// B2's chain kernels (chain_kernel.cuh) for the rate wrapper (forms.cuh,
// RateForm; ilqr_tpu_torch/models/rate.py) over the register models with
// n_x + n_u at most 16: the pendulum (3, 1), the double pendulum (5, 1),
// (6, 2), the cart-pole (5, 1), the planar quadrotor (8, 2), the 3-D
// quadrotor (16, 4) and the car (6, 2), the base under euler, midpoint or
// rk4 inside the wrapper's 'discrete' map.  n_x is the wrapped state's;
// the integrator the base's.  The phased instantiation only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <class Base, int NXB, int NU>
struct Rated {
  template <int INTEG>
  using type = RateForm<Base, NXB, NU, INTEG>;
};

template <class Base, int NXB, int NU, int MODE>
int rated(int integrator, const ChainArgs& r) {
  return by_form_integrator<Rated<Base, NXB, NU>::template type, NXB + NU,
                            NU, MODE, false>(integrator, r);
}

template <int MODE>
int dispatch_mode(int base, int integrator, int n_x, int n_u,
                  const ChainArgs& r) {
  if (base == kPendulum && n_x == 3 && n_u == 1)
    return rated<PendulumRegs<1>, 2, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 5 && n_u == 1)
    return rated<DoublePendulumRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 6 && n_u == 2)
    return rated<DoublePendulumRegs<2>, 4, 2, MODE>(integrator, r);
  if (base == kCartpole && n_x == 5 && n_u == 1)
    return rated<CartpoleRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kQuadrotor && n_x == 8 && n_u == 2)
    return rated<QuadrotorRegs<2>, 6, 2, MODE>(integrator, r);
  if (base == kQuadrotor3d && n_x == 16 && n_u == 4)
    return rated<Quadrotor3dRegs<4>, 12, 4, MODE>(integrator, r);
  if (base == kCar && n_x == 6 && n_u == 2)
    return rated<CarRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_rate_models(int mode, int base, int integrator, int n_x,
                         int n_u, const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, base, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
