// B2's chain kernels (chain_kernel.cuh) for the tracking wrapper
// (forms.cuh, TrackingForm; ilqr_tpu_torch/models/tracking.py) over the
// register models whose tracked state has at most 16 entries: the
// pendulum (3, 1), the double pendulum (5, 1), (5, 2), the cart-pole
// (5, 1), the planar quadrotor (7, 2), the 3-D quadrotor (13, 4) and the
// car (5, 2), each under euler, midpoint and rk4.  n_x is the tracked
// state's.  The phased instantiation only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <class Base, int NXB, int NU>
struct Tracked {
  template <int INTEG>
  using type = TrackingForm<Base, NXB, NU, INTEG>;
};

template <class Base, int NXB, int NU, int MODE>
int tracked(int integrator, const ChainArgs& r) {
  return by_form_integrator<Tracked<Base, NXB, NU>::template type, NXB + 1,
                            NU, MODE, false>(integrator, r);
}

template <int MODE>
int dispatch_mode(int base, int integrator, int n_x, int n_u,
                  const ChainArgs& r) {
  if (base == kPendulum && n_x == 3 && n_u == 1)
    return tracked<PendulumRegs<1>, 2, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 5 && n_u == 1)
    return tracked<DoublePendulumRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 5 && n_u == 2)
    return tracked<DoublePendulumRegs<2>, 4, 2, MODE>(integrator, r);
  if (base == kCartpole && n_x == 5 && n_u == 1)
    return tracked<CartpoleRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kQuadrotor && n_x == 7 && n_u == 2)
    return tracked<QuadrotorRegs<2>, 6, 2, MODE>(integrator, r);
  if (base == kQuadrotor3d && n_x == 13 && n_u == 4)
    return tracked<Quadrotor3dRegs<4>, 12, 4, MODE>(integrator, r);
  if (base == kCar && n_x == 5 && n_u == 2)
    return tracked<CarRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_tracking_models(int mode, int base, int integrator, int n_x,
                             int n_u, const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, base, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
