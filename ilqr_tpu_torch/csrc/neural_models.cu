// B2's chain kernels (chain_kernel.cuh) for the neural residual (forms.cuh,
// NeuralForm; ilqr_tpu_torch/models/neural.py) over the register models:
// the pendulum (2, 1), the double pendulum (4, 1), (4, 2), the cart-pole
// (4, 1), the planar quadrotor (6, 2), the 3-D quadrotor (12, 4), its
// rotor-lag variant (16, 4) and the car (4, 2), under euler, midpoint or
// rk4.  The phased instantiation only.  B5's batched entries take them
// through the same dispatch.
//
// Replaces, on this system: ilqr_tpu/ops/pallas_rollout.py:92
// _ls_cost_kernel and :132 _traj_kernel (B2), and
// ilqr_tpu/ops/pallas_batched.py:377 _rollout_kernel (B5), which trace the
// residual's JAX code into the kernel.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <class Base, int NX, int NU>
struct Neural {
  template <int INTEG>
  using type = NeuralForm<Base, NX, NU, INTEG>;
};

template <class Base, int NX, int NU, int MODE>
int neural(int integrator, const ChainArgs& r) {
  return by_form_integrator<Neural<Base, NX, NU>::template type, NX, NU,
                            MODE, false>(integrator, r);
}

template <int MODE>
int dispatch_mode(int base, int integrator, int n_x, int n_u,
                  const ChainArgs& r) {
  if (base == kPendulum && n_x == 2 && n_u == 1)
    return neural<PendulumRegs<1>, 2, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 4 && n_u == 1)
    return neural<DoublePendulumRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kDoublePendulum && n_x == 4 && n_u == 2)
    return neural<DoublePendulumRegs<2>, 4, 2, MODE>(integrator, r);
  if (base == kCartpole && n_x == 4 && n_u == 1)
    return neural<CartpoleRegs<1>, 4, 1, MODE>(integrator, r);
  if (base == kQuadrotor && n_x == 6 && n_u == 2)
    return neural<QuadrotorRegs<2>, 6, 2, MODE>(integrator, r);
  if (base == kQuadrotor3d && n_x == 12 && n_u == 4)
    return neural<Quadrotor3dRegs<4>, 12, 4, MODE>(integrator, r);
  if (base == kQuadrotor3dRotor && n_x == 16 && n_u == 4)
    return neural<Quadrotor3dRotorRegs<4>, 16, 4, MODE>(integrator, r);
  if (base == kCar && n_x == 4 && n_u == 2)
    return neural<CarRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_neural_models(int mode, int base, int integrator, int n_x,
                           int n_u, const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, base, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
