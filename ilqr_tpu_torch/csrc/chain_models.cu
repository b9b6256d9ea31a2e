// B2's chain kernels (chain_kernel.cuh) instantiated for the models added
// after the pendulum and the double pendulum: the cart-pole, the planar and
// 3-D quadrotors, the rotor-lag quadrotor and the car, under the explicit
// integrators (their implicit rules are implicit_models.cu's).  A
// translation unit of its own so that nvcc builds it beside
// chain_rollout.cu, whose entries dispatch model ids 2-6 here.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int MODE>
int dispatch_mode(int model, int integrator, int n_x, int n_u,
                  const ChainArgs& r) {
  if (model == kCartpole && n_x == 4 && n_u == 1)
    return by_explicit_integrator<CartpoleRegs<1>, 4, 1, MODE>(integrator, r);
  if (model == kQuadrotor && n_x == 6 && n_u == 2)
    return by_explicit_integrator<QuadrotorRegs<2>, 6, 2, MODE>(integrator, r);
  if (model == kQuadrotor3d && n_x == 12 && n_u == 4)
    return by_explicit_integrator<Quadrotor3dRegs<4>, 12, 4, MODE>(integrator,
                                                                   r);
  if (model == kQuadrotor3dRotor && n_x == 16 && n_u == 4)
    return by_explicit_integrator<Quadrotor3dRotorRegs<4>, 16, 4, MODE>(
        integrator, r);
  if (model == kCar && n_x == 4 && n_u == 2)
    return by_explicit_integrator<CarRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_models(int mode, int model, int integrator, int n_x, int n_u,
                    const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, model, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
