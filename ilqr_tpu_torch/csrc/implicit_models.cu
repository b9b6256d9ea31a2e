// B2's chain kernels (chain_kernel.cuh) under the implicit rules (backward
// Euler, trapezoidal) for the models added after the pendulum and the
// double pendulum: the cart-pole and the car (n_x = 4: df/dx by one
// Dual<4> evaluation, the closed-form inverse in registers), the planar
// quadrotor, the 3-D quadrotor and its rotor-lag variant (n_x = 6, 12, 16:
// df/dx column by column, Gauss-Jordan in the lane's shared work;
// models.cuh, integrate).  The phased instantiation only.  B5's batched
// entries take them through the same dispatch.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <class Model, int NX, int NU, int MODE>
int by_implicit(int integrator, const ChainArgs& r) {
  switch (integrator) {
    case kBackwardEuler:
      return launch<Model, NX, NU, kBackwardEuler, MODE, false>(r);
    case kTrapezoidal:
      return launch<Model, NX, NU, kTrapezoidal, MODE, false>(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int dispatch_mode(int model, int integrator, int n_x, int n_u,
                  const ChainArgs& r) {
  if (model == kCartpole && n_x == 4 && n_u == 1)
    return by_implicit<CartpoleRegs<1>, 4, 1, MODE>(integrator, r);
  if (model == kQuadrotor && n_x == 6 && n_u == 2)
    return by_implicit<QuadrotorRegs<2>, 6, 2, MODE>(integrator, r);
  if (model == kQuadrotor3d && n_x == 12 && n_u == 4)
    return by_implicit<Quadrotor3dRegs<4>, 12, 4, MODE>(integrator, r);
  if (model == kQuadrotor3dRotor && n_x == 16 && n_u == 4)
    return by_implicit<Quadrotor3dRotorRegs<4>, 16, 4, MODE>(integrator, r);
  if (model == kCar && n_x == 4 && n_u == 2)
    return by_implicit<CarRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_implicit(int mode, int model, int integrator, int n_x, int n_u,
                      const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, model, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
