// B2's chain kernels (chain_kernel.cuh) for the spring chain (forms.cuh,
// ChainForm; ilqr_tpu_torch/models/chain.py) at bench.py's shape: 16
// masses, an actuator on each (n_x = 32, n_u = 16), under euler, midpoint
// and rk4.  Its ring stages hold 8 steps (chunk_steps: a K row is 2 KB a
// step).  The phased instantiation only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int INTEG>
using Chain16 = ChainForm<16, 16, INTEG>;

template <int MODE>
int dispatch_mode(int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (n_x == 32 && n_u == 16)
    return by_form_integrator<Chain16, 32, 16, MODE, false>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_spring_chain(int mode, int integrator, int n_x, int n_u,
                          const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
