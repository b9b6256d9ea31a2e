// B2's chain kernels (chain_kernel.cuh) for the linear time-invariant
// systems (models.cuh, LtiRegs; ilqr_tpu_torch/models/linear.py) under
// the quadratic costs, at (n_x, n_u) = (2, 1), (4, 1), (4, 2), (6, 2),
// (12, 4), (16, 4), under euler, midpoint, rk4 and 'discrete' (x+ = A x +
// B u: make_discrete_lti).  The phased instantiation only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int NX, int NU>
struct LtiAt {
  template <int INTEG>
  using type = LtiRegs<NX, NU>;
};

template <int NX, int NU, int MODE>
int lti(int integrator, const ChainArgs& r) {
  return by_form_integrator<LtiAt<NX, NU>::template type, NX, NU, MODE,
                            true>(integrator, r);
}

template <int MODE>
int dispatch_mode(int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (n_x == 2 && n_u == 1) return lti<2, 1, MODE>(integrator, r);
  if (n_x == 4 && n_u == 1) return lti<4, 1, MODE>(integrator, r);
  if (n_x == 4 && n_u == 2) return lti<4, 2, MODE>(integrator, r);
  if (n_x == 6 && n_u == 2) return lti<6, 2, MODE>(integrator, r);
  if (n_x == 12 && n_u == 4) return lti<12, 4, MODE>(integrator, r);
  if (n_x == 16 && n_u == 4) return lti<16, 4, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_lti(int mode, int integrator, int n_x, int n_u,
                 const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
