// B2's chain kernels (chain_kernel.cuh) for the neural residual (forms.cuh,
// NeuralForm) over the LTI systems (models.cuh, LtiRegs) at (2, 1),
// (4, 1), (4, 2), (6, 2), (12, 4) and (16, 4), under euler, midpoint, rk4
// or 'discrete' (the map A x + B u plus the MLP).  The phased
// instantiation only; a translation unit of its own so that nvcc builds it
// beside neural_models.cu.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int NX, int NU>
struct NeuralLti {
  template <int INTEG>
  using type = NeuralForm<LtiRegs<NX, NU>, NX, NU, INTEG>;
};

template <int NX, int NU, int MODE>
int neural(int integrator, const ChainArgs& r) {
  return by_form_integrator<NeuralLti<NX, NU>::template type, NX, NU, MODE,
                            true>(integrator, r);
}

template <int MODE>
int dispatch_mode(int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (n_x == 2 && n_u == 1) return neural<2, 1, MODE>(integrator, r);
  if (n_x == 4 && n_u == 1) return neural<4, 1, MODE>(integrator, r);
  if (n_x == 4 && n_u == 2) return neural<4, 2, MODE>(integrator, r);
  if (n_x == 6 && n_u == 2) return neural<6, 2, MODE>(integrator, r);
  if (n_x == 12 && n_u == 4) return neural<12, 4, MODE>(integrator, r);
  if (n_x == 16 && n_u == 4) return neural<16, 4, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_neural_lti(int mode, int integrator, int n_x, int n_u,
                        const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
