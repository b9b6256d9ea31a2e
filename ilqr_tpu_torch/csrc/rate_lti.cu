// B2's chain kernels (chain_kernel.cuh) for the rate wrapper (forms.cuh,
// RateForm) over the LTI systems (models.cuh, LtiRegs) with n_x + n_u at
// most 16: bases (2, 1), (4, 1), (4, 2), (6, 2) and (12, 4), under euler,
// midpoint, rk4 or 'discrete' inside the wrapper's 'discrete' map.  n_x is
// the wrapped state's; the integrator the base's.  The phased
// instantiation only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int NXB, int NU>
struct RatedLti {
  template <int INTEG>
  using type = RateForm<LtiRegs<NXB, NU>, NXB, NU, INTEG>;
};

template <int NXB, int NU, int MODE>
int rated(int integrator, const ChainArgs& r) {
  return by_form_integrator<RatedLti<NXB, NU>::template type, NXB + NU, NU,
                            MODE, true>(integrator, r);
}

template <int MODE>
int dispatch_mode(int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (n_x == 3 && n_u == 1) return rated<2, 1, MODE>(integrator, r);
  if (n_x == 5 && n_u == 1) return rated<4, 1, MODE>(integrator, r);
  if (n_x == 6 && n_u == 2) return rated<4, 2, MODE>(integrator, r);
  if (n_x == 8 && n_u == 2) return rated<6, 2, MODE>(integrator, r);
  if (n_x == 16 && n_u == 4) return rated<12, 4, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_rate_lti(int mode, int integrator, int n_x, int n_u,
                      const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
