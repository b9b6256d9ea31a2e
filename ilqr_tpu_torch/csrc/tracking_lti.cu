// B2's chain kernels (chain_kernel.cuh) for the tracking wrapper
// (forms.cuh, TrackingForm) over the LTI systems (models.cuh, LtiRegs)
// whose tracked state has at most 16 entries: bases (2, 1), (4, 1), (4, 2),
// (6, 2) and (12, 4), under euler, midpoint, rk4 and 'discrete' (the clock
// set to k + 1).  n_x is the tracked state's.  The phased instantiation
// only.
#include <cuda_runtime.h>

#include "chain_kernel.cuh"

namespace ilqr {
namespace chain {

namespace {

template <int NXB, int NU>
struct TrackedLti {
  template <int INTEG>
  using type = TrackingForm<LtiRegs<NXB, NU>, NXB, NU, INTEG>;
};

template <int NXB, int NU, int MODE>
int tracked(int integrator, const ChainArgs& r) {
  return by_form_integrator<TrackedLti<NXB, NU>::template type, NXB + 1, NU,
                            MODE, true>(integrator, r);
}

template <int MODE>
int dispatch_mode(int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (n_x == 3 && n_u == 1) return tracked<2, 1, MODE>(integrator, r);
  if (n_x == 5 && n_u == 1) return tracked<4, 1, MODE>(integrator, r);
  if (n_x == 5 && n_u == 2) return tracked<4, 2, MODE>(integrator, r);
  if (n_x == 7 && n_u == 2) return tracked<6, 2, MODE>(integrator, r);
  if (n_x == 13 && n_u == 4) return tracked<12, 4, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dispatch_tracking_lti(int mode, int integrator, int n_x, int n_u,
                          const ChainArgs& r) {
  ILQR_CHAIN_MODES(dispatch_mode, mode, integrator, n_x, n_u, r)
}

}  // namespace chain
}  // namespace ilqr
