// Sequential rollout chains (B2, and B5 for a batch): line-search costs,
// the accepted trajectory, and the open-loop rollout, of B instances.
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py:92 _ls_cost_kernel (entry
// linesearch_costs_pallas) and :132 _traj_kernel (entry
// closed_loop_rollout_pallas), B2; and ilqr_tpu/ops/pallas_batched.py:377
// _rollout_kernel (launcher _rollout_batched_call; entries
// linesearch_costs_batched, closed_loop_rollout_batched and
// open_loop_rollout_batched), B5.  B2 is the batch of one instance.  The
// open-loop entries are the trajectory kernel without feedback, u = U_old:
// the initial rollout, which the JAX solver runs as one device program
// (solver.py:389-395).  The systems are the forms of forms.cuh: the
// register models of models.cuh (instantiated here for the pendulum and the
// double pendulum, the rest in the translation units that `dispatch`
// names), the LTI systems, the tracking and rate wrappers, the spring
// chain and the neural residual (an MLP on a register model's dynamics);
// JAX's kernels trace any system's Python, so each system the port's
// kernels take has a device form.
//
// What bounds it on an H100: the latency of one dependent chain.  The
// recursion
//   u_t = u_old_t + a*u_ff_t + K_t (x_t - x_old_t),  x_{t+1} = step(x_t, u_t)
// is N steps of a few hundred flops on a handful of floats; neither
// bandwidth nor SM count shortens it.  A step costs the latency of its
// longest dependent path (control law, the model's sines, the mass-matrix
// reciprocal, the integrator update) times the instructions issued on it,
// by one warp on one SM.  The implicit integrators (backward Euler,
// trapezoidal) make a step longer: the predictor, df/dx at it by one dual
// evaluation of the model, a closed-form inverse, then newton_iters
// corrections of one model evaluation each (models.cuh, integrate).
//
// Design, for that latency:
// - Warp-specialised blocks of W chain warps and one producer warp.  A
//   chain warp's lanes carry (instance, alpha) pairs, lpi = min(A, 32)
//   lanes for each of its I instances (grid.y covers more than 32 alphas),
//   with state, cost and parameters in registers.  I and W are chosen so
//   that the B instances spread over about three chain warps on each SM,
//   one block an SM (kTargetWarps), as far as the lanes and shared memory
//   allow: warps 0-2 then sit on three of the SM's four schedulers and the
//   producer on the fourth (two-warp blocks, several an SM, put two chain
//   warps on one scheduler).  At B = 1024: three instances a warp, three
//   warps a block, for both 10 alphas and one; at B = 1 (B2) one warp of
//   one instance.  The producer's lane j keeps a ring of kStages stages of
//   kChunk steps of the block's instance j (X_old, U_old, u_ff, K rows)
//   full with 1-D bulk copies completing on each stage's full barrier, and
//   drains the trajectory kernels' output stages (x_t, u_t rows written by
//   the chain lane of instance j) to device memory with bulk stores.  The
//   chain waits only on the stage it needs and releases it on the stage's
//   empty barrier; there is no block-wide barrier inside the time loop.
// - Any alignment: an instance's rows start b (N + 1) n_x or b N n_u
//   floats into a batch, so each run of a chunk is placed in its stage at
//   the same address modulo 16 bytes as in device memory (a shift of up to
//   3 floats, the same for every chunk of an instance), its 16-byte aligned
//   middle moves by bulk copy and its head and tail by plain loads and
//   stores.  When every run starts on 16 bytes (B = 1 from fresh tensors;
//   the DP at even N), the launcher picks the instantiation whose shifts
//   are 0 at compile time, so the chain reads and writes its stages by
//   vector loads and stores (a shift known only at run time turns them
//   into one per float, on the chain's path).
// - Nothing loop-invariant is read from memory on the chain: the parameter
//   buffer is loaded once into register structs (models.cuh, *Regs), whose
//   model constants are folded before the time loop; sin and cos of q2 come
//   from one sincosf and M^-1 h from one IEEE reciprocal of det.  Wider
//   operands that would spill (the quadratic costs above n_x = 4, LTI's A
//   and B above n_x = 4, the chain's S) sit in the block's shared memory and
//   are read volatile at each use; a tracking reference stays in device
//   memory, one row a step; the implicit rules above n_x = 4 keep their
//   Newton matrix in the lane's shared work (models.cuh, integrate), and
//   the spring chain's stages hold 8 steps (a K row is 2 KB a step).
// - The arithmetic that fixes the answer stays: the control law is
//   u_old + a*u_ff + K (x - x_old) in the TPU kernel's order (no folding of
//   u_old - K x_old, which cancels when x is near x_old), no fast-math
//   intrinsics, the stage cost in its own accumulator off the state's
//   chain, and exactly N steps with no padding or masking.
#include <cuda_runtime.h>

#include <cstdint>

#include "chain_kernel.cuh"

namespace {

using namespace ilqr;
using namespace ilqr::chain;

// model (ModelId): 0 = pendulum (n_x 2, n_u 1), 1 = double pendulum (n_x 4,
// n_u 1|2), 2 = cart-pole (4, 1), 3 = planar quadrotor (6, 2), 4 = 3-D
// quadrotor (12, 4), 5 = its rotor-lag variant (16, 4), 6 = car (4, 2),
// 7 = LTI (lti_rollout.cu), 8 = the spring chain (32, 16); 16 + b and
// 32 + b the tracking and rate wrappers over model b, 64 + b the neural
// residual over it.  The translation units of the other systems answer for
// their shapes.
template <int MODE>
int dispatch(int model, int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (model == kPendulum && n_x == 2 && n_u == 1)
    return by_integrator<PendulumRegs<1>, 2, 1, MODE>(integrator, r);
  if (model == kDoublePendulum && n_x == 4 && n_u == 1)
    return by_integrator<DoublePendulumRegs<1>, 4, 1, MODE>(integrator, r);
  if (model == kDoublePendulum && n_x == 4 && n_u == 2)
    return by_integrator<DoublePendulumRegs<2>, 4, 2, MODE>(integrator, r);
  if (model >= kCartpole && model <= kCar) {
    if (integrator == kBackwardEuler || integrator == kTrapezoidal)
      return dispatch_implicit(MODE, model, integrator, n_x, n_u, r);
    return dispatch_models(MODE, model, integrator, n_x, n_u, r);
  }
  if (model == kLti) return dispatch_lti(MODE, integrator, n_x, n_u, r);
  if (model == kSpringChain)
    return dispatch_spring_chain(MODE, integrator, n_x, n_u, r);
  if (model == kTracking + kLti)
    return dispatch_tracking_lti(MODE, integrator, n_x, n_u, r);
  if (model >= kTracking && model <= kTracking + kCar)
    return dispatch_tracking_models(MODE, model - kTracking, integrator, n_x,
                                    n_u, r);
  if (model == kRate + kLti)
    return dispatch_rate_lti(MODE, integrator, n_x, n_u, r);
  if (model >= kRate && model <= kRate + kCar)
    return dispatch_rate_models(MODE, model - kRate, integrator, n_x, n_u, r);
  if (model == kNeural + kLti)
    return dispatch_neural_lti(MODE, integrator, n_x, n_u, r);
  if (model >= kNeural && model <= kNeural + kCar)
    return dispatch_neural_models(MODE, model - kNeural, integrator, n_x,
                                  n_u, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NX, int NU>
BlockShape shape_of(int mode, int B, int n_alpha) {
  switch (mode) {
    case kCosts: return Ring<NX, NU, kCosts>::shape(B, n_alpha);
    case kTrajectory: return Ring<NX, NU, kTrajectory>::shape(B, n_alpha);
    default: return Ring<NX, NU, kOpenLoop>::shape(B, n_alpha);
  }
}

BlockShape shape_of(int mode, int n_x, int n_u, int B, int n_alpha) {
  if (B < 1 || n_alpha < 1) return {-1, -1};
  if (n_x == 2 && n_u == 1) return shape_of<2, 1>(mode, B, n_alpha);
  if (n_x == 4 && n_u == 1) return shape_of<4, 1>(mode, B, n_alpha);
  if (n_x == 4 && n_u == 2) return shape_of<4, 2>(mode, B, n_alpha);
  if (n_x == 6 && n_u == 2) return shape_of<6, 2>(mode, B, n_alpha);
  if (n_x == 12 && n_u == 4) return shape_of<12, 4>(mode, B, n_alpha);
  if (n_x == 16 && n_u == 4) return shape_of<16, 4>(mode, B, n_alpha);
  return {-1, -1};
}

}  // namespace

// Steps per ring stage and stages in the ring (for tests that cross them);
// the stage of the widest systems (the spring chain) is shorter.
extern "C" int ilqr_chain_chunk_steps() { return kChunk; }
extern "C" int ilqr_chain_chunk_steps_at(int n_x, int n_u) {
  return chunk_steps(n_x, n_u);
}
extern "C" int ilqr_chain_ring_stages() { return kStages; }

// How the chain kernels split B instances (mode: 0 costs, 1 trajectory,
// 2 open loop): instances a chain warp and chain warps a block, or -1 for
// shapes without a kernel.
extern "C" int ilqr_chain_instances_per_warp(int mode, int n_x, int n_u,
                                             int B, int n_alpha) {
  return shape_of(mode, n_x, n_u, B, n_alpha).per_warp;
}
extern "C" int ilqr_chain_warps_per_block(int mode, int n_x, int n_u, int B,
                                          int n_alpha) {
  return shape_of(mode, n_x, n_u, B, n_alpha).warps;
}

// integrator: models.cuh's Integrator; newton_iters: the implicit rules'
// fixed count of corrections (ignored by the explicit ones).
//
// B2a.  Candidate costs (n_alpha,) of every alpha in one sequential pass.
extern "C" int ilqr_linesearch_costs(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, const float* alphas,
    int n_alpha, const float* X_old, const float* U_old, const float* u_ff,
    const float* K, int N, float* costs, void* stream) {
  ChainArgs r{params, n_params, 1, x0, alphas, nullptr, 0.0f, n_alpha, X_old,
              U_old, u_ff, K, N, newton_iters, costs, nullptr, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kCosts>(model, integrator, n_x, n_u, r);
}

// B2b.  Trajectory of one alpha: X (N+1, n_x), U (N, n_u) and its cost (1,).
extern "C" int ilqr_closed_loop_rollout(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, float alpha,
    const float* X_old, const float* U_old, const float* u_ff, const float* K,
    int N, float* cost, float* X_out, float* U_out, void* stream) {
  ChainArgs r{params, n_params, 1, x0, nullptr, nullptr, alpha, 1, X_old,
              U_old, u_ff, K, N, newton_iters, cost, X_out, U_out,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kTrajectory>(model, integrator, n_x, n_u, r);
}

// B2b without feedback: the open-loop rollout of U (N, n_u) from x0,
// X (N+1, n_x) and its cost (1,).
extern "C" int ilqr_open_loop_rollout(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, const float* U, int N,
    float* cost, float* X_out, void* stream) {
  ChainArgs r{params, n_params, 1, x0, nullptr, nullptr, 0.0f, 1, nullptr, U,
              nullptr, nullptr, N, newton_iters, cost, X_out, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kOpenLoop>(model, integrator, n_x, n_u, r);
}

// B5.  Batched candidate costs (B, n_alpha): instance b rolls out from
// x0s[b] along its own X_old[b], U_old[b], u_ff[b], K[b] (all (B, ...),
// contiguous, any 4-byte alignment) for every alpha of the shared schedule.
extern "C" int ilqr_linesearch_costs_batched(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, int B, const float* x0s,
    const float* alphas, int n_alpha, const float* X_old, const float* U_old,
    const float* u_ff, const float* K, int N, float* costs, void* stream) {
  ChainArgs r{params, n_params, B, x0s, alphas, nullptr, 0.0f, n_alpha,
              X_old, U_old, u_ff, K, N, newton_iters, costs, nullptr, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kCosts>(model, integrator, n_x, n_u, r);
}

// B5.  Batched trajectories at one alpha per instance, alpha_b (B,):
// X (B, N+1, n_x), U (B, N, n_u) and cost (B,).
extern "C" int ilqr_closed_loop_rollout_batched(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, int B, const float* x0s,
    const float* alpha_b, const float* X_old, const float* U_old,
    const float* u_ff, const float* K, int N, float* cost, float* X_out,
    float* U_out, void* stream) {
  ChainArgs r{params, n_params, B, x0s, nullptr, alpha_b, 0.0f, 1, X_old,
              U_old, u_ff, K, N, newton_iters, cost, X_out, U_out,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kTrajectory>(model, integrator, n_x, n_u, r);
}

// B5.  Batched open-loop rollouts of U (B, N, n_u) from x0s (B, n_x):
// X (B, N+1, n_x) and cost (B,).
extern "C" int ilqr_open_loop_rollout_batched(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, int B, const float* x0s,
    const float* U, int N, float* cost, float* X_out, void* stream) {
  ChainArgs r{params, n_params, B, x0s, nullptr, nullptr, 0.0f, 1, nullptr,
              U, nullptr, nullptr, N, newton_iters, cost, X_out, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kOpenLoop>(model, integrator, n_x, n_u, r);
}

// The message of a CUDA error code, for every entry of the library.
extern "C" const char* ilqr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
