// Sequential rollout chains of one instance (B2): line-search costs, the
// accepted trajectory, and the open-loop rollout.
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py:92 _ls_cost_kernel (entry
// linesearch_costs_pallas) and :132 _traj_kernel (entry
// closed_loop_rollout_pallas), B2.  The open-loop entry is the trajectory
// kernel without feedback, u = U_old: the single-instance initial rollout,
// which the JAX solver runs as one device program (solver.py:389-395).
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
// - Warp-specialised block of two warps.  Warp 0 is the chain: one lane
//   per alpha (grid.y covers more than 32), state, cost and parameters in
//   registers.  Warp 1 is the producer: its lane 0 keeps a ring of
//   kStages stages of kChunk steps (X_old, U_old, u_ff, K rows) full with
//   1-D bulk copies completing on each stage's full barrier, and drains the
//   trajectory kernels' output stages (x_t, u_t rows written by the chain
//   lane) to device memory with bulk stores.  The chain waits only on the
//   stage it needs and releases it on the stage's empty barrier; there is
//   no block-wide barrier inside the time loop.  A ragged chunk's last
//   (< 16-byte) piece of each array is copied by plain loads and stores.
// - Nothing loop-invariant is read from memory on the chain: the parameter
//   buffer is loaded once into register structs (models.cuh, *Regs), whose
//   model constants are folded before the time loop; sin and cos of q2 come
//   from one sincosf and M^-1 h from one IEEE reciprocal of det.
// - The arithmetic that fixes the answer stays: the control law is
//   u_old + a*u_ff + K (x - x_old) in the B5 kernel's order (no folding of
//   u_old - K x_old, which cancels when x is near x_old), no fast-math
//   intrinsics, the stage cost in its own accumulator off the state's
//   chain, and exactly N steps with no padding or masking.
// Bulk copies need 16-byte aligned arrays (ops/fused_rollout.py checks).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "models.cuh"

namespace {

using namespace ilqr;

constexpr int kChunk = 64;              // steps per ring stage
constexpr int kStages = 4;              // ring depth
constexpr int kLanes = 32;              // chain lanes, one per alpha
constexpr int kThreads = 2 * kLanes;    // chain warp + producer warp

enum Mode { kCosts = 0, kTrajectory = 1, kOpenLoop = 2 };

// Shared memory of one block, in floats per stage:
//   [4 kStages barriers | kStages input stages | kStages output stages].
template <int NX, int NU, int MODE>
struct Ring {
  static constexpr bool kFeedback = MODE != kOpenLoop;
  static constexpr bool kStores = MODE != kCosts;
  // Input stage: X_old rows, U_old rows, u_ff rows, K rows (open loop:
  // U_old rows only).
  static constexpr int kX = 0;
  static constexpr int kU = kFeedback ? kChunk * NX : 0;
  static constexpr int kF = kU + kChunk * NU;
  static constexpr int kK = kF + kChunk * NU;
  static constexpr int kIn = kFeedback ? kK + kChunk * NU * NX : kChunk * NU;
  // Output stage: x_t rows, then u_t rows (trajectory kernel only).
  static constexpr int kOutU = kChunk * NX;
  static constexpr int kOut =
      MODE == kCosts ? 0 : kChunk * NX + (MODE == kTrajectory ? kChunk * NU : 0);
  static constexpr int kBarBytes = 4 * kStages * sizeof(uint64_t);
  static constexpr int kBytes =
      kBarBytes + sizeof(float) * kStages * (kIn + kOut);
};

struct Barriers {
  uint64_t* full;    // input stage loaded (1 arrival + its bytes)
  uint64_t* empty;   // input stage read by every chain lane (kLanes)
  uint64_t* ofull;   // output stage written by the chain (1)
  uint64_t* oempty;  // output stage drained by the producer (1)
};

// n floats device -> shared: the 16-byte prefix by one bulk copy, the rest
// (< 4 floats) by plain loads.  Returns the bulk bytes.
__device__ __forceinline__ uint32_t load_tail(float* dst, const float* src,
                                              int n) {
  const int bulk = n & ~3;
  for (int i = bulk; i < n; ++i) dst[i] = src[i];
  return 4u * bulk;
}

__device__ __forceinline__ void load_bulk(float* dst, const float* src, int n,
                                          uint64_t* bar) {
  const int bulk = n & ~3;
  if (bulk > 0) bulk_load(dst, src, 4u * bulk, bar);
}

// n floats shared -> device: bulk prefix, plain tail.
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int n) {
  const int bulk = n & ~3;
  if (bulk > 0) bulk_store(dst, src, 4u * bulk);
  for (int i = bulk; i < n; ++i) dst[i] = src[i];
}

// Warp 1, lane 0: fill the input ring ahead of the chain and drain its
// output stages.  Chunk c lives in stage c % kStages, round c / kStages.
template <int NX, int NU, int MODE>
__device__ void produce(int N, const float* X_old, const float* U_old,
                        const float* u_ff, const float* K, float* in,
                        float* out, float* X_out, float* U_out, Barriers b) {
  using R = Ring<NX, NU, MODE>;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  int loaded = 0;
  for (int c = 0; c < n_chunks; ++c) {
    for (; loaded < n_chunks && loaded < c + kStages; ++loaded) {
      const int s = loaded % kStages;
      const int t0 = loaded * kChunk, T = min(kChunk, N - t0);
      float* st = in + s * R::kIn;
      // Round r reuses the stage after the chain released round r - 1.
      mbar_wait(&b.empty[s], ((loaded / kStages) & 1) ^ 1);
      uint32_t bytes = load_tail(st + R::kU, U_old + t0 * NU, T * NU);
      if constexpr (R::kFeedback) {
        bytes += load_tail(st + R::kX, X_old + t0 * NX, T * NX);
        bytes += load_tail(st + R::kF, u_ff + t0 * NU, T * NU);
        bytes += load_tail(st + R::kK, K + t0 * NU * NX, T * NU * NX);
      }
      // The plain tail loads come before the arrival that releases them.
      mbar_arrive_expect_tx(&b.full[s], bytes);
      load_bulk(st + R::kU, U_old + t0 * NU, T * NU, &b.full[s]);
      if constexpr (R::kFeedback) {
        load_bulk(st + R::kX, X_old + t0 * NX, T * NX, &b.full[s]);
        load_bulk(st + R::kF, u_ff + t0 * NU, T * NU, &b.full[s]);
        load_bulk(st + R::kK, K + t0 * NU * NX, T * NU * NX, &b.full[s]);
      }
    }
    if constexpr (R::kStores) {
      const int s = c % kStages;
      const int t0 = c * kChunk, T = min(kChunk, N - t0);
      const float* ost = out + s * R::kOut;
      mbar_wait(&b.ofull[s], (c / kStages) & 1);
      store_rows(X_out + t0 * NX, ost, T * NX);
      if constexpr (MODE == kTrajectory)
        store_rows(U_out + t0 * NU, ost + R::kOutU, T * NU);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(&b.oempty[s]);
    }
  }
  if constexpr (R::kStores) bulk_wait_all();
}

// One block per SM is all a chain needs: with the thread bound alone, ptxas
// held some instantiations to 64 registers and spilled parameters.
template <class Model, int NX, int NU, int INTEG, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const float* __restrict__ params, const float* __restrict__ x0,
             const float* __restrict__ alphas, float alpha, int n_alpha,
             const float* __restrict__ X_old, const float* __restrict__ U_old,
             const float* __restrict__ u_ff, const float* __restrict__ K,
             int N, int newton_iters, float* __restrict__ costs,
             float* __restrict__ X_out, float* __restrict__ U_out) {
  using R = Ring<NX, NU, MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const Barriers b{bars, bars + kStages, bars + 2 * kStages,
                   bars + 3 * kStages};
  float* in = reinterpret_cast<float*>(smem + R::kBarBytes);
  float* out = in + kStages * R::kIn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&b.full[s], 1);
      mbar_init(&b.empty[s], kLanes);
      mbar_init(&b.ofull[s], 1);
      mbar_init(&b.oempty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the block's only barrier: the mbarriers are ready
  if (threadIdx.x >= kLanes) {
    if (threadIdx.x == kLanes)
      produce<NX, NU, MODE>(N, X_old, U_old, u_ff, K, in, out, X_out, U_out,
                            b);
    return;
  }

  // The chain warp.  Idle lanes (a >= n_alpha) repeat alpha 0 and store
  // nothing, so the warp never diverges inside the loop.
  const int a = blockIdx.y * kLanes + threadIdx.x;
  const bool active = a < n_alpha;
  const float al = alphas != nullptr ? alphas[active ? a : 0] : alpha;
  using L = ParamLayout<NX, NU>;
  Model model;
  model.load(params + L::kModel);
  StageCostRegs<NX, NU> running_cost;
  running_cost.load(params);
  const float dt = running_cost.dt;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i];
  float cost = 0.0f;

  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const uint32_t parity = (c / kStages) & 1;
    const int T = min(kChunk, N - c * kChunk);
    const float* st = in + s * R::kIn;
    float* ost = out + s * R::kOut;
    mbar_wait(&b.full[s], parity);
    // Only the storing lane waits for its output stage: an idle lane may
    // lag its lane 0 by a whole ring, and a parity wait cannot tell a
    // barrier that has moved two phases on from one that has not moved.
    if constexpr (R::kStores) {
      if (active) mbar_wait(&b.oempty[s], parity ^ 1);
    }
#pragma unroll 1
    for (int k = 0; k < T; ++k) {
      float u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = st[R::kU + k * NU + i];
        if constexpr (R::kFeedback) {
          acc += al * st[R::kF + k * NU + i];
#pragma unroll
          for (int j = 0; j < NX; ++j)
            acc += st[R::kK + (k * NU + i) * NX + j]
                   * (x[j] - st[R::kX + k * NX + j]);
        }
        u[i] = acc;
      }
      if constexpr (R::kStores) {
        if (active) {
#pragma unroll
          for (int i = 0; i < NX; ++i) ost[k * NX + i] = x[i];
          if constexpr (MODE == kTrajectory) {
#pragma unroll
            for (int i = 0; i < NU; ++i) ost[R::kOutU + k * NU + i] = u[i];
          }
        }
      }
      cost += running_cost(x, u);
      float xn[NX];
      integrate<NX, INTEG>(
          [&](const auto* xs, auto* xdot) { model.f(xs, u, xdot); }, dt, x,
          xn, newton_iters);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    mbar_arrive(&b.empty[s]);
    if constexpr (R::kStores) {
      if (active) {
        fence_async_smem();  // the rows are read next by a bulk store
        mbar_arrive(&b.ofull[s]);
      }
    }
  }
  if (!active) return;
  costs[a] = cost + terminal_cost<NX, NU>(params, x);
  if constexpr (R::kStores) {
#pragma unroll
    for (int i = 0; i < NX; ++i) X_out[N * NX + i] = x[i];
  }
}

struct ChainArgs {
  const float* params;
  int n_params;
  const float* x0;
  const float* alphas;
  float alpha;
  int n_alpha;
  const float* X_old;
  const float* U_old;
  const float* u_ff;
  const float* K;
  int N;
  int newton_iters;
  float* costs;
  float* X_out;
  float* U_out;
  cudaStream_t stream;
};

template <class Model, int NX, int NU, int INTEG, int MODE>
int launch(const ChainArgs& r) {
  using R = Ring<NX, NU, MODE>;
  // The buffer's length must be the layout this instantiation reads.
  if (r.n_params != ParamLayout<NX, NU>::kModel + Model::kParams)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(1, (r.n_alpha + kLanes - 1) / kLanes);
  chain_kernel<Model, NX, NU, INTEG, MODE><<<grid, kThreads, R::kBytes, r.stream>>>(
      r.params, r.x0, r.alphas, r.alpha, r.n_alpha, r.X_old, r.U_old, r.u_ff,
      r.K, r.N, r.newton_iters, r.costs, r.X_out, r.U_out);
  return static_cast<int>(cudaGetLastError());
}

template <class Model, int NX, int NU, int MODE>
int by_integrator(int integrator, const ChainArgs& r) {
  switch (integrator) {
    case kEuler: return launch<Model, NX, NU, kEuler, MODE>(r);
    case kMidpoint: return launch<Model, NX, NU, kMidpoint, MODE>(r);
    case kRk4: return launch<Model, NX, NU, kRk4, MODE>(r);
    case kBackwardEuler:
      return launch<Model, NX, NU, kBackwardEuler, MODE>(r);
    case kTrapezoidal: return launch<Model, NX, NU, kTrapezoidal, MODE>(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// model: 0 = pendulum (n_x 2, n_u 1), 1 = double pendulum (n_x 4, n_u 1|2).
template <int MODE>
int dispatch(int model, int integrator, int n_x, int n_u, const ChainArgs& r) {
  if (model == 0 && n_x == 2 && n_u == 1)
    return by_integrator<PendulumRegs<1>, 2, 1, MODE>(integrator, r);
  if (model == 1 && n_x == 4 && n_u == 1)
    return by_integrator<DoublePendulumRegs<1>, 4, 1, MODE>(integrator, r);
  if (model == 1 && n_x == 4 && n_u == 2)
    return by_integrator<DoublePendulumRegs<2>, 4, 2, MODE>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Steps per ring stage and stages in the ring (for tests that cross them).
extern "C" int ilqr_chain_chunk_steps() { return kChunk; }
extern "C" int ilqr_chain_ring_stages() { return kStages; }

// integrator: models.cuh's Integrator; newton_iters: the implicit rules'
// fixed count of corrections (ignored by the explicit ones).
//
// B2a.  Candidate costs (n_alpha,) of every alpha in one sequential pass.
extern "C" int ilqr_linesearch_costs(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, const float* alphas,
    int n_alpha, const float* X_old, const float* U_old, const float* u_ff,
    const float* K, int N, float* costs, void* stream) {
  ChainArgs r{params, n_params, x0, alphas, 0.0f, n_alpha, X_old, U_old,
              u_ff, K, N, newton_iters, costs, nullptr, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kCosts>(model, integrator, n_x, n_u, r);
}

// B2b.  Trajectory of one alpha: X (N+1, n_x), U (N, n_u) and its cost (1,).
extern "C" int ilqr_closed_loop_rollout(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, float alpha,
    const float* X_old, const float* U_old, const float* u_ff, const float* K,
    int N, float* cost, float* X_out, float* U_out, void* stream) {
  ChainArgs r{params, n_params, x0, nullptr, alpha, 1, X_old, U_old, u_ff, K,
              N, newton_iters, cost, X_out, U_out,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kTrajectory>(model, integrator, n_x, n_u, r);
}

// B2b without feedback: the open-loop rollout of U (N, n_u) from x0,
// X (N+1, n_x) and its cost (1,).
extern "C" int ilqr_open_loop_rollout(
    int model, int integrator, int newton_iters, int n_x, int n_u,
    const float* params, int n_params, const float* x0, const float* U, int N,
    float* cost, float* X_out, void* stream) {
  ChainArgs r{params, n_params, x0, nullptr, 0.0f, 1, nullptr, U, nullptr,
              nullptr, N, newton_iters, cost, X_out, nullptr,
              static_cast<cudaStream_t>(stream)};
  return dispatch<kOpenLoop>(model, integrator, n_x, n_u, r);
}
