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
// (solver.py:389-395).
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
//   from one sincosf and M^-1 h from one IEEE reciprocal of det.
// - The arithmetic that fixes the answer stays: the control law is
//   u_old + a*u_ff + K (x - x_old) in the TPU kernel's order (no folding of
//   u_old - K x_old, which cancels when x is near x_old), no fast-math
//   intrinsics, the stage cost in its own accumulator off the state's
//   chain, and exactly N steps with no padding or masking.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "models.cuh"
#include "runs.cuh"

namespace {

using namespace ilqr;

constexpr int kChunk = 32;              // steps per ring stage
constexpr int kStages = 4;              // ring depth
constexpr int kLanes = 32;              // lanes of a warp
constexpr int kMaxChainWarps = 3;       // chain warps a block
// Chain warps that fill an H100 at three an SM (132 SMs), and the shared
// memory a block may take.
constexpr int kTargetWarps = 396;
constexpr int kSmemBudget = 200 * 1024;
static_assert(kChunk % 4 == 0, "a chunk keeps each run's 16-byte phase");

enum Mode { kCosts = 0, kTrajectory = 1, kOpenLoop = 2 };

struct BlockShape {
  int per_warp;  // instances a chain warp
  int warps;     // chain warps a block
};

// A run of n floats in a stage: rounded up to 16 bytes, plus 16 bytes for
// its phase (runs.cuh).
__host__ __device__ constexpr int region(int n) { return (n + 3) / 4 * 4 + 4; }

// Shared memory of one block, in floats per instance and stage:
//   [4 kStages barriers | kStages x I input regions | kStages x I outputs].
template <int NX, int NU, int MODE>
struct Ring {
  static constexpr bool kFeedback = MODE != kOpenLoop;
  static constexpr bool kStores = MODE != kCosts;
  // Input: X_old rows, U_old rows, u_ff rows, K rows (open loop: U_old).
  static constexpr int kX = 0;
  static constexpr int kU = kFeedback ? region(kChunk * NX) : 0;
  static constexpr int kF = kU + region(kChunk * NU);
  static constexpr int kK = kF + region(kChunk * NU);
  static constexpr int kIn =
      kFeedback ? kK + region(kChunk * NU * NX) : region(kChunk * NU);
  // Output: x_t rows, then u_t rows (trajectory kernel only).
  static constexpr int kOutU = region(kChunk * NX);
  static constexpr int kOut =
      MODE == kCosts ? 0
                     : kOutU + (MODE == kTrajectory ? region(kChunk * NU) : 0);
  static constexpr int kBarBytes = 4 * kStages * sizeof(uint64_t);
  static constexpr int kInstBytes = sizeof(float) * kStages * (kIn + kOut);
  static int bytes(int insts) { return kBarBytes + insts * kInstBytes; }
  // B instances on about kTargetWarps chain warps: instances a warp,
  // within its lanes (lpi = min(n_alpha, 32) each), then chain warps a
  // block, within kMaxChainWarps and kSmemBudget.
  static BlockShape shape(int B, int n_alpha) {
    const int lpi = min(n_alpha, kLanes);
    const int fit = max(1, (kSmemBudget - kBarBytes) / kInstBytes);
    const int per = max(1, min(min(kLanes / lpi, fit),
                               (B + kTargetWarps - 1) / kTargetWarps));
    const int warps = min(min(kMaxChainWarps, (B + per - 1) / per),
                          max(1, fit / per));
    return {per, warps};
  }
};

struct Barriers {
  uint64_t* full;    // input stage loaded (I arrivals + their bytes)
  uint64_t* empty;   // input stage read by every chain lane (32 W)
  uint64_t* ofull;   // output stage written by the storing lanes (I)
  uint64_t* oempty;  // output stage drained by the producer lanes (I)
};

// Producer lane j: fill instance j's input regions of the ring ahead of
// the chain and drain its output regions.  Chunk c lives in stage
// c % kStages, round c / kStages.  The pointers are instance j's rows.
template <int NX, int NU, int MODE>
__device__ void produce(int N, int j, int insts, const float* X_old,
                        const float* U_old, const float* u_ff, const float* K,
                        float* in, float* out, float* X_out, float* U_out,
                        Barriers b) {
  using R = Ring<NX, NU, MODE>;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  int loaded = 0;
  for (int c = 0; c < n_chunks; ++c) {
    for (; loaded < n_chunks && loaded < c + kStages; ++loaded) {
      const int s = loaded % kStages;
      const int t0 = loaded * kChunk, T = min(kChunk, N - t0);
      float* st = in + (s * insts + j) * R::kIn;
      // Round r reuses the stage after the chain released round r - 1.
      mbar_wait(&b.empty[s], ((loaded / kStages) & 1) ^ 1);
      uint32_t bytes = load_ends(st + R::kU, U_old + t0 * NU, T * NU);
      if constexpr (R::kFeedback) {
        bytes += load_ends(st + R::kX, X_old + t0 * NX, T * NX);
        bytes += load_ends(st + R::kF, u_ff + t0 * NU, T * NU);
        bytes += load_ends(st + R::kK, K + t0 * NU * NX, T * NU * NX);
      }
      // The plain loads come before the arrival that releases them.
      mbar_arrive_expect_tx(&b.full[s], bytes);
      load_mid(st + R::kU, U_old + t0 * NU, T * NU, &b.full[s]);
      if constexpr (R::kFeedback) {
        load_mid(st + R::kX, X_old + t0 * NX, T * NX, &b.full[s]);
        load_mid(st + R::kF, u_ff + t0 * NU, T * NU, &b.full[s]);
        load_mid(st + R::kK, K + t0 * NU * NX, T * NU * NX, &b.full[s]);
      }
    }
    if constexpr (R::kStores) {
      const int s = c % kStages;
      const int t0 = c * kChunk, T = min(kChunk, N - t0);
      const float* ost = out + (s * insts + j) * R::kOut;
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

// Instance b's rows of the (B, ...) arrays, as offsets in floats.
struct Rows {
  size_t x, u, k;
  __device__ __forceinline__ Rows(int b, int N, int NX, int NU)
      : x((size_t)b * (N + 1) * NX), u((size_t)b * N * NU),
        k((size_t)b * N * NU * NX) {}
};

// One block per SM is all the chains need: with the thread bound alone,
// ptxas held some instantiations to 64 registers and spilled parameters.
// blockDim.x = 32 (W + 1): W chain warps of per_warp instances, then the
// producer.
// PHASED: the runs may start anywhere (their shifts are read at run time);
// else every run starts on 16 bytes.
template <class Model, int NX, int NU, int INTEG, int MODE, bool PHASED>
__global__ void __launch_bounds__(kLanes * (kMaxChainWarps + 1), 1)
chain_kernel(const float* __restrict__ params, int B, int per_warp,
             const float* __restrict__ x0, const float* __restrict__ alphas,
             const float* __restrict__ alpha_b, float alpha, int n_alpha,
             const float* __restrict__ X_old, const float* __restrict__ U_old,
             const float* __restrict__ u_ff, const float* __restrict__ K,
             int N, int newton_iters, float* __restrict__ costs,
             float* __restrict__ X_out, float* __restrict__ U_out) {
  using R = Ring<NX, NU, MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const Barriers b{bars, bars + kStages, bars + 2 * kStages,
                   bars + 3 * kStages};
  const int warps = blockDim.x / kLanes - 1;  // chain warps
  const int insts = warps * per_warp;          // instances a block
  float* in = reinterpret_cast<float*>(smem + R::kBarBytes);
  float* out = in + kStages * insts * R::kIn;
  const int b0 = blockIdx.x * insts;
  const int here = min(insts, B - b0);  // the block's instances

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&b.full[s], here);
      mbar_init(&b.empty[s], kLanes * warps);
      mbar_init(&b.ofull[s], here);
      mbar_init(&b.oempty[s], here);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the block's only barrier: the mbarriers are ready
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if (warp == warps) {
    const int j = lane;
    if (j < here) {
      const Rows rw(b0 + j, N, NX, NU);
      produce<NX, NU, MODE>(N, j, insts, X_old + rw.x, U_old + rw.u,
                            u_ff + rw.u, K + rw.k, in, out, X_out + rw.x,
                            U_out + rw.u, b);
    }
    return;
  }

  // A chain warp: lane l runs alpha a of the block's instance jl.  Idle
  // lanes (past the warp's instances or the alphas) run alpha 0 of an
  // instance of the block and store nothing, so the warp never diverges
  // inside the loop.
  const int lpi = min(n_alpha, kLanes);
  const int jl = warp * per_warp + lane / lpi;
  const int a = blockIdx.y * kLanes + lane % lpi;
  const bool active = lane / lpi < per_warp && jl < here && a < n_alpha;
  const int j = min(jl, here - 1);
  const int inst = b0 + j;
  const Rows rw(inst, N, NX, NU);
  const float al = alphas != nullptr  ? alphas[active ? a : 0]
                   : alpha_b != nullptr ? alpha_b[inst]
                                        : alpha;
  // Where the instance's runs sit in their regions.
  const int sX = PHASED && R::kFeedback ? phase(X_old + rw.x) : 0;
  const int sU = PHASED ? phase(U_old + rw.u) : 0;
  const int sF = PHASED && R::kFeedback ? phase(u_ff + rw.u) : 0;
  const int sK = PHASED && R::kFeedback ? phase(K + rw.k) : 0;
  const int sXo = PHASED && R::kStores ? phase(X_out + rw.x) : 0;
  const int sUo = PHASED && MODE == kTrajectory ? phase(U_out + rw.u) : 0;
  using L = ParamLayout<NX, NU>;
  Model model;
  model.load(params + L::kModel);
  StageCostRegs<NX, NU> running_cost;
  running_cost.load(params);
  const float dt = running_cost.dt;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[(size_t)inst * NX + i];
  float cost = 0.0f;

  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const uint32_t parity = (c / kStages) & 1;
    const int T = min(kChunk, N - c * kChunk);
    const float* st = in + (s * insts + j) * R::kIn;
    float* ost = out + (s * insts + j) * R::kOut;
    const float* sXr = st + R::kX + sX;
    const float* sUr = st + R::kU + sU;
    const float* sFr = st + R::kF + sF;
    const float* sKr = st + R::kK + sK;
    mbar_wait(&b.full[s], parity);
    // Only the storing lanes wait for their output stage: an idle lane may
    // lag the others by a whole ring, and a parity wait cannot tell a
    // barrier that has moved two phases on from one that has not moved.
    if constexpr (R::kStores) {
      if (active) mbar_wait(&b.oempty[s], parity ^ 1);
    }
#pragma unroll 1
    for (int k = 0; k < T; ++k) {
      float u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = sUr[k * NU + i];
        if constexpr (R::kFeedback) {
          acc += al * sFr[k * NU + i];
#pragma unroll
          for (int m = 0; m < NX; ++m)
            acc += sKr[(k * NU + i) * NX + m] * (x[m] - sXr[k * NX + m]);
        }
        u[i] = acc;
      }
      if constexpr (R::kStores) {
        if (active) {
#pragma unroll
          for (int i = 0; i < NX; ++i) ost[sXo + k * NX + i] = x[i];
          if constexpr (MODE == kTrajectory) {
#pragma unroll
            for (int i = 0; i < NU; ++i)
              ost[R::kOutU + sUo + k * NU + i] = u[i];
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
  costs[(size_t)inst * n_alpha + a] = cost + terminal_cost<NX, NU>(params, x);
  if constexpr (R::kStores) {
#pragma unroll
    for (int i = 0; i < NX; ++i) X_out[rw.x + (size_t)N * NX + i] = x[i];
  }
}

struct ChainArgs {
  const float* params;
  int n_params;
  int B;
  const float* x0;
  const float* alphas;   // the shared schedule (costs), or null
  const float* alpha_b;  // one alpha an instance (trajectory), or null
  float alpha;           // else this one
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

// Whether a run of some instance may start off 16 bytes: a base pointer
// that does not, or (B > 1) a row stride of a number of floats that is not
// a multiple of 4.  Absent arrays (null) do not count.
template <int NX, int NU>
bool phased(const ChainArgs& r) {
  const auto off = [&](const float* p, size_t stride) {
    return p != nullptr && ((reinterpret_cast<uintptr_t>(p) & 15) != 0 ||
                            (r.B > 1 && stride % 4 != 0));
  };
  const size_t x = (size_t)(r.N + 1) * NX, u = (size_t)r.N * NU;
  return off(r.X_old, x) || off(r.U_old, u) || off(r.u_ff, u) ||
         off(r.K, u * NX) || off(r.X_out, x) || off(r.U_out, u);
}

template <class Model, int NX, int NU, int INTEG, int MODE>
int launch(const ChainArgs& r) {
  using R = Ring<NX, NU, MODE>;
  // The buffer's length must be the layout this instantiation reads.
  if (r.n_params != ParamLayout<NX, NU>::kModel + Model::kParams ||
      r.B < 1 || r.N < 1 || r.n_alpha < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockShape sh = R::shape(r.B, r.n_alpha);
  const int insts = sh.per_warp * sh.warps;
  const int bytes = R::bytes(insts);
  auto kernel = phased<NX, NU>(r)
                    ? chain_kernel<Model, NX, NU, INTEG, MODE, true>
                    : chain_kernel<Model, NX, NU, INTEG, MODE, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((r.B + insts - 1) / insts,
                  (r.n_alpha + kLanes - 1) / kLanes);
  kernel<<<grid, kLanes * (sh.warps + 1), bytes, r.stream>>>(
      r.params, r.B, sh.per_warp, r.x0, r.alphas, r.alpha_b, r.alpha, r.n_alpha,
      r.X_old, r.U_old, r.u_ff, r.K, r.N, r.newton_iters, r.costs, r.X_out,
      r.U_out);
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
  return {-1, -1};
}

}  // namespace

// Steps per ring stage and stages in the ring (for tests that cross them).
extern "C" int ilqr_chain_chunk_steps() { return kChunk; }
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
