// The chain kernels of B2 and B5 (line-search costs, trajectory, open
// loop) and their launcher, shared by the translation units that
// instantiate them for the systems, built in parallel: chain_rollout.cu
// (the pendulum and the double pendulum, and the library's entries),
// chain_models.cu (the cart-pole, the quadrotors and the car under the
// explicit rules), implicit_models.cu (their implicit rules), lti_rollout.cu
// (the LTI systems), tracking_*.cu and rate_*.cu (the wrappers over those),
// spring_chain.cu and neural_*.cu (the neural residual over those bases).
// The design is described in chain_rollout.cu; the systems are the forms
// of forms.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "forms.cuh"
#include "models.cuh"
#include "runs.cuh"

namespace ilqr {
namespace chain {


constexpr int kChunk = 32;              // steps per ring stage
constexpr int kStages = 4;              // ring depth
constexpr int kLanes = 32;              // lanes of a warp
constexpr int kMaxChainWarps = 3;       // chain warps a block
// Chain warps that fill an H100 at three an SM (132 SMs), and the shared
// memory a block may take.
constexpr int kTargetWarps = 396;
constexpr int kSmemBudget = 200 * 1024;
static_assert(kChunk % 4 == 0, "a chunk keeps each run's 16-byte phase");

// Model ids of the entries (ops/fused_rollout.py): the register models
// 0-6 and LtiRegs, the spring chain, and the wrappers and the neural
// residual, whose id is their offset plus the base's.
enum ModelId {
  kPendulum = 0,
  kDoublePendulum = 1,
  kCartpole = 2,
  kQuadrotor = 3,
  kQuadrotor3d = 4,
  kQuadrotor3dRotor = 5,
  kCar = 6,
  kLti = 7,
  kSpringChain = 8,
  kTracking = 16,
  kRate = 32,
  kNeural = 64,
};

// Steps per ring stage at (NX, NU): kChunk, or a quarter of it (at least 4)
// where the gains of a chunk would not fit (the spring chain's K row is
// 2 KB a step).
__host__ __device__ constexpr int chunk_steps(int n_x, int n_u) {
  return n_x * n_u > 64 ? (kChunk / 4 > 4 ? kChunk / 4 : 4) : kChunk;
}

// The system a kernel runs: a register model of models.cuh under the
// quadratic costs, or a form of forms.cuh as it is.
template <class M, class = void>
struct IsForm : std::false_type {};
template <class M>
struct IsForm<M, std::void_t<decltype(M::kForm)>> : std::true_type {};
template <class Model, int NX, int NU, int INTEG>
using FormOf = std::conditional_t<IsForm<Model>::value, Model,
                                  QuadraticForm<Model, NX, NU, INTEG>>;

enum Mode { kCosts = 0, kTrajectory = 1, kOpenLoop = 2 };

struct BlockShape {
  int per_warp;  // instances a chain warp
  int warps;     // chain warps a block
};

// A run of n floats in a stage: rounded up to 16 bytes, plus 16 bytes for
// its phase (runs.cuh).
__host__ __device__ constexpr int region(int n) { return (n + 3) / 4 * 4 + 4; }

// Shared memory of one block, in floats per instance and stage:
//   [4 kStages barriers | the form's shared parameters (HEAD floats) |
//    W x 32 lanes x WORK floats of the lanes' work |
//    kStages x I input regions | kStages x I outputs].
// The defaults of HEAD and WORK are those of a register model under the
// quadratic costs: the stage cost's matrices where they are shared.
template <int NX, int NU, int MODE,
          int HEAD = kCostShared<NX> ? cost_floats<NX, NU>() : 0,
          int WORK = 0>
struct Ring {
  static constexpr int kSteps = chunk_steps(NX, NU);   // steps a stage
  static_assert(kSteps % 4 == 0, "a chunk keeps each run's 16-byte phase");
  static constexpr bool kFeedback = MODE != kOpenLoop;
  static constexpr bool kStores = MODE != kCosts;
  // Input: X_old rows, U_old rows, u_ff rows, K rows (open loop: U_old).
  static constexpr int kX = 0;
  static constexpr int kU = kFeedback ? region(kSteps * NX) : 0;
  static constexpr int kF = kU + region(kSteps * NU);
  static constexpr int kK = kF + region(kSteps * NU);
  static constexpr int kIn =
      kFeedback ? kK + region(kSteps * NU * NX) : region(kSteps * NU);
  // Output: x_t rows, then u_t rows (trajectory kernel only).
  static constexpr int kOutU = region(kSteps * NX);
  static constexpr int kOut =
      MODE == kCosts ? 0
                     : kOutU + (MODE == kTrajectory ? region(kSteps * NU) : 0);
  static constexpr int kBarBytes = 4 * kStages * sizeof(uint64_t);
  // The form's shared parameters, rounded to 16 bytes.
  static constexpr int kCostBytes = (4 * HEAD + 15) / 16 * 16;
  static constexpr int kHeadBytes = kBarBytes + kCostBytes;
  static constexpr int kWarpBytes = sizeof(float) * kLanes * WORK;
  static constexpr int kInstBytes = sizeof(float) * kStages * (kIn + kOut);
  static int bytes(int insts, int warps) {
    return kHeadBytes + warps * kWarpBytes + insts * kInstBytes;
  }
  // B instances on about kTargetWarps chain warps: instances a warp,
  // within its lanes (lpi = min(n_alpha, 32) each), then chain warps a
  // block, within kMaxChainWarps and kSmemBudget (each warp with its
  // lanes' work).
  static BlockShape shape(int B, int n_alpha) {
    const int lpi = min(n_alpha, kLanes);
    const int fit =
        max(1, (kSmemBudget - kHeadBytes - kWarpBytes) / kInstBytes);
    const int per = max(1, min(min(kLanes / lpi, fit),
                               (B + kTargetWarps - 1) / kTargetWarps));
    const int warps =
        min(min(kMaxChainWarps, (B + per - 1) / per),
            max(1, (kSmemBudget - kHeadBytes) / (per * kInstBytes + kWarpBytes)));
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
  constexpr int kSteps = R::kSteps;
  const int n_chunks = (N + kSteps - 1) / kSteps;
  int loaded = 0;
  for (int c = 0; c < n_chunks; ++c) {
    for (; loaded < n_chunks && loaded < c + kStages; ++loaded) {
      const int s = loaded % kStages;
      const int t0 = loaded * kSteps, T = min(kSteps, N - t0);
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
      const int t0 = c * kSteps, T = min(kSteps, N - t0);
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
// else every run starts on 16 bytes.  Model: a register model of
// models.cuh (under INTEG and the quadratic costs) or a form of forms.cuh.
template <class Model, int NX, int NU, int INTEG, int MODE, bool PHASED>
__global__ void __launch_bounds__(kLanes * (kMaxChainWarps + 1), 1)
chain_kernel(const float* __restrict__ params, int B, int per_warp,
             const float* __restrict__ x0, const float* __restrict__ alphas,
             const float* __restrict__ alpha_b, float alpha, int n_alpha,
             const float* __restrict__ X_old, const float* __restrict__ U_old,
             const float* __restrict__ u_ff, const float* __restrict__ K,
             int N, int newton_iters, float* __restrict__ costs,
             float* __restrict__ X_out, float* __restrict__ U_out) {
  using F = FormOf<Model, NX, NU, INTEG>;
  using R = Ring<NX, NU, MODE, F::kSmem, F::kWork>;
  constexpr int kSteps = R::kSteps;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const Barriers b{bars, bars + kStages, bars + 2 * kStages,
                   bars + 3 * kStages};
  const int warps = blockDim.x / kLanes - 1;  // chain warps
  const int insts = warps * per_warp;          // instances a block
  float* head_sm = reinterpret_cast<float*>(smem + R::kBarBytes);
  float* work_sm = reinterpret_cast<float*>(smem + R::kHeadBytes);
  float* in = reinterpret_cast<float*>(smem + R::kHeadBytes +
                                       warps * R::kWarpBytes);
  float* out = in + kStages * insts * R::kIn;
  const int b0 = blockIdx.x * insts;
  const int here = min(insts, B - b0);  // the block's instances

  if constexpr (F::kSmem > 0) F::fill(params, head_sm);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&b.full[s], here);
      mbar_init(&b.empty[s], kLanes * warps);
      mbar_init(&b.ofull[s], here);
      mbar_init(&b.oempty[s], here);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the block's only barrier: mbarriers and costs ready
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
  F form;
  form.load(params, head_sm);
  // The lane's work (the wide implicit rules), interleaved with its warp's.
  float* work = F::kWork > 0 ? work_sm + warp * kLanes * F::kWork + lane
                             : nullptr;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[(size_t)inst * NX + i];
  float cost = 0.0f;

  const int n_chunks = (N + kSteps - 1) / kSteps;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const uint32_t parity = (c / kStages) & 1;
    const int T = min(kSteps, N - c * kSteps);
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
      cost += form.stage(x, u);
      float xn[NX];
      form.step(x, u, xn, newton_iters, work);
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
  costs[(size_t)inst * n_alpha + a] = cost + form.terminal(x);
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

// BOTH: the instantiation with shifts fixed at 0 is built beside the
// phased one and taken when every run starts on 16 bytes (the register
// models); else the phased one runs every launch (the other forms: half
// the instantiations to build).
template <class Model, int NX, int NU, int INTEG, int MODE, bool BOTH = true>
int launch(const ChainArgs& r) {
  using F = FormOf<Model, NX, NU, INTEG>;
  using R = Ring<NX, NU, MODE, F::kSmem, F::kWork>;
  // The buffer's length must be the layout this instantiation reads.
  if (!F::params_ok(r.n_params) || r.B < 1 || r.N < 1 || r.n_alpha < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockShape sh = R::shape(r.B, r.n_alpha);
  const int insts = sh.per_warp * sh.warps;
  const int bytes = R::bytes(insts, sh.warps);
  auto kernel = chain_kernel<Model, NX, NU, INTEG, MODE, true>;
  if constexpr (BOTH) {
    if (!phased<NX, NU>(r)) kernel = chain_kernel<Model, NX, NU, INTEG, MODE, false>;
  }
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

// The explicit integrators only (chain_models.cu; the implicit rules of
// those models are instantiated in implicit_models.cu).
template <class Model, int NX, int NU, int MODE>
int by_explicit_integrator(int integrator, const ChainArgs& r) {
  switch (integrator) {
    case kEuler: return launch<Model, NX, NU, kEuler, MODE>(r);
    case kMidpoint: return launch<Model, NX, NU, kMidpoint, MODE>(r);
    case kRk4: return launch<Model, NX, NU, kRk4, MODE>(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A system Form<INTEG> (a form, or a register model whatever INTEG) under
// the explicit integrators, and 'discrete' where DISCRETE, in the phased
// instantiation only.
template <template <int> class Form, int NX, int NU, int MODE, bool DISCRETE>
int by_form_integrator(int integrator, const ChainArgs& r) {
  switch (integrator) {
    case kEuler: return launch<Form<kEuler>, NX, NU, kEuler, MODE, false>(r);
    case kMidpoint:
      return launch<Form<kMidpoint>, NX, NU, kMidpoint, MODE, false>(r);
    case kRk4: return launch<Form<kRk4>, NX, NU, kRk4, MODE, false>(r);
    case kDiscrete:
      if constexpr (DISCRETE) {
        return launch<Form<kDiscrete>, NX, NU, kDiscrete, MODE, false>(r);
      }
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The systems of the other translation units, each under mode 0 (costs),
// 1 (trajectory) or 2 (open loop); cudaErrorInvalidValue for what none
// instantiates.  Model ids as ModelId.
// chain_models.cu: models 2-6 under euler, midpoint, rk4.
int dispatch_models(int mode, int model, int integrator, int n_x, int n_u,
                    const ChainArgs& r);
// implicit_models.cu: models 2-6 under backward Euler and trapezoidal.
int dispatch_implicit(int mode, int model, int integrator, int n_x, int n_u,
                      const ChainArgs& r);
// lti_rollout.cu: kLti.
int dispatch_lti(int mode, int integrator, int n_x, int n_u,
                 const ChainArgs& r);
// tracking_models.cu, tracking_lti.cu: kTracking + the base's id.
int dispatch_tracking_models(int mode, int base, int integrator, int n_x,
                             int n_u, const ChainArgs& r);
int dispatch_tracking_lti(int mode, int integrator, int n_x, int n_u,
                          const ChainArgs& r);
// rate_models.cu, rate_lti.cu: kRate + the base's id; integrator: the
// base's.
int dispatch_rate_models(int mode, int base, int integrator, int n_x,
                         int n_u, const ChainArgs& r);
int dispatch_rate_lti(int mode, int integrator, int n_x, int n_u,
                      const ChainArgs& r);
// spring_chain.cu: kSpringChain.
int dispatch_spring_chain(int mode, int integrator, int n_x, int n_u,
                          const ChainArgs& r);
// neural_models.cu, neural_lti.cu: kNeural + the base's id.
int dispatch_neural_models(int mode, int base, int integrator, int n_x,
                           int n_u, const ChainArgs& r);
int dispatch_neural_lti(int mode, int integrator, int n_x, int n_u,
                        const ChainArgs& r);

// The three modes of a dispatch template D<MODE>(args...).
#define ILQR_CHAIN_MODES(D, mode, ...)                                   \
  switch (mode) {                                                        \
    case kCosts: return D<kCosts>(__VA_ARGS__);                          \
    case kTrajectory: return D<kTrajectory>(__VA_ARGS__);                \
    case kOpenLoop: return D<kOpenLoop>(__VA_ARGS__);                    \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace chain
}  // namespace ilqr
