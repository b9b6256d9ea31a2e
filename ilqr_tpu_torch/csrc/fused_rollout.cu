// Sequential closed-loop rollout kernels for a batch of instances (B5):
// line-search costs, trajectories at one alpha per instance, open loop.
//
// Replaces: ilqr_tpu/ops/pallas_batched.py::_rollout_kernel (launcher
// _rollout_batched_call; entries linesearch_costs_batched,
// closed_loop_rollout_batched and open_loop_rollout_batched), B5.  The
// single-instance kernels (B2) are chain_rollout.cu.
//
// What bounds it on an H100: latency.  The recursion
//   u_t = u_old_t + a*u_ff_t + K_t (x_t - x_old_t),  x_{t+1} = step(x_t, u_t)
// is a chain of N dependent steps of a few hundred flops on a handful of
// floats; no amount of bandwidth or SM count shortens it.  What the chain
// must not do is wait on device memory once per step.
//
// Design: one thread per alpha candidate (a block of 32 holds the whole
// schedule), state and cost in registers, the model, integrator and
// quadratic costs inlined from models.cuh.  Every candidate reads the same
// step inputs, so the block stages the next kChunk steps of X_old, U_old,
// u_ff and K in shared memory with coalesced loads, and the chain then
// reads shared memory only.  The parameter buffer is staged once.  The
// costs kernel stores no trajectory; the trajectory kernel (TRAJ) runs one
// alpha and writes X, U and the final state.  Unlike the TPU kernel, the
// time loop is exactly N steps: no chunk padding, alpha padding or masking.
//
// Grid dimension x is the instance.  Each block offsets its pointers to its
// instance's rows of the (B, ...) inputs and outputs, so B instances run as
// B independent blocks spread over the SMs.  The TPU kernel put the batch
// on the vector lanes and walked the candidates on an outer sequential grid
// axis; here candidates are threads and instances are blocks, and nothing
// is padded to tiles.  The trajectory kernel takes one alpha per instance
// (alpha_b), and null X_old/u_ff/K pointers drop the feedback terms: the
// open-loop rollout u = U_old (where the TPU entry fed zeros through the
// closed loop).  chain_rollout.cu's warp-specialised ring could serve this
// kernel too (ROADMAP B5).
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using namespace ilqr;

constexpr int kCandidates = 32;  // threads per block, one per alpha
constexpr int kChunk = 64;       // steps staged in shared memory per pass

template <class Model, int NX, int NU, int INTEG, bool TRAJ>
__global__ void __launch_bounds__(kCandidates)
rollout_kernel(const float* __restrict__ params, int n_params,
               const float* __restrict__ x0,
               const float* __restrict__ alphas,
               const float* __restrict__ alpha_b, int n_alpha,
               const float* __restrict__ X_old, const float* __restrict__ U_old,
               const float* __restrict__ u_ff, const float* __restrict__ K,
               int N, float* __restrict__ costs, float* __restrict__ X_out,
               float* __restrict__ U_out) {
  extern __shared__ float smem[];
  // This block's instance: its rows of every (B, ...) argument.
  const size_t inst = blockIdx.x;
  const bool feedback = u_ff != nullptr;
  x0 += inst * NX;
  U_old += inst * N * NU;
  if (feedback) {
    X_old += inst * (N + 1) * NX;
    u_ff += inst * N * NU;
    K += inst * N * NU * NX;
  }
  costs += inst * n_alpha;
  if constexpr (TRAJ) {
    X_out += inst * (N + 1) * NX;
    U_out += inst * N * NU;
  }
  float* sp = smem;                        // parameter buffer
  float* sX = sp + n_params;               // kChunk x NX
  float* sU = sX + kChunk * NX;            // kChunk x NU
  float* sF = sU + kChunk * NU;            // kChunk x NU
  float* sK = sF + kChunk * NU;            // kChunk x NU x NX

  const int tid = threadIdx.x;
  const int a = blockIdx.y * blockDim.x + tid;
  const bool active = a < n_alpha;
  float al = 0.0f;  // the open loop has no feedback terms
  if (active && alphas != nullptr) al = alphas[a];
  if (alpha_b != nullptr) al = alpha_b[inst];

  for (int i = tid; i < n_params; i += blockDim.x) sp[i] = params[i];
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i];
  float cost = 0.0f;

  for (int t0 = 0; t0 < N; t0 += kChunk) {
    const int T = min(kChunk, N - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < T * NU; i += blockDim.x) sU[i] = U_old[t0 * NU + i];
    if (feedback) {
      for (int i = tid; i < T * NX; i += blockDim.x)
        sX[i] = X_old[t0 * NX + i];
      for (int i = tid; i < T * NU; i += blockDim.x) sF[i] = u_ff[t0 * NU + i];
      for (int i = tid; i < T * NU * NX; i += blockDim.x)
        sK[i] = K[t0 * NU * NX + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < T; ++s) {
      float u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = sU[s * NU + i];
        if (feedback) {
          acc += al * sF[s * NU + i];
#pragma unroll
          for (int j = 0; j < NX; ++j)
            acc += sK[(s * NU + i) * NX + j] * (x[j] - sX[s * NX + j]);
        }
        u[i] = acc;
      }
      if constexpr (TRAJ) {
#pragma unroll
        for (int i = 0; i < NX; ++i) X_out[(t0 + s) * NX + i] = x[i];
#pragma unroll
        for (int i = 0; i < NU; ++i) U_out[(t0 + s) * NU + i] = u[i];
      }
      cost += stage_cost<NX, NU>(sp, x, u);
      float xn[NX];
      step<Model, NX, NU, INTEG>(sp, x, u, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
  }
  if (!active) return;
  cost += terminal_cost<NX, NU>(sp, x);
  costs[a] = cost;
  if constexpr (TRAJ) {
#pragma unroll
    for (int i = 0; i < NX; ++i) X_out[N * NX + i] = x[i];
  }
}

struct RolloutArgs {
  const float* params;
  int n_params;
  int B;
  const float* x0;
  const float* alphas;
  const float* alpha_b;
  int n_alpha;
  const float* X_old;
  const float* U_old;
  const float* u_ff;
  const float* K;
  int N;
  float* costs;
  float* X_out;
  float* U_out;
  cudaStream_t stream;
};

template <class Model, int NX, int NU, int INTEG, bool TRAJ>
int launch(const RolloutArgs& r) {
  const dim3 grid(r.B, (r.n_alpha + kCandidates - 1) / kCandidates);
  const size_t smem =
      sizeof(float) * (r.n_params + kChunk * (NX + 2 * NU + NU * NX));
  rollout_kernel<Model, NX, NU, INTEG, TRAJ>
      <<<grid, kCandidates, smem, r.stream>>>(
          r.params, r.n_params, r.x0, r.alphas, r.alpha_b, r.n_alpha,
          r.X_old, r.U_old, r.u_ff, r.K, r.N, r.costs, r.X_out, r.U_out);
  return static_cast<int>(cudaGetLastError());
}

template <class Model, int NX, int NU, bool TRAJ>
int by_integrator(int integrator, const RolloutArgs& r) {
  switch (integrator) {
    case kEuler: return launch<Model, NX, NU, kEuler, TRAJ>(r);
    case kMidpoint: return launch<Model, NX, NU, kMidpoint, TRAJ>(r);
    case kRk4: return launch<Model, NX, NU, kRk4, TRAJ>(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// model: 0 = pendulum (n_x 2, n_u 1), 1 = double pendulum (n_x 4, n_u 1|2).
template <bool TRAJ>
int dispatch(int model, int integrator, int n_x, int n_u,
             const RolloutArgs& r) {
  if (model == 0 && n_x == 2 && n_u == 1)
    return by_integrator<Pendulum, 2, 1, TRAJ>(integrator, r);
  if (model == 1 && n_x == 4 && n_u == 1)
    return by_integrator<DoublePendulum, 4, 1, TRAJ>(integrator, r);
  if (model == 1 && n_x == 4 && n_u == 2)
    return by_integrator<DoublePendulum, 4, 2, TRAJ>(integrator, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B5.  Batched candidate costs (B, n_alpha): instance b rolls out from
// x0s[b] along its own X_old[b], U_old[b], u_ff[b], K[b] (all (B, ...),
// contiguous) for every alpha of the shared schedule.
extern "C" int ilqr_linesearch_costs_batched(
    int model, int integrator, int n_x, int n_u, const float* params,
    int n_params, int B, const float* x0s, const float* alphas, int n_alpha,
    const float* X_old, const float* U_old, const float* u_ff, const float* K,
    int N, float* costs, void* stream) {
  RolloutArgs r{params, n_params, B, x0s, alphas, nullptr, n_alpha,
                X_old, U_old, u_ff, K, N, costs, nullptr, nullptr,
                static_cast<cudaStream_t>(stream)};
  return dispatch<false>(model, integrator, n_x, n_u, r);
}

// B5.  Batched trajectories at one alpha per instance, alpha_b (B,):
// X (B, N+1, n_x), U (B, N, n_u) and cost (B,).  Null u_ff and K (X_old
// unused) give the open-loop rollout of U_old.
extern "C" int ilqr_closed_loop_rollout_batched(
    int model, int integrator, int n_x, int n_u, const float* params,
    int n_params, int B, const float* x0s, const float* alpha_b,
    const float* X_old, const float* U_old, const float* u_ff, const float* K,
    int N, float* cost, float* X_out, float* U_out, void* stream) {
  RolloutArgs r{params, n_params, B, x0s, nullptr, alpha_b, 1, X_old,
                U_old, u_ff, K, N, cost, X_out, U_out,
                static_cast<cudaStream_t>(stream)};
  return dispatch<true>(model, integrator, n_x, n_u, r);
}

// B5.  Batched open-loop rollouts of U (B, N, n_u) from x0s (B, n_x):
// X (B, N+1, n_x) and cost (B,); U_out receives a copy of U.
extern "C" int ilqr_open_loop_rollout_batched(
    int model, int integrator, int n_x, int n_u, const float* params,
    int n_params, int B, const float* x0s, const float* U, int N, float* cost,
    float* X_out, float* U_out, void* stream) {
  RolloutArgs r{params, n_params, B, x0s, nullptr, nullptr, 1, nullptr,
                U, nullptr, nullptr, N, cost, X_out, U_out,
                static_cast<cudaStream_t>(stream)};
  return dispatch<true>(model, integrator, n_x, n_u, r);
}

extern "C" const char* ilqr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
