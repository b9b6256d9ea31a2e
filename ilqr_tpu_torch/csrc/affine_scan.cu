// Multi-candidate affine prefix scan: delta_{k+1} = P_k delta_k + q_k^(a).
//
// Replaces: ilqr_tpu/ops/pallas_affine.py::_prefix_kernel_sub (launcher
// _prefix_scan_packed_sub, entry affine_prefix_scan_multi).
//
// Math (see ilqr_tpu_torch/ops/affine_scan.py): step k is the element
// (P_k, q_k^(1..A)); the transition chain P is shared by the A candidates.
// Elements combine as (P, q^a) o (P', q'^a) = (P'P, P'q^a + q'^a), earlier
// first, and the q part of the inclusive prefix at k is delta_{k+1} once
// the state entering the scan is folded into the first drive.
//
// What bounds it on an H100: latency and memory, not arithmetic.  A combine
// is n^3 + A n^2 FMAs (224 at n = 4, A = 10) on F = n^2 + A n floats, and a
// step reads P and q (F floats) and writes delta (A n floats) once; at
// N = 100000 that is ~40 MB of traffic for ~17 doubling sweeps of tiny
// products.  Nothing here needs tensor cores.
//
// Design.  The TPU kernel walks its blocks left to right on a sequential
// grid and carries the whole prefix element (F fields) in SMEM.  CUDA blocks
// run in no order, so the carry is its own pass, and it carries a state:
// closing a block's local prefix (P_loc, q_loc) at step k against the delta
// that enters the block gives delta_{k+1} = P_loc delta_in + q_loc, so only
// A n floats cross each block edge.
//   1. scan_kernel (aggregate mode): one thread per step loads its element
//      (the identity beyond N), runs a Hillis-Steele inclusive prefix scan
//      over kScanSteps elements in shared memory (field-major) and writes
//      only the block aggregate (the prefix at the block's last step).
//   2. walk_kernel: one thread per candidate walks the block aggregates
//      left to right from delta_0, staging them through shared memory in
//      chunks, and writes the state entering every block (and delta_0).
//   3. scan_kernel (final mode): the same local scan, with the state that
//      enters the block folded into its first drive (q_s += P_s delta_in),
//      so the local q prefix is delta itself; writes delta_{k+1}.
// Only delta leaves the chip: the P chain and the local prefixes stay in
// registers and shared memory (pass 1 recomputes what pass 3 needs instead
// of storing N elements).  Each thread keeps its own q for up to kMaxCand
// candidates in registers: the candidate loops are unrolled to kMaxCand with
// a runtime guard, so A stays a runtime count.
#include <cuda_runtime.h>

namespace {

constexpr int kScanSteps = 256;  // steps per scan block (threads of 1 and 3)
constexpr int kMaxCand = 16;     // most candidates a launch takes
constexpr int kWalkThreads = 128;
constexpr int kWalkChunk = 64;   // block aggregates staged per walk round

// Passes 1 and 3.  carry == nullptr: aggregate mode (writes agg); else
// final mode (folds carry[block] into the first drive and writes out).
template <int NX>
__global__ void __launch_bounds__(kScanSteps)
scan_kernel(const float* __restrict__ P, const float* __restrict__ q, int N,
            int A, const float* __restrict__ carry, float* __restrict__ agg,
            float* __restrict__ out) {
  constexpr int NN = NX * NX;
  extern __shared__ float smem[];  // (NN + A NX) x kScanSteps, field-major
  const int tid = threadIdx.x;
  const int k = blockIdx.x * kScanSteps + tid;
  float p[NN], v[kMaxCand][NX];
  if (k < N) {
#pragma unroll
    for (int f = 0; f < NN; ++f) p[f] = P[(size_t)k * NN + f];
#pragma unroll
    for (int a = 0; a < kMaxCand; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          v[a][i] = q[((size_t)a * N + k) * NX + i];
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < NN; ++f) p[f] = (f / NX == f % NX) ? 1.0f : 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxCand; ++a)
#pragma unroll
      for (int i = 0; i < NX; ++i) v[a][i] = 0.0f;
  }
  if (carry != nullptr && tid == 0) {
    const float* din = carry + (size_t)blockIdx.x * A * NX;
#pragma unroll
    for (int a = 0; a < kMaxCand; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j) s += p[i * NX + j] * din[a * NX + j];
          v[a][i] += s;
        }
      }
    }
  }
  for (int d = 1; d < kScanSteps; d <<= 1) {
#pragma unroll
    for (int f = 0; f < NN; ++f) smem[f * kScanSteps + tid] = p[f];
#pragma unroll
    for (int a = 0; a < kMaxCand; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          smem[(NN + a * NX + i) * kScanSteps + tid] = v[a][i];
      }
    }
    __syncthreads();
    if (tid >= d) {
      const int src = tid - d;  // the earlier partner
#pragma unroll
      for (int a = 0; a < kMaxCand; ++a) {
        if (a < A) {
          float qp[NX];
#pragma unroll
          for (int i = 0; i < NX; ++i)
            qp[i] = smem[(NN + a * NX + i) * kScanSteps + src];
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float s = v[a][i];
#pragma unroll
            for (int j = 0; j < NX; ++j) s += p[i * NX + j] * qp[j];
            v[a][i] = s;
          }
        }
      }
      float pp[NN], pn[NN];
#pragma unroll
      for (int f = 0; f < NN; ++f) pp[f] = smem[f * kScanSteps + src];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < NX; ++m) s += p[i * NX + m] * pp[m * NX + j];
          pn[i * NX + j] = s;
        }
#pragma unroll
      for (int f = 0; f < NN; ++f) p[f] = pn[f];
    }
    __syncthreads();
  }
  if (carry == nullptr) {
    if (tid == kScanSteps - 1) {
      float* e = agg + (size_t)blockIdx.x * (NN + A * NX);
#pragma unroll
      for (int f = 0; f < NN; ++f) e[f] = p[f];
#pragma unroll
      for (int a = 0; a < kMaxCand; ++a) {
        if (a < A) {
#pragma unroll
          for (int i = 0; i < NX; ++i) e[NN + a * NX + i] = v[a][i];
        }
      }
    }
  } else if (k < N) {
#pragma unroll
    for (int a = 0; a < kMaxCand; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          out[((size_t)a * (N + 1) + k + 1) * NX + i] = v[a][i];
      }
    }
  }
}

// Pass 2: the state entering every block, left to right from delta_0.
template <int NX>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const float* __restrict__ agg, int n_blocks, int A, int N,
            const float* __restrict__ delta0, float* __restrict__ carry,
            float* __restrict__ out) {
  constexpr int NN = NX * NX;
  extern __shared__ float smem[];  // kWalkChunk aggregates of F floats
  const int F = NN + A * NX;
  const int a = threadIdx.x;       // the candidate this thread walks
  float d[NX];
  if (a < A) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      d[i] = delta0[a * NX + i];
      out[(size_t)a * (N + 1) * NX + i] = d[i];
    }
  }
  for (int b0 = 0; b0 < n_blocks; b0 += kWalkChunk) {
    const int nb = min(kWalkChunk, n_blocks - b0);
    const int n_agg = min(nb, n_blocks - 1 - b0);  // the last block has none
    for (int i = threadIdx.x; i < n_agg * F; i += blockDim.x)
      smem[i] = agg[(size_t)b0 * F + i];
    __syncthreads();
    if (a < A) {
      for (int j = 0; j < nb; ++j) {
        float* c = carry + ((size_t)(b0 + j) * A + a) * NX;
#pragma unroll
        for (int i = 0; i < NX; ++i) c[i] = d[i];
        if (j < n_agg) {
          const float* e = smem + j * F;
          float dn[NX];
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float s = e[NN + a * NX + i];
#pragma unroll
            for (int m = 0; m < NX; ++m) s += e[i * NX + m] * d[m];
            dn[i] = s;
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) d[i] = dn[i];
        }
      }
    }
    __syncthreads();
  }
}

template <int NX>
int run(int A, int N, const float* P, const float* q, const float* delta0,
        float* agg, float* carry, float* out, cudaStream_t stream) {
  constexpr int NN = NX * NX;
  const int F = NN + A * NX;
  const int n_blocks = (N + kScanSteps - 1) / kScanSteps;
  const int scan_smem = static_cast<int>(sizeof(float) * F * kScanSteps);
  const int walk_smem = static_cast<int>(sizeof(float) * F * kWalkChunk);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<NX>, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 1) {
    // Aggregates of every block but the last, which nothing follows.
    scan_kernel<NX><<<n_blocks - 1, kScanSteps, scan_smem, stream>>>(
        P, q, N, A, nullptr, agg, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walk_kernel<NX><<<1, kWalkThreads, walk_smem, stream>>>(
      agg, n_blocks, A, N, delta0, carry, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<NX><<<n_blocks, kScanSteps, scan_smem, stream>>>(
      P, q, N, A, carry, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ilqr_affine_block_steps() { return kScanSteps; }

// Inputs P (N, n, n), q (A, N, n), delta0 (A, n); scratch agg
// (n_blocks, n^2 + A n) and carry (n_blocks, A, n); output out (A, N+1, n).
extern "C" int ilqr_affine_prefix_scan(int n, int A, int N, const float* P,
                                       const float* q, const float* delta0,
                                       float* agg, float* carry, float* out,
                                       void* stream) {
  if (A < 1 || A > kMaxCand || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 2) return run<2>(A, N, P, q, delta0, agg, carry, out, s);
  if (n == 4) return run<4>(A, N, P, q, delta0, agg, carry, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
