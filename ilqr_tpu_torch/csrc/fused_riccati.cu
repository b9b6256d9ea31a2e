// Fused Riccati backward pass: elements, suffix scan, closure and gains.
//
// Replaces: ilqr_tpu/ops/pallas_riccati.py::_fused_kernel (launcher
// _fused_backward_packed, entry backward_pass_pallas_fused).
//
// Math (see ilqr_tpu_torch/ops/parallel_riccati.py; the element layout and
// the combine are in riccati_scan.cuh, shared with suffix_scan.cu): step k
// of the LQ subproblem is the element e_k = (A, b, C, eta, J) and the
// terminal cost the element (0, 0, 0, -v_x, v_xx).  The suffix products
// e_k (x) ... (x) e_N under the associative, non-commutative combine carry
// the cost-to-go V(k) = (J, -eta); the gains at k come from V(k+1).
//
// What bounds it on an H100: arithmetic and registers.  One combine is a
// 4x4 inverse and about ten 4x4 products (~1.3 kflop at n_x = 4) on an
// element of F = 3 n_x^2 + 2 n_x = 56 floats, and a recursive-doubling
// scan does log2(block) of them per step; the expansion read and the gains
// written are ~100 bytes a step.  With each element in one thread's
// registers, the register file (not shared memory or DRAM) caps how many
// threads an SM holds.
//
// Design.  The TPU kernel walks its blocks right to left on a sequential
// grid and carries the combined suffix of the later blocks in SMEM.  Blocks
// of a CUDA grid run in no order, so the cross-block carry is its own pass:
//   1. scan_blocks_kernel: one thread per step builds its element from the
//      expansion (R = l_uu + reg I inverted in closed form), then a
//      Hillis-Steele suffix scan over kBlockSteps elements in shared memory
//      (field-major, conflict-free).  At distance d each element joins the
//      adjacent window that starts d later, so the windows never overlap:
//      the combine is neither commutative nor idempotent.  Writes every
//      block-local suffix element.
//   2. boundary_kernel: one thread walks the blocks right to left and
//      applies each block's aggregate (its local suffix at the block start)
//      to the running value (eta, J).  Only (eta, J) of the later operand
//      enter the (eta, J) of a combine, so the carry is a value function,
//      not a whole element.  Writes the value at each block's right edge.
//   3. gains_kernel: one thread per step t closes the local suffix at t+1
//      with the value at its block's right edge, which gives V(t+1) without
//      a shift across blocks, then forms the Q-expansion, the gains and the
//      per-step dV, and reduces dV and a non-finite count per block.
// No TPU packing is reproduced: the expansion tensors are read as they are.
//
// GNMS defects (multiple shooting, B1d; the with_defects variant of the TPU
// kernel): with gaps d_k the local dynamics are affine, dx+ = f_x dx +
// f_u du + d_k, which adds d_k to the stage element's b (pass 1) and shifts
// the gains' linear terms by V_x(t+1) += V_xx(t+1) d_t (pass 3).  A null
// defects pointer is the plain backward pass.
#include <cuda_runtime.h>
#include <math.h>

#include "riccati_scan.cuh"

namespace {

using namespace ilqr;

constexpr int kBlockSteps = 256;  // steps per scan block (pass 1 threads)
constexpr int kGainThreads = 128;  // threads per block of pass 3

struct Expansion {
  const float* f_x;   // (N, NX, NX)
  const float* f_u;   // (N, NX, NU)
  const float* l_x;   // (N, NX)
  const float* l_u;   // (N, NU)
  const float* l_xx;  // (N, NX, NX)
  const float* l_ux;  // (N, NU, NX)
  const float* l_uu;  // (N, NU, NU)
  const float* v_x;   // (NX,)
  const float* v_xx;  // (NX, NX)
  const float* d;     // (N, NX) GNMS defects, or nullptr
};

// Element k: a stage leaf for k < N, the terminal element at k = N, the
// combine identity (A = I, rest 0) beyond.
template <int NX, int NU>
__device__ __forceinline__ void build_element(int k, int N,
                                              const Expansion& ex, float reg,
                                              float* e) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
#pragma unroll
  for (int i = 0; i < E::F; ++i) e[i] = 0.0f;
  if (k < N) {
    float f_x[NN], f_u[NX * NU], l_x[NX], l_u[NU], l_xx[NN], l_ux[NU * NX],
        R[NU * NU];
    load<NN>(ex.f_x + (size_t)k * NN, f_x);
    load<NX * NU>(ex.f_u + (size_t)k * NX * NU, f_u);
    load<NX>(ex.l_x + (size_t)k * NX, l_x);
    load<NU>(ex.l_u + (size_t)k * NU, l_u);
    load<NN>(ex.l_xx + (size_t)k * NN, l_xx);
    load<NU * NX>(ex.l_ux + (size_t)k * NU * NX, l_ux);
    load<NU * NU>(ex.l_uu + (size_t)k * NU * NU, R);
#pragma unroll
    for (int d = 0; d < NU; ++d) R[d * NU + d] += reg;
    float Ri[NU * NU], RiM[NU * NX], RiBt[NU * NX], Rir[NU];
    inv<NU>(R, Ri);
    mm<NU, NU, NX>(Ri, l_ux, RiM);
    mmt<NU, NU, NX>(Ri, f_u, RiBt);
    mv<NU, NU>(Ri, l_u, Rir);
    float T[NN], v[NX];
    // A = f_x - f_u R^-1 M
    mm<NX, NU, NX>(f_u, RiM, T);
#pragma unroll
    for (int i = 0; i < NN; ++i) e[E::A + i] = f_x[i] - T[i];
    // b = -f_u R^-1 r
    mv<NX, NU>(f_u, Rir, v);
#pragma unroll
    for (int i = 0; i < NX; ++i) e[E::B + i] = -v[i];
    if (ex.d != nullptr) {
#pragma unroll
      for (int i = 0; i < NX; ++i) e[E::B + i] += ex.d[(size_t)k * NX + i];
    }
    // C = sym(f_u R^-1 f_u')
    mm<NX, NU, NX>(f_u, RiBt, T);
    sym<NX>(T, e + E::C);
    // J = sym(l_xx - M' R^-1 M)
    mtm<NX, NU, NX>(l_ux, RiM, T);
#pragma unroll
    for (int i = 0; i < NN; ++i) T[i] = l_xx[i] - T[i];
    sym<NX>(T, e + E::J);
    // eta = -(l_x - M' R^-1 r)
    mtv<NX, NU>(l_ux, Rir, v);
#pragma unroll
    for (int i = 0; i < NX; ++i) e[E::ETA + i] = -(l_x[i] - v[i]);
  } else if (k == N) {
#pragma unroll
    for (int i = 0; i < NX; ++i) e[E::ETA + i] = -ex.v_x[i];
    load<NN>(ex.v_xx, e + E::J);
  } else {
#pragma unroll
    for (int d = 0; d < NX; ++d) e[E::A + d * NX + d] = 1.0f;
  }
}

// Pass 1: elements and the block-local inclusive suffix scan.
template <int NX, int NU>
__global__ void __launch_bounds__(kBlockSteps)
scan_blocks_kernel(Expansion ex, int N, float reg, float* __restrict__ local) {
  using E = Elem<NX>;
  extern __shared__ float smem[];  // E::F x kBlockSteps, field-major
  const int tid = threadIdx.x;
  const int k = blockIdx.x * kBlockSteps + tid;
  float e[E::F];
  build_element<NX, NU>(k, N, ex, reg, e);
  for (int d = 1; d < kBlockSteps; d <<= 1) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) smem[f * kBlockSteps + tid] = e[f];
    __syncthreads();
    // A partner past the terminal element is the identity: skip it.
    if (tid + d < kBlockSteps && k + d <= N) {
      float p[E::F], o[E::F];
#pragma unroll
      for (int f = 0; f < E::F; ++f) p[f] = smem[f * kBlockSteps + tid + d];
      combine<NX>(e, p, o);
#pragma unroll
      for (int f = 0; f < E::F; ++f) e[f] = o[f];
    }
    __syncthreads();
  }
  if (k <= N) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) local[(size_t)k * E::F + f] = e[f];
  }
}

// Pass 2: the value (eta, J) at the right edge of every block, i.e. the
// suffix of all later blocks; the last block's is zero (identity).
template <int NX>
__global__ void boundary_kernel(const float* __restrict__ local, int n_blocks,
                                float* __restrict__ edge) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  if (threadIdx.x != 0) return;
  float eta[NX], J[NN], eta2[NX], J2[NN], Li[NN], e[E::F];
#pragma unroll
  for (int i = 0; i < NX; ++i) eta[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NN; ++i) J[i] = 0.0f;
  for (int b = n_blocks - 1; b >= 0; --b) {
    float* out = edge + (size_t)b * (NX + NN);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = eta[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) out[NX + i] = J[i];
    load<E::F>(local + (size_t)b * kBlockSteps * E::F, e);
    apply_value<NX>(e, eta, J, eta2, J2, Li);
#pragma unroll
    for (int i = 0; i < NX; ++i) eta[i] = eta2[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) J[i] = J2[i];
  }
}

// Pass 3: V(t+1) by closure, then the gains and dV at step t.
template <int NX, int NU>
__global__ void __launch_bounds__(kGainThreads)
gains_kernel(Expansion ex, int N, float reg, const float* __restrict__ local,
             const float* __restrict__ edge, float* __restrict__ u_ff_out,
             float* __restrict__ K_out, float* __restrict__ partials) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  extern __shared__ float smem[];  // 3 x kGainThreads
  const int tid = threadIdx.x;
  const int t = blockIdx.x * kGainThreads + tid;
  float dv1 = 0.0f, dv2 = 0.0f, bad = 0.0f;
  if (t < N) {
    const int j = t + 1;
    float e[E::F], eta_n[NX], J_n[NN], Li[NN];
    load<E::F>(local + (size_t)j * E::F, e);
    const float* V = edge + (size_t)(j / kBlockSteps) * (NX + NN);
    apply_value<NX>(e, V, V + NX, eta_n, J_n, Li);

    float f_x[NN], f_u[NX * NU], l_u[NU], Q_ux[NU * NX], Q_uu[NU * NU];
    load<NN>(ex.f_x + (size_t)t * NN, f_x);
    load<NX * NU>(ex.f_u + (size_t)t * NX * NU, f_u);
    load<NU>(ex.l_u + (size_t)t * NU, l_u);
    float v_x[NX], fuT_Vxx[NU * NX], Q_u[NU], T[NU * NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) v_x[i] = -eta_n[i];
    if (ex.d != nullptr) {
      float d_t[NX], Jd[NX];
      load<NX>(ex.d + (size_t)t * NX, d_t);
      mv<NX, NX>(J_n, d_t, Jd);
#pragma unroll
      for (int i = 0; i < NX; ++i) v_x[i] += Jd[i];
    }
    mtm<NU, NX, NX>(f_u, J_n, fuT_Vxx);
    mtv<NU, NX>(f_u, v_x, Q_u);
#pragma unroll
    for (int i = 0; i < NU; ++i) Q_u[i] += l_u[i];
    mm<NU, NX, NX>(fuT_Vxx, f_x, Q_ux);
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) Q_ux[i] += ex.l_ux[(size_t)t * NU * NX + i];
    mm<NU, NX, NU>(fuT_Vxx, f_u, T);
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) T[i] += ex.l_uu[(size_t)t * NU * NU + i];
#pragma unroll
    for (int d = 0; d < NU; ++d) T[d * NU + d] += reg;
    sym<NU>(T, Q_uu);
    float Qi[NU * NU], K[NU * NX], u_ff[NU], q[NU];
    inv<NU>(Q_uu, Qi);
    mm<NU, NU, NX>(Qi, Q_ux, K);
    mv<NU, NU>(Qi, Q_u, u_ff);
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) {
      K[i] = -K[i];
      K_out[(size_t)t * NU * NX + i] = K[i];
      if (!isfinite(K[i])) bad = 1.0f;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      u_ff[i] = -u_ff[i];
      u_ff_out[(size_t)t * NU + i] = u_ff[i];
      if (!isfinite(u_ff[i])) bad = 1.0f;
    }
    mv<NU, NU>(Q_uu, u_ff, q);
    float uu = 0.0f, uQu = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      dv1 += u_ff[i] * Q_u[i];
      uQu += u_ff[i] * q[i];
      uu += u_ff[i] * u_ff[i];
    }
    dv2 = 0.5f * (uQu - reg * uu);
  }
  smem[tid] = dv1;
  smem[kGainThreads + tid] = dv2;
  smem[2 * kGainThreads + tid] = bad;
  __syncthreads();
  for (int s = kGainThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      smem[tid] += smem[tid + s];
      smem[kGainThreads + tid] += smem[kGainThreads + tid + s];
      smem[2 * kGainThreads + tid] += smem[2 * kGainThreads + tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    partials[blockIdx.x * 3 + 0] = smem[0];
    partials[blockIdx.x * 3 + 1] = smem[kGainThreads];
    partials[blockIdx.x * 3 + 2] = smem[2 * kGainThreads];
  }
}

template <int NX, int NU>
int run(int N, float reg, const Expansion& ex, float* local, float* edge,
        float* u_ff, float* K, float* partials, cudaStream_t stream) {
  using E = Elem<NX>;
  const int n_blocks = (N + 1 + kBlockSteps - 1) / kBlockSteps;
  const int scan_smem = static_cast<int>(sizeof(float) * E::F * kBlockSteps);
  cudaError_t err = cudaFuncSetAttribute(
      scan_blocks_kernel<NX, NU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      scan_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_blocks_kernel<NX, NU><<<n_blocks, kBlockSteps, scan_smem, stream>>>(
      ex, N, reg, local);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  boundary_kernel<NX><<<1, 32, 0, stream>>>(local, n_blocks, edge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gain_blocks = (N + kGainThreads - 1) / kGainThreads;
  gains_kernel<NX, NU><<<gain_blocks, kGainThreads,
                         3 * kGainThreads * sizeof(float), stream>>>(
      ex, N, reg, local, edge, u_ff, K, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ilqr_riccati_block_steps() { return kBlockSteps; }
extern "C" int ilqr_riccati_gain_threads() { return kGainThreads; }

// defects: (N, n_x) or null.  Scratch: local (N+1, F), edge
// (n_blocks, n_x + n_x^2); outputs u_ff
// (N, n_u), K (N, n_u, n_x), partials (gain_blocks, 3) = per-block sums of
// dV1, dV2 and the count of non-finite gains.
extern "C" int ilqr_fused_riccati(
    int n_x, int n_u, int N, float reg, const float* f_x, const float* f_u,
    const float* l_x, const float* l_u, const float* l_xx, const float* l_ux,
    const float* l_uu, const float* v_x, const float* v_xx,
    const float* defects, float* local, float* edge, float* u_ff, float* K,
    float* partials, void* stream) {
  const Expansion ex{f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx,
                     defects};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_x == 2 && n_u == 1)
    return run<2, 1>(N, reg, ex, local, edge, u_ff, K, partials, s);
  if (n_x == 4 && n_u == 1)
    return run<4, 1>(N, reg, ex, local, edge, u_ff, K, partials, s);
  if (n_x == 4 && n_u == 2)
    return run<4, 2>(N, reg, ex, local, edge, u_ff, K, partials, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
