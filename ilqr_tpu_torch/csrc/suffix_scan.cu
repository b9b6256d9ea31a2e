// Standalone Riccati suffix scan over prebuilt elements.
//
// Replaces: ilqr_tpu/ops/pallas_riccati.py::_suffix_kernel_sub (B6; launcher
// _suffix_scan_packed_sub, entry suffix_scan_pallas(layout='sub')) and
// ::_suffix_kernel (B7; launcher _suffix_scan_packed with the XLA block
// closure _close_blocks, entry suffix_scan_pallas(layout='lane')).
//
// Math (see ilqr_tpu_torch/ops/parallel_riccati.py; the element layout and
// the combine are in riccati_scan.cuh, shared with fused_riccati.cu): given
// M elements e_0 .. e_{M-1}, return every suffix product
// s_k = e_k (x) e_{k+1} (x) ... (x) e_{M-1}, all five fields (A, b, C, eta,
// J).  The combine is associative, neither commutative nor idempotent.
//
// What bounds it on an H100.  Each element is read once and each suffix
// written once (2 F floats a step, F = 3 n_x^2 + 2 n_x), and the M combines
// of the sequential recursion are 40 n_x^3 operations each (JAX's count):
// by those counts the bytes bind (1.25 us for the pendulum at M = 32769).
// This design is bound by latency instead: three launches, log2(block)
// dependent combines a thread in pass 1, and pass 2's one thread walking
// every block aggregate in order (chip_smoke.py measured 0.10-0.18 ms at
// that shape and 0.89 ms for the double pendulum at M = 131073, 513 blocks;
// NVIDIA H100 80GB HBM3, 700 W).  Each element lives in one thread's
// registers, as in B1 (127 registers at n_x = 4, no spills).
//
// Design.  The TPU kernels walk their blocks right to left on a sequential
// grid and carry the suffix of the later blocks (B6 in SMEM, B7 through an
// XLA pass).  Blocks of a CUDA grid run in no order, so the carry is a pass
// of its own.  Unlike B1, whose carry is a value function (only (eta, J) of
// the later operand enter (eta, J) of a combine), every field of every
// suffix is an output here, so the carry is a whole element:
//   1. local_kernel: one thread per element loads it from the five input
//      tensors as they are (contiguous f32, no packing), runs a
//      Hillis-Steele suffix scan over BLOCK elements in shared memory
//      (field-major, conflict-free; at distance d each element joins the
//      adjacent window that starts d later, never overlapping ones; partners
//      past M-1 are skipped, i.e. the identity) and writes every block-local
//      suffix.
//   2. carry_kernel: one thread walks the block aggregates (each block's
//      local suffix at its first element) right to left with the full
//      combine and writes each block's right-edge element, the suffix of
//      all later blocks.
//   3. close_kernel: one thread per element combines its local suffix with
//      its block's right-edge element (the last block has none) and writes
//      the five outputs.
// The TPU's lane/sublane split has no meaning here: both entries run these
// passes, B6 ('sub') over blocks of 256 elements, B7 ('lane') over blocks of
// 128.
#include <cuda_runtime.h>

#include "riccati_scan.cuh"

namespace {

using namespace ilqr;

constexpr int kSubBlock = 256;   // B6: elements per scan block
constexpr int kLaneBlock = 128;  // B7: elements per scan block
constexpr int kCloseThreads = 128;

struct Elements {
  const float* A;    // (M, NX, NX)
  const float* b;    // (M, NX)
  const float* C;    // (M, NX, NX)
  const float* eta;  // (M, NX)
  const float* J;    // (M, NX, NX)
};

struct Outputs {
  float* A;
  float* b;
  float* C;
  float* eta;
  float* J;
};

template <int NX>
__device__ __forceinline__ void load_element(const Elements& in, int k,
                                             float* e) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  load<NN>(in.A + (size_t)k * NN, e + E::A);
  load<NX>(in.b + (size_t)k * NX, e + E::B);
  load<NN>(in.C + (size_t)k * NN, e + E::C);
  load<NX>(in.eta + (size_t)k * NX, e + E::ETA);
  load<NN>(in.J + (size_t)k * NN, e + E::J);
}

// Pass 1: the block-local inclusive suffix scan.
template <int NX, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
local_kernel(Elements in, int M, float* __restrict__ local) {
  using E = Elem<NX>;
  extern __shared__ float smem[];  // E::F x BLOCK, field-major
  const int tid = threadIdx.x;
  const int k = blockIdx.x * BLOCK + tid;
  float e[E::F];
  if (k < M) {
    load_element<NX>(in, k, e);
  } else {
    identity<NX>(e);
  }
  for (int d = 1; d < BLOCK; d <<= 1) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) smem[f * BLOCK + tid] = e[f];
    __syncthreads();
    // A partner past the last element is the identity: skip it.
    if (tid + d < BLOCK && k + d < M) {
      float p[E::F], o[E::F];
#pragma unroll
      for (int f = 0; f < E::F; ++f) p[f] = smem[f * BLOCK + tid + d];
      combine<NX>(e, p, o);
#pragma unroll
      for (int f = 0; f < E::F; ++f) e[f] = o[f];
    }
    __syncthreads();
  }
  if (k < M) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) local[(size_t)k * E::F + f] = e[f];
  }
}

// Pass 2: the element at the right edge of every block, i.e. the suffix of
// all later blocks; the last block's is the identity (never read).
template <int NX, int BLOCK>
__global__ void carry_kernel(const float* __restrict__ local, int n_blocks,
                             float* __restrict__ edge) {
  using E = Elem<NX>;
  if (threadIdx.x != 0) return;
  float run[E::F], agg[E::F], o[E::F];
  identity<NX>(run);
  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    float* out = edge + (size_t)blk * E::F;
#pragma unroll
    for (int f = 0; f < E::F; ++f) out[f] = run[f];
    if (blk == 0) break;
    load<E::F>(local + (size_t)blk * BLOCK * E::F, agg);
    if (blk == n_blocks - 1) {
#pragma unroll
      for (int f = 0; f < E::F; ++f) run[f] = agg[f];
    } else {
      combine<NX>(agg, run, o);
#pragma unroll
      for (int f = 0; f < E::F; ++f) run[f] = o[f];
    }
  }
}

// Pass 3: close each local suffix with its block's right-edge element.
template <int NX, int BLOCK>
__global__ void __launch_bounds__(kCloseThreads)
close_kernel(const float* __restrict__ local, const float* __restrict__ edge,
             int M, int n_blocks, Outputs out) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  const int k = blockIdx.x * kCloseThreads + threadIdx.x;
  if (k >= M) return;
  const int blk = k / BLOCK;
  float e[E::F], s[E::F];
  load<E::F>(local + (size_t)k * E::F, e);
  if (blk == n_blocks - 1) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) s[f] = e[f];
  } else {
    float r[E::F];
    load<E::F>(edge + (size_t)blk * E::F, r);
    combine<NX>(e, r, s);
  }
#pragma unroll
  for (int i = 0; i < NN; ++i) {
    out.A[(size_t)k * NN + i] = s[E::A + i];
    out.C[(size_t)k * NN + i] = s[E::C + i];
    out.J[(size_t)k * NN + i] = s[E::J + i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    out.b[(size_t)k * NX + i] = s[E::B + i];
    out.eta[(size_t)k * NX + i] = s[E::ETA + i];
  }
}

template <int NX, int BLOCK>
int run(int M, const Elements& in, float* local, float* edge,
        const Outputs& out, cudaStream_t stream) {
  using E = Elem<NX>;
  const int n_blocks = (M + BLOCK - 1) / BLOCK;
  const int smem = static_cast<int>(sizeof(float) * E::F * BLOCK);
  cudaError_t err = cudaFuncSetAttribute(
      local_kernel<NX, BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  local_kernel<NX, BLOCK><<<n_blocks, BLOCK, smem, stream>>>(in, M, local);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<NX, BLOCK><<<1, 32, 0, stream>>>(local, n_blocks, edge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int close_blocks = (M + kCloseThreads - 1) / kCloseThreads;
  close_kernel<NX, BLOCK><<<close_blocks, kCloseThreads, 0, stream>>>(
      local, edge, M, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

template <int BLOCK>
int dispatch(int n_x, int M, const Elements& in, float* local, float* edge,
             const Outputs& out, cudaStream_t stream) {
  if (n_x == 2) return run<2, BLOCK>(M, in, local, edge, out, stream);
  if (n_x == 4) return run<4, BLOCK>(M, in, local, edge, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Elements per scan block of each entry: lane = 0 (B6), 1 (B7).
extern "C" int ilqr_suffix_block_steps(int lane) {
  return lane ? kLaneBlock : kSubBlock;
}

// Inputs: the five element fields, (M, n_x, n_x) / (M, n_x).  Scratch:
// local (M, F), edge (n_blocks, F).  Outputs: the five fields of every
// suffix, shaped as the inputs.
extern "C" int ilqr_suffix_scan(int lane, int n_x, int M, const float* A,
                                const float* b, const float* C,
                                const float* eta, const float* J, float* local,
                                float* edge, float* A_out, float* b_out,
                                float* C_out, float* eta_out, float* J_out,
                                void* stream) {
  const Elements in{A, b, C, eta, J};
  const Outputs out{A_out, b_out, C_out, eta_out, J_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane) return dispatch<kLaneBlock>(n_x, M, in, local, edge, out, s);
  return dispatch<kSubBlock>(n_x, M, in, local, edge, out, s);
}
