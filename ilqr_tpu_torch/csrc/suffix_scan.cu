// Standalone Riccati suffix scan over prebuilt elements.
//
// Replaces: ilqr_tpu/ops/pallas_riccati.py::_suffix_kernel_sub (B6; launcher
// _suffix_scan_packed_sub, entry suffix_scan_pallas(layout='sub')) and
// ::_suffix_kernel (B7; launcher _suffix_scan_packed with the XLA block
// closure _close_blocks, entry suffix_scan_pallas(layout='lane')).
//
// Math (see ilqr_tpu_torch/ops/parallel_riccati.py; the element layout, the
// combine and the tile scan are in riccati_scan.cuh, shared with
// fused_riccati.cu): given M elements e_0 .. e_{M-1}, return every suffix
// product s_k = e_k (x) e_{k+1} (x) ... (x) e_{M-1}, all five fields (A, b,
// C, eta, J).  The combine is associative, neither commutative nor
// idempotent.
//
// What bounds it on an H100.  By its counts, the bytes: each element is
// read once and each suffix written once (2 F floats a step, F = 3 n_x^2 +
// 2 n_x), against 40 n_x^3 operations a combine (JAX's count): 1.25 us for
// the pendulum at M = 32769.  In practice latency: log2(T) dependent
// combines a thread in the tile scan, each a 2x2 or 4x4 inverse and about
// ten small products in one thread's registers, and the look-back's chain
// of one combine per tile, issued by one thread: tiles that run at once
// publish their aggregates together and each then folds nearly all its
// predecessors, so the time grows with the tiles resident at once.
//
// Design (scan_kernel): one launch, one block per tile of T elements (B6
// 'sub': 256, B7 'lane': 128; the TPU's lane/sublane split has no meaning
// here), no round trip of per-step data through device memory.
//   1. Tiles take tickets from the right (lookback.cuh, shared with B1 and
//      B3).  One thread per element loads it from the five input tensors as
//      they are (contiguous f32, no packing) and the tile runs the
//      Hillis-Steele suffix scan of riccati_scan.cuh in shared memory
//      (partners past M - 1 are the identity and are skipped).
//   2. The tile publishes its aggregate (its local suffix at its first
//      element, F floats), then, by decoupled look-back, its inclusive
//      suffix element: the TPU kernels carry the suffix of the later blocks
//      (B6 in SMEM, B7 through an XLA pass); here thread 0 folds
//      run <- combine(agg_j, run) right-associated through the aggregates
//      from the nearest published inclusive element to this tile's own, the
//      order of a walk from the right end, so the result does not depend on
//      where the look-back stops.  Every field of every suffix is an output,
//      so the carry is a whole element (B1 carries only (eta, J)).
//   3. Each thread closes its local suffix with the tile's right-edge
//      element (the suffix of all later tiles; the last tile has none) and
//      writes the five outputs.
// Scratch (per device, stream and shape, zeroed once by the wrapper):
// counters [ticket, done, status (n_tiles)] and floats [aggregates
// (n_tiles, F), inclusive elements (n_tiles, F)].
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "riccati_scan.cuh"

namespace {

using namespace ilqr;
using lookback::kFromRight;

constexpr int kSubTile = 256;    // B6: elements per tile
constexpr int kLaneTile = 128;   // B7: elements per tile
constexpr int kStageTiles = 64;  // aggregates staged per look-back round

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

template <int NX>
__device__ __forceinline__ void store_element(const Outputs& out, int k,
                                              const float* s) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
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

// Shared memory of scan_kernel, in floats: the tile scan (F x T), the
// staged aggregates and the right-edge element.
template <int NX, int T>
constexpr int scan_smem_floats() {
  return Elem<NX>::F * (T + kStageTiles + 1);
}

template <int NX, int T>
__global__ void __launch_bounds__(T)
scan_kernel(Elements in, int M, int n_tiles, int* __restrict__ counters,
            float* __restrict__ scratch, Outputs out) {
  using E = Elem<NX>;
  constexpr int F = E::F;
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  float* buf = sm;                   // F x T
  float* stage = buf + F * T;        // (kStageTiles, F)
  float* edge = stage + kStageTiles * F;   // F
  int* status = counters + 2;
  float* aggs = scratch;                       // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;    // (n_tiles, F)
  const int tid = threadIdx.x;

  // 1. The tile in start order from the right end; its local suffixes.
  const int p = lookback::take_tile<kFromRight>(counters, n_tiles, &slots);
  const int k = p * T + tid;
  {
    float e[F];
    if (k < M) {
      load_element<NX>(in, k, e);
    } else {
      identity<NX>(e);
    }
    tile_suffix_scan<NX, T>(e, buf, tid, k, M - 1);
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) aggs[(size_t)p * F + f] = e[f];
      lookback::publish(&status[p], lookback::kAggregate);
    }
    // Parked in shared memory over the look-back.
#pragma unroll
    for (int f = 0; f < F; ++f) buf[f * T + tid] = e[f];
  }

  // 2. Look-back: thread 0 folds from the nearest inclusive element to the
  // right (none: start from the last tile's aggregate) through this tile's
  // aggregate; the element before the last step is the one at this tile's
  // right edge.
  const int q = lookback::find_inclusive<kFromRight>(counters, p, n_tiles,
                                                     &slots);
  float run[F], prev[F];
  bool started = false;
  if (tid == 0 && q < n_tiles) {
#pragma unroll
    for (int f = 0; f < F; ++f) run[f] = __ldcg(incl + (size_t)q * F + f);
    started = true;
  }
  lookback::fold<kFromRight, kStageTiles>(
      aggs, F, p, q, stage, tid == 0, [&](const float* agg) {
        if (started) {
          float o[F];
          combine<NX>(agg, run, o);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            prev[f] = run[f];
            run[f] = o[f];
          }
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) run[f] = agg[f];
          started = true;
        }
      });
  if (tid == 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) incl[(size_t)p * F + f] = run[f];
    lookback::publish(&status[p], lookback::kInclusive);
    // The element at this tile's right edge (the last tile has none).
    if (p != n_tiles - 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) edge[f] = prev[f];
    }
  }
  if (lookback::arrive(counters, n_tiles, &slots)) {
    lookback::reset(counters, n_tiles);
  }

  // 3. Close each local suffix with the right-edge element and write it.
  if (k < M) {
    float e[F];
#pragma unroll
    for (int f = 0; f < F; ++f) e[f] = buf[f * T + tid];
    if (p == n_tiles - 1) {
      store_element<NX>(out, k, e);
    } else {
      float s[F];
      combine<NX>(e, edge, s);
      store_element<NX>(out, k, s);
    }
  }
}

template <int NX, int T>
int run(int M, const Elements& in, int* counters, float* scratch,
        const Outputs& out, cudaStream_t stream) {
  const int n_tiles = (M + T - 1) / T;
  const int smem = static_cast<int>(sizeof(float) * scan_smem_floats<NX, T>());
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<NX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<NX, T><<<n_tiles, T, smem, stream>>>(in, M, n_tiles, counters,
                                                   scratch, out);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int dispatch(int n_x, int M, const Elements& in, int* counters,
             float* scratch, const Outputs& out, cudaStream_t stream) {
  if (n_x == 2) return run<2, T>(M, in, counters, scratch, out, stream);
  if (n_x == 4) return run<4, T>(M, in, counters, scratch, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NX, int T>
int occupancy() {
  int blocks = 0;
  const int smem = static_cast<int>(sizeof(float) * scan_smem_floats<NX, T>());
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<NX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, scan_kernel<NX, T>, T, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

int tile_steps(int lane) { return lane ? kLaneTile : kSubTile; }
int tiles(int lane, int M) {
  return (M + tile_steps(lane) - 1) / tile_steps(lane);
}

}  // namespace

// Elements per tile of each entry: lane = 0 (B6), 1 (B7).
extern "C" int ilqr_suffix_tile_steps(int lane) { return tile_steps(lane); }

// Sizes of scan_kernel's scratch: ints (zeroed once, left zeroed by every
// call) and floats.
extern "C" int ilqr_suffix_scan_counters(int lane, int n_x, int M) {
  (void)n_x;
  return lookback::counter_ints(tiles(lane, M));
}
extern "C" int ilqr_suffix_scan_scratch(int lane, int n_x, int M) {
  return 2 * tiles(lane, M) * (3 * n_x * n_x + 2 * n_x);
}

// Blocks of scan_kernel resident on one SM (a negative CUDA error code on
// failure).
extern "C" int ilqr_suffix_scan_occupancy(int lane, int n_x) {
  if (n_x == 2) return lane ? occupancy<2, kLaneTile>() : occupancy<2, kSubTile>();
  if (n_x == 4) return lane ? occupancy<4, kLaneTile>() : occupancy<4, kSubTile>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// One launch.  Inputs: the five element fields, (M, n_x, n_x) / (M, n_x);
// counters and scratch as sized above.  Outputs: the five fields of every
// suffix, shaped as the inputs.
extern "C" int ilqr_suffix_scan(int lane, int n_x, int M, const float* A,
                                const float* b, const float* C,
                                const float* eta, const float* J,
                                int* counters, float* scratch, float* A_out,
                                float* b_out, float* C_out, float* eta_out,
                                float* J_out, void* stream) {
  const Elements in{A, b, C, eta, J};
  const Outputs out{A_out, b_out, C_out, eta_out, J_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane) return dispatch<kLaneTile>(n_x, M, in, counters, scratch, out, s);
  return dispatch<kSubTile>(n_x, M, in, counters, scratch, out, s);
}
