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
//
// The wide form (wide_scan_kernel; B6w), 'sub' entry, every other
// n <= 16: the same three steps with an element per warp, zero-padded to
// P x P (P = 8 for n <= 8, 16 above; one instantiation per P), and the
// entry-parallel combine of group_linalg.cuh: each lane owns 2 or 8 entries
// of every product, the inverse of L = I + C J is a Gauss-Jordan with the
// pivot from a warp reduction.  Blocks of 16 warps hold tiles of 16
// elements (a combine is a few thousand cycles, so a bigger tile's
// Hillis-Steele levels and the look-back's fold chain cost about the
// same), warp 0 folds the look-back, a whole element a tile, staged two
// at a time.  The 'lane' entry (B7) runs the register form at n in
// {2, 4} and the same wide kernel (B7w) at every other n <= 16.
//
// Over a batch (ilqr_suffix_scan_batched; replaces jax.vmap of
// suffix_scan_pallas, whose pallas_call gains a batch grid axis): B
// independent sequences of M elements, (B, M, ...) contiguous, in one
// launch of B x n_tiles blocks, in either form ('sub' tiles).  At MPC
// shapes (M = H + 1 = 65) one tile holds an instance, so all the
// parallelism is across instances.  Blocks take their tickets
// instance-major (lookback.cuh, take_batched_tile), each instance's tiles
// from the right, so every tile a block waits on holds an earlier ticket:
// the look-back cannot wait on a tile that was never scheduled.  Status
// words, aggregates and inclusive elements are per (instance, tile), the
// counters reset once per launch by its last block.  Each instance runs
// the tiles and the fold order of a launch on it alone, so its outputs
// are those of the single-instance entry bit for bit (which is this
// kernel with B = 1).
#include <cuda_runtime.h>

#include "group_linalg.cuh"
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

// Instance i's rows of a batch of sequences of M elements of n x n.
template <class S>
__device__ __forceinline__ S instance_rows(const S& e, int i, int M, int n) {
  const size_t mm = (size_t)i * M * n * n, mv = (size_t)i * M * n;
  return S{e.A + mm, e.b + mv, e.C + mm, e.eta + mv, e.J + mm};
}

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
scan_kernel(Elements in_all, int M, int n_tiles, int n_inst,
            int* __restrict__ counters, float* __restrict__ scratch,
            Outputs out_all) {
  using E = Elem<NX>;
  constexpr int F = E::F;
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  float* buf = sm;                   // F x T
  float* stage = buf + F * T;        // (kStageTiles, F)
  float* edge = stage + kStageTiles * F;   // F
  const int tid = threadIdx.x;

  // 1. The tile in start order from the right end of its instance; its
  // local suffixes.
  const int p = lookback::take_batched_tile<kFromRight>(counters, n_tiles,
                                                        &slots);
  const int i = slots.instance;
  int* status = counters + 2 + (size_t)i * n_tiles;
  float* aggs = scratch + (size_t)i * 2 * n_tiles * F;   // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;              // (n_tiles, F)
  const int k = p * T + tid;
  {
    float e[F];
    if (k < M) {
      load_element<NX>(instance_rows(in_all, i, M, NX), k, e);
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
  const int q = lookback::find_inclusive<kFromRight>(
      status, p, n_tiles, &slots);
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
  if (lookback::arrive(counters, n_inst * n_tiles, &slots)) {
    lookback::reset(counters, n_inst * n_tiles);
  }

  // 3. Close each local suffix with the right-edge element and write it
  // (the instance's rows found here, not carried over the look-back).
  if (k < M) {
    const Outputs out = instance_rows(out_all, slots.instance, M, NX);
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
int run(int B, int M, const Elements& in, int* counters, float* scratch,
        const Outputs& out, cudaStream_t stream) {
  const int n_tiles = (M + T - 1) / T;
  const int smem = static_cast<int>(sizeof(float) * scan_smem_floats<NX, T>());
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<NX, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<NX, T><<<B * n_tiles, T, smem, stream>>>(
      in, M, n_tiles, B, counters, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

// ---- The wide form (B6w) -------------------------------------------------

constexpr int kWideTile = 16;    // elements of a tile: a warp each
constexpr int kWideStage = 2;    // aggregates staged per look-back round

template <int P>
struct WideSmem {
  using E = grp::Elem<P>;
  static constexpr int T = kWideTile;
  static constexpr int kThreads = 32 * T;
  static constexpr int kBuf0 = 0;
  static constexpr int kBuf1 = kBuf0 + T * E::F;
  static constexpr int kWork = kBuf1 + T * E::F;
  static constexpr int kCarry = kWork + T * E::WORK;   // run, prev, next
  static constexpr int kStage = kCarry + 3 * E::F;
  static constexpr int kFloats = kStage + kWideStage * E::F;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kBytes <= 232448 - 64, "a tile must fit shared memory");
};

// Element k of the inputs into e, zero-padded past n.
template <int P>
__device__ __forceinline__ void load_wide(const grp::Lane& ln, int n,
                                          const Elements& in, int k,
                                          float* e) {
  using E = grp::Elem<P>;
  constexpr int LD = grp::Mat<P>::LD;
  const size_t NN = (size_t)n * n;
  for (int i = ln.l; i < P * P; i += 32) {
    const int r = i / P, c = i % P;
    const bool real = r < n && c < n;
    const size_t g = k * NN + r * n + c;
    e[E::A + r * LD + c] = real ? in.A[g] : 0.0f;
    e[E::C + r * LD + c] = real ? in.C[g] : 0.0f;
    e[E::J + r * LD + c] = real ? in.J[g] : 0.0f;
  }
  if (ln.l < P) {
    e[E::B + ln.l] = ln.l < n ? in.b[(size_t)k * n + ln.l] : 0.0f;
    e[E::ETA + ln.l] = ln.l < n ? in.eta[(size_t)k * n + ln.l] : 0.0f;
  }
  grp::sync();
}

template <int P>
__device__ __forceinline__ void store_wide(const grp::Lane& ln, int n,
                                           const Outputs& out, int k,
                                           const float* s) {
  using E = grp::Elem<P>;
  constexpr int LD = grp::Mat<P>::LD;
  const size_t NN = (size_t)n * n;
  for (int i = ln.l; i < n * n; i += 32) {
    const int r = i / n, c = i % n;
    out.A[k * NN + i] = s[E::A + r * LD + c];
    out.C[k * NN + i] = s[E::C + r * LD + c];
    out.J[k * NN + i] = s[E::J + r * LD + c];
  }
  if (ln.l < n) {
    out.b[(size_t)k * n + ln.l] = s[E::B + ln.l];
    out.eta[(size_t)k * n + ln.l] = s[E::ETA + ln.l];
  }
}

template <int P>
__global__ void __launch_bounds__(32 * kWideTile, 1)
wide_scan_kernel(Elements in_all, int n, int M, int n_tiles, int n_inst,
                 int* __restrict__ counters, float* __restrict__ scratch,
                 Outputs out_all) {
  using E = grp::Elem<P>;
  using S = WideSmem<P>;
  constexpr int F = E::F, T = S::T;
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  const int tid = threadIdx.x, q = tid / 32;
  const grp::Lane ln;
  float* w = sm + S::kWork + q * E::WORK;

  // 1. The tile from the right end of its instance; its local suffixes.
  const int p = lookback::take_batched_tile<kFromRight>(counters, n_tiles,
                                                        &slots);
  const int i = slots.instance;
  int* status = counters + 2 + (size_t)i * n_tiles;
  float* aggs = scratch + (size_t)i * 2 * n_tiles * F;   // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;              // (n_tiles, F)
  const int k = p * T + q;
  float* e = sm + S::kBuf0 + q * F;
  if (k < M) {
    load_wide<P>(ln, n, instance_rows(in_all, i, M, n), k, e);
  } else {
    grp::identity<P>(ln, n, e);
  }
  __syncthreads();
  float* buf = grp::tile_suffix_scan<P, T>(ln, q, n, k, M - 1,
                                                sm + S::kBuf0, sm + S::kBuf1,
                                                w);
  float* other = buf == sm + S::kBuf0 ? sm + S::kBuf1 : sm + S::kBuf0;
  for (int i = tid; i < F; i += S::kThreads) {
    aggs[(size_t)p * F + i] = buf[i];
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kAggregate);

  // 2. Look-back: warp 0 folds run <- combine(agg, run) from the nearest
  // inclusive element to the right (none: from the last tile's aggregate)
  // through this tile's aggregate; the element before the last fold is the
  // one at this tile's right edge.
  const int q2 = lookback::find_inclusive<kFromRight>(
      status, p, n_tiles, &slots);
  float* run = sm + S::kCarry;
  float* prev = run + F;
  float* next = prev + F;
  bool started = q2 < n_tiles;
  if (q == 0 && started) {
    for (int i = ln.l; i < F; i += 32)
      run[i] = __ldcg(incl + (size_t)q2 * F + i);
    grp::sync();
  }
  lookback::fold<kFromRight, kWideStage>(
      aggs, F, p, q2, sm + S::kStage, q == 0, [&](const float* agg) {
        if (started) {
          grp::combine<P>(ln, n, agg, run, next, w);
          float* t = prev;
          prev = run;
          run = next;
          next = t;
        } else {
          grp::copy(ln, agg, run, F);
          started = true;
        }
      });
  if (q == 0) {
    for (int i = ln.l; i < F; i += 32) incl[(size_t)p * F + i] = run[i];
    __threadfence();
    grp::sync();
    if (ln.l == 0) lookback::publish(&status[p], lookback::kInclusive);
  }
  // Every warp reads the edge element from warp 0's rotation.
  __shared__ int edge_at;
  if (tid == 0) edge_at = static_cast<int>(prev - sm);
  if (lookback::arrive(counters, n_inst * n_tiles, &slots)) {
    lookback::reset(counters, n_inst * n_tiles);
  }

  // 3. Close each local suffix with the right-edge element and write it
  // (the instance's rows found here, not carried over the look-back).
  if (k < M) {
    const Outputs out = instance_rows(out_all, slots.instance, M, n);
    if (p == n_tiles - 1) {
      store_wide<P>(ln, n, out, k, buf + q * F);
    } else {
      grp::combine<P>(ln, n, buf + q * F, sm + edge_at, other + q * F, w);
      store_wide<P>(ln, n, out, k, other + q * F);
    }
  }
}

template <int P>
int run_wide(int n, int B, int M, const Elements& in, int* counters,
             float* scratch, const Outputs& out, cudaStream_t stream) {
  using S = WideSmem<P>;
  const int n_tiles = (M + S::T - 1) / S::T;
  cudaError_t err = cudaFuncSetAttribute(
      wide_scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_scan_kernel<P><<<B * n_tiles, S::kThreads, S::kBytes, stream>>>(
      in, n, M, n_tiles, B, counters, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int wide_occupancy() {
  using S = WideSmem<P>;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      wide_scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wide_scan_kernel<P>, S::kThreads, S::kBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

bool register_form(int n_x) { return n_x == 2 || n_x == 4; }
int wide_pad(int n_x) { return n_x <= 8 ? 8 : 16; }

template <int T>
int dispatch(int n_x, int B, int M, const Elements& in, int* counters,
             float* scratch, const Outputs& out, cudaStream_t stream) {
  if (n_x == 2) return run<2, T>(B, M, in, counters, scratch, out, stream);
  if (n_x == 4) return run<4, T>(B, M, in, counters, scratch, out, stream);
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

int tile_steps(int lane, int n_x) {
  if (register_form(n_x)) return lane ? kLaneTile : kSubTile;
  return kWideTile;
}
int tiles(int lane, int n_x, int M) {
  return (M + tile_steps(lane, n_x) - 1) / tile_steps(lane, n_x);
}
int element_floats(int n_x) {
  if (register_form(n_x)) return 3 * n_x * n_x + 2 * n_x;
  return wide_pad(n_x) == 8 ? grp::Elem<8>::F : grp::Elem<16>::F;
}

}  // namespace

// Elements per tile of each entry at n_x: lane = 0 (B6), 1 (B7); at n_x
// other than 2 and 4 the wide form's, the same for both (B6w, B7w).
extern "C" int ilqr_suffix_tile_steps(int lane, int n_x) {
  return tile_steps(lane, n_x);
}

// Sizes of the kernel's scratch: ints (zeroed once, left zeroed by every
// call) and floats.
extern "C" int ilqr_suffix_scan_counters(int lane, int n_x, int M) {
  return lookback::counter_ints(tiles(lane, n_x, M));
}
extern "C" int ilqr_suffix_scan_scratch(int lane, int n_x, int M) {
  return 2 * tiles(lane, n_x, M) * element_floats(n_x);
}

// Blocks of the kernel resident on one SM (a negative CUDA error code on
// failure).
extern "C" int ilqr_suffix_scan_occupancy(int lane, int n_x) {
  if (n_x == 2) return lane ? occupancy<2, kLaneTile>() : occupancy<2, kSubTile>();
  if (n_x == 4) return lane ? occupancy<4, kLaneTile>() : occupancy<4, kSubTile>();
  if (n_x < 1 || n_x > 16) return -static_cast<int>(cudaErrorInvalidValue);
  return wide_pad(n_x) == 8 ? wide_occupancy<8>() : wide_occupancy<16>();
}

// The launches of both entries: B sequences of M elements, in the register
// form at n_x = 2, 4 (either layout) or the wide form at every other
// n_x <= 16 (both layouts, one kernel).
static int scan(int lane, int n_x, int B, int M, const Elements& in,
                int* counters, float* scratch, const Outputs& out,
                cudaStream_t s) {
  if (B < 1 || M < 1 || (long long)B * tiles(lane, n_x, M) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (register_form(n_x)) {
    return lane ? dispatch<kLaneTile>(n_x, B, M, in, counters, scratch, out, s)
                : dispatch<kSubTile>(n_x, B, M, in, counters, scratch, out, s);
  }
  if (n_x < 1 || n_x > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (wide_pad(n_x) == 8)
    return run_wide<8>(n_x, B, M, in, counters, scratch, out, s);
  return run_wide<16>(n_x, B, M, in, counters, scratch, out, s);
}

// One launch over one sequence.  Inputs: the five element fields,
// (M, n_x, n_x) / (M, n_x); counters and scratch as sized above.
// Outputs: the five fields of every suffix, shaped as the inputs.
extern "C" int ilqr_suffix_scan(int lane, int n_x, int M, const float* A,
                                const float* b, const float* C,
                                const float* eta, const float* J,
                                int* counters, float* scratch, float* A_out,
                                float* b_out, float* C_out, float* eta_out,
                                float* J_out, void* stream) {
  return scan(lane, n_x, 1, M, Elements{A, b, C, eta, J}, counters, scratch,
              Outputs{A_out, b_out, C_out, eta_out, J_out},
              static_cast<cudaStream_t>(stream));
}

// The batch's scratch: ints (zeroed once, left zeroed by every call) and
// floats, for B sequences of M elements ('sub' tiles); -1 where a count
// does not fit an int.
static int fits(long long count) {
  return count > 0x7fffffffLL ? -1 : static_cast<int>(count);
}
extern "C" int ilqr_suffix_scan_batched_counters(int n_x, int B, int M) {
  return fits(2 + (long long)B * tiles(0, n_x, M));
}
extern "C" int ilqr_suffix_scan_batched_scratch(int n_x, int B, int M) {
  return fits(2LL * B * tiles(0, n_x, M) * element_floats(n_x));
}

// One launch over B sequences ('sub' tiles): the fields (B, M, n_x, n_x) /
// (B, M, n_x), contiguous; outputs shaped as the inputs, instance i's
// those of ilqr_suffix_scan on instance i alone.
extern "C" int ilqr_suffix_scan_batched(int n_x, int B, int M,
                                        const float* A, const float* b,
                                        const float* C, const float* eta,
                                        const float* J, int* counters,
                                        float* scratch, float* A_out,
                                        float* b_out, float* C_out,
                                        float* eta_out, float* J_out,
                                        void* stream) {
  return scan(0, n_x, B, M, Elements{A, b, C, eta, J}, counters, scratch,
              Outputs{A_out, b_out, C_out, eta_out, J_out},
              static_cast<cudaStream_t>(stream));
}
