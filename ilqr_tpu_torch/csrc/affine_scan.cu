// Multi-candidate affine prefix scan: delta_{k+1} = P_k delta_k + q_k^(a).
//
// Replaces: ilqr_tpu/ops/pallas_affine.py::_prefix_kernel_sub (launcher
// _prefix_scan_packed_sub, entry affine_prefix_scan_multi).
//
// Math (see ilqr_tpu_torch/ops/affine_scan.py): step k is the element
// (P_k, q_k^(1..A)); the transition chain P is shared by the A candidates.
// Elements combine as (P, q^a) o (P', q'^a) = (P'P, P'q^a + q'^a), earlier
// first.  Closing a local prefix (P_loc, q_loc) at step k against the state
// delta_in that enters it gives delta_{k+1} = P_loc delta_in + q_loc, so a
// state (A n floats) is all a carry across steps needs.
//
// What bounds it on an H100.  By its counts, the bytes: a step reads P and
// q (n^2 + A n floats) and writes delta (A n floats) once, 38 MB at
// N = 100000, n = 4, A = 10 (11 us at 3.35 TB/s), against n^3 + A n^2 FMAs
// a combine.  In practice latency, in two parts: the warp scan, 56
// shuffles and ~224 FMAs a level at n = 4, A = 10, on 16 warps an SM (128
// registers a thread), before a tile's aggregate is out; and the
// look-back, a chain of one affine map per tile, since tiles that run at
// once publish their aggregates together and each then folds nearly all
// of its predecessors.  Nothing here needs tensor cores.
//
// Design (prefix_kernel): one launch, one block per tile of kTileSteps
// steps; no per-step data makes a round trip through device memory.
//   1. Tiles take tickets from the left (lookback.cuh, shared with B1 and
//      B6/B7).  One thread per step loads (P_k, q_k^(1..A)) once (the
//      identity beyond N) and the warp scans its 32 steps by shuffles:
//      five levels, no barrier, each thread's element in registers.  The
//      candidate loops are unrolled to C (1, or kMaxCand) with a runtime
//      guard, so A stays a runtime count.
//   2. The 8 warp aggregates go through shared memory; the tile aggregate
//      is their chain: lanes 0..A-1 of warp 0 carry q^a (x <- P_w x + q_w^a
//      from the first warp's q^a), lane 0 of warp 1 the product of the P_w.
//      The tile publishes it (n^2 + A n floats).
//   3. Look-back: lanes 0..A-1, one per candidate, carry the nearest
//      published inclusive state (or delta_0) through the aggregates in
//      between and this tile's own, delta <- P_agg delta + q_agg^a, keep
//      the state delta_in that enters the tile, and publish the state at
//      its last step (A n floats).
//   4. The same lanes carry delta_in through the warp aggregates to the
//      state entering each warp; each step closes its warp-local prefix,
//      delta_{k+1} = P_w,k delta_w + q_w,k^a, and writes it.  No second
//      scan: the local prefixes stay in registers.
// Scratch (per device, stream and shape, zeroed once by the wrapper):
// counters [ticket, done, status (n_tiles)] and floats [aggregates
// (n_tiles, n^2 + A n), inclusive states (n_tiles, A n)].
// That register form serves n in {2, 4} with at most kMaxCand candidates.
//
// The wide form (wide_prefix_kernel; B3w), every other n <= 16 and any
// number of candidates, as JAX's kernel takes them.  An element no longer
// fits a thread (n = 12, A = 10: 264 floats), so a group of P lanes (P = 8
// for n <= 8, else 16) works on one n-vector or n x n matrix at a time,
// lane r owning row r, matrices in shared memory at row stride P + 1
// (riccati_scan.cuh, namespace wide, as B1w), n a run-time bound of one
// instantiation per P.  The tile, kWideTile steps, is a chain rather than
// a scan: A candidates would make the Hillis-Steele elements of a suffix
// scan's form A n + n^2 floats each, and the chain needs no element
// but the tile's transition matrices.  One launch, on lookback.cuh:
//   1. Tiles take tickets from the left; the block stages its tile's P_k.
//   2. The aggregate: the block's last group forms the product
//      P_last ... P_first by a chain of group products, and every group
//      carries its candidates (a = group, group + G, ...: candidates
//      beyond the groups loop inside the launch) from 0 through the tile,
//      x <- P_k x + q_k^a, each candidate's drives staged first.  Published
//      as [product (n^2), drives (A n)], the register form's layout.
//   3. Look-back: each group carries its candidates from the nearest
//      published inclusive state (or delta_0) through the aggregates
//      between, read from L2, and this tile's own; it keeps the state
//      entering the tile (scratch) and publishes the state at its end.
//   4. Each group runs its candidates' chains through the tile again from
//      the state entering it, writing every delta.
// Scratch floats: [aggregates (n_tiles, n^2 + A n), inclusive states
// (n_tiles, A n), entering states (n_tiles, A n)].  Shared memory does not
// depend on A.
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "riccati_scan.cuh"
#include "smallmat.cuh"

namespace {

using namespace ilqr;
using lookback::kFromLeft;

constexpr int kTileSteps = 256;  // steps of a tile = threads of its block
constexpr int kWarps = kTileSteps / 32;
constexpr int kMaxCand = 16;     // most candidates a launch takes
constexpr int kStageTiles = 64;  // aggregates staged per look-back round
constexpr unsigned kFullMask = 0xffffffffu;

// x <- P x + q: an element's affine map on one candidate's state.
template <int NX>
__device__ __forceinline__ void affine_step(const float* P, const float* q,
                                            float* x) {
  float y[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float s = q[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) s += P[i * NX + j] * x[j];
    y[i] = s;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = y[i];
}

// Inclusive prefix of the elements (p, v) of a warp's lanes: at distance
// d, lane l takes lane l - d as the earlier operand, P = P_l P_{l-d},
// q^a = P_l q^a_{l-d} + q^a_l.  Lanes below d keep theirs.
template <int NX, int C>
__device__ __forceinline__ void warp_prefix(float* p, float (*v)[NX], int A,
                                            int lane) {
  constexpr int NN = NX * NX;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool take = lane >= d;
#pragma unroll
    for (int a = 0; a < C; ++a) {
      if (a < A) {
        float qp[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
          qp[i] = __shfl_up_sync(kFullMask, v[a][i], d);
        if (take) {
          float y[NX];
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            float s = v[a][i];
#pragma unroll
            for (int j = 0; j < NX; ++j) s += p[i * NX + j] * qp[j];
            y[i] = s;
          }
#pragma unroll
          for (int i = 0; i < NX; ++i) v[a][i] = y[i];
        }
      }
    }
    float pp[NN];
#pragma unroll
    for (int f = 0; f < NN; ++f) pp[f] = __shfl_up_sync(kFullMask, p[f], d);
    if (take) {
      float pn[NN];
      mm<NX, NX, NX>(p, pp, pn);
#pragma unroll
      for (int f = 0; f < NN; ++f) p[f] = pn[f];
    }
  }
}

// Shared memory of prefix_kernel, in floats, at A candidates.
constexpr int prefix_smem_floats(int NX, int A) {
  return kWarps * (NX * NX + A * NX)   // the warp aggregates
         + kWarps * A * NX            // the state entering each warp
         + kStageTiles * (NX * NX + A * NX);   // staged tile aggregates
}

template <int NX, int C>
__global__ void __launch_bounds__(kTileSteps)
prefix_kernel(const float* __restrict__ P, const float* __restrict__ q,
              const float* __restrict__ delta0, int N, int A, int n_tiles,
              int* __restrict__ counters, float* __restrict__ scratch,
              float* __restrict__ out) {
  constexpr int NN = NX * NX;
  const int F = NN + A * NX;   // an element or aggregate: P, then q^1..A
  const int S = A * NX;        // a state of every candidate
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  float* wagg = sm;                  // (kWarps, F)
  float* win = wagg + kWarps * F;    // (kWarps, S)
  float* stage = win + kWarps * S;   // (kStageTiles, F)
  int* status = counters + 2;
  float* aggs = scratch;                        // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;     // (n_tiles, S)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. The tile in start order from the left; its elements, scanned by
  // warps.
  const int p = lookback::take_tile<kFromLeft>(counters, n_tiles, &slots);
  const int k = p * kTileSteps + tid;
  float pm[NN], v[C][NX];
  if (k < N) {
#pragma unroll
    for (int f = 0; f < NN; ++f) pm[f] = P[(size_t)k * NN + f];
#pragma unroll
    for (int a = 0; a < C; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          v[a][i] = q[((size_t)a * N + k) * NX + i];
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < NN; ++f) pm[f] = (f / NX == f % NX) ? 1.0f : 0.0f;
#pragma unroll
    for (int a = 0; a < C; ++a)
#pragma unroll
      for (int i = 0; i < NX; ++i) v[a][i] = 0.0f;
  }
  warp_prefix<NX, C>(pm, v, A, lane);
  if (lane == 31) {
    float* w = wagg + warp * F;
#pragma unroll
    for (int f = 0; f < NN; ++f) w[f] = pm[f];
#pragma unroll
    for (int a = 0; a < C; ++a) {
      if (a < A) {
#pragma unroll
        for (int i = 0; i < NX; ++i) w[NN + a * NX + i] = v[a][i];
      }
    }
  }
  if (p == 0 && tid < S) out[(size_t)(tid / NX) * (N + 1) * NX + tid % NX] =
      delta0[tid];
  __syncthreads();

  // 2. The tile aggregate: the chain of the warp aggregates.
  float* agg = aggs + (size_t)p * F;
  if (warp == 0 && lane < A) {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = wagg[NN + lane * NX + i];
    for (int w = 1; w < kWarps; ++w)
      affine_step<NX>(wagg + w * F, wagg + w * F + NN + lane * NX, x);
#pragma unroll
    for (int i = 0; i < NX; ++i) agg[NN + lane * NX + i] = x[i];
    __threadfence();
  } else if (warp == 1 && lane == 0) {
    float pt[NN], pn[NN];
#pragma unroll
    for (int f = 0; f < NN; ++f) pt[f] = wagg[f];
    for (int w = 1; w < kWarps; ++w) {
      mm<NX, NX, NX>(wagg + w * F, pt, pn);
#pragma unroll
      for (int f = 0; f < NN; ++f) pt[f] = pn[f];
    }
#pragma unroll
    for (int f = 0; f < NN; ++f) agg[f] = pt[f];
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kAggregate);

  // 3. Look-back, one lane per candidate: the nearest inclusive state to
  // the left (or delta_0) carried through the aggregates up to this tile's;
  // the state before the last step is the one entering this tile.
  const int qt = lookback::find_inclusive<kFromLeft>(counters, p, n_tiles,
                                                     &slots);
  float x[NX], x_in[NX];
  if (tid < A) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      x[i] = qt >= 0 ? __ldcg(incl + (size_t)qt * S + tid * NX + i)
                     : delta0[tid * NX + i];
  }
  lookback::fold<kFromLeft, kStageTiles>(
      aggs, F, p, qt, stage, tid < A, [&](const float* a_j) {
#pragma unroll
        for (int i = 0; i < NX; ++i) x_in[i] = x[i];
        affine_step<NX>(a_j, a_j + NN + tid * NX, x);
      });
  if (warp == 0) {
    if (tid < A) {
#pragma unroll
      for (int i = 0; i < NX; ++i) incl[(size_t)p * S + tid * NX + i] = x[i];
      __threadfence();
#pragma unroll
      for (int i = 0; i < NX; ++i) win[tid * NX + i] = x_in[i];
    }
    __syncwarp();
    if (lane == 0) lookback::publish(&status[p], lookback::kInclusive);
  }
  if (lookback::arrive(counters, n_tiles, &slots)) {
    lookback::reset(counters, n_tiles);
  }

  // 4. The state entering each warp, then every step's delta.
  if (tid < A) {
    float y[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) y[i] = win[tid * NX + i];
    for (int w = 1; w < kWarps; ++w) {
      const float* wa = wagg + (w - 1) * F;
      affine_step<NX>(wa, wa + NN + tid * NX, y);
#pragma unroll
      for (int i = 0; i < NX; ++i) win[w * S + tid * NX + i] = y[i];
    }
  }
  __syncthreads();
  if (k < N) {
    const float* d_in = win + warp * S;
#pragma unroll
    for (int a = 0; a < C; ++a) {
      if (a < A) {
        float y[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) y[i] = d_in[a * NX + i];
        affine_step<NX>(pm, v[a], y);
#pragma unroll
        for (int i = 0; i < NX; ++i)
          out[((size_t)a * (N + 1) + k + 1) * NX + i] = y[i];
      }
    }
  }
}

template <int NX, int C>
int run(int A, int N, const float* P, const float* q, const float* delta0,
        int* counters, float* scratch, float* out, cudaStream_t stream) {
  const int n_tiles = (N + kTileSteps - 1) / kTileSteps;
  const int smem = static_cast<int>(sizeof(float) * prefix_smem_floats(NX, A));
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel<NX, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefix_kernel<NX, C><<<n_tiles, kTileSteps, smem, stream>>>(
      P, q, delta0, N, A, n_tiles, counters, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

template <int NX, int C>
int occupancy(int A) {
  int blocks = 0;
  const int smem = static_cast<int>(sizeof(float) * prefix_smem_floats(NX, A));
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel<NX, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, prefix_kernel<NX, C>, kTileSteps, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// ---- The wide form (B3w) ------------------------------------------------

constexpr int kWideThreads = 256;   // a block: 256 / P lane groups
constexpr int kWideTile = 32;       // steps of a wide tile

template <int P>
struct WideSmem {
  static constexpr int LD = P + 1;
  static constexpr int M = P * LD;               // one P x P matrix
  static constexpr int G = kWideThreads / P;     // groups a block
  static constexpr int kP = 0;                   // the tile's P_k
  static constexpr int kQ = kP + kWideTile * M;  // a group's drives
  static constexpr int kX = kQ + G * kWideTile * P;   // a group's x, y
  static constexpr int kProd = kX + G * 2 * P;   // the product, two buffers
  static constexpr int kBytes = 4 * (kProd + 2 * M);
};

// The group's drives q_k^a of the tile's steps into qs (a step a row).
template <int P>
__device__ __forceinline__ void stage_drives(const wide::Group<P>& g, int n,
                                             const float* src, int steps,
                                             float* qs) {
  for (int i = g.r; i < steps * n; i += P) qs[(i / n) * P + i % n] = src[i];
  g.sync();
}

// y = P_k x + q, then the two swap; every lane of the group keeps the same
// pointers.
template <int P>
__device__ __forceinline__ void affine_group(const wide::Group<P>& g, int n,
                                             const float* Pk, const float* q,
                                             float*& x, float*& y) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    float s = q[g.r];
    for (int j = 0; j < n; ++j) s += Pk[g.r * LD + j] * x[j];
    y[g.r] = s;
  }
  g.sync();
  float* t = x;
  x = y;
  y = t;
}

template <int P>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_prefix_kernel(const float* __restrict__ Pm, const float* __restrict__ q,
                   const float* __restrict__ delta0, int n, int A, int N,
                   int n_tiles, int* __restrict__ counters,
                   float* __restrict__ scratch, float* __restrict__ out) {
  using S = WideSmem<P>;
  constexpr int LD = S::LD, G = S::G;
  extern __shared__ __align__(16) float smw[];
  __shared__ lookback::Slots slots;
  const int tid = threadIdx.x, grp = tid / P;
  const wide::Group<P> g;
  const int r = g.r;
  const int NN = n * n, F = NN + A * n, SA = A * n;
  int* status = counters + 2;
  float* aggs = scratch;                          // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;       // (n_tiles, SA)
  float* entering = incl + (size_t)n_tiles * SA;  // (n_tiles, SA)
  float* Ps = smw + S::kP;
  float* qs = smw + S::kQ + grp * kWideTile * P;
  float* x = smw + S::kX + grp * 2 * P;
  float* y = x + P;

  // 1. The tile from the left; its transition matrices.
  const int p = lookback::take_tile<kFromLeft>(counters, n_tiles, &slots);
  const int k0 = p * kWideTile, steps = min(kWideTile, N - k0);
  for (int i = tid; i < steps * NN; i += kWideThreads) {
    const int e = i % NN;
    Ps[(i / NN) * S::M + (e / n) * LD + e % n] = Pm[(size_t)k0 * NN + i];
  }
  if (p == 0) {
    for (int i = tid; i < SA; i += kWideThreads)
      out[(size_t)(i / n) * (N + 1) * n + i % n] = delta0[i];
  }
  __syncthreads();

  // 2. The aggregate: the product of the tile's P_k, and each candidate's
  // drive carried from 0 through the tile.
  float* agg = aggs + (size_t)p * F;
  if (grp == G - 1) {
    float* a = smw + S::kProd;
    float* b = a + S::M;
    if (r < n) {
      for (int j = 0; j < n; ++j) a[r * LD + j] = Ps[r * LD + j];
    }
    g.sync();
    for (int k = 1; k < steps; ++k) {
      wide::mm<P>(g, n, n, n, Ps + k * S::M, a, b);
      float* t = a;
      a = b;
      b = t;
    }
    if (r < n) {
      for (int j = 0; j < n; ++j) agg[r * n + j] = a[r * LD + j];
    }
    __threadfence();
  }
  for (int c = grp; c < A; c += G) {
    stage_drives<P>(g, n, q + ((size_t)c * N + k0) * n, steps, qs);
    if (r < n) x[r] = 0.0f;
    g.sync();
    for (int k = 0; k < steps; ++k)
      affine_group<P>(g, n, Ps + k * S::M, qs + k * P, x, y);
    if (r < n) agg[NN + c * n + r] = x[r];
    __threadfence();
    g.sync();   // qs and x are rewritten for the next candidate
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kAggregate);

  // 3. Look-back, a group per candidate: the nearest inclusive state to
  // the left (or delta_0) through the aggregates up to this tile's own.
  const int qt = lookback::find_inclusive<kFromLeft>(counters, p, n_tiles,
                                                     &slots);
  for (int c = grp; c < A; c += G) {
    if (r < n)
      x[r] = qt >= 0 ? __ldcg(incl + (size_t)qt * SA + c * n + r)
                     : delta0[c * n + r];
    g.sync();
    for (int j = qt + 1; j <= p; ++j) {
      const float* aj = aggs + (size_t)j * F;
      if (r < n) {
        if (j == p) entering[(size_t)p * SA + c * n + r] = x[r];
        float s = __ldcg(aj + NN + c * n + r);
        for (int i = 0; i < n; ++i) s += __ldcg(aj + r * n + i) * x[i];
        y[r] = s;
      }
      g.sync();
      float* t = x;
      x = y;
      y = t;
    }
    if (r < n) incl[(size_t)p * SA + c * n + r] = x[r];
    __threadfence();
    g.sync();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kInclusive);
  if (lookback::arrive(counters, n_tiles, &slots)) {
    lookback::reset(counters, n_tiles);
  }

  // 4. Every step's delta, from the state entering the tile.
  for (int c = grp; c < A; c += G) {
    stage_drives<P>(g, n, q + ((size_t)c * N + k0) * n, steps, qs);
    if (r < n) x[r] = entering[(size_t)p * SA + c * n + r];
    g.sync();
    float* o = out + ((size_t)c * (N + 1) + k0 + 1) * n;
    for (int k = 0; k < steps; ++k) {
      affine_group<P>(g, n, Ps + k * S::M, qs + k * P, x, y);
      if (r < n) o[(size_t)k * n + r] = x[r];
    }
    g.sync();
  }
}

template <int P>
int run_wide(int n, int A, int N, const float* Pm, const float* q,
             const float* delta0, int* counters, float* scratch, float* out,
             cudaStream_t stream) {
  using S = WideSmem<P>;
  const int n_tiles = (N + kWideTile - 1) / kWideTile;
  cudaError_t err = cudaFuncSetAttribute(
      wide_prefix_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_prefix_kernel<P><<<n_tiles, kWideThreads, S::kBytes, stream>>>(
      Pm, q, delta0, n, A, N, n_tiles, counters, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int wide_occupancy() {
  using S = WideSmem<P>;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      wide_prefix_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wide_prefix_kernel<P>, kWideThreads, S::kBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

bool register_form(int n, int A) {
  return (n == 2 || n == 4) && A <= kMaxCand;
}
int wide_lanes(int n) { return n <= 8 ? 8 : 16; }
int tile_steps(int n, int A) {
  return register_form(n, A) ? kTileSteps : kWideTile;
}
int tiles(int n, int A, int N) {
  return (N + tile_steps(n, A) - 1) / tile_steps(n, A);
}

}  // namespace

// Steps of a tile at n and A candidates (the cross-tile carry period).
extern "C" int ilqr_affine_tile_steps(int n, int A) { return tile_steps(n, A); }

// Sizes of the kernel's scratch: ints (zeroed once, left zeroed by every
// call) and floats.
extern "C" int ilqr_affine_prefix_scan_counters(int n, int A, int N) {
  return lookback::counter_ints(tiles(n, A, N));
}
extern "C" int ilqr_affine_prefix_scan_scratch(int n, int A, int N) {
  return tiles(n, A, N) * (n * n + (register_form(n, A) ? 2 : 3) * A * n);
}

// Blocks of the kernel resident on one SM at n and A candidates (a
// negative CUDA error code on failure).
extern "C" int ilqr_affine_prefix_scan_occupancy(int n, int A) {
  if (A < 1 || n < 1 || n > 16) return -static_cast<int>(cudaErrorInvalidValue);
  if (n == 2 && A <= kMaxCand)
    return A == 1 ? occupancy<2, 1>(A) : occupancy<2, kMaxCand>(A);
  if (n == 4 && A <= kMaxCand)
    return A == 1 ? occupancy<4, 1>(A) : occupancy<4, kMaxCand>(A);
  return wide_lanes(n) == 8 ? wide_occupancy<8>() : wide_occupancy<16>();
}

// One launch.  Inputs P (N, n, n), q (A, N, n), delta0 (A, n); counters
// and scratch as sized above; output out (A, N+1, n).  The register form
// at n in {2, 4} with A <= 16, the wide form at every other n <= 16.
extern "C" int ilqr_affine_prefix_scan(int n, int A, int N, const float* P,
                                       const float* q, const float* delta0,
                                       int* counters, float* scratch,
                                       float* out, void* stream) {
  if (A < 1 || N < 1 || n < 1 || n > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (register_form(n, A)) {
    if (n == 2 && A == 1)
      return run<2, 1>(A, N, P, q, delta0, counters, scratch, out, s);
    if (n == 2)
      return run<2, kMaxCand>(A, N, P, q, delta0, counters, scratch, out, s);
    if (A == 1)
      return run<4, 1>(A, N, P, q, delta0, counters, scratch, out, s);
    return run<4, kMaxCand>(A, N, P, q, delta0, counters, scratch, out, s);
  }
  if (wide_lanes(n) == 8)
    return run_wide<8>(n, A, N, P, q, delta0, counters, scratch, out, s);
  return run_wide<16>(n, A, N, P, q, delta0, counters, scratch, out, s);
}
