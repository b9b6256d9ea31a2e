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
// fits a thread (n = 12, A = 10: 264 floats), so a warp works on one n x n
// product or one candidate's n-vector at a time, with the entry-parallel
// math of group_linalg.cuh: matrices zero-padded to P x P (P = 8 for n <= 8,
// else 16; one instantiation per P) at row stride P + 4 in shared memory.
// The candidates' part of a tile is a chain rather than a scan: A
// candidates would make the Hillis-Steele elements of a suffix scan's form
// A n + n^2 floats each, and the chain needs no element but the tile's
// transition matrices.  One launch of 16 warps a tile of 32 steps, on
// lookback.cuh:
//   1. Tiles take tickets from the left; the block stages its tile's P_k.
//   2. The aggregate: the product P_last ... P_first by a fixed tree of
//      warp products, five levels (16, 8, 4, 2, 1 products) in place of a
//      chain of 31, so the association and the bits repeat; and each warp
//      carries its candidates (a = warp, warp + 16, ...: candidates beyond
//      the warps loop inside the launch) from 0 through the tile, x <- P_k x
//      + q_k^a, lane r forming row r from x broadcast by shuffles and the
//      candidate's drives loaded first.  Published as [product (n^2),
//      drives (A n)], the register form's layout.
//   3. Look-back: each warp carries its candidates from the nearest
//      published inclusive state (or delta_0) through the aggregates
//      between, read from L2, and this tile's own; it keeps the state
//      entering the tile (scratch) and publishes the state at its end.
//   4. Each warp runs its candidates' chains through the tile again from
//      the state entering it, writing every delta.
// Scratch floats: [aggregates (n_tiles, n^2 + A n), inclusive states
// (n_tiles, A n), entering states (n_tiles, A n)].  Shared memory does not
// depend on A.
//
// Over a batch (ilqr_affine_prefix_scan_batched; replaces jax.vmap of
// affine_prefix_scan_multi, whose pallas_call gains a batch grid axis): B
// independent chains, P (B, N, n, n), q (B, A, N, n), delta0 (B, A, n),
// in one launch of B x n_tiles blocks, in either form.  Blocks take their
// tickets instance-major (lookback.cuh, take_batched_tile), each
// instance's tiles from the left, so every tile a block waits on holds an
// earlier ticket.  Status words and the scratch are per (instance, tile),
// the counters reset once per launch by its last block, and instance
// offsets are 64-bit.  Each instance runs the tiles and the fold order of
// a launch on it alone, so its deltas are those of the single-instance
// entry bit for bit (which is this kernel with B = 1).
#include <cuda_runtime.h>

#include "group_linalg.cuh"
#include "lookback.cuh"
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

// Instance i's rows of a batch whose instances hold `per` floats each.
template <class T>
__device__ __forceinline__ T* instance_rows(T* base, int i, size_t per) {
  return base + (size_t)i * per;
}

template <int NX, int C>
__global__ void __launch_bounds__(kTileSteps)
prefix_kernel(const float* __restrict__ P_all, const float* __restrict__ q_all,
              const float* __restrict__ d0_all, int N, int A, int n_tiles,
              int n_inst, int* __restrict__ counters,
              float* __restrict__ scratch, float* __restrict__ out_all) {
  constexpr int NN = NX * NX;
  const int F = NN + A * NX;   // an element or aggregate: P, then q^1..A
  const int S = A * NX;        // a state of every candidate
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  float* wagg = sm;                  // (kWarps, F)
  float* win = wagg + kWarps * F;    // (kWarps, S)
  float* stage = win + kWarps * S;   // (kStageTiles, F)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. The tile in start order from the left of its instance; its
  // elements, scanned by warps.
  const int p = lookback::take_batched_tile<kFromLeft>(counters, n_tiles,
                                                       &slots);
  const int k = p * kTileSteps + tid;
  float pm[NN], v[C][NX];
  if (k < N) {
    const float* P = instance_rows(P_all, slots.instance, (size_t)N * NN);
    const float* q = instance_rows(q_all, slots.instance,
                                   (size_t)A * N * NX);
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
  if (p == 0 && tid < S) {
    instance_rows(out_all, slots.instance, (size_t)S * (N + 1))
        [(size_t)(tid / NX) * (N + 1) * NX + tid % NX] =
        instance_rows(d0_all, slots.instance, S)[tid];
  }
  __syncthreads();

  // 2. The tile aggregate: the chain of the warp aggregates (the
  // instance's status words and scratch found here, after the warp scan,
  // whose elements fill the registers).
  int* status = counters + 2 + (size_t)slots.instance * n_tiles;
  float* aggs = instance_rows(scratch, slots.instance,
                              (size_t)n_tiles * (F + S));   // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;                 // (n_tiles, S)
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
  const int qt = lookback::find_inclusive<kFromLeft>(
      status, p, n_tiles, &slots);
  float x[NX], x_in[NX];
  if (tid < A) {
    const float* delta0 = instance_rows(d0_all, slots.instance, S);
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
  if (lookback::arrive(counters, n_inst * n_tiles, &slots)) {
    lookback::reset(counters, n_inst * n_tiles);
  }

  // 4. The state entering each warp, then every step's delta (the
  // instance's rows found here, not carried over the look-back).
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
    float* out = instance_rows(out_all, slots.instance, (size_t)S * (N + 1));
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
int run(int A, int B, int N, const float* P, const float* q,
        const float* delta0, int* counters, float* scratch, float* out,
        cudaStream_t stream) {
  const int n_tiles = (N + kTileSteps - 1) / kTileSteps;
  const int smem = static_cast<int>(sizeof(float) * prefix_smem_floats(NX, A));
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel<NX, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefix_kernel<NX, C><<<B * n_tiles, kTileSteps, smem, stream>>>(
      P, q, delta0, N, A, n_tiles, B, counters, scratch, out);
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

constexpr int kWideTile = 32;               // steps of a wide tile
constexpr int kWideWarps = kWideTile / 2;   // a warp a first-level product

template <int P>
struct WideSmem {
  static constexpr int SZ = grp::Mat<P>::SIZE;
  static constexpr int kThreads = 32 * kWideWarps;
  static constexpr int kP = 0;                          // the tile's P_k
  static constexpr int kTree0 = kP + kWideTile * SZ;    // levels 1, 3, 5
  static constexpr int kTree1 = kTree0 + kWideWarps * SZ;   // levels 2, 4
  static constexpr int kBytes = 4 * (kTree1 + kWideWarps / 2 * SZ);
};

// y = Pk x + q on lane r's row (r = lane % P), x broadcast from lane j by
// shuffles: one fmaf chain in j order from q.  Rows and x past n are zero,
// and so is the result there.
template <int P>
__device__ __forceinline__ float affine_row(const grp::Lane& ln,
                                            const float* Pk, float x,
                                            float q) {
  const float* row = Pk + (ln.l % P) * grp::Mat<P>::LD;
  float s = q;
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    float a[4];
    grp::ld_row<4>(row + j, a);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s = fmaf(a[i], __shfl_sync(grp::kWarp, x, j + i), s);
  }
  return s;
}

// Candidate c's drives of the tile's steps, q_k^c on lane r < n (0
// elsewhere and past the tile's steps), loaded before its chain runs.
__device__ __forceinline__ void load_drives(const float* q, int c, int N,
                                            int n, int k0, int steps, int r,
                                            float (&qv)[kWideTile]) {
  const float* src = q + ((size_t)c * N + k0) * n + r;
#pragma unroll
  for (int k = 0; k < kWideTile; ++k)
    qv[k] = k < steps && r < n ? src[(size_t)k * n] : 0.0f;
}

template <int P>
__global__ void __launch_bounds__(32 * kWideWarps)
wide_prefix_kernel(const float* __restrict__ P_all,
                   const float* __restrict__ q_all,
                   const float* __restrict__ d0_all, int n, int A, int N,
                   int n_tiles, int n_inst, int* __restrict__ counters,
                   float* __restrict__ scratch,
                   float* __restrict__ out_all) {
  using W = WideSmem<P>;
  using M = grp::Mat<P>;
  constexpr int LD = M::LD, SZ = W::SZ, kThreads = W::kThreads;
  extern __shared__ __align__(16) float smw[];
  __shared__ lookback::Slots slots;
  const int tid = threadIdx.x, warp = tid / 32;
  const grp::Lane ln;
  const int r = ln.l % P;
  const int NN = n * n, F = NN + A * n, SA = A * n;
  float* Ps = smw + W::kP;

  // 1. The tile from the left of its instance; its transition matrices,
  // zero-padded, the identity past N.
  const int p = lookback::take_batched_tile<kFromLeft>(counters, n_tiles,
                                                       &slots);
  const int inst = slots.instance;
  int* status = counters + 2 + (size_t)inst * n_tiles;
  float* aggs = instance_rows(scratch, inst,
                              (size_t)n_tiles * (F + 2 * SA));  // (n_tiles, F)
  float* incl = aggs + (size_t)n_tiles * F;       // (n_tiles, SA)
  float* entering = incl + (size_t)n_tiles * SA;  // (n_tiles, SA)
  const int k0 = p * kWideTile, steps = min(kWideTile, N - k0);
  {
    const float* Pm = instance_rows(P_all, inst, (size_t)N * NN);
    for (int i = tid; i < kWideTile * P * P; i += kThreads) {
      const int k = i / (P * P), e = i % (P * P), row = e / P, col = e % P;
      float v = 0.0f;
      if (row < n && col < n)
        v = k < steps ? Pm[(size_t)(k0 + k) * NN + row * n + col]
                      : (row == col ? 1.0f : 0.0f);
      Ps[k * SZ + row * LD + col] = v;
    }
  }
  if (p == 0) {
    float* out = instance_rows(out_all, inst, (size_t)SA * (N + 1));
    const float* delta0 = instance_rows(d0_all, inst, SA);
    for (int i = tid; i < SA; i += kThreads)
      out[(size_t)(i / n) * (N + 1) * n + i % n] = delta0[i];
  }
  __syncthreads();

  // 2. The aggregate: the product P_last ... P_first by a fixed tree of
  // warp products (level 1: warp w forms P_2w+1 P_2w; each level pairs the
  // last one's products the same way, later on the left), and each
  // candidate's drive carried from 0 through the tile.
  const float* src = Ps;
  float* dst = smw + W::kTree0;
  for (int count = kWideTile / 2; count >= 1; count /= 2) {
    if (warp < count) {
      grp::Tile<P> c;
      grp::mm<P>(ln, src + (2 * warp + 1) * SZ, src + 2 * warp * SZ, c);
      grp::store<P>(ln, c, dst + warp * SZ);
    }
    __syncthreads();
    src = dst;
    dst = dst == smw + W::kTree0 ? smw + W::kTree1 : smw + W::kTree0;
  }
  float* agg = aggs + (size_t)p * F;
  if (warp == 0) {
    for (int i = ln.l; i < NN; i += 32) agg[i] = src[(i / n) * LD + i % n];
    __threadfence();
  }
  for (int c = warp; c < A; c += kWideWarps) {
    float qv[kWideTile];
    load_drives(instance_rows(q_all, inst, (size_t)SA * N), c, N, n, k0,
                steps, r, qv);
    float x = 0.0f;
#pragma unroll
    for (int k = 0; k < kWideTile; ++k)
      if (k < steps) x = affine_row<P>(ln, Ps + k * SZ, x, qv[k]);
    if (ln.l < n) agg[NN + c * n + ln.l] = x;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kAggregate);

  // 3. Look-back, a warp a candidate: the nearest inclusive state to the
  // left (or delta_0) through the aggregates up to this tile's own, each
  // read from L2; the state before the last is the one entering the tile.
  const int qt = lookback::find_inclusive<kFromLeft>(
      status, p, n_tiles, &slots);
  for (int c = warp; c < A; c += kWideWarps) {
    float x = 0.0f;
    if (r < n && ln.l < P)
      x = qt >= 0 ? __ldcg(incl + (size_t)qt * SA + c * n + r)
                  : instance_rows(d0_all, slots.instance, SA)[c * n + r];
    for (int j = qt + 1; j <= p; ++j) {
      const float* aj = aggs + (size_t)j * F;
      if (j == p && ln.l < n) entering[(size_t)p * SA + c * n + ln.l] = x;
      float s = r < n ? __ldcg(aj + NN + c * n + r) : 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float xi = __shfl_sync(grp::kWarp, x, i);
        if (r < n && i < n) s = fmaf(__ldcg(aj + r * n + i), xi, s);
      }
      x = ln.l < P ? s : 0.0f;
    }
    if (ln.l < n) incl[(size_t)p * SA + c * n + ln.l] = x;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kInclusive);
  if (lookback::arrive(counters, n_inst * n_tiles, &slots)) {
    lookback::reset(counters, n_inst * n_tiles);
  }

  // 4. Every step's delta, from the state entering the tile (the
  // instance's rows found here, not carried over the look-back).
  const int i4 = slots.instance;
  const float* q = instance_rows(q_all, i4, (size_t)SA * N);
  float* out = instance_rows(out_all, i4, (size_t)SA * (N + 1));
  for (int c = warp; c < A; c += kWideWarps) {
    float qv[kWideTile];
    load_drives(q, c, N, n, k0, steps, r, qv);
    float x = ln.l < n ? entering[(size_t)p * SA + c * n + ln.l] : 0.0f;
    float* o = out + ((size_t)c * (N + 1) + k0 + 1) * n;
#pragma unroll
    for (int k = 0; k < kWideTile; ++k) {
      if (k < steps) {
        x = affine_row<P>(ln, Ps + k * SZ, x, qv[k]);
        if (ln.l < n) o[(size_t)k * n + ln.l] = x;
      }
    }
  }
}

template <int P>
int run_wide(int n, int A, int B, int N, const float* Pm, const float* q,
             const float* delta0, int* counters, float* scratch, float* out,
             cudaStream_t stream) {
  using S = WideSmem<P>;
  const int n_tiles = (N + kWideTile - 1) / kWideTile;
  cudaError_t err = cudaFuncSetAttribute(
      wide_prefix_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_prefix_kernel<P><<<B * n_tiles, S::kThreads, S::kBytes, stream>>>(
      Pm, q, delta0, n, A, N, n_tiles, B, counters, scratch, out);
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
        &blocks, wide_prefix_kernel<P>, S::kThreads, S::kBytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

bool register_form(int n, int A) {
  return (n == 2 || n == 4) && A <= kMaxCand;
}
int wide_pad(int n) { return n <= 8 ? 8 : 16; }
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
// call) and floats; -1 where a count does not fit an int.
static int fits(long long count) {
  return count > 0x7fffffffLL ? -1 : static_cast<int>(count);
}
static long long scratch_floats(int n, int A, int N) {
  return (long long)tiles(n, A, N) *
         (n * n + (register_form(n, A) ? 2 : 3) * A * n);
}
extern "C" int ilqr_affine_prefix_scan_counters(int n, int A, int N) {
  return lookback::counter_ints(tiles(n, A, N));
}
extern "C" int ilqr_affine_prefix_scan_scratch(int n, int A, int N) {
  return fits(scratch_floats(n, A, N));
}
extern "C" int ilqr_affine_prefix_scan_batched_counters(int n, int A, int B,
                                                        int N) {
  return fits(2 + (long long)B * tiles(n, A, N));
}
extern "C" int ilqr_affine_prefix_scan_batched_scratch(int n, int A, int B,
                                                       int N) {
  return fits(B * scratch_floats(n, A, N));
}

// Blocks of the kernel resident on one SM at n and A candidates (a
// negative CUDA error code on failure).
extern "C" int ilqr_affine_prefix_scan_occupancy(int n, int A) {
  if (A < 1 || n < 1 || n > 16) return -static_cast<int>(cudaErrorInvalidValue);
  if (n == 2 && A <= kMaxCand)
    return A == 1 ? occupancy<2, 1>(A) : occupancy<2, kMaxCand>(A);
  if (n == 4 && A <= kMaxCand)
    return A == 1 ? occupancy<4, 1>(A) : occupancy<4, kMaxCand>(A);
  return wide_pad(n) == 8 ? wide_occupancy<8>() : wide_occupancy<16>();
}

// The launches of both entries: B chains of N steps with A candidates,
// the register form at n in {2, 4} with A <= 16, the wide form at every
// other n <= 16.
static int scan(int n, int A, int B, int N, const float* P, const float* q,
                const float* delta0, int* counters, float* scratch,
                float* out, cudaStream_t s) {
  if (A < 1 || B < 1 || N < 1 || n < 1 || n > 16 ||
      (long long)B * tiles(n, A, N) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (register_form(n, A)) {
    if (n == 2 && A == 1)
      return run<2, 1>(A, B, N, P, q, delta0, counters, scratch, out, s);
    if (n == 2)
      return run<2, kMaxCand>(A, B, N, P, q, delta0, counters, scratch, out,
                              s);
    if (A == 1)
      return run<4, 1>(A, B, N, P, q, delta0, counters, scratch, out, s);
    return run<4, kMaxCand>(A, B, N, P, q, delta0, counters, scratch, out, s);
  }
  if (wide_pad(n) == 8)
    return run_wide<8>(n, A, B, N, P, q, delta0, counters, scratch, out, s);
  return run_wide<16>(n, A, B, N, P, q, delta0, counters, scratch, out, s);
}

// One launch.  Inputs P (N, n, n), q (A, N, n), delta0 (A, n); counters
// and scratch as sized above; output out (A, N+1, n).
extern "C" int ilqr_affine_prefix_scan(int n, int A, int N, const float* P,
                                       const float* q, const float* delta0,
                                       int* counters, float* scratch,
                                       float* out, void* stream) {
  return scan(n, A, 1, N, P, q, delta0, counters, scratch, out,
              static_cast<cudaStream_t>(stream));
}

// One launch over B chains: P (B, N, n, n), q (B, A, N, n), delta0
// (B, A, n), contiguous; out (B, A, N+1, n), instance i's that of
// ilqr_affine_prefix_scan on instance i alone.
extern "C" int ilqr_affine_prefix_scan_batched(
    int n, int A, int B, int N, const float* P, const float* q,
    const float* delta0, int* counters, float* scratch, float* out,
    void* stream) {
  return scan(n, A, B, N, P, q, delta0, counters, scratch, out,
              static_cast<cudaStream_t>(stream));
}
