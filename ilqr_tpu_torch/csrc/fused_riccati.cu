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
// What bounds it on an H100: latency.  By its bytes (the expansion read
// and the gains written, ~100 bytes a step) and by its operations (30 n_x^3
// a step) it would take microseconds; what it pays is a chain of dependent
// small-matrix steps.  One combine is a 4x4 inverse and about ten 4x4
// products (~1.3 kflop at n_x = 4) on an element of F = 3 n_x^2 + 2 n_x =
// 56 floats in one thread's registers, and a scan over a tile of T steps
// runs log2(T) of them in a row; the carry across tiles is a chain of one
// value-function application per tile.
//
// Design (fused_kernel): one launch, one block per tile of kTileSteps
// steps, no round trip of per-step data through device memory.
//   1. Tiles take indices from a global ticket in the order they start,
//      from the right end, so that a tile only ever waits for tiles that
//      are already running.  One thread per step builds its element from
//      the expansion (R = l_uu + reg I inverted in closed form), then a
//      Hillis-Steele suffix scan over the tile in shared memory (field-
//      major, conflict-free; at distance d each element joins the adjacent
//      window that starts d later, so windows never overlap: the combine is
//      neither commutative nor idempotent).  At T = 256 that is 8 dependent
//      combines; a reduce-then-scan with R steps a thread would cost
//      (R - 1) + log2(T / R) combines and R applications, deeper for every
//      R >= 2 at the main path's horizons (N = 400-800 is 2-4 tiles), and
//      one element a thread is what the register file holds at T = 256.
//   2. The tile publishes its aggregate (its local suffix at its first
//      step, F floats) and then, by decoupled look-back, its inclusive value
//      function (eta, J): the CUDA form of the TPU kernel's right-to-left
//      walk with its carry in SMEM.  The block polls the status words of the
//      tiles to its right, kTileSteps at a time, for the nearest one whose
//      inclusive value is out; every tile in between has its aggregate out.
//      Only (eta, J) of the later operand enter the (eta, J) of a combine
//      (apply_value), so the value at the tile's right edge is that value
//      carried left through those aggregates, one apply_value each, staged
//      in shared memory.  Every carry is the same chain of apply_value calls
//      on the same inputs, at one call site, wherever the look-back stops:
//      a repeated call gives the same bits.
//   3. Each step closes its local suffix with the edge value, which gives
//      V(k) in shared memory; step t reads V(t+1) and forms the Q-expansion,
//      the gains and its dV.  The block sums dV1, dV2 and a count of
//      non-finite gains in a fixed tree; the last block to finish sums the
//      tiles' partials in tile order (no float atomics), writes dV and the
//      all-finite flag, and resets the ticket and the status words, so the
//      next call on the stream needs no memset.
// Scratch (per device, stream and shape, zeroed once by the wrapper):
// counters [ticket, done, status (n_tiles)] and floats [aggregates
// (n_tiles, F), inclusive values (n_tiles, n_x + n_x^2), partials
// (n_tiles, 3)].
//
// The first design, three launches (blocked scan, one-thread boundary walk,
// gains) with the block-local suffixes round-tripped through device memory,
// stays callable as ilqr_fused_riccati_blocked for comparison on the card;
// only chip_smoke.py calls it.
//
// GNMS defects (multiple shooting, B1d; the with_defects variant of the TPU
// kernel): with gaps d_k the local dynamics are affine, dx+ = f_x dx +
// f_u du + d_k, which adds d_k to the stage element's b and shifts the
// gains' linear terms by V_x(t+1) += V_xx(t+1) d_t.  A null defects pointer
// is the plain backward pass.
#include <cuda_runtime.h>
#include <math.h>

#include "riccati_scan.cuh"

namespace {

using namespace ilqr;

constexpr int kTileSteps = 256;   // steps of a tile = threads of its block
constexpr int kStageTiles = 64;   // aggregates staged per look-back round
constexpr int kBlockSteps = 256;  // blocked design: steps per scan block
constexpr int kGainThreads = 128;  // blocked design: threads of pass 3

enum TileStatus : int { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

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

// Inclusive suffix scan of the T elements of a block, one a thread, in
// place in e; `smem` holds F x T floats (field-major).  Element k's partner
// at distance d is skipped past the terminal element k + d > N (identity).
template <int NX, int T>
__device__ __forceinline__ void tile_suffix_scan(float* e, float* smem,
                                                 int tid, int k, int N) {
  using E = Elem<NX>;
  for (int d = 1; d < T; d <<= 1) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) smem[f * T + tid] = e[f];
    __syncthreads();
    if (tid + d < T && k + d <= N) {
      float p[E::F], o[E::F];
#pragma unroll
      for (int f = 0; f < E::F; ++f) p[f] = smem[f * T + tid + d];
      combine<NX>(e, p, o);
#pragma unroll
      for (int f = 0; f < E::F; ++f) e[f] = o[f];
    }
    __syncthreads();
  }
}

// Step t's gains and dV from the value V(t+1) = (J_n, -eta_n).
template <int NX, int NU>
__device__ __forceinline__ void gains(const Expansion& ex, int t, float reg,
                                      const float* eta_n, const float* J_n,
                                      float* __restrict__ u_ff_out,
                                      float* __restrict__ K_out, float& dv1,
                                      float& dv2, float& bad) {
  constexpr int NN = NX * NX;
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

// Sums of (a, b, c) over the T threads of a block in a fixed tree; thread 0
// gets them in red[0], red[T], red[2T].  `red` holds 3 T floats.
template <int T>
__device__ __forceinline__ void block_sum3(float* red, int tid, float a,
                                           float b, float c) {
  red[tid] = a;
  red[T + tid] = b;
  red[2 * T + tid] = c;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      red[T + tid] += red[T + tid + s];
      red[2 * T + tid] += red[2 * T + tid + s];
    }
    __syncthreads();
  }
}

// Device-scope publication between blocks: payload stores, a fence, then
// the status word; readers poll the word, fence, and read the payload from
// L2 (L1 is not coherent across SMs).
__device__ __forceinline__ void publish(int* word, int value) {
  __threadfence();
  atomicExch(word, value);
}

__device__ __forceinline__ int poll(const int* word) {
  const int v = *reinterpret_cast<const volatile int*>(word);
  __threadfence();
  return v;
}

// Shared memory of fused_kernel, in floats after a 4-int header.
template <int NX>
struct TileSmem {
  static constexpr int F = Elem<NX>::F;
  static constexpr int NV = NX + NX * NX;   // a value function (eta, J)
  static constexpr int kHeader = 4;         // ints: tile, q, last, spare
  static constexpr int kBuf = 0;            // F x T: the scan, then e_k
  static constexpr int kVals = kBuf + F * kTileSteps;   // NV x (T + 1)
  static constexpr int kStage = kVals + NV * (kTileSteps + 1);
  static constexpr int kFloats = kStage + kStageTiles * F;
  static constexpr int kBytes = 4 * kHeader + 4 * kFloats;
};

template <int NX, int NU>
__global__ void __launch_bounds__(kTileSteps, 1)
fused_kernel(Expansion ex, int N, float reg, int n_tiles,
             int* __restrict__ counters, float* __restrict__ scratch,
             float* __restrict__ u_ff_out, float* __restrict__ K_out,
             float* __restrict__ dV_out, unsigned char* __restrict__ ok_out) {
  using E = Elem<NX>;
  using S = TileSmem<NX>;
  constexpr int F = E::F, NN = E::NN, NV = S::NV, T = kTileSteps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* hdr = reinterpret_cast<int*>(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw + 4 * S::kHeader);
  float* buf = sm + S::kBuf;
  float* vals = sm + S::kVals;   // vals[i * (T + 1) + c]: field i of V(c)
  float* stage = sm + S::kStage;
  int* ticket = counters;
  int* done = counters + 1;
  int* status = counters + 2;
  float* aggs = scratch;                        // (n_tiles, F)
  float* values = aggs + (size_t)n_tiles * F;   // (n_tiles, NV)
  float* partials = values + (size_t)n_tiles * NV;   // (n_tiles, 3)
  const int tid = threadIdx.x;

  // 1. The tile in start order from the right end; its elements and their
  // tile-local suffixes.
  if (tid == 0) {
    hdr[0] = n_tiles - 1 - atomicAdd(ticket, 1);
    hdr[1] = n_tiles;
  }
  __syncthreads();
  const int p = hdr[0];
  const int k = p * T + tid;
  {
    float e[F];
    build_element<NX, NU>(k, N, ex, reg, e);
    tile_suffix_scan<NX, T>(e, buf, tid, k, N);
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) aggs[(size_t)p * F + f] = e[f];
      publish(&status[p], kAggregate);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) buf[f * T + tid] = e[f];
  }
  // The block stages this tile's aggregate below, even when the loop that
  // follows does not run (the last tile).
  __syncthreads();

  // 2. Look-back: q = the nearest tile to the right whose inclusive value
  // is out (n_tiles: none; the value beyond the last step is zero).  Every
  // tile to the right started earlier, so each publishes its aggregate
  // without waiting for this one.
  for (int base = p + 1; base < n_tiles; base += T) {
    const int j = base + tid;
    if (j < n_tiles) {
      int s;
      do {
        s = poll(&status[j]);
      } while (s == kEmpty);
      if (s == kInclusive) atomicMin(&hdr[1], j);
    }
    __syncthreads();
    const bool found = hdr[1] < n_tiles;
    __syncthreads();
    if (found) break;
  }
  const int q = hdr[1];
  // Carry (eta, J) from q leftward through the aggregates of q-1 .. p,
  // thread 0 applying, the block staging kStageTiles aggregates at a time.
  float eta[NX], J[NN];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      eta[i] = q < n_tiles ? __ldcg(values + (size_t)q * NV + i) : 0.0f;
#pragma unroll
    for (int i = 0; i < NN; ++i)
      J[i] = q < n_tiles ? __ldcg(values + (size_t)q * NV + NX + i) : 0.0f;
  }
  for (int hi = q - 1; hi >= p; hi -= kStageTiles) {
    const int lo = max(p, hi - kStageTiles + 1);
    for (int i = tid; i < (hi - lo + 1) * F; i += T)
      stage[i] = __ldcg(aggs + (size_t)lo * F + i);
    __syncthreads();
    if (tid == 0) {
      for (int j = hi; j >= lo; --j) {
        if (j == p) {   // the value at this tile's right edge
#pragma unroll
          for (int i = 0; i < NX; ++i) vals[i * (T + 1) + T] = eta[i];
#pragma unroll
          for (int i = 0; i < NN; ++i) vals[(NX + i) * (T + 1) + T] = J[i];
        }
        float eta2[NX], J2[NN], Li[NN];
        apply_value<NX>(stage + (j - lo) * F, eta, J, eta2, J2, Li);
#pragma unroll
        for (int i = 0; i < NX; ++i) eta[i] = eta2[i];
#pragma unroll
        for (int i = 0; i < NN; ++i) J[i] = J2[i];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) values[(size_t)p * NV + i] = eta[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) values[(size_t)p * NV + NX + i] = J[i];
    publish(&status[p], kInclusive);
  }

  // 3. V(k) = local suffix at k closed with the edge value; then the gains.
  if (k <= N) {
    float e[F], edge[NV], eta_k[NX], J_k[NN], Li[NN];
#pragma unroll
    for (int f = 0; f < F; ++f) e[f] = buf[f * T + tid];
#pragma unroll
    for (int i = 0; i < NV; ++i) edge[i] = vals[i * (T + 1) + T];
    apply_value<NX>(e, edge, edge + NX, eta_k, J_k, Li);
#pragma unroll
    for (int i = 0; i < NX; ++i) vals[i * (T + 1) + tid] = eta_k[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) vals[(NX + i) * (T + 1) + tid] = J_k[i];
  }
  __syncthreads();
  float dv1 = 0.0f, dv2 = 0.0f, bad = 0.0f;
  if (k < N) {
    float eta_n[NX], J_n[NN];
#pragma unroll
    for (int i = 0; i < NX; ++i) eta_n[i] = vals[i * (T + 1) + tid + 1];
#pragma unroll
    for (int i = 0; i < NN; ++i) J_n[i] = vals[(NX + i) * (T + 1) + tid + 1];
    gains<NX, NU>(ex, k, reg, eta_n, J_n, u_ff_out, K_out, dv1, dv2, bad);
  }

  // 4. dV and the finite flag: per tile, then over tiles by the last block.
  block_sum3<T>(buf, tid, dv1, dv2, bad);
  if (tid == 0) {
    partials[(size_t)p * 3 + 0] = buf[0];
    partials[(size_t)p * 3 + 1] = buf[T];
    partials[(size_t)p * 3 + 2] = buf[2 * T];
    __threadfence();
    hdr[2] = atomicAdd(done, 1) == n_tiles - 1;
  }
  __syncthreads();
  if (!hdr[2]) return;
  __threadfence();
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int j = tid; j < n_tiles; j += T) {
    s1 += __ldcg(partials + (size_t)j * 3 + 0);
    s2 += __ldcg(partials + (size_t)j * 3 + 1);
    s3 += __ldcg(partials + (size_t)j * 3 + 2);
  }
  block_sum3<T>(buf, tid, s1, s2, s3);
  if (tid == 0) {
    dV_out[0] = buf[0];
    dV_out[1] = buf[T];
    ok_out[0] = buf[2 * T] == 0.0f;
    *ticket = 0;
    *done = 0;
  }
  // Every block has finished reading the status words.
  for (int j = tid; j < n_tiles; j += T) status[j] = kEmpty;
}

template <int NX, int NU>
int run(int N, float reg, const Expansion& ex, int* counters, float* scratch,
        float* u_ff, float* K, float* dV, unsigned char* ok,
        cudaStream_t stream) {
  using S = TileSmem<NX>;
  const int n_tiles = (N + 1 + kTileSteps - 1) / kTileSteps;
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<NX, NU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<NX, NU><<<n_tiles, kTileSteps, S::kBytes, stream>>>(
      ex, N, reg, n_tiles, counters, scratch, u_ff, K, dV, ok);
  return static_cast<int>(cudaGetLastError());
}

// ---- The blocked design (three launches), kept for comparison ------------

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
  tile_suffix_scan<NX, kBlockSteps>(e, smem, tid, k, N);
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
    gains<NX, NU>(ex, t, reg, eta_n, J_n, u_ff_out, K_out, dv1, dv2, bad);
  }
  block_sum3<kGainThreads>(smem, tid, dv1, dv2, bad);
  if (tid == 0) {
    partials[blockIdx.x * 3 + 0] = smem[0];
    partials[blockIdx.x * 3 + 1] = smem[kGainThreads];
    partials[blockIdx.x * 3 + 2] = smem[2 * kGainThreads];
  }
}

template <int NX, int NU>
int run_blocked(int N, float reg, const Expansion& ex, float* local,
                float* edge, float* u_ff, float* K, float* partials,
                cudaStream_t stream) {
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

template <int NX>
constexpr int scratch_floats(int n_tiles) {
  return n_tiles * (Elem<NX>::F + NX + NX * NX + 3);
}

}  // namespace

extern "C" int ilqr_riccati_tile_steps() { return kTileSteps; }

// Sizes of fused_kernel's scratch at horizon N: ints (zeroed once, left
// zeroed by every call) and floats.
extern "C" int ilqr_fused_riccati_counters(int N) {
  return 2 + (N + 1 + kTileSteps - 1) / kTileSteps;
}
extern "C" int ilqr_fused_riccati_scratch(int n_x, int N) {
  const int n_tiles = (N + 1 + kTileSteps - 1) / kTileSteps;
  if (n_x == 2) return scratch_floats<2>(n_tiles);
  if (n_x == 4) return scratch_floats<4>(n_tiles);
  return 0;
}

// One launch.  defects: (N, n_x) or null; counters and scratch as sized
// above; outputs u_ff (N, n_u), K (N, n_u, n_x), dV (2,) = (sum dV1,
// sum dV2) and ok (1 byte) = all gains finite.
extern "C" int ilqr_fused_riccati(
    int n_x, int n_u, int N, float reg, const float* f_x, const float* f_u,
    const float* l_x, const float* l_u, const float* l_xx, const float* l_ux,
    const float* l_uu, const float* v_x, const float* v_xx,
    const float* defects, int* counters, float* scratch, float* u_ff,
    float* K, float* dV, unsigned char* ok, void* stream) {
  const Expansion ex{f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx,
                     defects};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_x == 2 && n_u == 1)
    return run<2, 1>(N, reg, ex, counters, scratch, u_ff, K, dV, ok, s);
  if (n_x == 4 && n_u == 1)
    return run<4, 1>(N, reg, ex, counters, scratch, u_ff, K, dV, ok, s);
  if (n_x == 4 && n_u == 2)
    return run<4, 2>(N, reg, ex, counters, scratch, u_ff, K, dV, ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ilqr_riccati_block_steps() { return kBlockSteps; }
extern "C" int ilqr_riccati_gain_threads() { return kGainThreads; }

// The blocked design, three launches.  Scratch: local (N+1, F), edge
// (n_blocks, n_x + n_x^2); outputs u_ff (N, n_u), K (N, n_u, n_x), partials
// (gain_blocks, 3) = per-block sums of dV1, dV2 and the count of
// non-finite gains.
extern "C" int ilqr_fused_riccati_blocked(
    int n_x, int n_u, int N, float reg, const float* f_x, const float* f_u,
    const float* l_x, const float* l_u, const float* l_xx, const float* l_ux,
    const float* l_uu, const float* v_x, const float* v_xx,
    const float* defects, float* local, float* edge, float* u_ff, float* K,
    float* partials, void* stream) {
  const Expansion ex{f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx,
                     defects};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_x == 2 && n_u == 1)
    return run_blocked<2, 1>(N, reg, ex, local, edge, u_ff, K, partials, s);
  if (n_x == 4 && n_u == 1)
    return run_blocked<4, 1>(N, reg, ex, local, edge, u_ff, K, partials, s);
  if (n_x == 4 && n_u == 2)
    return run_blocked<4, 2>(N, reg, ex, local, edge, u_ff, K, partials, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
