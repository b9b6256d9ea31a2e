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
//      step, F floats) and then, by decoupled look-back (lookback.cuh, shared
//      with B3 and B6/B7), its inclusive value function (eta, J): the CUDA
//      form of the TPU kernel's right-to-left walk with its carry in SMEM.
//      Only (eta, J) of the later operand enter the (eta, J) of a combine
//      (apply_value), so the value at the tile's right edge is the nearest
//      published inclusive value carried left through the aggregates in
//      between, one apply_value each by thread 0, staged in shared memory.
//   3. Each step closes its local suffix with the edge value, which gives
//      V(k) in shared memory; step t reads V(t+1) and forms the Q-expansion,
//      the gains and its dV.  The block sums dV1, dV2 and a count of
//      non-finite gains in a fixed tree; the last block to finish sums the
//      tiles' partials in tile order (no float atomics), writes dV and the
//      all-finite flag, and resets the look-back counters, so the next call
//      on the stream needs no memset.
// Scratch (per device, stream and shape, zeroed once by the wrapper):
// counters [ticket, done, status (n_tiles)] and floats [aggregates
// (n_tiles, F), inclusive values (n_tiles, n_x + n_x^2), partials
// (n_tiles, 3)].
//
// The wide form (wide_fused_kernel; B1w), for every other n_x <= 16,
// n_u <= 6: an element of F = 3 n_x^2 + 2 n_x floats does not fit one
// thread's registers beyond n_x = 4 (800 floats at n_x = 16), and a
// 256-step tile of them does not fit shared memory.  Each step's element
// belongs to a warp, zero-padded to P x P (P = 8 for n_x <= 8, 16 above;
// one instantiation per P), with the entry-parallel math of
// group_linalg.cuh, laid out as the wide suffix scan (suffix_scan.cu, B6w):
// each lane owns 2 or 8 entries of every product, and the inverses (of
// l_uu + reg I, of L = I + C J, of Q_uu + reg I) are Gauss-Jordan with the
// pivot from a warp reduction.  A block of 16 warps holds a tile of 16
// steps and runs the same steps as above: the elements (products whose
// rows or depth run over the controls stop at 8), the out-of-place
// Hillis-Steele scan of `combine`s, the look-back (warp 0 carries (eta,
// J) through the aggregates by `apply_value`, F floats a tile, staged two
// at a time; the carry starts at the last tile's aggregate, taken as it
// is), the closure (each warp's `apply_value` of the edge value; the last
// tile's local suffixes are the suffixes) and
// the gains (the plain version's, by the same products and inverse).  What
// bounds it: the chain of warp-wide inverses and products, log2(16) = 4
// levels of combines in the tile and one value application a tile in the
// look-back; by its counts (30 n_x^3 operations a step) it would be
// operations bound near 15 us at n_x = 16, N = 8192.
//
// GNMS defects (multiple shooting, B1d; the with_defects variant of the TPU
// kernel): with gaps d_k the local dynamics are affine, dx+ = f_x dx +
// f_u du + d_k, which adds d_k to the stage element's b and shifts the
// gains' linear terms by V_x(t+1) += V_xx(t+1) d_t.  A null defects pointer
// is the plain backward pass.
#include <cuda_runtime.h>
#include <math.h>

#include "group_linalg.cuh"
#include "lookback.cuh"
#include "riccati_scan.cuh"

namespace {

using namespace ilqr;

using lookback::kFromRight;

constexpr int kTileSteps = 256;   // steps of a tile = threads of its block
constexpr int kStageTiles = 64;   // aggregates staged per look-back round

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

// Shared memory of fused_kernel, in floats.
template <int NX>
struct TileSmem {
  static constexpr int F = Elem<NX>::F;
  static constexpr int NV = NX + NX * NX;   // a value function (eta, J)
  static constexpr int kBuf = 0;            // F x T: the scan, then e_k
  static constexpr int kVals = kBuf + F * kTileSteps;   // NV x (T + 1)
  static constexpr int kStage = kVals + NV * (kTileSteps + 1);
  static constexpr int kFloats = kStage + kStageTiles * F;
  static constexpr int kBytes = 4 * kFloats;
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
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  float* buf = sm + S::kBuf;
  float* vals = sm + S::kVals;   // vals[i * (T + 1) + c]: field i of V(c)
  float* stage = sm + S::kStage;
  int* status = counters + 2;
  float* aggs = scratch;                        // (n_tiles, F)
  float* values = aggs + (size_t)n_tiles * F;   // (n_tiles, NV)
  float* partials = values + (size_t)n_tiles * NV;   // (n_tiles, 3)
  const int tid = threadIdx.x;

  // 1. The tile in start order from the right end; its elements and their
  // tile-local suffixes.
  const int p = lookback::take_tile<kFromRight>(counters, n_tiles, &slots);
  const int k = p * T + tid;
  {
    float e[F];
    build_element<NX, NU>(k, N, ex, reg, e);
    tile_suffix_scan<NX, T>(e, buf, tid, k, N);
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) aggs[(size_t)p * F + f] = e[f];
      lookback::publish(&status[p], lookback::kAggregate);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) buf[f * T + tid] = e[f];
  }

  // 2. Look-back: q = the nearest tile to the right whose inclusive value
  // is out (none: n_tiles; the value beyond the last step is zero).  Thread
  // 0 carries (eta, J) from q leftward through the aggregates of q-1 .. p;
  // the value before the last step is the one at this tile's right edge.
  const int q = lookback::find_inclusive<kFromRight>(
      counters + 2, p, n_tiles, &slots);
  float eta[NX], J[NN], eta_e[NX], J_e[NN];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      eta[i] = q < n_tiles ? __ldcg(values + (size_t)q * NV + i) : 0.0f;
#pragma unroll
    for (int i = 0; i < NN; ++i)
      J[i] = q < n_tiles ? __ldcg(values + (size_t)q * NV + NX + i) : 0.0f;
  }
  lookback::fold<kFromRight, kStageTiles>(
      aggs, F, p, q, stage, tid == 0, [&](const float* agg) {
        float eta2[NX], J2[NN], Li[NN];
        apply_value<NX>(agg, eta, J, eta2, J2, Li);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          eta_e[i] = eta[i];
          eta[i] = eta2[i];
        }
#pragma unroll
        for (int i = 0; i < NN; ++i) {
          J_e[i] = J[i];
          J[i] = J2[i];
        }
      });
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) values[(size_t)p * NV + i] = eta[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) values[(size_t)p * NV + NX + i] = J[i];
    lookback::publish(&status[p], lookback::kInclusive);
    // The value at this tile's right edge.
#pragma unroll
    for (int i = 0; i < NX; ++i) vals[i * (T + 1) + T] = eta_e[i];
#pragma unroll
    for (int i = 0; i < NN; ++i) vals[(NX + i) * (T + 1) + T] = J_e[i];
  }
  __syncthreads();

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
  }
  if (!lookback::arrive(counters, n_tiles, &slots)) return;
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
  }
  lookback::reset(counters, n_tiles);
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

int tiles(int N) { return (N + 1 + kTileSteps - 1) / kTileSteps; }

template <int NX>
constexpr int scratch_floats(int n_tiles) {
  return n_tiles * (Elem<NX>::F + NX + NX * NX + 3);
}

// ---- The wide form (B1w) --------------------------------------------------

constexpr int kWideTile = 16;   // steps of a tile: a warp each
constexpr int kWideStage = 2;   // aggregates staged per look-back round
constexpr int kWideU = 8;       // rows and depths that run over the controls
constexpr int kWideMaxN = 1 << 23;   // horizons the wide form takes

template <int P>
struct WideSmem {
  using E = grp::Elem<P>;
  static constexpr int SZ = grp::Mat<P>::SIZE;
  static constexpr int NV = SZ + P;   // a value function: J, then eta
  static constexpr int T = kWideTile;
  static constexpr int kThreads = 32 * T;
  static constexpr int kBuf0 = 0;                       // T elements
  static constexpr int kBuf1 = kBuf0 + T * E::F;        // T elements
  static constexpr int kWork = kBuf1 + T * E::F;        // T work spaces
  static constexpr int kVals = kWork + T * E::WORK;     // T + 1 values
  static constexpr int kCarry = kVals + (T + 1) * NV;   // 3 values
  static constexpr int kStage = kCarry + 3 * NV;
  static constexpr int kFloats = kStage + kWideStage * E::F;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kBytes <= 232448 - 64, "a tile must fit shared memory");
};

// The value (J, eta) of element e, J then eta as the kernel keeps values:
// the value of e (x) 0, the suffix at the last step of the horizon, as the
// plain scan has it (apply_value of the zero value would form the same
// entries but J symmetrised, and the terminal element's J = v_xx is the
// caller's).
template <int P>
__device__ __forceinline__ void take_value(const grp::Lane& ln,
                                           const float* e, float* v) {
  using E = grp::Elem<P>;
  if (ln.l < P) v[WideSmem<P>::SZ + ln.l] = e[E::ETA + ln.l];
  grp::copy(ln, e + E::J, v, WideSmem<P>::SZ);
}

// Element k of the wide form into e, zero-padded (see build_element);
// s and w are 3 P x P matrices and 2 vectors of work space each.
template <int P>
__device__ __forceinline__ void build_wide(const grp::Lane& ln, int nx,
                                           int nu, int k, int N,
                                           const Expansion& ex, float reg,
                                           float* e, float* s, float* w) {
  using E = grp::Elem<P>;
  constexpr int SZ = E::S, U = kWideU;
  const int l = ln.l;
  grp::Tile<P> a, d;
  if (k > N) {
    grp::identity<P>(ln, nx, e);
    return;
  }
  if (k == N) {
    const grp::Tile<P> zero = {};
    grp::load_raw<P>(ln, ex.v_xx, nx, nx, a);
    grp::store<P>(ln, a, e + E::J);
    grp::store<P>(ln, zero, e + E::A);
    grp::store<P>(ln, zero, e + E::C);
    if (l < P) {
      e[E::B + l] = 0.0f;
      e[E::ETA + l] = l < nx ? -ex.v_x[l] : 0.0f;
    }
    grp::sync();
    return;
  }
  float* FU = s;           // f_u
  float* Mm = s + SZ;      // M = l_ux
  float* Rm = s + 2 * SZ;  // R = l_uu + reg I, then C before sym
  float* lu = s + 3 * SZ;
  float* rir = lu + P;     // R^-1 r
  float* Ri = w;           // R^-1, then J before sym
  float* RiM = w + SZ;
  float* RiBt = w + 2 * SZ;
  const size_t NN = (size_t)nx * nx;
  grp::load_raw<P>(ln, ex.f_u + (size_t)k * nx * nu, nx, nu, a);
  grp::store<P>(ln, a, FU);
  grp::load_raw<P>(ln, ex.l_ux + (size_t)k * nu * nx, nu, nx, a);
  grp::store<P>(ln, a, Mm);
  grp::load_raw<P>(ln, ex.l_uu + (size_t)k * nu * nu, nu, nu, a);
  grp::add_diag<P>(ln, nu, reg, a);
  grp::store<P>(ln, a, Rm);
  if (l < P) lu[l] = l < nu ? ex.l_u[(size_t)k * nu + l] : 0.0f;
  grp::sync();
  grp::inv<P>(ln, nu, Rm, Ri);
  // R^-1 M, R^-1 f_u' and R^-1 r: rows and depths past U are zero.
  grp::mm<P, false, false, U, U>(ln, Ri, Mm, a);
  grp::store<P>(ln, a, RiM);
  grp::mm<P, false, true, U, U>(ln, Ri, FU, a);
  grp::store<P>(ln, a, RiBt);
  if (l < P) rir[l] = grp::dot_row<P>(Ri, l, lu);
  grp::sync();
  // A = f_x - f_u R^-1 M.
  grp::mm<P, false, false, P, U>(ln, FU, RiM, a);
  grp::load_raw<P>(ln, ex.f_x + k * NN, nx, nx, d);
#pragma unroll
  for (int t = 0; t < grp::Mat<P>::R; ++t)
#pragma unroll
    for (int j = 0; j < grp::Mat<P>::CC; ++j) d.v[t][j] -= a.v[t][j];
  grp::store<P>(ln, d, e + E::A);
  // C = sym(f_u R^-1 f_u') and J = sym(l_xx - M' R^-1 M), formed in Rm and
  // Ri.
  grp::mm<P, false, false, P, U>(ln, FU, RiBt, a);
  grp::store<P>(ln, a, Rm);
  grp::mm<P, true, false, P, U>(ln, Mm, RiM, a);
  grp::load_raw<P>(ln, ex.l_xx + k * NN, nx, nx, d);
#pragma unroll
  for (int t = 0; t < grp::Mat<P>::R; ++t)
#pragma unroll
    for (int j = 0; j < grp::Mat<P>::CC; ++j) d.v[t][j] -= a.v[t][j];
  grp::store<P>(ln, d, Ri);
  // b = -f_u R^-1 r (+ d), eta = -(l_x - M' R^-1 r).
  if (l < P) {
    float b = -grp::dot_row<P>(FU, l, rir);
    if (ex.d != nullptr && l < nx) b += ex.d[(size_t)k * nx + l];
    e[E::B + l] = b;
  } else if (l < 2 * P) {
    const int i = l - P;
    e[E::ETA + i] =
        i < nx ? -(ex.l_x[(size_t)k * nx + i] - grp::dot_col<P>(Mm, i, rir))
               : 0.0f;
  }
  grp::sync();
  grp::sym<P>(ln, Rm, e + E::C);
  grp::sym<P>(ln, Ri, e + E::J);
}

// Step t's gains, and dV and the finite flag on lane 0, from V(t+1) =
// (J_n, -eta_n): the plain version's gains_from_value.  s0, s1 and w are 3
// P x P matrices and 2 vectors of work space each.  Offsets are ints (t
// 16^2 < 2^31 for N < kWideMaxN): 64-bit ones spilled registers at P = 16.
template <int P>
__device__ __forceinline__ void gains_wide(
    const grp::Lane& ln, int nx, int nu, const Expansion& ex, int t,
    float reg, const float* eta_n, const float* J_n, float* s0, float* s1,
    float* w, float* __restrict__ u_ff_out, float* __restrict__ K_out,
    float& dv1, float& dv2, float& bad) {
  using M = grp::Mat<P>;
  constexpr int SZ = M::SIZE, U = kWideU;
  const int l = ln.l;
  float* FU = s1;
  float* FX = s1 + SZ;
  float* Fm = s1 + 2 * SZ;   // f_u' V_xx
  float* vx = s1 + 3 * SZ;   // V_x (+ V_xx d)
  float* Qu = vx + P;
  float* Qux = w;
  float* Quu = w + SZ;
  float* Rm = w + 2 * SZ;    // Q_uu + reg I
  float* u = w + 3 * SZ;     // u_ff
  float* Qi = s0;            // (Q_uu + reg I)^-1
  float* dt = s0 + 3 * SZ;   // d_t
  grp::Tile<P> a, d;
  grp::load_raw<P>(ln, ex.f_u + t * nx * nu, nx, nu, a);
  grp::store<P>(ln, a, FU);
  grp::load_raw<P>(ln, ex.f_x + t * nx * nx, nx, nx, a);
  grp::store<P>(ln, a, FX);
  if (ex.d != nullptr && l < P)
    dt[l] = l < nx ? ex.d[t * nx + l] : 0.0f;
  grp::sync();
  if (l < P) {
    vx[l] = -eta_n[l];
    if (ex.d != nullptr) vx[l] += grp::dot_row<P>(J_n, l, dt);
  }
  grp::mm<P, true, false, U, P>(ln, FU, J_n, a);
  grp::store<P>(ln, a, Fm);
  grp::sync();
  // Q_u = l_u + f_u' V_x; Q_ux = l_ux + F f_x; Q_uu = l_uu + F f_u.
  if (l < P)
    Qu[l] = l < nu ? ex.l_u[t * nu + l] + grp::dot_col<P>(FU, l, vx)
                   : 0.0f;
  grp::mm<P, false, false, U, P>(ln, Fm, FX, a);
  grp::load_raw<P>(ln, ex.l_ux + t * nu * nx, nu, nx, d);
  grp::add<P>(a, d);
  grp::store<P>(ln, a, Qux);
  grp::mm<P, false, false, U, P>(ln, Fm, FU, a);
  grp::load_raw<P>(ln, ex.l_uu + t * nu * nu, nu, nu, d);
  grp::add<P>(a, d);
  grp::store<P>(ln, a, Quu);
  grp::add_diag<P>(ln, nu, reg, a);
  grp::store<P>(ln, a, Rm);
  grp::sync();
  grp::inv<P>(ln, nu, Rm, Qi);
  // K = -(Q_uu + reg I)^-1 Q_ux, u_ff = -(Q_uu + reg I)^-1 Q_u.
  grp::mm<P, false, false, U, U>(ln, Qi, Qux, a);
  bool b = false;
#pragma unroll
  for (int r = 0; r < M::R; ++r)
#pragma unroll
    for (int j = 0; j < M::CC; ++j) {
      const int i = ln.rg + 8 * r, jj = M::CC * ln.cg + j;
      if (i < nu && jj < nx) {
        const float kv = -a.v[r][j];
        K_out[(t * nu + i) * nx + jj] = kv;
        b |= !isfinite(kv);
      }
    }
  if (l < P) {
    const float v = -grp::dot_row<P>(Qi, l, Qu);
    u[l] = v;
    if (l < nu) {
      u_ff_out[t * nu + l] = v;
      b |= !isfinite(v);
    }
  }
  grp::sync();
  // dV = (u_ff' Q_u, 0.5 u_ff' Q_uu u_ff).
  if (__ballot_sync(grp::kWarp, b) != 0u) bad = 1.0f;
  if (l == 0) {
    float s1v = 0.0f, s2v = 0.0f;
    for (int i = 0; i < nu; ++i) {
      s1v = fmaf(u[i], Qu[i], s1v);
      s2v = fmaf(u[i], grp::dot_row<P>(Quu, i, u), s2v);
    }
    dv1 = s1v;
    dv2 = 0.5f * s2v;
  }
}

template <int P>
__global__ void __launch_bounds__(32 * kWideTile, 1)
wide_fused_kernel(Expansion ex, int nx, int nu, int N, float reg,
                  int n_tiles, int* __restrict__ counters,
                  float* __restrict__ scratch, float* __restrict__ u_ff_out,
                  float* __restrict__ K_out, float* __restrict__ dV_out,
                  unsigned char* __restrict__ ok_out) {
  using E = grp::Elem<P>;
  using S = WideSmem<P>;
  constexpr int F = E::F, NV = S::NV, SZ = S::SZ, T = S::T,
                kThreads = S::kThreads;
  extern __shared__ __align__(16) float sm[];
  __shared__ lookback::Slots slots;
  int* status = counters + 2;
  float* aggs = scratch;                               // (n_tiles, F)
  float* values = aggs + (size_t)n_tiles * F;          // (n_tiles, NV)
  float* partials = values + (size_t)n_tiles * NV;     // (n_tiles, 3)
  float* vals = sm + S::kVals;   // V(c) of the tile's steps, V(T) the edge
  const int tid = threadIdx.x, q = tid / 32;
  const grp::Lane ln;
  float* w = sm + S::kWork + q * E::WORK;

  // 1. The tile from the right end; its elements and local suffixes.
  const int p = lookback::take_tile<kFromRight>(counters, n_tiles, &slots);
  const int k = p * T + q;
  build_wide<P>(ln, nx, nu, k, N, ex, reg, sm + S::kBuf0 + q * F,
                sm + S::kBuf1 + q * F, w);
  __syncthreads();
  float* buf = grp::tile_suffix_scan<P, T>(ln, q, nx, k, N, sm + S::kBuf0,
                                           sm + S::kBuf1, w);
  float* other = buf == sm + S::kBuf0 ? sm + S::kBuf1 : sm + S::kBuf0;
  for (int i = tid; i < F; i += kThreads) {
    aggs[(size_t)p * F + i] = buf[i];
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) lookback::publish(&status[p], lookback::kAggregate);

  // 2. Look-back: warp 0 carries (eta, J) from the nearest inclusive tile
  // q2 through the aggregates of q2-1 .. p (three values in rotation: the
  // carry, its previous value and the next).  With none (q2 = n_tiles) the
  // carry starts at the last tile's aggregate, taken as it is.
  const int q2 = lookback::find_inclusive<kFromRight>(
      counters + 2, p, n_tiles, &slots);
  const bool last = p == n_tiles - 1;
  float* cur = sm + S::kCarry;
  float* prev = cur + NV;
  float* next = prev + NV;
  bool started = q2 < n_tiles;
  if (q == 0 && started) {
    for (int i = ln.l; i < NV; i += 32)
      cur[i] = __ldcg(values + (size_t)q2 * NV + i);
    grp::sync();
  }
  lookback::fold<kFromRight, kWideStage>(
      aggs, F, p, q2, sm + S::kStage, q == 0, [&](const float* agg) {
        if (!started) {
          take_value<P>(ln, agg, cur);
          started = true;
          return;
        }
        grp::apply_value<P>(ln, nx, agg, cur + SZ, cur, next + SZ, next, w);
        float* t = prev;
        prev = cur;
        cur = next;
        next = t;
      });
  if (q == 0) {
    for (int i = ln.l; i < NV; i += 32) {
      values[(size_t)p * NV + i] = cur[i];
      if (!last) vals[T * NV + i] = prev[i];   // the value at the right edge
    }
    __threadfence();
    grp::sync();
    if (ln.l == 0) lookback::publish(&status[p], lookback::kInclusive);
  }
  __syncthreads();

  // 3. V(k) = local suffix at k closed with the edge value (in the last
  // tile, the local suffix's own); then the gains.
  if (k <= N) {
    if (last) {
      take_value<P>(ln, buf + q * F, vals + q * NV);
    } else {
      grp::apply_value<P>(ln, nx, buf + q * F, vals + T * NV + SZ,
                          vals + T * NV, vals + q * NV + SZ, vals + q * NV,
                          w);
    }
  }
  __syncthreads();
  float dv1 = 0.0f, dv2 = 0.0f, bad = 0.0f;
  if (k < N) {
    gains_wide<P>(ln, nx, nu, ex, k, reg, vals + (q + 1) * NV + SZ,
                  vals + (q + 1) * NV, buf + q * F, other + q * F, w,
                  u_ff_out, K_out, dv1, dv2, bad);
  }

  // 4. dV and the finite flag in a fixed tree, as the register form sums
  // them (lane 0 of each warp holds its step's).
  float* red = sm + S::kBuf0;
  __syncthreads();   // every warp is done with its work space in buf
  block_sum3<kThreads>(red, tid, dv1, dv2, bad);
  if (tid == 0) {
    partials[(size_t)p * 3 + 0] = red[0];
    partials[(size_t)p * 3 + 1] = red[kThreads];
    partials[(size_t)p * 3 + 2] = red[2 * kThreads];
  }
  if (!lookback::arrive(counters, n_tiles, &slots)) return;
  __threadfence();
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int j = tid; j < n_tiles; j += kThreads) {
    s1 += __ldcg(partials + (size_t)j * 3 + 0);
    s2 += __ldcg(partials + (size_t)j * 3 + 1);
    s3 += __ldcg(partials + (size_t)j * 3 + 2);
  }
  block_sum3<kThreads>(red, tid, s1, s2, s3);
  if (tid == 0) {
    dV_out[0] = red[0];
    dV_out[1] = red[kThreads];
    ok_out[0] = red[2 * kThreads] == 0.0f;
  }
  lookback::reset(counters, n_tiles);
}

// The padded size of the wide form at n_x.
int wide_pad(int n_x) { return n_x <= 8 ? 8 : 16; }
int wide_tiles(int N) { return (N + 1 + kWideTile - 1) / kWideTile; }
template <int P>
constexpr int wide_scratch_floats(int n_tiles) {
  return n_tiles * (grp::Elem<P>::F + WideSmem<P>::NV + 3);
}

template <int P>
int run_wide(int nx, int nu, int N, float reg, const Expansion& ex,
             int* counters, float* scratch, float* u_ff, float* K, float* dV,
             unsigned char* ok, cudaStream_t stream) {
  using S = WideSmem<P>;
  const int n_tiles = wide_tiles(N);
  cudaError_t err = cudaFuncSetAttribute(
      wide_fused_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_fused_kernel<P><<<n_tiles, S::kThreads, S::kBytes, stream>>>(
      ex, nx, nu, N, reg, n_tiles, counters, scratch, u_ff, K, dV, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps per tile at (n_x, n_u): the register form's or the wide form's.
// The wide form's horizons are N < this (ops/fused_riccati.py's
// WIDE_MAX_N, which chip_smoke.py holds to it).
extern "C" int ilqr_riccati_wide_max_n() { return kWideMaxN; }

extern "C" int ilqr_riccati_tile_steps(int n_x, int n_u) {
  const bool registers =
      (n_x == 2 && n_u == 1) || (n_x == 4 && (n_u == 1 || n_u == 2));
  return registers ? kTileSteps : kWideTile;
}

// Sizes of the kernel's scratch at state size n_x and horizon N: ints
// (zeroed once, left zeroed by every call) and floats.  At n_x = 2 and 4
// both forms may run (by n_u), and the larger size serves both: a launch
// resets the counters of its own tiles only, the rest stay zero.
extern "C" int ilqr_fused_riccati_counters(int n_x, int N) {
  const int wide_n = lookback::counter_ints(wide_tiles(N));
  const int reg_n = lookback::counter_ints(tiles(N));
  return (n_x == 2 || n_x == 4) && reg_n > wide_n ? reg_n : wide_n;
}
extern "C" int ilqr_fused_riccati_scratch(int n_x, int N) {
  const int wide_f = wide_pad(n_x) == 8
                         ? wide_scratch_floats<8>(wide_tiles(N))
                         : wide_scratch_floats<16>(wide_tiles(N));
  if (n_x == 2) return scratch_floats<2>(tiles(N)) > wide_f ? scratch_floats<2>(tiles(N)) : wide_f;
  if (n_x == 4) return scratch_floats<4>(tiles(N)) > wide_f ? scratch_floats<4>(tiles(N)) : wide_f;
  return wide_f;
}

// One launch: the register form at (n_x, n_u) = (2, 1), (4, 1), (4, 2),
// the wide form at every other n_x <= 16, n_u <= 6 (N < 2^23 steps).
// defects: (N, n_x) or
// null; counters and scratch as sized above; outputs u_ff (N, n_u), K (N, n_u, n_x), dV (2,) = (sum dV1,
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
  if (n_x < 1 || n_x > 16 || n_u < 1 || n_u > 6 || N >= kWideMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide_pad(n_x) == 8)
    return run_wide<8>(n_x, n_u, N, reg, ex, counters, scratch, u_ff, K, dV,
                       ok, s);
  return run_wide<16>(n_x, n_u, N, reg, ex, counters, scratch, u_ff, K, dV,
                      ok, s);
}
