// Entry-parallel small-matrix math on one warp.
//
// Every wide form of the port works on matrices of up to 16 x 16 that fit
// no thread's registers: the fused backward pass (fused_riccati.cu, B1w),
// the affine prefix scan (affine_scan.cu, B3w), the batched backward pass
// (batched_riccati.cu, B4w) and the suffix scan (suffix_scan.cu, B6w and
// B7w).  Here a warp of 32 lanes owns one element, one instance or one
// product, and every matrix is P x P (P = 8 or 16, a compile-time
// constant) in shared memory, zero-padded past the run-time size n: exact
// zeros leave the sums of the real entries unchanged, so one instantiation
// per P serves every n <= P and every loop is unrolled to P.
//
// Layout: row-major with row stride LD = P + 4 floats (12 or 20, four times
// an odd number), so that the eight rows a warp reads down one column fall
// in eight distinct bank quads and a row's 16-byte pieces stay aligned.
//
// Products: lane l owns the entries (i_t, j_s) with i_t = l % 8 + 8 t
// (t < P / 8) and j_s = (P / 4) (l / 8) + s (s < P / 4): 2 entries a lane
// at P = 8, 8 at P = 16.  Each entry is a depth-P dot product, one fmaf
// chain in k order, fully unrolled; per k a lane reads its P / 8 entries of
// a's column (conflict-free by the stride) and its P / 4 contiguous entries
// of b's row in one vector load.  The result stays in registers (`Tile`),
// so a caller adds to it, keeps it across steps or stores it.  All math is
// f32 on the CUDA cores: the port pins f32 products to full precision, and
// TF32 tensor-core products would break the long Riccati recursions.
//
// Gauss-Jordan with partial pivoting on [M | I] (`inv`): lane c holds
// column c of [M | I] (P floats in registers).  At step k < n the lane
// holding column k shares it through shared memory, every row that has
// not pivoted offers |M[r][k]|, and the pivot row comes from a warp
// reduction (a max of the offers' bits, the lowest row on ties by a
// ballot) with the rules of a scan of the offers in row order: the first
// largest offer wins, rows that pivoted already do not offer, and a NaN
// offer still counts as a row (it wins when it is the first offer, as the
// scan's `v > best` never replaces a NaN).  Every other row then
// eliminates column k, each lane in its own column: the column to
// eliminate needs no broadcast that waits on the pivot, as a pivot row
// would.  Rows and columns past n keep their values, so the padded block
// of the inverse is I; a zero pivot makes the real block non-finite, which
// the callers' finite flags report.
//
// Every function here is called by the whole warp (tile_suffix_scan by
// the whole block).  Products, loads and stores touch only this lane's
// entries and leave the barrier to the caller (a __syncwarp between a store
// and other lanes' reads of it); inv, sym, copy, identity, apply_value and
// combine end with one.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ilqr {
namespace grp {

constexpr unsigned kWarp = 0xffffffffu;

template <int P>
struct Mat {
  static_assert(P == 8 || P == 16, "P is 8 or 16");
  static constexpr int LD = P + 4;      // row stride in floats
  static constexpr int SIZE = P * LD;   // one matrix
  static constexpr int R = P / 8;       // rows a lane owns in a product
  static constexpr int CC = P / 4;      // contiguous columns a lane owns
};

// An element of the Riccati scan (riccati_scan.cuh's Elem, padded): A, C,
// J, then b and eta; and a combine's work space: three matrices and two
// vectors.
template <int P>
struct Elem {
  static constexpr int S = Mat<P>::SIZE;
  static constexpr int A = 0;
  static constexpr int C = S;
  static constexpr int J = 2 * S;
  static constexpr int B = 3 * S;
  static constexpr int ETA = 3 * S + P;
  static constexpr int F = 3 * S + 2 * P;
  static constexpr int WORK = 3 * S + 2 * P;
};

// This lane's place in a product.
struct Lane {
  int l, rg, cg;
  __device__ __forceinline__ Lane()
      : l(threadIdx.x % 32), rg(threadIdx.x % 8), cg(threadIdx.x % 32 / 8) {}
};

template <int P>
struct Tile {
  float v[Mat<P>::R][Mat<P>::CC];
};

__device__ __forceinline__ void sync() { __syncwarp(kWarp); }

// The CC contiguous floats at p (16- or 8-byte aligned) in one access.
template <int CC>
__device__ __forceinline__ void ld_row(const float* p, float (&v)[CC]) {
  if constexpr (CC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

template <int CC>
__device__ __forceinline__ void st_row(float* p, const float (&v)[CC]) {
  if constexpr (CC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// c = op(a) op(b) at this lane's entries, op(x) = x' where the flag is set:
// c[i][j] = sum_k op(a)[i][k] op(b)[k][j], one fmaf chain in k order.
// Rows of c from ROWS on and terms from DEPTH on (multiples of 8) are left
// out where the caller knows them zero: a caller's rows past ROWS are not
// formed.  Reads only; no barrier.
template <int P, bool TA = false, bool TB = false, int ROWS = P,
          int DEPTH = P>
__device__ __forceinline__ void mm(const Lane& ln, const float* a,
                                   const float* b, Tile<P>& c) {
  using M = Mat<P>;
  constexpr int LD = M::LD;
  static_assert(ROWS % 8 == 0 && ROWS <= P && DEPTH <= P, "8-row blocks");
  const int j0 = M::CC * ln.cg;
#pragma unroll
  for (int t = 0; t < M::R; ++t)
#pragma unroll
    for (int s = 0; s < M::CC; ++s) c.v[t][s] = 0.0f;
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    float av[M::R], bv[M::CC];
#pragma unroll
    for (int t = 0; t < ROWS / 8; ++t) {
      const int i = ln.rg + 8 * t;
      av[t] = TA ? a[k * LD + i] : a[i * LD + k];
    }
    if (TB) {
#pragma unroll
      for (int s = 0; s < M::CC; ++s) bv[s] = b[(j0 + s) * LD + k];
    } else {
      ld_row<M::CC>(b + k * LD + j0, bv);
    }
#pragma unroll
    for (int t = 0; t < ROWS / 8; ++t)
#pragma unroll
      for (int s = 0; s < M::CC; ++s)
        c.v[t][s] = fmaf(av[t], bv[s], c.v[t][s]);
  }
}

// Row i, column j of an (rows x cols) row-major run at p, or 0 past it.
__device__ __forceinline__ float raw(const float* p, int i, int j, int rows,
                                     int cols) {
  return i < rows && j < cols ? p[i * cols + j] : 0.0f;
}

// c = this lane's entries of the (rows x cols) run at p (device or shared
// memory, any alignment), zero-padded to P x P.
template <int P>
__device__ __forceinline__ void load_raw(const Lane& ln, const float* p,
                                         int rows, int cols, Tile<P>& c) {
  using M = Mat<P>;
#pragma unroll
  for (int t = 0; t < M::R; ++t)
#pragma unroll
    for (int s = 0; s < M::CC; ++s)
      c.v[t][s] = raw(p, ln.rg + 8 * t, M::CC * ln.cg + s, rows, cols);
}

// This lane's entries of m, and of m'.
template <int P>
__device__ __forceinline__ void load(const Lane& ln, const float* m,
                                     Tile<P>& c) {
  using M = Mat<P>;
#pragma unroll
  for (int t = 0; t < M::R; ++t)
    ld_row<M::CC>(m + (ln.rg + 8 * t) * M::LD + M::CC * ln.cg, c.v[t]);
}

template <int P>
__device__ __forceinline__ void load_t(const Lane& ln, const float* m,
                                       Tile<P>& c) {
  using M = Mat<P>;
#pragma unroll
  for (int t = 0; t < M::R; ++t)
#pragma unroll
    for (int s = 0; s < M::CC; ++s)
      c.v[t][s] = m[(M::CC * ln.cg + s) * M::LD + ln.rg + 8 * t];
}

template <int P, int ROWS = P>
__device__ __forceinline__ void store(const Lane& ln, const Tile<P>& c,
                                      float* m) {
  using M = Mat<P>;
#pragma unroll
  for (int t = 0; t < ROWS / 8; ++t)
    st_row<M::CC>(m + (ln.rg + 8 * t) * M::LD + M::CC * ln.cg, c.v[t]);
}

// c += v on this lane's diagonal entries of rows and columns below n.
template <int P>
__device__ __forceinline__ void add_diag(const Lane& ln, int n, float v,
                                         Tile<P>& c) {
#pragma unroll
  for (int t = 0; t < Mat<P>::R; ++t)
#pragma unroll
    for (int s = 0; s < Mat<P>::CC; ++s) {
      const int i = ln.rg + 8 * t;
      if (i == Mat<P>::CC * ln.cg + s && i < n) c.v[t][s] += v;
    }
}

// c += d, entry by entry.
template <int P>
__device__ __forceinline__ void add(Tile<P>& c, const Tile<P>& d) {
#pragma unroll
  for (int t = 0; t < Mat<P>::R; ++t)
#pragma unroll
    for (int s = 0; s < Mat<P>::CC; ++s) c.v[t][s] += d.v[t][s];
}

// o = 0.5 (m + m'), exactly symmetric (both halves add the same two
// floats); o does not alias m.
template <int P>
__device__ __forceinline__ void sym(const Lane& ln, const float* m, float* o) {
  Tile<P> a, b;
  load<P>(ln, m, a);
  load_t<P>(ln, m, b);
#pragma unroll
  for (int t = 0; t < Mat<P>::R; ++t)
#pragma unroll
    for (int s = 0; s < Mat<P>::CC; ++s)
      a.v[t][s] = 0.5f * (a.v[t][s] + b.v[t][s]);
  store<P>(ln, a, o);
  sync();
}

// sum_k a[i][k] x[k] (row i) and sum_k a[k][i] x[k] (column i), one fmaf
// chain in k order.
template <int P>
__device__ __forceinline__ float dot_row(const float* a, int i,
                                         const float* x) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) s = fmaf(a[i * Mat<P>::LD + k], x[k], s);
  return s;
}

template <int P>
__device__ __forceinline__ float dot_col(const float* a, int i,
                                         const float* x) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) s = fmaf(a[k * Mat<P>::LD + i], x[k], s);
  return s;
}

// a[p] for a run-time p < P, by a tree of selects on p's bits.
template <int P>
__device__ __forceinline__ float pick(const float (&a)[P], int p) {
  float t[P];
#pragma unroll
  for (int i = 0; i < P; ++i) t[i] = a[i];
#pragma unroll
  for (int w = 1; w < P; w *= 2)
#pragma unroll
    for (int i = 0; i < P; i += 2 * w) t[i] = (p & w) ? t[i + w] : t[i];
  return t[0];
}

// The pivot row of a Gauss-Jordan step: lane r < P offers v = |M[r][k]|
// where `offers` holds; the same row in every lane.  The rules of a scan of
// the offers in row order: the first largest offer wins, and a NaN offer
// counts as a row and wins only as the first offer (the scan's `v > best`
// never replaces a NaN best and never takes a NaN over a number).  A warp
// max of the offers' bits (non-negative floats order as their bits), then
// a ballot for the lowest row that holds it.  At least one lane offers.
__device__ __forceinline__ int pivot_row(float v, bool offers) {
  const bool nan = isnan(v);
  const unsigned on = __ballot_sync(kWarp, offers);
  const unsigned on_nan = __ballot_sync(kWarp, offers && nan);
  const int first = __ffs(on) - 1;
  const unsigned key = offers && !nan ? __float_as_uint(v) + 1u : 0u;
  const unsigned best = __reduce_max_sync(kWarp, key);
  const int top = __ffs(__ballot_sync(kWarp, offers && key == best)) - 1;
  return (on_nan >> first) & 1u ? first : top;
}

// Mi = M^-1 by Gauss-Jordan with partial pivoting on the leading n x n
// block of M; Mi's rows and columns past n are the identity's.  Mi does
// not alias M.  Lane c < 2P holds column c of [M | I] in registers (at
// P = 8 lanes 16..31 repeat lanes 0..15).  Step k: lane k puts column k of
// M in shared memory (two rows of Mi, alternating, serve until Mi is
// written), lane r < P offers |M[r][k]| to `pivot_row`, and every lane
// eliminates with the pivot row p: col[r] -= M[r][k] (col[p] / M[p][k])
// for every other row r, M[r][k] read from the shared column and col[p]
// picked from its registers; the pivots' reciprocals are IEEE divisions
// (correctly rounded, as the plain version's f32 solve).  Padded columns and the padded rows' entries in
// column k hold exact zeros, so the updates leave the padding as it was.
template <int P>
__device__ __forceinline__ void inv(const Lane& ln, int n, const float* M,
                                    float* Mi) {
  constexpr int LD = Mat<P>::LD;
  const int l = ln.l, c = l % (2 * P);
  const bool left = c < P;
  const int cc = left ? c : c - P;
  float col[P];
#pragma unroll
  for (int r = 0; r < P; ++r)
    col[r] = left ? M[r * LD + cc] : (r == cc ? 1.0f : 0.0f);
  // Step k's pivot row and the reciprocal of its pivot go to row k's
  // padding (columns P and P + 1 of Mi, which no product reads).
  if (l < P) {
    Mi[l * LD + P] = static_cast<float>(l);
    Mi[l * LD + P + 1] = 1.0f;
  }
  unsigned pivoted = 0;   // rows that pivoted
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k >= n) break;
    float* ck_at = Mi + (k & 1) * LD;
    if (l == k) {
#pragma unroll
      for (int r = 0; r < P; r += 4) {
        float q[4] = {col[r], col[r + 1], col[r + 2], col[r + 3]};
        st_row<4>(ck_at + r, q);
      }
    }
    sync();
    float ck[P];
#pragma unroll
    for (int r = 0; r < P; r += 4) {
      float q[4];
      ld_row<4>(ck_at + r, q);
#pragma unroll
      for (int s = 0; s < 4; ++s) ck[r + s] = q[s];
    }
    const int p = pivot_row(fabsf(ck_at[l % P]),
                            l < n && !((pivoted >> l) & 1u));
    const float rcp = 1.0f / pick<P>(ck, p);
    const float g = rcp * pick<P>(col, p);
    // Rows past n hold M[r][k] = 0 and keep their values.
#pragma unroll
    for (int r = 0; r < P; ++r)
      if (r != p) col[r] = fmaf(-ck[r], g, col[r]);
    if (l == 0) {
      Mi[k * LD + P] = static_cast<float>(p);
      Mi[k * LD + P + 1] = rcp;
    }
    pivoted |= 1u << p;
  }
  sync();   // every lane has read the shared columns
  // Row k of the inverse is row p(k) of the right half over its pivot:
  // each lane permutes its own column through Mi.
  if (!left && l < 2 * P) {
    float at[P], s[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      at[k] = Mi[k * LD + P];
      s[k] = Mi[k * LD + P + 1];
    }
#pragma unroll
    for (int r = 0; r < P; ++r) Mi[r * LD + cc] = col[r];
#pragma unroll
    for (int k = 0; k < P; ++k)
      col[k] = Mi[static_cast<int>(at[k]) * LD + cc] * s[k];
#pragma unroll
    for (int k = 0; k < P; ++k) Mi[k * LD + cc] = col[k];
  }
  sync();
}

// dst = src, `count` floats (a multiple of 4, both 16-byte aligned).
__device__ __forceinline__ void copy(const Lane& ln, const float* src,
                                     float* dst, int count) {
  for (int i = 4 * ln.l; i < count; i += 128) {
    float q[4];
    ld_row<4>(src + i, q);
    st_row<4>(dst + i, q);
  }
  sync();
}

// The combine's identity: A = I (n x n), everything else 0.
template <int P>
__device__ __forceinline__ void identity(const Lane& ln, int n, float* e) {
  using E = Elem<P>;
  for (int i = ln.l; i < E::F; i += 32) e[i] = 0.0f;
  sync();
  if (ln.l < n) e[E::A + ln.l * (Mat<P>::LD + 1)] = 1.0f;
  sync();
}

// (eta, J) of e (x) (eta_j, J_j), the register form's apply_value
// (riccati_scan.cuh) and the first half of `combine` below, the same
// function with each entry formed by the same fmaf chains, so the two give
// the same bits:
//   L = I + C Jj,  T = L^-1 A,
//   eta = T' (eta_j - Jj b) + eta_e,  J = sym(T' (Jj A) + J_e),
// in four products and an inverse: C Jj and Z = Jj A, then L^-1, then T,
// then T' Z.  eta and J alias none of the inputs; J serves as work space
// until it is written; w is the warp's Elem<P>::WORK floats.
template <int P>
__device__ __forceinline__ void apply_value(const Lane& ln, int n,
                                            const float* e,
                                            const float* eta_j,
                                            const float* J_j, float* eta,
                                            float* J, float* w) {
  using E = Elem<P>;
  constexpr int S = E::S;
  float* W0 = w;
  float* W1 = w + S;
  float* W2 = w + 2 * S;
  float* v0 = w + 3 * S;   // eta_j - Jj b
  const int l = ln.l;
  Tile<P> c;

  // W0 = L = I + C Jj; J = Z = Jj A; v0 = eta_j - Jj b.
  mm<P>(ln, e + E::C, J_j, c);
  add_diag<P>(ln, P, 1.0f, c);
  store<P>(ln, c, W0);
  mm<P>(ln, J_j, e + E::A, c);
  store<P>(ln, c, J);
  if (l < P) v0[l] = eta_j[l] - dot_row<P>(J_j, l, e + E::B);
  sync();
  inv<P>(ln, n, W0, W1);                                   // W1 = L^-1
  mm<P>(ln, W1, e + E::A, c);                              // W2 = T
  store<P>(ln, c, W2);
  sync();
  // W0 = T' Z + J_e; eta.
  mm<P, true>(ln, W2, J, c);
  Tile<P> d;
  load<P>(ln, e + E::J, d);
  add<P>(c, d);
  store<P>(ln, c, W0);
  if (l < P) eta[l] = dot_col<P>(W2, l, v0) + e[E::ETA + l];
  sync();
  sym<P>(ln, W0, J);
}

// o = ei (x) ej: ei the earlier element, ej the later (the register form's
// combine in riccati_scan.cuh, the same function):
//   L = I + Ci Jj,  eta = Ai' L^-T (eta_j - Jj bi) + eta_i,
//   J = sym(Ai' L^-T Jj Ai + Ji),  A = Aj L^-1 Ai,
//   b = Aj L^-1 (bi + Ci eta_j) + bj,  C = sym(Aj L^-1 Ci Aj' + Cj),
// in eight products: Ci Jj and Z = Jj Ai, then L^-1, then X = Aj L^-1 and
// T = L^-1 Ai, then A = X Ai, T' Z (J's product), X Ci, and (X Ci) Aj'.
// The vectors: eta = T' (eta_j - Jj bi) + eta_i and b = X (Ci eta_j + bi)
// + bj, on lanes 0..P-1 (eta) and P..2P-1 (b) beside the products.  o
// aliases neither input (its J and C serve as work space until they are
// written); w is the warp's Elem<P>::WORK floats.
template <int P>
__device__ __forceinline__ void combine(const Lane& ln, int n,
                                        const float* ei, const float* ej,
                                        float* o, float* w) {
  using E = Elem<P>;
  constexpr int S = E::S;
  float* W0 = w;
  float* W1 = w + S;
  float* W2 = w + 2 * S;
  float* v0 = w + 3 * S;   // eta_j - Jj bi, then Ci eta_j + bi
  float* v2 = v0 + P;
  const int l = ln.l;
  const bool eta_lane = l < P, b_lane = l >= P && l < 2 * P;
  const int i = l % P;
  Tile<P> c, d;

  // W0 = L = I + Ci Jj; o.J = Z = Jj Ai; v0 = eta_j - Jj bi; v2 = Ci eta_j
  // + bi.
  mm<P>(ln, ei + E::C, ej + E::J, c);
  add_diag<P>(ln, P, 1.0f, c);
  store<P>(ln, c, W0);
  mm<P>(ln, ej + E::J, ei + E::A, d);
  store<P>(ln, d, o + E::J);
  if (eta_lane) v0[i] = ej[E::ETA + i] - dot_row<P>(ej + E::J, i, ei + E::B);
  if (b_lane) v2[i] = dot_row<P>(ei + E::C, i, ej + E::ETA) + ei[E::B + i];
  sync();
  inv<P>(ln, n, W0, W1);                                   // W1 = L^-1
  // W0 = X = Aj L^-1; W2 = T = L^-1 Ai.
  mm<P>(ln, ej + E::A, W1, c);
  store<P>(ln, c, W0);
  mm<P>(ln, W1, ei + E::A, c);
  store<P>(ln, c, W2);
  sync();
  // A = X Ai; W1 = T' Z + Ji; o.C = X Ci; eta and b.
  mm<P>(ln, W0, ei + E::A, c);
  store<P>(ln, c, o + E::A);
  mm<P, true>(ln, W2, o + E::J, c);
  load<P>(ln, ei + E::J, d);
  add<P>(c, d);
  store<P>(ln, c, W1);
  mm<P>(ln, W0, ei + E::C, c);
  store<P>(ln, c, o + E::C);
  if (eta_lane) o[E::ETA + i] = dot_col<P>(W2, i, v0) + ei[E::ETA + i];
  if (b_lane) o[E::B + i] = dot_row<P>(W0, i, v2) + ej[E::B + i];
  sync();
  // W2 = (X Ci) Aj' + Cj; J = sym(W1).
  mm<P, false, true>(ln, o + E::C, ej + E::A, c);
  load<P>(ln, ej + E::C, d);
  add<P>(c, d);
  store<P>(ln, c, W2);
  sym<P>(ln, W1, o + E::J);
  // C = sym(W2).
  sym<P>(ln, W2, o + E::C);
}

// Inclusive suffix scan of a tile's T elements, one a warp (warp q holds
// element k), between two buffers of T elements (F floats apart): the
// register form's Hillis-Steele (riccati_scan.cuh), out of place; a partner
// past `last` is the identity and is skipped.  Returns the buffer that
// holds the result.  Block-wide: every warp calls it.
template <int P, int T>
__device__ __forceinline__ float* tile_suffix_scan(const Lane& ln, int q,
                                                   int n, int k, int last,
                                                   float* src, float* dst,
                                                   float* w) {
  constexpr int F = Elem<P>::F;
  for (int d = 1; d < T; d <<= 1) {
    if (q + d < T && k + d <= last) {
      combine<P>(ln, n, src + q * F, src + (q + d) * F, dst + q * F, w);
    } else {
      copy(ln, src + q * F, dst + q * F, F);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

}  // namespace grp
}  // namespace ilqr
