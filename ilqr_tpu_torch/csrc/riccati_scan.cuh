// The Riccati scan core: the element layout and the associative combine.
//
// Shared by the fused backward pass (fused_riccati.cu, B1) and the
// standalone suffix scan (suffix_scan.cu, B6/B7), with the scan of a tile.  The math is that of
// ilqr_tpu_torch/ops/parallel_riccati.py: step k of the LQ subproblem is
// the element e = (A, b, C, eta, J), stored as F = 3 n_x^2 + 2 n_x floats
// in that order (A, C, J row-major), and the suffix products under the
// combine below carry the cost-to-go V = (J, -eta).
#pragma once

#include "smallmat.cuh"

namespace ilqr {

template <int NX>
struct Elem {
  static constexpr int NN = NX * NX;
  static constexpr int A = 0;
  static constexpr int B = NN;
  static constexpr int C = NN + NX;
  static constexpr int ETA = 2 * NN + NX;
  static constexpr int J = 2 * NN + 2 * NX;
  static constexpr int F = 3 * NN + 2 * NX;
};

// (eta, J) of e (x) e' where e' has value (eta_j, J_j):
//   eta = A' L^-T (eta_j - J_j b) + eta_e,  J = sym(A' L^-T J_j A + J_e),
//   L = I + C J_j.   `Li` returns L^-1 for callers that need the rest.
template <int NX>
__device__ __forceinline__ void apply_value(const float* e, const float* eta_j,
                                            const float* J_j, float* eta,
                                            float* J, float* Li) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  float L[NN];
  mm<NX, NX, NX>(e + E::C, J_j, L);
#pragma unroll
  for (int d = 0; d < NX; ++d) L[d * NX + d] += 1.0f;
  inv<NX>(L, Li);
  float v[NX], w[NX];
  mv<NX, NX>(J_j, e + E::B, v);
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = eta_j[i] - v[i];
  mtv<NX, NX>(Li, v, w);
  mtv<NX, NX>(e + E::A, w, eta);
#pragma unroll
  for (int i = 0; i < NX; ++i) eta[i] += e[E::ETA + i];
  float T[NN], T2[NN];
  mtm<NX, NX, NX>(Li, J_j, T);
  mm<NX, NX, NX>(T, e + E::A, T2);
  mtm<NX, NX, NX>(e + E::A, T2, T);
#pragma unroll
  for (int i = 0; i < NN; ++i) T[i] += e[E::J + i];
  sym<NX>(T, J);
}

// o = ei (x) ej: ei the earlier element, ej the later.  o must not alias.
template <int NX>
__device__ __forceinline__ void combine(const float* ei, const float* ej,
                                        float* o) {
  using E = Elem<NX>;
  constexpr int NN = E::NN;
  const float* Aj = ej + E::A;
  float Li[NN];
  apply_value<NX>(ei, ej + E::ETA, ej + E::J, o + E::ETA, o + E::J, Li);
  float T[NN], T2[NN];
  // A = Aj L^-1 Ai
  mm<NX, NX, NX>(Li, ei + E::A, T);
  mm<NX, NX, NX>(Aj, T, o + E::A);
  // b = Aj L^-1 (bi + Ci eta_j) + bj
  float v[NX], w[NX];
  mv<NX, NX>(ei + E::C, ej + E::ETA, v);
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] += ei[E::B + i];
  mv<NX, NX>(Li, v, w);
  mv<NX, NX>(Aj, w, o + E::B);
#pragma unroll
  for (int i = 0; i < NX; ++i) o[E::B + i] += ej[E::B + i];
  // C = sym(Aj L^-1 Ci Aj' + Cj)
  mm<NX, NX, NX>(Li, ei + E::C, T);
  mm<NX, NX, NX>(Aj, T, T2);
  mmt<NX, NX, NX>(T2, Aj, T);
#pragma unroll
  for (int i = 0; i < NN; ++i) T[i] += ej[E::C + i];
  sym<NX>(T, o + E::C);
}

// The combine's identity: A = I, everything else 0.
template <int NX>
__device__ __forceinline__ void identity(float* e) {
  using E = Elem<NX>;
#pragma unroll
  for (int i = 0; i < E::F; ++i) e[i] = 0.0f;
#pragma unroll
  for (int d = 0; d < NX; ++d) e[E::A + d * NX + d] = 1.0f;
}

// Inclusive suffix scan of the T elements of a tile, one a thread (thread
// tid holds element k), in place in e; `smem` holds F x T floats, field-
// major (conflict-free).  Hillis-Steele: at distance d each element joins
// the adjacent window that starts d later, so windows never overlap (the
// combine is neither commutative nor idempotent); a partner past the last
// element, k + d > last, is the identity and is skipped.  log2(T)
// dependent combines, two barriers each.
template <int NX, int T>
__device__ __forceinline__ void tile_suffix_scan(float* e, float* smem,
                                                 int tid, int k, int last) {
  using E = Elem<NX>;
  for (int d = 1; d < T; d <<= 1) {
#pragma unroll
    for (int f = 0; f < E::F; ++f) smem[f * T + tid] = e[f];
    __syncthreads();
    if (tid + d < T && k + d <= last) {
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

}  // namespace ilqr

// ---- The wide form: one element per lane group -------------------------
//
// The fused backward pass's wide form (B1w) and the affine scan's (B3w);
// the suffix scan (B6w, B7w) and the batched backward pass (B4w) run the
// entry-parallel math of group_linalg.cuh instead.  For 5 <= n_x <= 16
// (and every shape the register form above does not take) an element no
// longer fits one thread's registers: F = 3 n^2 + 2 n
// is 456 floats at n = 12 and 800 at n = 16.  Here an element belongs to a
// group of P lanes of one warp (P = 8 or 16), lane r owning row r, and
// every matrix lives in shared memory, row-major with stride P + 1 so that
// a lane's row and a column read across the group fall in distinct banks.
// The state size n <= P is a run-time bound: the group's loops run to n and
// lanes r >= n idle in row operations, so one instantiation serves every
// n <= P with no padding of the data.  Each collective below is called by
// all P lanes of the group together and ends with the group's barrier
// (__syncwarp over its mask), so its results are visible to the group.
// The combine's inverse of L = I + C J (nonsingular for C, J positive
// semidefinite, but its leading pivots may vanish: C = [[1, -2], [-2, 4]],
// J = ones gives L_00 = 0) is Gauss-Jordan with partial pivoting; the gain
// solves' Q_uu + reg I and the elements' l_uu + reg I use the same routine.
namespace wide {

template <int P>
struct Layout {
  static constexpr int LD = P + 1;          // row stride in shared memory
  static constexpr int M = P * LD;          // one P x P matrix
  static constexpr int A = 0;
  static constexpr int C = M;
  static constexpr int J = 2 * M;
  static constexpr int B = 3 * M;
  static constexpr int ETA = 3 * M + P;
  static constexpr int F = 3 * M + 2 * P;   // an element
  static constexpr int NV = P + M;          // a value function (eta, J)
  // A group's work space: five matrices, two vectors and the pivot search.
  static constexpr int W = 5 * M + 3 * P;
};

// This lane's row and its group's lanes.
template <int P>
struct Group {
  int r;
  unsigned mask;
  __device__ __forceinline__ Group()
      : r(threadIdx.x % P),
        mask((P == 32 ? 0xffffffffu : (1u << P) - 1u)
             << (threadIdx.x % 32 / P * P)) {}
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// A group's work space, carved from its W floats.
template <int P>
struct Work {
  float *m0, *m1, *m2, *m3, *m4, *v0, *v1, *red;
  __device__ __forceinline__ explicit Work(float* w) {
    using L = Layout<P>;
    m0 = w;
    m1 = w + L::M;
    m2 = w + 2 * L::M;
    m3 = w + 3 * L::M;
    m4 = w + 4 * L::M;
    v0 = w + 5 * L::M;
    v1 = v0 + P;
    red = v1 + P;
  }
};

// c (n x p) = a (n x m) b (m x p).  c aliases neither.
template <int P>
__device__ __forceinline__ void mm(const Group<P>& g, int n, int m, int p,
                                   const float* a, const float* b, float* c) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    for (int j = 0; j < p; ++j) {
      float s = 0.0f;
      for (int k = 0; k < m; ++k) s += a[g.r * LD + k] * b[k * LD + j];
      c[g.r * LD + j] = s;
    }
  }
  g.sync();
}

// c (n x p) = a' b, a (m x n), b (m x p).
template <int P>
__device__ __forceinline__ void mtm(const Group<P>& g, int n, int m, int p,
                                    const float* a, const float* b, float* c) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    for (int j = 0; j < p; ++j) {
      float s = 0.0f;
      for (int k = 0; k < m; ++k) s += a[k * LD + g.r] * b[k * LD + j];
      c[g.r * LD + j] = s;
    }
  }
  g.sync();
}

// c (n x p) = a b', a (n x m), b (p x m).
template <int P>
__device__ __forceinline__ void mmt(const Group<P>& g, int n, int m, int p,
                                    const float* a, const float* b, float* c) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    for (int j = 0; j < p; ++j) {
      float s = 0.0f;
      for (int k = 0; k < m; ++k) s += a[g.r * LD + k] * b[j * LD + k];
      c[g.r * LD + j] = s;
    }
  }
  g.sync();
}

// y (n) = a (n x m) x.
template <int P>
__device__ __forceinline__ void mv(const Group<P>& g, int n, int m,
                                   const float* a, const float* x, float* y) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s += a[g.r * LD + k] * x[k];
    y[g.r] = s;
  }
  g.sync();
}

// y (n) = a' x, a (m x n).
template <int P>
__device__ __forceinline__ void mtv(const Group<P>& g, int n, int m,
                                    const float* a, const float* x, float* y) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s += a[k * LD + g.r] * x[k];
    y[g.r] = s;
  }
  g.sync();
}

// o (n x n) = 0.5 (m + m'), o not m.
template <int P>
__device__ __forceinline__ void sym(const Group<P>& g, int n, const float* m,
                                    float* o) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    for (int j = 0; j < n; ++j)
      o[g.r * LD + j] = 0.5f * (m[g.r * LD + j] + m[j * LD + g.r]);
  }
  g.sync();
}

// Mi = M^-1 (n x n) by Gauss-Jordan with partial pivoting; M is
// overwritten, `red` holds P floats.  At step k each lane offers |M[r][k]|
// of its row unless that row pivoted already; every lane scans the offers
// in the same order (the first largest wins), so all agree on the pivot
// row p, and every other row eliminates column k with row p, which its
// lane leaves alone in that step.  At the end row p(k) of M holds its
// pivot alone, and row k of the inverse is row p(k) of Mi over it.
template <int P>
__device__ __forceinline__ void inv(const Group<P>& g, int n, float* M,
                                    float* Mi, float* red) {
  constexpr int LD = P + 1;
  if (g.r < n) {
    for (int j = 0; j < n; ++j) Mi[g.r * LD + j] = g.r == j ? 1.0f : 0.0f;
  }
  int done = -1;   // the column this lane's row pivoted
  for (int k = 0; k < n; ++k) {
    red[g.r] = g.r < n && done < 0 ? fabsf(M[g.r * LD + k]) : -1.0f;
    g.sync();
    // Rows that pivoted offer -1; a NaN offer still counts as a row, so
    // every step takes a row that has not pivoted.
    int p = -1;
    float best = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float v = red[i];
      if (!(v < 0.0f) && (p < 0 || v > best)) {
        best = v;
        p = i;
      }
    }
    if (g.r < n && g.r != p) {
      const float f = M[g.r * LD + k] / M[p * LD + k];
      for (int j = 0; j < n; ++j) {
        M[g.r * LD + j] -= f * M[p * LD + j];
        Mi[g.r * LD + j] -= f * Mi[p * LD + j];
      }
    }
    if (g.r == p) done = k;
    g.sync();
  }
  float row[P];
  const float s = g.r < n ? 1.0f / M[g.r * LD + done] : 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j)
    row[j] = g.r < n && j < n ? Mi[g.r * LD + j] * s : 0.0f;
  g.sync();
  if (g.r < n) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < n) Mi[done * LD + j] = row[j];
  }
  g.sync();
}

// dst = src, one element (all F floats, padding included).
template <int P>
__device__ __forceinline__ void copy(const Group<P>& g, const float* src,
                                     float* dst, int count) {
  for (int i = g.r; i < count; i += P) dst[i] = src[i];
  g.sync();
}

// The combine's identity: A = I, everything else 0.
template <int P>
__device__ __forceinline__ void identity(const Group<P>& g, int n, float* e) {
  using L = Layout<P>;
  if (g.r < n) {
    for (int j = 0; j < n; ++j) {
      e[L::A + g.r * L::LD + j] = g.r == j ? 1.0f : 0.0f;
      e[L::C + g.r * L::LD + j] = 0.0f;
      e[L::J + g.r * L::LD + j] = 0.0f;
    }
    e[L::B + g.r] = 0.0f;
    e[L::ETA + g.r] = 0.0f;
  }
  g.sync();
}

// (eta, J) of e (x) (eta_j, J_j), the register form's apply_value; L^-1 is
// left in w.m1.  eta, J alias none of the inputs.
template <int P>
__device__ __forceinline__ void apply_value(const Group<P>& g, int n,
                                            const float* e,
                                            const float* eta_j,
                                            const float* J_j, float* eta,
                                            float* J, const Work<P>& w) {
  using L = Layout<P>;
  mm<P>(g, n, n, n, e + L::C, J_j, w.m0);
  if (g.r < n) w.m0[g.r * L::LD + g.r] += 1.0f;
  g.sync();
  inv<P>(g, n, w.m0, w.m1, w.red);
  mv<P>(g, n, n, J_j, e + L::B, w.v0);
  if (g.r < n) w.v0[g.r] = eta_j[g.r] - w.v0[g.r];
  g.sync();
  mtv<P>(g, n, n, w.m1, w.v0, w.v1);
  mtv<P>(g, n, n, e + L::A, w.v1, eta);
  if (g.r < n) eta[g.r] += e[L::ETA + g.r];
  g.sync();
  mtm<P>(g, n, n, n, w.m1, J_j, w.m2);
  mm<P>(g, n, n, n, w.m2, e + L::A, w.m3);
  mtm<P>(g, n, n, n, e + L::A, w.m3, w.m2);
  if (g.r < n) {
    for (int j = 0; j < n; ++j) w.m2[g.r * L::LD + j] += e[L::J + g.r * L::LD + j];
  }
  g.sync();
  sym<P>(g, n, w.m2, J);
}

// o = ei (x) ej: ei the earlier element, ej the later; o aliases neither.
template <int P>
__device__ __forceinline__ void combine(const Group<P>& g, int n,
                                        const float* ei, const float* ej,
                                        float* o, const Work<P>& w) {
  using L = Layout<P>;
  const float* Aj = ej + L::A;
  apply_value<P>(g, n, ei, ej + L::ETA, ej + L::J, o + L::ETA, o + L::J, w);
  // A = Aj L^-1 Ai
  mm<P>(g, n, n, n, w.m1, ei + L::A, w.m2);
  mm<P>(g, n, n, n, Aj, w.m2, o + L::A);
  // b = Aj L^-1 (bi + Ci eta_j) + bj
  mv<P>(g, n, n, ei + L::C, ej + L::ETA, w.v0);
  if (g.r < n) w.v0[g.r] += ei[L::B + g.r];
  g.sync();
  mv<P>(g, n, n, w.m1, w.v0, w.v1);
  mv<P>(g, n, n, Aj, w.v1, o + L::B);
  if (g.r < n) o[L::B + g.r] += ej[L::B + g.r];
  g.sync();
  // C = sym(Aj L^-1 Ci Aj' + Cj)
  mm<P>(g, n, n, n, w.m1, ei + L::C, w.m2);
  mm<P>(g, n, n, n, Aj, w.m2, w.m3);
  mmt<P>(g, n, n, n, w.m3, Aj, w.m2);
  if (g.r < n) {
    for (int j = 0; j < n; ++j) w.m2[g.r * L::LD + j] += ej[L::C + g.r * L::LD + j];
  }
  g.sync();
  sym<P>(g, n, w.m2, o + L::C);
}

// Inclusive suffix scan of a tile's T elements, one a group (group q holds
// element k), between the two buffers of T elements each (F floats apart):
// the register form's Hillis-Steele, out of place.  A partner past `last`
// is the identity and is skipped.  Returns the buffer that holds the
// result.  Block-wide: every group calls it.
template <int P, int T>
__device__ __forceinline__ float* tile_suffix_scan(const Group<P>& g, int q,
                                                   int n, int k, int last,
                                                   float* src, float* dst,
                                                   const Work<P>& w) {
  constexpr int F = Layout<P>::F;
  for (int d = 1; d < T; d <<= 1) {
    if (q + d < T && k + d <= last) {
      combine<P>(g, n, src + q * F, src + (q + d) * F, dst + q * F, w);
    } else {
      copy<P>(g, src + q * F, dst + q * F, F);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

}  // namespace wide
