// The Riccati scan core: the element layout and the associative combine.
//
// Shared by the register forms (an element a thread, n_x in {2, 4}) of the
// fused backward pass (fused_riccati.cu, B1) and the standalone suffix scan
// (suffix_scan.cu, B6/B7), with the scan of a tile; their wide forms run
// the same math on group_linalg.cuh.  The math is that of
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
