"""The entry-parallel small-matrix math of `csrc/group_linalg.cuh` without a
GPU.

The header is compiled with g++ against `test_torch_lookback.MOCK_RUNTIME`
(a warp of pthreads, shuffles and ballots through a per-warp buffer) into a
small harness of one-warp kernels: the pivot choice of a Gauss-Jordan
step, the inverse, the products, the symmetrisation and `apply_value`
(the value of an element applied to a later value, B1w's look-back and
closure), each at padded P = 8 and 16 with the real size n below P.  The pivot rule is held to a
scan of the offers in row order (the rule of the lane-per-row form the
header replaced: the first largest offer wins, pivoted rows do not offer,
a NaN offer counts as a row) in every lane; the inverse and the products to numpy in
f64, with their padding exact, and `apply_value` to the (eta, J) of the
header's `combine` bit for bit.  The tests skip where no g++ is found;
the card runs the header in B1w, B3w, B4w and B6w (chip_smoke.py).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from ilqr_tpu_torch.ops import _build
from test_torch_lookback import MOCK_RUNTIME, _rewrite

HARNESS = r"""
#include <cuda_runtime.h>
#include "group_linalg.cuh"

using namespace ilqr;

namespace {

__global__ void pivot_kernel(const float* offers, const int* offering,
                             int* out) {
  const int l = threadIdx.x;
  out[l] = grp::pivot_row(offers[l], offering[l] != 0);
}

// Dense (P, P) row-major in and out; the padded layout in shared memory.
template <int P>
__device__ void to_smem(const float* m, float* s) {
  for (int i = threadIdx.x; i < P * P; i += 32)
    s[i / P * grp::Mat<P>::LD + i % P] = m[i];
  grp::sync();
}

template <int P>
__device__ void from_smem(const float* s, float* m) {
  for (int i = threadIdx.x; i < P * P; i += 32)
    m[i] = s[i / P * grp::Mat<P>::LD + i % P];
}

template <int P>
__global__ void inv_kernel(int n, const float* m, float* mi) {
  extern __shared__ __align__(16) float sm[];
  const grp::Lane ln;
  to_smem<P>(m, sm);
  grp::inv<P>(ln, n, sm, sm + grp::Mat<P>::SIZE);
  from_smem<P>(sm + grp::Mat<P>::SIZE, mi);
}

// c = op(a) op(b) for op = 0: a b, 1: a' b, 2: a b'; 3: c = sym(a).
template <int P>
__global__ void mm_kernel(int op, const float* a, const float* b, float* c) {
  extern __shared__ __align__(16) float sm[];
  constexpr int S = grp::Mat<P>::SIZE;
  const grp::Lane ln;
  to_smem<P>(a, sm);
  to_smem<P>(b, sm + S);
  grp::Tile<P> t;
  if (op == 0) grp::mm<P>(ln, sm, sm + S, t);
  if (op == 1) grp::mm<P, true>(ln, sm, sm + S, t);
  if (op == 2) grp::mm<P, false, true>(ln, sm, sm + S, t);
  if (op == 3) {
    grp::sym<P>(ln, sm, sm + 2 * S);
  } else {
    grp::store<P>(ln, t, sm + 2 * S);
  }
  grp::sync();
  from_smem<P>(sm + 2 * S, c);
}

// Element (A, b, C, eta, J) of dense (P, P) and (P,) fields at f (in that
// order, 3 P^2 + 2 P floats) into e, padded.
template <int P>
__device__ void elem_to_smem(const float* f, float* e) {
  using E = grp::Elem<P>;
  to_smem<P>(f, e + E::A);
  to_smem<P>(f + P * P + P, e + E::C);
  to_smem<P>(f + 2 * P * P + 2 * P, e + E::J);
  for (int i = threadIdx.x; i < P; i += 32) {
    e[E::B + i] = f[P * P + i];
    e[E::ETA + i] = f[2 * P * P + P + i];
  }
  grp::sync();
}

// (eta, J) of ei (x) (eta_j, J_j) by apply_value, and of ei (x) ej by
// combine: out = [eta (P), J (P, P)] of each, in that order.
template <int P>
__global__ void apply_kernel(int n, const float* ei, const float* ej,
                             float* out) {
  extern __shared__ __align__(16) float sm[];
  using E = grp::Elem<P>;
  const grp::Lane ln;
  float* a = sm;
  float* b = a + E::F;
  float* o = b + E::F;
  float* v = o + E::F;   // eta, then J
  float* w = v + E::F;
  elem_to_smem<P>(ei, a);
  elem_to_smem<P>(ej, b);
  grp::apply_value<P>(ln, n, a, b + E::ETA, b + E::J, v, v + P, w);
  grp::combine<P>(ln, n, a, b, o, w);
  for (int i = threadIdx.x; i < P; i += 32) {
    out[i] = v[i];
    out[P + P * P + i] = o[E::ETA + i];
  }
  from_smem<P>(v + P, out + P);
  from_smem<P>(o + E::J, out + 2 * P + P * P);
}

constexpr int kSmem = 4 * 3 * grp::Mat<16>::SIZE;
constexpr int kApplySmem = 4 * 5 * grp::Elem<16>::F;

}  // namespace

extern "C" int grp_pivot(const float* offers, const int* offering, int* out) {
  pivot_kernel<<<1, 32, 0, nullptr>>>(offers, offering, out);
  return 0;
}

extern "C" int grp_inv(int P, int n, const float* m, float* mi) {
  if (P == 8) {
    inv_kernel<8><<<1, 32, kSmem, nullptr>>>(n, m, mi);
  } else {
    inv_kernel<16><<<1, 32, kSmem, nullptr>>>(n, m, mi);
  }
  return 0;
}

extern "C" int grp_apply(int P, int n, const float* ei, const float* ej,
                         float* out) {
  if (P == 8) {
    apply_kernel<8><<<1, 32, kApplySmem, nullptr>>>(n, ei, ej, out);
  } else {
    apply_kernel<16><<<1, 32, kApplySmem, nullptr>>>(n, ei, ej, out);
  }
  return 0;
}

extern "C" int grp_mm(int P, int op, const float* a, const float* b,
                      float* c) {
  if (P == 8) {
    mm_kernel<8><<<1, 32, kSmem, nullptr>>>(op, a, b, c);
  } else {
    mm_kernel<16><<<1, 32, kSmem, nullptr>>>(op, a, b, c);
  }
  return 0;
}
"""

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@pytest.fixture(scope="module")
def grp_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host mock of the CUDA runtime")
    d = tmp_path_factory.mktemp("group_linalg_host")
    shutil.copy(_build.CSRC_DIR / "group_linalg.cuh", d / "group_linalg.cuh")
    (d / "cuda_runtime.h").write_text(MOCK_RUNTIME)
    (d / "harness.cpp").write_text(_rewrite(HARNESS))
    so = d / "libgrp_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(d), str(d / "harness.cpp"), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.grp_pivot.argtypes = [_FP, _IP, _IP]
    lib.grp_inv.argtypes = [ctypes.c_int, ctypes.c_int, _FP, _FP]
    lib.grp_mm.argtypes = [ctypes.c_int, ctypes.c_int, _FP, _FP, _FP]
    lib.grp_apply.argtypes = [ctypes.c_int, ctypes.c_int, _FP, _FP, _FP]
    return lib


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a, kind=_FP):
    return a.ctypes.data_as(kind)


def _scan_pivot(offers, offering):
    """The pivot of a scan of the offers in row order (the lane-per-row
    form's rule): a row that offers and whose offer beats the best so far
    (or is the first) becomes the pivot; a NaN best is never beaten."""
    p, best = -1, 0.0
    for i, (v, on) in enumerate(zip(offers, offering)):
        if on and (p < 0 or v > best):
            p, best = i, v
    return p


NAN = float("nan")


# Offers of lanes 0..15 (the rest offer nothing) and which of them offer.
@pytest.mark.parametrize("offers,offering", [
    ([0.5, 2.0, 2.0, 1.0], [1, 1, 1, 1]),          # equal offers: row 1
    ([3.0, 3.0, 3.0, 3.0], [0, 1, 1, 1]),          # pivoted row 0 skipped
    ([0.0, 0.0, 0.0], [1, 1, 1]),                  # all zero: the first
    ([NAN, 5.0, 7.0], [1, 1, 1]),                  # a NaN first offer wins
    ([1.0, NAN, 7.0, 7.0], [1, 1, 1, 1]),          # a later NaN is passed
    ([2.0, NAN, 0.5], [0, 1, 1]),                  # first offering is NaN
    ([np.inf, 1e30, np.inf], [1, 1, 1]),           # +inf ties: the first
    ([0.0] * 15 + [1e-38], [1] * 16),              # a denormal-scale max
    ([4.0, 9.0, 1.0, 9.0, 9.0, 2.0, 0.0, 3.0], [1, 0, 1, 1, 1, 1, 1, 1]),
])
def test_pivot_follows_the_row_order_scan(grp_lib, offers, offering):
    v = np.zeros(32, np.float32)
    on = np.zeros(32, np.int32)
    v[:len(offers)] = offers
    on[:len(offering)] = offering
    out = np.full(32, -7, np.int32)
    grp_lib.grp_pivot(_ptr(v), _ptr(on, _IP), _ptr(out, _IP))
    want = _scan_pivot(v[:16], on[:16])
    assert out.tolist() == [want] * 32


def _inv(grp_lib, P, n, m):
    full = np.zeros((P, P), np.float32)
    full[:n, :n] = m
    full[n:, n:] = 7.0       # the padded block is never read
    out = np.full((P, P), -1.0, np.float32)
    grp_lib.grp_inv(P, n, _ptr(_f32(full)), _ptr(out))
    return out


@pytest.mark.parametrize("P,n", [(8, 1), (8, 5), (8, 8), (16, 3), (16, 12),
                                 (16, 16)])
def test_inverse_at_padded_sizes(grp_lib, P, n):
    """Random nonsingular matrices: the inverse within 1e-5 of numpy's
    (relative to its max), the rows and columns past n exactly the
    identity's."""
    rng = np.random.default_rng(10 * P + n)
    m = rng.standard_normal((n, n)) + 2.0 * np.eye(n)
    got = _inv(grp_lib, P, n, m)
    ref = np.linalg.inv(_f32(m).astype(np.float64))
    err = np.abs(got[:n, :n] - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() * max(1.0, np.linalg.cond(m) / 10)
    pad = np.eye(P, dtype=np.float32)
    pad[:n, :n] = got[:n, :n]
    assert np.array_equal(got, pad)


@pytest.mark.parametrize("P,n", [(8, 6), (16, 12)])
def test_inverse_pivots_a_zero_leading_entry(grp_lib, P, n):
    """A permuted identity (zero leading entry) inverts exactly, and so
    does L = I + C J with C = [[1, -2], [-2, 4]], J = ones in the leading
    block (L_00 = 0)."""
    perm = np.eye(n)[::-1]
    got = _inv(grp_lib, P, n, perm)
    assert np.array_equal(got[:n, :n], perm.T.astype(np.float32))
    C = np.zeros((n, n))
    J = np.zeros((n, n))
    C[:2, :2] = [[1.0, -2.0], [-2.0, 4.0]]
    J[:2, :2] = 1.0
    L = np.eye(n) + C @ J
    assert L[0, 0] == 0.0
    got = _inv(grp_lib, P, n, L)
    assert np.allclose(got[:n, :n], np.linalg.inv(L), rtol=0, atol=1e-6)


@pytest.mark.parametrize("P,n", [(8, 2), (16, 4)])
def test_inverse_of_a_singular_or_nan_matrix_is_not_finite(grp_lib, P, n):
    """A zero pivot (a singular matrix) or a NaN offer leaves the real block
    non-finite, where the callers' finite flags see it."""
    for m in (np.zeros((n, n)), np.ones((n, n))):
        got = _inv(grp_lib, P, n, m)
        assert not np.isfinite(got[:n, :n]).all()
    m = np.eye(n)
    m[0, 0] = NAN
    got = _inv(grp_lib, P, n, m)
    assert np.isnan(got[0, 0])


@pytest.mark.parametrize("P,n", [(8, 5), (8, 8), (16, 12), (16, 16)])
@pytest.mark.parametrize("op", [0, 1, 2, 3])
def test_products_and_sym_at_padded_sizes(grp_lib, P, n, op):
    """a b, a' b, a b' and sym(a) of zero-padded operands: the real block
    within 1e-6 of numpy's f64 products (relative), the padding exactly
    zero, sym exactly symmetric."""
    rng = np.random.default_rng(100 * P + 10 * op + n)
    a = np.zeros((P, P), np.float32)
    b = np.zeros((P, P), np.float32)
    a[:n, :n] = rng.standard_normal((n, n))
    b[:n, :n] = rng.standard_normal((n, n))
    out = np.full((P, P), -1.0, np.float32)
    grp_lib.grp_mm(P, op, _ptr(a), _ptr(b), _ptr(out))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ref = [a64 @ b64, a64.T @ b64, a64 @ b64.T, 0.5 * (a64 + a64.T)][op]
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    assert not out[n:, :].any() and not out[:, n:].any()
    if op == 3:
        assert np.array_equal(out, out.T)


def _element(rng, P, n, pivot=False):
    """A random element at n zero-padded to P: A, b, eta Gaussian, C and J
    positive semidefinite; with ``pivot`` C's and J's leading blocks make
    L = I + C J_later have L_00 = 0 (C = [[1, -2], [-2, 4]], J = ones)."""
    f = {}
    for k in "AbCeJ":
        f[k] = np.zeros((P, P) if k in "ACJ" else P)
    f["A"][:n, :n] = np.eye(n) + 0.3 * rng.standard_normal((n, n))
    f["b"][:n] = rng.standard_normal(n)
    f["e"][:n] = rng.standard_normal(n)
    for k in "CJ":
        G = 0.5 * rng.standard_normal((n, n))
        f[k][:n, :n] = G @ G.T
    if pivot:
        f["C"][:n, :n] = 0.0
        f["C"][:2, :2] = [[1.0, -2.0], [-2.0, 4.0]]
        f["J"][:n, :n] = 0.0
        f["J"][:2, :2] = 1.0
    f = {k: _f32(v) for k, v in f.items()}
    flat = np.concatenate([f["A"].ravel(), f["b"], f["C"].ravel(), f["e"],
                           f["J"].ravel()])
    return f, _f32(flat)


@pytest.mark.parametrize("P,n,pivot", [(8, 5, False), (8, 7, True),
                                       (16, 12, False), (16, 3, False),
                                       (16, 12, True)])
def test_apply_value_at_padded_sizes(grp_lib, P, n, pivot):
    """apply_value's (eta, J) of e (x) (eta_j, J_j) within 1e-5 of numpy's
    f64 formula (relative to each output's max), the padding exactly zero,
    J exactly symmetric, and the same bits as the (eta, J) of combine(e,
    e_j) (the same function, entry by entry the same fmaf chains); also
    where L = I + C J_j has a zero leading pivot."""
    rng = np.random.default_rng(1000 * P + 10 * n + pivot)
    ei, fi = _element(rng, P, n)
    ej, fj = _element(rng, P, n)
    if pivot:
        ei, fi = _element(rng, P, n, pivot=True)
        ej["J"][:n, :n] = 0.0
        ej["J"][:2, :2] = 1.0
        fj = _f32(np.concatenate([ej["A"].ravel(), ej["b"],
                                  ej["C"].ravel(), ej["e"],
                                  ej["J"].ravel()]))
    out = np.full(2 * (P + P * P), -1.0, np.float32)
    grp_lib.grp_apply(P, n, _ptr(fi), _ptr(fj), _ptr(out))
    eta, J = out[:P], out[P:P + P * P].reshape(P, P)
    eta_c = out[P + P * P:2 * P + P * P]
    J_c = out[2 * P + P * P:].reshape(P, P)
    assert np.array_equal(eta, eta_c) and np.array_equal(J, J_c)
    d = {k: v.astype(np.float64)[:n, :n] if v.ndim == 2
         else v.astype(np.float64)[:n] for k, v in ei.items()}
    Jj = ej["J"].astype(np.float64)[:n, :n]
    eta_j = ej["e"].astype(np.float64)[:n]
    Li = np.linalg.inv(np.eye(n) + d["C"] @ Jj)
    T = Li @ d["A"]
    eta_ref = T.T @ (eta_j - Jj @ d["b"]) + d["e"]
    J_ref = T.T @ Jj @ d["A"] + d["J"]
    J_ref = 0.5 * (J_ref + J_ref.T)
    assert np.abs(eta[:n] - eta_ref).max() <= 1e-5 * np.abs(eta_ref).max()
    assert np.abs(J[:n, :n] - J_ref).max() <= 1e-5 * np.abs(J_ref).max()
    assert not eta[n:].any()
    assert not J[n:, :].any() and not J[:, n:].any()
    assert np.array_equal(J, J.T)
