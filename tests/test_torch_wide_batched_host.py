"""The wide forms of the batched backward pass (B4w) and of the affine
prefix scan (B3w) without a GPU.

`csrc/batched_riccati.cu` and `csrc/affine_scan.cu` are compiled with g++
against `test_torch_lookback.MOCK_RUNTIME` (every CUDA thread a pthread,
`__syncwarp` a barrier of the warp, shuffles and ballots through a
per-warp buffer) and `test_torch_batched_host.
MOCK_ASYNC_COPY` (bulk copies as synchronous copies that check their
alignment, the mbarrier model).  B4w runs a warp an instance
(group_linalg.cuh), one instance a block; its ring's chunks are cut from
8 steps to 3, so that a few steps cross chunk edges, and n_x = 6 and 12
leave padded rows in every matrix.  B3w runs a warp a product or a
candidate (group_linalg.cuh); its tiles are cut from 32 steps to 4 and so
its blocks from 16 warps to 2 (the tree of its aggregate from five levels
to two), so that 17 and 33 candidates loop over the warps and a few dozen
steps cross many tiles.  Each result is held to the plain version in f64 within 1e-5 of
each output's max, a repeated call must give the same bits, and the
look-back counters must be back at zero.  The tests skip where no g++ is
found; the card runs the same sources in chip_smoke.py.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import _build, affine_scan, batched
from test_torch_batched_host import MOCK_ASYNC_COPY
from test_torch_lookback import MOCK_RUNTIME, _rewrite

torch.set_num_threads(1)

SOURCES = ("batched_riccati.cu", "affine_scan.cu")
SMALL = {
    "batched_riccati.cu": [("kWideChunk = 8;", "kWideChunk = 3;")],
    "affine_scan.cu": [("kWideTile = 32;", "kWideTile = 4;")],
}
RTOL = 1e-5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host mock of the CUDA runtime")
    d = tmp_path_factory.mktemp("wide_batched_host")
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "async_copy.cuh").write_text(MOCK_ASYNC_COPY)
    (d / "cuda_runtime.h").write_text(MOCK_RUNTIME)
    for name in SOURCES:
        src = (_build.CSRC_DIR / name).read_text()
        for a, b in SMALL[name]:
            assert a in src, (name, a)
            src = src.replace(a, b)
        (d / f"{name}.cpp").write_text(_rewrite(src))
    (d / "err.cpp").write_text('extern "C" const char* '
                               'ilqr_cuda_error_string(int) { return ""; }\n')
    so = d / "libwide_batched_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", str(d), *(str(d / f"{n}.cpp") for n in SOURCES),
                    str(d / "err.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.ilqr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _close(got, ref, rtol=RTOL):
    for g, r in zip(got, ref):
        r = r.double()
        assert g.shape == r.shape
        err = float((g.double() - r).abs().max())
        assert err <= rtol * max(float(r.abs().max()), 1e-30), err


def _twice(launch):
    got, again = launch(), launch()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


# ---- B4w --------------------------------------------------------------------

def _expansion(B, N, n_x, n_u, seed):
    """A seeded batched expansion with l_uu positive definite."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, N, n_u, n_u))
    e = dict(f_x=np.eye(n_x) + 0.05 * rng.standard_normal((B, N, n_x, n_x)),
             f_u=0.3 * rng.standard_normal((B, N, n_x, n_u)),
             l_x=rng.standard_normal((B, N, n_x)),
             l_u=rng.standard_normal((B, N, n_u)),
             l_xx=np.broadcast_to(np.eye(n_x), (B, N, n_x, n_x)).copy(),
             l_ux=0.1 * rng.standard_normal((B, N, n_u, n_x)),
             l_uu=M @ np.swapaxes(M, -1, -2) / n_u + np.eye(n_u),
             v_x=rng.standard_normal((B, n_x)),
             v_xx=10.0 * np.broadcast_to(np.eye(n_x), (B, n_x, n_x)).copy())
    return itt.TrajectoryExpansion(**{
        k: torch.tensor(v, dtype=torch.float32) for k, v in e.items()})


def _plain64(exp, reg):
    exp64 = itt.TrajectoryExpansion(**{
        k: getattr(exp, k).double() for k in batched._FIELDS})
    return batched.vmap_backward(itt.backward_pass, exp64, reg.double())


# (n_x, n_u, B, N, pad): matrices padded to 8 (n_x, n_u <= 8) or 16.
@pytest.mark.parametrize("n_x,n_u,B,N,pad", [
    (6, 2, 5, 7, 8), (8, 2, 4, 3, 8), (3, 1, 9, 5, 8), (2, 2, 5, 4, 8),
    (1, 1, 3, 2, 8), (12, 4, 3, 6, 16), (16, 4, 2, 5, 16), (5, 9, 3, 4, 16),
    (16, 16, 3, 3, 16)])
def test_wide_batched_riccati_on_the_host(host_lib, n_x, n_u, B, N, pad):
    """B4w against the f64 plain version: a warp an instance, padded rows,
    a per-instance reg; N = 2-7 steps across the 3-step chunks."""
    assert host_lib.ilqr_batched_riccati_wide_lanes(n_x, n_u) == 32
    assert host_lib.ilqr_batched_riccati_wide_pad(n_x, n_u) == pad
    assert host_lib.ilqr_batched_riccati_wide_chunk_steps() == 3
    exp = _expansion(B, N, n_x, n_u, seed=7 * B + N + n_x)
    reg = torch.linspace(0.0, 0.3, B)
    got = _twice(lambda: batched.launch_riccati(host_lib, exp, reg, 0))
    ref = _plain64(exp, reg)
    _close(got[:3], ref[:3])
    assert got[3].dtype == torch.bool and got[3].tolist() == [True] * B


def test_register_form_shapes_keep_their_lanes(host_lib):
    for shape in ((2, 1), (4, 1), (4, 2)):
        assert host_lib.ilqr_batched_riccati_wide_lanes(*shape) == 0
        assert host_lib.ilqr_batched_riccati_wide_pad(*shape) == 0


# (n_x, n_u, N): N = 1, the 3-step chunk less one, at and plus one, and odd
# N past two and three chunk edges, at odd B.
@pytest.mark.parametrize("n_x,n_u,N", [
    (6, 2, 1), (6, 2, 2), (6, 2, 3), (6, 2, 4), (6, 2, 7), (12, 4, 1),
    (12, 4, 2), (12, 4, 3), (12, 4, 4), (12, 4, 7), (5, 1, 9)])
def test_wide_batched_riccati_horizon_edges(host_lib, n_x, n_u, N):
    """B4w at the horizon's and the ring's edges: the gains of every
    instance match the f64 plain version, twice with equal bits."""
    for B in (3, 5):
        exp = _expansion(B, N, n_x, n_u, seed=11 * B + N + n_x)
        reg = torch.full((B,), 0.05)
        got = _twice(lambda: batched.launch_riccati(host_lib, exp, reg, 0))
        ref = _plain64(exp, reg)
        _close(got[:3], ref[:3])
        assert got[3].tolist() == [True] * B


def _pivot_case(B, N, n_x, n_u, seed, step, l_uu):
    """An expansion whose Q_uu at ``step`` of instance 1 is ``l_uu``
    exactly (f_u = 0 there)."""
    exp = _expansion(B, N, n_x, n_u, seed)
    f_u, luu = exp.f_u.clone(), exp.l_uu.clone()
    f_u[1, step] = 0.0
    luu[1, step] = torch.tensor(l_uu, dtype=torch.float32)
    return dataclasses.replace(exp, f_u=f_u, l_uu=luu)


@pytest.mark.parametrize("n_x,n_u", [(6, 3), (12, 4)])
def test_wide_batched_riccati_pivots_a_zero_leading_entry(host_lib, n_x,
                                                          n_u):
    """Q_uu with Q_uu[0, 0] = 0 but nonsingular (a permuted identity):
    the warp's Gauss-Jordan pivots, and the gains match the plain
    version's solve."""
    perm = np.eye(n_u)[::-1].copy()
    exp = _pivot_case(3, 4, n_x, n_u, seed=n_x, step=2, l_uu=perm)
    reg = torch.zeros(3)
    got = _twice(lambda: batched.launch_riccati(host_lib, exp, reg, 0))
    ref = _plain64(exp, reg)
    _close(got[:3], ref[:3])
    assert got[3].tolist() == [True] * 3


def test_wide_batched_riccati_flags_a_singular_q_uu(host_lib):
    """A singular Q_uu (zero) in one instance sets its ok false, as the
    plain version's flag, and leaves the other instances' gains within
    1e-5 of the f64 plain version's."""
    exp = _pivot_case(4, 5, 6, 2, seed=3, step=3, l_uu=np.zeros((2, 2)))
    reg = torch.zeros(4)
    got = batched.launch_riccati(host_lib, exp, reg, 0)
    plain = batched.vmap_backward(itt.backward_pass, exp, 0.0)
    assert got[3].tolist() == plain[3].tolist() == [True, False, True, True]
    keep = torch.arange(4) != 1
    ref = _plain64(exp, reg)
    _close([g[keep] for g in got[:3]], [r[keep] for r in ref[:3]])


# ---- B3w --------------------------------------------------------------------

# (N, n, A, blocks resident at once): 4-step tiles (N = 3, 4, 5, 8, 9 at
# their edges), two warps a block, so 10, 17 and 33 candidates loop inside
# the launch.
@pytest.mark.parametrize("N,n,A,resident", [
    (1, 6, 1, 0), (3, 12, 3, 0), (4, 16, 17, 0), (5, 3, 10, 0),
    (23, 6, 17, 0), (23, 12, 10, 0), (21, 2, 17, 0), (81, 16, 3, 2),
    (45, 4, 33, 3), (3, 3, 1, 0), (4, 6, 33, 0), (5, 12, 1, 0),
    (8, 16, 10, 0), (9, 3, 33, 0), (9, 12, 33, 0), (8, 6, 1, 0),
    (31, 16, 1, 2), (17, 12, 17, 0)])
def test_wide_affine_scan_on_the_host(host_lib, monkeypatch, N, n, A,
                                      resident):
    """B3w against the f64 plain scan, twice with equal bits, the
    counters back at zero."""
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    assert affine_scan.tile_steps(host_lib, n, A) == 4
    rng = np.random.default_rng(N + n + A)
    P = torch.tensor(0.9 * np.eye(n) + 0.05 * rng.standard_normal((N, n, n)),
                     dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((A, N, n)), dtype=torch.float32)
    d0 = torch.tensor(rng.standard_normal((A, n)), dtype=torch.float32)
    got = _twice(lambda: (affine_scan.launch(host_lib, P, q, d0, 0),))
    ref = itt.affine_prefix_scan_multi(P.double(), q.double(), d0.double())
    _close(got, (ref,))
    counters, _ = _build.scratch(host_lib, affine_scan.KERNEL, P.device, 0,
                                 n, A, N)
    assert int(counters.abs().sum()) == 0


# (B, N, n, A, resident): the batched entry's wide form, B x n_tiles blocks
# by instance-major tickets, 4-step tiles.
@pytest.mark.parametrize("B,N,n,A,resident", [
    (1, 9, 12, 10, 0), (3, 1, 6, 1, 0), (3, 4, 16, 17, 0),
    (2, 23, 12, 33, 0), (4, 17, 6, 3, 2), (3, 21, 2, 17, 3)])
def test_wide_batched_affine_scan_on_the_host(host_lib, monkeypatch, B, N,
                                              n, A, resident):
    """B3w over a batch: one launch for B chains, each instance bit for bit
    a single-instance launch, against the f64 plain scan, twice with equal
    bits, the counters back at zero."""
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    rng = np.random.default_rng(B + N + n + A)
    P = torch.tensor(0.9 * np.eye(n)
                     + 0.05 * rng.standard_normal((B, N, n, n)),
                     dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((B, A, N, n)), dtype=torch.float32)
    d0 = torch.tensor(rng.standard_normal((B, A, n)), dtype=torch.float32)
    got = _twice(lambda: (affine_scan.launch_batched(host_lib, P, q, d0, 0),))
    ref = affine_scan.affine_prefix_scan_batched(P.double(), q.double(),
                                                 d0.double())
    _close(got, (ref,))
    for i in range(B):
        one = affine_scan.launch(host_lib, P[i].contiguous(),
                                 q[i].contiguous(), d0[i].contiguous(), 0)
        assert torch.equal(got[0][i], one), i
    assert host_lib.ilqr_affine_prefix_scan_batched_scratch(n, A, B, N) == \
        B * host_lib.ilqr_affine_prefix_scan_scratch(n, A, N)
    assert host_lib.ilqr_affine_prefix_scan_batched_counters(n, A, B, N) == \
        2 + B * (-(-N // affine_scan.tile_steps(host_lib, n, A)))


def test_wide_affine_scan_sizes(host_lib):
    """The register form keeps n in {2, 4} with at most 16 candidates;
    the wide form's scratch adds the states entering each tile."""
    assert affine_scan.tile_steps(host_lib, 4, 16) == 256
    assert affine_scan.tile_steps(host_lib, 4, 17) == 4
    assert affine_scan.tile_steps(host_lib, 12, 1) == 4
    assert host_lib.ilqr_affine_prefix_scan_scratch(12, 10, 9) == \
        3 * (144 + 3 * 10 * 12)
    assert host_lib.ilqr_affine_prefix_scan_scratch(4, 10, 257) == \
        2 * (16 + 2 * 10 * 4)
    assert host_lib.ilqr_affine_prefix_scan_occupancy(17, 1) < 0
