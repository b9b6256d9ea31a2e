"""The wide forms of the fused backward pass (B1w) and of the suffix scan
(B6w), with the suffix scan's 'lane' entry at the same n (B7w), without a
GPU.

`csrc/fused_riccati.cu` and `csrc/suffix_scan.cu` are compiled with g++
against `test_torch_lookback.MOCK_RUNTIME` (every CUDA thread a pthread,
`__syncwarp` a barrier of the warp, shuffles and ballots through a
per-warp buffer).  Both wide forms run a warp an element on
group_linalg.cuh; their tiles are cut from 16 elements (B1w: steps) to 4,
and the 'lane' entry runs B6w's kernel.  A few dozen steps then cross
many tile edges and fold several two-aggregate look-back stages.  At n_x =
3, 5, 6, 12 and 16 (the register form keeps (2, 1), (4, 1), (4, 2)) each
result is held to the plain version in f64 within 1e-5 of each output's
max, a repeated call must give the same bits, and the counters must be
back at zero.  The tests skip where no g++ is found; the card runs the
same sources in chip_smoke.py.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import _build, fused_riccati, parallel_riccati, \
    suffix_scan
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement
from test_torch_lookback import MOCK_RUNTIME, _close, _expansion, _rewrite, \
    _twice

torch.set_num_threads(1)

SOURCES = ("fused_riccati.cu", "suffix_scan.cu")
SMALL = {
    "fused_riccati.cu": [("kWideTile = 16;", "kWideTile = 4;"),
                         ("kTileSteps = 256;", "kTileSteps = 32;"),
                         ("kStageTiles = 64;", "kStageTiles = 3;")],
    "suffix_scan.cu": [("kWideTile = 16;", "kWideTile = 4;"),
                       ("kSubTile = 256;", "kSubTile = 64;"),
                       ("kStageTiles = 64;", "kStageTiles = 3;")],
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host mock of the CUDA runtime")
    d = tmp_path_factory.mktemp("wide_host")
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "cuda_runtime.h").write_text(MOCK_RUNTIME)
    for name in SOURCES:
        src = (_build.CSRC_DIR / name).read_text()
        for a, b in SMALL[name]:
            assert a in src, (name, a)
            src = src.replace(a, b)
        (d / f"{name}.cpp").write_text(_rewrite(src))
    (d / "err.cpp").write_text('extern "C" const char* '
                               'ilqr_cuda_error_string(int) { return ""; }\n')
    so = d / "libwide_host.so"
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


def test_wide_tiles_and_scratch_sizes(host_lib):
    """Wide tiles of 4 steps at every P in the host build (16 on the card),
    and scratch that serves both forms at n_x = 2 and 4."""
    assert fused_riccati.tile_steps(host_lib, 2, 1) == 32
    assert fused_riccati.tile_steps(host_lib, 6, 2) == 4
    assert fused_riccati.tile_steps(host_lib, 4, 3) == 4
    assert fused_riccati.tile_steps(host_lib, 12, 4) == 4
    assert suffix_scan.tile_steps(host_lib, "sub", 4) == 64
    assert suffix_scan.tile_steps(host_lib, "sub", 9) == 4
    assert suffix_scan.tile_steps(host_lib, "sub", 6) == 4
    assert suffix_scan.tile_steps(host_lib, "lane", 6) == 4
    assert suffix_scan.tile_steps(host_lib, "lane", 9) == 4
    # N = 100: 4 register tiles, 26 wide ones (4 steps) at n_x = 4; the
    # wide scratch holds a padded element, a padded value and 3 partials a
    # tile (P = 8: 3 * 96 + 16, 96 + 8).
    assert host_lib.ilqr_fused_riccati_counters(4, 100) == 2 + 26
    assert host_lib.ilqr_fused_riccati_scratch(6, 100) == 26 * (304 + 104 + 3)


def test_wide_horizon_limit_is_the_wrappers(host_lib):
    """The wide form's horizon bound (`kWideMaxN`, int offsets in its
    gains) is the one `fused_riccati._check` refuses past (B1x)."""
    assert host_lib.ilqr_riccati_wide_max_n() == fused_riccati.WIDE_MAX_N


# (N, n_x, n_u, defects, resident): tiles of 4 steps.
@pytest.mark.parametrize("N,n_x,n_u,defects,resident", [
    (1, 6, 2, False, 0), (7, 3, 1, False, 0), (8, 5, 2, True, 0),
    (45, 6, 2, False, 0), (3, 12, 4, False, 0), (30, 12, 4, True, 0),
    (21, 16, 4, False, 0), (13, 16, 6, False, 0), (40, 4, 3, False, 2),
    (41, 16, 6, True, 3)])
def test_wide_fused_riccati_on_the_host(host_lib, monkeypatch, N, n_x, n_u,
                                        defects, resident):
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    exp = _expansion(N, n_x, n_u, N + n_x)
    d = (torch.tensor(0.01 * np.random.default_rng(N).standard_normal(
        (N, n_x)), dtype=torch.float32) if defects else None)
    got = _twice(lambda: fused_riccati.launch(host_lib, exp, 0.1, 0, d))
    exp64 = itt.TrajectoryExpansion(**{
        k: getattr(exp, k).double() for k in exp.__dataclass_fields__})
    ref = itt.backward_pass_associative(exp64, 0.1,
                                        None if d is None else d.double())
    assert bool(got[3]) and bool(ref[3])
    _close(got[:3], ref[:3])


def test_wide_fused_riccati_flags_non_finite_gains(host_lib, monkeypatch):
    """A NaN in one step's l_uu reaches that step's gains and clears ok."""
    monkeypatch.setattr(_build, "_SCRATCH", {})
    exp = _expansion(20, 6, 2, 1)
    exp.l_uu[5, 0, 0] = float("nan")
    got = fused_riccati.launch(host_lib, exp, 0.1, 0)
    assert not bool(got[3])
    assert torch.isfinite(got[1][6:]).all()


@pytest.mark.parametrize("n_x,n_u", [(6, 2), (12, 4)])
def test_wide_fused_riccati_pivots_a_zero_leading_entry(host_lib,
                                                        monkeypatch, n_x,
                                                        n_u):
    """l_uu = a reversed identity (symmetric, nonsingular, zero leading
    entry) with reg = 0 and f_u = 0 at two steps, one each side of a tile
    edge: l_uu + reg I in the element and Q_uu in the gains both have a
    zero leading pivot, which the warp's Gauss-Jordan pivots around; every
    output within 1e-5 of the f64 plain version's."""
    monkeypatch.setattr(_build, "_SCRATCH", {})
    N = 11
    exp = _expansion(N, n_x, n_u, 5 * n_x)
    perm = torch.flip(torch.eye(n_u), [0])
    for t in (3, 4):
        exp.l_uu[t] = perm
        exp.f_u[t] = 0.0
    got = _twice(lambda: fused_riccati.launch(host_lib, exp, 0.0, 0))
    exp64 = itt.TrajectoryExpansion(**{
        k: getattr(exp, k).double() for k in exp.__dataclass_fields__})
    ref = itt.backward_pass_associative(exp64, 0.0)
    assert bool(got[3]) and bool(ref[3])
    _close(got[:3], ref[:3])


# (M, n_x, resident): tiles of 4 elements at every n_x: M = T - 1, T,
# T + 1, several tiles, and more tiles than are resident.
@pytest.mark.parametrize("M,n_x,resident", [
    (1, 6, 0), (8, 6, 0), (9, 3, 0), (37, 5, 0), (4, 12, 0), (29, 12, 0),
    (23, 16, 0), (50, 16, 3), (3, 12, 0), (5, 6, 0), (5, 16, 0),
    (33, 6, 2), (21, 12, 2)])
def test_wide_suffix_scan_on_the_host(host_lib, monkeypatch, M, n_x,
                                      resident):
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    elems = parallel_riccati.make_elements(_expansion(M, n_x, 2, M + n_x), 0.0)
    elems = RiccatiElement(*(t[:M].contiguous() for t in elems))
    got = _twice(lambda: suffix_scan.launch(host_lib, elems, "sub", 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)))
    _close(got, ref)


# (M, n_x, resident): 'lane' tiles of 4 elements, as 'sub'.
@pytest.mark.parametrize("M,n_x,resident", [
    (1, 6, 0), (8, 6, 0), (9, 6, 0), (19, 3, 0), (4, 12, 0), (5, 12, 0),
    (17, 16, 0), (33, 12, 3)])
def test_wide_lane_suffix_scan_on_the_host(host_lib, monkeypatch, M, n_x,
                                           resident):
    """B7w: the 'lane' entry's wide form at n outside {2, 4}, against the
    plain scan in f64, across its tile edges and with few tiles resident;
    the counters end at zero (a repeated call gives the same bits)."""
    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    elems = parallel_riccati.make_elements(_expansion(M, n_x, 2, M + 7 * n_x),
                                           0.0)
    elems = RiccatiElement(*(t[:M].contiguous() for t in elems))
    got = _twice(lambda: suffix_scan.launch(host_lib, elems, "lane", 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)))
    _close(got, ref)


@pytest.mark.parametrize("n_x", [6, 12])
def test_wide_combine_pivots(host_lib, monkeypatch, n_x):
    """L = I + C J is nonsingular for C, J positive semidefinite, but its
    leading pivot can vanish: C = [[1, -2], [-2, 4]] and J = ones(2, 2) in
    the leading block give L_00 = 0, which the Gauss-Jordan inverse must
    pivot around (elements 0 and 1 meet in one tile, 4 apart in a
    second)."""
    monkeypatch.setattr(_build, "_SCRATCH", {})
    M = 6
    rng = np.random.default_rng(n_x)
    A = np.broadcast_to(np.eye(n_x), (M, n_x, n_x)).copy()
    C = np.zeros((M, n_x, n_x))
    J = np.zeros((M, n_x, n_x))
    for k in range(M):
        G = 0.3 * rng.standard_normal((n_x, n_x))
        C[k] = G @ G.T
        J[k] = 0.5 * np.eye(n_x)
    C[0] = 0.0
    C[0, :2, :2] = [[1.0, -2.0], [-2.0, 4.0]]
    J[1] = 0.0
    J[1, :2, :2] = 1.0
    C[4], J[5] = C[0], J[1]
    elems = RiccatiElement(
        *(torch.tensor(a, dtype=torch.float32) for a in (
            A, rng.standard_normal((M, n_x)), C,
            rng.standard_normal((M, n_x)), J)))
    got = _twice(lambda: suffix_scan.launch(host_lib, elems, "sub", 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close(got, ref)


# (B, M, n_x, resident): the wide form's 4-element tiles over B instances.
@pytest.mark.parametrize("B,M,n_x,resident", [
    (1, 9, 6, 0), (3, 1, 12, 0), (3, 8, 6, 0), (4, 13, 12, 3),
    (2, 23, 16, 0), (5, 5, 3, 2)])
def test_wide_batched_suffix_scan_on_the_host(host_lib, monkeypatch, B, M,
                                              n_x, resident):
    """B6w over a batch: one launch, each instance bit for bit a
    single-instance launch, the plain scan in f64 within 1e-5 of each
    output's max, counters back at zero."""
    from test_torch_lookback import _batched_elements

    if resident:
        monkeypatch.setenv("MOCK_RESIDENT", str(resident))
    monkeypatch.setattr(_build, "_SCRATCH", {})
    elems = _batched_elements(B, M, n_x, M + n_x)
    got = _twice(lambda: suffix_scan.launch_batched(host_lib, elems, 0))
    ref = parallel_riccati.suffix_scan(
        RiccatiElement(*(t.double() for t in elems)), axis=1)
    _close(got, ref)
    for i in range(B):
        one = suffix_scan.launch(host_lib, RiccatiElement(
            *(t[i].contiguous() for t in elems)), "sub", 0)
        assert all(torch.equal(a[i], b) for a, b in zip(got, one)), i
