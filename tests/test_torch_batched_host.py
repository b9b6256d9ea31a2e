"""The batched kernels (B4, B5) and the chain kernels (B2) without a GPU.

`csrc/batched_riccati.cu` (B4) and `csrc/chain_rollout.cu` with the other
translation units of the chain kernels (B2, and B5, its batched entries;
the kernels are in `csrc/chain_kernel.cuh`, the systems in
`csrc/forms.cuh`) are compiled with g++, once per set of sources for all
the test modules that use the library, against
`test_torch_lookback.MOCK_RUNTIME` (every CUDA thread a pthread, shuffles
through a per-warp buffer) and `MOCK_ASYNC_COPY`, a host form of
`csrc/async_copy.cuh`: synchronous copies, the bulk ones checking their
16-byte alignment, and an mbarrier model with the PTX rules (arrival
count, transaction bytes that may run ahead of their expectation, phase
bit; ``try_wait(parity)`` true once the phase of that parity completed,
a fresh barrier counting parity 1 as completed), all under one mutex.
Chunks are cut small (B4: 4 steps; the chain kernels: a ring of 2 stages
of 8 steps) and the chain kernels aim at 2 chain warps, so that a warp
holds several instances, a block several warps, and a few dozen steps
cross many chunk edges.  Instance
rows start at every 4-byte phase (odd N, n_u = 1).  Each result is held to
its plain version in f64 within 1e-5 of each output's max, and a repeated
call must give the same bits.  The tests skip where no g++ is found; the
card runs the same sources in chip_smoke.py.
"""
import concurrent.futures
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import _build, batched, fused_rollout
from test_torch_lookback import MOCK_RUNTIME, _rewrite

torch.set_num_threads(1)

# B4 and every translation unit of the chain kernels.
SOURCES = ("batched_riccati.cu", "chain_rollout.cu", "chain_models.cu",
           "implicit_models.cu", "lti_rollout.cu", "tracking_models.cu",
           "tracking_lti.cu", "rate_models.cu", "rate_lti.cu",
           "spring_chain.cu", "neural_models.cu", "neural_lti.cu")
# Cuts of the sources and of chain_kernel.cuh, the chain kernels' header.
SMALL = {
    "batched_riccati.cu": [("kChunk = 16;", "kChunk = 4;")],
    "chain_kernel.cuh": [("kChunk = 32;", "kChunk = 8;"),
                         ("kStages = 4;", "kStages = 2;"),
                         ("kTargetWarps = 396;", "kTargetWarps = 2;")],
}
RTOL = 1e-5

MOCK_ASYNC_COPY = r"""#pragma once
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <sched.h>

namespace ilqr {
namespace mockbar {

struct State {
  long count = 0, pending = 0, tx = 0;
  unsigned completed = 0;  // phases completed since init
};
inline std::mutex& mu() {
  static std::mutex m;
  return m;
}
inline std::map<const void*, State>& states() {
  static std::map<const void*, State> m;
  return m;
}
inline State& at(const void* bar) {
  auto it = states().find(bar);
  if (it == states().end()) std::abort();  // never initialised
  return it->second;
}
inline void settle(State& s) {
  if (s.pending < 0 || (s.pending == 0 && s.tx < 0)) std::abort();
  if (s.pending == 0 && s.tx == 0) {
    ++s.completed;
    s.pending = s.count;
  }
}
inline void check16(const void* p, uint32_t bytes) {
  if (reinterpret_cast<uintptr_t>(p) % 16 || bytes % 16 || bytes == 0)
    std::abort();
}

}  // namespace mockbar

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(mockbar::mu());
  mockbar::State s;
  s.count = s.pending = count;
  mockbar::states()[bar] = s;
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(mockbar::mu());
  mockbar::State& s = mockbar::at(bar);
  --s.pending;
  mockbar::settle(s);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(mockbar::mu());
  mockbar::State& s = mockbar::at(bar);
  s.tx += bytes;
  --s.pending;
  mockbar::settle(s);
}
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::lock_guard<std::mutex> lock(mockbar::mu());
  return (mockbar::at(bar).completed & 1u) != parity;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) sched_yield();
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  mockbar::check16(dst, bytes);
  mockbar::check16(src, bytes);
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> lock(mockbar::mu());
  mockbar::State& s = mockbar::at(bar);
  s.tx -= bytes;
  if (s.pending == 0) mockbar::settle(s);
}
inline void fence_async_smem() {}
inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  mockbar::check16(dst, bytes);
  mockbar::check16(src, bytes);
  std::memcpy(dst, src, bytes);
}
inline void bulk_commit() {}
inline void bulk_wait_read() {}
inline void bulk_wait_all() {}

}  // namespace ilqr
"""


def _build_host_lib(gxx, d):
    """Write the cut sources and the mocks into ``d``, compile each source
    with g++ (four at a time) and link them into one library."""
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "async_copy.cuh").write_text(MOCK_ASYNC_COPY)
    (d / "cuda_runtime.h").write_text(MOCK_RUNTIME)
    src = (_build.CSRC_DIR / "chain_kernel.cuh").read_text()
    for a, b in SMALL["chain_kernel.cuh"]:
        assert a in src, ("chain_kernel.cuh", a)
        src = src.replace(a, b)
    (d / "chain_kernel.cuh").write_text(_rewrite(src))
    for name in SOURCES:
        src = (_build.CSRC_DIR / name).read_text()
        for a, b in SMALL.get(name, []):
            assert a in src, (name, a)
            src = src.replace(a, b)
        (d / f"{name}.cpp").write_text(_rewrite(src))

    def compile_one(name):
        subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-I",
                        str(d), "-c", str(d / f"{name}.cpp"), "-o",
                        str(d / f"{name}.o")], check=True)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(compile_one, SOURCES))
    so = d / "libbatched_host.so"
    subprocess.run([gxx, "-shared", "-pthread",
                    *(str(d / f"{n}.o") for n in SOURCES), "-o", str(so)],
                   check=True)
    return so


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The library built once per set of sources and mocks: test modules
    (and test processes) that use it share one build in the temporary
    directory, under a lock."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host mock of the CUDA runtime")
    key = hashlib.sha256(repr((MOCK_RUNTIME, MOCK_ASYNC_COPY, SMALL, SOURCES,
                               _rewrite.__code__.co_code)).encode())
    for src in sorted(_build.CSRC_DIR.glob("*.cu*")):
        key.update(src.name.encode() + src.read_bytes())
    d = Path(tempfile.gettempdir()) / f"ilqr_batched_host_{key.hexdigest()[:16]}"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        so = d / "libbatched_host.so"
        if not so.exists():
            work = Path(tempfile.mkdtemp(dir=d))
            os.replace(_build_host_lib(gxx, work), so)
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.ilqr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _close(got, ref):
    """Each output within RTOL of its max against the f64 plain version."""
    for g, r in zip(got, ref):
        r = r.double()
        assert g.shape == r.shape
        err = float((g.double() - r).abs().max())
        assert err <= RTOL * max(float(r.abs().max()), 1e-30), err


def _twice(launch):
    """Two calls with equal bits."""
    got, again = launch(), launch()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


def _f64(system):
    return system.replace(params={k: v.double()
                                  for k, v in system.params.items()})


# ---- B4 -------------------------------------------------------------------

def _batched_expansion(B, N, n_x, n_u, seed):
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


# (n_x, n_u, B, N, reg): 4-step chunks from the end of the horizon, the
# ragged one at t = 0; 8 (n_x = 4) or 16 (n_x = 2) instances a warp.
@pytest.mark.parametrize("n_x,n_u,B,N,reg", [
    (4, 2, 11, 13, 0.1), (2, 1, 19, 7, "per-instance"), (4, 1, 3, 1, 0.0),
    (4, 2, 8, 4, 0.0), (2, 1, 5, 5, 0.3), (4, 1, 9, 3, 0.05)])
def test_batched_riccati_kernel_on_the_host(host_lib, n_x, n_u, B, N, reg):
    exp = _batched_expansion(B, N, n_x, n_u, seed=B * N + n_x)
    reg_b = (torch.linspace(0.0, 0.2, B) if reg == "per-instance"
             else torch.full((B,), reg))
    got = _twice(lambda: batched.launch_riccati(host_lib, exp, reg_b, 0))
    exp64 = itt.TrajectoryExpansion(**{
        k: getattr(exp, k).double() for k in batched._FIELDS})
    ref = batched.vmap_backward(itt.backward_pass, exp64, reg_b.double())
    _close(got[:3], ref[:3])
    assert got[3].dtype == torch.bool and got[3].tolist() == [True] * B


def test_batched_riccati_kernel_flags_non_finite_instances(host_lib):
    """ok is formed in the kernel, per instance, as the plain version's."""
    exp = _batched_expansion(10, 6, 4, 2, seed=4)
    l_uu = exp.l_uu.clone()
    l_uu[3, 2] = torch.nan
    exp = dataclasses.replace(exp, l_uu=l_uu)
    reg_b = torch.zeros(10)
    got = batched.launch_riccati(host_lib, exp, reg_b, 0)
    plain = batched.vmap_backward(itt.backward_pass, exp, 0.0)
    assert got[3].tolist() == plain[3].tolist()
    assert got[3].tolist() == [i != 3 for i in range(10)]
    keep = torch.arange(10) != 3
    _close((got[1][keep],), (plain[1][keep],))


# ---- B5 and B2: the chain kernels -------------------------------------------

def _systems(integrator, dt=0.02):
    f32 = dict(dtype=torch.float32, device="cpu")
    return {
        "pendulum": itt.make_pendulum(
            2.5 * dt, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
            Q_f=10.0 * np.eye(2), d=0.1, integrator=integrator, **f32),
        "UA-DP": itt.make_double_pendulum(
            dt, [np.pi, 0, 0, 0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
            R=np.eye(1), Q_f=np.diag([10.0, 10.0, 1.0, 1.0]), d1=0.1,
            d2=0.1, theta1=1 / 12, theta2=1 / 12, underactuated=True,
            integrator=integrator, **f32),
        "DP": itt.make_double_pendulum(
            dt, [np.pi, 0, 0, 0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
            R=np.diag([0.1, 0.1]), Q_f=np.diag([10.0, 10.0, 1.0, 1.0]),
            d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
            integrator=integrator, **f32),
    }


def _nominal(system, B, N, seed):
    """x0s, a random nominal (X, U) and gains near a stabilising feedback."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32)
    x0s = torch.tensor(0.3 * rng.standard_normal((B, system.n_x)), **f32)
    U = torch.tensor(0.5 * rng.standard_normal((B, N, system.n_u)), **f32)
    X, _ = itt.rollout(system, x0s, U)
    u_ff = torch.tensor(0.2 * rng.standard_normal((B, N, system.n_u)), **f32)
    K = torch.tensor(-0.1 * rng.standard_normal((B, N, system.n_u,
                                                  system.n_x)), **f32)
    return x0s, X.contiguous(), U, u_ff, K


def _check_batched_rollouts(lib, system, B, N, n_alphas, seed):
    x0s, X, U, u_ff, K = _nominal(system, B, N, seed)
    alphas = torch.tensor([0.5 ** i for i in range(n_alphas)])
    alpha_b = alphas[torch.arange(B) % n_alphas].contiguous()
    s64 = _f64(system)
    ref = itt.linesearch_rollouts(s64, x0s.double(), alphas.double(),
                                  X.double(), U.double(), u_ff.double(),
                                  K.double())
    got = _twice(lambda: (batched.launch_costs(
        lib, system, x0s, alphas, X, U, u_ff, K, 0),))
    _close(got, (ref[2],))
    ref = itt.linesearch_rollouts(s64, x0s.double(), alpha_b[:, None].double(),
                                  X.double(), U.double(), u_ff.double(),
                                  K.double())
    got = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, alpha_b, X, U, u_ff, K, 0))
    _close(got, tuple(r[:, 0] for r in ref))
    X_ol, c_ol = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, None, None, U, None, None, 0)[::2])
    _close((X_ol, c_ol), itt.rollout(s64, x0s.double(), U.double()))


# (system, B, N, alphas): 8-step stages in a ring of 2, 2 target warps, so
# a warp holds ceil(B / 2) instances up to 32 / min(A, 32) of them, and a
# block up to 3 such warps.
@pytest.mark.parametrize("name,B,N,A", [
    ("pendulum", 5, 13, 10), ("DP", 7, 21, 1), ("UA-DP", 3, 17, 33),
    ("DP", 1, 9, 10), ("pendulum", 9, 1, 3)])
def test_batched_rollout_kernels_on_the_host(host_lib, name, B, N, A):
    _check_batched_rollouts(host_lib, _systems("rk4")[name], B, N, A,
                            seed=B + N)


@pytest.mark.parametrize("integrator", ["euler", "midpoint",
                                        "backward_euler", "trapezoidal"])
def test_batched_rollout_kernels_run_every_integrator(host_lib, integrator):
    for i, system in enumerate(_systems(integrator).values()):
        _check_batched_rollouts(host_lib, system, 4, 11, 10, seed=i)


def test_batched_rollout_kernels_take_newton_iters(host_lib):
    """The implicit step runs exactly newton_iters corrections: 1 and 10
    each match the plain rollout at the same count, and differ."""
    ua = _systems("backward_euler", dt=0.05)["UA-DP"]
    x0s, X, U, _, _ = _nominal(ua, 3, 15, seed=8)
    x0s[:, 0] = 2.0
    out = {}
    for iters in (1, 10):
        sys_i = ua.replace(newton_iters=iters)
        X_k, _, c_k = batched.launch_trajectory(host_lib, sys_i, x0s, None,
                                                None, U, None, None, 0)
        _close((X_k, c_k), itt.rollout(_f64(sys_i), x0s.double(),
                                       U.double()))
        out[iters] = X_k
    assert float((out[1] - out[10]).abs().max()) > 1e-4


def test_single_instance_entries_are_the_batch_of_one(host_lib):
    """B2's entries at misaligned row views (the kernel places each run at
    its own 16-byte phase) against the plain rollouts."""
    system = _systems("backward_euler")["DP"]
    x0s, X, U, u_ff, K = _nominal(system, 1, 19, seed=3)
    pad = torch.zeros(60)
    views = []
    for t in (X[0], U[0], u_ff[0], K[0]):
        buf = torch.cat([pad[:1], t.reshape(-1)])[1:].view(t.shape)
        assert buf.data_ptr() % 16 == 4
        views.append(buf)
    Xv, Uv, uv, Kv = views
    alphas = torch.tensor([1.0, 0.5, 0.25])
    s64 = _f64(system)
    args64 = (x0s[0].double(), alphas.double(), X[0].double(),
              U[0].double(), u_ff[0].double(), K[0].double())
    ref = itt.linesearch_rollouts(s64, *args64)
    got = _twice(lambda: (fused_rollout.launch_costs(
        host_lib, system, x0s[0], alphas, Xv, Uv, uv, Kv, 0),))
    _close(got, (ref[2],))
    got = _twice(lambda: fused_rollout.launch_trajectory(
        host_lib, system, x0s[0], 0.5, Xv, Uv, uv, Kv, 0))
    _close(got, tuple(r[1] for r in ref))
    got = _twice(lambda: fused_rollout.launch_open_loop(
        host_lib, system, x0s[0], Uv, 0))
    _close(got, itt.rollout(s64, x0s[0].double(), U[0].double()))


def test_chain_split_spreads_a_batch_over_the_card(host_lib):
    """How the chain kernels split a batch (the test build aims at 2 chain
    warps): instances a warp as the batch needs, within 32 // min(A, 32)
    lanes, then up to 3 chain warps a block."""
    def split(*args):
        return (host_lib.ilqr_chain_instances_per_warp(*args),
                host_lib.ilqr_chain_warps_per_block(*args))
    assert split(0, 4, 2, 1, 10) == (1, 1)
    assert split(0, 4, 2, 5, 10) == (3, 2)
    assert split(0, 4, 2, 100, 10) == (3, 3)
    assert split(0, 4, 2, 9, 33) == (1, 3)
    assert split(1, 2, 1, 9, 1) == (5, 2)
    assert split(2, 4, 1, 100, 1) == (32, 3)
    assert split(0, 3, 1, 4, 1) == (-1, -1)
