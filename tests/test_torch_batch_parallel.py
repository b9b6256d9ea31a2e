"""Batched parallel-in-time line searches against ilqr_tpu's
``jax.vmap(solve)``, per instance.

`solve_batch` with rollout='defect' or 'chunked' runs JAX's two-phase
search per instance (phase 1 on α0, phase 2 on the whole schedule, the
exact fallback and the latch) with masks in place of vmap's selects, and
stops each instance's sweeps on its own, as vmap of JAX's ``while_loop``
does.  Checked here in f64 (JAX under `enable_x64_oracle`, jitted, on its
'xla' engines; the port's sweeps scan through the plain version of B3's
batched entry on CPU tensors):

* both searches on the DP batch of `test_torch_batch_options.py`, whose
  instances keep or drop their latches ([False, True, False] under
  'defect', all True under 'chunked'), and a ``defect_latch`` input that
  clears one instance, which then takes the exact rollouts from its first
  iteration;
* 'defect' with the pendulum's limits and adaptive_reg;
* `run_mpc_batched(rollout='defect')`, with its per-instance cooldown,
  against ``jax.vmap(run_mpc)``;
* `affine_prefix_scan_batched`'s plain version against ``jax.vmap`` of
  JAX's plain scan, its checks and its routes.

Per-instance agreement: `test_torch_batch_options.py::_compare` (iterations,
status and α traces exact, cost rtol 1e-8, X 1e-7, U 1e-6) plus the final
latches equal.  One JAX reference per configuration, cached in the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.ops.pallas_affine import (
    affine_prefix_scan_multi as jax_affine_scan,
)
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import solver
from ilqr_tpu_torch.ops import affine_scan, parallel_rollout
from test_torch_batch_options import (
    F64,
    LIMIT,
    N,
    SYSTEMS,
    X0S,
    _compare,
    _f64,
    _port,
)

torch.set_num_threads(1)

DP_CFG = dict(maxiter=30, tol=1e-8, defect_engine="xla")
LATCHES = {"defect": [False, True, False], "chunked": [True, True, True]}
_JAX = {}


def _jax_latched(name, cfg):
    """``jax.jit(jax.vmap(solve))`` in f64 from zero controls with the
    latch as a batched input, as a function of the latches; compiled once
    per (system, config) in this module."""
    key = (name, repr(cfg))
    if key not in _JAX:
        jsys = SYSTEMS[name]()
        n = N[name]
        with enable_x64_oracle():
            j64 = _f64(jsys)
            _JAX[key] = jax.jit(jax.vmap(lambda x, latch: it.solve(
                j64, x, jnp.zeros((n, jsys.n_u)), it.IlqrConfig(**cfg),
                defect_latch=latch)))

    def run(latches):
        with enable_x64_oracle():
            out = _JAX[key](jnp.asarray(X0S[name]), jnp.asarray(latches))
            return jax.tree_util.tree_map(np.asarray, out)
    return run


def _port_solve(name, cfg, latches=None):
    jsys = SYSTEMS[name]()
    return itt.solve_batch(
        _port(jsys), torch.tensor(X0S[name], **F64),
        torch.zeros((N[name], jsys.n_u), **F64), itt.IlqrConfig(**cfg),
        defect_latch=latches)


def _compare_latched(sol, ref):
    _compare(sol, ref)
    np.testing.assert_array_equal(sol.defect_latch.numpy(), ref.defect_latch)


@pytest.mark.parametrize("rollout", ["defect", "chunked"])
def test_parallel_linesearches_match_jax_vmap_solve(rollout):
    """The DP batch: a swing from rest, a small correction and a state at
    the target; every instance CONVERGED, the latches as JAX leaves them."""
    cfg = dict(DP_CFG, rollout=rollout)
    ref = _jax_latched("dp", cfg)([True] * 3)
    sol = _port_solve("dp", cfg)
    _compare_latched(sol, ref)
    assert sol.defect_latch.tolist() == LATCHES[rollout]
    assert sol.status.tolist() == [itt.CONVERGED] * 3


def test_defect_latch_input_sends_an_instance_to_the_exact_rollouts(
        monkeypatch):
    """A cleared latch takes the exact rollouts from iteration 0: the
    small correction, which keeps its latch when it starts set, runs the
    exact line search in each of its iterations and ends with the latch
    down; each instance held to JAX with the same latches in."""
    cfg = dict(DP_CFG, rollout="defect")
    latches = [True, False, True]
    exact = []
    plain = solver.linesearch_rollouts

    def recorded(*args, **kw):
        exact.append(args[1].shape[0])
        return plain(*args, **kw)

    monkeypatch.setattr(solver, "linesearch_rollouts", recorded)
    ref = _jax_latched("dp", cfg)(latches)
    sol = _port_solve("dp", cfg, latches=torch.tensor(latches))
    _compare_latched(sol, ref)
    assert sol.defect_latch.tolist() == [False, False, False]
    assert len(exact) >= int(sol.iterations[1]) >= 2


def test_limited_adaptive_reg_defect_matches_jax_vmap_solve():
    """The pendulum under ±1.5 with adaptive_reg: the clipped sweeps clip
    per candidate and per instance with the shared box."""
    lim = LIMIT["pendulum"]
    cfg = dict(maxiter=12, tol=1e-6, u_min=-lim, u_max=lim,
               adaptive_reg=True, rollout="defect", defect_engine="xla",
               backward="scan")
    ref = _jax_latched("pendulum", cfg)([True] * 3)
    sol = _port_solve("pendulum", cfg)
    _compare_latched(sol, ref)
    assert float(sol.U.abs().max()) == pytest.approx(lim)


def test_run_mpc_batched_defect_matches_jax_vmap_run_mpc():
    """Three steps of `run_mpc_batched(rollout='defect')`, each instance's
    latch cooldown carried across steps as ``jax.vmap(run_mpc)`` does."""
    name, n_sim = "pendulum", 3
    cfg = dict(maxiter=6, tol=1e-6, rollout="defect", defect_engine="xla")
    jsys = SYSTEMS[name]()
    with enable_x64_oracle():
        j64 = _f64(jsys)
        ref = jax.jit(lambda xs: jax_mpc.run_mpc_batched(
            j64, j64, xs, jnp.zeros((N[name], 1)), n_sim,
            it.IlqrConfig(**cfg)))(jnp.asarray(X0S[name]))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    system = _port(jsys)
    res = itt.run_mpc_batched(system, system, torch.tensor(X0S[name], **F64),
                              torch.zeros((N[name], 1), **F64), n_sim,
                              itt.IlqrConfig(**cfg))
    np.testing.assert_array_equal(res.solve_iters.numpy(), ref.solve_iters)
    np.testing.assert_array_equal(res.solve_status.numpy(), ref.solve_status)
    np.testing.assert_allclose(res.X.numpy(), ref.X, atol=1e-7)
    np.testing.assert_allclose(res.U.numpy(), ref.U, atol=1e-6)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-8)


# ---- B3 over the batch: the plain version, checks, routes ----------------

def _chains(B, N_, n, A, seed):
    rng = np.random.default_rng(seed)
    return (0.9 * np.eye(n) + 0.05 * rng.standard_normal((B, N_, n, n)),
            rng.standard_normal((B, A, N_, n)),
            rng.standard_normal((B, A, n)))


@pytest.mark.parametrize("n,A", [(2, 1), (2, 10), (4, 1), (4, 10), (12, 1),
                                 (12, 10)])
def test_batched_affine_scan_plain_matches_jax_vmap(n, A):
    P, q, d0 = _chains(3, 37, n, A, seed=10 * n + A)
    with enable_x64_oracle():
        ref = np.asarray(jax.jit(jax.vmap(
            lambda p, q, d: jax_affine_scan(p, q, d, engine="xla")))(
                jnp.asarray(P), jnp.asarray(q), jnp.asarray(d0)))
    got = itt.affine_prefix_scan_batched(*(torch.tensor(a, **F64)
                                           for a in (P, q, d0)))
    assert got.shape == (3, A, 38, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    for i in range(3):
        one = itt.affine_prefix_scan_multi(*(torch.tensor(a[i], **F64)
                                             for a in (P, q, d0)))
        torch.testing.assert_close(got[i], one, rtol=1e-13, atol=1e-13)


def test_batched_affine_scan_checks_and_routes():
    """What the CUDA wrapper refuses before the batched launch, and the
    routes (a meta tensor stands in for a CUDA one: no kernel takes it,
    so a route to the kernel raises at the device check): 'pallas' raises
    on float64, 'auto' runs the plain version there, n > 16 runs it on
    every engine."""
    P, q, d0 = (torch.tensor(a, dtype=torch.float32)
                for a in _chains(3, 5, 4, 2, seed=0))
    affine_scan._check(P, q, d0)
    for bad in ((P.double(), q, d0), (P, q[:, :, :4], d0), (P, q, d0[:2]),
                (P, q[:2], d0), (P.transpose(2, 3), q, d0),
                (P[:0], q[:0], d0[:0]), (P[:, :0], q[:, :, :0], d0)):
        with pytest.raises((TypeError, ValueError)):
            affine_scan._check(*bad)
    meta = dict(device="meta", dtype=torch.float32)
    meta64 = dict(device="meta", dtype=torch.float64)
    for engine in ("auto", "pallas"):
        for n, A in ((2, 3), (12, 10)):
            with pytest.raises(ValueError, match="device"):
                itt.affine_prefix_scan_batched(
                    torch.empty(2, 6, n, n, **meta),
                    torch.empty(2, A, 6, n, **meta),
                    torch.empty(2, A, n, **meta), engine=engine)
    with pytest.raises(TypeError, match="float32"):
        itt.affine_prefix_scan_batched(torch.empty(2, 6, 4, 4, **meta64),
                                       torch.empty(2, 3, 6, 4, **meta64),
                                       torch.empty(2, 3, 4, **meta64),
                                       engine="pallas")
    out = itt.affine_prefix_scan_batched(torch.empty(2, 6, 4, 4, **meta64),
                                         torch.empty(2, 3, 6, 4, **meta64),
                                         torch.empty(2, 3, 4, **meta64))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 3, 7, 4)
    wide = itt.affine_prefix_scan_batched(
        torch.eye(17).expand(2, 3, 17, 17), torch.ones(2, 1, 3, 17),
        torch.zeros(2, 1, 17), engine="pallas")
    np.testing.assert_allclose(wide[1, 0, :, 0].numpy(), [0, 1, 2, 3])
    with pytest.raises(ValueError, match="engine"):
        itt.affine_prefix_scan_batched(P, q, d0, engine="cuda")


def test_batched_defect_search_scans_the_batch_once_a_sweep(monkeypatch):
    """Under defect_engine='pallas' the batched search scans every sweep
    through B3's batched entry, once for the whole batch, and never
    through the single-instance entry (CPU tensors: its plain version)."""
    calls = {"batched": 0, "single": 0}
    plain = parallel_rollout.affine_prefix_scan_batched

    def batched(P, q, delta0, engine="auto"):
        assert engine == "pallas" and P.shape[0] == 3
        calls["batched"] += 1
        return plain(P, q, delta0, engine)

    def single(*args, **kw):
        calls["single"] += 1
        raise AssertionError("single-instance B3 inside solve_batch")

    monkeypatch.setattr(parallel_rollout, "affine_prefix_scan_batched",
                        batched)
    monkeypatch.setattr(parallel_rollout, "affine_prefix_scan_multi", single)
    sol = _port_solve("dp", dict(DP_CFG, maxiter=3, rollout="defect",
                                 defect_engine="pallas"))
    assert calls["batched"] > 0 and calls["single"] == 0
    assert bool(torch.isfinite(sol.cost).all())
