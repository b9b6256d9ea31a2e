"""The slice as a whole: the port's `solve` against ilqr_tpu's and the
reference goldens.

* the pendulum swing-up (backward Euler, N = 400) reproduces the
  reference's cost 23.435774 and trajectory (tests/golden/pendulum_ol.npz),
  with per-iteration cost and α traces equal to `ilqr_tpu.solve`;
* reduced fully- and under-actuated double-pendulum swing-ups, in f64
  against `ilqr_tpu.solve` under `enable_x64_oracle`.  The port runs the
  slice's engines (backward='pallas', rollout='pallas', whose CPU paths are
  the plain versions); the JAX side runs 'scan' so that no interpret-mode
  Pallas loop is compiled.  f32 double-pendulum swing-ups jump between
  basins when summation order changes, so trajectories are compared in f64;
* the parallel-in-time line searches (rollout='defect'|'chunked') with the
  defect initial rollout, against `ilqr_tpu.solve`'s traces and its
  certification latch (`defect_latch`), which a failed certification drops
  and a caller can set.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_pendulum():
    # Reference config: run_iLQR_open_loop.py (as tests/test_solver.py).
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=np.zeros((2, 2)), d=0.0,
                            integrator="backward_euler")


def _port(jsys, kind, dtype):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


PENDULUM_CFG = dict(maxiter=100, tol=1e-5)


@pytest.fixture(scope="module")
def pendulum_port():
    sys_ = _port(_jax_pendulum(), "pendulum", torch.float32)
    return itt.solve(sys_, torch.tensor([1.0, 0.0]), torch.zeros((400, 1)),
                     itt.IlqrConfig(**PENDULUM_CFG))


def test_pendulum_reproduces_reference_golden(pendulum_port):
    d = np.load(os.path.join(GOLDEN, "pendulum_ol.npz"))
    sol = pendulum_port
    assert sol.status == itt.CONVERGED
    np.testing.assert_allclose(float(sol.cost), 23.4358, rtol=1e-3)
    np.testing.assert_allclose(float(sol.cost), float(d["cost"]), rtol=1e-3)
    # Reference layout is (dim, time); tolerances as tests/test_solver.py.
    np.testing.assert_allclose(sol.X.numpy(), d["X"].T, atol=5e-2)
    np.testing.assert_allclose(sol.U.numpy(), d["U"].T, atol=5e-2)


def test_pendulum_traces_equal_jax(pendulum_port):
    """Same accept rules, same iterations: the α trace is equal and the
    cost trace agrees to f32 rounding of costs near 25 (both packages
    evaluate the same rollouts in float32, in other operation orders)."""
    jsys = _jax_pendulum()
    ref = jax.jit(it.solve, static_argnums=3)(
        jsys, jnp.array([1.0, 0.0]), jnp.zeros((400, 1)),
        it.IlqrConfig(**PENDULUM_CFG))
    sol = pendulum_port
    assert sol.iterations == int(ref.iterations)
    assert sol.status == int(ref.status)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(),
                                  np.asarray(ref.alpha_trace))
    np.testing.assert_allclose(sol.cost_trace.numpy(),
                               np.asarray(ref.cost_trace), rtol=2e-6)
    # max |u_ff| falls from ~3 to ~5e-5 and its last values are f32
    # differences of large terms: held to 1e-6 of the first one's scale.
    np.testing.assert_allclose(sol.grad_trace.numpy(),
                               np.asarray(ref.grad_trace), rtol=1e-3,
                               atol=1e-6)
    assert np.isnan(sol.cost_trace.numpy()[sol.iterations:]).all()


@pytest.fixture(scope="module")
def jax_pendulum_ref():
    return jax.jit(it.solve, static_argnums=3)(
        _jax_pendulum(), jnp.array([1.0, 0.0]), jnp.zeros((400, 1)),
        it.IlqrConfig(**PENDULUM_CFG))


def _spy_open_loop(monkeypatch):
    """Count the solver's calls of the open-loop rollout wrapper."""
    from ilqr_tpu_torch import solver

    calls = []
    real = solver.open_loop_rollout_fused

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return real(*args, **kw)

    monkeypatch.setattr(solver, "open_loop_rollout_fused", spy)
    return calls


def test_pallas_rollout_initial_rollout_runs_the_open_loop_kernel(
        monkeypatch, jax_pendulum_ref):
    """rollout='pallas' sends the initial rollout through the open-loop
    wrapper (the kernel on CUDA, its plain version here), once per solve,
    and the traces still equal JAX's (as test_pendulum_traces_equal_jax)."""
    calls = _spy_open_loop(monkeypatch)
    sys_ = _port(_jax_pendulum(), "pendulum", torch.float32)
    sol = itt.solve(sys_, torch.tensor([1.0, 0.0]), torch.zeros((400, 1)),
                    itt.IlqrConfig(rollout="pallas", **PENDULUM_CFG))
    assert calls == [(400, 1)]
    ref = jax_pendulum_ref
    assert sol.iterations == int(ref.iterations)
    assert sol.status == int(ref.status)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(),
                                  np.asarray(ref.alpha_trace))
    np.testing.assert_allclose(sol.cost_trace.numpy(),
                               np.asarray(ref.cost_trace), rtol=2e-6)
    np.testing.assert_allclose(float(sol.cost), 23.4358, rtol=1e-3)


@pytest.mark.parametrize("rollout,init_rollout,calls", [
    ("pallas", "scan", 1), ("pallas", "defect", 0), ("scan", "auto", 0),
    ("defect", "auto", 0)])
def test_initial_rollout_routing(monkeypatch, rollout, init_rollout, calls):
    """Only rollout='pallas' without init_rollout='defect' runs the
    open-loop kernel, as JAX's solver routes it (solver.py:378-395)."""
    spy = _spy_open_loop(monkeypatch)
    sys_ = _port(_jax_pendulum(), "pendulum", torch.float32)
    itt.solve(sys_, torch.tensor([1.0, 0.0]), torch.zeros((40, 1)),
              itt.IlqrConfig(maxiter=1, rollout=rollout,
                             init_rollout=init_rollout))
    assert len(spy) == calls


def _jax_dp(underactuated):
    if underactuated:
        # Reference config: run_iLQR_OL_UA_Pendulum.py.
        return it.make_double_pendulum(
            0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
            R=np.diag([1.0]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
            d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
            underactuated=True, integrator="backward_euler")
    # Reference config: run_double_pendulum_open_loop.py (the flagship).
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler")


@pytest.mark.parametrize("underactuated,N,maxiter", [(False, 120, 25),
                                                     (True, 60, 12)])
def test_reduced_double_pendulum_traces_match_jax_f64(underactuated, N,
                                                      maxiter):
    """Cut to N steps and maxiter iterations (the reference horizons are
    500 and 800) to keep the CPU run short; f64 on both sides."""
    jsys = _jax_dp(underactuated)
    with enable_x64_oracle():
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     jsys)
        ref = jax.jit(it.solve, static_argnums=3)(
            j64, jnp.zeros(4), jnp.zeros((N, jsys.n_u)),
            it.IlqrConfig(maxiter=maxiter, tol=1e-10, backward="scan",
                          rollout="scan"))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sys_ = _port(jsys, "double_pendulum", torch.float64)
    sol = itt.solve(sys_, torch.zeros(4, dtype=torch.float64),
                    torch.zeros((N, jsys.n_u), dtype=torch.float64),
                    itt.IlqrConfig(maxiter=maxiter, tol=1e-10,
                                   backward="pallas", rollout="pallas"))
    assert sol.iterations == int(ref.iterations) and sol.iterations >= 5
    assert sol.status == int(ref.status)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    # f64 sequential (JAX) vs associative (port) Riccati: same gains to
    # ~1e-12 relative, which the iterations carry into the costs.
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-7)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)
    np.testing.assert_allclose(sol.K.numpy(), ref.K, rtol=1e-6, atol=1e-6)


def test_config_matches_jax_validation_and_schedule():
    for bad in (dict(backward="fast"), dict(rollout="xla"),
                dict(init_rollout="pallas"), dict(defect_engine="cuda"),
                dict(u_min=-1.0), dict(maxiter=0), dict(ddp_sweeps=0),
                dict(u_min=-1.0, u_max=1.0, rollout="pallas")):
        with pytest.raises(ValueError):
            it.IlqrConfig(**bad)
        with pytest.raises(ValueError):
            itt.IlqrConfig(**bad)
    jfields = {f.name: f.default for f in dataclasses.fields(it.IlqrConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(itt.IlqrConfig)}
    assert jfields == tfields
    for kw in (dict(), dict(alpha0=0.8, alpha_factor=0.3, n_alphas=40)):
        assert (itt.IlqrConfig(**kw).alpha_schedule()
                == it.IlqrConfig(**kw).alpha_schedule())
    auto = itt.IlqrConfig()
    assert (auto.resolved_backward(), auto.resolved_rollout(),
            auto.resolved_init_rollout()) == ("scan", "scan", "scan")


@pytest.mark.parametrize("kw,item", [
    (dict(rollout="defect", u_min=-1.0, u_max=1.0), "A14"),
    (dict(rollout="chunked", ddp=True), "A15"),
    (dict(init_rollout="defect", adaptive_reg=True), "A6b"),
    (dict(defect_engine="xla", noise=lambda x, u: 0.1 * x[:, None]), "A15"),
    (dict(u_min=-1.0, u_max=1.0), "A14"), (dict(ddp=True), "A15"),
    (dict(noise=lambda x, u: 0.1 * x[:, None]), "A15"),
    (dict(adaptive_reg=True), "A6b"),
])
def test_unported_options_raise(kw, item):
    """The options of ROADMAP ``item`` (control limits, ddp/noise,
    adaptive_reg), alone and beside the parallel-in-time options, run in
    `solve` whatever the latch, and in `solve_batch` (A12c) with its
    sequential line search.  The name and ids are kept from when `solve`
    and `solve_batch` refused them, so the cases stay comparable across
    runs; ``item`` labels each failure."""
    sys_ = _port(_jax_pendulum(), "pendulum", torch.float32)
    cfg = itt.IlqrConfig(maxiter=3, **kw)
    for latch in (None, True):
        sol = itt.solve(sys_, torch.tensor([1.0, 0.0]), torch.zeros((5, 1)),
                        cfg, defect_latch=latch)
        assert sol.status in (itt.CONVERGED, itt.MAXITER,
                              itt.LINESEARCH_FAILED), item
        assert np.isfinite(float(sol.cost))
        if cfg.u_min is not None:
            assert float(sol.U.abs().max()) <= 1.0
    sols = itt.solve_batch(sys_, torch.zeros((2, 2)), torch.zeros((5, 1)),
                           dataclasses.replace(cfg, rollout="scan"))
    assert bool(torch.isfinite(sols.cost).all()), item
    assert set(sols.status.tolist()) <= {itt.CONVERGED, itt.MAXITER,
                                         itt.LINESEARCH_FAILED}, item
    if cfg.u_min is not None:
        assert float(sols.U.abs().max()) <= 1.0


def _traces_equal(sol, ref, rtol):
    assert (sol.iterations, sol.status) == (int(ref.iterations),
                                            int(ref.status))
    assert sol.defect_latch == bool(ref.defect_latch)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(),
                                  np.asarray(ref.alpha_trace))
    np.testing.assert_allclose(sol.cost_trace.numpy(),
                               np.asarray(ref.cost_trace), rtol=rtol)


@pytest.mark.parametrize("rollout", ["defect", "chunked"])
def test_parallel_linesearch_pendulum_golden_matches_jax(rollout):
    """The pendulum golden through the parallel-in-time line search and the
    defect initial rollout: the golden cost in f32, and JAX's iterations,
    α and cost traces and latch in f64 (in f32 the last step, taken at the
    f32 floor of the cost, is decided by rounding).  defect_engine
    'pallas' runs the plain scan on CPU tensors, as JAX's 'auto' does off
    the TPU."""
    cfg = dict(PENDULUM_CFG, rollout=rollout, init_rollout="defect")
    sol = itt.solve(_port(_jax_pendulum(), "pendulum", torch.float32),
                    torch.tensor([1.0, 0.0]), torch.zeros((400, 1)),
                    itt.IlqrConfig(defect_engine="pallas", **cfg))
    assert sol.status == itt.CONVERGED and sol.defect_latch
    np.testing.assert_allclose(float(sol.cost), 23.435774, rtol=1e-3)
    jsys = _jax_pendulum()  # f32 parameters, as the port's
    with enable_x64_oracle():
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     jsys)
        ref = jax.jit(it.solve, static_argnums=3)(
            j64, jnp.asarray([1.0, 0.0]), jnp.zeros((400, 1)),
            it.IlqrConfig(**cfg))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    f64 = dict(dtype=torch.float64)
    sol = itt.solve(_port(jsys, "pendulum", torch.float64),
                    torch.tensor([1.0, 0.0], **f64), torch.zeros((400, 1), **f64),
                    itt.IlqrConfig(defect_engine="pallas", **cfg))
    _traces_equal(sol, ref, rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-7)


@pytest.mark.parametrize("rollout", ["defect", "chunked"])
def test_parallel_linesearch_double_pendulum_matches_jax_f64(rollout):
    """The reduced DP swing-up (as above) through the parallel line search,
    f64 on both sides; the port runs the kernel engines' CPU paths."""
    jsys = _jax_dp(False)
    N, maxiter = 120, 25
    kw = dict(maxiter=maxiter, tol=1e-10, rollout=rollout,
              init_rollout="defect")
    with enable_x64_oracle():
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     jsys)
        ref = jax.jit(it.solve, static_argnums=3)(
            j64, jnp.zeros(4), jnp.zeros((N, 2)),
            it.IlqrConfig(backward="scan", **kw))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sys_ = _port(jsys, "double_pendulum", torch.float64)
    sol = itt.solve(sys_, torch.zeros(4, dtype=torch.float64),
                    torch.zeros((N, 2), dtype=torch.float64),
                    itt.IlqrConfig(backward="pallas", defect_engine="pallas",
                                   **kw))
    assert sol.iterations >= 5
    _traces_equal(sol, ref, rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-7)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)


def test_defect_latch_drops_on_failed_certification_and_is_honoured():
    """One sweep cannot certify at defect_tol 1e-9: the exact rollouts
    decide and the latch drops, as in JAX, and the solve then equals the
    sequential line search's.  A caller's latch is honoured both ways."""
    jsys = _jax_pendulum()
    sys_ = _port(jsys, "pendulum", torch.float32)
    x0, U0 = torch.tensor([1.0, 0.0]), torch.zeros((400, 1))
    strict = dict(PENDULUM_CFG, rollout="defect", defect_iters=1,
                  defect_tol=1e-9)
    ref = jax.jit(it.solve, static_argnums=3)(
        jsys, jnp.array([1.0, 0.0]), jnp.zeros((400, 1)),
        it.IlqrConfig(**strict))
    sol = itt.solve(sys_, x0, U0, itt.IlqrConfig(**strict))
    assert not sol.defect_latch
    _traces_equal(sol, ref, rtol=2e-6)
    plain = itt.solve(sys_, x0, U0, itt.IlqrConfig(**PENDULUM_CFG))
    np.testing.assert_array_equal(sol.alpha_trace.numpy(),
                                  plain.alpha_trace.numpy())
    # latch False: the parallel path is never tried; True: it is.
    cfg = itt.IlqrConfig(rollout="defect", **PENDULUM_CFG)
    off = itt.solve(sys_, x0, U0, cfg, defect_latch=False)
    assert not off.defect_latch
    np.testing.assert_array_equal(off.cost_trace.numpy(),
                                  plain.cost_trace.numpy())
    assert itt.solve(sys_, x0, U0, cfg, defect_latch=True).defect_latch
    assert not plain.defect_latch


def test_solve_validates_shapes_and_stops_on_linesearch_failure():
    sys_ = _port(_jax_pendulum(), "pendulum", torch.float64)
    with pytest.raises(ValueError, match="U_init"):
        itt.solve(sys_, torch.zeros(2), torch.zeros((5, 2)))
    with pytest.raises(ValueError, match="x0"):
        itt.solve(sys_, torch.zeros(3), torch.zeros((5, 1)))
    # At the target with zero control nothing improves: JAX reports
    # LINESEARCH_FAILED after 0 iterations or converges; both agree.
    x0 = torch.tensor([np.pi, 0.0], dtype=torch.float64)
    sol = itt.solve(sys_, x0, torch.zeros((5, 1), dtype=torch.float64),
                    itt.IlqrConfig(maxiter=3))
    with enable_x64_oracle():
        ref = it.solve(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), _jax_pendulum()),
            jnp.asarray([np.pi, 0.0]), jnp.zeros((5, 1)),
            it.IlqrConfig(maxiter=3))
        assert (sol.status, sol.iterations) == (int(ref.status),
                                                int(ref.iterations))


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "import ilqr_tpu_torch, ilqr_tpu_torch.convert, "
            "ilqr_tpu_torch.estimation, ilqr_tpu_torch.estimation_parallel; "
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
