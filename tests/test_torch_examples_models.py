"""The drivers of the other model families (examples_torch/) in smoke mode,
against the JAX package on the same problems.

Each driver runs in this process under ``ILQR_TPU_SMOKE=1`` with
``device='cpu'`` and ``plot=False`` (its kernel engines run their plain
versions on CPU tensors), and its result is held within 1e-4 relative to
`ilqr_tpu` solving the driver's own `problem()` in f32, the JAX systems
rebuilt from the port's parameters (the JAX side runs its default engines,
'pscan' where limits make the port run the limited parallel pass).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import tracking as jtracking
from ilqr_tpu.models import quadrotor3d as jq3
from ilqr_tpu.models.car import obstacle_constraints as jax_obstacles
from ilqr_tpu.mpc import run_mpc as jax_run_mpc
from ilqr_tpu.utils.x64 import enable_x64_oracle

RTOL = 1e-4


@pytest.fixture
def driver(monkeypatch):
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")

    def load(name):
        return importlib.import_module(f"examples_torch.{name}")
    return load


def _np(t):
    return t.detach().cpu().numpy()


def _cost_params(sys_):
    return tuple(_np(sys_.params[k]) for k in ("x_target", "Q", "R", "Q_f"))


def _close(got, ref):
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def _cfg(cfg, **kw):
    return it.IlqrConfig(maxiter=cfg.maxiter, tol=cfg.tol, u_min=cfg.u_min,
                         u_max=cfg.u_max, adaptive_reg=cfg.adaptive_reg, **kw)


def test_quadrotor3d_flight_driver(driver):
    """In f64: the smoke-size flight stops at maxiter 5 with limits, where
    f32 rounding decides which thrusts sit at a bound (1e-3 apart); the
    smoke MPC (H = 10, maxiter 2) tumbles the craft after its third step,
    where JAX's own engines part by 5 %, so it runs 3 steps."""
    m = driver("quadrotor3d_flight")
    sol, res = m.main(plot=False, device="cpu", dtype=torch.float64,
                      n_sim=3)
    p = m.problem("cpu", torch.float64)
    with enable_x64_oracle():
        jsys = it.make_quadrotor3d(p.dt, *_cost_params(p.system))
        ref = jax.jit(lambda x, U: it.solve(jsys, x, U, _cfg(
            p.config, backward="pscan")))(_np(p.x0), _np(p.U0))
        _close(sol.cost, ref.cost)
        plant = jq3.make_quadrotor3d(p.dt, *_cost_params(p.system),
                                     integrator="euler")
        ref = jax.jit(lambda x: jax_run_mpc(
            jsys, plant, x, _np(p.U0_mpc), 3,
            it.IlqrConfig(maxiter=p.config_mpc.maxiter,
                          tol=p.config_mpc.tol, backward="pscan",
                          rollout="scan", init_rollout="scan"),
            auto_parallel=False))(_np(p.x0))
        _close(res.cost, ref.cost)


def test_quadrotor_dash_driver(driver):
    m = driver("quadrotor_dash")
    out = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    jsys = it.make_quadrotor(p.system.dt, *_cost_params(p.system))
    ref = jax.jit(lambda x, U: it.solve(jsys, x, U, _cfg(
        p.config, backward="pscan")))(_np(p.x0), _np(p.U0))
    _close(out.sol.cost, ref.cost)
    w = {k: _np(v) for k, v in p.track_weights.items()}
    K = jtracking.tvlqr_gains(jsys, ref.X, ref.U, **w)
    np.testing.assert_allclose(_np(out.K), np.asarray(K), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(K)).max())


def test_car_obstacles_driver(driver):
    m = driver("car_obstacles")
    sol = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    jsys = it.make_car(p.system.dt, *_cost_params(p.system))
    cons = it.merge_constraints(
        jax_obstacles(_np(p.centers), _np(p.radii)),
        it.box_control_constraints(np.array([-3.0, -0.5]),
                                   np.array([3.0, 0.5])))
    al = p.al_config
    ref = jax.jit(lambda x, U: it.solve_constrained(
        jsys, cons, x, U, it.IlqrConfig(maxiter=p.config.maxiter,
                                        tol=p.config.tol),
        it.AlConfig(max_outer=al.max_outer, ctol=al.ctol, mu0=al.mu0,
                    mu_factor=al.mu_factor)))(_np(p.x0), _np(p.U0))
    _close(sol.cost, ref.cost)


def test_linear_lqr_driver(driver):
    m = driver("linear_lqr")
    out = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    A_d, B_d = it.cont2disc(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                            jnp.array([[0.0], [1.0]]), p.dt)
    np.testing.assert_allclose(_np(p.A_d), np.asarray(A_d), rtol=1e-6)
    ref = it.lqr_solve(A_d, B_d, jnp.eye(2), jnp.eye(1), 10.0 * jnp.eye(2),
                       jnp.array([2.0, 0.0]), p.N)
    _close(out.lqr.cost, ref.cost)
    assert out.ilqr.status == 1


def test_tvlqr_tracking_driver(driver):
    m = driver("tvlqr_tracking")
    out = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    s = p.system
    f = {k: float(_np(s.params[k])) for k in ("g", "l", "d")}
    jsys = it.make_pendulum(s.dt, *_cost_params(s), integrator="rk4", **f)
    ref = jax.jit(lambda x, U: it.solve(jsys, x, U, it.IlqrConfig(
        maxiter=p.config.maxiter, tol=p.config.tol)))(_np(p.x0), _np(p.U0))
    _close(out.sol.cost, ref.cost)
    assert len(out.err_cl) == 4


def test_reference_tracking_mpc_driver(driver):
    m = driver("reference_tracking_mpc")
    out = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    trk = p.system
    b = trk.params["base"]
    base = it.make_pendulum(trk.dt, _np(b["x_target"]), _np(b["Q"]),
                            _np(b["R"]), _np(b["Q_f"]), d=float(_np(b["d"])),
                            integrator="rk4")
    jtrk = it.make_tracking_system(
        base, _np(trk.params["X_ref"]), _np(trk.params["U_ref"]),
        _np(trk.params["Q"]), _np(trk.params["R"]), _np(trk.params["Q_f"]))
    ref = jax.jit(lambda x: jax_run_mpc(
        jtrk, jtrk, x, _np(p.U0), p.n_sim,
        it.IlqrConfig(maxiter=8, tol=1e-6)))(_np(p.x0))
    _close(out.res.cost, ref.cost)
