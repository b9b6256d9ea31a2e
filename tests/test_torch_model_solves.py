"""Solves of the other model families, LQR and TVLQR, against ilqr_tpu.

In f64 (JAX under `enable_x64_oracle`, its systems built from the same
numpy parameters): the cart-pole swing-up, the planar quadrotor with thrust
limits (the limited parallel pass, whose suffix scan is B6w's plain
version here), the 3-D quadrotor's thrust-limited flight at a cut N, the
car's AL solve around the obstacles, and a tracking MPC on the pendulum,
each by the port's kernel engines ('pallas', their plain versions on CPU
tensors; JAX runs its XLA engines) with the iteration count, the status
and the cost trace compared; then the one-shot LQR (`ops/lqr.py`) and the
TVLQR gains and tracked rollouts (`tracking.py`).
"""
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
from ilqr_tpu.ops import lqr as jlqr
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import tracking
from ilqr_tpu_torch.convert import system_from_numpy
from ilqr_tpu_torch.mpc import run_mpc

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _port(jsys, kind):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, **F64)


def _jax_solve(jsys, x0, U0, cfg):
    with enable_x64_oracle():
        out = jax.jit(it.solve, static_argnums=3)(
            _f64(jsys), jnp.asarray(x0), jnp.asarray(U0), cfg)
        return jax.tree_util.tree_map(np.asarray, out)


def _traces_match(sol, ref, rtol=1e-8):
    assert (sol.iterations, sol.status) == (int(ref.iterations),
                                            int(ref.status))
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=rtol)


def test_cartpole_swing_up_matches_jax():
    jsys = it.make_cartpole(0.02, [0.0, np.pi, 0.0, 0.0],
                            np.diag([1.0, 10.0, 0.1, 0.1]), 0.1 * np.eye(1),
                            np.diag([100.0, 500.0, 10.0, 10.0]))
    N, x0 = 80, np.zeros(4)
    ref = _jax_solve(jsys, x0, np.zeros((N, 1)),
                     it.IlqrConfig(maxiter=40, tol=1e-6))
    sol = itt.solve(_port(jsys, "cartpole"), x0, np.zeros((N, 1)),
                    itt.IlqrConfig(maxiter=40, tol=1e-6, backward="pallas",
                                   rollout="pallas"))
    assert sol.iterations >= 5
    _traces_match(sol, ref)


@pytest.mark.parametrize("name", ["quadrotor", "quadrotor3d"])
def test_thrust_limited_quadrotors_match_jax(name):
    """The dash (N = 40) and the flight (N = 20) with rotor thrusts in
    [0, f_max] and adaptive_reg, through the limited parallel pass (JAX's
    'pscan', the port's 'pallas')."""
    if name == "quadrotor":
        jsys = it.make_quadrotor(
            0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
            np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
            np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]))
        N, f_max, hover = 40, 0.5 * 9.81, 0.25 * 9.81
    else:
        Q, R, Q_f = (np.asarray(a) for a in jq3.default_weights())
        jsys = it.make_quadrotor3d(0.02, [2.0, 1.0, 1.5] + [0.0] * 9, Q, R,
                                   Q_f)
        N, f_max, hover = 20, 0.6 * 0.5 * 9.81, 0.25 * 0.5 * 9.81
    x0, U0 = np.zeros(jsys.n_x), np.full((N, jsys.n_u), hover)
    kw = dict(maxiter=25, tol=1e-6, u_min=0.0, u_max=f_max,
              adaptive_reg=True)
    ref = _jax_solve(jsys, x0, U0, it.IlqrConfig(backward="pscan", **kw))
    sol = itt.solve(_port(jsys, name), x0, U0,
                    itt.IlqrConfig(backward="pallas", **kw))
    assert sol.iterations >= 3 and float(sol.U.max()) <= f_max + 1e-9
    _traces_match(sol, ref, rtol=1e-7)


def test_car_obstacles_al_matches_jax():
    """The car's AL solve (N = 30): outer and inner iterations, status and
    cost."""
    jsys = it.make_car(0.1, [8.0, 0.0, 0.0, 0.0],
                       np.diag([0.1, 0.1, 0.01, 0.1]), np.diag([1.0, 5.0]),
                       100.0 * np.diag([1.0, 1.0, 0.1, 1.0]))
    centers, radii = np.array([[3.0, 0.3], [5.5, -0.4]]), np.array([1.0, 0.8])
    lo, hi = np.array([-3.0, -0.5]), np.array([3.0, 0.5])
    al = dict(max_outer=6, ctol=1e-3, mu0=50.0, mu_factor=5.0)
    N = 30
    with enable_x64_oracle():
        cons = it.merge_constraints(jax_obstacles(centers, radii),
                                    it.box_control_constraints(lo, hi))
        ref = jax.jit(lambda s, c, x, U: it.solve_constrained(
            s, c, x, U, it.IlqrConfig(maxiter=50, tol=1e-7),
            it.AlConfig(**al)))(_f64(jsys), _f64(cons), jnp.zeros(4),
                                jnp.zeros((N, 2)))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    cons_t = itt.merge_constraints(
        itt.obstacle_constraints(centers, radii, **F64),
        itt.box_control_constraints(lo, hi, **F64))
    sol = itt.solve_constrained(
        _port(jsys, "car"), cons_t, torch.zeros(4, **F64),
        torch.zeros((N, 2), **F64),
        itt.IlqrConfig(maxiter=50, tol=1e-7, backward="pallas",
                       rollout="pallas"), itt.AlConfig(**al))
    assert (int(sol.status), int(sol.outer_iterations),
            int(sol.inner_iterations)) == (int(ref.status),
                                           int(ref.outer_iterations),
                                           int(ref.inner_iterations))
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, rtol=1e-6, atol=1e-8)


def test_tracking_mpc_matches_jax():
    """The reference-tracking MPC (pendulum, sinusoidal target, horizon
    10, 8 steps) through the fused backward pass's plain version at the
    augmented (3, 1)."""
    dt, n_sim, H = 0.01, 8, 10
    t = np.arange(n_sim + H + 1) * dt
    X_ref = np.stack([0.8 * np.sin(2 * t), 1.6 * np.cos(2 * t)], -1)
    U_ref = np.zeros((n_sim + H, 1))
    Q, R, Q_f = np.diag([100.0, 1.0]), 0.01 * np.eye(1), np.zeros((2, 2))
    base = it.make_pendulum(dt, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=np.zeros((2, 2)), d=0.05, integrator="rk4")
    x0 = np.zeros(3)
    with enable_x64_oracle():
        trk = it.make_tracking_system(_f64(base), X_ref, U_ref, Q, R, Q_f)
        ref = jax.jit(lambda x: jax_run_mpc(
            trk, trk, x, jnp.zeros((H, 1)), n_sim,
            it.IlqrConfig(maxiter=8, tol=1e-6)))(jnp.asarray(x0))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    base_t = _port(base, "pendulum")
    trk_t = itt.make_tracking_system(base_t, X_ref, U_ref, Q, R, Q_f)
    res = run_mpc(trk_t, trk_t, x0, np.zeros((H, 1)), n_sim,
                  itt.IlqrConfig(maxiter=8, tol=1e-6, backward="pallas"))
    np.testing.assert_array_equal(res.solve_iters.numpy(), ref.solve_iters)
    np.testing.assert_allclose(res.X.numpy(), ref.X, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-8)


def test_lqr_matches_jax_f64():
    """The double-integrator LQR (examples/linear_lqr.py): gains, values,
    trajectory and cost, with and without a target."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    Q, R, Q_f = np.eye(2), np.eye(1), 10.0 * np.eye(2)
    x0, xt = np.array([2.0, 0.0]), np.array([0.5, -0.2])
    for target in (None, xt):
        with enable_x64_oracle():
            ref_b = [np.asarray(a) for a in jlqr.lqr_backward(
                *map(jnp.asarray, (A, B, Q, R, Q_f)),
                None if target is None else jnp.asarray(target), N=50)]
            ref = jax.tree_util.tree_map(np.asarray, jlqr.lqr_solve(
                *map(jnp.asarray, (A, B, Q, R, Q_f, x0)), 50,
                None if target is None else jnp.asarray(target)))
        t = [torch.tensor(a) for a in (A, B, Q, R, Q_f)]
        tt = None if target is None else torch.tensor(target)
        got_b = itt.lqr_backward(*t, tt, N=50)
        for g, r in zip(got_b, ref_b):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-12)
        got = itt.lqr_solve(*t, torch.tensor(x0), 50, tt)
        for f in ("X", "U", "K", "k_ff", "cost"):
            np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                       getattr(ref, f), rtol=1e-10,
                                       atol=1e-12, err_msg=f)


def test_tvlqr_gains_and_tracking_match_jax_f64():
    """TVLQR gains along a pendulum swing-up's first iterate, the tracked
    rollout on a mismatched plant (with limits), and `track_solution`."""
    jsys = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=100.0 * np.eye(2), d=0.1, integrator="rk4")
    jplant = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                              Q_f=100.0 * np.eye(2), d=0.13,
                              integrator="midpoint")
    N = 40
    rng = np.random.default_rng(0)
    U = 0.5 * rng.standard_normal((N, 1))
    Qt, Rt, Qft = np.diag([10.0, 1.0]), np.eye(1), 50.0 * np.eye(2)
    x1 = np.array([0.2, -0.1])
    with enable_x64_oracle():
        js, jp = _f64(jsys), _f64(jplant)
        X, _ = jax.jit(it.rollout)(js, jnp.zeros(2), jnp.asarray(U))
        K = jax.jit(lambda X, U: jtracking.tvlqr_gains(
            js, X, U, jnp.asarray(Qt), jnp.asarray(Rt),
            jnp.asarray(Qft)))(X, jnp.asarray(U))
        tr = jax.jit(lambda x: jtracking.track(
            jp, x, X, jnp.asarray(U), K, u_limits=(-1.0, 1.0)))(
                jnp.asarray(x1))
        ref = [np.asarray(a) for a in (X, K) + tuple(tr)]
    sys_t, plant_t = _port(jsys, "pendulum"), _port(jplant, "pendulum")
    X_t = torch.tensor(ref[0])
    K_t = tracking.tvlqr_gains(sys_t, X_t, torch.tensor(U), Qt, Rt, Qft,
                               backward=itt.backward_pass_fused)
    np.testing.assert_allclose(K_t.numpy(), ref[1], rtol=1e-9, atol=1e-12)
    X_tr, U_tr, c_tr = tracking.track(plant_t, x1, X_t, U, K_t,
                                      u_limits=(-1.0, 1.0))
    for g, r in zip((X_tr, U_tr, c_tr), ref[2:]):
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-9, atol=1e-12)
    fake = type("Sol", (), dict(X=X_t, U=torch.tensor(U), K=K_t))
    got = tracking.track_solution(plant_t, x1, fake, u_limits=(-1.0, 1.0))
    np.testing.assert_allclose(got[0].numpy(), X_tr.numpy(), rtol=0, atol=0)
