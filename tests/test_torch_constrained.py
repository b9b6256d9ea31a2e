"""The port's augmented-Lagrangian solvers against `ilqr_tpu.constrained`.

A small torque-limited reach (pendulum rk4, dt 0.05, N = 40, |u| <= 3 and
the exact goal [1, 0], AlConfig(max_outer=4, ctol=1e-3, mu0=1000)): the
box is active at the solution and the AL loop converges in 3 outer
iterations.  In f64 the port must take the same steps as JAX (status,
outer and inner counts equal; cost within 1e-8 relative; X and U within
1e-6; multipliers within 1e-6 of max|λ|); in f32 end with the same status
and a cost within 1e-4.  JAX's f64 references run its 'scan'/'pscan' and
'xla' engines where the port runs 'pallas' (the plain versions of B1, B1d
and B3 on CPU tensors); the JAX systems are built outside
`enable_x64_oracle`, so their f64 copies hold the f32 parameters the port
receives.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.shooting import MsConfig as JaxMsConfig
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import constrained
from ilqr_tpu_torch.convert import constraints_from_numpy, system_from_numpy

torch.set_num_threads(1)

N, LIM, GOAL = 40, 3.0, np.array([1.0, 0.0])
CFG = dict(maxiter=50, tol=1e-7)
AL = dict(max_outer=4, ctol=1e-3, mu0=1000.0)


def _jax_problem(lim=LIM):
    sys_ = it.make_pendulum(0.05, x_target=GOAL, Q=np.eye(2), R=np.eye(1),
                            Q_f=100.0 * np.eye(2), d=0.0, integrator="rk4")
    cons = it.merge_constraints(
        it.box_control_constraints(np.array([-lim]), np.array([lim])),
        it.goal_constraint(GOAL))
    return sys_, cons


def _tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port_problem(dtype, lim=LIM):
    jsys, jcons = _jax_problem(lim)
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    sys_ = system_from_numpy("pendulum", params, 2, 1, jsys.dt, "rk4",
                             device="cpu", dtype=dtype)
    cons = constraints_from_numpy(("box_control", "goal"),
                                  _tree_np(jcons.params), device="cpu",
                                  dtype=dtype)
    return sys_, cons


def _jax(run, dtype, lim=LIM):
    """``run(system, constraints, x0, U0)`` on the JAX problem in dtype,
    jitted; numpy out."""
    jsys, jcons = _jax_problem(lim)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ctx = enable_x64_oracle() if dtype == torch.float64 else \
        contextlib.nullcontext()
    with ctx:
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)
        out = jax.jit(lambda s, c: run(s, c, jnp.zeros(2, jdt),
                                       jnp.zeros((N, 1), jdt)))(
            cast(jsys), cast(jcons))
        return _tree_np(out)


def _port(run, dtype, lim=LIM):
    sys_, cons = _port_problem(dtype, lim)
    return run(sys_, cons, torch.zeros(2, dtype=dtype),
               torch.zeros((N, 1), dtype=dtype))


def _same_f64(sol, ref):
    assert (sol.status, sol.outer_iterations, sol.inner_iterations) == (
        int(ref.status), int(ref.outer_iterations),
        int(ref.inner_iterations))
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-6)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)
    for name in ("lam_stage_ineq", "lam_stage_eq", "lam_terminal_ineq",
                 "lam_terminal_eq"):
        got, want = getattr(sol, name).numpy(), getattr(ref, name)
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, atol=1e-6 * scale, err_msg=name)
    np.testing.assert_allclose(float(sol.mu), float(ref.mu), rtol=1e-12)
    np.testing.assert_allclose(sol.violation_trace.numpy(),
                               ref.violation_trace, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-8)


def test_factories_and_merge_match_jax():
    x = np.array([0.4, -1.2])
    u = np.array([3.5])
    lo, hi = np.array([-1.0, -2.0]), np.array([1.0, 0.5])
    jax_sets = dict(
        box_control=it.box_control_constraints(np.array([-3.0]),
                                               np.array([3.0])),
        state_bound=it.state_bound_constraints(lo, hi),
        state_bound_stage=it.state_bound_constraints(lo, hi, terminal=False),
        goal=it.goal_constraint(GOAL))
    port_sets = dict(
        box_control=itt.box_control_constraints([-3.0], [3.0], device="cpu"),
        state_bound=itt.state_bound_constraints(lo, hi, device="cpu"),
        state_bound_stage=itt.state_bound_constraints(lo, hi, terminal=False,
                                                      device="cpu"),
        goal=itt.goal_constraint(GOAL, device="cpu"))
    pairs = [(k, k) for k in jax_sets] + [
        (("box_control", "goal"), None), (("state_bound", "goal"), None)]
    for kind, _ in pairs:
        if isinstance(kind, tuple):
            jset = it.merge_constraints(*(jax_sets[k] for k in kind))
            pset = itt.merge_constraints(*(port_sets[k] for k in kind))
        else:
            jset, pset = jax_sets[kind], port_sets[kind]
        # The factories, and the same sets rebuilt from JAX's params.
        conv = constraints_from_numpy(kind, _tree_np(jset.params),
                                      device="cpu", dtype=torch.float32)
        for cset in (pset, conv):
            for field, args in (("stage_ineq", (x, u)), ("stage_eq", (x, u)),
                                ("terminal_ineq", (x,)),
                                ("terminal_eq", (x,))):
                want = np.asarray(getattr(jset, field)(
                    jset.params, *map(jnp.asarray, args)))
                got = getattr(cset, field)(
                    cset.params, *(torch.tensor(a, dtype=torch.float32)
                                   for a in args))
                assert got.dtype == torch.float32 and got.shape == want.shape
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           err_msg=f"{kind} {field}")
    with pytest.raises(ValueError, match="unknown constraint kind"):
        constraints_from_numpy("torque", {}, device="cpu")


def test_absent_blocks_are_zero_size_under_transforms():
    """An absent block is a (0,) tensor on x's device and dtype, also under
    vmap and jacfwd (the penalty and Gauss-Newton terms use both)."""
    x = torch.tensor([0.1, 0.2], dtype=torch.float64)
    u = torch.tensor([0.3], dtype=torch.float64)
    zero = constrained._zero_con
    assert zero(None, x, u).shape == (0,) and zero(None, x).dtype == x.dtype
    X = x.expand(5, 2)
    assert torch.func.vmap(lambda xx: zero(None, xx, u))(X).shape == (5, 0)
    jx, ju = torch.func.jacfwd(zero, argnums=(1, 2))(None, x, u)
    assert jx.shape == (0, 2) and ju.shape == (0, 1)
    assert float(constrained._max0(x[:0], x[:0])) == 0.0


@pytest.mark.parametrize("backward", ["scan", "pallas"])
def test_solve_constrained_matches_jax_f64(backward):
    """'pallas' runs B1's plain version on CPU tensors, 'scan' the
    sequential pass; both take JAX's 'scan' steps."""
    dtype = torch.float64
    ref = _jax(lambda s, c, x, U: it.solve_constrained(
        s, c, x, U, it.IlqrConfig(**CFG), it.AlConfig(**AL)), dtype)
    sol = _port(lambda s, c, x, U: itt.solve_constrained(
        s, c, x, U, itt.IlqrConfig(backward=backward, **CFG),
        itt.AlConfig(**AL)), dtype)
    assert int(ref.status) == itt.CONVERGED
    assert float(sol.U.abs().max()) >= LIM - 1e-3    # the box is active
    _same_f64(sol, ref)
    assert sol.X.dtype == dtype and sol.lam_stage_ineq.shape == (N, 2)


def test_solve_constrained_f32_matches_jax():
    dtype = torch.float32
    ref = _jax(lambda s, c, x, U: it.solve_constrained(
        s, c, x, U, it.IlqrConfig(**CFG), it.AlConfig(**AL)), dtype)
    sol = _port(lambda s, c, x, U: itt.solve_constrained(
        s, c, x, U, itt.IlqrConfig(backward="pallas", rollout="pallas",
                                   **CFG), itt.AlConfig(**AL)), dtype)
    assert sol.status == int(ref.status) == itt.CONVERGED
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-4)
    assert float(sol.violation) <= AL["ctol"]


def test_solve_constrained_ms_matches_jax_f64():
    """The AL x multiple-shooting solve: the port's B1d and B3 plain
    versions (backward='pallas', update_engine='pallas') against JAX's
    'pscan' and 'xla' engines."""
    dtype = torch.float64
    ref = _jax(lambda s, c, x, U: it.solve_constrained_ms(
        s, c, x, U, config=it.IlqrConfig(backward="pscan", **CFG),
        al_config=it.AlConfig(**AL),
        ms=JaxMsConfig(update_engine="xla")), dtype)
    sol = _port(lambda s, c, x, U: itt.solve_constrained_ms(
        s, c, x, U, config=itt.IlqrConfig(backward="pallas", **CFG),
        al_config=itt.AlConfig(**AL),
        ms=itt.MsConfig(update_engine="pallas")), dtype)
    assert int(ref.status) == itt.CONVERGED
    _same_f64(sol, ref)


def test_control_limits_reach_the_inner_solve():
    """u_min/u_max in the config clip the rollouts and go to the backward
    pass, as JAX's `_backward` reads them from its config: an AL solve of
    the goal alone under ±2 limits, against JAX in f64."""
    dtype = torch.float64
    cfg = dict(CFG, u_min=-2.0, u_max=2.0)

    ref = _jax(lambda s, c, x, U: it.solve_constrained(
        s, it.goal_constraint(c.params["b"]["x_goal"]), x, U,
        it.IlqrConfig(**cfg), it.AlConfig(**AL)), dtype)
    sol = _port(lambda s, c, x, U: itt.solve_constrained(
        s, itt.goal_constraint(c.params["b"]["x_goal"], device="cpu",
                               dtype=dtype), x, U,
        itt.IlqrConfig(**cfg), itt.AlConfig(**AL)), dtype)
    assert float(np.abs(ref.U).max()) == pytest.approx(2.0)
    assert (sol.status, sol.outer_iterations, sol.inner_iterations) == (
        int(ref.status), int(ref.outer_iterations),
        int(ref.inner_iterations))
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)
    assert float(sol.U.abs().max()) <= 2.0 + 1e-12


def test_infeasible_stop_matches_jax():
    """|u| <= 2 cannot reach the goal at rest in 2 s: INFEASIBLE after
    max_outer, in both packages, with the same traces."""
    dtype = torch.float64
    al = dict(AL, mu0=100.0)
    ref = _jax(lambda s, c, x, U: it.solve_constrained(
        s, c, x, U, it.IlqrConfig(**CFG), it.AlConfig(**al)), dtype, lim=2.0)
    sol = _port(lambda s, c, x, U: itt.solve_constrained(
        s, c, x, U, itt.IlqrConfig(**CFG), itt.AlConfig(**al)), dtype,
        lim=2.0)
    assert sol.status == int(ref.status) == itt.INFEASIBLE
    assert sol.outer_iterations == AL["max_outer"]
    np.testing.assert_allclose(sol.violation_trace.numpy(),
                               ref.violation_trace, rtol=1e-6)


def test_input_errors():
    sys_, cons = _port_problem(torch.float32)
    x0, U0 = torch.zeros(2), torch.zeros((N, 1))
    empty = itt.ConstraintSet()
    with pytest.raises(ValueError, match="constraint set is empty"):
        itt.solve_constrained(sys_, empty, x0, U0)
    with pytest.raises(ValueError, match="constraint set is empty"):
        itt.solve_constrained_ms(sys_, empty, x0, U0)
    with pytest.raises(ValueError, match="X_init must have shape"):
        itt.solve_constrained_ms(sys_, cons, x0, U0,
                                 X_init=torch.zeros((N, 2)))
    with pytest.raises(ValueError, match="U_init must have shape"):
        itt.solve_constrained(sys_, cons, x0, torch.zeros((N, 2)))
    with pytest.raises(ValueError, match="max_outer"):
        itt.AlConfig(max_outer=0)
    with pytest.raises(ValueError, match="mu_factor"):
        itt.AlConfig(mu_factor=1.0)
