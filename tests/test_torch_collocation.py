"""The port's collocation oracle against `ilqr_tpu.collocation`.

Both oracles compute in float64 whatever their system's dtype; the
systems are built in float32 on both sides (JAX's outside any x64 scope),
so their f64 copies hold the same parameters.  Each case is held to JAX's
`solve_collocation` at N ≤ 40: the same Newton iteration count, the cost
within 1e-12 relative, X and U within 1e-10, the KKT residual within 1e-10
absolute (both under the tolerance).  The cases: the pendulum under the
'step' and 'trapezoidal' defects (also against the port's iLQR solve, as
`tests/test_cross_validation.py:117-150` holds JAX's), the infeasible
straight-line start, the LTI double integrator against `lqr_solve`, a
backward-Euler swing-up (the Lagrangian Hessian W of the implicit step,
which the port takes through `newton_polish`; its W blocks are also held
to JAX's at a point off the solution), and one barrier-constrained solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import collocation as jc
from ilqr_tpu.models.linear import make_lti

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import collocation as tc

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _pendulum(integrator, dt=0.01, Q_f=0.0, R=1.0, d=0.0):
    kw = dict(Q=np.eye(2), R=R * np.eye(1), Q_f=Q_f * np.eye(2), d=d,
              integrator=integrator)
    return (it.make_pendulum(dt, [np.pi, 0.0], **kw),
            itt.make_pendulum(dt, [np.pi, 0.0], **kw, **CPU))


def _held(jsol, tsol, tol):
    assert int(tsol.iterations) == int(jsol.iterations)
    np.testing.assert_allclose(float(tsol.cost), float(jsol.cost),
                               rtol=1e-12)
    for f in ("X", "U"):
        assert getattr(tsol, f).dtype == torch.float64
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)), rtol=0,
                                   atol=1e-10)
    assert float(tsol.kkt_residual) < tol
    assert abs(float(tsol.kkt_residual) - float(jsol.kkt_residual)) < 1e-10


@pytest.mark.parametrize("integrator,defect", [("euler", "step"),
                                               ("trapezoidal", "trapezoidal")])
def test_pendulum_matches_jax_and_the_ilqr_solve(integrator, defect):
    jsys, tsys = _pendulum(integrator)
    x0, N = np.array([1.0, 0.0]), 40
    jsol = jc.solve_collocation(jsys, jnp.asarray(x0), jnp.zeros((N, 1)),
                                defect=defect, tol=1e-6)
    tsol = tc.solve_collocation(tsys, x0, np.zeros((N, 1)), defect=defect,
                                tol=1e-6)
    _held(jsol, tsol, 1e-6)
    sys64 = tsys.replace(params={k: v.double()
                                 for k, v in tsys.params.items()})
    sol_i = itt.solve(sys64, x0, np.zeros((N, 1)),
                      itt.IlqrConfig(maxiter=200, tol=1e-9))
    assert abs(float(tsol.cost) - float(sol_i.cost)) < 1e-4 * max(
        1.0, abs(float(sol_i.cost)))
    assert float((tsol.X - sol_i.X).abs().max()) < 1e-3
    assert float((tsol.U - sol_i.U).abs().max()) < 1e-3


def test_infeasible_start_matches_jax():
    jsys, tsys = _pendulum("euler")
    x0, N = np.array([1.0, 0.0]), 40
    X_line = x0[None] + np.linspace(0, 1, N + 1)[:, None] * (
        np.array([np.pi, 0.0]) - x0)
    jsol = jc.solve_collocation(jsys, jnp.asarray(x0), jnp.zeros((N, 1)),
                                tol=1e-6, X_init=jnp.asarray(X_line))
    tsol = tc.solve_collocation(tsys, x0, np.zeros((N, 1)), tol=1e-6,
                                X_init=X_line)
    assert int(tsol.iterations) > 1
    _held(jsol, tsol, 1e-6)


def test_lti_matches_jax_and_lqr_solve():
    """The discrete double integrator with Q/dt, R/dt (the stage cost is
    dt-scaled), so that the objective is `lqr_solve`'s."""
    dt, N = 0.1, 40
    A_c = np.array([[0.0, 1.0], [0.0, 0.0]])
    B_c = np.array([[0.0], [1.0]])
    A_d, B_d = (np.asarray(m, np.float64) for m in it.cont2disc(
        jnp.asarray(A_c), jnp.asarray(B_c), dt))
    Q, R, Q_f = np.eye(2), np.eye(1), 10.0 * np.eye(2)
    x0 = np.array([1.0, 0.5])
    args = (dt, [0.0, 0.0], Q / dt, R / dt, Q_f)
    jsys = make_lti(jnp.asarray(A_d), jnp.asarray(B_d), *args,
                    integrator="discrete")
    tsys = itt.make_lti(A_d, B_d, *args, integrator="discrete", **CPU)
    jsol = jc.solve_collocation(jsys, jnp.asarray(x0), jnp.zeros((N, 1)),
                                tol=1e-8)
    tsol = tc.solve_collocation(tsys, x0, np.zeros((N, 1)), tol=1e-8)
    _held(jsol, tsol, 1e-7)
    t64 = dict(dtype=torch.float64)
    lqr = itt.lqr_solve(*(torch.tensor(m, **t64) for m in (A_d, B_d, Q, R,
                                                           Q_f)),
                        torch.tensor(x0, **t64), N)
    assert abs(float(tsol.cost) - float(lqr.cost)) < 1e-5 * max(
        1.0, abs(float(lqr.cost)))
    assert float((tsol.U - lqr.U).abs().max()) < 1e-4


@pytest.mark.parametrize("integrator", ["backward_euler", "trapezoidal"])
def test_implicit_step_defect_matches_jax(integrator):
    """A swing-up (Q_f = 100 I, dt 0.05, N = 40) under the implicit rules:
    nine to eleven Newton steps, each on JAX's W.  With the second
    derivatives of the step through the rule's `autograd.Function` (zeros)
    the same solve takes more than twice the steps."""
    jsys, tsys = _pendulum(integrator, dt=0.05, Q_f=100.0, R=0.1, d=0.1)
    N = 40
    jsol = jc.solve_collocation(jsys, jnp.zeros(2), jnp.zeros((N, 1)),
                                tol=1e-8)
    tsol = tc.solve_collocation(tsys, np.zeros(2), np.zeros((N, 1)),
                                tol=1e-8)
    assert int(tsol.iterations) >= 9
    _held(jsol, tsol, 1e-8)


def test_implicit_lagrangian_hessian_blocks_match_jax():
    """The KKT blocks of the backward-Euler 'step' defect at a point off
    the solution (seeded X, U and multipliers): W within 1e-9 of JAX's."""
    jsys, tsys = _pendulum("backward_euler", dt=0.05, Q_f=100.0, R=0.1,
                           d=0.1)
    rng = np.random.default_rng(3)
    N = 12
    X = rng.standard_normal((N + 1, 2))
    U = rng.standard_normal((N, 1))
    lam = rng.standard_normal((N, 2))
    with jax.enable_x64(True):
        jd = jc._make_eval_fns(jsys, "step", N, 2, 1)[0](
            *(jnp.asarray(a, jnp.float64) for a in (X, U, lam)))
        jd = {k: np.asarray(v) for k, v in jd.items()}
    td = tc._make_eval_fns(tc._as_f64(tsys), "step", 2, 1)[0](
        *(torch.tensor(a, dtype=torch.float64) for a in (X, U, lam)))
    assert np.abs(jd["W"]).max() > 1e-3
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def test_barrier_constrained_matches_jax():
    """Torque limits |u| <= 1 on a swing-up (rk4, Q_f = 10 I): the barrier
    continuation from mu_b = 1 to 1e-3, every level's Newton steps as
    JAX's, the limit active at the solution."""
    kw = dict(d=0.0, integrator="rk4")
    args = (0.05, [np.pi, 0.0], np.eye(2), 0.1 * np.eye(1), 10.0 * np.eye(2))
    jsys = it.make_pendulum(*args, **kw)
    tsys = itt.make_pendulum(*args, **kw, **CPU)
    N, opts = 40, dict(tol=1e-6, mu_b_min=1e-3)
    jsol = jc.solve_collocation_constrained(
        jsys, it.box_control_constraints(-1.0, 1.0), jnp.zeros(2),
        jnp.zeros((N, 1)), **opts)
    tsol = tc.solve_collocation_constrained(
        tsys, itt.box_control_constraints(-1.0, 1.0, **CPU), np.zeros(2),
        np.zeros((N, 1)), **opts)
    _held(jsol, tsol, 1e-6)
    assert float(tsol.violation) <= 0.0
    assert float(tsol.comp_gap) == float(jsol.comp_gap) == 1e-3
    assert float(tsol.U.abs().max()) > 0.99


def test_refuses_equality_blocks_and_unknown_defects():
    _, tsys = _pendulum("euler")
    with pytest.raises(ValueError, match="inequality blocks only"):
        tc.solve_collocation_constrained(
            tsys, itt.goal_constraint([np.pi, 0.0], **CPU), np.zeros(2),
            np.zeros((5, 1)))
    with pytest.raises(ValueError, match="defect"):
        tc.solve_collocation(tsys, np.zeros(2), np.zeros((5, 1)),
                             defect="hermite")
