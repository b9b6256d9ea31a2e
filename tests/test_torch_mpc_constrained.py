"""The port's constrained MPC loops against `ilqr_tpu.mpc`.

examples/constrained_mpc.py's configuration (pendulum, backward-Euler
solver, midpoint plant, |u| <= 6) cut to a 20-step horizon and 5
simulated steps, in f64: X, U and the closed-loop cost within 1e-6, the
per-step iterations and statuses equal.  The AL loop carries shifted
multipliers and the penalty from step to step, from the cold-start shapes
of one call of each constraint callable.  The JAX systems are built
outside `enable_x64_oracle`, so their f64 copies hold the f32 parameters
the port receives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy

torch.set_num_threads(1)

H, N_SIM, LIM = 20, 5, 6.0
F64 = dict(dtype=torch.float64)


def _jax_pair():
    mk = lambda integ: it.make_pendulum(
        0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
        Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integ)
    return mk("backward_euler"), mk("midpoint")


def _port(jsys):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy("pendulum", params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters,
                             dtype=torch.float64, device="cpu")


def _jax_f64(run):
    solver, plant = _jax_pair()
    with enable_x64_oracle():
        cast = lambda s: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), s)
        box = it.box_control_constraints(jnp.array([-LIM]), jnp.array([LIM]))
        out = jax.jit(lambda s, p: run(s, p, box, jnp.zeros(2),
                                       jnp.zeros((H, 1))))(
            cast(solver), cast(plant))
        return jax.tree_util.tree_map(np.asarray, out)


def _port_run(run):
    solver, plant = (_port(s) for s in _jax_pair())
    box = itt.box_control_constraints([-LIM], [LIM], device="cpu", **F64)
    return run(solver, plant, box, torch.zeros(2, **F64),
               torch.zeros((H, 1), **F64))


def _same(res, ref):
    assert res.X.shape == (N_SIM + 1, 2) and res.violation.shape == (N_SIM,)
    np.testing.assert_array_equal(res.solve_iters.numpy(), ref.solve_iters)
    np.testing.assert_array_equal(res.solve_status.numpy(), ref.solve_status)
    np.testing.assert_allclose(res.X.numpy(), ref.X, atol=1e-6)
    np.testing.assert_allclose(res.U.numpy(), ref.U, atol=1e-6)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), atol=1e-6)
    np.testing.assert_allclose(res.violation.numpy(), ref.violation,
                               atol=1e-6)


@pytest.mark.parametrize("backward", ["scan", "pallas"])
def test_run_mpc_constrained_matches_jax(backward):
    cfg = dict(maxiter=15, tol=1e-6)
    al = dict(max_outer=2, ctol=1e-3, mu0=1.0)
    ref = _jax_f64(lambda s, p, c, x, U: jax_mpc.run_mpc_constrained(
        s, p, c, x, U, N_SIM, it.IlqrConfig(**cfg), it.AlConfig(**al)))
    res = _port_run(lambda s, p, c, x, U: itt.run_mpc_constrained(
        s, p, c, x, U, N_SIM, itt.IlqrConfig(backward=backward, **cfg),
        itt.AlConfig(**al)))
    _same(res, ref)


def test_run_mpc_barrier_matches_jax():
    cfg = dict(maxiter=10, tol=1e-6)
    ref = _jax_f64(lambda s, p, c, x, U: jax_mpc.run_mpc_barrier(
        s, p, c, x, U, N_SIM, it.IlqrConfig(**cfg), mu=1e-2, delta=0.05))
    res = _port_run(lambda s, p, c, x, U: itt.run_mpc_barrier(
        s, p, c, x, U, N_SIM, itt.IlqrConfig(backward="pallas", **cfg),
        mu=1e-2, delta=0.05))
    _same(res, ref)
