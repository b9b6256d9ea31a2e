"""The port's MPC loops against ilqr_tpu.mpc.

The reference MPC config (tests/test_mpc.py: pendulum, backward-Euler
solver, midpoint plant, Q = diag(10, 1), Q_f = diag(10, 10), R = I, d = 0),
cut to a 40-step horizon and 30 simulated steps.  Every loop is compared in
f64: a closed loop feeds each solve's f32 rounding into the next state, so
f32 loops of two frameworks part by more than rounding after a few steps
(an iteration count at the tol boundary flips).  The JAX systems are built
outside `enable_x64_oracle`, so their f64 copies hold the f32-rounded
parameters the port receives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.shooting import MsConfig as JaxMsConfig
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import mpc
from ilqr_tpu_torch.convert import system_from_numpy

torch.set_num_threads(1)

H, N_SIM = 40, 30
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
    """``run(solver, plant)`` on f64 copies of the JAX pair, as numpy."""
    solver, plant = _jax_pair()
    with enable_x64_oracle():
        cast = lambda s: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), s)
        out = run(cast(solver), cast(plant))
        return jax.tree_util.tree_map(np.asarray, out)


def _ports():
    return tuple(_port(s) for s in _jax_pair())


def _same(res, ref, atol=1e-9):
    np.testing.assert_array_equal(res.solve_iters.numpy(), ref.solve_iters)
    np.testing.assert_array_equal(res.solve_status.numpy(), ref.solve_status)
    np.testing.assert_allclose(res.X.numpy(), ref.X, atol=atol)
    np.testing.assert_allclose(res.U.numpy(), ref.U, atol=10 * atol)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-10)


CFG = dict(maxiter=10, tol=1e-5)


def test_run_mpc_matches_jax():
    ref = _jax_f64(lambda s, p: jax.jit(lambda x: jax_mpc.run_mpc(
        s, p, x, jnp.zeros((H, 1)), N_SIM, it.IlqrConfig(**CFG)))(
        jnp.zeros(2)))
    res = itt.run_mpc(*_ports(), torch.zeros(2, **F64),
                      torch.zeros((H, 1), **F64), N_SIM, itt.IlqrConfig(**CFG))
    assert res.X.shape == (N_SIM + 1, 2) and res.U.shape == (N_SIM, 1)
    assert res.solve_iters.shape == (N_SIM,) and res.cost.ndim == 0
    _same(res, ref)


def test_run_mpc_rti_matches_jax_and_checks_divisibility():
    ref = _jax_f64(lambda s, p: jax.jit(lambda x: jax_mpc.run_mpc_rti(
        s, p, x, jnp.zeros((H, 1)), N_SIM, it.IlqrConfig(**CFG),
        resolve_every=5))(jnp.zeros(2)))
    solver, plant = _ports()
    res = itt.run_mpc_rti(solver, plant, torch.zeros(2, **F64),
                          torch.zeros((H, 1), **F64), N_SIM,
                          itt.IlqrConfig(**CFG), resolve_every=5)
    assert res.U.shape == (N_SIM, 1) and res.solve_iters.shape == (6,)
    _same(res, ref)
    with pytest.raises(ValueError, match="divisible"):
        itt.run_mpc_rti(solver, plant, torch.zeros(2, **F64),
                        torch.zeros((H, 1), **F64), 31, resolve_every=5)


def test_run_mpc_ms_one_iteration_matches_jax():
    """One Gauss-Newton iteration per step on shifted X and U warm starts
    (the multiple-shooting RTI mode)."""
    cfg = dict(maxiter=1, tol=1e-5)
    ref = _jax_f64(lambda s, p: jax.jit(lambda x: jax_mpc.run_mpc_ms(
        s, p, x, jnp.zeros((H, 1)), N_SIM, it.IlqrConfig(**cfg),
        ms=JaxMsConfig(update_engine="seq")))(jnp.zeros(2)))
    res = itt.run_mpc_ms(*_ports(), torch.zeros(2, **F64),
                         torch.zeros((H, 1), **F64), N_SIM,
                         itt.IlqrConfig(**cfg),
                         ms=itt.MsConfig(update_engine="seq"))
    _same(res, ref, atol=1e-8)


def test_run_mpc_batched_matches_jax():
    x0s = np.array([[0.0, 0.0], [0.3, 0.0], [-0.2, 0.5]])
    cfg = dict(maxiter=5, tol=1e-5)
    ref = _jax_f64(lambda s, p: jax.jit(lambda xs: jax_mpc.run_mpc_batched(
        s, p, xs, jnp.zeros((H, 1)), N_SIM, it.IlqrConfig(**cfg)))(
        jnp.asarray(x0s)))
    solver, plant = _ports()
    res = itt.run_mpc_batched(solver, plant, torch.tensor(x0s),
                              torch.zeros((H, 1), **F64), N_SIM,
                              itt.IlqrConfig(**cfg))
    assert res.X.shape == (3, N_SIM + 1, 2) and res.cost.shape == (3,)
    assert res.solve_iters.shape == (3, N_SIM)
    _same(res, ref)


def test_mpc_auto_engines_stay_sequential():
    """JAX resolves 'auto' engines in MPC loops only on a TPU; the port has
    no such rule, and a batched loop with 'auto' is the one with 'scan'."""
    assert jax_mpc._mpc_auto_config(it.IlqrConfig(), 2) == it.IlqrConfig()
    assert mpc._LATCH_COOLDOWN == jax_mpc._LATCH_COOLDOWN
    solver, plant = _ports()
    x0s = torch.tensor([[0.0, 0.0], [0.3, 0.0]], **F64)
    runs = [itt.run_mpc_batched(solver, plant, x0s,
                                torch.zeros((H, 1), **F64), 5,
                                itt.IlqrConfig(maxiter=3, rollout=r))
            for r in ("auto", "scan")]
    for a, b in zip(dataclasses.astuple(runs[0]), dataclasses.astuple(runs[1])):
        assert torch.equal(a, b)
