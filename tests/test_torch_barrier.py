"""The port's relaxed-barrier solver against `ilqr_tpu.barrier`.

* β(z; δ) and its two derivatives on a grid that crosses δ, against JAX
  (and β', β'' against torch's own derivatives of β);
* `solve_barrier` on the torque-limited reach of test_torch_constrained.py
  with the box alone (pendulum rk4, N = 40, |u| <= 3), in f64 against JAX:
  the same status and inner iterations, cost within 1e-8 relative, X and U
  within 1e-6, the same traces; with backward='pallas' (B1's plain version)
  as with 'scan';
* the refusal of equality constraints and of an empty set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import barrier as jax_barrier
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import barrier
from ilqr_tpu_torch.convert import system_from_numpy

torch.set_num_threads(1)

N, LIM, GOAL = 40, 3.0, np.array([1.0, 0.0])
CFG = dict(maxiter=50, tol=1e-7)


@pytest.mark.parametrize("delta", [0.1, 0.05])
def test_relaxed_log_barrier_and_derivatives_match_jax(delta):
    z = np.concatenate([np.linspace(-2.0, 2.0, 41), [delta, delta * (1 - 1e-9),
                                                     delta * (1 + 1e-9)]])
    zt = torch.tensor(z, dtype=torch.float64, requires_grad=True)
    with enable_x64_oracle():
        zj = jnp.asarray(z, jnp.float64)
        refs = [np.asarray(f(zj, delta)) for f in (
            jax_barrier.relaxed_log_barrier, jax_barrier._beta_d1,
            jax_barrier._beta_d2)]
    beta = itt.relaxed_log_barrier(zt, delta)
    d1 = barrier._beta_d1(zt, delta)
    d2 = barrier._beta_d2(zt, delta)
    for got, want in zip((beta, d1, d2), refs):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    # β' and β'' are β's derivatives (C² across δ).  At z = δ itself the
    # maximum's tie splits autograd's gradient, so that point is left out.
    g1, = torch.autograd.grad(beta.sum(), zt, create_graph=True)
    g2, = torch.autograd.grad(g1.sum(), zt)
    off = z != delta
    np.testing.assert_allclose(g1.detach().numpy()[off],
                               d1.detach().numpy()[off], rtol=1e-12)
    np.testing.assert_allclose(g2.numpy()[off], d2.detach().numpy()[off],
                               rtol=1e-9)
    assert bool((d2 > 0).all())


def _problem(dtype):
    jsys = it.make_pendulum(0.05, x_target=GOAL, Q=np.eye(2), R=np.eye(1),
                            Q_f=100.0 * np.eye(2), d=0.0, integrator="rk4")
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    sys_ = system_from_numpy("pendulum", params, 2, 1, jsys.dt, "rk4",
                             device="cpu", dtype=dtype)
    return jsys, sys_


@pytest.fixture(scope="module")
def jax_ref():
    jsys, _ = _problem(torch.float64)
    with enable_x64_oracle():
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        box = it.box_control_constraints(jnp.array([-LIM]), jnp.array([LIM]))
        out = jax.jit(lambda s: it.solve_barrier(
            s, box, jnp.zeros(2), jnp.zeros((N, 1)), it.IlqrConfig(**CFG),
            it.BarrierConfig()))(cast(jsys))
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("backward", ["scan", "pallas"])
def test_solve_barrier_matches_jax_f64(jax_ref, backward):
    dtype = torch.float64
    _, sys_ = _problem(dtype)
    box = itt.box_control_constraints([-LIM], [LIM], device="cpu")
    sol = itt.solve_barrier(sys_, box, torch.zeros(2, dtype=dtype),
                            torch.zeros((N, 1), dtype=dtype),
                            itt.IlqrConfig(backward=backward, **CFG),
                            itt.BarrierConfig())
    ref = jax_ref
    assert (sol.status, sol.inner_iterations) == (
        int(ref.status), int(ref.inner_iterations))
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-6)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-8)
    np.testing.assert_allclose(sol.violation_trace.numpy(),
                               ref.violation_trace, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(sol.mu), float(ref.mu), rtol=1e-12)
    # The box binds the unconstrained plan and the barrier keeps inside it.
    assert float(sol.U.abs().max()) <= LIM + 1e-3
    assert float(sol.U.abs().max()) >= 0.9 * LIM


def test_equality_and_empty_sets_rejected():
    _, sys_ = _problem(torch.float32)
    x0, U0 = torch.zeros(2), torch.zeros((N, 1))
    with pytest.raises(ValueError, match="inequality constraints only"):
        itt.solve_barrier(sys_, itt.goal_constraint(GOAL, device="cpu"), x0,
                          U0)
    with pytest.raises(ValueError, match="constraint set is empty"):
        itt.solve_barrier(sys_, itt.ConstraintSet(), x0, U0)
    with pytest.raises(ValueError, match="mu_factor"):
        itt.BarrierConfig(mu_factor=1.0)
