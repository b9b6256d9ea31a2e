"""The port's differentiable solve (ilqr_tpu_torch.diff) against the JAX
package's (ilqr_tpu.diff) on the same problems.

The pendulum at N = 15 with its cost weights q, r and its damping d as
tensors, gradients of a loss that reads X, U and the cost with respect to
(q, r, d) and x0, under rk4 and backward Euler (whose steps the port
differentiates through `integrators.newton_polish`), in float64 and
float32; JAX runs ``jax.grad`` under ``jax.jit``.  Tolerances: float64
1e-9 relative (the solves stop at tol 1e-12; seen: 1.4e-12); float32
5e-4 relative (each package's f32 solve stops within its own rounding of
the optimum and the IFT gradient of a loss on U* inherits that; seen: the
port 5.4e-5 from JAX under backward Euler and 4.6e-7 under rk4, each 1e-5
to 7e-5 from the f64 gradient).  The CG is held to
``jax.scipy.sparse.linalg.cg`` below convergence.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import diff as jdiff
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import diff as pdiff

torch.set_num_threads(1)

N = 15
X0 = np.array([0.3, 0.1])
THETA = np.array([1.0, 0.5, 0.05])   # q, r, d
RTOL = {"f64": 1e-9, "f32": 5e-4}
DT = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def _ctx(name):
    return enable_x64_oracle() if name == "f64" else contextlib.nullcontext()


def _jax_pendulum(theta, integrator, jdt):
    q, r, d = theta[0], theta[1], theta[2]
    return it.make_pendulum(0.05, jnp.array([np.pi, 0.0], jdt),
                            Q=q * jnp.eye(2, dtype=jdt),
                            R=r * jnp.eye(1, dtype=jdt),
                            Q_f=10.0 * jnp.eye(2, dtype=jdt), d=d,
                            integrator=integrator)


def _port_pendulum(theta, integrator, dtype):
    q, r, d = theta[0], theta[1], theta[2]
    eye = torch.eye(2, dtype=dtype)
    return itt.make_pendulum(0.05, [np.pi, 0.0], Q=q * eye,
                             R=r * torch.eye(1, dtype=dtype),
                             Q_f=10.0 * np.eye(2), d=d,
                             integrator=integrator, device="cpu",
                             dtype=dtype)


def _loss_of(sol):
    return (sol.U ** 2).sum() + (sol.X[-1] ** 2).sum() + sol.cost


def _jax_grad(integrator, name, tol=1e-12):
    _, jdt = DT[name]
    with _ctx(name):
        cfg = it.IlqrConfig(maxiter=200, tol=tol)

        def loss(theta, x0):
            sol = jdiff.solve_implicit(_jax_pendulum(theta, integrator, jdt),
                                       x0, jnp.zeros((N, 1), jdt), cfg)
            return _loss_of(sol)
        g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(THETA, jdt), jnp.asarray(X0, jdt))
    return [np.asarray(a, np.float64) for a in g]


def _port_grad(integrator, name, tol=1e-12):
    dtype, _ = DT[name]
    theta = torch.tensor(THETA, dtype=dtype, requires_grad=True)
    x0 = torch.tensor(X0, dtype=dtype, requires_grad=True)
    U_init = torch.zeros((N, 1), dtype=dtype, requires_grad=True)
    sol = pdiff.solve_implicit(_port_pendulum(theta, integrator, dtype), x0,
                               U_init, itt.IlqrConfig(maxiter=200, tol=tol))
    _loss_of(sol).backward()
    assert sol.status == itt.CONVERGED
    assert torch.equal(U_init.grad, torch.zeros_like(U_init))
    return [theta.grad.double().numpy(), x0.grad.double().numpy()]


def _held(got, ref, rtol, what):
    for g, r, part in zip(got, ref, ("theta", "x0")):
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= rtol, f"{what} d/d{part}: {g} against JAX {r} " \
                            f"({err:.2e} > {rtol})"


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("integrator", ["rk4", "backward_euler"])
def test_solve_implicit_gradients_match_jax(integrator, name):
    tol = 1e-12 if name == "f64" else 1e-9
    _held(_port_grad(integrator, name, tol), _jax_grad(integrator, name, tol),
          RTOL[name], f"{integrator} {name}")


@pytest.mark.parametrize("integrator", ["rk4", "backward_euler"])
def test_hvp_operator_matches_jax_jvp_of_grad(integrator):
    """The backward pass's Hessian-vector product (`diff._Adjoint.hvp`:
    the second-order adjoint on the expansion and the dynamics' second
    derivatives) against the product JAX's diff.py takes, ``jax.jvp`` of
    ``jax.grad`` of the rollout cost, at a seeded (U, v) away from the
    optimum, in float64: within 1e-9 of max |Hv|."""
    rng = np.random.default_rng(3)
    U, v = 0.5 * rng.standard_normal((N, 1)), rng.standard_normal((N, 1))
    with enable_x64_oracle():
        js = _jax_pendulum(jnp.asarray(THETA), integrator, jnp.float64)

        def cost(U):
            return it.rollout(js, jnp.asarray(X0), U)[1]
        ref = np.asarray(jax.jit(lambda U, v: jax.jvp(
            jax.grad(cost), (U,), (v,))[1])(jnp.asarray(U), jnp.asarray(v)))
    ps = _port_pendulum(torch.tensor(THETA), integrator, torch.float64)
    U_t = torch.tensor(U)
    X = itt.rollout(ps, torch.tensor(X0), U_t)[0]
    got = pdiff._Adjoint(ps, X, U_t).hvp(0.0)(torch.tensor(v)).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-9, f"{err:.2e}"


def test_forward_is_solve_bit_for_bit():
    sys_ = _port_pendulum(THETA, "rk4", torch.float32)
    cfg = itt.IlqrConfig(maxiter=50, tol=1e-7)
    ref = itt.solve(sys_, X0, np.zeros((N, 1)), cfg)
    got = pdiff.solve_implicit(sys_, X0, np.zeros((N, 1)), cfg)
    assert torch.equal(got.U, ref.U) and torch.equal(got.X, ref.X)
    assert torch.equal(got.cost, ref.cost) and got.iterations == ref.iterations


def test_envelope_theorem():
    """d(cost*)/dθ is the direct ∂J/∂θ at the fixed optimum (the implicit
    term vanishes with ∇_U J(U*) = 0), in the port as in JAX."""
    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    sys_ = _port_pendulum(theta, "rk4", torch.float64)
    sol = pdiff.solve_implicit(sys_, X0, np.zeros((N, 1)),
                               itt.IlqrConfig(maxiter=200, tol=1e-12))
    (g_ift,) = torch.autograd.grad(sol.cost, theta)
    theta2 = theta.detach().clone().requires_grad_(True)
    direct = itt.rollout(_port_pendulum(theta2, "rk4", torch.float64),
                         torch.as_tensor(X0), sol.U.detach())[1]
    (g_env,) = torch.autograd.grad(direct, theta2)
    assert torch.allclose(g_ift, g_env, rtol=1e-6, atol=1e-9)


def test_cg_matches_jax_below_convergence():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((20, 20))
    A = M @ M.T + 0.5 * np.eye(20)
    b = rng.standard_normal(20)
    for maxiter in (3, 7):
        with enable_x64_oracle():
            ref = jax.scipy.sparse.linalg.cg(
                lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-8,
                maxiter=maxiter)[0]
        At = torch.as_tensor(A)
        got = pdiff.cg(lambda v: At @ v, torch.as_tensor(b), 1e-8, maxiter)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12)
        ref32 = jax.scipy.sparse.linalg.cg(
            lambda v: jnp.asarray(A, jnp.float32) @ v,
            jnp.asarray(b, jnp.float32), tol=1e-8, maxiter=maxiter)[0]
        got32 = pdiff.cg(lambda v: At.float() @ v, torch.as_tensor(b).float(),
                         1e-8, maxiter)
        np.testing.assert_allclose(got32.numpy(), np.asarray(ref32),
                                   rtol=1e-4, atol=1e-5)
    # Converged: the stopping rule r·r <= tol² b·b ends the loop early.
    x = pdiff.cg(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), 1e-10,
                 100)
    np.testing.assert_allclose(A @ x.numpy(), b, rtol=0, atol=1e-8)


def test_refuses_control_limits():
    sys_ = _port_pendulum(THETA, "rk4", torch.float64)
    with pytest.raises(ValueError, match="unconstrained solve"):
        pdiff.solve_implicit(sys_, X0, np.zeros((N, 1)),
                             itt.IlqrConfig(u_min=-1.0, u_max=1.0))


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_run_mpc_implicit_gradient_matches_jax(name):
    """Closed-loop cost of 5 MPC steps (H = 12, rk4 solver, midpoint plant)
    with respect to the solver's weights and x0."""
    dtype, jdt = DT[name]
    cfg_kw = dict(maxiter=60, tol=1e-12 if name == "f64" else 1e-9)
    n_sim, H = 5, 12
    with _ctx(name):
        def loss(theta, x0):
            sys_ = _jax_pendulum(theta, "rk4", jdt)
            plant = _jax_pendulum(jnp.asarray(THETA, jdt), "midpoint", jdt)
            X, U, cost = jdiff.run_mpc_implicit(
                sys_, plant, x0, jnp.zeros((H, 1), jdt), n_sim,
                it.IlqrConfig(**cfg_kw))
            return cost + jnp.sum(X[-1] ** 2)
        ref = [np.asarray(a, np.float64) for a in jax.jit(
            jax.grad(loss, (0, 1)))(jnp.asarray(THETA, jdt),
                                    jnp.asarray(X0, jdt))]
    theta = torch.tensor(THETA, dtype=dtype, requires_grad=True)
    x0 = torch.tensor(X0, dtype=dtype, requires_grad=True)
    X, U, cost = pdiff.run_mpc_implicit(
        _port_pendulum(theta, "rk4", dtype),
        _port_pendulum(THETA, "midpoint", dtype), x0,
        torch.zeros((H, 1), dtype=dtype), n_sim, itt.IlqrConfig(**cfg_kw))
    assert X.shape == (n_sim + 1, 2) and U.shape == (n_sim, 1)
    (cost + (X[-1] ** 2).sum()).backward()
    # Five solves and plant steps carry the rk4 ulp differences between
    # XLA and eager torch from step to step (seen: 3.5e-9 in f64, 5.0e-6
    # in f32).
    _held([theta.grad.double().numpy(), x0.grad.double().numpy()], ref,
          1e-7 if name == "f64" else RTOL["f32"], f"run_mpc_implicit {name}")


def test_package_exports_the_differentiable_solve_and_mppi():
    from ilqr_tpu import __all__ as jax_all
    names = ("solve_implicit", "run_mpc_implicit", "IftConfig",
             "solve_mppi", "mppi_update", "run_mpc_mppi", "MppiConfig")
    assert set(names) <= set(jax_all)
    for name in names:
        assert name in itt.__all__ and hasattr(itt, name)
