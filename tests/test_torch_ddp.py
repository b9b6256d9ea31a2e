"""Full DDP and iLQG in the port against ilqr_tpu.

* `dynamics_hessians` (forward over forward mode, vmapped over time) on the
  pendulum (rk4, backward Euler) and the double pendulum (euler,
  trapezoidal), against JAX's in f64;
* `noise_expansion` and the noise models, and `simulate_closed_loop`;
* the second-order terms in the sequential `backward_pass` and in
  `backward_pass_ddp_parallel` (both engines; 'pallas' runs its plain
  version on CPU tensors), f32 and f64;
* `solve` with ``ddp``, ``noise`` and ``adaptive_reg``: cost and α traces,
  status and iterations against `ilqr_tpu.solve` in f64.

The same seeded numpy inputs go to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ilqg import control_multiplicative_noise as jax_cm_noise
from ilqr_tpu.ilqg import noise_expansion as jax_noise_expansion
from ilqr_tpu.ilqg import simulate_closed_loop as jax_simulate
from ilqr_tpu.ops.linearize import dynamics_hessians as jax_hessians
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.parallel_riccati import (
    backward_pass_ddp_parallel as jax_ddp_parallel,
)
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy

torch.set_num_threads(1)


def _jax_pendulum(integrator="rk4"):
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=100.0 * np.eye(2), d=0.1,
                            integrator=integrator)


def _jax_dp(integrator="euler"):
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator=integrator)


def _port(jsys, dtype):
    kind = "pendulum" if jsys.n_x == 2 else "double_pendulum"
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


def _f64(jsys):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jsys)


def _trajectory(jsys, N, seed):
    """A seeded random-control rollout (numpy, f64)."""
    rng = np.random.default_rng(seed)
    U = 0.5 * rng.standard_normal((N, jsys.n_u))
    x0 = 0.3 * rng.standard_normal(jsys.n_x)
    with enable_x64_oracle():
        X, _ = jax.jit(it.rollout)(_f64(jsys), jnp.asarray(x0),
                                   jnp.asarray(U))
    return np.asarray(X), U


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jax_noise(x, u):
    """State- and control-dependent noise, two columns."""
    base = jnp.stack([jnp.ones_like(x), 0.5 * x], axis=1)
    return 0.05 * base * (1.0 + 0.1 * x[0] + 0.2 * u[0])


def _torch_noise(x, u):
    base = torch.stack([torch.ones_like(x), 0.5 * x], dim=1)
    return 0.05 * base * (1.0 + 0.1 * x[0] + 0.2 * u[0])


@pytest.mark.parametrize("name,integrator", [
    ("pendulum", "rk4"), ("pendulum", "backward_euler"),
    ("dp", "euler"), ("dp", "trapezoidal")])
def test_dynamics_hessians_match_jax(name, integrator):
    """f64, both sides; the implicit integrators' second derivatives come
    from Newton steps on the residual in the port and from JAX's tangent
    rule in JAX (both are those of the implicit solution, to the Newton
    solve's convergence: rtol 1e-6)."""
    jsys = (_jax_pendulum if name == "pendulum" else _jax_dp)(integrator)
    X, U = _trajectory(jsys, 12, seed=3)
    with enable_x64_oracle():
        ref = jax.jit(jax_hessians)(_f64(jsys), jnp.asarray(X),
                                    jnp.asarray(U))
        ref = [np.asarray(getattr(ref, f)) for f in ("f_xx", "f_ux", "f_uu")]
    got = itt.dynamics_hessians(_port(jsys, torch.float64), _t(X), _t(U))
    n_x, n_u = jsys.n_x, jsys.n_u
    assert got.f_xx.shape == (12, n_x, n_x, n_x)
    assert got.f_ux.shape == (12, n_x, n_u, n_x)
    assert got.f_uu.shape == (12, n_x, n_u, n_u)
    tol = 1e-6 if integrator in ("backward_euler", "trapezoidal") else 1e-10
    for g, r in zip((got.f_xx, got.f_ux, got.f_uu), ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r, rtol=tol,
                                   atol=tol * max(1.0, np.abs(r).max()))


def test_dynamics_hessians_f32_keep_the_dtype():
    jsys = _jax_dp("euler")
    X, U = _trajectory(jsys, 8, seed=4)
    got = itt.dynamics_hessians(_port(jsys, torch.float32),
                                _t(X, torch.float32), _t(U, torch.float32))
    ref = jax.jit(jax_hessians)(jsys, jnp.asarray(X, jnp.float32),
                                jnp.asarray(U, jnp.float32))
    for f in ("f_xx", "f_ux", "f_uu"):
        g = getattr(got, f)
        assert g.dtype == torch.float32
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


def test_noise_expansion_and_models_match_jax():
    jsys = _jax_pendulum()
    X, U = _trajectory(jsys, 10, seed=5)
    B = np.array([[0.0], [1.0]])
    for jfn, tfn in ((_jax_noise, _torch_noise),
                     (jax_cm_noise(1.5, B),
                      itt.control_multiplicative_noise(1.5, B)),
                     (it.ilqg.additive_noise(0.25 * np.eye(2)),
                      itt.additive_noise(0.25 * np.eye(2)))):
        with enable_x64_oracle():
            ref = jax.jit(lambda X, U: jax_noise_expansion(jfn, X, U))(
                jnp.asarray(X), jnp.asarray(U))
        got = itt.noise_expansion(tfn, _t(X), _t(U))
        assert isinstance(got, itt.NoiseExpansion)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                       atol=1e-14)


def _second_order_case(jsys, N, seed, terms):
    """(JAX expansion, hess, noise) in f64 along a seeded rollout."""
    X, U = _trajectory(jsys, N, seed)
    with enable_x64_oracle():
        j64 = _f64(jsys)
        Xj, Uj = jnp.asarray(X), jnp.asarray(U)
        exp = jax.tree_util.tree_map(np.asarray,
                                     jax.jit(jax_linearize)(j64, Xj, Uj))
        hess = (jax.tree_util.tree_map(
            np.asarray, jax.jit(jax_hessians)(j64, Xj, Uj))
            if "hess" in terms else None)
        noise = (tuple(np.asarray(a) for a in jax.jit(
            lambda X, U: jax_noise_expansion(_jax_noise, X, U))(Xj, Uj))
            if "noise" in terms else None)
    return exp, hess, noise


def _port_terms(hess, noise, dtype):
    h = None if hess is None else itt.DynamicsHessians(
        *(_t(getattr(hess, f), dtype) for f in ("f_xx", "f_ux", "f_uu")))
    nz = None if noise is None else tuple(_t(a, dtype) for a in noise)
    return h, nz


def _jax_terms(hess, noise, dtype):
    h = None if hess is None else jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), hess)
    nz = None if noise is None else tuple(jnp.asarray(a, dtype)
                                          for a in noise)
    return h, nz


TERMS = [("hess",), ("noise",), ("hess", "noise")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("terms", TERMS)
def test_second_order_backward_pass_matches_jax(terms, dtype):
    """The sequential pass with DDP and/or iLQG terms, 40 steps of the
    double pendulum.  f64: rtol 1e-9 against JAX.  f32: both packages'
    f32 results against the f64 answer (on which they agree to 1e-9), so
    the host's BLAS does not decide the verdict.  With both terms the
    gain solves are indefinite and the f32 error is set by the rounding of
    the small matrix products: the port's order replayed in numpy f32
    (OpenBLAS) lands at 0.6x JAX's error, the same order in torch f32
    (MKL) at 3.5-3.9x on one host and under 1e-3 relative on another.
    So the port's f32 error is held to 8x JAX's, the measured spread of
    the BLAS libraries with margin, plus 1e-5 of the largest f64 entry,
    and each package's to 5e-3 of that entry."""
    exp, hess, noise = _second_order_case(_jax_dp(), 40, 7, terms)

    def jax_ref(jdt):
        e = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), exp)
        return jax.jit(jax_backward)(e, 0.05, *_jax_terms(hess, noise, jdt))

    with enable_x64_oracle():
        ref64 = [np.asarray(r) for r in jax_ref(jnp.float64)]
    got = itt.backward_pass(expansion_from_numpy(exp, device="cpu",
                                                 dtype=dtype), 0.05,
                            *_port_terms(hess, noise, dtype))
    assert bool(got[3]) and bool(ref64[3])
    if dtype == torch.float64:
        for g, r in zip(got[:3], ref64[:3]):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                       atol=1e-10 * np.abs(r).max())
        return
    ref32 = jax_ref(jnp.float32)
    assert bool(ref32[3])
    for g, r32, r in zip(got[:3], ref32[:3], ref64[:3]):
        scale = np.abs(r).max()
        err = np.abs(g.numpy().astype(np.float64) - r).max()
        err_jax = np.abs(np.asarray(r32, np.float64) - r).max()
        assert err <= 8.0 * err_jax + 1e-5 * scale, (err, err_jax, scale)
        assert max(err, err_jax) <= 5e-3 * scale, (err, err_jax, scale)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("terms", TERMS)
def test_ddp_parallel_backward_matches_jax(terms, engine):
    """`backward_pass_ddp_parallel` in f64 against JAX's 'xla' engine (the
    port's 'pallas' engine is the plain scan on CPU tensors; JAX's Pallas
    scan takes f32 only).  4 sweeps; rtol 1e-9."""
    exp, hess, noise = _second_order_case(_jax_pendulum(), 60, 8, terms)
    with enable_x64_oracle():
        e = jax.tree_util.tree_map(jnp.asarray, exp)
        ref = jax.jit(jax_ddp_parallel, static_argnames=("sweeps", "engine"))(
            e, 0.0, *_jax_terms(hess, noise, jnp.float64), sweeps=4,
            engine="xla")
    got = itt.backward_pass_ddp_parallel(
        expansion_from_numpy(exp, device="cpu", dtype=torch.float64), 0.0,
        *_port_terms(hess, noise, torch.float64), sweeps=4, engine=engine)
    assert bool(got[3])
    for g, r in zip(got[:3], ref[:3]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                   atol=1e-10 * np.abs(r).max())
    assert got[1].is_contiguous()
    with pytest.raises(ValueError, match="engine"):
        itt.backward_pass_ddp_parallel(
            expansion_from_numpy(exp, device="cpu"), engine="auto")


def _solve_both(jsys, N, cfg_kw, x0, jax_kw=None):
    """ilqr_tpu.solve (f64, jitted) and the port's solve (f64, numpy
    inputs)."""
    jax_kw = dict(cfg_kw, **(jax_kw or {}))
    with enable_x64_oracle():
        ref = jax.jit(it.solve, static_argnums=3)(
            _f64(jsys), jnp.asarray(x0), jnp.zeros((N, jsys.n_u)),
            it.IlqrConfig(**jax_kw))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sol = itt.solve(_port(jsys, torch.float64), np.asarray(x0),
                    np.zeros((N, jsys.n_u)), itt.IlqrConfig(**cfg_kw))
    return sol, ref


def _traces_match(sol, ref, rtol=1e-9):
    assert (sol.iterations, sol.status) == (int(ref.iterations),
                                            int(ref.status))
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=rtol)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("backward", ["scan", "pscan", "pallas"])
def test_ddp_solve_traces_match_jax(backward):
    """Pendulum swing-up (N = 150) with ddp=True and adaptive_reg: the
    sequential recursion ('scan') and the frozen-trace parallel pass
    (4 sweeps; 'pallas' is its plain version here, JAX runs 'pscan')."""
    cfg = dict(maxiter=30, tol=1e-9, ddp=True, adaptive_reg=True,
               reg_init=1e-6, backward=backward, ddp_sweeps=4)
    sol, ref = _solve_both(_jax_pendulum(), 150, cfg, np.zeros(2),
                           jax_kw=dict(backward=backward.replace("pallas",
                                                                 "pscan")))
    assert sol.iterations >= 4
    _traces_match(sol, ref)


@pytest.mark.parametrize("backward", ["scan", "pallas"])
def test_noise_solve_traces_match_jax(backward):
    """iLQG with state- and control-dependent noise on the double pendulum
    (N = 60)."""
    cfg = dict(maxiter=15, tol=1e-9, noise=_torch_noise, backward=backward)
    sol, ref = _solve_both(_jax_dp(), 60, cfg, np.zeros(4),
                           jax_kw=dict(noise=_jax_noise,
                                       backward=backward.replace("pallas",
                                                                 "pscan")))
    assert sol.iterations >= 4
    _traces_match(sol, ref)


def test_adaptive_reg_escalates_and_recovers_as_jax():
    """A one-candidate line search (n_alphas=1) on the double pendulum
    fails some iterations: adaptive_reg escalates from max(reg, 1e-6),
    consumes the iteration (nan in the traces), lowers reg after each
    accepted step; the port takes the same path as JAX."""
    cfg = dict(maxiter=25, tol=1e-9, n_alphas=1, adaptive_reg=True,
               reg_factor=10.0)
    sol, ref = _solve_both(_jax_dp(), 80, cfg, np.zeros(4))
    alphas = sol.alpha_trace.numpy()[:sol.iterations]
    assert np.isnan(alphas).any() and np.isfinite(alphas).any()
    _traces_match(sol, ref)
    # Without adaptive_reg the first failure ends the solve.
    sol0, ref0 = _solve_both(_jax_dp(), 80,
                             dict(cfg, adaptive_reg=False), np.zeros(4))
    assert sol0.status == itt.LINESEARCH_FAILED
    _traces_match(sol0, ref0)


def test_adaptive_reg_gives_up_past_reg_max():
    """reg_max below the first escalation: LINESEARCH_FAILED after one
    consumed iteration, as JAX."""
    cfg = dict(maxiter=25, tol=1e-9, n_alphas=1, adaptive_reg=True,
               reg_max=1e-7)
    sol, ref = _solve_both(_jax_dp(), 80, cfg, np.zeros(4))
    assert sol.status == itt.LINESEARCH_FAILED
    _traces_match(sol, ref)


def test_simulate_closed_loop():
    """Zero noise: every realization is the closed-loop rollout (std 0,
    mean = JAX's).  With noise: the same generator seed gives the same
    draw; the policy's mean cost is finite."""
    jsys = _jax_pendulum()
    sys_ = _port(jsys, torch.float64)
    sol = itt.solve(sys_, np.zeros(2), np.zeros((60, 1)),
                    itt.IlqrConfig(maxiter=10))
    zero = itt.additive_noise(np.zeros((2, 1)))
    mean, std = itt.simulate_closed_loop(
        sys_, zero, sol.X, sol.U, sol.K, torch.Generator().manual_seed(0),
        n_rollouts=4)
    with enable_x64_oracle():
        ref = jax_simulate(_f64(jsys), it.ilqg.additive_noise(
            np.zeros((2, 1))), jnp.asarray(sol.X.numpy()),
            jnp.asarray(sol.U.numpy()), jnp.asarray(sol.K.numpy()),
            jax.random.PRNGKey(0), n_rollouts=4)
    assert float(std) == 0.0 and float(ref[1]) == 0.0
    np.testing.assert_allclose(float(mean), float(ref[0]), rtol=1e-12)
    np.testing.assert_allclose(float(mean), float(sol.cost), rtol=1e-12)
    draws = [itt.simulate_closed_loop(
        sys_, _torch_noise, sol.X, sol.U, sol.K,
        torch.Generator().manual_seed(7), n_rollouts=16) for _ in range(2)]
    assert float(draws[0][0]) == float(draws[1][0])
    assert np.isfinite(float(draws[0][0])) and float(draws[0][1]) > 0.0


def test_fold_second_order_is_the_sequential_q_terms():
    """At the sequential recursion's own value trace the folded stage
    terms give its gains: the fixed point of the parallel pass."""
    exp, hess, noise = _second_order_case(_jax_pendulum(), 30, 9,
                                          ("hess", "noise"))
    e = expansion_from_numpy(exp, device="cpu", dtype=torch.float64)
    h, nz = _port_terms(hess, noise, torch.float64)
    u_seq = itt.backward_pass(e, 0.0, h, nz)[0]
    par = itt.backward_pass_ddp_parallel(e, 0.0, h, nz, sweeps=30)
    np.testing.assert_allclose(par[0].numpy(), u_seq.numpy(), rtol=1e-9,
                               atol=1e-12)
