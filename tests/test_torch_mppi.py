"""The port's MPPI (ilqr_tpu_torch.mppi) against the JAX package's
(ilqr_tpu.mppi), fed JAX's own normal draws.

The port draws through `utils.random.normal`; these tests stand JAX's
draws in for it, in the order JAX splits its keys, so both packages
update from the same noise.  The torque-limited pendulum swing-up of
tests/test_mppi.py at N = 20, S = 64, in float64 and float32, with the
elite cut, time-correlated noise (β = 0.8), limits and σ annealing.
JAX runs under ``jax.jit``.  Tolerances: float64 1e-10 of scale; float32
5e-5 of scale on the controls and states and 1e-4 relative on costs and
effective sample sizes (the softmax weights exp(−ΔJ/λ) turn f32 rounding
of the sampled costs, ~1e-7 of J, into ~1e-5 of the weights at λ = 0.2).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mppi as jm
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import mppi as pm
from ilqr_tpu_torch.utils import random as trandom

torch.set_num_threads(1)

N, S = 20, 64
TOL = {"f64": (torch.float64, jnp.float64, 1e-10, 1e-10),
       "f32": (torch.float32, jnp.float32, 5e-5, 1e-4)}
CASES = {
    "elite": dict(samples=S, iters=3, temperature=0.3, sigma=1.0,
                  elite_frac=0.25),
    "lowpass_limits": dict(samples=S, iters=3, temperature=0.2, sigma=1.0,
                           noise_beta=0.8, u_min=-1.5, u_max=1.5,
                           sigma_decay=0.9),
}


def _ctx(name):
    return enable_x64_oracle() if name == "f64" else contextlib.nullcontext()


def _jax_pendulum(jdt, integrator="rk4"):
    return it.make_pendulum(
        0.05, jnp.array([np.pi, 0.0], jdt),
        Q=jnp.diag(jnp.array([5.0, 0.5], jdt)), R=0.1 * jnp.eye(1, dtype=jdt),
        Q_f=jnp.diag(jnp.array([50.0, 5.0], jdt)), integrator=integrator)


def _port_pendulum(dtype, integrator="rk4"):
    return itt.make_pendulum(
        0.05, [np.pi, 0.0], Q=np.diag([5.0, 0.5]), R=0.1 * np.eye(1),
        Q_f=np.diag([50.0, 5.0]), integrator=integrator, device="cpu",
        dtype=dtype)


def _feed(monkeypatch, draws):
    """Make the port draw ``draws`` (numpy arrays) in order."""
    it_ = iter(draws)

    def normal(gen, shape, dtype, device):
        d = next(it_)
        assert tuple(d.shape) == tuple(shape)
        return torch.as_tensor(d, dtype=dtype, device=device)
    monkeypatch.setattr(trandom, "normal", normal)
    return it_


def _close(got, ref, tol, what):
    got, ref = got.detach().numpy(), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3g}"


def _rel(got, ref, tol, what):
    got, ref = got.detach().numpy(), np.asarray(ref)
    err = float(np.max(np.abs(got - ref) / np.abs(ref)))
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_mppi_update_matches_jax(monkeypatch, name, case):
    dtype, jdt, tol, rtol = TOL[name]
    kw = CASES[case]
    key = jax.random.key(3)
    U0 = 0.1 * np.sin(np.arange(N))[:, None]
    x0 = np.array([0.5, 0.0])
    with _ctx(name):
        cfg = jm.MppiConfig(**kw)
        U_j, ess_j = jax.jit(lambda x, U, k: jm.mppi_update(
            _jax_pendulum(jdt), x, U, k, cfg, 0.8))(
            jnp.asarray(x0, jdt), jnp.asarray(U0, jdt), key)
        draw = np.asarray(jax.random.normal(key, (S, N, 1), jdt))
    left = _feed(monkeypatch, [draw])
    U_t, ess_t = pm.mppi_update(_port_pendulum(dtype), x0, U0, 0,
                                pm.MppiConfig(**kw), 0.8)
    assert next(left, None) is None
    assert U_t.dtype == dtype and U_t.shape == (N, 1)
    _close(U_t, U_j, tol, "U_new")
    _rel(ess_t, ess_j, rtol, "ess")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_solve_mppi_matches_jax(monkeypatch, name, case):
    dtype, jdt, tol, rtol = TOL[name]
    kw = CASES[case]
    key = jax.random.key(1)
    x0 = np.array([0.3, 0.0])
    with _ctx(name):
        cfg = jm.MppiConfig(**kw)
        ref = jax.jit(lambda x, U, k: jm.solve_mppi(
            _jax_pendulum(jdt), x, U, k, cfg))(
            jnp.asarray(x0, jdt), jnp.zeros((N, 1), jdt), key)
        draws = [np.asarray(jax.random.normal(k, (S, N, 1), jdt))
                 for k in jax.random.split(key, cfg.iters)]
    _feed(monkeypatch, draws)
    sol = pm.solve_mppi(_port_pendulum(dtype), x0, np.zeros((N, 1)), 0,
                        pm.MppiConfig(**kw))
    _close(sol.U, ref.U, tol, "U")
    _close(sol.X, ref.X, tol, "X")
    _rel(sol.cost, ref.cost, rtol, "cost")
    _rel(sol.cost_trace, ref.cost_trace, rtol, "cost_trace")
    _rel(sol.ess_trace, ref.ess_trace, rtol, "ess_trace")
    if "u_min" in kw:
        assert float(sol.U.abs().max()) <= kw["u_max"]


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_run_mpc_mppi_matches_jax(monkeypatch, name):
    """tests/test_mppi.py's swing-up loop, cut to 6 steps at S = 64."""
    dtype, jdt, tol, rtol = TOL[name]
    kw = dict(samples=S, iters=2, temperature=0.2, sigma=1.0,
              noise_beta=0.8, u_min=-8.0, u_max=8.0)
    n_sim, key = 6, jax.random.key(11)
    with _ctx(name):
        cfg = jm.MppiConfig(**kw)
        res = jax.jit(lambda k: jm.run_mpc_mppi(
            _jax_pendulum(jdt), _jax_pendulum(jdt, "midpoint"),
            jnp.zeros(2, jdt), jnp.zeros((N, 1), jdt), n_sim, k, cfg))(key)
        draws = [np.asarray(jax.random.normal(kk, (S, N, 1), jdt))
                 for k in jax.random.split(key, n_sim)
                 for kk in jax.random.split(k, cfg.iters)]
    _feed(monkeypatch, draws)
    got = pm.run_mpc_mppi(_port_pendulum(dtype),
                          _port_pendulum(dtype, "midpoint"), np.zeros(2),
                          np.zeros((N, 1)), n_sim, 0, pm.MppiConfig(**kw))
    assert got.X.shape == (n_sim + 1, 2) and got.U.shape == (n_sim, 1)
    _close(got.X, res.X, tol, "X")
    _close(got.U, res.U, tol, "U")
    _rel(got.cost, res.cost, rtol, "cost")
    _rel(got.ess, res.ess, rtol, "ess")


def test_config_defaults_and_validation_match_jax():
    for f, g in zip(dataclasses.fields(pm.MppiConfig),
                    dataclasses.fields(jm.MppiConfig)):
        assert f.name == g.name and f.default == g.default, f.name
    bad = [dict(samples=1), dict(iters=0), dict(elite_frac=0.0),
           dict(elite_frac=1.5), dict(sigma_decay=0.0),
           dict(sigma_decay=1.1), dict(noise_beta=1.0),
           dict(noise_beta=-0.1), dict(u_min=-1.0), dict(u_max=1.0)]
    for kw in bad:
        with pytest.raises(ValueError) as e_j:
            jm.MppiConfig(**kw)
        with pytest.raises(ValueError) as e_t:
            pm.MppiConfig(**kw)
        assert str(e_t.value) == str(e_j.value)
    cfg = pm.MppiConfig(sigma=(0.5,), u_min=-1.0, u_max=2.0)
    assert cfg.sigma_array(1, torch.float32).tolist() == [0.5]
    lo, hi = cfg.limit_arrays(2, torch.float64)
    assert lo.tolist() == [-1.0, -1.0] and hi.tolist() == [2.0, 2.0]
    with pytest.raises(ValueError, match="U_init must have shape"):
        pm.solve_mppi(_port_pendulum(torch.float32), np.zeros(2),
                      np.zeros((5, 3)), 0)


def test_generator_draws_are_deterministic_and_engines_agree_on_cpu(
        monkeypatch):
    sys_ = _port_pendulum(torch.float32)
    cfg = pm.MppiConfig(samples=32, iters=3, noise_beta=0.5)
    runs = [pm.solve_mppi(sys_, [0.4, 0.0], np.zeros((10, 1)), seed, cfg)
            for seed in (7, 7, 8)]
    assert torch.equal(runs[0].U, runs[1].U)
    assert not torch.equal(runs[0].U, runs[2].U)
    g = torch.Generator().manual_seed(7)
    assert torch.equal(pm.solve_mppi(sys_, [0.4, 0.0], np.zeros((10, 1)), g,
                                     cfg).U, runs[0].U)
    U = 0.1 * torch.ones((10, 1))
    kernel = pm.mppi_update(sys_, [0.4, 0.0], U, 3, cfg)
    # The plain route (what a system or dtype no kernel takes runs).
    monkeypatch.setattr(pm, "_on_kernel", lambda *a: False)
    plain = pm.mppi_update(sys_, [0.4, 0.0], U, 3, cfg)
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1],
                                                            plain[1])


def test_kernel_route_is_a_static_test_of_system_and_dtype():
    """Off the CPU, MPPI launches B5 (samples) and B2 (means) where they
    take the system in float32 and runs the plain rollouts elsewhere; the
    test reads the system and dtype only (meta tensors: nothing is built
    or launched)."""
    from ilqr_tpu_torch.ops.batched import batched_model
    from ilqr_tpu_torch.ops.fused_rollout import device_model

    meta32 = torch.empty(2, device="meta")
    meta64 = torch.empty(2, device="meta", dtype=torch.float64)
    pend = _port_pendulum(torch.float32)
    q3 = itt.make_quadrotor3d(0.02, np.zeros(12), np.eye(12), np.eye(4),
                              np.eye(12), integrator="backward_euler",
                              device="cpu")
    assert pm._on_kernel(batched_model, pend, meta32)
    assert not pm._on_kernel(batched_model, pend, meta64)
    # B5 refuses the 3-D quadrotor's implicit rule, B2 takes it.
    assert not pm._on_kernel(batched_model, q3, meta32)
    assert pm._on_kernel(device_model, q3, meta32)
    cpu = torch.empty(2)
    assert pm._on_kernel(batched_model, q3, cpu)   # plain on CPU
