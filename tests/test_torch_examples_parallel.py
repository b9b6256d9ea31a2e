"""The long-horizon and iLQG drivers (examples_torch/) in smoke mode,
against their JAX originals on the same numpy data.

Each driver runs in this process under ``ILQR_TPU_SMOKE=1`` with
``device='cpu'`` (its kernel wrappers run their plain versions on CPU
tensors); the JAX side rebuilds the driver's problem from the port's
`problem()` and runs under ``jax.jit`` in float32.  `long_horizon`'s three
solves (the 'defect' line search, the sequential one, multiple shooting)
are held to JAX's costs within 1e-4 relative, with JAX's engines where
the port's kernels run their plain versions ('pscan' for B1, 'xla' for
B3).  `ilqg_pendulum` is fed JAX's normal draws (the same key for both
policies, as the JAX driver) and held on its nominal costs (1e-4) and its
Monte-Carlo statistics (1e-3 relative; an exploding closed loop is inf in
both).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ilqg import control_multiplicative_noise as jax_noise
from ilqr_tpu.ilqg import simulate_closed_loop as jax_simulate
from ilqr_tpu.models.cartpole import make_cartpole as jax_cartpole
from ilqr_tpu.shooting import MsConfig as JaxMsConfig
from ilqr_tpu.shooting import solve_ms as jax_solve_ms

from ilqr_tpu_torch.utils import random as trandom

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture
def driver(monkeypatch):
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")

    def load(name):
        return importlib.import_module(f"examples_torch.{name}")
    return load


def _np(t):
    return t.detach().cpu().numpy()


def _jax_cfg(cfg, **engines):
    return it.IlqrConfig(maxiter=cfg.maxiter, tol=cfg.tol,
                         adaptive_reg=cfg.adaptive_reg,
                         init_rollout=cfg.init_rollout,
                         rollout=cfg.rollout, **engines)


def test_long_horizon_driver_matches_jax(driver):
    m = driver("long_horizon")
    out = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    prm = {k: float(_np(v)) if v.ndim == 0 else _np(v)
           for k, v in p.system.params.items()}
    sys_ = jax_cartpole(p.system.dt, prm["x_target"], prm["Q"], prm["R"],
                        prm["Q_f"], g=prm["g"], m_cart=prm["m_cart"],
                        m_pole=prm["m_pole"], l=prm["l"])
    x0, U0 = jnp.zeros(4), jnp.zeros(tuple(p.U0.shape))
    eng = dict(backward="pscan", defect_engine="xla")
    for got, cfg in ((out.sol, p.config), (out.sol_seq, p.config_seq)):
        ref = jax.jit(lambda x, U, c=_jax_cfg(cfg, **eng): it.solve(
            sys_, x, U, c))(x0, U0)
        assert got.iterations == int(ref.iterations)
        np.testing.assert_allclose(float(got.cost), float(ref.cost),
                                   rtol=RTOL)
    ref = jax.jit(lambda x, U: jax_solve_ms(
        sys_, x, U, config=_jax_cfg(p.config_ms, **eng),
        ms=JaxMsConfig(update_engine="xla")))(x0, U0)
    assert out.sol_ms.iterations == int(ref.iterations)
    np.testing.assert_allclose(float(out.sol_ms.cost), float(ref.cost),
                               rtol=RTOL)
    assert float(out.defect) <= 1e-5


def test_ilqg_pendulum_driver_matches_jax(driver, monkeypatch):
    m = driver("ilqg_pendulum")
    p = m.problem("cpu")
    prm = {k: float(_np(v)) if v.ndim == 0 else _np(v)
           for k, v in p.system.params.items()}
    sys_ = it.make_pendulum(p.system.dt, prm["x_target"], Q=prm["Q"],
                            R=prm["R"], Q_f=prm["Q_f"], g=prm["g"],
                            l=prm["l"], d=prm["d"], integrator="rk4")
    noise = jax_noise(p.sigma, jnp.array([[0.0], [1.0]]))
    N, x0 = p.U0.shape[0], jnp.zeros(2)
    key = jax.random.PRNGKey(p.seed)
    refs = {}
    for k, cfg in (("det", it.IlqrConfig(maxiter=p.config.maxiter,
                                         tol=p.config.tol)),
                   ("ilqg", it.IlqrConfig(maxiter=p.config.maxiter,
                                          tol=p.config.tol, noise=noise))):
        sol = jax.jit(lambda x, U, c=cfg: it.solve(sys_, x, U, c))(
            x0, jnp.zeros((N, 1)))
        refs[k] = (sol, jax.jit(lambda X, U, K: jax_simulate(
            sys_, noise, X, U, K, key, n_rollouts=p.n_rollouts))(
                sol.X, sol.U, sol.K))
    # JAX draws (N, n_w) per rollout key; the port (N, n_rollouts, n_w).
    draws = np.stack([np.asarray(jax.random.normal(k, (N, 1)))
                      for k in jax.random.split(key, p.n_rollouts)], axis=1)
    fed = iter([draws, draws])
    monkeypatch.setattr(trandom, "normal", lambda gen, shape, dt, dev: (
        torch.as_tensor(next(fed), dtype=dt, device=dev)))
    out = m.main(plot=False, device="cpu")
    assert next(fed, None) is None
    for k in ("det", "ilqg"):
        sol, (mean, std) = refs[k]
        np.testing.assert_allclose(float(getattr(out, k).cost),
                                   float(sol.cost), rtol=RTOL)
        got = [float(v) for v in getattr(out, f"{k}_stats")]
        for g, r in zip(got, (float(mean), float(std))):
            if np.isfinite(r):
                np.testing.assert_allclose(g, r, rtol=1e-3)
            else:
                assert not np.isfinite(g), (k, got, r)
    assert np.isfinite(got[0]) and got[1] > 0.0   # the iLQG policy's
