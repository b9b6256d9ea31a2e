"""The learned-dynamics driver (examples_torch/neural_sysid.py) in smoke
mode, against the JAX package on the same numpy data.

The driver runs under ``ILQR_TPU_SMOKE=1`` with ``device='cpu'`` (its
kernel wrappers run their plain versions on CPU tensors).  JAX refits its
own residual from the port's initial layers on the port's excitation data
(optax's adam in float32, the driver's 20 smoke steps) and runs the three
closed loops with `ilqr_tpu.mpc.run_mpc` under ``jax.jit``.  Tolerances:
the loss trace within 1e-4 relative, the fitted layers within 1e-4 of
their scale, each closed-loop cost within 1e-3 relative (float32 solves of
both packages on a fitted model).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.models import neural as jn
from ilqr_tpu.mpc import run_mpc as jax_run_mpc

torch.set_num_threads(1)


@pytest.fixture
def driver(monkeypatch):
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")
    return importlib.import_module("examples_torch.neural_sysid")


def _np(t):
    return t.detach().cpu().numpy()


def _jax_pendulum(d, l):
    return it.make_pendulum(
        0.05, [jnp.pi, 0.0], Q=jnp.diag(jnp.array([5.0, 0.5])),
        R=0.1 * jnp.eye(1), Q_f=jnp.diag(jnp.array([50.0, 5.0])), d=d, l=l,
        integrator="rk4")


def test_excitation_draws_are_jax_drivers(driver):
    """`JAX_DRAWS` are examples/neural_sysid.py's draws, bit for bit."""
    k1, k2, k3, k4 = jax.random.split(jax.random.key(0), 4)
    B = 32
    ref = dict(
        amps=jax.random.uniform(k1, (B, 1, 1), minval=1.0, maxval=6.0),
        freqs=jax.random.uniform(k2, (B, 1, 1), minval=0.5, maxval=3.0),
        theta0=jax.random.uniform(k3, (B, 1), minval=-3.0, maxval=3.0),
        omega0=jax.random.uniform(k4, (B, 1), minval=-4.0, maxval=4.0))
    for k, v in ref.items():
        np.testing.assert_array_equal(
            np.asarray(driver.JAX_DRAWS[k], np.float32), np.asarray(v).ravel())


def test_neural_sysid_driver_matches_jax(driver):
    out = driver.main(device="cpu")
    p = driver.problem("cpu")
    plant, nominal = _jax_pendulum(0.5, 1.0), _jax_pendulum(0.0, 1.6)
    jnet = jn.make_neural_residual(nominal, hidden=(32, 32))
    jnet = jnet.replace(params={**jnet.params, "mlp": [
        {k: jnp.asarray(_np(v)) for k, v in layer.items()}
        for layer in p.net.params["mlp"]]})
    X, U = jnp.asarray(_np(p.X)), jnp.asarray(_np(p.U))
    np.testing.assert_allclose(
        float(out.loss0), float(jn.prediction_loss(jnet, X, U, horizon=10)),
        rtol=1e-5)
    jfit, jlosses = jn.fit_dynamics(jnet, X, U, **p.fit)
    np.testing.assert_allclose(_np(out.losses), np.asarray(jlosses),
                               rtol=1e-4)
    for got, ref in zip(out.net.params["mlp"], jfit.params["mlp"]):
        for k in ("W", "b"):
            r = np.asarray(ref[k])
            np.testing.assert_allclose(_np(got[k]), r, rtol=0,
                                       atol=1e-4 * max(np.abs(r).max(), 1.0))
    cfg = it.IlqrConfig(maxiter=p.config.maxiter, tol=p.config.tol)
    x0, U0 = jnp.zeros(2), jnp.zeros(tuple(p.U0.shape))
    for name, model in (("nominal", nominal), ("learned", jfit),
                        ("oracle", plant)):
        ref = jax.jit(lambda x: jax_run_mpc(model, plant, x, U0, p.n_sim,
                                            cfg))(x0)
        np.testing.assert_allclose(float(out.mpc[name].cost),
                                   float(ref.cost), rtol=1e-3, err_msg=name)
