"""The drivers of the solvers beyond iLQR (examples_torch/) in smoke mode,
against the JAX package on the same numpy data.

Each driver runs in this process under ``ILQR_TPU_SMOKE=1`` with
``device='cpu'`` (its kernel wrappers run their plain versions on CPU
tensors); the JAX side rebuilds the driver's problem from the port's
`problem()` and runs under ``jax.jit`` in float32.  The inverse optimal
control driver is held to JAX's loss and gradient (its expert's system
from the JAX driver's own `make_system`), the MPPI driver is fed JAX's
normal draws and held on its three controllers, the estimation driver's
four estimators are held to JAX's on the port's record.  Tolerances are
stated at each check.
"""
import importlib
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import estimation as jest
from ilqr_tpu import estimation_parallel as jep
from ilqr_tpu import mppi as jm
from ilqr_tpu.diff import solve_implicit as jax_solve_implicit
from ilqr_tpu.mpc import run_mpc as jax_run_mpc

from ilqr_tpu_torch.utils import random as trandom

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture
def driver(monkeypatch):
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")

    def load(name):
        return importlib.import_module(f"examples_torch.{name}")
    return load


def _jax_example(name):
    """A JAX driver of examples/ as a module (its `_smoke` beside it)."""
    sys.path.insert(0, str(EXAMPLES))
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_example_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(EXAMPLES))
    return mod


def _np(t):
    return t.detach().cpu().numpy()


def _jnp(t):
    return jnp.asarray(_np(t))


def _jax_cfg(cfg):
    return it.IlqrConfig(maxiter=cfg.maxiter, tol=cfg.tol, u_min=cfg.u_min,
                         u_max=cfg.u_max)


def test_inverse_optimal_control_driver_matches_jax(driver):
    """The demonstrations within 5e-4 of scale, the loss and gradient at
    the start and the weights after the smoke descent (2 backtracked
    steps) within 1e-3 relative: both packages' f32 smoke solves stop at
    maxiter 10, short of convergence (seen: demonstrations 1e-4 of scale
    apart), and the IFT gradient inherits each package's iterate."""
    m = driver("inverse_optimal_control")
    res = m.main(plot=False, device="cpu")
    p = m.problem("cpu")
    jioc = _jax_example("inverse_optimal_control")
    cfg = _jax_cfg(p.config)
    x0s, U0 = _jnp(p.x0s), _jnp(p.U0)
    demo = jax.jit(jax.vmap(lambda x0: it.solve(
        jioc.make_system(_jnp(p.log_w_true)), x0, U0, cfg).U))(x0s)
    np.testing.assert_allclose(_np(res.demo_U), np.asarray(demo), rtol=0,
                               atol=5e-4 * float(jnp.abs(demo).max()))

    def loss(log_w):
        sys_ = jioc.make_system(log_w)
        Us = jax.vmap(lambda x0: jax_solve_implicit(sys_, x0, U0, cfg).U)(x0s)
        return jnp.mean((Us - demo) ** 2)
    grad_fn = jax.jit(jax.value_and_grad(loss))
    log_w, lr = jnp.zeros(3), 1.0
    val, g = grad_fn(log_w)
    np.testing.assert_allclose(float(res.first_loss), float(val), rtol=1e-3)
    np.testing.assert_allclose(_np(res.first_grad), np.asarray(g), rtol=1e-3,
                               atol=1e-3 * float(jnp.abs(g).max()))
    for _ in range(p.outer_steps):
        cand = log_w - lr * g
        val_c, g_c = grad_fn(cand)
        if val_c < val:
            log_w, val, g, lr = cand, val_c, g_c, min(lr * 1.5, 4.0)
        else:
            lr *= 0.3
    np.testing.assert_allclose(_np(res.log_w), np.asarray(log_w), rtol=1e-3,
                               atol=1e-4)


def test_mppi_driver_matches_jax(driver, monkeypatch):
    """Fed JAX's draws (key 0 for both MPPI runs, as the JAX driver): the
    MPPI MPC's states and controls within 1e-4 of scale, every cost within
    1e-4 relative (iLQR's MPC and solves: the f32 box-QP solves of both
    packages)."""
    m = driver("mppi_pendulum")
    p = m.problem("cpu")
    sys_ = it.make_pendulum(0.05, [jnp.pi, 0.0],
                            Q=jnp.diag(jnp.array([5.0, 0.5])),
                            R=0.1 * jnp.eye(1),
                            Q_f=jnp.diag(jnp.array([50.0, 5.0])),
                            integrator="rk4")
    plant = sys_.with_integrator("midpoint")
    key = jax.random.key(0)
    mc = jm.MppiConfig(**{f: getattr(p.mppi_config, f) for f in
                          p.mppi_config.__dataclass_fields__})
    ec = jm.MppiConfig(**{f: getattr(p.explore_config, f) for f in
                          p.explore_config.__dataclass_fields__})
    N_h, N_ol = p.U0.shape[0], p.U0_ol.shape[0]
    x0 = jnp.zeros(2)
    mpc = jax.jit(lambda k: jm.run_mpc_mppi(
        sys_, plant, x0, jnp.zeros((N_h, 1)), p.n_sim, k, mc))(key)
    ilqr = jax.jit(lambda x: jax_run_mpc(sys_, plant, x, jnp.zeros((N_h, 1)),
                                         p.n_sim, _jax_cfg(p.ilqr_config)))(x0)
    warm = jax.jit(lambda k: jm.solve_mppi(sys_, x0, jnp.zeros((N_ol, 1)), k,
                                           ec))(key)
    ol = _jax_cfg(p.ol_config)
    polish = jax.jit(lambda u: it.solve(sys_, x0, u, ol))(warm.U)
    zeros = jax.jit(lambda u: it.solve(sys_, x0, u, ol))(jnp.zeros((N_ol, 1)))

    draws = [np.asarray(jax.random.normal(kk, (mc.samples, N_h, 1)))
             for k in jax.random.split(key, p.n_sim)
             for kk in jax.random.split(k, mc.iters)]
    draws += [np.asarray(jax.random.normal(k, (ec.samples, N_ol, 1)))
              for k in jax.random.split(key, ec.iters)]
    fed = iter(draws)
    monkeypatch.setattr(trandom, "normal", lambda gen, shape, dt, dev: (
        torch.as_tensor(next(fed), dtype=dt, device=dev)))
    out = m.main(plot=False, device="cpu")
    assert next(fed, None) is None
    for got, ref in ((out.mppi_mpc.X, mpc.X), (out.mppi_mpc.U, mpc.U),
                     (out.explore.U, warm.U)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                                   atol=1e-4 * max(1.0, float(
                                       jnp.abs(ref).max())))
    for got, ref in ((out.mppi_mpc, mpc), (out.ilqr_mpc, ilqr),
                     (out.explore, warm), (out.polish, polish),
                     (out.from_zeros, zeros)):
        np.testing.assert_allclose(float(got.cost), float(ref.cost),
                                   rtol=1e-4)


def test_parallel_estimation_driver_matches_jax(driver):
    """The four estimators at the smoke record (N = 512) against JAX's on
    the same record: estimates within 5e-4 of scale (float32; the parallel
    scans associate otherwise than XLA's), RMS-to-truth within 1 %."""
    m = driver("parallel_estimation")
    out = m.main(512, device="cpu", reps=1)
    p = m.problem(512, "cpu")
    js = it.make_pendulum(0.001, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                          Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")
    s0 = jest.EkfState(_jnp(p.s0.x_hat), _jnp(p.s0.P))
    Qp, Ro = _jnp(p.Q_proc), _jnp(p.R_obs)

    def obs(x):
        return x[:1]
    refs = jax.jit(lambda U, Y: {
        "EKF  sequential": jest.run_ekf(js, obs, s0, U, Y, Qp, Ro)[1],
        "EKF  parallel": jep.run_ekf_parallel(js, obs, s0, U, Y, Qp, Ro)[0],
        "EKS  sequential": jest.run_eks(js, obs, s0, U, Y, Qp, Ro)[0],
        "EKS  parallel(2)": jep.run_eks_parallel(js, obs, s0, U, Y, Qp, Ro,
                                                 iters=2)[0],
    })(_jnp(p.U), _jnp(p.Y))
    X_true = _np(p.X_true)[1:]
    assert sorted(out) == sorted(refs)
    for name, ref in refs.items():
        Xh, _, rms = out[name]
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(Xh), ref, rtol=0,
                                   atol=5e-4 * float(np.abs(ref).max()))
        rms_j = float(np.sqrt(np.mean((ref - X_true) ** 2)))
        assert abs(rms - rms_j) <= 1e-2 * rms_j, name
