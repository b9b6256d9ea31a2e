"""The port's example drivers (examples_torch/) in smoke mode, against the
JAX package's API on the same problems: the five reference workloads here,
the two constrained drivers in test_torch_examples_constrained.py.

Every driver runs in this process under ``ILQR_TPU_SMOKE=1`` with
``device='cpu'`` and ``plot=False`` (its kernel engines run their plain
versions on CPU tensors), and its final cost is held within 1e-4 relative
to `ilqr_tpu` solving the driver's own `problem()` in f32: JAX systems,
constraint sets and configs are rebuilt from the port's parameters (the
JAX side runs its 'auto' engines, sequential on the CPU).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc

torch.set_num_threads(1)

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples_torch")
DRIVERS = sorted(f[:-3] for f in os.listdir(EXAMPLES_DIR)
                 if f.endswith(".py") and not f.startswith("_"))
RTOL = 1e-4


def test_driver_inventory():
    # The five reference workloads, the two constrained drivers, the six
    # drivers of the other model families (test_torch_examples_models.py),
    # the three of the solvers beyond iLQR
    # (test_torch_examples_solvers.py), the batched surface's
    # (test_torch_batch_options.py), the long-horizon and iLQG drivers
    # (test_torch_examples_parallel.py) and the learned-dynamics driver
    # (test_torch_examples_learned.py).
    assert DRIVERS == sorted([
        "pendulum_open_loop", "double_pendulum_open_loop",
        "ua_double_pendulum_open_loop", "pendulum_mpc",
        "double_pendulum_mpc", "constrained_pendulum", "constrained_mpc",
        "quadrotor3d_flight", "quadrotor_dash", "car_obstacles",
        "linear_lqr", "tvlqr_tracking", "reference_tracking_mpc",
        "inverse_optimal_control", "mppi_pendulum", "parallel_estimation",
        "batched_mpc", "long_horizon", "ilqg_pendulum", "neural_sysid"])


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")

    def load(name):
        return importlib.import_module(f"examples_torch.{name}")
    return load


def _np(t):
    return t.detach().cpu().numpy()


def _jax_system(sys_):
    """The JAX twin of a port pendulum or double-pendulum system, with the
    same (f32) parameters."""
    p = {k: _np(v) for k, v in sys_.params.items()}
    f = {k: float(v) for k, v in p.items() if v.ndim == 0 and k != "dt"}
    cost = (p["x_target"], p["Q"], p["R"], p["Q_f"])
    if sys_.n_x == 2:
        return it.make_pendulum(sys_.dt, *cost, g=f["g"], l=f["l"], d=f["d"],
                                integrator=sys_.integrator)
    return it.make_double_pendulum(sys_.dt, *cost, underactuated=sys_.n_u == 1,
                                   integrator=sys_.integrator, **f)


def _jax_config(cfg):
    """The port's config with the JAX package's default engines."""
    return it.IlqrConfig(maxiter=cfg.maxiter, tol=cfg.tol, alpha0=cfg.alpha0,
                         alpha_factor=cfg.alpha_factor, n_alphas=cfg.n_alphas,
                         min_alpha=cfg.min_alpha, reg_init=cfg.reg_init,
                         u_min=cfg.u_min, u_max=cfg.u_max)


def _jnp(t):
    return jnp.asarray(_np(t))


def _close(got, ref):
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.mark.parametrize("name", ["pendulum_open_loop",
                                  "double_pendulum_open_loop",
                                  "ua_double_pendulum_open_loop"])
def test_open_loop_driver_matches_jax(smoke, name):
    mod = smoke(name)
    sol = mod.main(plot=False, device="cpu", reps=1)
    p = mod.problem("cpu")
    ref = jax.jit(lambda x, U: it.solve(_jax_system(p.system), x, U,
                                        _jax_config(p.config)))(
        _jnp(p.x0), _jnp(p.U0))
    assert sol.status == int(ref.status)
    assert sol.iterations == int(ref.iterations)
    _close(sol.cost, ref.cost)


def _jax_mpc(p, n_sim=None):
    return jax.jit(lambda x, U: jax_mpc.run_mpc(
        _jax_system(p.solver), _jax_system(p.plant), x, U,
        p.n_sim if n_sim is None else n_sim, _jax_config(p.config)))(
        _jnp(p.x0), _jnp(p.U0))


def test_pendulum_mpc_driver_matches_jax(smoke):
    """Also at a cut step count, as chip_smoke.py cuts the loops."""
    mod = smoke("pendulum_mpc")
    res = mod.main(plot=False, device="cpu", reps=1, n_sim=4)
    ref = _jax_mpc(mod.problem("cpu"), n_sim=4)
    assert res.X.shape == ref.X.shape == (5, 2)
    np.testing.assert_array_equal(_np(res.solve_iters), ref.solve_iters)
    _close(res.cost, ref.cost)


def test_double_pendulum_mpc_driver_matches_jax(smoke):
    mod = smoke("double_pendulum_mpc")
    out = mod.main(plot=False, device="cpu", reps=(1, 1))
    for key, ua in (("fa", False), ("ua", True)):
        ref = _jax_mpc(mod.problem("cpu", underactuated=ua))
        # f32 iteration counts part at the tol boundary (3 against 2 in
        # one UA step); the closed-loop costs agree.
        _close(out[key].cost, ref.cost)
