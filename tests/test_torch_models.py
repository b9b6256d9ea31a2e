"""The PyTorch port's models, integrators and costs against ilqr_tpu.

Every input is made with numpy from a seed and goes through both packages:
the JAX models from `ilqr_tpu.models`, the port's from the same numpy
parameters through `ilqr_tpu_torch.convert`.  Comparisons run in f32 and in
f64 (JAX under `enable_x64_oracle`), plus the reference's own samples in
`tests/golden/dynamics_samples.npz`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.integrators import step as jax_step
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import params_from_numpy, system_from_numpy

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "dynamics_samples.npz")
INTEGRATORS = ("euler", "midpoint", "rk4", "backward_euler", "trapezoidal",
               "discrete")
# f32: both packages evaluate the same formulas in float32, in other
# operation orders (and the implicit rules invert their stale Jacobian by LU
# here, by closed form in JAX); a few ulp of O(10) values.  f64: the same
# formulas agree to rounding.
ATOL = {torch.float32: 5e-5, torch.float64: 1e-11}


def _jax_dp(integrator, underactuated=False):
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0],
        Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1] * (1 if underactuated else 2)),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        g=9.81, m1=1.0, m2=1.3, l1=1.0, l2=0.8, d1=0.1, d2=0.2,
        theta1=1.0 / 12.0, theta2=1.3 * 0.8**2 / 12.0,
        underactuated=underactuated, integrator=integrator)


def _jax_pendulum(integrator):
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=10.0 * np.eye(2), d=0.05,
                            integrator=integrator)


def _port(jsys, kind, dtype):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


CASES = [
    ("pendulum", lambda integ: _jax_pendulum(integ)),
    ("double_pendulum", lambda integ: _jax_dp(integ)),
    ("double_pendulum", lambda integ: _jax_dp(integ, underactuated=True)),
]


def _samples(n_x, n_u, seed=0, n=16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, n_x)), rng.normal(size=(n, n_u))


def _jax_eval(jsys, xs, us, dtype):
    """step, stage cost and terminal cost of the JAX system, as numpy."""
    @jax.jit
    def run(jsys, x, u):
        f = jax.vmap(lambda a, b: jax_step(jsys, a, b))(x, u)
        l = jax.vmap(lambda a, b: jsys.stage_cost(jsys.params, a, b))(x, u)
        lf = jax.vmap(lambda a: jsys.terminal_cost(jsys.params, a))(x)
        return f, l, lf

    if dtype == jnp.float64:
        with enable_x64_oracle():
            jsys = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys)
            out = run(jsys, jnp.asarray(xs, dtype), jnp.asarray(us, dtype))
            return tuple(np.asarray(a) for a in out)
    out = run(jsys, jnp.asarray(xs, dtype), jnp.asarray(us, dtype))
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("integ", INTEGRATORS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_step_and_costs_match_jax(case, integ, dtype):
    kind, make = CASES[case]
    jsys = make(integ)
    sys_ = _port(jsys, kind, dtype)
    xs, us = _samples(jsys.n_x, jsys.n_u, seed=case)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    f_ref, l_ref, lf_ref = _jax_eval(jsys, xs, us, jdt)

    x = torch.tensor(xs, dtype=dtype)
    u = torch.tensor(us, dtype=dtype)
    f = itt.step(sys_, x, u)                       # batched states
    f_one = torch.stack([itt.step(sys_, a, b) for a, b in zip(x, u)])
    l = sys_.stage_cost(sys_.params, x, u)
    lf = sys_.terminal_cost(sys_.params, x)
    assert f.dtype == dtype and l.dtype == dtype
    scale = 1.0 + np.abs(f_ref).max()
    np.testing.assert_allclose(f.numpy(), f_ref, atol=ATOL[dtype] * scale)
    np.testing.assert_allclose(f_one.numpy(), f.numpy(),
                               atol=ATOL[dtype] * scale)
    np.testing.assert_allclose(l.numpy(), l_ref, rtol=ATOL[dtype])
    np.testing.assert_allclose(lf.numpy(), lf_ref, rtol=ATOL[dtype])


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_system():
    # The parameters of tests/golden/make_golden.py::dynamics_samples.
    return _port(_jax_dp("euler"), "double_pendulum", torch.float32)


@pytest.mark.parametrize("integ", ["euler", "midpoint", "rk4",
                                   "backward_euler"])
def test_dynamics_and_jacobians_match_reference_samples(golden, integ):
    """The reference implementation's own values (same tolerances as
    tests/test_model_parity.py: it ran its models in float32)."""
    sys_ = _golden_system().with_integrator(integ)
    xs = torch.tensor(golden["xs"])
    us = torch.tensor(golden["us"])
    f = itt.step(sys_, xs, us)
    f_x, f_u = torch.func.vmap(torch.func.jacfwd(
        lambda a, b: itt.step(sys_, a, b), argnums=(0, 1)))(xs, us)
    np.testing.assert_allclose(f.numpy(), golden[f"f_{integ}"], atol=2e-4)
    np.testing.assert_allclose(f_x.numpy(), golden[f"fx_{integ}"], atol=2e-3)
    np.testing.assert_allclose(f_u.numpy(), golden[f"fu_{integ}"], atol=2e-3)


def test_costs_match_reference_samples(golden):
    sys_ = _golden_system()
    xs = torch.tensor(golden["xs"])
    us = torch.tensor(golden["us"])
    l = sys_.stage_cost(sys_.params, xs, us)
    lf = sys_.terminal_cost(sys_.params, xs)
    np.testing.assert_allclose(l.numpy(), golden["l"], rtol=1e-5)
    np.testing.assert_allclose(lf.numpy(), golden["l_f"], rtol=1e-5)


def test_constructors_match_jax_parameters():
    """make_* builds the same parameter set as the JAX constructors."""
    for jsys, port in (
        (_jax_pendulum("rk4"),
         itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                           Q_f=10.0 * np.eye(2), d=0.05,
                           dtype=torch.float64, device="cpu")),
        (_jax_dp("euler", underactuated=True),
         itt.make_double_pendulum(
             0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
             R=np.diag([0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
             m2=1.3, l2=0.8, d1=0.1, d2=0.2, theta1=1.0 / 12.0,
             theta2=1.3 * 0.8**2 / 12.0, underactuated=True,
             integrator="euler", dtype=torch.float64, device="cpu")),
    ):
        assert (port.n_x, port.n_u, port.dt) == (jsys.n_x, jsys.n_u, jsys.dt)
        assert sorted(port.params) == sorted(jsys.params)
        for k, v in jsys.params.items():
            np.testing.assert_allclose(port.params[k].numpy(), np.asarray(v),
                                       rtol=1e-7, err_msg=k)


def test_system_replace_and_integrator_validation():
    sys_ = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.eye(2), device="cpu")
    assert sys_.with_integrator("midpoint").integrator == "midpoint"
    assert sys_.replace(dt=0.02).dt == 0.02
    with pytest.raises(ValueError, match="Unknown integrator"):
        sys_.with_integrator("leapfrog")
    with pytest.raises(ValueError, match="Unknown integrator"):
        itt.step(sys_.replace(integrator="leapfrog"), torch.zeros(2),
                 torch.zeros(1))


def test_full_f32_matmuls_scopes_and_restores_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with itt.full_f32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_params_from_numpy_device_and_dtype():
    p = params_from_numpy({"a": np.arange(3.0), "b": np.float32(2.0)},
                          dtype=torch.float64, device="cpu")
    assert p["a"].dtype == torch.float64 and p["b"].shape == ()
    assert p["a"].device.type == "cpu"


def test_factories_default_to_the_gpu_and_entry_points_follow_the_system():
    """The model factories and `convert.py` build on 'cuda' unless told
    otherwise (without CUDA such a build fails as torch fails, never on the
    CPU by itself); `solve`, `solve_batch` and `run_mpc` run on the system's
    device and dtype whatever their inputs are (numpy arrays here), and a
    system whose parameters span devices raises."""
    import inspect

    from ilqr_tpu_torch import convert

    for fn in (itt.make_pendulum, itt.make_double_pendulum,
               itt.quadratic_cost_params, convert.params_from_numpy,
               convert.system_from_numpy, convert.expansion_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                              Q_f=np.eye(2))
    sys_ = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.eye(2), dtype=torch.float64, device="cpu")
    assert sys_.device == torch.device("cpu") and sys_.dtype == torch.float64
    cfg = itt.IlqrConfig(maxiter=3)
    sol = itt.solve(sys_, np.array([1.0, 0.0]), np.zeros((20, 1)), cfg)
    ref = itt.solve(sys_, torch.tensor([1.0, 0.0], dtype=torch.float64),
                    torch.zeros((20, 1), dtype=torch.float64), cfg)
    for t in (sol.X, sol.U, sol.K, sol.cost_trace):
        assert t.device == sys_.device and t.dtype == torch.float64
    assert torch.equal(sol.U, ref.U)
    # f32 tensors move to the system's dtype as well.
    sol32 = itt.solve(sys_, torch.tensor([1.0, 0.0]), torch.zeros((20, 1)),
                      cfg)
    assert torch.equal(sol32.U, ref.U)
    batch = itt.solve_batch(sys_, np.zeros((2, 2)), np.zeros((20, 1)), cfg)
    assert batch.X.dtype == torch.float64 and batch.X.shape == (2, 21, 2)
    mpc = itt.run_mpc(sys_, sys_, np.array([1.0, 0.0]), np.zeros((10, 1)), 2,
                      itt.IlqrConfig(maxiter=2))
    assert mpc.X.device == sys_.device and mpc.X.dtype == torch.float64
    mixed = sys_.replace(params={**sys_.params,
                                 "g": sys_.params["g"].to("meta")})
    with pytest.raises(ValueError, match="span devices"):
        itt.solve(mixed, np.zeros(2), np.zeros((5, 1)), cfg)
