"""The port's compat facade against `ilqr_tpu.compat`.

The four tests of tests/test_compat.py, each against the JAX facade on the
same inputs: the reference's pendulum swing-up (backward Euler, N = 400)
through `iLQR`, in f64 against JAX's f64 (X and U within 1e-6, the verbose
lines equal in count and text, their numbers within 1e-6) and in f32
against the reference's cost 23.435774; the U_init shape check; the 13
derivative functions at one (x, u) (1e-10 in f64, 1e-5 in f32); the
reference's MPC warm-start pattern (x_0 and U reassigned between solves).
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import compat as jax_compat
from ilqr_tpu.utils.x64 import enable_x64_oracle

from ilqr_tpu_torch import compat

torch.set_num_threads(1)

PENDULUM = dict(dt=0.01, x_target=[np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                Q_f=np.zeros((2, 2)), g=9.81, l=1.0, d=0.0,
                integrator="backward_euler")
T = 4.0
N = 400
NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


def _x64(dtype):
    return enable_x64_oracle() if dtype == torch.float64 else \
        contextlib.nullcontext()


def _run(make_solver, verbose):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        X, U, cost = make_solver(verbose).optimize_trajectory()
    return X, U, cost, out.getvalue().splitlines()


def _jax_golden(jdtype, verbose=False):
    sys_ = jax_compat.MyPendulum(**PENDULUM)
    return _run(lambda v: jax_compat.iLQR(
        sys_, T=T, x_0=jnp.array([1.0, 0.0], jdtype),
        U_init=jnp.zeros((1, N), jdtype), tol=1e-5, maxiter=100,
        verbose=v), verbose)


def _port_golden(dtype, verbose=False):
    sys_ = compat.MyPendulum(**PENDULUM, device="cpu", dtype=dtype)
    return _run(lambda v: compat.iLQR(
        sys_, T=T, x_0=[1.0, 0.0], U_init=torch.zeros((1, N), dtype=dtype),
        tol=1e-5, maxiter=100, verbose=v), verbose)


def test_reference_style_workflow_matches_jax():
    """The reference's usage pattern: warm-up through backward_pass and
    forward_pass, then optimize_trajectory in the (dim, time) layout."""
    dtype = torch.float64
    sys_ = compat.MyPendulum(**PENDULUM, use_jit=True, device="cpu",
                             dtype=dtype)
    solver = compat.iLQR(sys_, T=T, x_0=torch.tensor([1.0, 0.0]),
                         U_init=torch.zeros((1, N)), verbose=False)
    assert solver.N == N and solver.X.dtype == dtype
    U_ff, K = solver.backward_pass(torch.zeros_like(solver.X),
                                   torch.zeros_like(solver.U))
    assert U_ff.shape == (1, N) and K.shape == (N, 1, 2)
    X_f, U_f, c_f = solver.forward_pass(solver.x_0, 0.0, solver.X, solver.U,
                                        solver.U_ff, solver.K)
    assert X_f.shape == (2, N + 1) and U_f.shape == (1, N)

    X, U, cost, lines = _port_golden(dtype, verbose=True)
    with enable_x64_oracle():
        X_j, U_j, cost_j, lines_j = _jax_golden(jnp.float64, verbose=True)
        X_j, U_j, cost_j = map(np.asarray, (X_j, U_j, cost_j))
    assert X.shape == (2, N + 1) and U.shape == (1, N)
    np.testing.assert_allclose(X.numpy(), X_j, atol=1e-6)
    np.testing.assert_allclose(U.numpy(), U_j, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-9)
    # Verbose output: the same lines, numbers within 1e-6.
    assert len(lines) == len(lines_j) > 2, (lines, lines_j)
    for line, line_j in zip(lines, lines_j):
        assert NUMBER.sub("#", line) == NUMBER.sub("#", line_j)
        np.testing.assert_allclose(
            [float(v) for v in NUMBER.findall(line)],
            [float(v) for v in NUMBER.findall(line_j)], rtol=1e-6, atol=1e-6)
    assert lines[-1] == lines_j[-1]

    # f32: the reference's golden cost.
    _, _, cost32, _ = _port_golden(torch.float32)
    np.testing.assert_allclose(float(cost32), 23.435774, atol=1e-3)


def test_u_init_shape_validation():
    sys_ = compat.MyPendulum(dt=0.01, x_target=[np.pi, 0.0], Q=np.eye(2),
                             R=np.eye(1), Q_f=np.zeros((2, 2)), device="cpu")
    with pytest.raises(ValueError, match="U_init must have shape"):
        compat.iLQR(sys_, T=1.0, x_0=np.zeros(2), U_init=torch.zeros((100, 1)))


DP = dict(dt=0.01, x_target=[np.pi, 0, 0, 0], Q=np.eye(4), R=0.1 * np.eye(2),
          Q_f=np.eye(4), theta1=1 / 12, theta2=1 / 12)
FUNCTIONS = ("f_fcn", "f_x_fcn", "f_u_fcn", "l_fcn", "l_x_fcn", "l_u_fcn",
             "l_xx_fcn", "l_ux_fcn", "l_uu_fcn")
TERMINAL = ("l_f_fcn", "l_f_x_fcn", "l_f_xx_fcn")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_thirteen_function_surface_matches_jax(dtype, tol):
    x = np.array([0.3, -0.2, 0.5, 0.1])
    u = np.array([0.2, -0.4])
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    with _x64(dtype):
        ref_sys = jax_compat.MyDoublePendulum(**DP)
        xj, uj = jnp.asarray(x, jdtype), jnp.asarray(u, jdtype)
        ref = {name: np.asarray(getattr(ref_sys, name)(xj, uj))
               for name in FUNCTIONS}
        ref.update({name: np.asarray(getattr(ref_sys, name)(xj))
                    for name in TERMINAL})
    sys_ = compat.MyDoublePendulum(**DP, device="cpu", dtype=dtype)
    shapes = dict(f_fcn=(4,), f_x_fcn=(4, 4), f_u_fcn=(4, 2), l_fcn=(),
                  l_x_fcn=(4,), l_u_fcn=(2,), l_xx_fcn=(4, 4),
                  l_ux_fcn=(2, 4), l_uu_fcn=(2, 2), l_f_fcn=(),
                  l_f_x_fcn=(4,), l_f_xx_fcn=(4, 4))
    for name in FUNCTIONS + TERMINAL:
        args = (x, u) if name in FUNCTIONS else (x,)
        got = getattr(sys_, name)(*args)   # numpy in, tensors out
        assert got.shape == shapes[name] and got.dtype == dtype, name
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(got.numpy(), ref[name], rtol=0,
                                   atol=tol * scale, err_msg=name)
    assert sys_.system.n_u == 2 and sys_.use_jit
    ua = compat.MyUADoublePendulum(**{**DP, "R": 0.1 * np.eye(1)},
                                   device="cpu", dtype=dtype)
    assert ua.f_u_fcn(x, u[:1]).shape == (4, 1)


def test_mpc_pattern_warm_start_matches_jax():
    """The reference MPC pattern: x_0 and U reassigned between solves."""
    H = 100
    kw = dict(dt=0.01, x_target=[np.pi, 0.0], Q=np.diag([10.0, 1.0]),
              R=np.eye(1), Q_f=np.diag([10.0, 10.0]), d=0.0,
              integrator="backward_euler")

    def loop(sys_, solver, x, U, cat):
        xs = [x]
        for _ in range(5):
            solver.x_0 = x
            solver.U = U
            _, U_bar, _ = solver.optimize_trajectory()
            x = sys_.f_fcn(x, U_bar[:, 0])
            U = cat([U_bar[:, 1:], U_bar[:, -1:]], 1)
            xs.append(x)
        return np.stack([np.asarray(v) for v in xs])

    sys_ = compat.MyPendulum(**kw, device="cpu", dtype=torch.float64)
    solver = compat.iLQR(sys_, T=1.0, x_0=np.zeros(2),
                         U_init=torch.zeros((1, H)), maxiter=10,
                         verbose=False)
    xs = loop(sys_, solver, solver.x_0, solver.U, torch.cat)
    with enable_x64_oracle():
        sys_j = jax_compat.MyPendulum(**kw)
        solver_j = jax_compat.iLQR(sys_j, T=1.0, x_0=jnp.zeros(2),
                                   U_init=jnp.zeros((1, H)), maxiter=10,
                                   verbose=False)
        xs_j = loop(sys_j, solver_j, jnp.zeros(2), jnp.zeros((1, H)),
                    lambda a, axis: jnp.concatenate(a, axis=axis))
    assert np.all(np.isfinite(xs))
    np.testing.assert_allclose(xs, xs_j, atol=1e-6)
