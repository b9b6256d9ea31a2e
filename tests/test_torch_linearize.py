"""The port's trajectory expansion against `ilqr_tpu.ops.linearize`.

Same numpy trajectories through both packages, in f32 and in f64 (JAX under
`enable_x64_oracle`).  The implicit integrators' Jacobians come from their
IFT tangent rules on both sides (`jax.custom_jvp` there,
`torch.autograd.Function.jvp` here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy

torch.set_num_threads(1)

FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")
# f32: the derivative programs differ between the frameworks (forward vs
# reverse mode, LU vs closed-form inverse in the IFT rule), a few ulp of the
# largest entry.  f64: agreement to rounding.
RTOL = {torch.float32: 2e-5, torch.float64: 1e-11}


def _jax_system(kind, integrator):
    if kind == "pendulum":
        return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                Q_f=10.0 * np.eye(2), d=0.0,
                                integrator=integrator)
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
        R=np.diag([1.0] if kind == "ua_dp" else [0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]), d1=0.1, d2=0.1,
        theta1=1 / 12, theta2=1 / 12, underactuated=kind == "ua_dp",
        integrator=integrator)


def _trajectory(n_x, n_u, N, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N + 1, n_x)), 0.5 * rng.normal(size=(N, n_u))


def _both(kind, integrator, dtype, N=24, seed=0):
    jsys = _jax_system(kind, integrator)
    Xn, Un = _trajectory(jsys.n_x, jsys.n_u, N, seed)
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    sys_ = system_from_numpy(
        "pendulum" if kind == "pendulum" else "double_pendulum", params,
        jsys.n_x, jsys.n_u, jsys.dt, integrator, dtype=dtype, device="cpu")
    exp = itt.linearize_trajectory(sys_, torch.tensor(Xn, dtype=dtype),
                                   torch.tensor(Un, dtype=dtype))
    if dtype == torch.float64:
        with enable_x64_oracle():
            j64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys)
            ref = jax.jit(jax_linearize)(j64, jnp.asarray(Xn), jnp.asarray(Un))
            ref = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    else:
        ref = jax.jit(jax_linearize)(jsys, jnp.asarray(Xn, jnp.float32),
                                     jnp.asarray(Un, jnp.float32))
        ref = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    return exp, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,integrator", [
    ("pendulum", "backward_euler"),
    ("dp", "euler"),
    ("dp", "trapezoidal"),
    ("ua_dp", "backward_euler"),
])
def test_expansion_matches_jax(kind, integrator, dtype):
    exp, ref = _both(kind, integrator, dtype)
    for f in FIELDS:
        got = getattr(exp, f)
        assert got.dtype == dtype, f"{f} came out {got.dtype}"
        assert got.is_contiguous()
        assert tuple(got.shape) == ref[f].shape
        scale = 1.0 + np.abs(ref[f]).max()
        np.testing.assert_allclose(got.numpy(), ref[f],
                                   atol=RTOL[dtype] * scale, err_msg=f)


def test_backward_euler_jacobian_is_the_ift_solution():
    """At the converged step x1 = x + dt f(x1, u), the Jacobians must solve
    (I - dt f_x(x1)) dx1/dx = I and (I - dt f_x(x1)) dx1/du = dt f_u(x1)."""
    sys_ = itt.make_double_pendulum(
        0.01, [np.pi, 0, 0, 0], Q=np.eye(4), R=np.eye(1), Q_f=np.eye(4),
        underactuated=True, integrator="backward_euler",
        dtype=torch.float64, device="cpu").replace(newton_iters=30)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=4))
    u = torch.tensor(rng.normal(size=1))
    x1 = itt.step(sys_, x, u)
    J_x, J_u = torch.func.jacfwd(lambda a, b: itt.step(sys_, a, b),
                                 argnums=(0, 1))(x, u)
    fx, fu = torch.func.jacfwd(lambda a, b: sys_.f_cont(sys_.params, a, b),
                               argnums=(0, 1))(x1, u)
    A = torch.eye(4, dtype=torch.float64) - 0.01 * fx
    np.testing.assert_allclose((A @ J_x).numpy(), np.eye(4), atol=1e-12)
    np.testing.assert_allclose((A @ J_u).numpy(), (0.01 * fu).numpy(),
                               atol=1e-12)
