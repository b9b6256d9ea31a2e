"""The port's filters and smoother (ilqr_tpu_torch.estimation) against the
JAX package's (ilqr_tpu.estimation) on the same numpy records.

Two records: a damped oscillator (LTI, euler, position observed) and the
pendulum (rk4, angle observed), both made from numpy seeds and fed to both
packages in float64 and float32.  JAX runs under ``jax.jit``.  Tolerances:
float64 1e-9 of scale (the same recursions in another operation order);
float32 2e-4 of scale on the filters (the EKF's Joseph update and the
UKF's sigma points round differently over 40 steps) and 2e-3 on the
smoother's covariances (its gain solves Pp⁻¹, amplifying that rounding).
`simulate_output_feedback` is fed JAX's own noise draws through the
port's draw function (`utils.random.normal`).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import estimation as jest
from ilqr_tpu.models.linear import make_lti as jax_make_lti
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import estimation as pest
from ilqr_tpu_torch.utils import random as trandom

torch.set_num_threads(1)

N = 40
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-9, 1e-9),
          "f32": (torch.float32, jnp.float32, 2e-4, 2e-3)}
A_OSC = np.array([[0.0, 1.0], [-1.0, -0.2]])
B_OSC = np.array([[0.0], [1.0]])


def _record(kind, seed=3):
    """(U, Y, Q_proc, R_obs, x0, P0) in f64 numpy: the true trajectory
    from the noisy dynamics (numpy noise, JAX f64 steps), then noisy
    observations of it."""
    rng = np.random.default_rng(seed)
    U = 0.5 * rng.standard_normal((N, 1))
    Qp = np.diag([1e-4, 1e-4]) if kind == "osc" else np.diag([1e-6, 1e-6])
    Ro = np.array([[0.04]]) if kind == "osc" else np.array([[1e-3]])
    W = rng.standard_normal((N, 2)) @ np.sqrt(Qp)
    V = rng.standard_normal((N, 1)) @ np.sqrt(Ro)
    with enable_x64_oracle():
        js = _jax_system(kind, jnp.float64)
        x = jnp.array([0.4, -0.3])
        xs = []
        for k in range(N):
            x = it.step(js, x, jnp.asarray(U[k])) + W[k]
            xs.append(np.asarray(x))
    Y = np.stack(xs)[:, :1] + V
    return U, Y, Qp, Ro, np.array([0.3, 0.0]), 0.5 * np.eye(2)


def _jax_system(kind, jdt):
    if kind == "osc":
        return jax_make_lti(jnp.asarray(A_OSC, jdt), jnp.asarray(B_OSC, jdt),
                            0.05, [0.0, 0.0], jnp.eye(2, dtype=jdt),
                            jnp.eye(1, dtype=jdt), jnp.zeros((2, 2), jdt),
                            integrator="euler")
    return it.make_pendulum(0.02, jnp.array([np.pi, 0.0], jdt),
                            Q=jnp.eye(2, dtype=jdt), R=jnp.eye(1, dtype=jdt),
                            Q_f=jnp.zeros((2, 2), jdt), d=0.05,
                            integrator="rk4")


def _port_system(kind, dtype):
    if kind == "osc":
        return itt.make_lti(A_OSC, B_OSC, 0.05, [0.0, 0.0], np.eye(2),
                            np.eye(1), np.zeros((2, 2)), integrator="euler",
                            device="cpu", dtype=dtype)
    return itt.make_pendulum(0.02, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.05, integrator="rk4",
                             device="cpu", dtype=dtype)


def obs(x):
    return x[:1]


def _jax_run(fn_name, kind, jdt, rec):
    U, Y, Qp, Ro, x0, P0 = (jnp.asarray(a, jdt) for a in rec)
    js = _jax_system(kind, jdt)
    fn = getattr(jest, fn_name)
    return jax.jit(lambda U, Y: fn(js, obs, jest.EkfState(x0, P0), U, Y,
                                   Qp, Ro))(U, Y)


def _port_run(fn_name, kind, dtype, rec):
    U, Y, Qp, Ro, x0, P0 = rec
    ps = _port_system(kind, dtype)
    return getattr(pest, fn_name)(ps, obs, pest.EkfState(x0, P0), U, Y,
                                   Qp, Ro)


def _close(got, ref, tol, what):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3g}"


def _jax_ctx(name):
    return enable_x64_oracle() if name == "f64" else contextlib.nullcontext()


@pytest.mark.parametrize("kind", ["osc", "pendulum"])
@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("fn_name", ["run_ekf", "run_ukf"])
def test_filters_match_jax(fn_name, name, kind):
    dtype, jdt, tol, _ = DTYPES[name]
    rec = _record(kind)
    with _jax_ctx(name):
        s_j, X_j, P_j = _jax_run(fn_name, kind, jdt, rec)
    s_t, X_t, P_t = _port_run(fn_name, kind, dtype, rec)
    assert X_t.dtype == dtype and X_t.shape == (N, 2) and P_t.shape == (N, 2, 2)
    _close(X_t, X_j, tol, f"{fn_name} X_hat")
    _close(P_t, P_j, tol, f"{fn_name} P")
    _close(s_t.x_hat, s_j.x_hat, tol, f"{fn_name} final state")


@pytest.mark.parametrize("kind", ["osc", "pendulum"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_smoother_matches_jax(name, kind):
    dtype, jdt, tol, tol_p = DTYPES[name]
    rec = _record(kind)
    with _jax_ctx(name):
        X_j, P_j = _jax_run("run_eks", kind, jdt, rec)
    X_t, P_t = _port_run("run_eks", kind, dtype, rec)
    _close(X_t, X_j, tol, "EKS X_s")
    _close(P_t, P_j, tol_p, "EKS P_s")


def _lqg_inputs():
    """The pendulum's open-loop plan with small gains around it."""
    rng = np.random.default_rng(5)
    U_ref = 0.3 * rng.standard_normal((N, 1))
    with enable_x64_oracle():
        X_ref = np.asarray(it.rollout(_jax_system("pendulum", jnp.float64),
                                      jnp.array([0.3, 0.0]),
                                      jnp.asarray(U_ref))[0])
    K = np.tile(np.array([[[-2.0, -0.5]]]), (N, 1, 1))
    return X_ref, U_ref, K


@pytest.mark.parametrize("filt", ["ekf_step", "ukf_step"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_output_feedback_matches_jax_on_jax_draws(monkeypatch, name, filt):
    dtype, jdt, tol, _ = DTYPES[name]
    X_ref, U_ref, K = _lqg_inputs()
    Qp, Ro = np.diag([1e-4, 1e-4]), np.array([[1e-3]])
    x0_true, P0 = np.array([0.35, 0.05]), 0.01 * np.eye(2)
    key = jax.random.key(9)
    with _jax_ctx(name):
        args = [jnp.asarray(a, jdt) for a in (X_ref, U_ref, K, x0_true, Qp,
                                               Ro, X_ref[0], P0)]
        js = _jax_system("pendulum", jdt)

        def run(X_ref, U_ref, K, x0_true, Qp, Ro, m0, P0, key):
            return jest.simulate_output_feedback(
                js, obs, X_ref, U_ref, K, jest.EkfState(m0, P0), x0_true,
                key, Qp, Ro, filter_step=getattr(jest, filt))
        ref = jax.jit(run)(*args, key)
        kw, kv = jax.random.split(key)
        draws = [np.asarray(jax.random.normal(kw, (N, 2), jdt)),
                 np.asarray(jax.random.normal(kv, (N, 1), jdt))]
    fed = iter(draws)
    monkeypatch.setattr(trandom, "normal", lambda gen, shape, dt, dev: (
        torch.as_tensor(next(fed), dtype=dt, device=dev)))
    ps = _port_system("pendulum", dtype)
    got = pest.simulate_output_feedback(
        ps, obs, X_ref, U_ref, K, pest.EkfState(X_ref[0], P0), x0_true, 0,
        Qp, Ro, filter_step=getattr(pest, filt))
    for g, r, what in zip(got, ref, ("X_true", "X_hat", "U", "cost")):
        _close(g, r, tol, what)


def test_non_positive_definite_covariance_gives_nan():
    """jnp.linalg.cholesky returns NaN in the lower triangle where the
    matrix is not positive definite; the port's factor does the same,
    without an exception."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    L_j = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    L_t = pest.cholesky(torch.as_tensor(bad))
    assert np.isnan(L_j[np.tril_indices(2)]).all()
    np.testing.assert_array_equal(torch.isnan(L_t).numpy(), np.isnan(L_j))
    good = torch.as_tensor(np.array([[2.0, 0.5], [0.5, 1.0]]))
    np.testing.assert_allclose(pest.cholesky(good).numpy(),
                               np.linalg.cholesky(good.numpy()), rtol=1e-12)
    # A UKF step from a covariance that is not positive definite: NaN, as
    # JAX's.
    ps = _port_system("pendulum", torch.float64)
    s = pest.EkfState(torch.tensor([0.1, 0.0], dtype=torch.float64),
                       torch.as_tensor(-np.eye(2)))
    out = pest.ukf_predict(ps, s, torch.zeros(1, dtype=torch.float64),
                            torch.eye(2, dtype=torch.float64))
    with enable_x64_oracle():
        ref = jest.ukf_predict(_jax_system("pendulum", jnp.float64),
                               jest.EkfState(jnp.array([0.1, 0.0]),
                                             -jnp.eye(2)),
                               jnp.zeros(1), jnp.eye(2))
    assert np.isnan(np.asarray(ref.x_hat)).all()
    assert torch.isnan(out.x_hat).all()
