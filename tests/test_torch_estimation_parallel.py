"""The port's parallel-in-time filter and smoother
(ilqr_tpu_torch.estimation_parallel) against sequential folds and against
the JAX package's (ilqr_tpu.estimation_parallel).

The scans double recursively (`parallel_riccati.prefix_scan` and
`suffix_scan`); at N = 37, not a power of two, every prefix and suffix is
held to the left (right) fold of the same elements: 1e-12 of scale in
float64, 1e-5 in float32 (the same products associated otherwise).
Against JAX, whose ``associative_scan`` associates yet otherwise, on a
damped oscillator (LTI) and a pendulum record (rk4, angle observed):
float64 1e-9 of scale, float32 5e-4 of scale on the means and 5e-3 on
the covariances (two scans, each an association order of its own, over
N = 60 steps).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import estimation as jest
from ilqr_tpu import estimation_parallel as jep
from ilqr_tpu.models.linear import make_lti as jax_make_lti
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import estimation_parallel as pep
from ilqr_tpu_torch.estimation import EkfState
from ilqr_tpu_torch.ops.parallel_riccati import (
    RiccatiElement,
    combine,
    prefix_scan,
    suffix_scan,
)

torch.set_num_threads(1)

N = 60
TOL = {"f64": (torch.float64, jnp.float64, 1e-9, 1e-9),
       "f32": (torch.float32, jnp.float32, 5e-4, 5e-3)}
A_OSC = np.array([[0.0, 1.0], [-1.0, -0.2]])
B_OSC = np.array([[0.0], [1.0]])


def _ctx(name):
    return enable_x64_oracle() if name == "f64" else contextlib.nullcontext()


def _affine_model(n_steps, dtype, seed=0):
    """A random stable affine chain with a scalar observation."""
    rng = np.random.default_rng(seed)
    F = np.eye(2) + 0.1 * rng.standard_normal((n_steps, 2, 2))
    c = 0.1 * rng.standard_normal((n_steps, 2))
    H = np.tile(np.array([[[1.0, 0.0]]]), (n_steps, 1, 1)) \
        + 0.05 * rng.standard_normal((n_steps, 1, 2))
    d = 0.01 * rng.standard_normal((n_steps, 1))
    Y = rng.standard_normal((n_steps, 1))
    t = [torch.as_tensor(a, dtype=dtype) for a in (F, c, H, d, Y)]
    Qp = torch.as_tensor(np.diag([1e-2, 2e-2]), dtype=dtype)
    Ro = torch.as_tensor(np.array([[0.1]]), dtype=dtype)
    m0 = torch.as_tensor(np.array([0.2, -0.1]), dtype=dtype)
    P0 = torch.as_tensor(0.5 * np.eye(2), dtype=dtype)
    return t, Qp, Ro, m0, P0


def _scale_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_prefix_and_suffix_scans_match_sequential_folds(dtype, tol):
    M = 37
    (F, c, H, d, Y), Qp, Ro, m0, P0 = _affine_model(M, dtype)
    el = pep._filter_elements(F, c, H, d, Qp, Ro, m0, P0, Y)
    got = prefix_scan(el)
    acc = RiccatiElement(*(a[0] for a in el))
    for k in range(M):
        if k:
            acc = combine(acc, RiccatiElement(*(a[k] for a in el)))
        for g, r in zip(got, acc):
            assert _scale_err(g[k], r) <= tol, f"prefix {k}"
    # Riccati elements and the smoother's, suffix by suffix.
    X_f, P_f = pep.kalman_filter_parallel(F, c, H, d, Qp, Ro, m0, P0, Y)
    Pf = P_f[:-1]
    Pp = F[1:] @ Pf @ F[1:].mT + Qp
    E = torch.linalg.solve(Pp, F[1:] @ Pf).mT
    sm = pep.SmootherElement(
        E=torch.cat([E, torch.zeros_like(P_f[-1:])]),
        g=torch.cat([X_f[:-1] - ((E @ ((F[1:] @ X_f[:-1, :, None])[..., 0]
                                        + c[1:])[..., None])[..., 0]),
                     X_f[-1:]]),
        L=torch.cat([Pf - E @ F[1:] @ Pf, P_f[-1:]]))
    for elems, op, kind in ((el, combine, RiccatiElement),
                            (sm, pep.smoother_combine, pep.SmootherElement)):
        got = suffix_scan(elems, op)
        acc = kind(*(a[M - 1] for a in elems))
        for k in range(M - 1, -1, -1):
            if k < M - 1:
                acc = op(kind(*(a[k] for a in elems)), acc)
            for g, r in zip(got, acc):
                assert _scale_err(g[k], r) <= tol, f"{kind.__name__} {k}"


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


def _record(kind, seed=4):
    rng = np.random.default_rng(seed)
    U = 0.5 * rng.standard_normal((N, 1))
    Qp = np.diag([1e-4, 1e-4]) if kind == "osc" else np.diag([1e-6, 1e-6])
    Ro = np.array([[0.04]]) if kind == "osc" else np.array([[1e-3]])
    W = rng.standard_normal((N, 2)) @ np.sqrt(Qp)
    V = rng.standard_normal((N, 1)) @ np.sqrt(Ro)
    with enable_x64_oracle():
        js = _jax_system(kind, jnp.float64)
        x, xs = jnp.array([0.4, -0.3]), []
        for k in range(N):
            x = it.step(js, x, jnp.asarray(U[k])) + W[k]
            xs.append(np.asarray(x))
    return U, np.stack(xs)[:, :1] + V, Qp, Ro, np.array([0.3, 0.0]), \
        0.5 * np.eye(2)


def _close(got, ref, tol, what):
    got, ref = got.detach().numpy(), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3g}"


@pytest.mark.parametrize("kind", ["osc", "pendulum"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_parallel_filter_and_smoother_match_jax(name, kind):
    dtype, jdt, tol, tol_p = TOL[name]
    rec = _record(kind)
    with _ctx(name):
        U, Y, Qp, Ro, x0, P0 = (jnp.asarray(a, jdt) for a in rec)
        js = _jax_system(kind, jdt)
        s0 = jest.EkfState(x0, P0)
        ref = jax.jit(lambda U, Y: (
            jep.run_ekf_parallel(js, obs, s0, U, Y, Qp, Ro),
            jep.run_eks_parallel(js, obs, s0, U, Y, Qp, Ro, iters=2),
            jep._default_x_lin(js, x0, U)))(U, Y)
    ps = _port_system(kind, dtype)
    U, Y, Qp, Ro, x0, P0 = rec
    s0 = EkfState(x0, P0)
    X_lin = pep._default_x_lin(ps, ps.inputs(x0), ps.inputs(U))
    _close(X_lin, ref[2], tol, "default X_lin")
    X_f, P_f = pep.run_ekf_parallel(ps, obs, s0, U, Y, Qp, Ro)
    X_s, P_s = pep.run_eks_parallel(ps, obs, s0, U, Y, Qp, Ro, iters=2)
    assert X_f.dtype == dtype and X_s.shape == (N, 2) and P_s.shape == (N, 2, 2)
    _close(X_f, ref[0][0], tol, "filter means")
    _close(P_f, ref[0][1], tol_p, "filter covariances")
    _close(X_s, ref[1][0], tol, "smoother means")
    _close(P_s, ref[1][1], tol_p, "smoother covariances")


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_affine_filter_and_smoother_match_jax(name):
    """`kalman_filter_parallel` and `kalman_smoother_parallel` on the same
    random affine chain (N = 37) as JAX's, the smoother on the port's
    filtered moments."""
    dtype, jdt, tol, tol_p = TOL[name]
    (F, c, H, d, Y), Qp, Ro, m0, P0 = _affine_model(37, torch.float64)
    args = (F, c, H, d, Qp, Ro, m0, P0, Y)
    X_f, P_f = pep.kalman_filter_parallel(*(a.to(dtype) for a in args))
    X_s, P_s = pep.kalman_smoother_parallel(F[1:].to(dtype),
                                            c[1:].to(dtype), Qp.to(dtype),
                                            X_f, P_f)
    with _ctx(name):
        j = [jnp.asarray(a.numpy(), jdt) for a in args]
        ref_f = jax.jit(jep.kalman_filter_parallel)(*j)
        ref_s = jax.jit(jep.kalman_smoother_parallel)(
            j[0][1:], j[1][1:], j[4], jnp.asarray(X_f.double().numpy(), jdt),
            jnp.asarray(P_f.double().numpy(), jdt))
    _close(X_f.double(), ref_f[0], tol, "filtered means")
    _close(P_f.double(), ref_f[1], tol_p, "filtered covariances")
    _close(X_s.double(), ref_s[0], tol, "smoothed means")
    _close(P_s.double(), ref_s[1], tol_p, "smoothed covariances")
    combined = pep.smoother_combine(
        pep.SmootherElement(P_f[0], X_f[0], P_f[1]),
        pep.SmootherElement(P_f[2], X_f[2], P_f[3]))
    with _ctx(name):
        ref_c = jep.smoother_combine(
            jep.SmootherElement(*(jnp.asarray(t.double().numpy(), jdt)
                                  for t in (P_f[0], X_f[0], P_f[1]))),
            jep.SmootherElement(*(jnp.asarray(t.double().numpy(), jdt)
                                  for t in (P_f[2], X_f[2], P_f[3]))))
    for g, r, what in zip(combined, ref_c, "EgL"):
        _close(g.double(), r, tol, f"smoother_combine {what}")


def test_parallel_filter_is_the_sequential_filter_on_a_linear_system():
    """On the LTI record the parallel filter is the EKF (the same affine
    model), to float64 rounding."""
    rec = _record("osc")
    ps = _port_system("osc", torch.float64)
    U, Y, Qp, Ro, x0, P0 = rec
    from ilqr_tpu_torch.estimation import run_ekf
    _, X_seq, P_seq = run_ekf(ps, obs, EkfState(x0, P0), U, Y, Qp, Ro)
    X_par, P_par = pep.run_ekf_parallel(ps, obs, EkfState(x0, P0), U, Y, Qp,
                                        Ro)
    assert float((X_par - X_seq).abs().max()) <= 1e-10
    assert float((P_par - P_seq).abs().max()) <= 1e-10


def test_eks_parallel_validates_iters():
    ps = _port_system("osc", torch.float64)
    with pytest.raises(ValueError):
        pep.run_eks_parallel(ps, obs, EkfState(np.zeros(2), np.eye(2)),
                             np.zeros((3, 1)), np.zeros((3, 1)), np.eye(2),
                             np.eye(1), iters=0)
