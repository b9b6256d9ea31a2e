"""The port's other model families against ilqr_tpu's.

Cart-pole, the planar and 3-D quadrotors (and the rotor-lag variant), the
car, the spring chain (a few masses and n_x = 32), the tracking and
control-rate wrappers around the pendulum and the double pendulum, and the
LTI systems: the same seeded numpy states and controls go through both
packages, the port's systems built from the JAX systems' parameters by
`convert.system_from_numpy`.  Each case checks f_cont, one `step` under
each explicit integrator and the trajectory expansion, in f32 and in f64
(JAX under `enable_x64_oracle`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.models import chain as jchain
from ilqr_tpu.models import linear as jlinear
from ilqr_tpu.models import quadrotor3d as jq3
from ilqr_tpu.models import rate as jrate
from ilqr_tpu.ops.integrators import step as jax_step
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy
from ilqr_tpu_torch.models import quadrotor3d, rate, tracking

torch.set_num_threads(1)

FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")
# f32: the same formulas in two frameworks' operation orders, a few ulp of
# the largest value; f64: agreement to rounding.
ATOL = {torch.float32: 5e-5, torch.float64: 1e-11}
RTOL_EXP = {torch.float32: 2e-5, torch.float64: 1e-10}
EXPLICIT = ("euler", "midpoint", "rk4")


def _diag(*v):
    return np.diag(np.asarray(v, np.float64))


def _q3_weights(n_x=12):
    Q, R, Q_f = (np.asarray(a) for a in jq3.default_weights())
    if n_x == 16:
        Q = np.diag(np.r_[np.diag(Q), [0.01] * 4])
        Q_f = np.diag(np.r_[np.diag(Q_f), [1.0] * 4])
    return Q, R, Q_f


def _jax_pendulum(integ):
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=10.0 * np.eye(2), d=0.05, integrator=integ)


def _jax_dp(integ):
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=_diag(10, 10, 0.1, 0.1),
        R=_diag(0.1, 0.1), Q_f=_diag(1000, 1000, 100, 100), d1=0.1, d2=0.1,
        theta1=1 / 12, theta2=1 / 12, integrator=integ)


def _ref(n_x, n_u, N=12, seed=5):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.normal(size=(N + 1, n_x)), 0.3 * rng.normal(size=(N, n_u))


# name -> (JAX system factory of the integrator, port kind, sample scale)
MODELS = {
    "cartpole": (lambda i: it.make_cartpole(
        0.02, [0.0, np.pi, 0.0, 0.0], _diag(1, 10, 0.1, 0.1), _diag(0.1),
        _diag(100, 100, 10, 10), integrator=i), "cartpole"),
    "quadrotor": (lambda i: it.make_quadrotor(
        0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0], _diag(1, 1, 0.5, 0.1, 0.1, 0.1),
        0.1 * np.eye(2), _diag(200, 200, 50, 20, 20, 10), integrator=i),
        "quadrotor"),
    "quadrotor3d": (lambda i: it.make_quadrotor3d(
        0.02, [2.0, 1.0, 1.5] + [0.0] * 9, *_q3_weights(), integrator=i),
        "quadrotor3d"),
    "quadrotor3d_rotor": (lambda i: jq3.make_quadrotor3d_rotor(
        0.02, [2.0, 1.0, 1.5] + [0.0] * 9 + [1.226] * 4, *_q3_weights(16),
        integrator=i), "quadrotor3d_rotor"),
    "car": (lambda i: it.make_car(
        0.05, [8.0, 0.0, 0.0, 0.0], _diag(0.1, 0.1, 0.01, 0.1), _diag(1, 5),
        100.0 * _diag(1, 1, 0.1, 1), integrator=i), "car"),
    "chain3": (lambda i: jchain.make_spring_chain(
        0.02, n_masses=3, integrator=i), "chain"),
    "chain32": (lambda i: jchain.make_spring_chain(
        0.02, n_masses=16, integrator=i), "chain"),
    "tracking_pendulum": (lambda i: it.make_tracking_system(
        _jax_pendulum(i), *_ref(2, 1), np.eye(2), np.eye(1),
        10.0 * np.eye(2)), ("tracking", "pendulum")),
    "tracking_dp": (lambda i: it.make_tracking_system(
        _jax_dp(i), *_ref(4, 2), np.eye(4), 0.1 * np.eye(2),
        10.0 * np.eye(4)), ("tracking", "double_pendulum")),
    "rate_pendulum": (lambda i: jrate.make_rate_penalized_system(
        _jax_pendulum(i), 2.0 * np.eye(1)), ("rate", "pendulum")),
    "rate_dp": (lambda i: jrate.make_rate_penalized_system(
        _jax_dp(i), np.array([[1.0, 0.2], [0.2, 0.5]])),
        ("rate", "double_pendulum")),
    "lti": (lambda i: it.make_lti(
        np.array([[0.0, 1.0, 0.0], [-2.0, -0.3, 1.0], [0.0, 0.0, -1.0]]),
        np.array([[0.0], [1.0], [0.5]]), 0.05, [1.0, 0.0, 0.0], np.eye(3),
        np.eye(1), 10.0 * np.eye(3), integrator=i), "lti"),
}


def _np(v):
    if isinstance(v, dict):
        return {k: _np(w) for k, w in v.items()
                if k not in ("base_f", "base_sys")}
    return np.asarray(v, np.float64)


def _port(name, jsys, dtype):
    kind = MODELS[name][1]
    params = _np(jsys.params)
    if kind[0] == "rate":
        params["base"] = _np(jsys.params["base_sys"].params)
        base = jsys.params["base_sys"]
        integ, iters = base.integrator, base.newton_iters
    else:
        integ, iters = jsys.integrator, jsys.newton_iters
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             integ, iters, dtype=dtype, device="cpu")


def _samples(name, jsys, seed=0, n=12):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.normal(size=(n, jsys.n_x))
    u = 0.5 * rng.normal(size=(n, jsys.n_u))
    if name.startswith("tracking"):
        x[:, -1] = rng.integers(0, 12, size=n)   # the clock: step indices
    if name.startswith("quadrotor3d"):
        u += 1.226                      # about the hover thrust per rotor
        # Pitch within 1e-3 of vertical: the cos θ guard clamps there.
        x[0, 4], x[1, 4] = np.pi / 2 - 4e-4, -np.pi / 2 + 3e-4
    return x, u


def _jax_to(jsys, jdt):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), jsys)


def _jax_run(fn, jsys, dtype, *arrays):
    """fn(jsys, *arrays) jitted, in the test's dtype, as numpy."""
    if dtype == torch.float64:
        with enable_x64_oracle():
            out = jax.jit(fn)(_jax_to(jsys, jnp.float64),
                              *(jnp.asarray(a, jnp.float64) for a in arrays))
            return jax.tree_util.tree_map(np.asarray, out)
    out = jax.jit(fn)(jsys, *(jnp.asarray(a, jnp.float32) for a in arrays))
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_eval(jsys, x, u):
    f = jax.vmap(lambda a, b: jsys.f_cont(jsys.params, a, b))(x, u)
    s = jax.vmap(lambda a, b: jax_step(jsys, a, b))(x, u)
    lf = jax.vmap(lambda a: jsys.terminal_cost(jsys.params, a))(x)
    ls = jax.vmap(lambda a, b: jsys.stage_cost(jsys.params, a, b))(x, u)
    return f, s, ls, lf


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("integ", EXPLICIT)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_dynamics_step_and_costs_match_jax(name, integ, dtype):
    """f_cont, one step under the integrator, the stage and terminal costs,
    on batched states and one state at a time."""
    jsys = MODELS[name][0](integ)
    sys_ = _port(name, jsys, dtype)
    assert (sys_.n_x, sys_.n_u) == (jsys.n_x, jsys.n_u)
    xs, us = _samples(name, jsys)
    f_ref, s_ref, l_ref, lf_ref = _jax_run(_jax_eval, jsys, dtype, xs, us)
    x, u = torch.tensor(xs, dtype=dtype), torch.tensor(us, dtype=dtype)
    f = sys_.f_cont(sys_.params, x, u)
    s = itt.step(sys_, x, u)
    s_one = torch.stack([itt.step(sys_, a, b) for a, b in zip(x, u)])
    l = sys_.stage_cost(sys_.params, x, u)
    lf = sys_.terminal_cost(sys_.params, x)
    assert s.dtype == dtype and l.dtype == dtype
    for got, ref in ((f, f_ref), (s, s_ref), (s_one, s_ref), (l, l_ref),
                     (lf, lf_ref)):
        scale = 1.0 + np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=ATOL[dtype],
                                   atol=ATOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_linearize_trajectory_matches_jax(name, dtype):
    """The trajectory expansion under rk4 (the tracking and rate wrappers
    under their base's rk4), each field within RTOL_EXP of its max."""
    jsys = MODELS[name][0]("rk4")
    sys_ = _port(name, jsys, dtype)
    N = 10
    rng = np.random.default_rng(3)
    X = 0.4 * rng.normal(size=(N + 1, jsys.n_x))
    U = 0.4 * rng.normal(size=(N, jsys.n_u))
    if name.startswith("tracking"):
        X[:, -1] = np.arange(N + 1)
    if name.startswith("quadrotor3d"):
        U += 1.226
    ref = _jax_run(lambda s, X, U: jax_linearize(s, X, U), jsys, dtype, X, U)
    exp = itt.linearize_trajectory(sys_, torch.tensor(X, dtype=dtype),
                                   torch.tensor(U, dtype=dtype))
    for f in FIELDS:
        r = np.asarray(getattr(ref, f))
        g = getattr(exp, f)
        assert g.dtype == dtype, f
        np.testing.assert_allclose(
            g.numpy(), r, rtol=RTOL_EXP[dtype],
            atol=RTOL_EXP[dtype] * max(np.abs(r).max(), 1.0), err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cont2disc_and_discrete_lti_match_jax(dtype):
    """Exact ZOH by the matrix exponential, and the discrete LTI step and
    the discrete tracking clock (set to k + 1)."""
    rng = np.random.default_rng(0)
    A, B = rng.normal(size=(4, 4)), rng.normal(size=(4, 2))
    if dtype == torch.float64:
        with enable_x64_oracle():
            Ad_ref, Bd_ref = (np.asarray(a) for a in jlinear.cont2disc(
                jnp.asarray(A), jnp.asarray(B), 0.1))
    else:
        Ad_ref, Bd_ref = (np.asarray(a) for a in jlinear.cont2disc(
            jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32), 0.1))
    Ad, Bd = itt.cont2disc(torch.tensor(A, dtype=dtype),
                           torch.tensor(B, dtype=dtype), 0.1)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(Ad.numpy(), Ad_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(Bd.numpy(), Bd_ref, rtol=tol, atol=tol)
    kw = dict(device="cpu", dtype=dtype)
    sys_ = itt.make_discrete_lti(Ad, Bd, 0.1, np.zeros(4), np.eye(4),
                                 np.eye(2), np.eye(4), **kw)
    assert sys_.integrator == "discrete"
    x, u = torch.tensor(rng.normal(size=4), dtype=dtype), torch.ones(2, **{
        "dtype": dtype})
    np.testing.assert_allclose(itt.step(sys_, x, u).numpy(),
                               (Ad @ x + Bd @ u).numpy(), rtol=1e-12)
    tr = itt.make_tracking_system(sys_, torch.zeros((6, 4), **kw),
                                  torch.zeros((5, 2), **kw), np.eye(4),
                                  np.eye(2), np.eye(4))
    z = itt.step(tr, itt.augment_x0(x, 3.0), u)
    assert float(z[-1]) == 4.0
    np.testing.assert_allclose(itt.strip_clock(z).numpy(),
                               (Ad @ x + Bd @ u).numpy(), rtol=1e-12)


def test_factories_and_helpers_match_jax():
    """Parameter sets of the factories, the hover controls, the default
    weights, and the wrappers' boundary helpers."""
    kw = dict(device="cpu", dtype=torch.float64)
    for jsys, port in (
        (MODELS["cartpole"][0]("rk4"), itt.make_cartpole(
            0.02, [0.0, np.pi, 0.0, 0.0], _diag(1, 10, 0.1, 0.1), _diag(0.1),
            _diag(100, 100, 10, 10), **kw)),
        (MODELS["quadrotor3d"][0]("rk4"), itt.make_quadrotor3d(
            0.02, [2.0, 1.0, 1.5] + [0.0] * 9, *quadrotor3d.default_weights(
                **kw), **kw)),
        (MODELS["car"][0]("rk4"), itt.make_car(
            0.05, [8.0, 0.0, 0.0, 0.0], _diag(0.1, 0.1, 0.01, 0.1),
            _diag(1, 5), 100.0 * _diag(1, 1, 0.1, 1), **kw)),
        (MODELS["chain32"][0]("rk4"), itt.make_spring_chain(
            0.02, n_masses=16, **kw)),
    ):
        assert (port.n_x, port.n_u, port.dt) == (jsys.n_x, jsys.n_u, jsys.dt)
        assert sorted(port.params) == sorted(jsys.params)
        for k, v in jsys.params.items():
            np.testing.assert_allclose(port.params[k].numpy(), np.asarray(v),
                                       rtol=1e-7, err_msg=k)
    q = itt.make_quadrotor(0.01, np.zeros(6), np.eye(6), np.eye(2),
                           np.eye(6), **kw)
    from ilqr_tpu.models.quadrotor import hover_controls as jhover
    from ilqr_tpu_torch.models.quadrotor import hover_controls
    np.testing.assert_allclose(hover_controls(q.params).numpy(),
                               np.asarray(jhover({"m": 0.5, "g": 9.81})))
    q3 = itt.make_quadrotor3d(0.02, np.zeros(12), np.eye(12), np.eye(4),
                              np.eye(12), **kw)
    np.testing.assert_allclose(quadrotor3d.hover_controls(q3.params).numpy(),
                               np.asarray(jq3.hover_controls(
                                   {"m": 0.5, "g": 9.81})))
    z = rate.rate_augment_x0(torch.ones(2, **kw), n_u=1)
    assert z.tolist() == [1.0, 1.0, 0.0]
    assert rate.strip_rate(z, 2).tolist() == [1.0, 1.0]
    assert tracking.augment_x0(torch.ones(2, **kw), 2.0).tolist() == [
        1.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="wrapper"):
        system_from_numpy(("smoothing", "pendulum"), {}, 3, 1, 0.01,
                          device="cpu")
