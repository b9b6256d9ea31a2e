"""The rollouts of the systems the rollout kernels now take, against JAX.

The LTI systems, the tracking and rate wrappers, the spring chain and the
later models' implicit rules: the port's plain rollouts (what the kernel
wrappers run on CPU tensors, and what chip_smoke.py and the host tests hold
the CUDA kernels to) against

* JAX's Pallas rollout kernels in interpret mode, as
  tests/test_pallas_rollout.py calls them (`linesearch_costs_pallas`,
  `closed_loop_rollout_pallas`, and the batched ones of `pallas_batched`
  for the systems JAX's `_kernel_ok` takes): f32, costs within rtol 1e-5,
  X and U within 1e-5 of their scale;
* JAX's plain rollouts in f64 within 1e-10 of their scale.

Then B7w's plain route (`suffix_scan_fused(layout='lane')` on CPU tensors)
against JAX's lane kernel in interpret mode at n = 6 and against its scan at
n = 12, and the slice's paths on the CPU: P4 (the tracking MPC) for a few
steps in f64 against JAX's `run_mpc`, P5 (the rate-penalized cart-pole)
at B = 8 against `jax.vmap(solve)`, P6 (the LTI double integrator) against
JAX's `solve`.  The JAX systems are built outside `enable_x64_oracle`, so
that their f64 copies hold the f32-rounded parameters the port receives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.models import chain as jchain
from ilqr_tpu.models import rate as jrate
from ilqr_tpu.models.linear import make_discrete_lti as jax_discrete_lti
from ilqr_tpu.mpc import run_mpc as jax_run_mpc
from ilqr_tpu.ops.pallas_batched import (
    closed_loop_rollout_batched as jax_closed_loop_batched,
    linesearch_costs_batched as jax_costs_batched,
    open_loop_rollout_batched as jax_open_loop_batched,
)
from ilqr_tpu.ops.pallas_riccati import suffix_scan_pallas as jax_suffix_pallas
from ilqr_tpu.ops.pallas_rollout import (
    closed_loop_rollout_pallas,
    linesearch_costs_pallas,
)
from ilqr_tpu.ops.rollout import linesearch_rollouts as jax_linesearch
from ilqr_tpu.ops.parallel_riccati import RiccatiElement as JaxElement
from ilqr_tpu.ops.parallel_riccati import make_elements as jax_make_elements
from ilqr_tpu.ops.parallel_riccati import suffix_scan as jax_suffix_scan
from ilqr_tpu.utils.x64 import enable_x64_oracle

import chip_smoke as cs
import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

torch.set_num_threads(1)

N = 20
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


def _pendulum(integ):
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=10.0 * np.eye(2), d=0.05, integrator=integ)


def _lti_discrete():
    A_d, B_d = it.cont2disc(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                            jnp.array([[0.0], [1.0]]), 0.1)
    return jax_discrete_lti(A_d, B_d, 0.1, jnp.zeros(2), jnp.eye(2),
                            jnp.eye(1), 10.0 * jnp.eye(2))


def _reference(n_x, n_u, rows=N + 6, seed=5):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=(rows, n_x)),
            0.3 * rng.normal(size=(rows - 1, n_u)))


def _lti_42(integ):
    rng = np.random.default_rng(42)
    A = rng.normal(size=(4, 4))
    return it.make_lti((A - A.T) / 2.0 - 0.2 * np.eye(4),
                       0.5 * rng.normal(size=(4, 2)), 0.05,
                       rng.normal(size=4), np.eye(4), 0.1 * np.eye(2),
                       10.0 * np.eye(4), integrator=integ)


# name -> (JAX system, port kind, the base's integrator for the port).
SYSTEMS = {
    "tracking_pendulum_rk4": (lambda: it.make_tracking_system(
        _pendulum("rk4"), *_reference(2, 1), np.eye(2), np.eye(1),
        10.0 * np.eye(2)), ("tracking", "pendulum"), "rk4"),
    "tracking_lti_discrete": (lambda: it.make_tracking_system(
        _lti_discrete(), *_reference(2, 1), np.eye(2), np.eye(1),
        np.eye(2)), ("tracking", "lti"), "discrete"),
    "rate_pendulum_rk4": (lambda: jrate.make_rate_penalized_system(
        _pendulum("rk4"), 2.0 * np.eye(1)), ("rate", "pendulum"), "rk4"),
    "rate_lti_discrete": (lambda: jrate.make_rate_penalized_system(
        _lti_discrete(), 0.5 * np.eye(1)), ("rate", "lti"), "discrete"),
    "lti_euler": (lambda: _lti_42("euler"), "lti", "euler"),
    "lti_discrete": (_lti_discrete, "lti", "discrete"),
    "chain_midpoint": (lambda: jchain.make_spring_chain(
        0.02, n_masses=16, integrator="midpoint"), "chain", "midpoint"),
    "cartpole_backward_euler": (lambda: it.make_cartpole(
        0.02, [0.0, np.pi, 0.0, 0.0], np.diag([1.0, 10.0, 0.1, 0.1]),
        0.1 * np.eye(1), np.diag([100.0, 100.0, 10.0, 10.0]),
        integrator="backward_euler"), "cartpole", "backward_euler"),
    "quadrotor_trapezoidal": (lambda: it.make_quadrotor(
        0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
        np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]),
        integrator="trapezoidal"), "quadrotor", "trapezoidal"),
}


def _np(v):
    if isinstance(v, dict):
        return {k: _np(w) for k, w in v.items()
                if k not in ("base_f", "base_sys")}
    return np.asarray(v, np.float64)


def _port(name, jsys, dtype):
    _, kind, integ = SYSTEMS[name]
    params = _np(jsys.params)
    if kind[0] == "rate":
        params["base"] = _np(jsys.params["base_sys"].params)
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             integ, dtype=dtype, device="cpu")


def _inputs(name, jsys, B=None, seed=0):
    """x0, X_old, U_old, u_ff, K (numpy, f64) of a seeded nominal: the JAX
    system's own rollout of controls about its operating point."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    n_x, n_u = jsys.n_x, jsys.n_u
    x0 = 0.3 * rng.normal(size=lead + (n_x,))
    U = 0.3 * rng.normal(size=lead + (N, n_u))
    if name.startswith("tracking"):
        x0[..., -1] = 0.0
    if name.startswith("quadrotor"):
        U += 0.5 * 9.81
    u_ff = 0.2 * rng.normal(size=lead + (N, n_u))
    K = -0.05 * rng.normal(size=lead + (N, n_u, n_x))
    if name.startswith("tracking"):
        K[..., -1] = 0.0
    roll = jax.vmap(it.rollout, (None, 0, 0)) if B else it.rollout
    X = np.asarray(jax.jit(lambda x, u: roll(jsys, x, u)[0])(
        jnp.asarray(x0, jnp.float32), jnp.asarray(U, jnp.float32)),
        np.float64)
    return x0, X, U, u_ff, K


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_rollouts_match_jax_kernels_interpret(name):
    """f32: the port's plain line-search costs, closed loop and open loop
    against JAX's Pallas rollout kernels in interpret mode (the open loop:
    JAX's rollout)."""
    jsys = SYSTEMS[name][0]()
    sys_ = _port(name, jsys, torch.float32)
    x0, X, U, u_ff, K = _inputs(name, jsys)
    j32 = [jnp.asarray(a, jnp.float32) for a in (x0, X, U, u_ff, K)]
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (x0, X, U, u_ff, K)]
    al = jnp.asarray(ALPHAS, jnp.float32)
    ref = linesearch_costs_pallas(jsys, j32[0], al, *j32[1:], interpret=True)
    got = itt.linesearch_costs_fused(sys_, t32[0], torch.tensor(ALPHAS),
                                     *t32[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    Xr, Ur, cr = closed_loop_rollout_pallas(jsys, j32[0], 0.5, *j32[1:],
                                            interpret=True)
    Xp, Up, cp = itt.closed_loop_rollout_fused(sys_, t32[0], 0.5, *t32[1:])
    _close(Xp, Xr, 1e-5)
    _close(Up, Ur, 1e-5)
    np.testing.assert_allclose(float(cp), float(cr), rtol=1e-5)
    Xo, co = jax.jit(lambda x, u: it.rollout(jsys, x, u))(j32[0], j32[2])
    Xq, cq = itt.open_loop_rollout_fused(sys_, t32[0], t32[2])
    _close(Xq, Xo, 1e-5)
    np.testing.assert_allclose(float(cq), float(co), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_rollouts_match_jax_f64(name):
    """f64: the port's plain rollouts against JAX's, within 1e-10 of
    their scale."""
    jsys = SYSTEMS[name][0]()
    sys_ = _port(name, jsys, torch.float64)
    x0, X, U, u_ff, K = _inputs(name, jsys)
    with enable_x64_oracle():
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     jsys)
        ref = jax.jit(lambda *a: jax_linesearch(j64, *a))(
            jnp.asarray(x0), jnp.asarray(ALPHAS), jnp.asarray(X),
            jnp.asarray(U), jnp.asarray(u_ff), jnp.asarray(K))
        ref_o = jax.jit(lambda x, u: it.rollout(j64, x, u))(
            jnp.asarray(x0), jnp.asarray(U))
    t64 = [torch.tensor(a, dtype=torch.float64) for a in (x0, X, U, u_ff, K)]
    got = itt.linesearch_rollouts(sys_, t64[0], torch.tensor(ALPHAS,
                                                             dtype=torch.float64),
                                  *t64[1:])
    for g, r in zip(got, ref):
        _close(g, r, 1e-10)
    for g, r in zip(itt.rollout(sys_, t64[0], t64[2]), ref_o):
        _close(g, r, 1e-10)


# JAX's batched kernel takes the explicit integrators and 'discrete'.
BATCHED = [n for n in sorted(SYSTEMS) if SYSTEMS[n][2] in
           ("euler", "midpoint", "rk4", "discrete")]


@pytest.mark.parametrize("name", BATCHED)
def test_batched_rollouts_match_jax_kernels_interpret(name):
    """f32, B = 3: the port's plain batched costs, per-instance-alpha
    trajectories and open loops against JAX's batched Pallas kernels in
    interpret mode."""
    jsys = SYSTEMS[name][0]()
    sys_ = _port(name, jsys, torch.float32)
    x0, X, U, u_ff, K = _inputs(name, jsys, B=3, seed=1)
    j32 = [jnp.asarray(a, jnp.float32) for a in (x0, X, U, u_ff, K)]
    t32 = [torch.tensor(a, dtype=torch.float32) for a in (x0, X, U, u_ff, K)]
    al = np.array([1.0, 0.5, 0.25])
    ref = jax_costs_batched(jsys, j32[0], jnp.asarray(al, jnp.float32),
                            *j32[1:], interpret=True)
    got = itt.linesearch_costs_batched(sys_, t32[0], torch.tensor(al),
                                       *t32[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    Xr, Ur, cr = jax_closed_loop_batched(jsys, j32[0],
                                         jnp.asarray(al, jnp.float32),
                                         *j32[1:], interpret=True)
    Xp, Up, cp = itt.closed_loop_rollout_batched(
        sys_, t32[0], torch.tensor(al, dtype=torch.float32), *t32[1:])
    _close(Xp, Xr, 1e-5)
    _close(Up, Ur, 1e-5)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cr), rtol=1e-5)
    Xo, co = jax_open_loop_batched(jsys, j32[0], j32[2], interpret=True)
    Xq, cq = itt.open_loop_rollout_batched(sys_, t32[0], t32[2])
    _close(Xq, Xo, 1e-5)
    np.testing.assert_allclose(cq.numpy(), np.asarray(co), rtol=1e-5)


def _suffix_elements(n, M, seed):
    """The Riccati elements of a seeded expansion at (n, 2), M - 1 stages
    and the terminal element (numpy, f32)."""
    rng = np.random.default_rng(seed)
    Nst, W = M - 1, rng.normal(size=(M - 1, 2, 2))
    exp = it.TrajectoryExpansion(
        f_x=np.eye(n) + 0.05 * rng.normal(size=(Nst, n, n)),
        f_u=0.3 * rng.normal(size=(Nst, n, 2)),
        l_x=rng.normal(size=(Nst, n)), l_u=rng.normal(size=(Nst, 2)),
        l_xx=np.broadcast_to(np.eye(n), (Nst, n, n)).copy(),
        l_ux=0.1 * rng.normal(size=(Nst, 2, n)),
        l_uu=W @ W.transpose(0, 2, 1) / 2 + np.eye(2),
        v_x=rng.normal(size=n), v_xx=10.0 * np.eye(n))
    exp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), exp)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jax_make_elements)(exp, 0.0))


def _check_fields(got, ref, rtol):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=rtol * max(np.abs(r).max(), 1e-30))


def test_lane_suffix_scan_wide_matches_jax_lane_kernel_interpret():
    """B7w's plain route at n = 6 (the 'lane' layout on CPU tensors)
    against JAX's lane kernel (`_suffix_kernel`) in interpret mode, M = 40:
    every field within 1e-4 of its max (f32 scans in other orders)."""
    elems = _suffix_elements(6, 40, 6)
    ref = jax_suffix_pallas(JaxElement(*map(jnp.asarray, elems)),
                            interpret=True, layout="lane")
    got = itt.suffix_scan_fused(RiccatiElement(*(torch.tensor(a)
                                                 for a in elems)), "lane")
    _check_fields(got, ref, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lane_suffix_scan_wide_matches_jax_scan(dtype):
    """B7w's plain route at n = 12, M = 151 (the flight's M), against
    JAX's associative suffix scan, which JAX's lane kernel computes (at n
    = 12 its interpreter takes minutes to trace the kernel): f32 within
    1e-4 of each field's max, f64 within 1e-10."""
    elems = _suffix_elements(12, 151, 12)
    if dtype == torch.float64:
        with enable_x64_oracle():
            ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_suffix_scan)(
                JaxElement(*(jnp.asarray(a, jnp.float64) for a in elems))))
        rtol = 1e-10
    else:
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_suffix_scan)(
            JaxElement(*map(jnp.asarray, elems))))
        rtol = 1e-4
    got = itt.suffix_scan_fused(RiccatiElement(*(
        torch.tensor(a, dtype=dtype) for a in elems)), "lane")
    _check_fields(got, ref, rtol)


def test_p4_tracking_mpc_matches_jax_f64():
    """P4 (examples/reference_tracking_mpc.py's tracking MPC, H = 50) for
    3 steps in f64 with rollout='pallas' (the plain rollouts on CPU
    tensors) against JAX's run_mpc: states within 1e-8, cost within
    1e-9."""
    from examples_torch import reference_tracking_mpc
    p = reference_tracking_mpc.problem("cpu", torch.float64)
    cfg = dataclasses.replace(p.config, rollout="pallas")
    res = itt.run_mpc(p.system, p.system, p.x0, p.U0, 3, cfg)
    dt, n_sim, horizon = 0.01, 600, 50
    base = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")
    t = np.arange(n_sim + horizon + 1) * dt
    X_ref = np.stack([0.8 * np.sin(2.0 * t), 1.6 * np.cos(2.0 * t)], -1)
    trk = it.make_tracking_system(
        base, X_ref, np.zeros((n_sim + horizon, 1)),
        Q=np.diag([100.0, 1.0]), R=0.01 * np.eye(1), Q_f=np.zeros((2, 2)))
    with enable_x64_oracle():
        j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     trk)
        ref = jax.jit(lambda x: jax_run_mpc(
            j64, j64, x, jnp.zeros((horizon, 1), jnp.float64), 3,
            it.IlqrConfig(maxiter=8, tol=1e-6)))(jnp.zeros(3, jnp.float64))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    _close(res.X.numpy(), ref.X, 1e-8)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_p5_rate_cartpole_batch_matches_jax_vmap(dtype):
    """P5 (the rate-penalized cart-pole of chip_smoke.py, N = 100) at B =
    8 of its instances: `solve_batch` with rollout='pallas' (the plain
    batched rollouts on CPU tensors) against `jax.vmap(solve)`, costs
    within 1e-8 relative in f64 (test_torch_batched.py's solve_batch
    bound) and, in f32, within chip_smoke.py's
    RTOL_AL (1e-3): at tol 1e-5 on costs of 4e-3 to 0.4, f32 rounding
    decides whether an instance takes one more step (4e-5 apart here)."""
    kw = dict(dtype=dtype, device="cpu")
    rs = cs.p5_system(itt, dict(dtype=torch.float32, device="cpu"))
    if dtype == torch.float64:
        rs = rs.replace(params=cs.params_f64(rs.params))
    x0s = cs.p5_x0s(kw)[::32].contiguous()
    cfg = itt.IlqrConfig(maxiter=40, tol=1e-5, rollout="pallas")
    sol = itt.solve_batch(rs, x0s, torch.zeros((cs.P5_N, 1), **kw), cfg)
    cart = it.make_cartpole(
        0.01, [0.0, jnp.pi, 0.0, 0.0], Q=np.diag([1.0, 10.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 10.0, 10.0]),
        integrator="rk4")
    jrs = jrate.make_rate_penalized_system(cart, 0.1 * np.eye(1))
    jcfg = it.IlqrConfig(maxiter=40, tol=1e-5)

    def run(system, xs, U):
        return jax.vmap(lambda x: it.solve(system, x, U, jcfg).cost)(xs)

    if dtype == torch.float64:
        with enable_x64_oracle():
            j64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jrs)
            ref = np.asarray(jax.jit(run)(j64, jnp.asarray(x0s.numpy()),
                                          jnp.zeros((cs.P5_N, 1))))
        rtol = 1e-8
    else:
        ref = np.asarray(jax.jit(run)(jrs, jnp.asarray(x0s.numpy()),
                                      jnp.zeros((cs.P5_N, 1), jnp.float32)))
        rtol = cs.RTOL_AL
    np.testing.assert_allclose(sol.cost.numpy(), ref, rtol=rtol)


def test_p6_lti_double_integrator_matches_jax():
    """P6 (examples/linear_lqr.py's double integrator as
    make_discrete_lti's system, N = 50) by `solve` with rollout='pallas'
    and backward='pallas' against JAX's solve in f32 (1e-5)."""
    kw = dict(dtype=torch.float32, device="cpu")
    lti = cs.p6_system(itt, kw)
    x0 = torch.tensor([2.0, 0.0], **kw)
    sol = itt.solve(lti, x0, torch.zeros((cs.P6_N, 1), **kw),
                    itt.IlqrConfig(maxiter=20, tol=1e-6, backward="pallas",
                                   rollout="pallas"))
    jsys = _lti_discrete()
    ref = jax.jit(lambda x, U: it.solve(
        jsys, x, U, it.IlqrConfig(maxiter=20, tol=1e-6)).cost)(
        jnp.array([2.0, 0.0]), jnp.zeros((cs.P6_N, 1)))
    np.testing.assert_allclose(float(sol.cost), float(ref), rtol=1e-5)
