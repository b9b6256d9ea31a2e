"""Batched solving in the port against ilqr_tpu's ``jax.vmap(solve)``.

On CPU tensors the batched kernel wrappers of `ilqr_tpu_torch.ops.batched`
run their plain versions; the CUDA kernels (B4 `csrc/batched_riccati.cu`,
B5 the batched entries of `csrc/chain_rollout.cu`) are checked against
those on the GPU by chip_smoke.py and on a host mock of the runtime by
test_torch_batched_host.py.  Here:

* B4's plain version against the JAX batched Pallas kernel in interpret
  mode and against ``jax.vmap(backward_pass)``, with a scalar and a
  per-instance reg, at the JAX package's relative tolerance;
* B5's plain versions against the JAX batched rollout kernels in interpret
  mode;
* `linearize_trajectory_batched` against ``jax.vmap(linearize_trajectory)``;
* `solve_batch` against ``jax.vmap(solve)`` per instance for every engine
  pair, in f64 (f32 double-pendulum trajectories jump basins between
  frameworks), with a batch in which one instance stops at its first
  iteration while the others run on; against the port's own `solve`; and
  the batch surfaces of `ilqr_tpu_torch.parallel`.

The JAX systems are built outside `enable_x64_oracle`, so that their f64
copies hold the same (f32-rounded) parameters the port receives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.pallas_batched import (
    backward_pass_batched as jax_backward_batched,
    closed_loop_rollout_batched as jax_closed_loop_batched,
    linesearch_costs_batched as jax_costs_batched,
    open_loop_rollout_batched as jax_open_loop_batched,
)
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.parallel.batch import solve_multistart as jax_multistart
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy
from ilqr_tpu_torch.ops import batched, fused_rollout

torch.set_num_threads(1)

FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")
ALPHAS = (1.0, 0.5, 0.25, 0.125)


def _jax_dp(integrator="rk4"):
    # The JAX package's batched-kernel test system
    # (tests/test_pallas_batched.py).
    return it.make_double_pendulum(
        0.02, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([100.0, 100.0, 10.0, 10.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator=integrator)


def _jax_pendulum(integrator="rk4"):
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=10.0 * np.eye(2), d=0.0, integrator=integrator)


def _port(jsys, dtype):
    kind = "pendulum" if jsys.n_x == 2 else "double_pendulum"
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


def _f64(jsys):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jsys)


def _random_batch(jsys, B, N, seed):
    """x0s (B, n_x) and controls (B, N, n_u) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return (0.3 * rng.normal(size=(B, jsys.n_x)),
            0.1 * rng.normal(size=(B, N, jsys.n_u)))


def _jax_batched_expansion(jsys, x0s, Us):
    """JAX rollouts of (x0s, Us) and their expansion, vmapped over B."""
    f = jnp.asarray
    Xs = jax.jit(jax.vmap(lambda x, u: it.rollout(jsys, x, u)[0]))(
        f(x0s, jnp.float32), f(Us, jnp.float32))
    exp = jax.jit(jax.vmap(lambda x, u: jax_linearize(jsys, x, u)))(
        Xs, f(Us, jnp.float32))
    return Xs, exp


# ---- B4: the batched backward pass ------------------------------------------

@pytest.mark.parametrize("B,N,reg", [
    (5, 17, 0.013),
    (4, 9, tuple(np.linspace(0.0, 0.2, 4))),
])
def test_b4_plain_matches_jax_batched_kernel_and_vmapped_scan(B, N, reg):
    """The JAX package's own cases and relative tolerance
    (tests/test_pallas_batched.py: rtol 2e-4 in f32), with the absolute
    part scaled to the largest entry: the two frameworks round the
    recursion differently, and on entries of 0.01-0.1 next to gains of
    30-100 that difference (up to 6e-4 absolute) is the f32 error each
    package has against an f64 evaluation of the same expansion (JAX's
    kernel 0.9-3.5e-4, the port's plain version 2.5e-4)."""
    jsys = _jax_dp()
    _, exp = _jax_batched_expansion(jsys, *_random_batch(jsys, B, N, seed=B))
    reg_j = jnp.asarray(reg, jnp.float32)
    ref_kernel = jax_backward_batched(exp, reg_j, interpret=True)
    if reg_j.ndim:
        ref_vmap = jax.vmap(jax_backward)(exp, reg_j)
    else:
        ref_vmap = jax.vmap(lambda e: jax_backward(e, reg_j))(exp)
    reg_t = torch.tensor(np.asarray(reg), dtype=torch.float32)
    got = itt.backward_pass_batched(expansion_from_numpy(exp, device="cpu"),
                                    reg_t if reg_j.ndim else reg)
    assert got[0].shape == (B, N, 2) and got[1].shape == (B, N, 2, 4)
    assert got[2].shape == (B, 2) and got[3].shape == (B,)
    for ref in (ref_kernel, ref_vmap):
        for g, r in zip(got[:3], ref[:3]):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4,
                                       atol=1e-5 * (1.0 + np.abs(r).max()))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("kind,B,N", [("pendulum", 19, 13), ("UA-DP", 11, 7)])
def test_b4_plain_matches_jax_batched_kernel_at_a_ragged_batch(kind, B, N):
    """n_u = 1 at odd N (every instance's l_u, l_uu and u_ff rows start at
    another 4-byte phase, as the CUDA kernel reads them) and a B that fills
    no whole warp of B4's lane groups (16 instances a warp at n_x = 2, 8
    at n_x = 4): the plain version, with ``ok`` per instance, against the
    JAX batched kernel in interpret mode, at the tolerance of
    `test_b4_plain_matches_jax_batched_kernel_and_vmapped_scan`."""
    if kind == "pendulum":
        jsys = _jax_pendulum()
    else:
        jsys = it.make_double_pendulum(
            0.02, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([1.0, 1.0, 0.1, 0.1]),
            R=np.eye(1), Q_f=np.diag([100.0, 100.0, 10.0, 10.0]), d1=0.1,
            d2=0.1, theta1=1 / 12, theta2=1 / 12, underactuated=True,
            integrator="rk4")
    _, exp = _jax_batched_expansion(jsys, *_random_batch(jsys, B, N, seed=N))
    ref = jax_backward_batched(exp, jnp.float32(0.05), interpret=True)
    got = itt.backward_pass_batched(expansion_from_numpy(exp, device="cpu"),
                                    0.05)
    assert got[0].shape == (B, N, 1) and got[3].shape == (B,)
    for g, r in zip(got[:3], ref[:3]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4,
                                   atol=1e-5 * (1.0 + np.abs(r).max()))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].all()


def test_b4_plain_flags_non_finite_instances_only():
    """``ok`` is per instance: a NaN in one instance's expansion clears its
    flag and leaves the others' gains as they were."""
    jsys = _jax_dp()
    _, exp = _jax_batched_expansion(jsys, *_random_batch(jsys, 3, 6, seed=3))
    exp_t = expansion_from_numpy(exp, device="cpu")
    clean = itt.backward_pass_batched(exp_t, 0.0)
    l_uu = exp_t.l_uu.clone()
    l_uu[1, 2] = torch.nan
    dirty = itt.backward_pass_batched(
        dataclasses.replace(exp_t, l_uu=l_uu), 0.0)
    assert clean[3].tolist() == [True, True, True]
    assert dirty[3].tolist() == [True, False, True]
    for i in (0, 2):
        torch.testing.assert_close(dirty[1][i], clean[1][i], rtol=0, atol=0)


# ---- B5: the batched rollouts -------------------------------------------------

def test_b5_plain_matches_jax_batched_rollout_kernels():
    """Candidate costs, per-instance-α trajectories and the open loop,
    against the JAX kernels in interpret mode (f32; the same recursion in
    other operation orders)."""
    jsys = _jax_dp()
    B, N = 3, 9
    x0s, U_old = _random_batch(jsys, B, N, seed=11)
    rng = np.random.default_rng(12)
    u_ff = 0.2 * rng.normal(size=(B, N, 2))
    K = 0.1 * rng.normal(size=(B, N, 2, 4))
    alpha_b = np.array([1.0, 0.25, 0.5])
    f = lambda a: jnp.asarray(a, jnp.float32)
    X_old, _ = _jax_batched_expansion(jsys, x0s, U_old)
    args_j = (f(x0s), f(ALPHAS), X_old, f(U_old), f(u_ff), f(K))
    costs_j = jax_costs_batched(jsys, *args_j, interpret=True)
    traj_j = jax_closed_loop_batched(jsys, f(x0s), f(alpha_b), X_old,
                                     f(U_old), f(u_ff), f(K), interpret=True)
    open_j = jax_open_loop_batched(jsys, f(x0s), f(U_old), interpret=True)

    sys_ = _port(jsys, torch.float32)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    costs = itt.linesearch_costs_batched(sys_, t(x0s), t(ALPHAS), t(X_old),
                                         t(U_old), t(u_ff), t(K))
    traj = itt.closed_loop_rollout_batched(sys_, t(x0s), t(alpha_b),
                                           t(X_old), t(U_old), t(u_ff), t(K))
    open_loop = itt.open_loop_rollout_batched(sys_, t(x0s), t(U_old))
    assert costs.shape == (B, len(ALPHAS))
    pairs = [(costs, costs_j)] + list(zip(traj, traj_j)) + [
        (open_loop[0], open_j[0]), (open_loop[1], open_j[1])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=2e-5 * (np.abs(ref).max() + 1.0))


def test_batched_rollouts_equal_the_single_instance_ones():
    """Instance b of a batched plain rollout is the single-instance rollout
    of instance b, to the bit: the same host loop with a batch axis."""
    jsys = _jax_pendulum("backward_euler")
    sys_ = _port(jsys, torch.float64)
    B, N = 3, 12
    x0s, U = (torch.tensor(a) for a in _random_batch(jsys, B, N, seed=5))
    rng = np.random.default_rng(6)
    u_ff = torch.tensor(0.2 * rng.normal(size=(B, N, 1)))
    K = torch.tensor(0.1 * rng.normal(size=(B, N, 1, 2)))
    X, cost = itt.open_loop_rollout_batched(sys_, x0s, U)
    Xs, Us, cs = itt.linesearch_rollouts(sys_, x0s, ALPHAS, X, U, u_ff, K)
    alpha_b = torch.tensor([0.5, 1.0, 0.125], dtype=torch.float64)
    X1, U1, c1 = itt.closed_loop_rollout_batched(sys_, x0s, alpha_b, X, U,
                                                 u_ff, K)
    for b in range(B):
        Xb, cb = itt.rollout(sys_, x0s[b], U[b])
        torch.testing.assert_close(X[b], Xb, rtol=0, atol=0)
        torch.testing.assert_close(cost[b], cb, rtol=0, atol=0)
        ref = itt.linesearch_rollouts(sys_, x0s[b], ALPHAS, X[b], U[b],
                                      u_ff[b], K[b])
        for got, r in zip((Xs[b], Us[b], cs[b]), ref):
            torch.testing.assert_close(got, r, rtol=0, atol=0)
        one = itt.closed_loop_rollout(sys_, x0s[b], float(alpha_b[b]), X[b],
                                      U[b], u_ff[b], K[b])
        for got, r in zip((X1[b], U1[b], c1[b]), one):
            torch.testing.assert_close(got, r, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_linearize_trajectory_batched_matches_jax_vmap(dtype):
    jsys = _jax_dp("euler")
    B, N = 3, 7
    rng = np.random.default_rng(21)
    X = 0.5 * rng.normal(size=(B, N + 1, 4))
    U = 0.5 * rng.normal(size=(B, N, 2))
    lin = jax.vmap(lambda x, u: jax_linearize(jsys64, x, u))
    if dtype == torch.float64:
        with enable_x64_oracle():
            jsys64 = _f64(jsys)
            ref = jax.jit(lin)(jnp.asarray(X), jnp.asarray(U))
            ref = jax.tree_util.tree_map(np.asarray, ref)
    else:
        jsys64 = jsys
        ref = jax.jit(lin)(jnp.asarray(X, jnp.float32),
                           jnp.asarray(U, jnp.float32))
    got = itt.linearize_trajectory_batched(
        _port(jsys, dtype), torch.tensor(X, dtype=dtype),
        torch.tensor(U, dtype=dtype))
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for name in FIELDS:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.shape == r.shape and g.is_contiguous() and g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=rtol * (np.abs(r).max() + 1.0),
                                   err_msg=name)


# ---- solve_batch: the port's vmap(solve) --------------------------------------

# Two swing-ups from near rest and one instance at the target, which stops
# at its first convergence test while the others run to maxiter.
X0S = np.array([[0.1, 0.0, 0.0, 0.0], [0.0, 0.2, 0.0, 0.0],
                [np.pi, 0.0, 0.0, 0.0]])
SOLVE_CFG = dict(maxiter=15, tol=1e-7)


def _compare(sol, ref, rtol_cost, atol_x):
    """Per-instance agreement of a batched port solution with JAX's."""
    np.testing.assert_array_equal(sol.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(sol.status.numpy(), ref.status)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=rtol_cost)
    np.testing.assert_allclose(sol.cost.numpy(), ref.cost, rtol=rtol_cost,
                               atol=1e-12)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=atol_x)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=10 * atol_x)


@pytest.mark.parametrize("rollout", ["scan", "pallas"])
@pytest.mark.parametrize("backward", ["scan", "pallas", "pscan"])
def test_solve_batch_matches_jax_vmap_solve_f64(rollout, backward):
    """`tests/test_pallas_batched.py`'s DP config with a third instance at
    the target.  JAX's vmapped 'pallas' backward pass cannot run in f64 on
    the CPU (its interpret-mode kernel stores f32), so JAX runs 'scan'
    against the port's 'pallas' here — the same sequential recursion,
    which is what the port's batched 'pallas' engine (B4) computes; the
    f32 test below holds both packages' 'pallas' engines to each other."""
    jsys = _jax_dp()
    N = 24
    cfg = dict(SOLVE_CFG, rollout=rollout, backward=backward)
    with enable_x64_oracle():
        j64 = _f64(jsys)
        jcfg = it.IlqrConfig(**dict(
            cfg, backward="scan" if backward == "pallas" else backward))
        ref = jax.jit(jax.vmap(lambda x: it.solve(
            j64, x, jnp.zeros((N, 2)), jcfg)))(jnp.asarray(X0S))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    f64 = dict(dtype=torch.float64)
    sol = itt.solve_batch(_port(jsys, torch.float64),
                          torch.tensor(X0S, **f64), torch.zeros((N, 2), **f64),
                          itt.IlqrConfig(**cfg))
    assert sol.X.shape == (3, N + 1, 4) and sol.K.shape == (3, N, 2, 4)
    assert sol.cost_trace.shape == (3, 15)
    # The stopped instance: CONVERGED after one iteration, the rest of its
    # traces NaN; the running ones use the whole budget.
    assert sol.status.tolist() == [itt.MAXITER, itt.MAXITER, itt.CONVERGED]
    assert sol.iterations.tolist() == [15, 15, 1]
    assert np.isnan(sol.cost_trace[2, 1:].numpy()).all()
    assert not sol.defect_latch.any()
    _compare(sol, ref, rtol_cost=1e-8, atol_x=1e-7)


def test_solve_batch_pallas_engines_match_jax_f32_pendulum():
    """Both packages' 'pallas' engines in f32 (JAX: the vmapped fused
    kernel in interpret mode; the port: B4's and B5's plain versions), on
    the pendulum, where f32 trajectories do not jump basins."""
    jsys = _jax_pendulum()
    x0s = np.array([[1.0, 0.0], [0.3, 0.0], [np.pi, 0.0]], np.float32)
    N = 30
    cfg = dict(maxiter=10, tol=1e-4, backward="pallas", rollout="pallas")
    ref = jax.jit(jax.vmap(lambda x: it.solve(
        jsys, x, jnp.zeros((N, 1)), it.IlqrConfig(**cfg))))(
        jnp.asarray(x0s))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    sol = itt.solve_batch(_port(jsys, torch.float32), torch.tensor(x0s),
                          torch.zeros((N, 1)), itt.IlqrConfig(**cfg))
    assert sol.status.tolist() == [itt.CONVERGED] * 3
    _compare(sol, ref, rtol_cost=2e-5, atol_x=2e-4)


def test_solve_batch_backward_euler_pallas_rollouts_match_jax_vmap_f64():
    """Batched backward-Euler solves with rollout='pallas' (on CUDA: B5's
    implicit step; here its plain versions) against ``jax.vmap(solve)``,
    f64, on the reference's pendulum MPC solver system."""
    jsys = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]),
                            R=np.eye(1), Q_f=np.diag([10.0, 10.0]), d=0.0,
                            integrator="backward_euler")
    x0s = np.array([[0.0, 0.0], [0.5, 0.1], [np.pi, 0.0]])
    N = 40
    cfg = dict(maxiter=8, tol=1e-6, rollout="pallas")
    with enable_x64_oracle():
        j64 = _f64(jsys)
        ref = jax.jit(jax.vmap(lambda x: it.solve(
            j64, x, jnp.zeros((N, 1)), it.IlqrConfig(**cfg))))(
            jnp.asarray(x0s))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    f64 = dict(dtype=torch.float64)
    sol = itt.solve_batch(_port(jsys, torch.float64),
                          torch.tensor(x0s, **f64),
                          torch.zeros((N, 1), **f64), itt.IlqrConfig(**cfg))
    assert sol.status[2] == itt.CONVERGED
    _compare(sol, ref, rtol_cost=1e-8, atol_x=1e-7)


def test_solve_batch_equals_the_ports_single_instance_solves():
    """Instance b of `solve_batch` is `solve` from x0s[b] (f64, the
    pendulum golden's backward-Euler system; two instances stop early)."""
    jsys = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=np.zeros((2, 2)), d=0.0,
                            integrator="backward_euler")
    sys_ = _port(jsys, torch.float64)
    x0s = torch.tensor([[1.0, 0.0], [np.pi, 0.0], [0.5, 0.1], [2.0, -1.0]],
                       dtype=torch.float64)
    N = 60
    for rollout in ("scan", "pallas"):
        cfg = itt.IlqrConfig(maxiter=12, tol=1e-6, rollout=rollout)
        sol = itt.solve_batch(sys_, x0s, torch.zeros((N, 1),
                                                     dtype=torch.float64), cfg)
        assert len(set(sol.iterations.tolist())) > 1
        for b in range(4):
            one = itt.solve(sys_, x0s[b], torch.zeros((N, 1),
                                                      dtype=torch.float64), cfg)
            assert (one.iterations, one.status) == (int(sol.iterations[b]),
                                                    int(sol.status[b]))
            torch.testing.assert_close(sol.cost[b], one.cost, rtol=1e-12,
                                       atol=1e-12)
            torch.testing.assert_close(sol.X[b], one.X, rtol=0, atol=1e-10)
            torch.testing.assert_close(sol.alpha_trace[b], one.alpha_trace,
                                       rtol=0, atol=0, equal_nan=True)


# ---- parallel.solve_batched / solve_multistart --------------------------------

def test_solve_batched_shares_a_two_dimensional_U_init():
    jsys = _jax_pendulum()
    sys_ = _port(jsys, torch.float64)
    x0s = torch.tensor([[1.0, 0.0], [0.2, 0.0]], dtype=torch.float64)
    U0 = 0.1 * torch.ones((20, 1), dtype=torch.float64)
    cfg = itt.IlqrConfig(maxiter=6)
    shared = itt.solve_batched(sys_, x0s, U0, cfg)
    full = itt.solve_batch(sys_, x0s, U0.expand(2, 20, 1), cfg)
    for f in ("X", "U", "cost", "iterations", "status", "cost_trace"):
        torch.testing.assert_close(getattr(shared, f), getattr(full, f),
                                   equal_nan=True)


def test_solve_multistart_picks_the_start_jax_picks():
    """Four starts of the pendulum swing-up; the best is the lowest cost
    among those that did not fail the line search (f64 on both sides)."""
    jsys = _jax_pendulum()
    rng = np.random.default_rng(3)
    U_inits = 2.0 * rng.normal(size=(4, 40, 1))
    x0 = np.array([0.0, 0.0])
    cfg = dict(maxiter=20, tol=1e-6)
    with enable_x64_oracle():
        best_j, sols_j = jax_multistart(_f64(jsys), jnp.asarray(x0),
                                        jnp.asarray(U_inits),
                                        it.IlqrConfig(**cfg))
        best_j, sols_j = jax.tree_util.tree_map(np.asarray, (best_j, sols_j))
    best, sols = itt.solve_multistart(
        _port(jsys, torch.float64), torch.tensor(x0), torch.tensor(U_inits),
        itt.IlqrConfig(**cfg))
    np.testing.assert_allclose(sols.cost.numpy(), sols_j.cost, rtol=1e-9)
    np.testing.assert_array_equal(sols.status.numpy(), sols_j.status)
    assert isinstance(best.iterations, int) and isinstance(best.status, int)
    assert (best.iterations, best.status) == (int(best_j.iterations),
                                              int(best_j.status))
    np.testing.assert_allclose(float(best.cost), float(best_j.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(best.U.numpy(), best_j.U, atol=1e-8)


# ---- what the batched path refuses --------------------------------------------

def test_mesh_and_batched_parallel_linesearches_raise():
    sys_ = _port(_jax_pendulum(), torch.float32)
    x0s, U0 = torch.zeros((2, 2)), torch.zeros((5, 1))
    with pytest.raises(NotImplementedError, match="A19"):
        itt.solve_batched(sys_, x0s, U0, mesh=object())
    with pytest.raises(NotImplementedError, match="A19"):
        itt.solve_multistart(sys_, x0s[0], U0.expand(2, 5, 1), mesh=object())
    with pytest.raises(NotImplementedError, match="A19"):
        itt.run_mpc_sharded(sys_, sys_, x0s, U0, 2, mesh=object())
    # Limits, ddp, noise, adaptive_reg (A12c) and the parallel line
    # searches (A12b) run batched (tests/test_torch_batch_options.py and
    # tests/test_torch_batch_parallel.py hold them to JAX).
    for kw in (dict(u_min=-1.0, u_max=1.0), dict(ddp=True),
               dict(noise=lambda x, u: 0.1 * x[:, None]),
               dict(adaptive_reg=True), dict(rollout="defect"),
               dict(rollout="chunked")):
        sol = itt.solve_batch(sys_, x0s, U0, itt.IlqrConfig(maxiter=3, **kw))
        assert bool(torch.isfinite(sol.cost).all()), kw
    with pytest.raises(ValueError, match="x0s"):
        itt.solve_batch(sys_, torch.zeros(2), U0)
    with pytest.raises(ValueError, match="U_init"):
        itt.solve_batch(sys_, x0s, torch.zeros((3, 5, 1)))


def test_batched_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The checks that run before a CUDA launch (here on CPU tensors), and
    the wrappers on a device with no kernel."""
    dp = _port(_jax_dp("euler"), torch.float32)
    B, N = 3, 5
    good = dict(x0s=torch.zeros(B, 4), U_old=torch.zeros(B, N, 2),
                X_old=torch.zeros(B, N + 1, 4), u_ff=torch.zeros(B, N, 2),
                K=torch.zeros(B, N, 2, 4))
    assert batched._check_rollout(dp, **good) == (B, N)
    for key, value in (("x0s", torch.zeros(B, 4, dtype=torch.float64)),
                       ("X_old", torch.zeros(B, N, 4)),
                       ("K", torch.zeros(B, N, 4, 2).transpose(2, 3)),
                       ("U_old", torch.zeros(N, 2))):
        with pytest.raises((TypeError, ValueError)):
            batched._check_rollout(dp, **{**good, key: value})
    exp = itt.linearize_trajectory_batched(dp, good["X_old"], good["U_old"])
    batched._check_expansion(exp)
    for name, value in (("f_x", exp.f_x.double()),
                        ("l_uu", exp.l_uu.transpose(2, 3)),
                        ("v_x", exp.v_x[:2])):
        with pytest.raises((TypeError, ValueError)):
            batched._check_expansion(dataclasses.replace(exp, **{name: value}))
    with pytest.raises(ValueError, match="reg"):
        batched._reg_vector(torch.zeros(2), B, exp.f_x)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="meta"):
        itt.backward_pass_batched(dataclasses.replace(
            exp, **{f: getattr(exp, f).to(**meta) for f in FIELDS}))
    with pytest.raises(ValueError, match="meta"):
        itt.open_loop_rollout_batched(dp, good["x0s"].to(**meta),
                                      good["U_old"].to(**meta))


def test_associative_gains_are_contiguous_for_the_rollout_kernels():
    """`backward_pass_associative` (backward='pscan') returned K as a
    strided view of its solve; the CUDA rollout kernels' checks refuse
    non-contiguous gains, so solve(backward='pscan', rollout='pallas')
    raised on a GPU.  Its gains now pass those checks."""
    dp = _port(_jax_dp("euler"), torch.float32)
    N = 8
    x0, U = torch.zeros(4), torch.zeros((N, 2))
    X, _ = itt.rollout(dp, x0, U)
    u_ff, K, _, _ = itt.backward_pass_associative(
        itt.linearize_trajectory(dp, X, U), 0.0)
    assert fused_rollout._check(dp, x0, X, U, u_ff, K) == N
