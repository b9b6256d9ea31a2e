"""Control limits in the port against ilqr_tpu.

* `boxqp` / `boxqp_with_gains` against JAX's and the enumeration oracle of
  tests/test_boxqp.py, one problem at a time and as a stack;
* the sequential `backward_pass_limited` and the frozen-active-set
  `backward_pass_limited_parallel` (both engines; 'pallas' runs its plain
  version on CPU tensors), with and without DDP Hessians and iLQG noise;
* the clamped rollouts (scan, defect, chunked);
* `solve` with ``u_min``/``u_max`` on every backward engine and the
  parallel line searches, and `run_mpc_rti` with limits: traces, status
  and iterations against `ilqr_tpu` in f64.

The same seeded numpy inputs go to both packages; JAX runs its 'xla'
engines where the port runs 'pallas' (JAX's Pallas kernels take f32 only).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.ilqg import noise_expansion as jax_noise_expansion
from ilqr_tpu.ops import chunked_rollout as jax_chunked
from ilqr_tpu.ops import parallel_rollout as jax_parallel
from ilqr_tpu.ops.boxqp import boxqp as jax_boxqp
from ilqr_tpu.ops.boxqp import boxqp_with_gains as jax_boxqp_gains
from ilqr_tpu.ops.limited_parallel import (
    backward_pass_limited_parallel as jax_limited_parallel,
)
from ilqr_tpu.ops.limited_parallel import masked_expansion as jax_masked
from ilqr_tpu.ops.linearize import dynamics_hessians as jax_hessians
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.riccati import backward_pass_limited as jax_limited
from ilqr_tpu.ops.rollout import closed_loop_rollout as jax_closed_loop
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy
from ilqr_tpu_torch.ops import chunked_rollout, limited_parallel
from ilqr_tpu_torch.ops import parallel_rollout

torch.set_num_threads(1)

LIMIT = 2.0


def _oracle(H, g, lo, hi):
    """Exact box-QP minimizer by enumerating all 3^n activity patterns
    (tests/test_boxqp.py)."""
    n = g.shape[0]
    best, best_val = None, np.inf
    for pattern in itertools.product((-1, 0, 1), repeat=n):
        clamped = [i for i, p in enumerate(pattern) if p != 0]
        free = [i for i, p in enumerate(pattern) if p == 0]
        d = np.zeros(n)
        d[clamped] = [lo[i] if pattern[i] < 0 else hi[i] for i in clamped]
        if free:
            rhs = -g[free]
            if clamped:
                rhs = rhs - H[np.ix_(free, clamped)] @ d[clamped]
            d[free] = np.linalg.solve(H[np.ix_(free, free)], rhs)
        if np.any(d < lo - 1e-9) or np.any(d > hi + 1e-9):
            continue
        val = 0.5 * d @ H @ d + g @ d
        if val < best_val - 1e-12:
            best, best_val = d, val
    return best


def _qp_stack(n, S, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((S, n, n))
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    g = 3.0 * rng.standard_normal((S, n))
    lo = -0.5 - 0.3 * rng.random((S, n))
    hi = 0.8 + 0.3 * rng.random((S, n))
    return H, g, lo, hi


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_boxqp_matches_jax_and_the_oracle(n):
    """f64: the fixed 8 projected-Newton iterations find the oracle's
    minimizer (atol 1e-9) and JAX's iterate (1e-12), one problem at a time
    and as a stack of 6 (leading batch axis)."""
    H, g, lo, hi = _qp_stack(n, 6, seed=n)
    d, free = itt.boxqp(*map(torch.tensor, (H, g, lo, hi)))
    assert d.shape == (6, n) and free.shape == (6, n)
    with enable_x64_oracle():
        d_j, free_j = jax.vmap(jax_boxqp)(*map(jnp.asarray, (H, g, lo, hi)))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(free.numpy(), np.asarray(free_j))
    for s in range(6):
        np.testing.assert_allclose(d[s].numpy(),
                                   _oracle(H[s], g[s], lo[s], hi[s]),
                                   atol=1e-9)
        one, _ = itt.boxqp(*(torch.tensor(a[s]) for a in (H, g, lo, hi)))
        np.testing.assert_allclose(one.numpy(), d[s].numpy(), rtol=1e-14,
                                   atol=1e-14)


def test_boxqp_with_gains_matches_jax():
    """K solves the free subsystem and is zero on clamped rows; f64 against
    JAX, and f32 within 1e-5."""
    H, g, lo, hi = _qp_stack(3, 8, seed=11)
    rhs = np.random.default_rng(12).standard_normal((8, 3, 4))
    with enable_x64_oracle():
        ref = jax.vmap(jax_boxqp_gains)(*map(jnp.asarray,
                                             (H, g, lo, hi, rhs)))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        d, free, K = itt.boxqp_with_gains(
            *(torch.tensor(a, dtype=dtype) for a in (H, g, lo, hi, rhs)))
        assert K.shape == (8, 3, 4) and K.dtype == dtype
        for got, want in zip((d, free, K), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=tol, atol=tol)
        assert bool((K * (1.0 - free)[..., None] == 0).all())
        assert (free == 0).any() and (free == 1).any()


def _jax_pendulum():
    # tests/test_limited_parallel.py's torque-limited pendulum.
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                            R=0.1 * np.eye(1), Q_f=100.0 * np.eye(2), d=0.0,
                            integrator="rk4")


def _port(jsys, dtype):
    kind = "pendulum" if jsys.n_x == 2 else "double_pendulum"
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


def _f64(jsys):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jsys)


def _noise(xp):
    def fn(x, u):
        return 0.05 * xp.ones((2, 1), dtype=x.dtype) * (1.0 + 0.1 * x[0])
    return fn


def _limited_case(N=60, terms=()):
    """A nominal like bench.py's limited-backward cell (U = clip(2.5 sin,
    ±2)) on a short horizon, as numpy f64: (exp, U, hess, noise)."""
    jsys = _jax_pendulum()
    U = np.clip(2.5 * np.sin(np.linspace(0.0, 6.0, N)), -LIMIT, LIMIT)[:, None]
    with enable_x64_oracle():
        j64 = _f64(jsys)
        Uj = jnp.asarray(U)
        X, _ = jax.jit(it.rollout)(j64, jnp.zeros(2), Uj)
        exp = jax.tree_util.tree_map(np.asarray,
                                     jax.jit(jax_linearize)(j64, X, Uj))
        hess = (jax.tree_util.tree_map(np.asarray,
                                       jax.jit(jax_hessians)(j64, X, Uj))
                if "hess" in terms else None)
        noise = (tuple(np.asarray(a) for a in jax.jit(
            lambda X, U: jax_noise_expansion(_noise(jnp), X, U))(X, Uj))
            if "noise" in terms else None)
    return exp, U, hess, noise


def _to_jax(exp, U, hess, noise, dtype):
    conv = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return (jax.tree_util.tree_map(conv, exp), conv(U),
            None if hess is None else jax.tree_util.tree_map(conv, hess),
            None if noise is None else tuple(map(conv, noise)))


def _to_port(exp, U, hess, noise, dtype):
    conv = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return (expansion_from_numpy(exp, device="cpu", dtype=dtype), conv(U),
            None if hess is None else itt.DynamicsHessians(
                conv(hess.f_xx), conv(hess.f_ux), conv(hess.f_uu)),
            None if noise is None else tuple(map(conv, noise)))


def _close(got, ref, rtol):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(r).max()))


TERMS = [(), ("hess",), ("noise",)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("terms", TERMS)
def test_backward_pass_limited_matches_jax(terms, dtype):
    """The sequential box-QP pass.  f64: rtol 1e-9; f32: the same recursion
    in two frameworks' roundings, rtol 1e-4 (relative to the larger of 1
    and the field's largest entry)."""
    case = _limited_case(terms=terms)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32

    def ref():
        exp, U, h, nz = _to_jax(*case, jdt)
        return jax.jit(jax_limited)(exp, U, -LIMIT, LIMIT, 0.01, hess=h,
                                    noise=nz)

    if dtype == torch.float64:
        with enable_x64_oracle():
            want = ref()
    else:
        want = ref()
    exp, U, h, nz = _to_port(*case, dtype)
    got = itt.backward_pass_limited(exp, U, -LIMIT, LIMIT, 0.01, hess=h,
                                    noise=nz)
    assert bool(got[3])
    # Some controls sit at their bounds: the feedforward respects them.
    u_new = U + got[0]
    assert float(u_new.abs().max()) <= LIMIT + 1e-6
    _close(got[:3], want[:3], 1e-9 if dtype == torch.float64 else 1e-4)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("terms", TERMS + [("hess", "noise")])
def test_backward_pass_limited_parallel_matches_jax(terms, engine):
    """The frozen-active-set pass (12 sweeps, doubled with ``hess`` or
    ``noise``) against JAX's 'xla' engine in f64: the same sweeps and set
    changes, rtol 1e-9."""
    case = _limited_case(terms=terms)
    with enable_x64_oracle():
        exp, U, h, nz = _to_jax(*case, jnp.float64)
        want = jax.jit(jax_limited_parallel, static_argnames=(
            "sweeps", "engine"))(exp, U, -LIMIT, LIMIT, 0.01, sweeps=12,
                                 engine="xla", hess=h, noise=nz)
    exp, U, h, nz = _to_port(*case, torch.float64)
    got = itt.backward_pass_limited_parallel(exp, U, -LIMIT, LIMIT, 0.01,
                                             sweeps=12, engine=engine,
                                             hess=h, noise=nz)
    assert bool(got[3]) and got[1].is_contiguous()
    _close(got[:3], want[:3], 1e-9)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("terms", [(), ("hess",)])
def test_backward_pass_limited_parallel_mixed_set_matches_jax(terms, engine):
    """A mixed active set, where `_limited_case` clamps every control:
    bench.py's limited-backward nominal (Q = R = I, Q_f = 0, U = clip(2.5
    sin, ±2)) at N = 1024 under ±1, the nominal clipped to them.  Against
    JAX's 'xla' engine in f64, rtol 1e-9, with the same clamped controls."""
    N, lim = 1024, 1.0
    U = np.clip(np.clip(2.5 * np.sin(np.linspace(0.0, 40.0, N)), -2.0, 2.0),
                -lim, lim)[:, None]
    with enable_x64_oracle():
        jsys = _f64(it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                                     R=np.eye(1), Q_f=np.zeros((2, 2)),
                                     d=0.0, integrator="rk4"))
        Uj = jnp.asarray(U)
        X, _ = jax.jit(it.rollout)(jsys, jnp.zeros(2), Uj)
        exp = jax.tree_util.tree_map(np.asarray,
                                     jax.jit(jax_linearize)(jsys, X, Uj))
        hess = (jax.tree_util.tree_map(np.asarray,
                                       jax.jit(jax_hessians)(jsys, X, Uj))
                if terms else None)
        exp_j, U_j, h_j, _ = _to_jax(exp, U, hess, None, jnp.float64)
        want = jax.jit(jax_limited_parallel, static_argnames=(
            "sweeps", "engine"))(exp_j, U_j, -lim, lim, 0.0, engine="xla",
                                 hess=h_j)
    exp_t, U_t, h_t, _ = _to_port(exp, U, hess, None, torch.float64)
    got = itt.backward_pass_limited_parallel(exp_t, U_t, -lim, lim, 0.0,
                                             engine=engine, hess=h_t)
    assert bool(got[3])
    _close(got[:3], want[:3], 1e-9)
    u_new = U_t[:, 0] + got[0][:, 0]
    clamped = ((u_new.abs() - lim).abs() <= 1e-9) & (got[1][:, 0].abs()
                                                     .amax(-1) == 0)
    want_u = U[:, 0] + np.asarray(want[0])[:, 0]
    want_clamped = ((np.abs(np.abs(want_u) - lim) <= 1e-9)
                    & (np.abs(np.asarray(want[1])[:, 0]).max(-1) == 0))
    np.testing.assert_array_equal(clamped.numpy(), want_clamped)
    assert N // 10 <= int(clamped.sum()) <= N - N // 10


def test_limited_parallel_with_inactive_bounds_is_the_plain_pass():
    exp, U, _, _ = _to_port(*_limited_case(), torch.float64)
    got = itt.backward_pass_limited_parallel(exp, U, -1e6, 1e6, 0.0)
    plain = itt.backward_pass(exp, 0.0)
    _close(got[:3], [p.numpy() for p in plain[:3]], 1e-9)
    with pytest.raises(ValueError, match="engine"):
        itt.backward_pass_limited_parallel(exp, U, -1.0, 1.0, engine="cuda")


def test_masked_expansion_matches_jax():
    exp_np, U, _, _ = _limited_case(N=20)
    rng = np.random.default_rng(4)
    free = (rng.random((20, 1)) < 0.6).astype(np.float64)
    du_c = (1.0 - free) * rng.choice([-0.5, 0.7], size=(20, 1))
    with enable_x64_oracle():
        exp_j = jax.tree_util.tree_map(jnp.asarray, exp_np)
        ref_e, ref_d = jax_masked(exp_j, jnp.asarray(du_c),
                                  jnp.asarray(free))
    got_e, got_d = limited_parallel.masked_expansion(
        expansion_from_numpy(exp_np, device="cpu", dtype=torch.float64),
        torch.tensor(du_c), torch.tensor(free))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-14)
    for f in ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x",
              "v_xx"):
        np.testing.assert_allclose(getattr(got_e, f).numpy(),
                                   np.asarray(getattr(ref_e, f)),
                                   rtol=1e-14, atol=1e-15)


def _rollout_case():
    """A limited backward pass's gains along the clipped-sine nominal."""
    exp, U, _, _ = _limited_case(N=80)
    with enable_x64_oracle():
        exp_j = jax.tree_util.tree_map(jnp.asarray, exp)
        u_ff, K, _, _ = jax.jit(jax_limited)(exp_j, jnp.asarray(U), -LIMIT,
                                              LIMIT, 0.0)
        X, _ = jax.jit(it.rollout)(_f64(_jax_pendulum()), jnp.zeros(2),
                                   jnp.asarray(U))
    return tuple(map(np.asarray, (X, U, u_ff, K))), exp


@pytest.mark.parametrize("kind", ["scan", "defect", "chunked"])
def test_clamped_rollouts_match_jax(kind):
    """Each applied control is clipped inside the recursion, as JAX clips;
    f64, four α candidates, limits ±1.5 (tighter than the nominal's, so the
    candidates clamp).  A step of the two packages differs by an ulp (XLA
    fuses the rk4 stages), and the closed loop grows that to ~1e-7 of the
    cost over 80 steps: held to 1e-6 of 1 + max|JAX|."""
    (X, U, u_ff, K), exp = _rollout_case()
    alphas = np.array([1.0, 0.5, 0.25, 0.125])
    lim = 1.5
    x0 = np.zeros(2)
    j = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    with enable_x64_oracle():
        jsys = _f64(_jax_pendulum())
        jl = (j(-lim), j(lim))
        exp_j = jax.tree_util.tree_map(j, exp)
        A_cl = exp_j.f_x + exp_j.f_u @ j(K)
        if kind == "scan":
            one = jax.jit(jax_closed_loop)
            ref = [one(jsys, j(x0), a, j(X), j(U), j(u_ff), j(K),
                       u_limits=jl) for a in alphas]
            ref = [jnp.stack(r) for r in zip(*ref)]
        elif kind == "defect":
            ref = jax.jit(jax_parallel.linesearch_defect_rollouts,
                          static_argnames=("iters", "engine"))(
                jsys, j(x0), j(alphas), j(X), j(U), j(u_ff), j(K), exp_j,
                iters=8, engine="xla", u_limits=jl)
            ref1 = jax.jit(jax_parallel.defect_rollout,
                           static_argnames=("iters", "engine"))(
                jsys, j(x0), 0.5, j(X), j(U), j(u_ff), j(K), A_cl, iters=8,
                engine="xla", u_limits=jl)
        else:
            ref = jax.jit(jax_chunked.linesearch_chunked_rollouts,
                          static_argnames=("sweeps", "chunk_len"))(
                jsys, j(x0), j(alphas), j(X), j(U), j(u_ff), j(K), A_cl,
                sweeps=4, chunk_len=16, u_limits=jl)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sys_ = _port(_jax_pendulum(), torch.float64)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    tl = (t(-lim), t(lim))
    args = (sys_, t(x0), t(alphas), t(X), t(U), t(u_ff), t(K))
    exp_t = expansion_from_numpy(exp, device="cpu", dtype=torch.float64)
    A_cl = exp_t.f_x + exp_t.f_u @ t(K)
    tol = 1e-6
    if kind == "scan":
        got = itt.linesearch_rollouts(*args, u_limits=tl)
        one = itt.closed_loop_rollout(sys_, t(x0), 0.5, t(X), t(U), t(u_ff),
                                      t(K), u_limits=tl)
        for g, r in zip(one, got):
            np.testing.assert_allclose(g.numpy(), r[1].numpy(), rtol=1e-14)
    elif kind == "defect":
        got = parallel_rollout.linesearch_defect_rollouts(
            *args, exp_t, iters=8, engine="pallas", u_limits=tl)
        one = parallel_rollout.defect_rollout(
            sys_, t(x0), 0.5, t(X), t(U), t(u_ff), t(K), A_cl, iters=8,
            engine="pallas", u_limits=tl)
        for g, r in zip(one, ref1):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol,
                                       atol=tol * (1.0 + np.abs(r).max()))
    else:
        got = chunked_rollout.linesearch_chunked_rollouts(
            *args, A_cl, sweeps=4, chunk_len=16, u_limits=tl)
    U_c = got[1].numpy()
    assert np.abs(U_c).max() <= lim and np.isclose(np.abs(U_c).max(), lim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=tol,
                                   atol=tol * (1.0 + np.abs(r).max()))


def _solve_both(cfg_kw, N=150, jax_kw=None):
    jsys = _jax_pendulum()
    with enable_x64_oracle():
        ref = jax.jit(it.solve, static_argnums=3)(
            _f64(jsys), jnp.zeros(2), jnp.zeros((N, 1)),
            it.IlqrConfig(**dict(cfg_kw, **(jax_kw or {}))))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sol = itt.solve(_port(jsys, torch.float64), np.zeros(2),
                    np.zeros((N, 1)), itt.IlqrConfig(**cfg_kw))
    return sol, ref


@pytest.mark.parametrize("backward,rollout", [
    ("scan", "scan"), ("pscan", "scan"), ("pallas", "defect"),
    ("scan", "chunked")])
def test_limited_solve_traces_match_jax(backward, rollout):
    """The torque-limited pendulum swing-up (±2, N = 150): sequential and
    parallel limited backward passes, with the exact, defect and chunked
    line searches; JAX runs 'pscan' where the port runs 'pallas'."""
    cfg = dict(maxiter=30, tol=1e-9, u_min=-LIMIT, u_max=LIMIT,
               backward=backward, rollout=rollout)
    sol, ref = _solve_both(cfg, jax_kw=dict(
        backward=backward.replace("pallas", "pscan")))
    assert sol.iterations >= 5 and sol.status == itt.CONVERGED
    assert (sol.iterations, sol.status) == (int(ref.iterations),
                                            int(ref.status))
    assert sol.defect_latch == bool(ref.defect_latch)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-9)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-7)
    assert float(sol.U.abs().max()) <= LIMIT
    assert float(sol.U.abs().max()) == pytest.approx(LIMIT)


def test_limited_ddp_ilqg_adaptive_solve_matches_jax():
    """Limits, DDP, iLQG noise and adaptive_reg together through the
    parallel pass ('pallas', plain here; JAX 'pscan')."""
    cfg = dict(maxiter=20, tol=1e-9, u_min=-LIMIT, u_max=LIMIT, ddp=True,
               noise=_noise(torch), adaptive_reg=True, backward="pallas")
    sol, ref = _solve_both(cfg, N=100, jax_kw=dict(noise=_noise(jnp),
                                                   backward="pscan"))
    assert sol.iterations >= 3
    assert (sol.iterations, sol.status) == (int(ref.iterations),
                                            int(ref.status))
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-9)


def test_initial_guess_is_clipped():
    """U_init outside the box is clipped before the initial rollout."""
    sys_ = _port(_jax_pendulum(), torch.float64)
    sol = itt.solve(sys_, np.zeros(2), np.full((30, 1), 5.0),
                    itt.IlqrConfig(maxiter=1, u_min=-LIMIT, u_max=LIMIT))
    assert float(sol.U.abs().max()) <= LIMIT
    lo, hi = itt.IlqrConfig(u_min=-1.0, u_max=(2.0,)).limit_arrays(
        1, torch.float64)
    assert lo.tolist() == [-1.0] and hi.tolist() == [2.0]
    assert itt.IlqrConfig().limit_arrays(1, torch.float64) is None


def test_run_mpc_rti_clips_to_limits_as_jax():
    """RTI MPC with limits ±1: the tracked control u = U[j] + K[j](x − X[j])
    is clipped, as JAX clips it (f64, horizon 40, 12 steps re-solved every
    3; the plant has more damping than the solver's model)."""
    jsys = _jax_pendulum()
    plant_j = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                               R=0.1 * np.eye(1), Q_f=100.0 * np.eye(2),
                               d=0.2, integrator="rk4")
    kw = dict(maxiter=4, tol=1e-9, u_min=-1.0, u_max=1.0)
    with enable_x64_oracle():
        ref = jax_mpc.run_mpc_rti(_f64(jsys), _f64(plant_j),
                                  jnp.array([0.3, 0.0]), jnp.zeros((40, 1)),
                                  12, it.IlqrConfig(**kw), resolve_every=3)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    got = itt.run_mpc_rti(_port(jsys, torch.float64),
                          _port(plant_j, torch.float64), np.array([0.3, 0.0]),
                          np.zeros((40, 1)), 12, itt.IlqrConfig(**kw),
                          resolve_every=3)
    assert float(got.U.abs().max()) <= 1.0
    np.testing.assert_allclose(got.U.numpy(), ref.U, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.X.numpy(), ref.X, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-9)
    np.testing.assert_array_equal(got.solve_iters.numpy(), ref.solve_iters)
