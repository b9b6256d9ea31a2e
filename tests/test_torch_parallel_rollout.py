"""The port's parallel-in-time rollouts against ilqr_tpu's.

Defect-correction (closed- and open-loop) and chunked rollouts on the
pendulum (rk4) and the double pendulum (euler) at N ≈ 250, from the same
numpy inputs, in f32 and in f64 (JAX under `enable_x64_oracle`).  The
port's defect sweeps run with ``engine='pallas'``, whose CPU path is the
plain prefix scan; JAX runs ``engine='xla'`` so that no interpret-mode
Pallas loop is compiled.  The CUDA kernel behind the port's 'pallas'
engine is checked against the plain scan on the GPU by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops import chunked_rollout as jax_chunked
from ilqr_tpu.ops import parallel_rollout as jax_parallel
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.ops.rollout import closed_loop_rollout as jax_closed_loop
from ilqr_tpu.ops.rollout import rollout as jax_rollout
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy
from ilqr_tpu_torch.ops import chunked_rollout, parallel_rollout

torch.set_num_threads(1)

ALPHAS = (1.0, 0.5, 0.25, 0.125)
# Tolerances relative to 1 + max|reference|.  f32: Newton sweeps to the
# f32 floor in other operation orders (the defects themselves are compared
# to an absolute 1e-4: near the floor they are rounding noise).  f64: the
# same sweeps agree to rounding amplified by the closed loop.
TOL = {torch.float32: 2e-4, torch.float64: 1e-9}


def _jax_system(name):
    if name == "pendulum":
        return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                Q_f=10.0 * np.eye(2), d=0.1, integrator="rk4")
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler")


def _case(name, dtype, N=250):
    """JAX nominal (X, U), expansion and gains as numpy, and the port's
    system, both in ``dtype``."""
    jsys = _jax_system(name)
    rng = np.random.default_rng(N)
    x0 = 0.2 * rng.normal(size=jsys.n_x)
    U = 0.3 * np.sin(np.linspace(0, 6, N))[:, None] * np.ones(jsys.n_u)
    U = U + 0.05 * rng.normal(size=U.shape)

    def run(jsys, dt):
        X, _ = jax.jit(jax_rollout)(jsys, jnp.asarray(x0, dt),
                                    jnp.asarray(U, dt))
        exp = jax.jit(jax_linearize)(jsys, X, jnp.asarray(U, dt))
        u_ff, K, _, _ = jax.jit(jax_backward)(exp, 0.0)
        return jax.tree_util.tree_map(np.asarray, (X, exp, u_ff, K))

    x64 = dtype == torch.float64
    if x64:
        with enable_x64_oracle():
            j64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys)
            X, exp, u_ff, K = run(j64, jnp.float64)
    else:
        X, exp, u_ff, K = run(jsys, jnp.float32)
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    sys_ = system_from_numpy(name if name == "pendulum" else "double_pendulum",
                             params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, dtype=dtype, device="cpu")
    return jsys, sys_, dict(x0=x0, X=X, U=U, u_ff=u_ff, K=K, exp=exp)


def _jax(fn, jsys, dtype, *args, **kw):
    """Run a JAX function jitted in ``dtype``; numpy arrays in and out."""
    dt = jnp.float64 if dtype == torch.float64 else jnp.float32
    cast = lambda a: jax.tree_util.tree_map(lambda v: jnp.asarray(v, dt), a)

    def run():
        out = jax.jit(fn, static_argnames=tuple(kw))(cast(jsys), *map(cast, args),
                                                     **kw)
        return jax.tree_util.tree_map(np.asarray, out)

    if dtype == torch.float64:
        with enable_x64_oracle():
            return run()
    return run()


def _close(got, ref, dtype, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=TOL[dtype] * (1.0 + np.abs(ref).max()),
                               err_msg=what)


def _defects_close(got, ref, dtype):
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                               atol=1e-4 if dtype == torch.float32 else 1e-9)


CASES = [("pendulum", torch.float32), ("pendulum", torch.float64),
         ("dp", torch.float32), ("dp", torch.float64)]


@pytest.mark.parametrize("name,dtype", CASES)
def test_defect_rollouts_match_jax(name, dtype):
    jsys, sys_, c = _case(name, dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    exp = expansion_from_numpy(c["exp"], dtype=dtype, device="cpu")
    A_cl = exp.f_x + exp.f_u @ t(c["K"])
    args = (c["x0"], c["X"], c["U"], c["u_ff"], c["K"])
    targs = tuple(map(t, args))

    ref = _jax(lambda s, x0, X, U, uf, K, e: jax_parallel.linesearch_defect_rollouts(
        s, x0, jnp.asarray(ALPHAS, x0.dtype), X, U, uf, K, e, iters=6,
        engine="xla"), jsys, dtype, *args, c["exp"])
    got = parallel_rollout.linesearch_defect_rollouts(
        sys_, targs[0], ALPHAS, *targs[1:], exp, iters=6, engine="pallas")
    for what, g, r in zip(("X", "U", "costs"), got[:3], ref[:3]):
        _close(g, r, dtype, f"linesearch_defect_rollouts {what}")
    _defects_close(got[3], ref[3], dtype)
    assert (got[3].numpy()[1:] < 1e-3).all()  # α ≤ 0.5 certify in 6 sweeps

    ref1 = _jax(lambda s, x0, X, U, uf, K, A: jax_parallel.defect_rollout(
        s, x0, 0.5, X, U, uf, K, A, iters=6, engine="xla"),
        jsys, dtype, *args, A_cl.numpy())
    got1 = parallel_rollout.defect_rollout(sys_, targs[0], 0.5, *targs[1:],
                                           A_cl, iters=6, engine="pallas")
    for what, g, r in zip(("X", "U", "cost"), got1[:3], ref1[:3]):
        _close(g, r, dtype, f"defect_rollout {what}")
    _defects_close(got1[3], ref1[3], dtype)
    # The certified sweep is the exact closed-loop rollout.
    exact = _jax(lambda s, x0, X, U, uf, K: jax_closed_loop(
        s, x0, 0.5, X, U, uf, K), jsys, dtype, *args)
    _close(got1[0], exact[0], torch.float32, "defect_rollout vs exact X")


@pytest.mark.parametrize("name,dtype", CASES)
def test_open_loop_defect_rollout_matches_jax(name, dtype):
    jsys, sys_, c = _case(name, dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    # Warm start: the nominal trajectory perturbed, as a solver's stale plan.
    guess = c["X"] + 0.01 * np.cos(np.arange(c["X"].shape[0]))[:, None]
    ref = _jax(lambda s, x0, U, Xg: jax_parallel.open_loop_defect_rollout(
        s, x0, U, Xg, iters=5, engine="xla"), jsys, dtype, c["x0"], c["U"],
        guess)
    got = parallel_rollout.open_loop_defect_rollout(
        sys_, t(c["x0"]), t(c["U"]), t(guess), iters=5, engine="pallas")
    _close(got[0], ref[0], dtype, "X")
    _close(got[1], ref[1], dtype, "cost")
    _defects_close(got[2], ref[2], dtype)
    _close(got[0], c["X"], torch.float32, "X vs sequential rollout")
    # From the constant guess at x0 (the default) on the pendulum.
    if name == "pendulum":
        ref = _jax(lambda s, x0, U: jax_parallel.open_loop_defect_rollout(
            s, x0, U, iters=8, engine="xla"), jsys, dtype, c["x0"], c["U"])
        got = parallel_rollout.open_loop_defect_rollout(
            sys_, t(c["x0"]), t(c["U"]), iters=8)
        _close(got[0], ref[0], dtype, "X from x0")
        _defects_close(got[2], ref[2], dtype)


def test_open_loop_defect_rollout_from_a_row_of_a_batch():
    """The default constant guess from an x0 that is a row of a batch of
    initial states (``solve(system, x0s[i], ...)`` with
    init_rollout='defect'): the sweeps' Jacobians used to raise on the
    repeated row; now the rollout is JAX's from the same x0."""
    jsys, sys_, c = _case("dp", torch.float64)
    x0s = np.stack([np.zeros(4), [0.3, -0.2, 0.0, 0.0]])
    U = np.zeros((40, 2))
    ref = _jax(lambda s, x0, U: jax_parallel.open_loop_defect_rollout(
        s, x0, U, iters=8, engine="xla"), jsys, torch.float64, x0s[1], U)
    got = parallel_rollout.open_loop_defect_rollout(
        sys_, torch.tensor(x0s, dtype=torch.float64)[1],
        torch.tensor(U, dtype=torch.float64), iters=8)
    _close(got[0], ref[0], torch.float64, "X from a row of x0s")
    _defects_close(got[2], ref[2], torch.float64)


@pytest.mark.parametrize("name,dtype", CASES)
def test_chunked_rollouts_match_jax(name, dtype):
    jsys, sys_, c = _case(name, dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    exp = expansion_from_numpy(c["exp"], dtype=dtype, device="cpu")
    A_cl = (exp.f_x + exp.f_u @ t(c["K"])).numpy()
    args = (c["x0"], c["X"], c["U"], c["u_ff"], c["K"], A_cl)
    targs = tuple(map(t, args))
    for L in (0, 37):   # auto (16 chunks), and a ragged last chunk
        ref = _jax(lambda s, x0, X, U, uf, K, A: jax_chunked.linesearch_chunked_rollouts(
            s, x0, jnp.asarray(ALPHAS, x0.dtype), X, U, uf, K, A, sweeps=3,
            chunk_len=L), jsys, dtype, *args)
        got = chunked_rollout.linesearch_chunked_rollouts(
            sys_, targs[0], ALPHAS, *targs[1:], sweeps=3, chunk_len=L)
        for what, g, r in zip(("X", "U", "costs"), got[:3], ref[:3]):
            _close(g, r, dtype, f"chunk_len {L} {what}")
        _defects_close(got[3], ref[3], dtype)
    ref1 = _jax(lambda s, x0, X, U, uf, K, A: jax_chunked.chunked_rollout(
        s, x0, 0.25, X, U, uf, K, A, sweeps=3), jsys, dtype, *args)
    got1 = chunked_rollout.chunked_rollout(sys_, targs[0], 0.25, *targs[1:],
                                           sweeps=3)
    for what, g, r in zip(("X", "U", "cost"), got1[:3], ref1[:3]):
        _close(g, r, dtype, f"chunked_rollout {what}")
    _defects_close(got1[3], ref1[3], dtype)


def test_chunk_lengths_and_transition_products_match_jax():
    for N in (1, 15, 250, 400, 4096, 100_000, 10 ** 7):
        assert chunked_rollout.auto_chunk_len(N) == jax_chunked.auto_chunk_len(N)
        assert (chunked_rollout.coarse_chunk_len(N)
                == jax_chunked.coarse_chunk_len(N))
    rng = np.random.default_rng(3)
    A = 0.3 * rng.normal(size=(24, 3, 3)) + np.eye(3)
    ref = np.asarray(jax_chunked.chunk_transition_products(
        jnp.asarray(A, jnp.float32), 6))
    got = chunked_rollout.chunk_transition_products(torch.tensor(A), 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(),
                               A[11] @ A[10] @ A[9] @ A[8] @ A[7] @ A[6],
                               rtol=1e-12)


def test_guarded_max_defect_reads_nan_as_unconverged():
    d = torch.tensor([[[0.1, -0.3]], [[np.nan, 0.0]], [[np.inf, 1.0]]])
    got = parallel_rollout._guarded_max_defect(d, (1, 2))
    np.testing.assert_allclose(got.numpy(), [0.3, np.inf, np.inf], rtol=1e-6)
    ref = jax_parallel._guarded_max_defect(jnp.asarray(d.numpy()), (1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
