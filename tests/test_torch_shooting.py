"""The port's multiple shooting (GNMS) against ilqr_tpu's.

* the defect-aware backward passes — sequential, associative and the
  fused wrapper (whose CPU path is the associative pass; the CUDA kernel
  with defects, B1d, is checked on the GPU by chip_smoke.py) — against JAX
  `backward_pass(defects=)` and `backward_pass_associative(defects=)`, in
  f32 and f64;
* the multi-α affine update pass under every engine against JAX's;
* `solve_ms` on the pendulum golden (reference cost 23.435774) with the
  parallel engines, against the JAX solve's traces, and from a
  straight-line `interpolate_states` warm start.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import shooting as jax_shooting
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.parallel_riccati import (
    backward_pass_associative as jax_associative,
)
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import shooting
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy

torch.set_num_threads(1)

GOLDEN_COST = 23.435774
# As tests/test_torch_riccati.py: relative to the largest reference entry.
RTOL = {torch.float32: 2e-3, torch.float64: 1e-8}


def _jax_system(name):
    if name == "pendulum":
        return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                Q_f=10.0 * np.eye(2), d=0.1, integrator="rk4")
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1] if name == "ua_dp" else [0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]), d1=0.1, d2=0.1,
        theta1=1 / 12, theta2=1 / 12, underactuated=name == "ua_dp",
        integrator="euler")


def _golden_pendulum():
    # Reference config: run_iLQR_open_loop.py (as tests/test_shooting.py).
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=np.zeros((2, 2)), d=0.0,
                            integrator="backward_euler")


def _port(jsys, dtype=torch.float32):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    kind = "pendulum" if jsys.n_x == 2 else "double_pendulum"
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


def _expansion(name, N, seed, dtype):
    """A JAX expansion along a random trajectory and random gaps, numpy."""
    jsys = _jax_system(name)
    rng = np.random.default_rng(seed)
    X = 0.5 * rng.normal(size=(N + 1, jsys.n_x))
    U = 0.5 * rng.normal(size=(N, jsys.n_u))
    d = 0.3 * rng.normal(size=(N, jsys.n_x))
    dt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), jsys)
    exp = jax.jit(jax_linearize)(j, jnp.asarray(X, dt), jnp.asarray(U, dt))
    return exp, jnp.asarray(d, dt), X, U


def _close(got, ref, rtol, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=rtol * (np.abs(ref).max() + 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,N", [("pendulum", 61), ("dp", 40),
                                    ("ua_dp", 33)])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_defect_backward_passes_match_jax(name, N, reg, dtype):
    def refs():
        exp, d, _, _ = _expansion(name, N, seed=N, dtype=dtype)
        seq = jax.jit(jax_backward)(exp, reg, defects=d)
        par = jax.jit(jax_associative)(exp, reg, defects=d)
        return exp, np.asarray(d), seq, par

    if dtype == torch.float64:
        with enable_x64_oracle():
            jexp, d, ref_seq, ref_par = refs()
    else:
        jexp, d, ref_seq, ref_par = refs()
    exp = expansion_from_numpy(jexp, dtype=dtype, device="cpu")
    d = torch.tensor(d, dtype=dtype)
    for engine, ref in ((itt.backward_pass, ref_seq),
                        (itt.backward_pass_associative, ref_par),
                        (itt.backward_pass_fused, ref_par)):
        u_ff, K, dV, ok = engine(exp, reg, defects=d)
        assert bool(ok) and u_ff.dtype == dtype
        for what, got, want in (("u_ff", u_ff, ref[0]), ("K", K, ref[1]),
                                ("dV", dV, ref[2])):
            _close(got, want, RTOL[dtype], f"{engine.__name__} {what}")


def test_zero_defects_are_the_plain_backward_pass():
    with enable_x64_oracle():
        jexp, _, _, _ = _expansion("dp", 30, seed=2, dtype=torch.float64)
    exp = expansion_from_numpy(jexp, dtype=torch.float64, device="cpu")
    zero = torch.zeros(30, 4, dtype=torch.float64)
    for engine in (itt.backward_pass, itt.backward_pass_associative,
                   itt.backward_pass_fused):
        plain, gnms = engine(exp, 0.0), engine(exp, 0.0, defects=zero)
        for a, b in zip(plain[:3], gnms[:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_update_pass_engines_match_jax(dtype):
    """The affine update is exact under every engine: the port's 'seq',
    'xla' and 'pallas' (CPU: the plain scan) against JAX's 'seq'."""
    alphas = np.array([1.0, 0.5, 0.25])

    def refs():
        exp, d, _, _ = _expansion("pendulum", 61, seed=0, dtype=dtype)
        u_ff, K, _, _ = jax.jit(jax_backward)(exp, 0.0, defects=d)
        out = jax.jit(jax_shooting._update_pass_multi, static_argnums=5)(
            jnp.asarray(alphas, d.dtype), exp, d, u_ff, K, "seq")
        one = jax.jit(jax_shooting._update_pass)(0.5, exp, d, u_ff, K)
        return jax.tree_util.tree_map(np.asarray,
                                      (exp, d, u_ff, K, out, one))

    if dtype == torch.float64:
        with enable_x64_oracle():
            jexp, d, u_ff, K, ref, ref_one = refs()
    else:
        jexp, d, u_ff, K, ref, ref_one = refs()
    exp = expansion_from_numpy(jexp, dtype=dtype, device="cpu")
    t = lambda a: torch.tensor(a, dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for engine in ("auto", "seq", "xla", "pallas"):
        dX, dU = shooting._update_pass_multi(t(alphas), exp, t(d), t(u_ff),
                                             t(K), engine)
        assert dX.shape == (3, 62, 2) and dU.shape == (3, 61, 1)
        np.testing.assert_allclose(dX.numpy(), ref[0], rtol=tol, atol=tol)
        np.testing.assert_allclose(dU.numpy(), ref[1], rtol=tol, atol=tol)
    dX, dU = shooting._update_pass(0.5, exp, t(d), t(u_ff), t(K))
    np.testing.assert_allclose(dX.numpy(), ref_one[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(dU.numpy(), ref_one[1], rtol=tol, atol=tol)


def _assert_traces(sol, ref, at):
    """The α, cost and defect traces of an MS solve against a reference's,
    at the entries `at` selects."""
    np.testing.assert_array_equal(sol.alpha_trace.numpy()[at],
                                  ref.alpha_trace[at])
    np.testing.assert_allclose(sol.cost_trace.numpy()[at], ref.cost_trace[at],
                               rtol=1e-5)
    # Gaps of accepted steps: f32 rounding noise once closed.
    np.testing.assert_allclose(sol.defect_trace.numpy()[at],
                               ref.defect_trace[at], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("engines,dtype", [
    (dict(backward="pscan", update_engine="xla"), torch.float32),
    (dict(backward="pallas", update_engine="pallas", init_rollout="defect"),
     torch.float64),
])
def test_solve_ms_pendulum_golden_matches_jax(engines, dtype):
    """The fully parallel-in-time engines reproduce the golden cost and the
    JAX solve's iterations.  The kernel engines' CPU paths (plain versions)
    with the defect initial rollout are held to JAX's parallel engines
    ('pscan', 'xla') with the same initial rollout, in f64: in f32 the
    unconverged initial sweeps leave gaps whose rounding decides the last
    steps at the f32 floor (one more α = 1 iteration, same cost)."""
    engines = dict(engines)
    update_engine = engines.pop("update_engine")
    init = engines.get("init_rollout", "auto")

    def jax_solve(jdt):
        jsys = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                      _golden_pendulum())
        out = jax.jit(jax_shooting.solve_ms, static_argnames=("config", "ms"))(
            jsys, jnp.asarray([1.0, 0.0], jdt), jnp.zeros((400, 1), jdt),
            config=it.IlqrConfig(maxiter=100, tol=1e-5, backward="pscan",
                                 init_rollout=init),
            ms=jax_shooting.MsConfig(update_engine="xla"))
        return jax.tree_util.tree_map(np.asarray, out)

    with enable_x64_oracle():
        ref64 = jax_solve(jnp.float64)
    ref = ref64 if dtype == torch.float64 else jax_solve(jnp.float32)
    sol = itt.solve_ms(
        _port(_golden_pendulum(), dtype), torch.tensor([1.0, 0.0], dtype=dtype),
        torch.zeros((400, 1), dtype=dtype),
        config=itt.IlqrConfig(maxiter=100, tol=1e-5, **engines),
        ms=itt.MsConfig(update_engine=update_engine))
    assert sol.status == itt.CONVERGED == int(ref.status)
    assert abs(float(sol.cost) - GOLDEN_COST) < 1e-3
    assert float(sol.defect) < 1e-5
    # Both packages' f64 solves stop after six iterations.  The sixth moves
    # the f64 cost by 3e-7, below the f32 resolution of the cost, and there
    # the f32 solves part, by host: JAX's takes α = 0.5 at that sixth step
    # and runs a seventh iteration; the port's does the same on some hosts
    # and on others accepts no step and stops after six.  So the count is
    # held to the f64 solve's or to JAX f32's, the traces to the same
    # package's solve before that floor, and, in f32, the whole traces to
    # the f64 solve but the floor's entry: no step, the f64 solve's step,
    # or JAX f32's step, which then moves the cost by less than one f32 eps
    # of it.
    assert sol.iterations in (int(ref64.iterations), int(ref.iterations))
    n = None if dtype == torch.float64 else int(ref64.iterations) - 1
    _assert_traces(sol, ref, slice(None, n))
    if dtype == torch.float32:
        eps = np.finfo(np.float32).eps
        c64 = ref64.cost_trace
        assert abs(c64[n] - c64[n - 1]) < eps * c64[n]
        _assert_traces(sol, ref64, np.arange(len(c64)) != n)
        if sol.iterations != int(ref64.iterations):
            # JAX f32's extra step.
            cost = sol.cost_trace.numpy()
            assert abs(cost[n] - cost[n - 1]) < eps * cost[n]
            _assert_traces(sol, ref, slice(n, n + 1))
        elif not np.isnan(sol.alpha_trace.numpy()[n]):
            _assert_traces(sol, ref64, slice(n, n + 1))
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-3)


def test_straight_line_init_converges_feasibly():
    """The infeasible straight-line warm start (as tests/test_shooting.py):
    MS closes the gaps, and re-rolling out U reproduces the cost."""
    x0 = torch.tensor([1.0, 0.0])
    X0 = itt.interpolate_states(x0, [np.pi, 0.0], 400)
    ref = jax_shooting.interpolate_states(jnp.array([1.0, 0.0]),
                                          jnp.array([np.pi, 0.0]), 400)
    np.testing.assert_allclose(X0.numpy(), np.asarray(ref), rtol=1e-6)
    sys_ = _port(_golden_pendulum())
    sol = itt.solve_ms(sys_, x0, torch.zeros((400, 1)), X_init=X0,
                       config=itt.IlqrConfig(maxiter=100, tol=1e-5,
                                             backward="pscan"),
                       ms=itt.MsConfig(update_engine="xla"))
    assert sol.status == itt.CONVERGED
    assert float(sol.defect) < 1e-4
    _, cost_roll = itt.rollout(sys_, x0, sol.U)
    assert abs(float(cost_roll) - float(sol.cost)) < 1e-2 * float(sol.cost)
    assert np.isnan(sol.cost_trace.numpy()[sol.iterations:]).all()


def test_ms_config_and_input_validation():
    for bad in ("gpu", "cuda"):
        with pytest.raises(ValueError):
            jax_shooting.MsConfig(update_engine=bad)
        with pytest.raises(ValueError):
            itt.MsConfig(update_engine=bad)
    import dataclasses

    assert ({f.name: f.default for f in dataclasses.fields(itt.MsConfig)}
            == {f.name: f.default
                for f in dataclasses.fields(jax_shooting.MsConfig)})
    sys_ = _port(_golden_pendulum())
    with pytest.raises(ValueError, match="U_init"):
        itt.solve_ms(sys_, torch.zeros(2), torch.zeros((10, 3)))
    with pytest.raises(ValueError, match="x0"):
        itt.solve_ms(sys_, torch.zeros(3), torch.zeros((10, 1)))
    with pytest.raises(ValueError, match="X_init"):
        itt.solve_ms(sys_, torch.zeros(2), torch.zeros((10, 1)),
                     X_init=torch.zeros((5, 2)))
