"""The wider models' batched and parallel-in-time paths against ilqr_tpu.

The paths that `chip_smoke.py` phases 31-34 run on the card through B4w,
B5n and B3w, here at a small size on the CPU, where the kernel wrappers
run their plain versions:

* batched solves of the 3-D quadrotor (`parallel.solve_batched`, B = 4,
  N = 80, `tests/test_quadrotor3d.py`'s problem) against
  ``jax.vmap(solve)``;
* batched MPC (`run_mpc_batched`, B = 3, H = 20, 3 steps) of the planar
  quadrotor of `examples/quadrotor_dash.py` and the cart-pole of
  `bench.py:795-799` against JAX's `run_mpc_batched`;
* the 3-D quadrotor's defect line search with the defect initial rollout
  (`solve(rollout='defect', init_rollout='defect', backward='pallas')`)
  and its multiple-shooting solve (`solve_ms`, update_engine 'pallas') at
  N = 40 against JAX's XLA engines;
* the engine routes of ROADMAP item C2 on meta tensors: 'auto' and 'scan'
  run the plain version where no kernel takes the shape or the dtype, and
  'pallas' raises.

f64 runs are held to JAX within 1e-8 of the cost (the same recursions in
another order); f32 runs within the tolerance stated at each test, since
f32 solves part by rounding.  The JAX side is jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu import shooting as jax_shooting
from ilqr_tpu.models import chain as jchain
from ilqr_tpu.models import quadrotor3d as jq3
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import solver
from ilqr_tpu_torch.convert import system_from_numpy
from ilqr_tpu_torch.ops import affine_scan, batched
from ilqr_tpu_torch.parallel import batch as port_batch

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]


def _port(jsys, kind, dtype):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters, dtype=dtype,
                             device="cpu")


def _jax_run(fn, dtype, *trees):
    """``fn(*trees)`` jitted, in JAX's float of ``dtype``, as numpy."""
    def run(jdt):
        cast = [jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)
                for t in trees]
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*cast))
    if dtype == torch.float64:
        with enable_x64_oracle():
            return run(jnp.float64)
    return run(jnp.float32)


def _q3():
    Q, R, Q_f = (np.asarray(a) for a in jq3.default_weights())
    return it.make_quadrotor3d(0.02, [1.0, 1.0, 1.0] + [0.0] * 9, Q, R, Q_f)


# ---- P1: batched solves of the 3-D quadrotor --------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_batched_quadrotor3d_matches_jax_vmap(dtype):
    """`tests/test_quadrotor3d.py`'s vmapped batch (N = 80, maxiter 40,
    tol 1e-5, x0 spread over [-0.2, 0.2] in x) through the port's batched
    solve with rollout='pallas' (B4's and B5's plain versions here) against
    ``jax.vmap(solve)`` with its default engines.  f64: costs within 1e-8,
    X within 1e-6, the same statuses and iterations; f32: the same
    statuses, costs within 1e-4 and X within 1e-3 (f32 solves stop at the
    tol boundary an iteration apart)."""
    jsys = _q3()
    N, B = 80, 4
    x0s = np.zeros((B, 12))
    x0s[:, 0] = np.linspace(-0.2, 0.2, B)
    U0 = np.broadcast_to(np.asarray(jq3.hover_controls(jsys.params)),
                         (N, 4)).copy()
    cfg = dict(maxiter=40, tol=1e-5)
    ref = _jax_run(lambda s, x, u: jax.vmap(lambda x1: it.solve(
        s, x1, u, it.IlqrConfig(**cfg)))(x), dtype, jsys, x0s, U0)
    sol = port_batch.solve_batched(
        _port(jsys, "quadrotor3d", dtype), torch.tensor(x0s, dtype=dtype),
        torch.tensor(U0, dtype=dtype),
        itt.IlqrConfig(**cfg, rollout="pallas"), mesh=None)
    assert sol.status.tolist() == ref.status.tolist() == [itt.CONVERGED] * B
    if dtype == torch.float64:
        assert sol.iterations.tolist() == ref.iterations.tolist()
        np.testing.assert_allclose(sol.cost.numpy(), ref.cost, rtol=1e-8)
        np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-6)
    else:
        np.testing.assert_allclose(sol.cost.numpy(), ref.cost, rtol=1e-4)
        np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-3)


# ---- P2: batched MPC of the planar quadrotor and the cart-pole --------------

def _dash():
    return it.make_quadrotor(
        0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
        np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]))


def _cart():
    return it.make_cartpole(
        0.01, [0.0, np.pi, 0.0, 0.0], Q=np.diag([1.0, 10.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 10.0, 10.0]),
        integrator="rk4")


MPC_CASES = {
    "quadrotor": (_dash, np.array([[0.0] * 6, [0.2, -0.1, 0.05, 0, 0, 0],
                                   [-0.3, 0.2, -0.05, 0, 0, 0]]),
                  lambda s: np.asarray(it.models.quadrotor.hover_controls(
                      s.params))),
    "cartpole": (_cart, np.array([[0.0, 0.3, 0.0, 0.0], [0.1, 0.5, 0.0, 0.0],
                                  [-0.1, 0.1, 0.0, 0.0]]),
                 lambda s: np.zeros(1)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(MPC_CASES))
def test_run_mpc_batched_wide_models_match_jax(name, dtype):
    """B = 3, H = 20, 3 steps, maxiter 5, the solver system as its own
    plant, rollout='pallas' in the port (B4 and B5's plain versions) and
    JAX's default engines.  f64: the same solve iterations and statuses,
    X within 1e-8, costs within 1e-10; f32: X within 2e-2 of max|X| and
    costs within 1e-2, the MPC rule of chip_smoke.py (a closed loop feeds
    each solve's rounding into the next state, and a solve that stops at
    the tol boundary an iteration apart moves the next state by ~1e-2 on
    the quadrotor's dash)."""
    make, x0s, hover = MPC_CASES[name]
    jsys = make()
    H, n_sim = 20, 3
    U0 = np.broadcast_to(hover(jsys), (H, jsys.n_u)).copy()
    cfg = dict(maxiter=5, tol=1e-5)
    ref = _jax_run(lambda s, x, u: jax_mpc.run_mpc_batched(
        s, s, x, u, n_sim, it.IlqrConfig(**cfg)), dtype, jsys, x0s, U0)
    port = _port(jsys, name, dtype)
    res = itt.run_mpc_batched(port, port, torch.tensor(x0s, dtype=dtype),
                              torch.tensor(U0, dtype=dtype), n_sim,
                              itt.IlqrConfig(**cfg, rollout="pallas"))
    assert res.X.shape == (3, n_sim + 1, jsys.n_x)
    if dtype == torch.float64:
        np.testing.assert_array_equal(res.solve_iters.numpy(),
                                      ref.solve_iters)
        np.testing.assert_array_equal(res.solve_status.numpy(),
                                      ref.solve_status)
        np.testing.assert_allclose(res.X.numpy(), ref.X, atol=1e-8)
        np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-10)
    else:
        np.testing.assert_allclose(res.X.numpy(), ref.X,
                                   atol=2e-2 * np.abs(ref.X).max())
        np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-2)


# ---- P3: the 3-D quadrotor's parallel-in-time path --------------------------

P3_N = 40


def _p3_inputs(dtype):
    jsys = _q3()
    U0 = np.broadcast_to(np.asarray(jq3.hover_controls(jsys.params)),
                         (P3_N, 4)).copy()
    x0 = np.zeros(12)
    x0[0] = 0.2
    return jsys, x0, U0


@pytest.mark.parametrize("dtype", DTYPES)
def test_defect_solve_quadrotor3d_matches_jax(dtype):
    """solve(rollout='defect', init_rollout='defect', backward='pallas')
    (B1w's and B3w's plain versions here) against JAX's defect line search
    with the defect initial rollout and its 'scan' backward pass and XLA
    scan.  f64: the iteration count, status and α trace equal, the cost
    trace within 1e-8; f32: the status equal and the cost within 1e-5."""
    jsys, x0, U0 = _p3_inputs(dtype)
    cfg = dict(maxiter=40, tol=1e-5, rollout="defect", init_rollout="defect")
    ref = _jax_run(lambda s, x, u: it.solve(s, x, u, it.IlqrConfig(
        **cfg, backward="scan", defect_engine="xla")), dtype, jsys, x0, U0)
    sol = itt.solve(_port(jsys, "quadrotor3d", dtype),
                    torch.tensor(x0, dtype=dtype),
                    torch.tensor(U0, dtype=dtype),
                    itt.IlqrConfig(**cfg, backward="pallas",
                                   defect_engine="pallas"))
    assert sol.status == int(ref.status) == itt.CONVERGED
    if dtype == torch.float64:
        assert sol.iterations == int(ref.iterations)
        np.testing.assert_array_equal(sol.alpha_trace.numpy(),
                                      ref.alpha_trace)
        np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                                   rtol=1e-8)
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_ms_quadrotor3d_matches_jax(dtype):
    """solve_ms with update_engine 'pallas' (B3w's plain version here) and
    backward 'pallas' (B1w with defects) against JAX's solve_ms with its
    XLA update pass and 'scan' backward pass.  f64: iterations, status and
    cost trace within 1e-8; f32: status and cost within 1e-5, defect below
    1e-4."""
    jsys, x0, U0 = _p3_inputs(dtype)
    cfg = dict(maxiter=40, tol=1e-5)
    ref = _jax_run(lambda s, x, u: jax_shooting.solve_ms(
        s, x, u, config=it.IlqrConfig(**cfg, backward="scan"),
        ms=jax_shooting.MsConfig(update_engine="xla")), dtype, jsys, x0, U0)
    sol = itt.solve_ms(_port(jsys, "quadrotor3d", dtype),
                       torch.tensor(x0, dtype=dtype),
                       torch.tensor(U0, dtype=dtype),
                       config=itt.IlqrConfig(**cfg, backward="pallas"),
                       ms=itt.MsConfig(update_engine="pallas"))
    assert sol.status == int(ref.status) == itt.CONVERGED
    if dtype == torch.float64:
        assert sol.iterations == int(ref.iterations)
        np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                                   rtol=1e-8)
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-5)
    assert float(sol.defect) < 1e-4


# ---- C2: the engine routes ----------------------------------------------------

def _meta_expansion(B, N, n_x, n_u, dtype):
    m = dict(device="meta", dtype=dtype)
    return itt.TrajectoryExpansion(
        f_x=torch.empty(B, N, n_x, n_x, **m), f_u=torch.empty(B, N, n_x, n_u, **m),
        l_x=torch.empty(B, N, n_x, **m), l_u=torch.empty(B, N, n_u, **m),
        l_xx=torch.empty(B, N, n_x, n_x, **m),
        l_ux=torch.empty(B, N, n_u, n_x, **m),
        l_uu=torch.empty(B, N, n_u, n_u, **m), v_x=torch.empty(B, n_x, **m),
        v_xx=torch.empty(B, n_x, n_x, **m))


@pytest.mark.parametrize("engine", ["auto", "scan", "pallas"])
@pytest.mark.parametrize("n_x,n_u,dtype", [
    (12, 4, torch.float64), (6, 2, torch.float64), (32, 16, torch.float32),
    (16, 17, torch.float32), (12, 4, torch.float32), (16, 16, torch.float32),
    (4, 2, torch.float32)])
def test_batched_backward_routes(monkeypatch, engine, n_x, n_u, dtype):
    """C2(a).  B4 takes float32 with n_x, n_u <= 16; off the CPU, outside
    that, 'auto' and 'scan' run the plain version (`vmap_backward` of the
    sequential pass, recorded here) and 'pallas' raises; inside it every
    engine goes to the kernel (a meta tensor then fails the device check,
    and never reaches the plain version)."""
    calls = []
    monkeypatch.setattr(batched, "vmap_backward",
                        lambda fn, exp, reg: calls.append(fn) or "plain")
    exp = _meta_expansion(3, 5, n_x, n_u, dtype)
    takes = dtype == torch.float32 and n_x <= 16 and n_u <= 16
    if takes:
        with pytest.raises(ValueError, match="device"):
            batched.backward_pass_batched(exp, 0.0, engine)
    elif engine == "pallas":
        with pytest.raises(NotImplementedError, match="float32"):
            batched.backward_pass_batched(exp, 0.0, engine)
    else:
        assert batched.backward_pass_batched(exp, 0.0, engine) == "plain"
        assert calls == [itt.backward_pass]
    assert batched.kernel_takes(exp) == takes
    # solve_batch's dispatch hands its engine to the wrapper ('auto' is
    # 'scan'); 'pscan' is the associative scan per instance.
    seen = []
    monkeypatch.setattr(solver, "backward_pass_batched",
                        lambda e, r, eng: seen.append(eng))
    solver._backward_batch(exp, 0.0, itt.IlqrConfig(backward=engine))
    assert seen == ["scan" if engine == "auto" else engine]


@pytest.mark.parametrize("engine", ["auto", "pallas"])
@pytest.mark.parametrize("n,A,dtype", [
    (12, 10, torch.float64), (4, 3, torch.float64), (12, 10, torch.float32),
    (2, 17, torch.float32), (16, 33, torch.float32), (4, 16, torch.float32)])
def test_affine_scan_routes(monkeypatch, engine, n, A, dtype):
    """C2(b).  The affine scan's kernel takes float32 at n <= 16 with any
    number of candidates; off the CPU 'auto' runs `prefix_scan` (recorded)
    for float64, 'pallas' raises there, and every float32 case goes to the
    kernel (the device check, on a meta tensor)."""
    calls = []
    plain = affine_scan.prefix_scan
    monkeypatch.setattr(affine_scan, "prefix_scan",
                        lambda P, q: calls.append(1) or plain(P, q))
    m = dict(device="meta", dtype=dtype)
    args = (torch.empty(7, n, n, **m), torch.empty(A, 7, n, **m),
            torch.empty(A, n, **m))
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="device"):
            affine_scan.affine_prefix_scan_multi(*args, engine=engine)
        assert not calls
    elif engine == "pallas":
        with pytest.raises(TypeError, match="float32"):
            affine_scan.affine_prefix_scan_multi(*args, engine=engine)
        assert not calls
    else:
        out = affine_scan.affine_prefix_scan_multi(*args, engine=engine)
        assert tuple(out.shape) == (A, 8, n) and calls == [1]


def test_batched_chain_solve_equals_single_instance_solves():
    """The chain (n_x = 32) stays outside every kernel, as in JAX: its
    batched solve runs the plain backward pass and equals
    ``jax.vmap(solve)`` on the same x0s and U0 (f64: costs within 1e-10,
    X within 1e-10, the same iterations)."""
    jsys = jchain.make_spring_chain(0.02, n_masses=16)
    s = _port(jsys, "chain", torch.float64)
    assert s.n_x == 32
    x0s = np.zeros((2, s.n_x))
    x0s[:, 0] = [0.1, -0.1]
    U0 = np.zeros((6, s.n_u))
    ref = _jax_run(lambda js, x, u: jax.vmap(lambda x1: it.solve(
        js, x1, u, it.IlqrConfig(maxiter=3)))(x), torch.float64, jsys, x0s,
        U0)
    sol = itt.solve_batch(s, torch.tensor(x0s), torch.tensor(U0),
                          itt.IlqrConfig(maxiter=3))
    assert sol.iterations.tolist() == ref.iterations.tolist()
    np.testing.assert_allclose(sol.cost.numpy(), ref.cost, rtol=1e-10)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, rtol=0, atol=1e-10)
