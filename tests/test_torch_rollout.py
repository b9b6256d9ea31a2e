"""The port's rollouts against ilqr_tpu's.

On CPU tensors the fused rollout wrappers run their plain versions
(`linesearch_rollouts`, `closed_loop_rollout` and `rollout`); the CUDA
kernels are checked against those on the GPU by chip_smoke.py.  Here the
CPU paths are held against the JAX Pallas kernels in interpret mode (the
line search under explicit and implicit integrators, and the batched open
loop at B = 1) and the JAX scan rollouts, in f32 and in f64 (JAX under
`enable_x64_oracle`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.pallas_batched import open_loop_rollout_batched
from ilqr_tpu.ops.pallas_rollout import (
    closed_loop_rollout_pallas,
    linesearch_costs_pallas,
)
from ilqr_tpu.ops.rollout import closed_loop_rollout as jax_closed_loop
from ilqr_tpu.ops.rollout import linesearch_rollouts as jax_linesearch
from ilqr_tpu.ops.rollout import rollout as jax_rollout
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import system_from_numpy
from ilqr_tpu_torch.ops import batched, fused_rollout

torch.set_num_threads(1)

ALPHAS = tuple(0.5 ** i for i in range(10))
# f32: the same recursion in other operation orders over N steps of a
# closed loop; a few ulp of the largest value per step, not amplified by the
# feedback.  f64: agreement to rounding.
RTOL = {torch.float32: 2e-5, torch.float64: 1e-11}


def _jax_system(name, integrator):
    if name == "pendulum":
        return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                Q_f=10.0 * np.eye(2), d=0.0,
                                integrator=integrator)
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1] if name == "ua_dp" else [0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]), d1=0.1, d2=0.1,
        theta1=1 / 12, theta2=1 / 12, underactuated=name == "ua_dp",
        integrator=integrator)


def _inputs(jsys, N, seed):
    """x0, U_old, u_ff, K: a random nominal and small random gains."""
    rng = np.random.default_rng(seed)
    x0 = 0.3 * rng.normal(size=jsys.n_x)
    U_old = 0.5 * rng.normal(size=(N, jsys.n_u))
    u_ff = 0.2 * rng.normal(size=(N, jsys.n_u))
    K = 0.1 * rng.normal(size=(N, jsys.n_u, jsys.n_x))
    return x0, U_old, u_ff, K


def _port(jsys, name, dtype):
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(
        "pendulum" if name == "pendulum" else "double_pendulum", params,
        jsys.n_x, jsys.n_u, jsys.dt, jsys.integrator, dtype=dtype,
        device="cpu")


def _jax_refs(jsys, x0, U_old, u_ff, K, x64):
    """JAX nominal rollout, then the line-search batch and one α."""
    def run(jsys, dt):
        x0j = jnp.asarray(x0, dt)
        U = jnp.asarray(U_old, dt)
        X, _ = jax.jit(jax_rollout)(jsys, x0j, U)
        Xs, Us, cs = jax.jit(jax_linesearch)(
            jsys, x0j, jnp.asarray(ALPHAS, dt), X, U, jnp.asarray(u_ff, dt),
            jnp.asarray(K, dt))
        return tuple(np.asarray(a) for a in (X, Xs, Us, cs))

    if x64:
        with enable_x64_oracle():
            return run(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys), jnp.float64)
    return run(jsys, jnp.float32)


def _close(got, ref, rtol, what):
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=rtol * (np.abs(ref).max() + 1.0),
                               err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,integrator,N", [
    ("pendulum", "backward_euler", 30),
    ("dp", "euler", 60),
    ("ua_dp", "rk4", 40),
])
def test_rollouts_match_jax(name, integrator, N, dtype):
    jsys = _jax_system(name, integrator)
    x0, U_old, u_ff, K = _inputs(jsys, N, seed=N)
    X_ref, Xs_ref, Us_ref, cs_ref = _jax_refs(jsys, x0, U_old, u_ff, K,
                                              dtype == torch.float64)
    sys_ = _port(jsys, name, dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    rtol = RTOL[dtype]

    X, cost = itt.rollout(sys_, t(x0), t(U_old))
    _close(X, X_ref, rtol, "rollout X")
    args = (t(x0), t(ALPHAS), X, t(U_old), t(u_ff), t(K))
    Xs, Us, cs = itt.linesearch_rollouts(sys_, *args)
    _close(Xs, Xs_ref, rtol, "X candidates")
    _close(Us, Us_ref, rtol, "U candidates")
    _close(cs, cs_ref, rtol, "costs")
    # The fused wrappers' CPU paths.
    _close(itt.linesearch_costs_fused(sys_, *args), cs_ref, rtol,
           "linesearch_costs_fused")
    X1, U1, c1 = itt.closed_loop_rollout_fused(
        sys_, t(x0), ALPHAS[2], X, t(U_old), t(u_ff), t(K))
    _close(X1, Xs_ref[2], rtol, "closed_loop_rollout_fused X")
    _close(U1, Us_ref[2], rtol, "closed_loop_rollout_fused U")
    _close(c1, cs_ref[2], rtol, "closed_loop_rollout_fused cost")


def test_rollout_wrappers_match_jax_pallas_kernels_interpret():
    """The CPU paths of both wrappers against the Pallas kernels they
    replace, run by the JAX package's interpret mode (f32), and against the
    JAX scan rollout."""
    jsys = _jax_system("dp", "euler")
    x0, U_old, u_ff, K = _inputs(jsys, 70, seed=7)
    f = lambda a: jnp.asarray(a, jnp.float32)
    X, _ = jax.jit(jax_rollout)(jsys, f(x0), f(U_old))
    ref = linesearch_costs_pallas(jsys, f(x0), f(ALPHAS), X, f(U_old),
                                  f(u_ff), f(K), interpret=True)
    ref_one = jax_closed_loop(jsys, f(x0), 0.5, X, f(U_old), f(u_ff), f(K))
    ref_kernel = closed_loop_rollout_pallas(jsys, f(x0), 0.5, X, f(U_old),
                                            f(u_ff), f(K), interpret=True)
    sys_ = _port(jsys, "dp", torch.float32)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    got = itt.linesearch_costs_fused(sys_, t(x0), t(ALPHAS), t(X), t(U_old),
                                     t(u_ff), t(K))
    _close(got, np.asarray(ref), RTOL[torch.float32], "costs")
    X1, U1, c1 = itt.closed_loop_rollout_fused(sys_, t(x0), 0.5, t(X),
                                               t(U_old), t(u_ff), t(K))
    for ref in (ref_one, ref_kernel):
        for what, g, r in (("X", X1, ref[0]), ("U", U1, ref[1]),
                           ("cost", c1, ref[2])):
            _close(g, np.asarray(r), RTOL[torch.float32], what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,integrator,N", [
    ("pendulum", "rk4", 30),
    ("dp", "euler", 60),
    ("ua_dp", "midpoint", 40),
])
def test_open_loop_rollout_fused_matches_jax(name, integrator, N, dtype):
    """The open-loop wrapper's CPU path against JAX's scan rollout."""
    jsys = _jax_system(name, integrator)
    x0, U, _, _ = _inputs(jsys, N, seed=N + 1)
    X_ref = _jax_refs(jsys, x0, U, np.zeros_like(U),
                      np.zeros((N, jsys.n_u, jsys.n_x)),
                      dtype == torch.float64)[0]
    if dtype == torch.float64:
        with enable_x64_oracle():
            j64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys)
            c_ref = jax.jit(jax_rollout)(j64, jnp.asarray(x0, jnp.float64),
                                         jnp.asarray(U, jnp.float64))[1]
    else:
        c_ref = jax.jit(jax_rollout)(jsys, jnp.asarray(x0, jnp.float32),
                                     jnp.asarray(U, jnp.float32))[1]
    sys_ = _port(jsys, name, dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    X, cost = itt.open_loop_rollout_fused(sys_, t(x0), t(U))
    _close(X, X_ref, RTOL[dtype], "open-loop X")
    _close(cost, np.asarray(c_ref), RTOL[dtype], "open-loop cost")


def test_open_loop_rollout_fused_matches_jax_batched_kernel_interpret():
    """The open-loop wrapper's CPU path against the JAX batched open-loop
    kernel at B = 1, run by the JAX package's interpret mode (f32)."""
    jsys = _jax_system("dp", "euler")
    x0, U, _, _ = _inputs(jsys, 70, seed=11)
    f = lambda a: jnp.asarray(a, jnp.float32)
    X_ref, c_ref = open_loop_rollout_batched(jsys, f(x0)[None], f(U)[None],
                                             interpret=True)
    sys_ = _port(jsys, "dp", torch.float32)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    X, cost = itt.open_loop_rollout_fused(sys_, t(x0), t(U))
    _close(X, np.asarray(X_ref)[0], RTOL[torch.float32], "open-loop X")
    _close(cost, np.asarray(c_ref)[0], RTOL[torch.float32], "open-loop cost")


def test_params_buffer_layout():
    """The buffer order that csrc/models.cuh reads."""
    dp = itt.make_double_pendulum(
        0.02, [1.0, 2.0, 3.0, 4.0], Q=np.diag([1.0, 2.0, 3.0, 4.0]),
        R=np.diag([5.0]), Q_f=np.diag([6.0, 7.0, 8.0, 9.0]), g=9.5, m1=1.5,
        m2=2.5, l1=0.7, l2=0.9, d1=0.11, d2=0.22, theta1=0.3, theta2=0.4,
        underactuated=True, device="cpu")
    buf = fused_rollout.params_buffer(dp).numpy()
    n_x, n_u = 4, 1
    assert buf.shape == (1 + n_x + 2 * n_x * n_x + n_u * n_u + 9 + 2 * n_u,)
    np.testing.assert_allclose(buf[:5], [0.02, 1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(buf[5:21], np.diag([1.0, 2.0, 3.0, 4.0]).ravel())
    np.testing.assert_allclose(buf[21], 5.0)
    np.testing.assert_allclose(buf[22:38], np.diag([6.0, 7.0, 8.0, 9.0]).ravel())
    np.testing.assert_allclose(
        buf[38:], [1.5, 2.5, 0.7, 0.9, 9.5, 0.11, 0.22, 0.3, 0.4, 1.0, 0.0],
        rtol=1e-6)
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.eye(2), g=9.0, l=2.0, d=0.5, device="cpu")
    np.testing.assert_allclose(fused_rollout.params_buffer(pend).numpy()[-3:],
                               [9.0, 2.0, 0.5])


@pytest.mark.parametrize("name,integrator,N", [
    ("pendulum", "backward_euler", 50),
    ("pendulum", "trapezoidal", 50),
    ("ua_dp", "backward_euler", 40),
    ("ua_dp", "trapezoidal", 40),
])
def test_rollout_wrappers_match_jax_pallas_kernels_implicit_interpret(
        name, integrator, N):
    """The CPU paths of the three wrappers under the implicit integrators
    against the Pallas kernels that trace them, run by the JAX package's
    interpret mode (f32): the line-search costs and one α's trajectory, and
    the open loop as the trajectory kernel with zero gains (u = U_old).
    These are the functions the kernels' implicit instantiations compute."""
    jsys = _jax_system(name, integrator)
    x0, U_old, u_ff, K = _inputs(jsys, N, seed=3 * N)
    f = lambda a: jnp.asarray(a, jnp.float32)
    X, _ = jax.jit(jax_rollout)(jsys, f(x0), f(U_old))
    ref_costs = linesearch_costs_pallas(jsys, f(x0), f(ALPHAS), X, f(U_old),
                                        f(u_ff), f(K), interpret=True)
    ref_traj = closed_loop_rollout_pallas(jsys, f(x0), 0.5, X, f(U_old),
                                          f(u_ff), f(K), interpret=True)
    ref_open = closed_loop_rollout_pallas(
        jsys, f(x0), 0.0, X, f(U_old), jnp.zeros_like(f(u_ff)),
        jnp.zeros_like(f(K)), interpret=True)
    sys_ = _port(jsys, name, torch.float32)
    assert fused_rollout.device_model(sys_)[1] == (
        3 if integrator == "backward_euler" else 4)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    rtol = RTOL[torch.float32]
    _close(itt.linesearch_costs_fused(sys_, t(x0), t(ALPHAS), t(X), t(U_old),
                                      t(u_ff), t(K)),
           np.asarray(ref_costs), rtol, "costs")
    X1, U1, c1 = itt.closed_loop_rollout_fused(sys_, t(x0), 0.5, t(X),
                                               t(U_old), t(u_ff), t(K))
    for what, g, r in (("X", X1, ref_traj[0]), ("U", U1, ref_traj[1]),
                       ("cost", c1, ref_traj[2])):
        _close(g, np.asarray(r), rtol, f"trajectory {what}")
    X0, c0 = itt.open_loop_rollout_fused(sys_, t(x0), t(U_old))
    _close(X0, np.asarray(ref_open[0]), rtol, "open-loop X")
    _close(c0, np.asarray(ref_open[2]), rtol, "open-loop cost")


def test_device_model_covers_the_kernels_and_refuses_the_rest():
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.eye(2), integrator="midpoint",
                             device="cpu")
    assert fused_rollout.device_model(pend) == (0, 1)
    dp = itt.make_double_pendulum(0.01, [np.pi, 0, 0, 0], Q=np.eye(4),
                                  R=np.eye(2), Q_f=np.eye(4),
                                  integrator="rk4", device="cpu")
    assert fused_rollout.device_model(dp) == (1, 2)
    assert fused_rollout.device_model(
        dp.with_integrator("backward_euler")) == (1, 3)
    assert fused_rollout.device_model(
        pend.with_integrator("trapezoidal")) == (0, 4)
    with pytest.raises(NotImplementedError, match="B2x"):
        fused_rollout.device_model(dp.with_integrator("discrete"))
    with pytest.raises(NotImplementedError, match="B2x"):
        fused_rollout.device_model(dp.replace(
            stage_cost=lambda p, x, u: (x * x).sum()))


def test_batched_rollout_entries_refuse_implicit_integrators():
    """B5 (the batched entries) used to refuse the implicit integrators by
    name (ROADMAP B5i); on B2's chain kernels it runs them, so its
    launchers now hand the library the integrator's id and the system's
    newton_iters (checked here with a stand-in library) and keep only the
    refusals of ROADMAP item B2x (B2m's until the other systems' device
    forms came)."""
    N, B = 4, 2
    x0s, U = torch.zeros(B, 4), torch.zeros(B, N, 2)
    X, u_ff, K = torch.zeros(B, N + 1, 4), torch.zeros(B, N, 2), torch.zeros(
        B, N, 2, 4)

    class StandIn:
        calls = []

        def ilqr_linesearch_costs_batched(self, *args):
            self.calls.append(("costs",) + args)
            return 0

        def ilqr_open_loop_rollout_batched(self, *args):
            self.calls.append(("open loop",) + args)
            return 0

    lib = StandIn()
    for integ, iters in (("backward_euler", 3), ("trapezoidal", 7)):
        dp = itt.make_double_pendulum(0.01, [np.pi, 0, 0, 0], Q=np.eye(4),
                                      R=np.eye(2), Q_f=np.eye(4),
                                      integrator=integ, device="cpu"
                                      ).replace(newton_iters=iters)
        costs = batched.launch_costs(lib, dp, x0s, torch.ones(1), X, U, u_ff,
                                     K, None)
        assert costs.shape == (B, 1)
        X_o, U_o, c_o = batched.launch_trajectory(lib, dp, x0s, None, None, U,
                                                  None, None, None)
        assert X_o.shape == (B, N + 1, 4) and U_o is None
        for call in lib.calls[-2:]:
            # (model, integrator, newton_iters, n_x, n_u, ...)
            assert call[1:6] == (1, fused_rollout._INTEGRATORS[integ], iters,
                                 4, 2)
    with pytest.raises(NotImplementedError, match="B2x"):
        batched.launch_costs(None, dp.with_integrator("discrete"), x0s,
                             torch.ones(1), X, U, u_ff, K, None)


@pytest.mark.parametrize("offset_floats", [1, 2])
def test_aligned_copies_misaligned_views_and_keeps_aligned_tensors(
        offset_floats):
    """What the B = 1 wrappers hand their launchers (`kernel_inputs`): a row
    view at a 4- or 8-byte offset, such as U_prev[1:] of an (N, 1) or
    (N, 2) tensor, is contiguous but misaligned; it reaches each launcher
    at its own data_ptr, with no copy, since the kernels place every run
    at its own 16-byte phase.  A non-contiguous view arrives as an equal
    contiguous copy.  Checked with a stand-in library that records the
    launchers' arguments."""
    n_u = offset_floats
    system = (itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                Q_f=np.eye(2), device="cpu") if n_u == 1
              else itt.make_double_pendulum(
                  0.01, [np.pi, 0, 0, 0], Q=np.eye(4), R=np.eye(2),
                  Q_f=np.eye(4), integrator="euler", device="cpu"))
    n_x, N = system.n_x, 500
    U_prev = torch.arange(501.0 * n_u).reshape(501, n_u)
    view = U_prev[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset_floats
    x0, X_old = torch.zeros(n_x), torch.zeros(N + 1, n_x)
    u_ff, K = torch.zeros(N, n_u), torch.zeros(N, n_u, n_x)

    class StandIn:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return lambda *args: self.calls.append((name, args)) or 0

    strided = torch.arange(2.0 * N * n_u).reshape(N, 2 * n_u)[:, ::2]
    assert not strided.is_contiguous()
    for U_in in (view, strided):
        X_k, U_k, u_k, K_k = fused_rollout.kernel_inputs(system, x0, X_old,
                                                          U_in, u_ff, K)
        assert (X_k, u_k, K_k) == (X_old, u_ff, K)   # the same tensors
        U_o = fused_rollout.kernel_inputs(system, x0, None, U_in, None,
                                          None)[1]
        if U_in is view:
            assert U_k.data_ptr() == U_o.data_ptr() == view.data_ptr()
        else:
            assert U_k.is_contiguous() and torch.equal(U_k, strided)
            assert U_o.is_contiguous() and torch.equal(U_o, strided)
        lib = StandIn()
        fused_rollout.launch_costs(lib, system, x0, torch.ones(3), X_k, U_k,
                                   u_k, K_k, None)
        fused_rollout.launch_trajectory(lib, system, x0, 0.5, X_k, U_k, u_k,
                                        K_k, None)
        fused_rollout.launch_open_loop(lib, system, x0, U_o, None)
        assert [c[0] for c in lib.calls] == [
            "ilqr_linesearch_costs", "ilqr_closed_loop_rollout",
            "ilqr_open_loop_rollout"]
        for (_, args), U_passed in zip(lib.calls, (U_k, U_k, U_o)):
            assert U_passed.data_ptr() in args and N in args


def test_params_buffer_is_built_once_per_set_of_parameters():
    """The launchers' parameter buffer (`_params_on`) is built once for a
    set of parameter tensors and reused, by a system rebuilt around them
    too, so a launch does not concatenate the parameters on the device
    again; an in-place change of a parameter builds it anew."""
    dp = itt.make_double_pendulum(0.01, [np.pi, 0, 0, 0], Q=np.eye(4),
                                  R=np.eye(2), Q_f=np.eye(4),
                                  integrator="euler", device="cpu")
    cpu = torch.device("cpu")
    buf = fused_rollout._params_on(dp, cpu)
    assert fused_rollout._params_on(dp, cpu) is buf
    assert fused_rollout._params_on(dp.replace(newton_iters=3), cpu) is buf
    assert torch.equal(buf, fused_rollout.params_buffer(dp))
    dp.params["Q"].mul_(2.0)
    fresh = fused_rollout._params_on(dp, cpu)
    assert fresh is not buf
    assert torch.equal(fresh, fused_rollout.params_buffer(dp))
    with pytest.raises(ValueError, match="parameters are on"):
        fused_rollout._params_on(dp, torch.device("meta"))


def test_kernel_input_checks_refuse_what_the_kernel_does_not_take():
    dp = itt.make_double_pendulum(0.01, [np.pi, 0, 0, 0], Q=np.eye(4),
                                  R=np.eye(2), Q_f=np.eye(4),
                                  integrator="euler", device="cpu")
    N = 5
    good = dict(x0=torch.zeros(4), X_old=torch.zeros(N + 1, 4),
                U_old=torch.zeros(N, 2), u_ff=torch.zeros(N, 2),
                K=torch.zeros(N, 2, 4))
    assert fused_rollout._check(dp, **good) == N
    for key, value in (("x0", torch.zeros(4, dtype=torch.float64)),
                       ("X_old", torch.zeros(N, 4)),
                       ("K", torch.zeros(N, 4, 2).transpose(1, 2)),
                       ("u_ff", torch.zeros(N, 1))):
        with pytest.raises((TypeError, ValueError)):
            fused_rollout._check(dp, **{**good, key: value})


def test_kernel_input_checks_refuse_unaligned_arrays():
    """The kernels used to refuse views that do not start on 16 bytes, and
    the wrappers copied them; they now place every run at its own 16-byte
    phase (csrc/runs.cuh), so the checks take a contiguous view at any
    offset, for the open loop too, and still refuse a strided one."""
    dp = itt.make_double_pendulum(0.01, [np.pi, 0, 0, 0], Q=np.eye(4),
                                  R=np.eye(2), Q_f=np.eye(4),
                                  integrator="euler", device="cpu")
    N = 5
    good = dict(x0=torch.zeros(4), X_old=torch.zeros(N + 1, 4),
                U_old=torch.zeros(N, 2), u_ff=torch.zeros(N, 2),
                K=torch.zeros(N, 2, 4))
    shifted = dict(X_old=torch.zeros((N + 1) * 4 + 1)[1:].view(N + 1, 4),
                   U_old=torch.zeros(N * 2 + 1)[1:].view(N, 2),
                   u_ff=torch.zeros(N * 2 + 3)[3:].view(N, 2),
                   K=torch.zeros(N * 8 + 2)[2:].view(N, 2, 4))
    for key, value in shifted.items():
        assert value.is_contiguous() and value.data_ptr() % 16 != 0
        assert fused_rollout._check(dp, **{**good, key: value}) == N
    x0 = torch.zeros(5)[1:]
    assert fused_rollout._check(dp, **{**good, "x0": x0}) == N
    assert fused_rollout._check(dp, good["x0"], None, shifted["U_old"], None,
                                None) == N
    with pytest.raises(ValueError, match="contiguous"):
        fused_rollout._check(dp, good["x0"], None,
                             torch.zeros(N, 4)[:, ::2], None, None)
