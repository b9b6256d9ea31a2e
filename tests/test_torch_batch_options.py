"""Batched solves with control limits, DDP/iLQG and adaptive regularization
against ilqr_tpu's ``jax.vmap(solve)``, per instance.

`solve_batch` runs B problems in one host loop; ``jax.vmap`` of JAX's
``while_loop`` runs each instance on its own.  What the batch must keep per
instance, checked here in f64 (JAX under `enable_x64_oracle`, jitted):

* limits clamp U_init and every rollout's controls, under the sequential
  box-QP pass ('scan'), the parallel limited pass ('pscan') and its
  'pallas' engine (B6 over the batch; its plain version on CPU tensors,
  where JAX runs 'pscan': its interpret-mode kernel stores f32);
* DDP (sequential and parallel), iLQG noise terms, and their batched
  Hessians and noise expansions;
* under adaptive_reg a (B,) regularization: an instance that retries
  counts the retry as an iteration (NaN trace slots) while the others
  accept, and one that passes reg_max stops alone;
* the batched limited parallel pass stops each instance after its own
  number of sweeps (JAX's loop under vmap);
* the batched suffix scan's plain version, and the surfaces built on
  `solve_batch` (`run_mpc_batched`, `solve_multistart`, the
  `examples_torch/batched_mpc.py` driver).

Per-instance agreement follows `tests/test_torch_batched.py::_compare`:
iterations, status and α traces exact (NaN slots equal), cost rtol 1e-8,
X 1e-7, U 1e-6.  The JAX systems are built outside `enable_x64_oracle`, so
that their f64 copies hold the parameters the port receives.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.ops.limited_parallel import (
    backward_pass_limited_parallel as jax_limited_parallel,
)
from ilqr_tpu.ops.linearize import dynamics_hessians as jax_hessians
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.parallel_riccati import make_elements as jax_make_elements
from ilqr_tpu.ops.parallel_riccati import suffix_scan as jax_suffix_scan
from ilqr_tpu.parallel.batch import solve_batched as jax_solve_batched
from ilqr_tpu.parallel.batch import solve_multistart as jax_multistart
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy, system_from_numpy
from ilqr_tpu_torch.ops import limited_parallel, parallel_riccati, suffix_scan
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)


def _jax_dp():
    return it.make_double_pendulum(
        0.02, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([100.0, 100.0, 10.0, 10.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="rk4")


def _jax_pendulum():
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=100.0 * np.eye(2), d=0.1,
                            integrator="backward_euler")


SYSTEMS = {"dp": _jax_dp, "pendulum": _jax_pendulum}
# Per system: the horizon and a batch of initial states (a swing from
# rest, which clamps under the pendulum's LIMIT, a small correction, which
# does not, and a state at the target).
N = {"dp": 30, "pendulum": 40}
X0S = {"dp": np.array([[0.0, 0.0, 0.0, 0.0], [np.pi - 0.02, 0.01, 0.0, 0.0],
                       [np.pi, 0.0, 0.0, 0.0]]),
       "pendulum": np.array([[0.0, 0.0], [np.pi - 0.05, 0.0],
                             [np.pi, 0.0]])}
LIMIT = {"pendulum": 1.5}


def _port(jsys):
    kind = "pendulum" if jsys.n_x == 2 else "double_pendulum"
    params = {k: np.asarray(v, np.float64) for k, v in jsys.params.items()}
    return system_from_numpy(kind, params, jsys.n_x, jsys.n_u, jsys.dt,
                             jsys.integrator, jsys.newton_iters,
                             dtype=torch.float64, device="cpu")


def _f64(jsys):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jsys)


def _jax_noise(x, u):
    """State- and control-dependent noise, two columns."""
    base = jnp.stack([jnp.ones_like(x), 0.5 * x], axis=1)
    return 0.05 * base * (1.0 + 0.1 * x[0] + 0.2 * u[0])


def _torch_noise(x, u):
    base = torch.stack([torch.ones_like(x), 0.5 * x], dim=1)
    return 0.05 * base * (1.0 + 0.1 * x[0] + 0.2 * u[0])


_JAX_CACHE = {}


def _jax_batch(name, x0s, n, cfg):
    """``jax.jit(jax.vmap(solve))`` in f64 from zero controls, as numpy;
    computed once per (system, inputs, config) in this module."""
    key = (name, x0s.tobytes(), n, repr(cfg))
    if key not in _JAX_CACHE:
        jsys = SYSTEMS[name]()
        with enable_x64_oracle():
            j64 = _f64(jsys)
            ref = jax.jit(jax.vmap(lambda x: it.solve(
                j64, x, jnp.zeros((n, jsys.n_u)), it.IlqrConfig(**cfg))))(
                    jnp.asarray(x0s))
            _JAX_CACHE[key] = jax.tree_util.tree_map(np.asarray, ref)
    return _JAX_CACHE[key]


def _port_batch(name, x0s, n, cfg):
    return itt.solve_batch(_port(SYSTEMS[name]()), torch.tensor(x0s, **F64),
                           torch.zeros((n, SYSTEMS[name]().n_u), **F64),
                           itt.IlqrConfig(**cfg))


def _compare(sol, ref):
    """`tests/test_torch_batched.py::_compare`'s rule at its f64 limits."""
    np.testing.assert_array_equal(sol.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(sol.status.numpy(), ref.status)
    np.testing.assert_array_equal(sol.alpha_trace.numpy(), ref.alpha_trace)
    np.testing.assert_allclose(sol.cost_trace.numpy(), ref.cost_trace,
                               rtol=1e-8)
    np.testing.assert_allclose(sol.cost.numpy(), ref.cost, rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(sol.X.numpy(), ref.X, atol=1e-7)
    np.testing.assert_allclose(sol.U.numpy(), ref.U, atol=1e-6)


def _jax_engine(backward):
    """JAX's engine for the port's: its 'pallas' passes cannot run f64."""
    return "pscan" if backward == "pallas" else backward


# ---- control limits ------------------------------------------------------

@pytest.mark.parametrize("name,backward", [
    ("pendulum", "scan"), ("pendulum", "pscan"), ("pendulum", "pallas")])
def test_limits_match_jax_vmap_solve(name, backward):
    """A batch where the swing from rest clamps and the small correction
    does not; U_init (zero) is inside the box, every rollout clips."""
    lim = LIMIT[name]
    cfg = dict(maxiter=12, tol=1e-6, u_min=-lim, u_max=lim)
    ref = _jax_batch(name, X0S[name], N[name],
                     dict(cfg, backward=_jax_engine(backward)))
    sol = _port_batch(name, X0S[name], N[name], dict(cfg, backward=backward))
    _compare(sol, ref)
    peak = sol.U.abs().amax(dim=(1, 2)).numpy()
    assert peak[0] == pytest.approx(lim) and peak[1] < 0.9 * lim
    assert sol.iterations[2] == 1 and sol.status[2] == itt.CONVERGED


def test_limits_clip_u_init_per_instance():
    """U_init outside the box is clamped before the initial rollout, per
    instance (one instance's guess is inside, one's outside): each
    instance as `solve` alone (held to JAX by test_torch_limited.py)."""
    name, n = "pendulum", 20
    lim = LIMIT[name]
    U0 = torch.zeros((2, n, 1), **F64)
    U0[1] = 4.0
    x0s = torch.tensor(X0S[name][:2], **F64)
    cfg = itt.IlqrConfig(maxiter=4, tol=1e-8, u_min=-lim, u_max=lim)
    system = _port(SYSTEMS[name]())
    sol = itt.solve_batch(system, x0s, U0, cfg)
    for i in range(2):
        one = itt.solve(system, x0s[i], U0[i], cfg)
        assert (int(sol.iterations[i]), int(sol.status[i])) == (
            one.iterations, one.status)
        torch.testing.assert_close(sol.U[i], one.U, rtol=0, atol=1e-12)
        torch.testing.assert_close(sol.cost[i], one.cost, rtol=1e-12,
                                   atol=0)
    assert float(sol.U.abs().max()) <= lim


# ---- DDP, iLQG ------------------------------------------------------------

@pytest.mark.parametrize("backward", ["scan", "pscan"])
def test_ddp_matches_jax_vmap_solve(backward):
    """Backward-Euler DDP: the batched Hessians differentiate
    `newton_polish` (nested forward mode through the implicit step's
    autograd.Function would give zeros)."""
    name = "pendulum"
    cfg = dict(maxiter=10, tol=1e-9, ddp=True, backward=backward,
               ddp_sweeps=3)
    ref = _jax_batch(name, X0S[name], N[name], cfg)
    sol = _port_batch(name, X0S[name], N[name], cfg)
    assert sol.iterations[0] >= 4
    _compare(sol, ref)


def test_noise_matches_jax_vmap_solve():
    name = "dp"
    cfg = dict(maxiter=8, tol=1e-9)
    ref = _jax_batch(name, X0S[name], N[name], dict(cfg, noise=_jax_noise))
    sol = _port_batch(name, X0S[name], N[name], dict(cfg, noise=_torch_noise))
    assert sol.iterations[0] >= 4
    _compare(sol, ref)


def test_batched_hessians_and_noise_match_per_instance():
    """`dynamics_hessians_batched` and `noise_expansion_batched` against
    their single-trajectory forms on each instance (backward Euler's
    Hessians through `newton_polish`)."""
    rng = np.random.default_rng(3)
    for name in ("pendulum", "dp"):
        system = _port(SYSTEMS[name]())
        U = torch.tensor(0.5 * rng.standard_normal((3, 7, system.n_u)), **F64)
        X, _ = itt.rollout(system, torch.tensor(0.3 * rng.standard_normal(
            (3, system.n_x)), **F64), U)
        hb = itt.dynamics_hessians_batched(system, X, U)
        nb = itt.noise_expansion_batched(_torch_noise, X, U)
        for i in range(3):
            h1 = itt.dynamics_hessians(system, X[i], U[i])
            n1 = itt.noise_expansion(_torch_noise, X[i], U[i])
            for a, b in zip((hb.f_xx, hb.f_ux, hb.f_uu) + tuple(nb),
                            (h1.f_xx, h1.f_ux, h1.f_uu) + tuple(n1)):
                torch.testing.assert_close(a[i], b, rtol=1e-12, atol=1e-12)
        assert float(hb.f_xx.abs().max()) > 0


# ---- adaptive regularization ---------------------------------------------

# The DP with a one-candidate line search (n_alphas=1): instance 0 never
# retries, instance 1 retries four times in a row early (its reg peaks at
# 1e-2), instance 2 fails more often and under REG_MAX passes reg_max at
# its eighth iteration and stops while the others run on.
ADAPTIVE_X0S = np.array([[2.283, -0.21, 0.0, 0.0],
                         [0.3, 0.9, 0.0, 0.0],
                         [-0.816, -0.926, 0.0, 0.0]])
REG_MAX = 0.05


@pytest.mark.parametrize("backward", ["scan", "pallas"])
def test_adaptive_reg_matches_jax_vmap_solve(backward):
    """Per-instance reg: retries count as iterations (NaN trace slots),
    and one instance ends LINESEARCH_FAILED past reg_max alone.  The
    port's 'pallas' is B4 fed the (B,) reg (its plain version here); JAX
    runs 'scan', the same sequential recursion."""
    cfg = dict(maxiter=16, tol=1e-9, n_alphas=1, adaptive_reg=True,
               reg_max=REG_MAX)
    ref = _jax_batch("dp", ADAPTIVE_X0S, N["dp"], dict(cfg, backward="scan"))
    sol = _port_batch("dp", ADAPTIVE_X0S, N["dp"],
                      dict(cfg, backward=backward))
    _compare(sol, ref)
    it_ = sol.iterations.numpy()
    retried = np.isnan(sol.alpha_trace.numpy())
    retries = [int(retried[i, :it_[i]].sum()) for i in range(3)]
    assert retries[0] == 0 and retries[1] >= 2 and retries[2] >= 1
    assert sol.status.tolist()[2] == itt.LINESEARCH_FAILED
    assert sol.status.tolist()[:2] != [itt.LINESEARCH_FAILED] * 2
    # The failed instance stopped while another instance ran on.
    assert it_[2] < it_.max()


@pytest.mark.parametrize("backward", ["pallas"])
def test_limits_ddp_adaptive_reg_together_match_jax(backward):
    name = "pendulum"
    lim = LIMIT[name]
    cfg = dict(maxiter=12, tol=1e-9, u_min=-lim, u_max=lim, ddp=True,
               adaptive_reg=True, reg_init=1e-6)
    ref = _jax_batch(name, X0S[name], N[name],
                     dict(cfg, backward=_jax_engine(backward)))
    sol = _port_batch(name, X0S[name], N[name], dict(cfg, backward=backward))
    _compare(sol, ref)
    assert float(sol.U.abs().max()) == pytest.approx(lim)


# ---- the batched limited parallel pass: per-instance sweeps --------------

def _limited_case():
    """Three pendulum (rk4) instances along seeded controls (a sine inside
    the box of LIMITED_BOX, at two phases) whose active sets settle after
    1, 2 and 12 sweeps (3, 4 and 24 with the Hessians)."""
    jsys = it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=np.zeros((2, 2)), d=0.0, integrator="rk4")
    rng = np.random.default_rng(11)
    x0s = 0.3 * rng.standard_normal((3, 2))
    x0s[2] = x0s[1]
    t = np.linspace(0.0, 6.0, 60)
    U = np.stack([0.5 * np.sin(t + p) for p in (0.0, 0.0, 2.1)])[..., None]
    with enable_x64_oracle():
        j64 = _f64(jsys)
        Xs = jax.jit(jax.vmap(lambda x, u: it.rollout(j64, x, u)[0]))(
            jnp.asarray(x0s), jnp.asarray(U))
        exp = jax.jit(jax.vmap(lambda x, u: jax_linearize(j64, x, u)))(
            Xs, jnp.asarray(U))
        hess = jax.jit(jax.vmap(lambda x, u: jax_hessians(j64, x, u)))(
            Xs, jnp.asarray(U))
    return exp, hess, U


LIMITED_BOX = (-0.5, 0.5)
LIMITED_REG = np.array([0.0, 1e-3, 0.0])
_LIMITED_REFS = {}


def _jax_limited_refs():
    """``jax.vmap(backward_pass_limited_parallel(engine='xla'))`` on
    `_limited_case` without and with the Hessians, in one jitted call."""
    if not _LIMITED_REFS:
        exp, hess, U = _limited_case()
        (lo, hi), reg = LIMITED_BOX, jnp.asarray(LIMITED_REG)

        def both(e, u, r, h):
            return tuple(jax.vmap(lambda e, u, r, h: jax_limited_parallel(
                e, u, lo, hi, r, engine="xla", hess=h if second else None))(
                    e, u, r, h) for second in (False, True))

        with enable_x64_oracle():
            refs = jax.jit(both)(exp, jnp.asarray(U), reg, hess)
        for second, ref in zip((False, True), refs):
            _LIMITED_REFS[second] = [np.asarray(a) for a in ref]
        _LIMITED_REFS["case"] = (exp, hess, U)
    return _LIMITED_REFS


@pytest.mark.parametrize("second_order", [False, True])
def test_batched_limited_pass_stops_each_instance_on_its_own(second_order):
    """Against ``jax.vmap(backward_pass_limited_parallel(engine='xla'))``:
    the instances settle after different numbers of sweeps (counted by
    running each alone), and the batch keeps each one's carries from its
    own last sweep, as vmap of JAX's while_loop does."""
    refs = _jax_limited_refs()
    exp, hess, U = refs["case"]
    ref = refs[second_order]
    (lo, hi), reg = LIMITED_BOX, LIMITED_REG
    exp_t = expansion_from_numpy(exp, dtype=torch.float64, device="cpu")
    U_t = torch.tensor(U, **F64)
    hess_t = itt.DynamicsHessians(*(torch.tensor(np.asarray(a), **F64)
                                    for a in (hess.f_xx, hess.f_ux,
                                              hess.f_uu)))
    h = hess_t if second_order else None
    got = itt.backward_pass_limited_parallel(
        exp_t, U_t, lo, hi, torch.tensor(reg, **F64), engine="pallas",
        hess=h)
    for name, a, b in zip(("u_ff", "K", "dV", "ok"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10,
                                   err_msg=name)
    # Each instance alone: its own sweep count, and the batch's values.
    sweeps = []
    plain_values = limited_parallel._suffix_values
    for i in range(3):
        calls = [0]

        def counted(*args, **kw):
            calls[0] += 1
            return plain_values(*args, **kw)

        limited_parallel._suffix_values = counted
        try:
            one = itt.backward_pass_limited_parallel(
                dataclasses.replace(exp_t, **{
                    f.name: getattr(exp_t, f.name)[i]
                    for f in dataclasses.fields(exp_t)}),
                U_t[i], lo, hi, float(reg[i]), engine="xla",
                hess=None if h is None else itt.DynamicsHessians(
                    h.f_xx[i], h.f_ux[i], h.f_uu[i]))
        finally:
            limited_parallel._suffix_values = plain_values
        sweeps.append(calls[0] - int(second_order))
        for a, b in zip(one[:3], got[:3]):
            torch.testing.assert_close(b[i], a, rtol=1e-10, atol=1e-12)
    assert len(set(sweeps)) == 3, sweeps


# ---- the batched suffix scan (plain version and checks) -----------------

def test_batched_suffix_scan_plain_version():
    """`suffix_scan_fused` on (B, M, ...) elements (CPU: the plain scan
    along axis 1) against a loop of single-instance plain calls and
    against ``jax.vmap(suffix_scan)``, with a per-instance reg."""
    exp = _jax_limited_refs()["case"][0]
    reg = np.array([0.0, 0.1, 0.5])
    with enable_x64_oracle():
        ref = jax.jit(jax.vmap(lambda e, r: jax_suffix_scan(
            jax_make_elements(e, r))))(exp, jnp.asarray(reg))
        ref = [np.asarray(a) for a in ref]
    exp_t = expansion_from_numpy(exp, dtype=torch.float64, device="cpu")
    elems = parallel_riccati.make_elements(exp_t, torch.tensor(reg, **F64))
    assert elems.A.shape == (3, 61, 2, 2)
    got = itt.suffix_scan_fused(elems)
    for name, a, b in zip(RiccatiElement._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    for i in range(3):
        one = parallel_riccati.suffix_scan(RiccatiElement(
            *(t[i] for t in elems)))
        for a, b in zip(got, one):
            torch.testing.assert_close(a[i], b, rtol=1e-13, atol=1e-13)


def test_batched_suffix_scan_checks():
    """What the CUDA wrapper refuses before the batched launch: shape,
    dtype, contiguity, an empty batch or sequence, the 'lane' layout."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    elems = RiccatiElement(z(3, 5, 2, 2), z(3, 5, 2), z(3, 5, 2, 2),
                           z(3, 5, 2), z(3, 5, 2, 2))
    suffix_scan._check(elems)
    with pytest.raises(ValueError, match="shape"):
        suffix_scan._check(elems._replace(b=z(2, 5, 2)))
    with pytest.raises(TypeError, match="float32"):
        suffix_scan._check(elems._replace(J=elems.J.double()))
    with pytest.raises(ValueError, match="contiguous"):
        suffix_scan._check(elems._replace(A=elems.A.transpose(0, 1)
                                          .contiguous().transpose(0, 1)))
    empty = RiccatiElement(z(0, 5, 2, 2), z(0, 5, 2), z(0, 5, 2, 2),
                           z(0, 5, 2), z(0, 5, 2, 2))
    with pytest.raises(ValueError, match="at least one"):
        suffix_scan._check(empty)
    with pytest.raises(ValueError, match="shape"):
        suffix_scan._check(RiccatiElement(*(t[None] for t in elems)))
    with pytest.raises(ValueError, match="layout 'sub'"):
        itt.suffix_scan_fused(elems, layout="lane")
    meta = RiccatiElement(*(t.to("meta") for t in elems))
    with pytest.raises(ValueError, match="device"):
        itt.suffix_scan_fused(meta)


# ---- the surfaces ----------------------------------------------------------

def test_run_mpc_batched_with_limits_matches_jax():
    """``jax.vmap(run_mpc)`` per instance, with limits and adaptive_reg
    (the pendulum, backward Euler)."""
    name, H, n_sim = "pendulum", 20, 3
    jsys = SYSTEMS[name]()
    x0s = X0S[name][:2]
    lim = LIMIT[name]
    cfg = dict(maxiter=5, tol=1e-6, u_min=-lim, u_max=lim,
               adaptive_reg=True)
    with enable_x64_oracle():
        j64 = _f64(jsys)
        ref = jax.jit(lambda x: jax_mpc.run_mpc_batched(
            j64, j64, x, jnp.zeros((H, 1)), n_sim, it.IlqrConfig(**cfg)))(
                jnp.asarray(x0s))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    system = _port(jsys)
    res = itt.run_mpc_batched(system, system, torch.tensor(x0s, **F64),
                              torch.zeros((H, 1), **F64), n_sim,
                              itt.IlqrConfig(**cfg))
    np.testing.assert_array_equal(res.solve_iters.numpy(), ref.solve_iters)
    np.testing.assert_array_equal(res.solve_status.numpy(),
                                  ref.solve_status)
    np.testing.assert_allclose(res.X.numpy(), ref.X, atol=1e-7)
    np.testing.assert_allclose(res.U.numpy(), ref.U, atol=1e-6)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-8)
    assert float(res.U.abs().max()) == pytest.approx(lim)


def test_solve_multistart_with_limits_matches_jax():
    name, n = "pendulum", N["pendulum"]
    jsys = SYSTEMS[name]()
    lim = LIMIT[name]
    rng = np.random.default_rng(5)
    U_inits = rng.uniform(-2.0, 2.0, (3, n, 1))
    x0 = np.zeros(2)
    cfg = dict(maxiter=10, tol=1e-8, u_min=-lim, u_max=lim)
    with enable_x64_oracle():
        best_j, sols_j = jax_multistart(_f64(jsys), jnp.asarray(x0),
                                        jnp.asarray(U_inits),
                                        it.IlqrConfig(**cfg))
        best_j, sols_j = jax.tree_util.tree_map(np.asarray, (best_j, sols_j))
    best, sols = itt.solve_multistart(_port(jsys), torch.tensor(x0, **F64),
                                      torch.tensor(U_inits, **F64),
                                      itt.IlqrConfig(**cfg))
    _compare(sols, sols_j)
    assert (best.iterations, best.status) == (int(best_j.iterations),
                                              int(best_j.status))
    np.testing.assert_allclose(best.U.numpy(), best_j.U, atol=1e-6)
    assert float(sols.U.abs().max()) <= lim


def test_batched_mpc_driver_matches_jax(monkeypatch):
    """`examples_torch/batched_mpc.py` at smoke size against the JAX
    package's `solve_batched` on the driver's own problem (f32 parameters
    and draws, JAX's 'auto' engines): costs within 1e-4 relative."""
    monkeypatch.setenv("ILQR_TPU_SMOKE", "1")
    driver = importlib.import_module("examples_torch.batched_mpc")
    p = driver.problem(device="cpu")
    out = driver.main(device="cpu", reps=1)
    prm = {k: v.detach().cpu().numpy() for k, v in p.system.params.items()}
    f = {k: float(v) for k, v in prm.items() if v.ndim == 0 and k != "dt"}
    jsys = it.make_double_pendulum(
        p.system.dt, prm["x_target"], prm["Q"], prm["R"], prm["Q_f"],
        integrator=p.system.integrator, **f)
    c = p.config
    ref = jax_solve_batched(
        jsys, jnp.asarray(p.x0s.numpy()), jnp.asarray(p.U0.numpy()),
        it.IlqrConfig(maxiter=c.maxiter, tol=c.tol, u_min=c.u_min,
                      u_max=c.u_max))
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
