"""The port's backward passes against ilqr_tpu's.

On CPU tensors `backward_pass_fused` runs its plain version (the
associative scan); the CUDA kernel itself is checked against the same plain
version on the GPU by chip_smoke.py.  Here the CPU path is held against the
JAX fused Pallas kernel in interpret mode (once: interpret mode compiles
slowly), and the port's sequential, associative and fused passes against
JAX `backward_pass` and `backward_pass_associative` at several horizons, in
f32 and in f64 (JAX under `enable_x64_oracle`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.pallas_riccati import backward_pass_pallas_fused
from ilqr_tpu.ops.parallel_riccati import (
    backward_pass_associative as jax_associative,
)
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy
from ilqr_tpu_torch.ops import fused_riccati, parallel_riccati

torch.set_num_threads(1)

FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")
# Tolerances are relative to the largest entry of the reference.  f32:
# the Riccati recursion of the double pendulum (Q_f / R up to 1e4)
# amplifies rounding, and the two packages associate sums, inverses and the
# scan differently; the JAX tests hold the fused kernel to 2e-3
# (tests/test_pallas_riccati.py).  f64: the same algorithms agree to ~1e-9
# after that amplification.
RTOL = {torch.float32: 2e-3, torch.float64: 1e-8}


def _jax_dp(underactuated=False):
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1] if underactuated else [0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]), d1=0.1, d2=0.1,
        theta1=1 / 12, theta2=1 / 12, underactuated=underactuated,
        integrator="euler")


def _jax_pendulum():
    return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                            Q_f=10.0 * np.eye(2), d=0.0, integrator="rk4")


SYSTEMS = {"pendulum": _jax_pendulum, "dp": _jax_dp,
           "ua_dp": lambda: _jax_dp(underactuated=True)}


def _jax_expansion(name, N, seed, x64):
    """A JAX expansion along a random trajectory, as numpy fields."""
    jsys = SYSTEMS[name]()
    rng = np.random.default_rng(seed)
    X = 0.5 * rng.normal(size=(N + 1, jsys.n_x))
    U = 0.5 * rng.normal(size=(N, jsys.n_u))
    if x64:
        jsys = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      jsys)
        exp = jax.jit(jax_linearize)(jsys, jnp.asarray(X), jnp.asarray(U))
    else:
        exp = jax.jit(jax_linearize)(jsys, jnp.asarray(X, jnp.float32),
                                     jnp.asarray(U, jnp.float32))
    return exp


def _close(got, ref, rtol, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=rtol * (np.abs(ref).max() + 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,N", [("pendulum", 40), ("dp", 7),
                                    ("dp", 130), ("ua_dp", 65)])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_backward_passes_match_jax(name, N, reg, dtype):
    x64 = dtype == torch.float64
    if x64:
        with enable_x64_oracle():
            jexp = _jax_expansion(name, N, seed=N, x64=True)
            ref_seq = jax.jit(jax_backward)(jexp, reg)
            ref_par = jax.jit(jax_associative)(jexp, reg)
    else:
        jexp = _jax_expansion(name, N, seed=N, x64=False)
        ref_seq = jax.jit(jax_backward)(jexp, reg)
        ref_par = jax.jit(jax_associative)(jexp, reg)
    exp = expansion_from_numpy(jexp, dtype=dtype, device="cpu")
    rtol = RTOL[dtype]
    # reg enters the sequential pass on the gain solve only and the
    # associative pass in R as well (as in JAX): each port engine is held
    # to its JAX counterpart.
    for engine, ref in ((itt.backward_pass, ref_seq),
                        (itt.backward_pass_associative, ref_par),
                        (itt.backward_pass_fused, ref_par)):
        u_ff, K, dV, ok = engine(exp, reg)
        assert u_ff.dtype == dtype and bool(ok)
        for what, got, want in (("u_ff", u_ff, ref[0]), ("K", K, ref[1]),
                                ("dV", dV, ref[2])):
            _close(got, want, rtol, f"{engine.__name__} {what}")


def test_fused_cpu_path_matches_jax_fused_kernel_interpret():
    """The fused backward pass against the Pallas kernel it replaces, run
    by the JAX package's interpret mode on CPU (f32, one call: interpret
    mode is slow to compile)."""
    jexp = _jax_expansion("dp", 48, seed=5, x64=False)
    ref = backward_pass_pallas_fused(jexp, 0.05, interpret=True)
    exp = expansion_from_numpy(jexp, dtype=torch.float32, device="cpu")
    u_ff, K, dV, ok = itt.backward_pass_fused(exp, 0.05)
    assert bool(ok) and bool(ref[3])
    for what, got, want in (("u_ff", u_ff, ref[0]), ("K", K, ref[1]),
                            ("dV", dV, ref[2])):
        _close(got, want, RTOL[torch.float32], what)


def test_suffix_scan_is_the_sequential_value_function():
    """suffix[k] carries V(k): its (J, -eta) must equal the sequential
    recursion's value function (f64, reg = 0)."""
    with enable_x64_oracle():
        jexp = _jax_expansion("ua_dp", 33, seed=1, x64=True)
    exp = expansion_from_numpy(jexp, dtype=torch.float64, device="cpu")
    suffix = parallel_riccati.suffix_scan(
        parallel_riccati.make_elements(exp, 0.0))
    # V(0) by the plain recursion, step by step.
    V_x, V_xx = exp.v_x, exp.v_xx
    for k in range(exp.l_u.shape[0] - 1, -1, -1):
        f_x, f_u = exp.f_x[k], exp.f_u[k]
        Q_x = exp.l_x[k] + f_x.T @ V_x
        Q_u = exp.l_u[k] + f_u.T @ V_x
        Q_xx = exp.l_xx[k] + f_x.T @ V_xx @ f_x
        Q_ux = exp.l_ux[k] + f_u.T @ V_xx @ f_x
        Q_uu = exp.l_uu[k] + f_u.T @ V_xx @ f_u
        V_x = Q_x - Q_ux.T @ torch.linalg.solve(Q_uu, Q_u)
        V_xx = Q_xx - Q_ux.T @ torch.linalg.solve(Q_uu, Q_ux)
    np.testing.assert_allclose(suffix.J[0].numpy(), V_xx.numpy(), rtol=1e-9)
    np.testing.assert_allclose(-suffix.eta[0].numpy(), V_x.numpy(),
                               rtol=1e-9)


def test_unported_terms_raise():
    """The second-order terms are ported: zero DDP Hessians and zero noise
    give the plain recursion, and malformed terms raise."""
    jexp = _jax_expansion("pendulum", 4, seed=0, x64=False)
    exp = expansion_from_numpy(jexp, device="cpu")
    N, n_x, n_u = 4, 2, 1
    hess = itt.DynamicsHessians(torch.zeros(N, n_x, n_x, n_x),
                                torch.zeros(N, n_x, n_u, n_x),
                                torch.zeros(N, n_x, n_u, n_u))
    noise = (torch.zeros(N, n_x, 3), torch.zeros(N, n_x, 3, n_x),
             torch.zeros(N, n_x, 3, n_u))
    plain = itt.backward_pass(exp)
    for got in (itt.backward_pass(exp, hess=hess, noise=noise),
                itt.backward_pass_ddp_parallel(exp, hess=hess, noise=noise)):
        for g, p in zip(got[:3], plain[:3]):
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(AttributeError):
        itt.backward_pass(exp, hess=object())
    with pytest.raises(TypeError):
        itt.backward_pass(exp, noise=(None, None, None))


def test_fused_dispatch_sends_wide_systems_to_the_associative_pass():
    """As in JAX, n_u > 6 goes to backward_pass_associative (the fused
    kernels cap n_x at 16 and n_u at 6) — on CPU both are the plain pass,
    so this checks that the wide shape is accepted and agrees."""
    rng = np.random.default_rng(2)
    N, n_x, n_u = 6, 3, 7
    A = 0.3 * rng.normal(size=(N, n_x, n_x)) + np.eye(n_x)
    B = rng.normal(size=(N, n_x, n_u))
    exp = itt.TrajectoryExpansion(*(torch.tensor(a) for a in (
        A, B, rng.normal(size=(N, n_x)), rng.normal(size=(N, n_u)),
        np.broadcast_to(np.eye(n_x), (N, n_x, n_x)).copy(),
        np.zeros((N, n_u, n_x)),
        np.broadcast_to(np.eye(n_u), (N, n_u, n_u)).copy(),
        rng.normal(size=n_x), np.eye(n_x))))
    got = itt.backward_pass_fused(exp, 0.0)
    seq = itt.backward_pass(exp, 0.0)
    np.testing.assert_allclose(got[0].numpy(), seq[0].numpy(), rtol=1e-9,
                               atol=1e-12)
    assert fused_riccati.SHAPES == ((2, 1), (4, 1), (4, 2))


def test_kernel_input_checks_refuse_what_the_kernel_does_not_take():
    """The checks the CUDA wrapper runs before a launch (the kernel reads
    float32, contiguous tensors of the expansion's shapes)."""
    jexp = _jax_expansion("dp", 6, seed=0, x64=False)
    exp = expansion_from_numpy(jexp, dtype=torch.float32, device="cpu")
    fused_riccati._check(exp)
    import dataclasses

    bad = {
        "float64": dataclasses.replace(exp, l_x=exp.l_x.double()),
        "non-contiguous": dataclasses.replace(
            exp, f_x=exp.f_x.transpose(1, 2)),
        "shape": dataclasses.replace(exp, l_ux=exp.l_ux[:, :, :3]),
        "empty": dataclasses.replace(exp, **{
            f: getattr(exp, f)[:0] for f in FIELDS[:7]}),
    }
    for what, e in bad.items():
        with pytest.raises((TypeError, ValueError)):
            fused_riccati._check(e)


def test_singular_gain_systems_flag_instead_of_raising():
    """A singular Q_uu (here l_uu = 0 and f_u = 0 at one step) gives
    non-finite gains and ok = False in the unconstrained backward passes,
    as JAX's small solves do, instead of torch's singular-matrix error (the
    solver's accept rule and adaptive_reg then take over); the box-QP
    passes clip the infinite step to the box, as JAX's clip does."""
    jexp = _jax_expansion("pendulum", 6, seed=0, x64=False)
    exp = expansion_from_numpy(jexp, device="cpu")
    l_uu, f_u = exp.l_uu.clone(), exp.f_u.clone()
    l_uu[3], f_u[3] = 0.0, 0.0
    import dataclasses
    bad = dataclasses.replace(exp, l_uu=l_uu, f_u=f_u)
    U = torch.zeros(6, 1)
    for out in (itt.backward_pass(bad), itt.backward_pass_associative(bad),
                itt.backward_pass_suffix_scan(bad),
                itt.backward_pass_ddp_parallel(bad)):
        assert not bool(out[3])
        assert not bool(torch.isfinite(out[0]).all())
    for out in (itt.backward_pass_limited(bad, U, -1.0, 1.0),
                itt.backward_pass_limited_parallel(bad, U, -1.0, 1.0)):
        assert float(out[0].abs().max()) <= 1.0
