"""The standalone Riccati suffix scan (kernels B6 and B7) against ilqr_tpu.

On CPU tensors `suffix_scan_fused` runs its plain version,
`parallel_riccati.suffix_scan`; these tests hold that path to JAX's
kernels in interpret mode (both layouts, at a horizon that crosses the
kernel's block) and to JAX's associative scan in f64, check the backward
pass built on it (`backward_pass_suffix_scan`, JAX's
`backward_pass_pallas`) with more than six controls, and the wrapper's
dispatch and input checks.  The CUDA kernels themselves are held to the
plain version on the GPU by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.ops.linearize import linearize_trajectory as jax_linearize
from ilqr_tpu.ops.pallas_riccati import backward_pass_pallas as jax_bp_pallas
from ilqr_tpu.ops.pallas_riccati import suffix_scan_pallas as jax_suffix_pallas
from ilqr_tpu.ops.parallel_riccati import (
    backward_pass_associative as jax_associative,
)
from ilqr_tpu.ops.parallel_riccati import make_elements as jax_make_elements
from ilqr_tpu.ops.parallel_riccati import suffix_scan as jax_suffix_scan
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import shooting, solver
from ilqr_tpu_torch.ops import _build, suffix_scan
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

torch.set_num_threads(1)

FIELDS = RiccatiElement._fields


def _jax_system(name):
    if name == "pendulum":
        return it.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                                R=0.1 * np.eye(1), Q_f=100.0 * np.eye(2),
                                d=0.0, integrator="rk4")
    return it.make_double_pendulum(
        0.01, [np.pi, 0.0, 0.0, 0.0], Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=np.diag([0.1, 0.1]), Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler")


def _elements(name, M, x64):
    """Riccati elements (numpy) of a real expansion along the clipped-sine
    controls of bench.py's limited cell, M = N + 1."""
    jsys = _jax_system(name)
    N = M - 1
    U = np.clip(2.5 * np.sin(np.linspace(0.0, 40.0, N)), -2.0, 2.0)
    U = np.repeat(U[:, None], jsys.n_u, axis=1)

    def run(j):
        X, _ = jax.jit(it.rollout)(j, jnp.zeros(j.n_x), jnp.asarray(U))
        exp = jax.jit(jax_linearize)(j, X, jnp.asarray(U))
        return jax.tree_util.tree_map(np.asarray,
                                      jax_make_elements(exp, 0.0))

    if x64:
        with enable_x64_oracle():
            return run(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jsys))
    return run(jsys)


def _port_elements(elems, dtype):
    return RiccatiElement(*(torch.tensor(np.asarray(a), dtype=dtype)
                            for a in elems))


def _check_fields(got, ref, rtol):
    """Each field within rtol of that field's max|ref| (windowed products
    over a long horizon span many orders of magnitude)."""
    for name, g, r in zip(FIELDS, got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=rtol * max(np.abs(r).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("layout,M", [
    ("sub", 1100), ("lane", 2100), ("sub", 255), ("sub", 256), ("sub", 257),
    ("sub", 513), ("lane", 127), ("lane", 128), ("lane", 129)])
def test_suffix_scan_fused_matches_jax_kernel_interpret(layout, M):
    """f32, pendulum elements, against JAX's B6 ('sub', blocks of 1024
    steps) and B7 ('lane', blocks of 2048) in interpret mode, at an M that
    crosses the block and at the CUDA kernel's tile edges (256 elements a
    tile for 'sub', 128 for 'lane'): every field within 1e-4 of its max
    (two f32 scans in different association orders)."""
    elems = _elements("pendulum", M, x64=False)
    ref = jax_suffix_pallas(RiccatiElement(*map(jnp.asarray, elems)),
                            interpret=True, layout=layout)
    counts = _build.launch_counts()
    got = itt.suffix_scan_fused(_port_elements(elems, torch.float32),
                                layout=layout)
    assert _build.launch_counts() == counts  # the plain version: no launch
    _check_fields(got, ref, 1e-4)


@pytest.mark.parametrize("name", ["pendulum", "dp"])
def test_suffix_scan_fused_matches_jax_scan_f64(name):
    """f64, M = 1411, all five fields against JAX's associative scan to
    1e-10 of each field's max, in both layouts."""
    elems = _elements(name, 1411, x64=True)
    with enable_x64_oracle():
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_suffix_scan)(
            RiccatiElement(*map(jnp.asarray, elems))))
    for layout in ("sub", "lane"):
        got = itt.suffix_scan_fused(_port_elements(elems, torch.float64),
                                    layout=layout)
        _check_fields(got, ref, 1e-10)


def _wide_expansion(N, n_x, n_u, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(n_x) + 0.1 * rng.standard_normal((N, n_x, n_x))
    B = 0.3 * rng.standard_normal((N, n_x, n_u))
    M = rng.standard_normal((N, n_u, n_u))
    return dict(
        f_x=A, f_u=B, l_x=rng.standard_normal((N, n_x)),
        l_u=rng.standard_normal((N, n_u)),
        l_xx=np.broadcast_to(np.eye(n_x), (N, n_x, n_x)).copy(),
        l_ux=0.1 * rng.standard_normal((N, n_u, n_x)),
        l_uu=M @ M.transpose(0, 2, 1) / n_u + np.eye(n_u),
        v_x=rng.standard_normal(n_x), v_xx=10.0 * np.eye(n_x))


@pytest.mark.parametrize("with_defects", [False, True])
def test_backward_pass_suffix_scan_wide_controls(with_defects):
    """n_u = 7 > 6 (beyond B1's reach) on a synthetic expansion (n_x = 3,
    N = 40): f64 against JAX's associative pass (rtol 1e-10), f32 against
    JAX's `backward_pass_pallas` in interpret mode (rtol 1e-4 of each
    output's max)."""
    N, n_x, n_u = 40, 3, 7
    e = _wide_expansion(N, n_x, n_u, seed=5)
    d = (0.05 * np.random.default_rng(6).standard_normal((N, n_x))
         if with_defects else None)
    with enable_x64_oracle():
        jexp = it.TrajectoryExpansion(**{k: jnp.asarray(v)
                                         for k, v in e.items()})
        ref = jax.jit(jax_associative)(jexp, 0.1,
                                       None if d is None else jnp.asarray(d))
    exp64 = itt.TrajectoryExpansion(**{k: torch.tensor(v)
                                       for k, v in e.items()})
    for layout in ("sub", "lane"):
        got = itt.backward_pass_suffix_scan(
            exp64, 0.1, layout=layout,
            defects=None if d is None else torch.tensor(d))
        assert bool(got[3]) and got[1].shape == (N, n_u, n_x)
        assert got[0].is_contiguous() and got[1].is_contiguous()
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                       atol=1e-12)
    jexp32 = it.TrajectoryExpansion(**{k: jnp.asarray(v, jnp.float32)
                                       for k, v in e.items()})
    ref32 = jax_bp_pallas(jexp32, 0.1, interpret=True,
                          defects=None if d is None
                          else jnp.asarray(d, jnp.float32))
    exp32 = itt.TrajectoryExpansion(**{k: torch.tensor(v, dtype=torch.float32)
                                       for k, v in e.items()})
    got = itt.backward_pass_suffix_scan(
        exp32, 0.1, defects=None if d is None
        else torch.tensor(d, dtype=torch.float32))
    for g, r in zip(got[:3], ref32[:3]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_pallas_backward_routes_wide_controls_to_the_suffix_scan(monkeypatch):
    """backward='pallas' sends n_u ≤ 6 to B1's wrapper and n_u > 6 to the
    suffix-scan pass, in `solve` and in `solve_ms`."""
    calls = []

    def spy(name):
        def fn(exp, reg, defects=None):
            calls.append(name)
            return itt.backward_pass_associative(exp, reg, defects)
        return fn

    for mod in (solver, shooting):
        monkeypatch.setattr(mod, "backward_pass_fused", spy("fused"))
        monkeypatch.setattr(mod, "backward_pass_suffix_scan", spy("suffix"))
    cfg = itt.IlqrConfig(backward="pallas")
    for n_u, want in ((6, "fused"), (7, "suffix")):
        e = itt.TrajectoryExpansion(**{
            k: torch.tensor(v) for k, v in _wide_expansion(5, 3, n_u,
                                                           0).items()})
        calls.clear()
        solver._backward(e, torch.zeros(5, n_u, dtype=torch.float64), 0.0,
                         cfg)
        shooting._backward_ms(e, torch.zeros(5, 3, dtype=torch.float64),
                              0.0, cfg)
        assert calls == [want, want]


def test_dispatch_and_input_checks():
    """What the CUDA wrapper refuses before a launch, and the dispatch rules
    that need no GPU: an unknown layout raises; n_x > 16 runs the plain scan
    on every device (here the meta device, which has no kernel); another
    device than CPU or CUDA raises."""
    elems = _port_elements(_elements("pendulum", 9, x64=False),
                           torch.float32)
    suffix_scan._check(elems)
    with pytest.raises(ValueError, match="layout"):
        itt.suffix_scan_fused(elems, layout="row")
    bad = elems._replace(J=elems.J.double())
    with pytest.raises(TypeError, match="float32"):
        suffix_scan._check(bad)
    bad = elems._replace(A=elems.A.transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        suffix_scan._check(bad)
    bad = elems._replace(b=elems.b[:-1])
    with pytest.raises(ValueError, match="shape"):
        suffix_scan._check(bad)
    meta = RiccatiElement(*(t.to("meta") for t in elems))
    with pytest.raises(ValueError, match="device"):
        itt.suffix_scan_fused(meta)
    wide = RiccatiElement(*(torch.zeros((5,) + (17,) * (t.ndim - 1),
                                        device="meta") for t in elems))
    out = itt.suffix_scan_fused(wide)
    assert out.J.shape == (5, 17, 17) and out.J.device.type == "meta"
