"""The port's multi-candidate affine prefix scan against ilqr_tpu's.

On CPU tensors `affine_prefix_scan_multi` runs its plain version (the
recursive-doubling prefix scan) under every engine; the CUDA kernel
(csrc/affine_scan.cu) is checked against the same plain version on the GPU
by chip_smoke.py.  Here the plain version is held against JAX's
``engine='xla'`` scan in f32 and f64 (JAX under `enable_x64_oracle`),
against the recurrence itself, and against the Pallas kernel it replaces,
run by the JAX package's interpret mode, at the CUDA kernel's tile edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import pallas_affine
from ilqr_tpu.ops import parallel_rollout as jax_parallel_rollout
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import affine_scan, parallel_rollout

torch.set_num_threads(1)

# f32: the two packages associate the scan differently (XLA's
# associative_scan against recursive doubling); tests/test_pallas_affine.py
# holds the Pallas kernel to the same 1e-4.  f64: rounding only.
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _problem(N, n, A, seed):
    rng = np.random.default_rng(seed)
    P = 0.2 * rng.normal(size=(N, n, n)) + 0.85 * np.eye(n)
    return P, rng.normal(size=(A, N, n)), rng.normal(size=(A, n))


_jax_multi = jax.jit(pallas_affine.affine_prefix_scan_multi,
                     static_argnames=("engine", "interpret"))


def _jax_scan(P, q, d0, dtype, engine="xla", interpret=None):
    def run(dt):
        out = _jax_multi(jnp.asarray(P, dt), jnp.asarray(q, dt),
                         jnp.asarray(d0, dt), engine=engine,
                         interpret=interpret)
        return np.asarray(out)

    if dtype == torch.float64:
        with enable_x64_oracle():
            return run(jnp.float64)
    return run(jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,n,A", [(1, 4, 2), (5, 2, 1), (60, 3, 4),
                                   (257, 4, 10), (700, 2, 16)])
def test_plain_scan_matches_jax_xla(N, n, A, dtype):
    P, q, d0 = _problem(N, n, A, seed=N)
    ref = _jax_scan(P, q, d0, dtype)
    t = lambda a: torch.tensor(a, dtype=dtype)
    for engine in affine_scan.ENGINES:
        got = itt.affine_prefix_scan_multi(t(P), t(q), t(d0), engine=engine)
        assert got.shape == (A, N + 1, n) and got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=engine)


def test_plain_scan_is_the_recurrence():
    P, q, d0 = _problem(130, 4, 3, seed=1)
    ref = np.zeros((3, 131, 4))
    for a in range(3):
        x = ref[a, 0] = d0[a]
        for k in range(130):
            x = ref[a, k + 1] = P[k] @ x + q[a, k]
    got = itt.affine_prefix_scan_multi(torch.tensor(P), torch.tensor(q),
                                       torch.tensor(d0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("N,n,A", [(40, 2, 2), (255, 2, 16), (256, 4, 1),
                                   (257, 2, 16), (513, 4, 1)])
def test_cpu_path_matches_jax_pallas_kernel_interpret(N, n, A):
    """The wrapper on CPU tensors against the Pallas kernel it replaces
    (f32, interpret mode, which is slow to compile): a small single-block
    case, then horizons at the CUDA kernel's 256-step tile edges (255, 256,
    257) and across two of them (513), with 1 and 16 candidates."""
    P, q, d0 = _problem(N, n, A, seed=4)
    ref = _jax_scan(P, q, d0, torch.float32, engine="pallas", interpret=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    got = itt.affine_prefix_scan_multi(t(P), t(q), t(d0), engine="pallas")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_drive_scan_matches_jax(dtype):
    P, q, d0 = _problem(90, 2, 1, seed=9)

    def run(dt):
        return np.asarray(jax.jit(jax_parallel_rollout.affine_prefix_scan)(
            jnp.asarray(P, dt), jnp.asarray(q[0], dt), jnp.asarray(d0[0], dt)))

    if dtype == torch.float64:
        with enable_x64_oracle():
            ref = run(jnp.float64)
    else:
        ref = run(jnp.float32)
    t = lambda a: torch.tensor(a, dtype=dtype)
    got = parallel_rollout.affine_prefix_scan(t(P), t(q[0]), t(d0[0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_dispatch_refuses_what_the_kernel_does_not_take():
    """Engine names as in JAX.  Off the CPU, 'auto' launches the kernel
    where it takes the inputs (float32, n <= 16, any number of candidates:
    here a meta tensor, which no kernel takes, raises at the device check)
    and runs the plain version elsewhere (float64), as JAX's 'auto' runs
    XLA; 'pallas' raises where the kernel does not take the inputs and
    never runs the plain version.  Then the checks the CUDA wrapper runs
    before a launch."""
    P, q, d0 = (torch.tensor(a, dtype=torch.float32)
                for a in _problem(6, 4, 3, seed=0))
    with pytest.raises(ValueError, match="engine"):
        itt.affine_prefix_scan_multi(P, q, d0, engine="cuda")
    meta = dict(device="meta", dtype=torch.float32)
    meta64 = dict(device="meta", dtype=torch.float64)
    for engine in ("auto", "pallas"):
        for n, A in ((3, 2), (12, 10), (2, 17), (4, 3)):
            with pytest.raises(ValueError, match="device"):
                itt.affine_prefix_scan_multi(torch.empty(6, n, n, **meta),
                                             torch.empty(A, 6, n, **meta),
                                             torch.empty(A, n, **meta),
                                             engine=engine)
    out = itt.affine_prefix_scan_multi(torch.empty(6, 12, 12, **meta64),
                                       torch.empty(10, 6, 12, **meta64),
                                       torch.empty(10, 12, **meta64))
    assert out.device.type == "meta" and tuple(out.shape) == (10, 7, 12)
    with pytest.raises(TypeError, match="float32"):
        itt.affine_prefix_scan_multi(torch.empty(6, 12, 12, **meta64),
                                     torch.empty(10, 6, 12, **meta64),
                                     torch.empty(10, 12, **meta64),
                                     engine="pallas")
    # n > 16 runs the plain version on every device, as in JAX.
    wide = itt.affine_prefix_scan_multi(torch.eye(17).expand(3, 17, 17),
                                        torch.ones(1, 3, 17),
                                        torch.zeros(1, 17), engine="pallas")
    np.testing.assert_allclose(wide[0, :, 0].numpy(), [0, 1, 2, 3])
    affine_scan._check(P, q, d0)
    for bad in ((P.double(), q, d0), (P.transpose(1, 2), q, d0),
                (P, q[:, :5], d0), (P, q, d0[:2])):
        with pytest.raises((TypeError, ValueError)):
            affine_scan._check(*bad)
