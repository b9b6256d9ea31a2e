"""The wide shapes of the suffix scan (B6w) through its plain version,
against ilqr_tpu.

On CPU tensors `suffix_scan_fused` runs the plain scan, the function the
CUDA wide form is held to on the card: against JAX's B6
(`suffix_scan_pallas`) in interpret mode at n = 6 and a small M in f32
(1e-4 of each field's max: f32 scans in other association orders), and
at n = 6, 12 and 16 against JAX's associative scan in f64 (1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.pallas_riccati import suffix_scan_pallas as jax_suffix_pallas
from ilqr_tpu.ops.parallel_riccati import make_elements as jax_make_elements
from ilqr_tpu.ops.parallel_riccati import suffix_scan as jax_suffix_scan
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement
from test_torch_wide_plain import _close, _expansion, _jax

torch.set_num_threads(1)


def _elements(M, n, seed):
    e = _expansion(M, n, 2, seed)
    with enable_x64_oracle():
        el = jax.jit(jax_make_elements)(_jax(e, jnp.float64), 0.0)
        return [np.asarray(f) for f in el]


def test_wide_suffix_scan_matches_jax_kernel_interpret():
    """f32, n = 6, M = 9, against JAX's B6 in interpret mode (about a
    minute on a CPU: the interpreter compiles the kernel's row-symbolic QR
    inverse slowly, and minutes at n = 12 and 16, which the f64 test below
    and the card's check of the kernel against the plain scan cover)."""
    el = _elements(9, 6, 6)
    ref = jax_suffix_pallas(RiccatiElement(*(jnp.asarray(f, jnp.float32)
                                             for f in el)), interpret=True)
    counts = _build.launch_counts()
    got = itt.suffix_scan_fused(RiccatiElement(*(
        torch.tensor(f, dtype=torch.float32) for f in el)))
    assert _build.launch_counts() == counts   # the plain version: no launch
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("n", [6, 12, 16])
def test_wide_suffix_scan_matches_jax_f64(n):
    """f64, M = 70, all five fields against JAX's associative scan."""
    el = _elements(70, n, n + 1)
    with enable_x64_oracle():
        ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_suffix_scan)(
            RiccatiElement(*map(jnp.asarray, el))))
    got = itt.suffix_scan_fused(RiccatiElement(*map(torch.tensor, el)))
    _close(got, ref, 1e-10)
