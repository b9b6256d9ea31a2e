"""The wide shapes of the fused backward pass (B1w) and of the suffix scan
(B6w) through their plain versions, against ilqr_tpu.

On CPU tensors `backward_pass_fused` runs `backward_pass_associative` and
`suffix_scan_fused` the plain scan: the functions the CUDA wide forms are
held to on the card.  Here at (n_x, n_u) = (3, 1), (5, 2), (6, 2), (12, 4),
(16, 4) and (16, 6) against JAX's sequential `backward_pass` in f64 at
reg 0 (1e-9 of each output's max; with reg > 0 the parallel form
regularizes its elements and the sequential one only its gain solves), against the Pallas kernels B1 and B6 in
interpret mode in f32 at small sizes (the interpreter takes minutes at
the larger widths, `tests/test_pallas_riccati_ext.py:43-66`; 2e-4 of
each output's max: f32 scans in other association orders), and with
GNMS defects (B1d) at (12, 4).  The suffix scan's wide shapes are in
test_torch_wide_scan.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops.linearize import TrajectoryExpansion as JaxExpansion
from ilqr_tpu.ops.pallas_riccati import backward_pass_pallas_fused
from ilqr_tpu.ops.riccati import backward_pass as jax_backward
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.convert import expansion_from_numpy
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.parallel_riccati import RiccatiElement

torch.set_num_threads(1)

FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")
SHAPES = [(3, 1), (5, 2), (6, 2), (12, 4), (16, 4), (16, 6)]


def _expansion(N, n_x, n_u, seed):
    """A seeded expansion (numpy, f64) with positive definite l_uu."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, n_u, n_u))
    return dict(
        f_x=np.eye(n_x) + 0.05 * rng.standard_normal((N, n_x, n_x)),
        f_u=0.3 * rng.standard_normal((N, n_x, n_u)),
        l_x=rng.standard_normal((N, n_x)), l_u=rng.standard_normal((N, n_u)),
        l_xx=np.broadcast_to(np.eye(n_x), (N, n_x, n_x)).copy(),
        l_ux=0.1 * rng.standard_normal((N, n_u, n_x)),
        l_uu=M @ M.transpose(0, 2, 1) / n_u + np.eye(n_u),
        v_x=rng.standard_normal(n_x), v_xx=10.0 * np.eye(n_x))


def _jax(e, dtype):
    return JaxExpansion(**{k: jnp.asarray(e[k], dtype) for k in FIELDS})


def _close(got, ref, rtol):
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        err = np.abs(g.double().numpy() - r).max()
        assert err <= rtol * max(np.abs(r).max(), 1e-30), (err, rtol)


@pytest.mark.parametrize("n_x,n_u", SHAPES)
def test_wide_backward_pass_matches_jax_sequential_f64(n_x, n_u):
    e = _expansion(60, n_x, n_u, n_x * 10 + n_u)
    with enable_x64_oracle():
        ref = jax.jit(jax_backward)(_jax(e, jnp.float64), 0.0)
        ref = [np.asarray(r) for r in ref]
    counts = _build.launch_counts()
    got = itt.backward_pass_fused(
        expansion_from_numpy(e, device="cpu", dtype=torch.float64), 0.0)
    assert _build.launch_counts() == counts   # the plain version: no launch
    assert bool(got[3]) and bool(ref[3])
    assert got[1].shape == (60, n_u, n_x)
    _close(got[:3], ref[:3], 1e-9)


def test_wide_backward_pass_with_defects_matches_jax_f64():
    """B1d's plain path at (12, 4): the GNMS gaps in the elements' offsets
    and in V_x of the gains."""
    e = _expansion(40, 12, 4, 3)
    d = 0.01 * np.random.default_rng(4).standard_normal((40, 12))
    with enable_x64_oracle():
        ref = jax.jit(jax_backward)(_jax(e, jnp.float64), 0.0,
                                    defects=jnp.asarray(d))
        ref = [np.asarray(r) for r in ref]
    got = itt.backward_pass_fused(
        expansion_from_numpy(e, device="cpu", dtype=torch.float64), 0.0,
        torch.tensor(d))
    _close(got[:3], ref[:3], 1e-9)


@pytest.mark.parametrize("n_x,n_u", [(5, 2), (6, 2)])
def test_wide_backward_pass_matches_jax_fused_kernel_interpret(n_x, n_u):
    """f32 against the Pallas kernel B1 replaces, in interpret mode, at a
    small N (one call: the interpreter compiles slowly)."""
    e = _expansion(12, n_x, n_u, n_x)
    ref = backward_pass_pallas_fused(_jax(e, jnp.float32), 0.05,
                                     interpret=True)
    got = itt.backward_pass_fused(
        expansion_from_numpy(e, device="cpu", dtype=torch.float32), 0.05)
    assert bool(got[3]) and bool(ref[3])
    _close(got[:3], ref[:3], 2e-4)


def test_wide_shapes_reach_the_kernels_on_cuda():
    """What the CUDA path takes (checked without a GPU through the entries
    a launch calls, with a stand-in library): every n_x <= 16, n_u <= 6 for
    the fused pass, and the wide 'sub' scan."""
    from ilqr_tpu_torch.ops import fused_riccati, suffix_scan

    class StandIn:
        calls = []

        def ilqr_fused_riccati_counters(self, *a):
            return 4

        ilqr_fused_riccati_scratch = ilqr_fused_riccati_counters
        ilqr_suffix_scan_counters = ilqr_fused_riccati_counters
        ilqr_suffix_scan_scratch = ilqr_fused_riccati_counters

        def ilqr_fused_riccati(self, n_x, n_u, N, *args):
            self.calls.append(("B1", n_x, n_u, N))
            return 0

        def ilqr_suffix_scan(self, lane, n, M, *args):
            self.calls.append(("B6", lane, n, M))
            return 0

    lib = StandIn()
    for n_x in range(1, 17):
        for n_u in range(1, 7):
            e = expansion_from_numpy(_expansion(3, n_x, n_u, 0), device="cpu")
            fused_riccati._check(e)
            fused_riccati.launch(lib, e, 0.0, 0)
    assert len(lib.calls) == 16 * 6
    el = RiccatiElement(*(torch.zeros(s) for s in
                          ((5, 12, 12), (5, 12), (5, 12, 12), (5, 12),
                           (5, 12, 12))))
    suffix_scan.launch(lib, el, "sub", 0)
    assert lib.calls[-1] == ("B6", 0, 12, 5)


def test_wide_lane_layout_refuses_with_its_roadmap_item():
    """The 'lane' layout's ROADMAP item (B7w) is done: off the CPU, at n
    outside {2, 4} it no longer raises NotImplementedError but goes on to
    the device check as 'sub' does (a tensor on the meta device stands in
    for a GPU one), for every n <= 16."""
    for n in (1, 3, 5, 6, 12, 16):
        el = RiccatiElement(*(torch.zeros(s, device="meta") for s in
                              ((5, n, n), (5, n), (5, n, n), (5, n),
                               (5, n, n))))
        for layout in ("lane", "sub"):
            with pytest.raises(ValueError, match="device"):
                itt.suffix_scan_fused(el, layout)
