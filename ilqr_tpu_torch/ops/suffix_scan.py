"""Standalone Riccati suffix scan: hand-written CUDA kernels B6 and B7.

PyTorch counterpart of `ilqr_tpu/ops/pallas_riccati.py::suffix_scan_pallas`
(kernels `_suffix_kernel_sub`, layout 'sub', and `_suffix_kernel`, layout
'lane') and of `backward_pass_pallas`, the backward pass built on it.  The
kernel, `csrc/suffix_scan.cu`, returns every suffix product
e_k ⊗ … ⊗ e_{M−1} of prebuilt Riccati elements, all five fields, in one
launch (tiles scanned in shared memory, the suffix of the later tiles
carried by decoupled look-back); its note says how the TPU design was
rethought for a GPU.  Its counters and scratch come from `_build.scratch`
(once per device, stream and shape); per call the wrapper allocates only
the outputs.  The limited (`ops/limited_parallel.py`) and DDP/iLQG
(`parallel_riccati.backward_pass_ddp_parallel`) parallel passes scan their
elements through it, and so does the solver's ``backward='pallas'`` when
n_u > 6.

Over a batch (fields (B, M, …)) `suffix_scan_fused` makes one launch of
the kernel's batched entry for all B sequences (JAX's ``jax.vmap`` of
`suffix_scan_pallas`), each instance's outputs those of a single-instance
call on it bit for bit; the batched limited and DDP/iLQG passes of
`solver.solve_batch` scan through it.  Its plain version is
`parallel_riccati.suffix_scan` along the time axis 1.

Dispatch follows the tensor: on the CPU `suffix_scan_fused` runs its plain
version, `parallel_riccati.suffix_scan`; on a CUDA tensor it launches the
kernel or raises.  As in JAX, n_x > 16 runs the plain scan on every device.
On CUDA both layouts take every n_x ≤ 16, as JAX's kernels do: the
register form (an element a thread) at n_x in `NX`, the wide form (an
element a warp in blocks of 16 warps, `csrc/group_linalg.cuh`; B7w
launches B6w's kernel) at the rest.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.parallel_riccati import (
    RiccatiElement,
    gains_from_value,
    make_elements,
    suffix_scan,
    value_trace,
)
from ilqr_tpu_torch.ops.riccati import all_finite

# Launch-counter name of each layout's kernel, and of the batched entry.
KERNEL = {"sub": "suffix_scan", "lane": "suffix_scan_lane"}
KERNEL_BATCHED = "suffix_scan_batched"
NX = (2, 4)


def tile_steps(lib, layout: str, n_x: int) -> int:
    """Elements per tile of a layout's kernel at n_x."""
    return lib.ilqr_suffix_tile_steps(int(layout == "lane"), n_x)


def _check(elems: RiccatiElement) -> None:
    """Refuse what the kernel does not take: fields (M, …) or, over a
    batch, (B, M, …) with B, M >= 1, float32, on one device, contiguous."""
    lead = tuple(elems.A.shape[:-2])
    n_x = elems.A.shape[-1]
    if len(lead) not in (1, 2):
        raise ValueError(f"A has shape {tuple(elems.A.shape)}, expected "
                         f"(M, n_x, n_x) or (B, M, n_x, n_x)")
    if min(lead) < 1:
        raise ValueError("the CUDA suffix scan needs at least one element "
                         "and one instance")
    for name, t in zip(RiccatiElement._fields, elems):
        want = lead + ((n_x,) if name in ("b", "eta") else (n_x, n_x))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA suffix scan takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != elems.A.device:
            raise ValueError(f"{name} is on {t.device}, A on {elems.A.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(lib, elems: RiccatiElement, layout: str,
           stream) -> RiccatiElement:
    """Allocate the outputs and run the kernel on ``stream``: one launch.

    Takes the library handle so that any build of the sources can be run;
    inputs must already have passed `_check`.
    """
    M, n_x = elems.A.shape[0], elems.A.shape[-1]
    lane = int(layout == "lane")
    counters, scratch = _build.scratch(lib, "suffix_scan", elems.A.device,
                                       stream, lane, n_x, M)
    out = RiccatiElement(*(torch.empty_like(t) for t in elems))
    code = lib.ilqr_suffix_scan(
        lane, n_x, M, *(t.data_ptr() for t in elems), counters.data_ptr(),
        scratch.data_ptr(), *(t.data_ptr() for t in out), stream)
    _build.check(lib, code, "suffix scan kernel")
    return out


def launch_batched(lib, elems: RiccatiElement, stream) -> RiccatiElement:
    """The batched entry on (B, M, …) fields: one launch for every
    instance ('sub' tiles).  Takes the library handle as `launch` does;
    inputs must already have passed `_check`."""
    B, M, n_x = elems.A.shape[0], elems.A.shape[1], elems.A.shape[-1]
    counters, scratch = _build.scratch(lib, KERNEL_BATCHED, elems.A.device,
                                       stream, n_x, B, M)
    out = RiccatiElement(*(torch.empty_like(t) for t in elems))
    code = lib.ilqr_suffix_scan_batched(
        n_x, B, M, *(t.data_ptr() for t in elems), counters.data_ptr(),
        scratch.data_ptr(), *(t.data_ptr() for t in out), stream)
    _build.check(lib, code, "batched suffix scan kernel")
    return out


def suffix_scan_fused(elems: RiccatiElement,
                      layout: str = "sub") -> RiccatiElement:
    """suffix[k] = e_k ⊗ … ⊗ e_{M−1} for all k, every field: the contract
    of `parallel_riccati.suffix_scan`.  ``layout`` picks the kernel: 'sub'
    (B6) or 'lane' (B7); both compute the same function.  Fields of shape
    (B, M, …) scan B independent sequences along axis 1, on CUDA in one
    launch of B6's batched entry (layout 'sub' only)."""
    if layout not in KERNEL:
        raise ValueError(f"layout must be 'sub' or 'lane', got {layout!r}")
    batched = elems.A.ndim == 4
    if batched and layout != "sub":
        raise ValueError("the batched suffix scan runs layout 'sub' (B6)")
    n_x = elems.A.shape[-1]
    device = elems.A.device
    if n_x > 16 or device.type == "cpu":
        return suffix_scan(elems, axis=int(batched))
    if device.type != "cuda":
        raise ValueError(f"no suffix scan kernel for device {device}")
    _check(elems)
    with _build.on_device(device):
        lib = _build.load().lib
        stream = _build.current_stream(device)
        out = (launch_batched(lib, elems, stream) if batched
               else launch(lib, elems, layout, stream))
    _build.count_launch(KERNEL_BATCHED if batched else KERNEL[layout])
    return out


@full_f32_matmuls()
def backward_pass_suffix_scan(
    exp: TrajectoryExpansion, reg: float = 0.0, layout: str = "sub",
    defects=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward pass through the standalone suffix scan (JAX's
    `backward_pass_pallas`): elements, `suffix_scan_fused`, then the gains
    from V(k+1), ``defects`` included.  The contract of
    `riccati.backward_pass`."""
    V_x, V_xx = value_trace(suffix_scan_fused(
        make_elements(exp, reg, defects=defects), layout))
    if defects is not None:
        V_x = V_x + (V_xx @ defects[..., None])[..., 0]
    u_ff, K, dVs = gains_from_value(exp, V_x, V_xx, reg)
    # Contiguous, as the CUDA rollout kernels read the gains as they are.
    u_ff, K = u_ff.contiguous(), K.contiguous()
    return u_ff, K, dVs.sum(0), all_finite(u_ff, K)
