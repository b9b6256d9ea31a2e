"""Fused backward pass: one hand-written CUDA kernel from expansion to gains.

PyTorch counterpart of the fused path of `ilqr_tpu/ops/pallas_riccati.py`
(`backward_pass_pallas_fused`, kernel `_fused_kernel`).  The kernel,
`csrc/fused_riccati.cu`, builds the Riccati elements, scans them in tiles,
carries the cost-to-go across tiles by decoupled look-back and forms the
gains, dV and the all-finite flag, in one launch; its note says how the TPU
design was rethought for a GPU.  With GNMS ``defects`` (multiple shooting,
`ilqr_tpu_torch.shooting`) the kernel adds d_k to each stage element's
offset b and V_xx(k+1)·d_k to V_x(k+1) in the gains, as the TPU kernel's
``with_defects`` variant does.

Dispatch follows the tensor: on the CPU `backward_pass_fused` runs its
plain version, `parallel_riccati.backward_pass_associative` (the same
function, defects included); on a CUDA tensor it launches the kernel or
raises.  As in JAX, n_x > 16 or n_u > 6 go to `backward_pass_associative`
on every device.  The kernel takes every n_x ≤ 16, n_u ≤ 6 on CUDA: in
its register form (an element a thread) at the (n_x, n_u) of `SHAPES`,
in its wide form (an element a warp, zero-padded to 8 x 8 or 16 x 16 on
`csrc/group_linalg.cuh`, 16-step tiles, B1w) at the rest.

The kernel's scratch (tile status words, aggregates, carried values and
partial sums) comes from `_build.scratch`, allocated once per device,
stream and shape and reused: the kernel leaves its counters zeroed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.parallel_riccati import backward_pass_associative

KERNEL = "fused_riccati"
SHAPES = ((2, 1), (4, 1), (4, 2))
# The wide form's horizons are N < WIDE_MAX_N (`kWideMaxN` in
# csrc/fused_riccati.cu, int offsets inside its gains; the library's
# `ilqr_riccati_wide_max_n`, which chip_smoke.py holds to this).
WIDE_MAX_N = 1 << 23
_FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")


def tile_steps(lib, n_x: int, n_u: int) -> int:
    """Steps per tile of the kernel at (n_x, n_u) (its cross-tile carry
    period): the register form's at `SHAPES`, else the wide form's."""
    return lib.ilqr_riccati_tile_steps(n_x, n_u)


def _check(exp: TrajectoryExpansion, defects=None) -> None:
    """Raise on what the kernel does not take: the (N, n_x, n_u) shapes
    of every field, float32, contiguous, all on f_x's device.  The common
    case passes in a few aggregate tests; a failure names its field."""
    f_x = exp.f_x
    N, n_x = f_x.shape[0], f_x.shape[-1]
    n_u = exp.l_u.shape[-1]
    if N < 1:
        raise ValueError("the CUDA backward pass needs a horizon N >= 1")
    if (n_x, n_u) not in SHAPES and N >= WIDE_MAX_N:
        # The kernel would answer with a bare launch error.
        raise NotImplementedError(
            f"the wide CUDA backward pass (B1w, (n_x, n_u) = {(n_x, n_u)}) "
            f"takes horizons N < 2^23, got N = {N}: ROADMAP item B1x")
    tensors = (f_x, exp.f_u, exp.l_x, exp.l_u, exp.l_xx, exp.l_ux, exp.l_uu,
               exp.v_x, exp.v_xx)
    shapes = [(N, n_x, n_x), (N, n_x, n_u), (N, n_x), (N, n_u),
              (N, n_x, n_x), (N, n_u, n_x), (N, n_u, n_u), (n_x,),
              (n_x, n_x)]
    if defects is not None:
        tensors += (defects,)
        shapes.append((N, n_x))
    device = f_x.device
    if ([t.shape for t in tensors] == shapes
            and all(t.dtype is torch.float32 and t.is_contiguous()
                    and t.device == device for t in tensors)):
        return
    for name, t, shape in zip(_FIELDS + ("defects",), tensors, shapes):
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA backward pass takes float32, "
                            f"{name} is {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, f_x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(lib, exp: TrajectoryExpansion, reg: float, stream, defects=None):
    """Allocate the outputs and run the kernel on ``stream``: one launch.

    Takes the library handle so that any build of the sources can be run;
    inputs must already have passed `_check`.  ``defects=None`` passes a
    null pointer: the plain backward pass.
    """
    f_x = exp.f_x
    N, n_x = f_x.shape[0], f_x.shape[-1]
    n_u = exp.l_u.shape[-1]
    device = f_x.device
    counters, scratch = _build.scratch(lib, KERNEL, device, stream, n_x, N)
    u_ff = torch.empty((N, n_u), dtype=torch.float32, device=device)
    K = torch.empty((N, n_u, n_x), dtype=torch.float32, device=device)
    dV = torch.empty((2,), dtype=torch.float32, device=device)
    ok = torch.empty((), dtype=torch.bool, device=device)
    code = lib.ilqr_fused_riccati(
        n_x, n_u, N, reg, f_x.data_ptr(), exp.f_u.data_ptr(),
        exp.l_x.data_ptr(), exp.l_u.data_ptr(), exp.l_xx.data_ptr(),
        exp.l_ux.data_ptr(), exp.l_uu.data_ptr(), exp.v_x.data_ptr(),
        exp.v_xx.data_ptr(), None if defects is None else defects.data_ptr(),
        counters.data_ptr(), scratch.data_ptr(), u_ff.data_ptr(),
        K.data_ptr(), dV.data_ptr(), ok.data_ptr(), stream)
    _build.check(lib, code, "fused Riccati kernel")
    return u_ff, K, dV, ok


def backward_pass_fused(
    exp: TrajectoryExpansion, reg: float = 0.0, defects=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused backward pass; the contract of `riccati.backward_pass`:
    returns (u_ff (N, n_u), K (N, n_u, n_x), dV (2,), ok).  ``defects``
    ((N, n_x) multiple-shooting gaps) gives the GNMS variant."""
    n_x, n_u = exp.f_x.shape[-1], exp.l_u.shape[-1]
    device = exp.f_x.device
    if n_x > 16 or n_u > 6 or device.type == "cpu":
        return backward_pass_associative(exp, reg, defects=defects)
    if device.type != "cuda":
        raise ValueError(f"no backward pass kernel for device {device}")
    _check(exp, defects)
    with _build.on_device(device):
        out = launch(_build.load().lib, exp, float(reg),
                     _build.current_stream(device), defects)
    _build.count_launch(KERNEL)
    return out
