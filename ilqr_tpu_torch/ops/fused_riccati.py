"""Fused backward pass: one hand-written CUDA pipeline from expansion to gains.

PyTorch counterpart of the fused path of `ilqr_tpu/ops/pallas_riccati.py`
(`backward_pass_pallas_fused`, kernel `_fused_kernel`).  The kernel,
`csrc/fused_riccati.cu`, builds the Riccati elements, runs the blocked
suffix scan, closes it across blocks and forms the gains and dV; its note
says how the TPU design was rethought for a GPU.  With GNMS ``defects``
(multiple shooting, `ilqr_tpu_torch.shooting`) the kernel adds d_k to each
stage element's offset b and V_xx(k+1)·d_k to V_x(k+1) in the gains, as the
TPU kernel's ``with_defects`` variant does.

Dispatch follows the tensor: on the CPU `backward_pass_fused` runs its
plain version, `parallel_riccati.backward_pass_associative` (the same
function, defects included); on a CUDA tensor it launches the kernel or
raises.  As in JAX, n_x > 16 or n_u > 6 go to `backward_pass_associative`
on every device.  The kernel is instantiated for (n_x, n_u) in `SHAPES`,
the slice's three models; other shapes raise on CUDA (ROADMAP item B1w).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.parallel_riccati import backward_pass_associative

KERNEL = "fused_riccati"
SHAPES = ((2, 1), (4, 1), (4, 2))
_FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")


def block_steps(lib) -> int:
    """Steps per scan block of the kernel (its cross-block carry period)."""
    return lib.ilqr_riccati_block_steps()


def _check(exp: TrajectoryExpansion, defects=None) -> None:
    N, n_x = exp.f_x.shape[0], exp.f_x.shape[-1]
    n_u = exp.l_u.shape[-1]
    if N < 1:
        raise ValueError("the CUDA backward pass needs a horizon N >= 1")
    shapes = dict(f_x=(N, n_x, n_x), f_u=(N, n_x, n_u), l_x=(N, n_x),
                  l_u=(N, n_u), l_xx=(N, n_x, n_x), l_ux=(N, n_u, n_x),
                  l_uu=(N, n_u, n_u), v_x=(n_x,), v_xx=(n_x, n_x),
                  defects=(N, n_x))
    tensors = {name: getattr(exp, name) for name in _FIELDS}
    if defects is not None:
        tensors["defects"] = defects
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA backward pass takes float32, "
                            f"{name} is {t.dtype}")
        if t.device != exp.f_x.device:
            raise ValueError(f"{name} is on {t.device}, f_x on {exp.f_x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(lib, exp: TrajectoryExpansion, reg: float, stream, defects=None):
    """Allocate outputs and scratch and run the kernel on ``stream``.

    Takes the library handle so that any build of the sources can be run;
    inputs must already have passed `_check`.  ``defects=None`` passes a
    null pointer: the plain backward pass.
    """
    N, n_x = exp.f_x.shape[0], exp.f_x.shape[-1]
    n_u = exp.l_u.shape[-1]
    F = 3 * n_x * n_x + 2 * n_x
    n_blocks = -(-(N + 1) // block_steps(lib))
    gain_blocks = -(-N // lib.ilqr_riccati_gain_threads())
    opts = dict(dtype=torch.float32, device=exp.f_x.device)
    local = torch.empty((N + 1, F), **opts)
    edge = torch.empty((n_blocks, n_x + n_x * n_x), **opts)
    u_ff = torch.empty((N, n_u), **opts)
    K = torch.empty((N, n_u, n_x), **opts)
    partials = torch.empty((gain_blocks, 3), **opts)
    code = lib.ilqr_fused_riccati(
        n_x, n_u, N, reg, *(getattr(exp, f).data_ptr() for f in _FIELDS),
        None if defects is None else defects.data_ptr(), local.data_ptr(),
        edge.data_ptr(), u_ff.data_ptr(), K.data_ptr(), partials.data_ptr(),
        stream)
    _build.check(lib, code, "fused Riccati kernel")
    sums = partials.sum(0)
    return u_ff, K, sums[:2], sums[2] == 0


@full_f32_matmuls()
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
    if (n_x, n_u) not in SHAPES:
        raise NotImplementedError(
            f"the CUDA backward pass is instantiated for (n_x, n_u) in "
            f"{SHAPES}, got {(n_x, n_u)}: ROADMAP item B1w")
    _check(exp, defects)
    with torch.cuda.device(device):
        lib = _build.load().lib
        out = launch(lib, exp, float(reg),
                     torch.cuda.current_stream(device).cuda_stream, defects)
    _build.count_launch(KERNEL)
    return out
