"""Box-constrained QP for control-limited iLQR (projected Newton).

PyTorch counterpart of `ilqr_tpu/ops/boxqp.py` (Tassa, Mansard & Todorov,
ICRA 2014).  At each step of the control-limited backward pass solve

    min_d  ½ d'H d + g'd     s.t.  lo ≤ d ≤ hi

by a fixed number of projected-Newton iterations (`models.base.lin_solve`
for the small systems, JAX's `solve_small`).  The free subsystem is
solved full-size with the clamped rows and columns masked to identity, and
the feedback rows of clamped controls are zero.  Leading axes of every
argument batch independent problems.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls, lin_solve

# Projected-Newton iterations (JAX's DEFAULT_ITERS).
DEFAULT_ITERS = 8
# A component within this of its bound, with the gradient pushing outward,
# counts as clamped.
_ACTIVE_TOL = 1e-9


def _free(d, g, H, lo, hi) -> Tuple[torch.Tensor, torch.Tensor]:
    """(free, grad) at d: the float mask of unclamped components (1.0 =
    free) and the gradient g + H d."""
    grad = g + (H @ d[..., None])[..., 0]
    at_lo = (d <= lo + _ACTIVE_TOL) & (grad > 0)
    at_hi = (d >= hi - _ACTIVE_TOL) & (grad < 0)
    return (~(at_lo | at_hi)).to(g.dtype), grad


def _masked(H, free) -> torch.Tensor:
    """H with the clamped rows and columns replaced by the identity's."""
    return (H * free[..., :, None] * free[..., None, :]
            + torch.diag_embed(1.0 - free))


@full_f32_matmuls()
def boxqp(H, g, lo, hi, iters: int = DEFAULT_ITERS
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize ½d'Hd + g'd subject to lo ≤ d ≤ hi (H SPD, small).

    H (..., n, n), g (..., n); lo and hi broadcast against g.  Returns
    (d, free), ``free`` the float mask (1.0 on unclamped components) of the
    feedback subspace.
    """
    lo = torch.as_tensor(lo, dtype=g.dtype, device=g.device).expand_as(g)
    hi = torch.as_tensor(hi, dtype=g.dtype, device=g.device).expand_as(g)
    d = torch.clamp(torch.zeros_like(g), lo, hi)
    for _ in range(iters):
        free, grad = _free(d, g, H, lo, hi)
        step = lin_solve(_masked(H, free), -grad * free)
        d = torch.clamp(d + step * free, lo, hi)
    # Final activity for the feedback mask (gains live on the free subspace).
    return d, _free(d, g, H, lo, hi)[0]


def boxqp_with_gains(H, g, lo, hi, rhs, iters: int = DEFAULT_ITERS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxqp plus the free-subspace solve K = −H_ff⁻¹ rhs_f (clamped rows 0).

    ``rhs`` is (..., n, n_x) (Q_ux); returns (d, free, K).
    """
    d, free = boxqp(H, g, lo, hi, iters)
    K = lin_solve(_masked(H, free), -(rhs * free[..., :, None]))
    return d, free, K
