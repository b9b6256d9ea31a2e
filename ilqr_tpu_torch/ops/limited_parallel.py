"""Control-limited backward pass with O(log N) depth per sweep.

PyTorch counterpart of `ilqr_tpu/ops/limited_parallel.py`.  The sequential
control-limited pass (`ops.riccati.backward_pass_limited`) solves a box QP
at every step of a reverse recursion.  Here the active set is frozen
instead:

    repeat up to ``sweeps`` times:
      1. freeze the clamped controls at their bounds: δu = δc + F δv (δc
         the clamp deltas, F the free mask) makes the stage problem
         unconstrained in δv with a dynamics drift d = B δc, the
         multiple-shooting defect form of `parallel_riccati.make_elements`;
      2. one suffix scan of the masked elements gives V(k+1) for every k
         (`ops/suffix_scan.suffix_scan_fused`, kernel B6 on CUDA tensors,
         under engine 'pallas'; the plain scan under 'xla');
      3. gains and feedforward of the free components, parallel over time;
      4. the projected-Newton set update from the full problem's
         Q-expansion at the same V: clamp where the clipped step sits at a
         bound with the gradient pushing outward, release otherwise.

At a fixed point the result meets the sequential pass's KKT conditions.
JAX's ``while_loop`` is a host loop here, with one host read per sweep
(does any instance still sweep?).  ``hess`` (DDP) and ``noise`` (iLQG)
fold into the stage expansion at the carried value trace, as in
`parallel_riccati.backward_pass_ddp_parallel`, with twice the sweep budget
and two extra sweeps after the set settles.

B instances at once (every field leading with B, ``reg`` a number or
(B,)) stop as ``jax.vmap`` of JAX's loop stops them: each instance's
carries freeze once its own set has settled, while the others sweep on;
every sweep scans all B instances in one call (one launch of B6's batched
entry under 'pallas').  Sweeping a settled second-order instance further
would change its values (the folded terms lag the trace by a sweep).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.parallel_riccati import (
    finite_gains,
    fold_second_order,
    gains_from_value,
    make_elements,
    reg_eye,
    suffix_scan,
    value_trace,
)
from ilqr_tpu_torch.ops.suffix_scan import suffix_scan_fused

# "At the bound" tolerance of the set update, relative to the width of the
# delta box.
_BOUND_EPS = 1e-6


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def masked_expansion(exp: TrajectoryExpansion, du_c: torch.Tensor,
                     free: torch.Tensor
                     ) -> Tuple[TrajectoryExpansion, torch.Tensor]:
    """Stage data of the δ-LQ problem with the clamped components frozen.

    du_c (N, n_u): frozen clamp deltas (zero on free components); free
    (N, n_u): 1.0 free, 0.0 clamped.  With δu = δc + F δv:

        d    = B δc                        (drift, the element offset b)
        l_x̃  = l_x + l_uxᵀ δc
        l_ũ  = F ⊙ (l_u + l_uu δc)
        f_ũ  = B diag(F),  l_ũx = diag(F) l_ux
        l_ũu = diag(F) l_uu diag(F) + diag(1 − F)

    Constant terms drop.  Returns (masked expansion, d (N, n_x)).
    """
    d = _mv(exp.f_u, du_c)
    l_x = exp.l_x + _mv(exp.l_ux.transpose(-1, -2), du_c)
    l_u = free * (exp.l_u + _mv(exp.l_uu, du_c))
    n_u = exp.l_u.shape[-1]
    eye_u = torch.eye(n_u, dtype=exp.l_u.dtype, device=exp.l_u.device)
    clamped = 1.0 - free
    l_uu = (free[..., :, None] * exp.l_uu * free[..., None, :]
            + clamped[..., :, None] * clamped[..., None, :] * eye_u)
    return dataclasses.replace(
        exp, f_u=exp.f_u * free[..., None, :], l_x=l_x, l_u=l_u,
        l_ux=exp.l_ux * free[..., None], l_uu=l_uu), d


def _suffix_values(exp_m, reg, defects, engine: str):
    """V_x, V_xx at k+1 for every k (defect-shifted) from one suffix scan
    (of every instance, when the fields lead with B)."""
    elems = make_elements(exp_m, reg, defects=defects)
    suffix = (suffix_scan_fused(elems) if engine == "pallas"
              else suffix_scan(elems, axis=defects.ndim - 2))
    V_x, V_xx = value_trace(suffix)
    return V_x + _mv(V_xx, defects), V_xx


@full_f32_matmuls()
def backward_pass_limited_parallel(
    exp: TrajectoryExpansion, U_old: torch.Tensor, u_lo, u_hi,
    reg: float = 0.0, sweeps: int = 12, engine: str = "auto", hess=None,
    noise=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contract of `ops.riccati.backward_pass_limited` with
    O(sweeps · log N) depth: (u_ff, K, dV, ok), the feedback rows of
    clamped controls zero, u_lo/u_hi broadcast against (n_u,).

    ``sweeps`` caps the active-set iteration, which stops as soon as the
    set no longer changes (with ``hess``/``noise``: once the value trace
    has been refreshed twice more under the settled set).  ``engine``
    'pallas' scans through `suffix_scan_fused` (kernel B6 on CUDA tensors),
    'xla' and 'auto' through the plain `suffix_scan` ('auto' has no CUDA
    rule yet).  With U_old (B, N, n_u) and every field of ``exp`` (and of
    ``hess`` and ``noise``) leading with B, it solves B instances, each
    stopping on its own; ``reg`` is then a number or (B,), dV (B, 2) and
    ok (B,).
    """
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"engine must be 'auto'|'pallas'|'xla', got "
                         f"{engine!r}")
    if engine == "auto":
        engine = "xla"
    lead, (N, n_u) = tuple(U_old.shape[:-2]), U_old.shape[-2:]
    n_x = exp.v_x.shape[-1]
    dtype, device = exp.l_u.dtype, exp.l_u.device
    opts = dict(dtype=dtype, device=device)
    lo_d = torch.as_tensor(u_lo, **opts).expand(U_old.shape) - U_old
    hi_d = torch.as_tensor(u_hi, **opts).expand(U_old.shape) - U_old
    eps = _BOUND_EPS * (1.0 + (hi_d - lo_d).abs())
    reg_u = reg_eye(reg, n_u, exp.l_u)
    second_order = hess is not None or noise is not None
    # The folded terms lag the trace by a sweep: two more refreshes after
    # the set settles, and twice the budget to split between the two.
    settle = 2 if second_order else 0
    if second_order:
        sweeps = 2 * sweeps

    def one_sweep(free, du_c, V_x, V_xx):
        e = fold_second_order(exp, V_x, V_xx, hess, noise)
        exp_m, d = masked_expansion(e, du_c, free)
        V_x, V_xx = _suffix_values(exp_m, reg, d, engine)
        u_ff_f, K, dVs = gains_from_value(exp_m, V_x, V_xx, reg)
        u_ff = torch.clamp(du_c + u_ff_f, lo_d, hi_d)
        # Set update from the full (folded) problem at the same V.
        fuT = e.f_u.transpose(-1, -2)
        Q_u = e.l_u + _mv(fuT, V_x)
        Q_uu = e.l_uu + fuT @ V_xx @ e.f_u + reg_u
        g = Q_u + _mv(Q_uu, u_ff)
        clamp_lo = (u_ff <= lo_d + eps) & (g > 0)
        clamp_hi = (u_ff >= hi_d - eps) & (g < 0)
        free_new = 1.0 - (clamp_lo | clamp_hi).to(dtype)
        du_c_new = (torch.where(clamp_lo, lo_d, 0.0)
                    + torch.where(clamp_hi, hi_d, 0.0))
        return u_ff, K, dVs.sum(-2), free_new, du_c_new, V_x, V_xx

    free = torch.ones(lead + (N, n_u), **opts)
    du_c = torch.zeros(lead + (N, n_u), **opts)
    V_x = torch.zeros(lead + (N, n_x), **opts)
    V_xx = torch.zeros(lead + (N, n_x, n_x), **opts)
    if second_order:
        # Seed the trace with the Gauss-Newton unconstrained values.
        V_x, V_xx = _suffix_values(exp, reg, torch.zeros(lead + (N, n_x),
                                                         **opts), engine)
    u_ff = torch.zeros(lead + (N, n_u), **opts)
    K = torch.zeros(lead + (N, n_u, n_x), **opts)
    dV = torch.zeros(lead + (2,), **opts)
    carry = (u_ff, K, dV, free, du_c, V_x, V_xx)
    stable = torch.zeros(lead, dtype=torch.int64, device=device)
    for k in range(sweeps):
        # An instance sweeps while its set has not settled (JAX's loop
        # condition, per instance under vmap); the sweep's one host read is
        # whether any instance still does.
        sweeping = stable < 1 + settle
        if k > 0 and not bool(sweeping.any()):
            break
        new = one_sweep(*carry[3:])
        changed = (new[3] != carry[3]).flatten(-2).any(-1)
        stable = torch.where(sweeping, torch.where(changed, 0, stable + 1),
                             stable)
        if lead:
            # Settled instances keep their carries.
            carry = tuple(torch.where(
                sweeping.reshape(lead + (1,) * (n.ndim - len(lead))), n, c)
                for n, c in zip(new, carry))
        else:
            carry = new
    u_ff, K, dV = carry[:3]
    # Contiguous, as the CUDA rollout kernels read the gains as they are.
    u_ff, K = u_ff.contiguous(), K.contiguous()
    return u_ff, K, dV, finite_gains(u_ff, K)
