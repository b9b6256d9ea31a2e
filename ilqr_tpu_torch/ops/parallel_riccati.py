"""Parallel Riccati backward pass by an associative suffix scan.

PyTorch counterpart of `ilqr_tpu/ops/parallel_riccati.py`.  Each step k of
the δ-LQ subproblem is the element e = (A̅, b, C, η, J) of the conditional
value function

    V(x, z) = ½ x'J x − η'x + ½ (z − A̅x − b)' C⁻¹ (z − A̅x − b),

    A̅ = A − B R⁻¹ M        b = −B R⁻¹ r        C = B R⁻¹ B'
    J = Q − M' R⁻¹ M        η = −(q − M' R⁻¹ r)

with the terminal element (0, 0, 0, −l_f_x, l_f_xx).  Multiple-shooting
gaps d_k (GNMS, `ilqr_tpu_torch.shooting`) make the step affine,
δx⁺ = A δx + B δu + d_k, which adds d_k to b; the gains then read
V_x(k+1) + V_xx(k+1)·d_k.  The combine of an earlier element e_i with a
later e_j (L = I + C_i J_j)

    A̅ = A̅_j L⁻¹ A̅_i                 b = A̅_j L⁻¹ (b_i + C_i η_j) + b_j
    C = A̅_j L⁻¹ C_i A̅_j' + C_j      η = A̅_i' L⁻ᵀ (η_j − J_j b_i) + η_i
    J = A̅_i' L⁻ᵀ J_j A̅_i + J_i

is associative (not commutative), so the suffix products e_k ⊗ … ⊗ e_N —
whose (J, η) are V_xx(k) and −V_x(k) — come from ⌈log₂(N+1)⌉ sweeps of
recursive doubling.  This module is the plain version of the fused CUDA
backward pass (`ilqr_tpu_torch.ops.fused_riccati`) and the engine of
``backward='pscan'``.

`make_elements`, `gains_from_value`, `fold_second_order` and
`backward_pass_ddp_parallel` also take B instances at once: every field
of the expansion (and of the Hessians and noise terms) then leads with B,
time is the axis after it, ``reg`` may be a (B,) tensor, and ``ok`` is
(B,).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls, lin_inv, lin_solve
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.riccati import _noise_q_terms, all_finite


class RiccatiElement(NamedTuple):
    A: torch.Tensor    # (..., n_x, n_x)
    b: torch.Tensor    # (..., n_x)
    C: torch.Tensor    # (..., n_x, n_x)
    eta: torch.Tensor  # (..., n_x)
    J: torch.Tensor    # (..., n_x, n_x)


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def reg_eye(reg, n: int, like: torch.Tensor) -> torch.Tensor:
    """reg·I (n × n) to add to (..., N, n, n) stage matrices: ``reg`` a
    number, a 0-d tensor or one per instance, (B,)."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    if isinstance(reg, torch.Tensor) and reg.ndim:
        return reg[..., None, None, None] * eye
    return reg * eye


# The time axis of each element field, counted from the end.
_TIME_AXIS = RiccatiElement(-3, -2, -3, -2, -3)


def make_elements(exp: TrajectoryExpansion, reg, defects=None) -> RiccatiElement:
    """The N+1 stacked scan elements (N stage leaves + terminal);
    ``defects`` (N, n_x) enter the leaves' affine offsets, b ← b + d.
    Leading axes of the fields batch instances."""
    n_u = exp.l_u.shape[-1]
    n_x = exp.v_x.shape[-1]
    R = exp.l_uu + reg_eye(reg, n_u, exp.l_u)
    # One factorization for all three R-solves.
    rhs = torch.cat([exp.l_ux, exp.f_u.transpose(-1, -2), exp.l_u[..., None]],
                    dim=-1)
    sol = lin_solve(R, rhs)
    Rinv_M, Rinv_Bt, Rinv_r = sol[..., :n_x], sol[..., n_x:-1], sol[..., -1]
    MT = exp.l_ux.transpose(-1, -2)
    b = -_mv(exp.f_u, Rinv_r)
    leaves = RiccatiElement(
        A=exp.f_x - exp.f_u @ Rinv_M,
        b=b if defects is None else b + defects,
        C=_sym(exp.f_u @ Rinv_Bt),
        eta=-(exp.l_x - _mv(MT, Rinv_r)),
        J=_sym(exp.l_xx - MT @ Rinv_M),
    )
    lead = tuple(exp.v_x.shape[:-1])
    opts = dict(dtype=exp.v_x.dtype, device=exp.v_x.device)
    zero_m = torch.zeros(lead + (1, n_x, n_x), **opts)
    zero_v = torch.zeros(lead + (1, n_x), **opts)
    term = RiccatiElement(zero_m, zero_v, zero_m, -exp.v_x[..., None, :],
                          exp.v_xx[..., None, :, :])
    return RiccatiElement(*(torch.cat([a, t], dim=ax) for a, t, ax in
                            zip(leaves, term, _TIME_AXIS)))


def combine(ei: RiccatiElement, ej: RiccatiElement) -> RiccatiElement:
    """Associative combine of an earlier element ``ei`` with a later ``ej``,
    batched over leading axes."""
    n_x = ei.A.shape[-1]
    eye = torch.eye(n_x, dtype=ei.A.dtype, device=ei.A.device)
    Li = lin_inv(eye + ei.C @ ej.J)
    Lti = Li.transpose(-1, -2)
    AiT = ei.A.transpose(-1, -2)
    AjT = ej.A.transpose(-1, -2)
    return RiccatiElement(
        A=ej.A @ (Li @ ei.A),
        b=_mv(ej.A, _mv(Li, ei.b + _mv(ei.C, ej.eta))) + ej.b,
        C=_sym(ej.A @ (Li @ ei.C) @ AjT + ej.C),
        eta=_mv(AiT, _mv(Lti, ej.eta - _mv(ej.J, ei.b))) + ei.eta,
        J=_sym(AiT @ (Lti @ ej.J) @ ei.A + ei.J),
    )


def suffix_scan(elems, op=combine, axis: int = 0):
    """suffix[k] = e_k ⊗ e_{k+1} ⊗ … ⊗ e_{M-1} for all k, by recursive
    doubling: at distance d, E[k] ← E[k] ⊗ E[k+d] wherever k+d exists.  The
    windows joined at each sweep are adjacent and disjoint, as the
    non-idempotent combine requires.  ``elems`` is a NamedTuple of stacked
    fields and ``op(earlier, later)`` its combine (`combine` for Riccati
    elements).  The sequence runs along ``axis`` of every field (1 for B
    sequences stacked along axis 0)."""
    kind = type(elems)
    M = elems[0].shape[axis]
    E = elems
    d = 1
    while d < M:
        head = op(kind(*(a.narrow(axis, 0, M - d) for a in E)),
                  kind(*(a.narrow(axis, d, M - d) for a in E)))
        E = kind(*(torch.cat([h, a.narrow(axis, M - d, d)], dim=axis)
                   for h, a in zip(head, E)))
        d *= 2
    return E


def prefix_scan(elems, op=combine):
    """prefix[k] = e_0 ⊗ … ⊗ e_k for all k, by recursive doubling (the
    mirror of `suffix_scan`): at distance d, E[k] ← E[k−d] ⊗ E[k] wherever
    k−d exists.  XLA's ``associative_scan`` associates the same products
    in another order, so f32 results differ from JAX's by rounding."""
    kind = type(elems)
    M = elems[0].shape[0]
    E = elems
    d = 1
    while d < M:
        tail = op(kind(*(a[:M - d] for a in E)), kind(*(a[d:] for a in E)))
        E = kind(*(torch.cat([a[:d], t]) for t, a in zip(tail, E)))
        d *= 2
    return E


def gains_from_value(exp: TrajectoryExpansion, V_x, V_xx, reg):
    """Per-step gains from the cost-to-go at k+1, parallel over time (and
    over leading instance axes)."""
    n_u = exp.l_u.shape[-1]
    fuT = exp.f_u.transpose(-1, -2)
    fuT_Vxx = fuT @ V_xx
    Q_u = exp.l_u + _mv(fuT, V_x)
    Q_ux = exp.l_ux + fuT_Vxx @ exp.f_x
    Q_uu = exp.l_uu + fuT_Vxx @ exp.f_u
    rhs = torch.cat([Q_ux, Q_u[..., None]], dim=-1)
    sol = -lin_solve(Q_uu + reg_eye(reg, n_u, exp.l_u), rhs)
    K, u_ff = sol[..., :-1], sol[..., -1]
    dV = torch.stack([(u_ff * Q_u).sum(-1),
                      0.5 * (u_ff * _mv(Q_uu, u_ff)).sum(-1)], dim=-1)
    return u_ff, K, dV


def fold_second_order(exp: TrajectoryExpansion, V_x_next, V_xx_next,
                      hess=None, noise=None) -> TrajectoryExpansion:
    """``exp`` with the second-order terms folded into its stage costs at a
    frozen value trace (V_x, V_xx at k+1, (..., N, n_x) and (..., N, n_x,
    n_x)):
    the DDP terms V_x·f_xx, V_x·f_ux, V_x·f_uu of ``hess`` (a
    `DynamicsHessians`, summed by broadcasting as JAX does) into l_xx,
    l_ux, l_uu, and the iLQG terms of ``noise`` ((C, C_x, C_u)) into all
    five.  With neither, ``exp`` itself."""
    e = exp
    if hess is not None:
        vx = V_x_next[..., None, None]
        e = dataclasses.replace(
            e, l_xx=e.l_xx + (vx * hess.f_xx).sum(-3),
            l_ux=e.l_ux + (vx * hess.f_ux).sum(-3),
            l_uu=e.l_uu + (vx * hess.f_uu).sum(-3))
    if noise is not None:
        q_x, q_u, q_xx, q_ux, q_uu = _noise_q_terms(V_xx_next, *noise)
        e = dataclasses.replace(
            e, l_x=e.l_x + q_x, l_u=e.l_u + q_u, l_xx=e.l_xx + q_xx,
            l_ux=e.l_ux + q_ux, l_uu=e.l_uu + q_uu)
    return e


@full_f32_matmuls()
def backward_pass_ddp_parallel(
    exp: TrajectoryExpansion, reg: float = 0.0, hess=None, noise=None,
    sweeps: int = 3, engine: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-DDP / iLQG backward pass in O(sweeps·log N) depth.

    The DDP terms couple each step to the downstream value gradient and the
    iLQG terms to its Hessian, so the exact recursions are sequential; for a
    frozen value trace they are stage-cost modifications and one sweep is
    again a suffix scan.  The trace starts from the Gauss-Newton scan and is
    refreshed ``sweeps`` times from the expansion folded with the last one;
    its fixed point is the sequential recursion.  The gains come from the
    expansion folded with the same trace that drives them.  ``engine``
    'pallas' scans through `suffix_scan_fused` (kernel B6 on CUDA tensors;
    over a batch its batched entry, one launch a sweep), 'xla' through the
    plain `suffix_scan`.  Fields leading with B solve B instances, ``reg``
    a number or (B,); dV is then (B, 2) and ok (B,).
    """
    if engine == "pallas":
        from ilqr_tpu_torch.ops.suffix_scan import suffix_scan_fused as scan
    elif engine == "xla":
        # Time is the axis after the instance axes, if any.
        scan = functools.partial(suffix_scan, axis=exp.v_x.ndim - 1)
    else:
        raise ValueError(f"engine must be 'pallas'|'xla', got {engine!r}")

    def traces(e):
        return value_trace(scan(make_elements(e, reg)))

    V_x, V_xx = traces(exp)
    for _ in range(sweeps):
        V_x, V_xx = traces(fold_second_order(exp, V_x, V_xx, hess, noise))
    u_ff, K, dVs = gains_from_value(
        fold_second_order(exp, V_x, V_xx, hess, noise), V_x, V_xx, reg)
    u_ff, K = u_ff.contiguous(), K.contiguous()
    return u_ff, K, dVs.sum(-2), finite_gains(u_ff, K)


def value_trace(suffix: RiccatiElement):
    """(V_x, V_xx) at k+1 for every stage k from the suffix products of
    the N+1 elements: −η and J past the first, along the time axis."""
    return -suffix.eta[..., 1:, :], suffix.J[..., 1:, :, :]


def finite_gains(u_ff, K):
    """Whether every gain is finite, per instance: u_ff (..., N, n_u), K
    (..., N, n_u, n_x); a 0-d bool tensor for one instance."""
    return (torch.isfinite(u_ff).flatten(-2).all(-1)
            & torch.isfinite(K).flatten(-3).all(-1))


@full_f32_matmuls()
def backward_pass_associative(
    exp: TrajectoryExpansion, reg: float = 0.0, defects=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop-in replacement for `ilqr_tpu_torch.ops.riccati.backward_pass`,
    ``defects`` included (the GNMS variant)."""
    # Cost-to-go at k+1 drives the gains at k.
    V_x, V_xx = value_trace(suffix_scan(make_elements(exp, reg,
                                                      defects=defects)))
    if defects is not None:
        V_x = V_x + _mv(V_xx, defects)
    u_ff, K, dVs = gains_from_value(exp, V_x, V_xx, reg)
    # Contiguous, as the CUDA rollout kernels read the gains as they are.
    u_ff, K = u_ff.contiguous(), K.contiguous()
    return u_ff, K, dVs.sum(0), all_finite(u_ff, K)
