"""Sequential Riccati backward pass over a precomputed trajectory expansion.

PyTorch counterpart of `ilqr_tpu/ops/riccati.py::backward_pass`: the same
Q-expansion and gain solves, walked backward over time in a host loop, with
the full symmetric value update, regularization on the gain solve only, the
expected-improvement terms dV and the ``ok`` flag.  The (n_u × n_u) gain
systems go to `models.base.lin_solve`.  With multiple-shooting ``defects``
(the GNMS backward pass of `ilqr_tpu_torch.shooting`) the linear Q-terms
use V_x + V_xx·d_k in place of V_x.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls, lin_solve
from ilqr_tpu_torch.ops.boxqp import boxqp_with_gains
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion


def all_finite(*tensors: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: every entry of every tensor is finite."""
    out = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        out = out & torch.isfinite(t).all()
    return out


def _noise_q_terms(V_xx, C, C_x, C_u):
    """iLQG noise contributions to the Q-expansion (Todorov & Li 2005).

    With x⁺ = f(x, u) + C(x, u)·ξ, ξ ~ N(0, I), the expected cost-to-go
    adds, over the noise columns c_i: q_u = Σ_i C_u,iᵀ V_xx c_i,
    q_uu = Σ_i C_u,iᵀ V_xx C_u,i, and so on.  Additive noise (C_x = C_u = 0)
    adds nothing.  Shapes: V_xx (..., n_x, n_x), C (..., n_x, n_w),
    C_x (..., n_x, n_w, n_x), C_u (..., n_x, n_w, n_u); leading axes batch.
    Returns (q_x, q_u, q_xx, q_ux, q_uu).
    """
    n_x, n_w = C.shape[-2:]
    n_u = C_u.shape[-1]
    lead = C.shape[:-2]
    Vc = V_xx @ C
    Wu = V_xx @ C_u.reshape(lead + (n_x, n_w * n_u))
    Wx = V_xx @ C_x.reshape(lead + (n_x, n_w * n_x))
    Cu2T = C_u.reshape(lead + (n_x * n_w, n_u)).mT
    Cx2T = C_x.reshape(lead + (n_x * n_w, n_x)).mT
    vc = Vc.reshape(lead + (n_x * n_w, 1))
    Wu2 = Wu.reshape(lead + (n_x * n_w, n_u))
    Wx2 = Wx.reshape(lead + (n_x * n_w, n_x))
    return ((Cx2T @ vc)[..., 0], (Cu2T @ vc)[..., 0], Cx2T @ Wx2,
            Cu2T @ Wx2, Cu2T @ Wu2)


def _second_order_terms(Q, V_x, V_xx, h, nz):
    """Q = (Q_x, Q_u, Q_xx, Q_ux, Q_uu) plus the DDP terms V_x·f_·· of
    ``h`` = (f_xx, f_ux, f_uu) at one step, summed by broadcasting as JAX
    does, and the iLQG terms of ``nz`` = (C, C_x, C_u); either may be
    None."""
    Q_x, Q_u, Q_xx, Q_ux, Q_uu = Q
    if h is not None:
        f_xx, f_ux, f_uu = h
        vx = V_x[:, None, None]
        Q_xx = Q_xx + (vx * f_xx).sum(0)
        Q_ux = Q_ux + (vx * f_ux).sum(0)
        Q_uu = Q_uu + (vx * f_uu).sum(0)
    if nz is not None:
        q_x, q_u, q_xx, q_ux, q_uu = _noise_q_terms(V_xx, *nz)
        Q_x, Q_u = Q_x + q_x, Q_u + q_u
        Q_xx, Q_ux, Q_uu = Q_xx + q_xx, Q_ux + q_ux, Q_uu + q_uu
    return Q_x, Q_u, Q_xx, Q_ux, Q_uu


def _step_terms(hess, noise, k):
    """Step k's (f_xx, f_ux, f_uu) and (C, C_x, C_u), or None."""
    h = None if hess is None else (hess.f_xx[k], hess.f_ux[k], hess.f_uu[k])
    nz = None if noise is None else tuple(n[k] for n in noise)
    return h, nz


@full_f32_matmuls()
def backward_pass(
    exp: TrajectoryExpansion, reg: float = 0.0, hess=None, noise=None,
    defects=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the Riccati recursion.

    ``defects`` ((N, n_x) gaps d_k = f(x_k, u_k) − x_{k+1}) make the local
    dynamics affine, δx⁺ = f_x δx + f_u δu + d_k; ``None`` (or zeros) is the
    plain recursion.  ``hess`` (a `DynamicsHessians`) adds the full-DDP
    terms V_x·f_xx, V_x·f_ux, V_x·f_uu to the Q-expansion, ``noise`` (a
    (C, C_x, C_u) triple of stacked (N, …) tensors, `ilqr_tpu_torch.ilqg`)
    the iLQG noise-covariance terms; both couple to the running value
    function, so they stay sequential here.

    Returns:
        u_ff: (N, n_u) feedforward controls
        K:    (N, n_u, n_x) feedback gains
        dV:   (2,) expected cost-decrease coefficients (linear, quadratic in α)
        ok:   0-d bool tensor — all gains finite
    """
    N, n_u = exp.l_u.shape
    eye_u = torch.eye(n_u, dtype=exp.l_u.dtype, device=exp.l_u.device)
    V_x, V_xx = exp.v_x, exp.v_xx
    u_ffs, Ks, dVs = [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        f_x, f_u = exp.f_x[k], exp.f_u[k]
        # A shooting gap folds the affine term into the linear Q-terms.
        W = V_x if defects is None else V_x + V_xx @ defects[k]
        fuT_Vxx = f_u.T @ V_xx
        Q_x = exp.l_x[k] + f_x.T @ W
        Q_u = exp.l_u[k] + f_u.T @ W
        Q_xx = exp.l_xx[k] + f_x.T @ V_xx @ f_x
        Q_ux = exp.l_ux[k] + fuT_Vxx @ f_x
        Q_uu = exp.l_uu[k] + fuT_Vxx @ f_u
        Q_x, Q_u, Q_xx, Q_ux, Q_uu = _second_order_terms(
            (Q_x, Q_u, Q_xx, Q_ux, Q_uu), V_x, V_xx,
            *_step_terms(hess, noise, k))

        # Gains; one factorization for both right-hand sides.
        rhs = torch.cat([Q_ux, Q_u[:, None]], dim=1)
        sol = -lin_solve(Q_uu + reg * eye_u, rhs)
        K, u_ff = sol[:, :-1], sol[:, -1]

        # Full symmetric value update via the stationarity residuals
        # W = Q_uu K + Q_ux and w = Q_u + Q_uu u_ff.
        W = Q_uu @ K + Q_ux
        w = Q_u + Q_uu @ u_ff
        V_x = Q_x + K.T @ w + Q_ux.T @ u_ff
        V_xx = Q_xx + K.T @ W + Q_ux.T @ K
        V_xx = 0.5 * (V_xx + V_xx.T)

        u_ffs[k], Ks[k] = u_ff, K
        dVs[k] = torch.stack([u_ff @ Q_u, 0.5 * u_ff @ (w - Q_u)])
    u_ff, K = torch.stack(u_ffs), torch.stack(Ks)
    dV = torch.stack(dVs).sum(0)
    return u_ff, K, dV, all_finite(u_ff, K)


@full_f32_matmuls()
def backward_pass_limited(
    exp: TrajectoryExpansion, U_old, u_lo, u_hi, reg: float = 0.0,
    qp_iters: int = 8, hess=None, noise=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Control-limited backward pass (Tassa et al. 2014, `ops/boxqp.py`).

    The contract of `backward_pass`, plus box limits lo ≤ u ≤ hi at the gain
    computation: the feedforward solves a box QP over the delta bounds
    [lo − u_k, hi − u_k] and the feedback rows of clamped controls are zero.
    U_old (N, n_u); u_lo and u_hi broadcast against (n_u,).  The value
    update is the full symmetric form with JAX's broadcast-sum
    contractions (for clamped controls the simplified form is not even
    algebraically valid).
    """
    N, n_u = exp.l_u.shape
    eye_u = torch.eye(n_u, dtype=exp.l_u.dtype, device=exp.l_u.device)
    u_lo = torch.as_tensor(u_lo, dtype=U_old.dtype, device=U_old.device)
    u_hi = torch.as_tensor(u_hi, dtype=U_old.dtype, device=U_old.device)
    V_x, V_xx = exp.v_x, exp.v_xx
    u_ffs, Ks, dVs = [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        f_x, f_u = exp.f_x[k], exp.f_u[k]
        fuT_Vxx = f_u.T @ V_xx
        Q_x, Q_u, Q_xx, Q_ux, Q_uu = _second_order_terms(
            (exp.l_x[k] + f_x.T @ V_x, exp.l_u[k] + f_u.T @ V_x,
             exp.l_xx[k] + f_x.T @ V_xx @ f_x, exp.l_ux[k] + fuT_Vxx @ f_x,
             exp.l_uu[k] + fuT_Vxx @ f_u),
            V_x, V_xx, *_step_terms(hess, noise, k))
        u_ff, _, K = boxqp_with_gains(Q_uu + reg * eye_u, Q_u,
                                      u_lo - U_old[k], u_hi - U_old[k], Q_ux,
                                      iters=qp_iters)
        W = (Q_uu[:, :, None] * K[None, :, :]).sum(1) + Q_ux
        w = Q_u + (Q_uu * u_ff[None, :]).sum(1)
        V_x = Q_x + (K * w[:, None]).sum(0) + (Q_ux * u_ff[:, None]).sum(0)
        V_xx = (Q_xx + (K[:, :, None] * W[:, None, :]).sum(0)
                + (Q_ux[:, :, None] * K[:, None, :]).sum(0))
        V_xx = 0.5 * (V_xx + V_xx.T)
        u_ffs[k], Ks[k] = u_ff, K
        dVs[k] = torch.stack([u_ff @ Q_u, 0.5 * u_ff @ (w - Q_u)])
    u_ff, K = torch.stack(u_ffs), torch.stack(Ks)
    return u_ff, K, torch.stack(dVs).sum(0), all_finite(u_ff, K)
