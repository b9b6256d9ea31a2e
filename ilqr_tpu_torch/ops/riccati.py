"""Sequential Riccati backward pass over a precomputed trajectory expansion.

PyTorch counterpart of `ilqr_tpu/ops/riccati.py::backward_pass`: the same
Q-expansion and gain solves, walked backward over time in a host loop, with
the full symmetric value update, regularization on the gain solve only, the
expected-improvement terms dV and the ``ok`` flag.  The (n_u × n_u) gain
systems go to `torch.linalg.solve`.  With multiple-shooting ``defects``
(the GNMS backward pass of `ilqr_tpu_torch.shooting`) the linear Q-terms
use V_x + V_xx·d_k in place of V_x.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion


def all_finite(*tensors: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: every entry of every tensor is finite."""
    out = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        out = out & torch.isfinite(t).all()
    return out


@full_f32_matmuls()
def backward_pass(
    exp: TrajectoryExpansion, reg: float = 0.0, hess=None, noise=None,
    defects=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the Riccati recursion.

    ``defects`` ((N, n_x) gaps d_k = f(x_k, u_k) − x_{k+1}) make the local
    dynamics affine, δx⁺ = f_x δx + f_u δu + d_k; ``None`` (or zeros) is the
    plain recursion.

    Returns:
        u_ff: (N, n_u) feedforward controls
        K:    (N, n_u, n_x) feedback gains
        dV:   (2,) expected cost-decrease coefficients (linear, quadratic in α)
        ok:   0-d bool tensor — all gains finite
    """
    if hess is not None or noise is not None:
        raise NotImplementedError(
            "second-order (DDP) and iLQG noise terms are ROADMAP item A15")
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

        # Gains; one factorization for both right-hand sides.
        rhs = torch.cat([Q_ux, Q_u[:, None]], dim=1)
        sol = -torch.linalg.solve(Q_uu + reg * eye_u, rhs)
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
