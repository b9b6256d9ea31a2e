"""One-shot finite-horizon discrete LQR, the exactly linear special case.

PyTorch counterpart of `ilqr_tpu/ops/lqr.py`: for x⁺ = A x + B u with the
tracking cost Σ ½(x−x*)'Q(x−x*) + ½u'Ru + ½(x_N−x*)'Q_f(x_N−x*) the
Riccati recursion is exact, so the solve is one backward recursion and
one rollout, with no iteration and no line search.  The value function is
affine around x*, carried as (S, s).  The backward recursion runs over
time on the host; the gain systems go to `models.base.lin_solve`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ilqr_tpu_torch.models.base import full_f32_matmuls, lin_solve


class LqrSolution(NamedTuple):
    X: torch.Tensor      # (N+1, n_x)
    U: torch.Tensor      # (N, n_u)
    K: torch.Tensor      # (N, n_u, n_x) feedback gains
    k_ff: torch.Tensor   # (N, n_u) feedforward terms
    cost: torch.Tensor   # scalar


@full_f32_matmuls()
def lqr_backward(A, B, Q, R, Q_f, x_target: Optional[torch.Tensor] = None,
                 N: int = 1):
    """Backward Riccati recursion for time-invariant (A, B, Q, R).

    Returns stacked gains (K (N, n_u, n_x), k_ff (N, n_u)) and value
    matrices (S (N, n_x, n_x), s (N, n_x)), with u_k = −K_k x_k − k_ff_k.
    """
    if x_target is None:
        x_target = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    q = -(Q @ x_target)
    S, s = Q_f, -(Q_f @ x_target)
    Ks, ks, Ss, ss = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        # V_k(x) = ½ x'S x + s'x; H = R + B'SB, G = B'SA, g = B's.
        BtS = B.T @ S
        H = R + BtS @ B
        G = BtS @ A
        g = B.T @ s
        sol = lin_solve(H, torch.cat([G, g[:, None]], dim=1))
        K, k_ff = sol[:, :-1], sol[:, -1]
        Ks[k], ks[k], Ss[k], ss[k] = K, k_ff, S, s
        S_new = Q + A.T @ S @ (A - B @ K)
        S = 0.5 * (S_new + S_new.T)
        s = q + A.T @ s - G.T @ k_ff
    return (torch.stack(Ks), torch.stack(ks), torch.stack(Ss),
            torch.stack(ss))


@full_f32_matmuls()
def lqr_solve(A, B, Q, R, Q_f, x0, N: int,
              x_target: Optional[torch.Tensor] = None) -> LqrSolution:
    """Solve the finite-horizon LQR and roll out the optimal policy."""
    if x_target is None:
        x_target = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    K, k_ff, _, _ = lqr_backward(A, B, Q, R, Q_f, x_target, N)
    x, xs, us = x0, [], []
    cost = torch.zeros((), dtype=x0.dtype, device=x0.device)
    for k in range(N):
        u = -K[k] @ x - k_ff[k]
        dx = x - x_target
        cost = cost + 0.5 * (dx @ Q @ dx + u @ R @ u)
        xs.append(x)
        us.append(u)
        x = A @ x + B @ u
    dxN = x - x_target
    cost = cost + 0.5 * dxN @ Q_f @ dxN
    return LqrSolution(X=torch.stack(xs + [x]), U=torch.stack(us), K=K,
                       k_ff=k_ff, cost=cost)
