"""Forward rollouts: nominal, closed-loop, and the line-search batch.

PyTorch counterpart of `ilqr_tpu/ops/rollout.py`:
    u_k = u_old_k + α·u_ff_k + K_k (x_k − x_old_k)
    x_{k+1} = f(x_k, u_k),   cost += l(x_k, u_k),  + l_f(x_N) at the end.

The loop over time runs on the host.  `linesearch_rollouts` advances every
α of the schedule together along a leading axis (the models accept batched
states), so the whole schedule costs one pass.  These are the plain versions
of the rollout kernels in `ilqr_tpu_torch.ops.fused_rollout`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import step


@full_f32_matmuls()
def rollout(system: System, x0: torch.Tensor, U: torch.Tensor):
    """Open-loop rollout of a control sequence. Returns X: (N+1, n_x), cost."""
    x = x0
    cost = torch.zeros((), dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for u in U:
        cost = cost + system.stage_cost(system.params, x, u)
        x = step(system, x, u)
        xs.append(x)
    cost = cost + system.terminal_cost(system.params, x)
    return torch.stack(xs), cost


@full_f32_matmuls()
def linesearch_rollouts(system: System, x0, alphas, X_old, U_old, u_ff, K):
    """Roll out every α of ``alphas`` (A,) at once.

    Time-major inputs: X_old (N+1, n_x), U_old (N, n_u), u_ff (N, n_u),
    K (N, n_u, n_x).  Returns (X (A, N+1, n_x), U (A, N, n_u), costs (A,)).
    """
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    al = alphas[:, None]
    x = x0.expand(alphas.shape[0], x0.shape[0])
    cost = torch.zeros(alphas.shape, dtype=x0.dtype, device=x0.device)
    xs, us = [x], []
    for t in range(U_old.shape[0]):
        u = (U_old[t] + al * u_ff[t]
             + ((x - X_old[t]) @ K[t].T))
        cost = cost + system.stage_cost(system.params, x, u)
        x = step(system, x, u)
        xs.append(x)
        us.append(u)
    cost = cost + system.terminal_cost(system.params, x)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1), cost


def closed_loop_rollout(
    system: System, x0, alpha, X_old, U_old, u_ff, K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop rollout for one α. Returns (X_new, U_new, cost)."""
    alphas = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    X, U, cost = linesearch_rollouts(system, x0, alphas.reshape(1), X_old,
                                     U_old, u_ff, K)
    return X[0], U[0], cost[0]
