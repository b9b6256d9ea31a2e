"""Forward rollouts: nominal, closed-loop, and the line-search batch.

PyTorch counterpart of `ilqr_tpu/ops/rollout.py`:
    u_k = u_old_k + α·u_ff_k + K_k (x_k − x_old_k)
    x_{k+1} = f(x_k, u_k),   cost += l(x_k, u_k),  + l_f(x_N) at the end.

The loop over time runs on the host.  `linesearch_rollouts` advances every
α of the schedule together along a leading axis (the models accept batched
states), so the whole schedule costs one pass.  Leading axes of the inputs
batch independent instances (B of them: states (B, A, n_x)), still in one
host loop over time.  These are the plain versions of the rollout kernels
in `ilqr_tpu_torch.ops.fused_rollout` (one instance) and
`ilqr_tpu_torch.ops.batched` (a batch).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import step


@full_f32_matmuls()
def rollout(system: System, x0: torch.Tensor, U: torch.Tensor):
    """Open-loop rollout of a control sequence: x0 (..., n_x), U
    (..., N, n_u).  Returns X (..., N+1, n_x) and the cost (...)."""
    x = x0
    cost = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for u in U.unbind(-2):
        cost = cost + system.stage_cost(system.params, x, u)
        x = step(system, x, u)
        xs.append(x)
    cost = cost + system.terminal_cost(system.params, x)
    return torch.stack(xs, dim=-2), cost


@full_f32_matmuls()
def linesearch_rollouts(system: System, x0, alphas, X_old, U_old, u_ff, K,
                        u_limits=None):
    """Roll out every α of ``alphas`` at once.

    Time-major inputs: x0 (..., n_x), X_old (..., N+1, n_x), U_old and
    u_ff (..., N, n_u), K (..., N, n_u, n_x), whose leading axes batch
    instances; ``alphas`` is (A,), shared, or (..., A), per instance.
    ``u_limits`` = (lo, hi) clips each applied control to box limits.
    Returns (X (..., A, N+1, n_x), U (..., A, N, n_u), costs (..., A)).
    """
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    al = alphas[..., None]
    batch = x0.shape[:-1]
    x = x0[..., None, :].expand(batch + (alphas.shape[-1], x0.shape[-1]))
    cost = torch.zeros(batch + alphas.shape[-1:], dtype=x0.dtype,
                       device=x0.device)
    xs, us = [x], []
    for t in range(U_old.shape[-2]):
        u = (U_old[..., t, None, :] + al * u_ff[..., t, None, :]
             + ((x - X_old[..., t, None, :]) @ K[..., t, :, :].mT))
        if u_limits is not None:
            u = torch.clamp(u, *u_limits)
        cost = cost + system.stage_cost(system.params, x, u)
        x = step(system, x, u)
        xs.append(x)
        us.append(u)
    cost = cost + system.terminal_cost(system.params, x)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), cost


def closed_loop_rollout(
    system: System, x0, alpha, X_old, U_old, u_ff, K, u_limits=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop rollout for one α, each control clipped to ``u_limits``
    = (lo, hi) when given.  Returns (X_new, U_new, cost)."""
    alphas = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    X, U, cost = linesearch_rollouts(system, x0, alphas.reshape(1), X_old,
                                     U_old, u_ff, K, u_limits)
    return X[0], U[0], cost[0]
