"""Time-varying LQR tracking of solved trajectories.

PyTorch counterpart of `ilqr_tpu/tracking.py`: linearize once along a
reference (X_ref, U_ref), run a Riccati backward pass on a deviation-cost
expansion for time-varying gains, then apply u = u_ref + K (x − x_ref) with
no per-step optimization.  Gain synthesis takes any backward pass with the
`backward_pass(exp, reg)` contract, the fused kernel
(`ops.fused_riccati.backward_pass_fused`) included; execution is the
closed-loop rollout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ilqr_tpu_torch.models.base import System, as_tensor, full_f32_matmuls
from ilqr_tpu_torch.ops.linearize import (
    TrajectoryExpansion,
    linearize_trajectory,
)
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops.rollout import closed_loop_rollout


@full_f32_matmuls()
def tvlqr_gains(system: System, X_ref, U_ref, Q, R, Q_f,
                backward=backward_pass) -> torch.Tensor:
    """Feedback gains K (N, n_u, n_x) stabilizing (X_ref, U_ref).

    Deviation cost ½(δx'Qδx + δu'Rδu)·dt a step and ½ δx'Q_f δx at the end,
    expanded around the reference (zero gradients), dynamics linearized
    along it.
    """
    X_ref, U_ref = system.inputs(X_ref, U_ref)
    device, dtype = U_ref.device, U_ref.dtype
    N = U_ref.shape[0]
    exp_dyn = linearize_trajectory(system, X_ref, U_ref)
    dt = as_tensor(system.dt, device, dtype)
    Q, R, Q_f = (as_tensor(m, device, dtype) for m in (Q, R, Q_f))
    exp = TrajectoryExpansion(
        f_x=exp_dyn.f_x, f_u=exp_dyn.f_u,
        l_x=torch.zeros((N, X_ref.shape[-1]), dtype=dtype, device=device),
        l_u=torch.zeros((N, U_ref.shape[-1]), dtype=dtype, device=device),
        l_xx=(Q * dt).expand(exp_dyn.l_xx.shape).contiguous(),
        l_ux=torch.zeros_like(exp_dyn.l_ux),
        l_uu=(R * dt).expand(exp_dyn.l_uu.shape).contiguous(),
        v_x=torch.zeros((X_ref.shape[-1],), dtype=dtype, device=device),
        v_xx=Q_f.contiguous(),
    )
    return backward(exp, 0.0)[1]


@full_f32_matmuls()
def track(plant: System, x0, X_ref, U_ref, K,
          u_limits: Optional[Tuple] = None):
    """Run u_k = u_ref_k + K_k (x_k − x_ref_k) on ``plant`` (which may differ
    from the system the reference was solved on).  Returns (X, U, cost)."""
    x0, X_ref, U_ref, K = plant.inputs(x0, X_ref, U_ref, K)
    return closed_loop_rollout(plant, x0, 0.0, X_ref, U_ref,
                               torch.zeros_like(U_ref), K, u_limits=u_limits)


def track_solution(plant: System, x0, solution, u_limits=None):
    """Track a solution (`IlqrSolution`) with its own converged gains, the
    TVLQR gains of its trajectory under the problem's cost.  With control
    limits or near-zero regularization those gains can be ill-conditioned;
    synthesize fresh ones with `tvlqr_gains` there."""
    return track(plant, x0, solution.X, solution.U, solution.K,
                 u_limits=u_limits)
