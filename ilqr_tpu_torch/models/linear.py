"""Linear time-invariant systems and exact zero-order-hold discretization.

PyTorch counterpart of `ilqr_tpu/models/linear.py`: `cont2disc` by the
augmented matrix exponential (`torch.linalg.matrix_exp`), the continuous
`make_lti` and the discrete `make_discrete_lti` (the 'discrete'
integrator: f_cont is the next-state map).  The one-shot LQR solve is
`ilqr_tpu_torch.ops.lqr`.  The rollout kernels run these systems through
their device model (`csrc/models.cuh`, LtiRegs) at the (n_x, n_u) of
`ops.fused_rollout.LTI_SHAPES`, under the explicit integrators and
'discrete'; other sizes raise on CUDA (ROADMAP item B2x).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    System,
    as_tensor,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)


def cont2disc(A: torch.Tensor, B: torch.Tensor,
              dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ZOH discretization: expm([[A, B], [0, 0]]·dt) → (A_d, B_d)."""
    n, m = A.shape[0], B.shape[1]
    top = torch.cat([A, B], dim=1)
    bot = torch.zeros((m, n + m), dtype=top.dtype, device=top.device)
    E = torch.linalg.matrix_exp(torch.cat([top, bot], dim=0) * dt)
    return E[:n, :n], E[:n, n:]


def lti_f_cont(params, x, u):
    return ((params["A"] @ x[..., None])[..., 0]
            + (params["B"] @ u[..., None])[..., 0])


def _system(A, B, dt, x_target, Q, R, Q_f, integrator, device, dtype):
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    params.update(A=as_tensor(A, device, dtype), B=as_tensor(B, device, dtype),
                  dt=as_tensor(dt, device, dtype))
    return System(
        params=params, n_x=params["A"].shape[0], n_u=params["B"].shape[1],
        dt=dt, f_cont=lti_f_cont, stage_cost=quadratic_stage_cost,
        terminal_cost=quadratic_terminal_cost, integrator=integrator,
    )


def make_discrete_lti(A_d, B_d, dt: float, x_target, Q, R, Q_f, *,
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> System:
    """Discrete LTI system x⁺ = A_d x + B_d u (e.g. `cont2disc`'s output)
    with quadratic tracking costs, under the 'discrete' integrator."""
    return _system(A_d, B_d, dt, x_target, Q, R, Q_f, "discrete", device,
                   dtype)


def make_lti(A, B, dt: float, x_target, Q, R, Q_f, integrator: str = "euler",
             *, device=DEFAULT_DEVICE, dtype=torch.float32) -> System:
    """Continuous LTI system ẋ = Ax + Bu with quadratic tracking costs."""
    return _system(A, B, dt, x_target, Q, R, Q_f, integrator, device, dtype)
