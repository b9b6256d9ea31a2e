"""Single pendulum swing-up system.

PyTorch counterpart of `ilqr_tpu/models/pendulum.py`: state x = [θ, θ̇],
control u = [τ], θ̈ = τ − d·θ̇ − (g/l)·sin θ, dt-scaled quadratic stage cost,
unscaled quadratic terminal cost.  Its CUDA twin for the rollout kernel is
`pendulum_f` in `csrc/models.cuh`.
"""
from __future__ import annotations

import torch

from ilqr_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    System,
    as_tensor,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)


def f_cont(params, x, u):
    theta, theta_dot = x[..., 0], x[..., 1]
    return torch.stack(
        [
            theta_dot,
            u[..., 0] - params["d"] * theta_dot
            - (params["g"] / params["l"]) * torch.sin(theta),
        ],
        dim=-1,
    )


def make_pendulum(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    l: float = 1.0,
    d: float = 0.01,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    for name, v in dict(g=g, l=l, d=d, dt=dt).items():
        params[name] = as_tensor(v, device, dtype)
    return System(
        params=params,
        n_x=2,
        n_u=1,
        dt=dt,
        f_cont=f_cont,
        stage_cost=quadratic_stage_cost,
        terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
