"""Planar quadrotor.

PyTorch counterpart of `ilqr_tpu/models/quadrotor.py`: state
x = [p_x, p_z, φ, ṗ_x, ṗ_z, φ̇] (position, roll angle, velocities),
controls u = [F1, F2] (rotor thrusts at ±arm length).  Its CUDA twin for
the rollout kernels is `QuadrotorRegs` in `csrc/models.cuh`.
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
    p = params
    m, g, arm, inertia = p["m"], p["g"], p["arm"], p["inertia"]
    phi = x[..., 2]
    vx, vz, phid = x[..., 3], x[..., 4], x[..., 5]
    thrust = u[..., 0] + u[..., 1]
    torque = arm * (u[..., 1] - u[..., 0])
    ax = -thrust * torch.sin(phi) / m
    az = thrust * torch.cos(phi) / m - g
    aphi = torque / inertia
    return torch.stack([vx, vz, phid, ax, az, aphi], dim=-1)


def hover_controls(params) -> torch.Tensor:
    """Per-rotor thrust that cancels gravity, useful as U_init."""
    m = params["m"]
    return 0.5 * m * params["g"] * torch.ones(2, dtype=m.dtype,
                                              device=m.device)


def make_quadrotor(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m: float = 0.5,
    arm: float = 0.25,
    inertia: float = 0.01,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    for name, v in dict(g=g, m=m, arm=arm, inertia=inertia, dt=dt).items():
        params[name] = as_tensor(v, device, dtype)
    return System(
        params=params, n_x=6, n_u=2, dt=dt, f_cont=f_cont,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
