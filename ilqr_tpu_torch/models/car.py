"""Kinematic bicycle ("car") model.

PyTorch counterpart of `ilqr_tpu/models/car.py`: state
x = [p_x, p_y, heading θ, speed v], control u = [acceleration a, steering
angle δ], wheelbase L:

    ṗ_x = v cos θ,  ṗ_y = v sin θ,  θ̇ = (v / L) tan δ,  v̇ = a

with keep-out discs as smooth quadratic stage and terminal inequalities
for the constrained solver (`ilqr_tpu_torch.constrained`).  Its CUDA twin
for the rollout kernels is `CarRegs` in `csrc/models.cuh`.
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
    th, v = x[..., 2], x[..., 3]
    a, delta = u[..., 0], u[..., 1]
    return torch.stack([
        v * torch.cos(th),
        v * torch.sin(th),
        v / params["L"] * torch.tan(delta),
        a,
    ], dim=-1)


def make_car(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    L: float = 2.0,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    params["L"] = as_tensor(L, device, dtype)
    params["dt"] = as_tensor(dt, device, dtype)
    return System(
        params=params, n_x=4, n_u=2, dt=dt, f_cont=f_cont,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )


def _obstacle_g(params, x, u=None):
    # g_i = r_i² − ‖p − c_i‖² ≤ 0, violated inside disc i (units of m²).
    d = x[..., None, :2] - params["centers"]          # (..., n_obs, 2)
    return params["radii"] ** 2 - torch.sum(d * d, dim=-1)


def _obstacle_terminal(params, x):
    return _obstacle_g(params, x)


def obstacle_constraints(centers, radii, *, device=DEFAULT_DEVICE,
                         dtype=torch.float32):
    """Keep-out discs in the (p_x, p_y) plane as stage and terminal
    inequalities, a `constrained.ConstraintSet`; centers (n_obs, 2), radii
    (n_obs,).  Combine with control boxes by `merge_constraints`."""
    # Here, not at the top: constrained imports the rollout kernels'
    # module, which imports this one.
    from ilqr_tpu_torch.constrained import ConstraintSet, _params_to

    return ConstraintSet(
        params=_params_to(dict(centers=centers, radii=radii), device, dtype),
        stage_ineq=_obstacle_g,
        terminal_ineq=_obstacle_terminal,
    )
