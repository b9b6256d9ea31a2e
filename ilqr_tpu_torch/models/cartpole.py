"""Cart-pole swing-up system.

PyTorch counterpart of `ilqr_tpu/models/cartpole.py`: state
x = [p, θ, ṗ, θ̇] with θ measured from the hanging-down position, control
u = [F], the horizontal force on the cart; point mass at distance l:

    p̈ = [F + m s (g c + l θ̇²)] / (M + m s²)
    θ̈ = −[F c + m l θ̇² s c + (M + m) g s] / (l (M + m s²))

Its CUDA twin for the rollout kernels is `CartpoleRegs` in
`csrc/models.cuh`.
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
    mc, mp_, l, g = p["m_cart"], p["m_pole"], p["l"], p["g"]
    th, pd, thd = x[..., 1], x[..., 2], x[..., 3]
    f = u[..., 0]
    s, c = torch.sin(th), torch.cos(th)
    denom = mc + mp_ * s**2
    pdd = (f + mp_ * s * (g * c + l * thd**2)) / denom
    thdd = -(f * c + mp_ * l * thd**2 * s * c + (mc + mp_) * g * s) / (
        l * denom)
    return torch.stack([pd, thd, pdd, thdd], dim=-1)


def make_cartpole(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m_cart: float = 1.0,
    m_pole: float = 0.2,
    l: float = 0.5,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    for name, v in dict(g=g, m_cart=m_cart, m_pole=m_pole, l=l,
                        dt=dt).items():
        params[name] = as_tensor(v, device, dtype)
    return System(
        params=params, n_x=4, n_u=1, dt=dt, f_cont=f_cont,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
