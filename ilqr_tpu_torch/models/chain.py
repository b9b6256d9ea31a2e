"""Nonlinear mass-spring-damper chain: a medium-dimension system.

PyTorch counterpart of `ilqr_tpu/models/chain.py`: ``m`` masses on a line,
nearest-neighbour springs (stiffness k, fixed walls at both ends), damping
c, a softening term s·sin(qᵢ), and an actuator on every ``n_act``-th mass:

    q̈ᵢ = −k(2qᵢ − qᵢ₋₁ − qᵢ₊₁) − c·q̇ᵢ − s·sin(qᵢ) + (S u)ᵢ

State x = (q, q̇) ∈ R^{2m}, controls u ∈ R^{m/n_act}; m = 16 gives
n_x = 32, above the fused kernels' n_x ≤ 16, so ``backward='pallas'``
runs the associative scan there, as in JAX.  Its own diagonal stage and
terminal costs.  The rollout kernels run it through its device form
(`csrc/forms.cuh`, ChainForm) at 16 masses with an actuator on each (n_x =
32, n_u = 16), under the explicit integrators.
"""
from __future__ import annotations

import torch

from ilqr_tpu_torch.models.base import DEFAULT_DEVICE, System, as_tensor


def _f_cont(params, x, u):
    m = params["q_target"].shape[0]
    q, qd = x[..., :m], x[..., m:]
    k, c, s = params["k"], params["c"], params["s"]
    # Fixed walls: q_0's left neighbour and q_{m-1}'s right one are 0.
    zero = torch.zeros_like(q[..., :1])
    left = torch.cat([zero, q[..., :-1]], dim=-1)
    right = torch.cat([q[..., 1:], zero], dim=-1)
    qdd = (-k * ((q + q) - left - right) - c * qd - s * torch.sin(q)
           + (params["S"] @ u[..., None])[..., 0])
    return torch.cat([qd, qdd], dim=-1)


def _stage_cost(params, x, u):
    m = params["q_target"].shape[0]
    dq = x[..., :m] - params["q_target"]
    v = x[..., m:]
    return 0.5 * params["dt"] * (
        params["wq"] * torch.sum(dq * dq, dim=-1)
        + params["wv"] * torch.sum(v * v, dim=-1)
        + params["wu"] * torch.sum(u * u, dim=-1))


def _terminal_cost(params, x):
    m = params["q_target"].shape[0]
    dq = x[..., :m] - params["q_target"]
    v = x[..., m:]
    return 0.5 * (params["wqf"] * torch.sum(dq * dq, dim=-1)
                  + params["wvf"] * torch.sum(v * v, dim=-1))


def make_spring_chain(dt: float, n_masses: int = 16, n_act: int = 1,
                      k: float = 10.0, c: float = 0.2, s: float = 3.0,
                      q_target=None, wq: float = 1.0, wv: float = 0.1,
                      wu: float = 0.01, wqf: float = 100.0,
                      wvf: float = 10.0, integrator: str = "rk4", *,
                      device=DEFAULT_DEVICE,
                      dtype=torch.float32) -> System:
    """Build the chain; n_x = 2·n_masses, n_u = n_masses // n_act."""
    m = n_masses
    n_u = m // n_act
    S = torch.zeros((m, n_u), dtype=dtype, device=device)
    S[torch.arange(n_u) * n_act, torch.arange(n_u)] = 1.0
    if q_target is None:
        q_target = 0.5 * torch.ones((m,))
    params = dict(S=S, q_target=as_tensor(q_target, device, dtype))
    for name, v in dict(dt=dt, k=k, c=c, s=s, wq=wq, wv=wv, wu=wu, wqf=wqf,
                        wvf=wvf).items():
        params[name] = as_tensor(v, device, dtype)
    return System(params=params, n_x=2 * m, n_u=n_u, dt=dt,
                  f_cont=_f_cont, stage_cost=_stage_cost,
                  terminal_cost=_terminal_cost, integrator=integrator)
