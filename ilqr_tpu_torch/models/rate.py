"""Control-rate (Δu) penalties by exact discrete state augmentation.

PyTorch counterpart of `ilqr_tpu/models/rate.py`: the state carries the
previous control, z = [x; u_prev], under the discrete map
z⁺ = [step(base, x, u); u] (the 'discrete' integrator: the u_prev update
is a jump), and the stage cost adds 0.5 (u − u_prev)ᵀ S (u − u_prev)·dt.
The base system's own integrator runs inside the map.  The base's
parameters sit under ``params["base"]``, its static fields are bound into
the wrapper's functions, by which the rollout kernels recognise the
wrapper: their device form (`csrc/forms.cuh`, RateForm) runs it over every
base with a device model and n_x + n_u at most 16, the base under the
explicit integrators ('discrete' too for LTI bases).
"""
from __future__ import annotations

import functools

import torch

from ilqr_tpu_torch.models.base import System, as_tensor, quad_form
from ilqr_tpu_torch.ops.integrators import step


def _base(base: System, params) -> System:
    return base.replace(params=params["base"])


def _f_disc(base, params, z, u):
    x_next = step(_base(base, params), z[..., :base.n_x], u)
    return torch.cat([x_next, u], dim=-1)


def _stage_cost(base, params, z, u):
    # dt as a tensor: a Python float times a tensor that carries a tangent
    # gives a float64 tangent under vmap(jacfwd).
    du = u - z[..., base.n_x:]
    return (base.stage_cost(params["base"], z[..., :base.n_x], u)
            + 0.5 * quad_form(du, params["S"]) * params["dt"])


def _terminal_cost(base, params, z):
    return base.terminal_cost(params["base"], z[..., :base.n_x])


def make_rate_penalized_system(base: System, S) -> System:
    """Wrap ``base`` with a quadratic penalty on control increments.

    S (n_u, n_u).  The result has ``n_x = base.n_x + base.n_u`` (a
    trailing u_prev block); use `rate_augment_x0` / `strip_rate` at the
    boundary.
    """
    device, dtype = base.device, base.dtype
    params = dict(base=base.params, S=as_tensor(S, device, dtype),
                  dt=as_tensor(base.dt, device, dtype))
    return System(
        params=params,
        n_x=base.n_x + base.n_u,
        n_u=base.n_u,
        dt=base.dt,
        f_cont=functools.partial(_f_disc, base),
        stage_cost=functools.partial(_stage_cost, base),
        terminal_cost=functools.partial(_terminal_cost, base),
        integrator="discrete",
    )


def rate_augment_x0(x0, u_prev=None, n_u: int | None = None):
    """[x0; u_prev]: the initial state of a rate-penalized system."""
    x0 = torch.as_tensor(x0)
    if u_prev is None:
        u_prev = torch.zeros((n_u,), dtype=x0.dtype, device=x0.device)
    return torch.cat([x0, torch.as_tensor(u_prev, dtype=x0.dtype,
                                          device=x0.device)])


def strip_rate(Z, n_x: int):
    """The states without their trailing u_prev block."""
    return Z[..., :n_x]
