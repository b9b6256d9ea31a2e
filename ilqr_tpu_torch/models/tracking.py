"""Time-varying reference tracking as a time-augmented `System`.

PyTorch counterpart of `ilqr_tpu/models/tracking.py`: the step index is
part of the state, x̃ = [x; k].  The clock advances by exactly one a step:
dk/dt = 1/dt for the integrating schemes (each is exact on a constant
derivative), and under ``integrator='discrete'``, where f_cont is the
next-state map, the clock is set to k + 1.  The quadratic tracking cost
gathers X_ref[k] and U_ref[k] at the rounded, detached clock, so the cost
expansion sees the reference as locally constant.  The result is a
`System`, so the solver, MPC loops and constrained solves take it as it is.

The base system's parameters sit under ``params["base"]``; its f_cont is
bound into the wrapper's, by which the rollout kernels recognise the
wrapper: their device form (`csrc/forms.cuh`, TrackingForm) runs it over
every base with a device model whose tracked state has at most 16 entries,
under the explicit integrators ('discrete' too for LTI bases), and reads
the reference rows from device memory at the state's clock.
"""
from __future__ import annotations

import functools

import torch

from ilqr_tpu_torch.models.base import System, as_tensor, quad_form


def _ref_index(params, x):
    k = x[..., -1].detach()
    n_ref = params["X_ref"].shape[0]
    return torch.clamp(torch.round(k).to(torch.int64), 0, n_ref - 1)


def _f_cont(base_f, params, x, u):
    xdot = base_f(params["base"], x[..., :-1], u)
    clock = torch.ones_like(x[..., -1:]) / params["dt"]
    return torch.cat([xdot, clock], dim=-1)


def _f_discrete(base_f, params, x, u):
    # Under 'discrete' f_cont is the next-state map: set the clock to k + 1.
    x_next = base_f(params["base"], x[..., :-1], u)
    return torch.cat([x_next, x[..., -1:] + torch.ones_like(x[..., -1:])],
                     dim=-1)


def _rows(M, i):
    """M[i] for an index tensor i of any shape (a gather that vmap takes,
    where M[i] would read i on the host)."""
    return M.index_select(0, i.reshape(-1)).reshape(i.shape + M.shape[1:])


def stage_cost(params, x, u):
    i = _ref_index(params, x)
    i_u = torch.clamp(i, max=params["U_ref"].shape[0] - 1)
    dx = x[..., :-1] - _rows(params["X_ref"], i)
    du = u - _rows(params["U_ref"], i_u)
    return 0.5 * (quad_form(dx, params["Q"])
                  + quad_form(du, params["R"])) * params["dt"]


def terminal_cost(params, x):
    dx = x[..., :-1] - params["X_ref"][-1]
    return 0.5 * quad_form(dx, params["Q_f"])


def make_tracking_system(base: System, X_ref, U_ref, Q, R, Q_f) -> System:
    """Wrap ``base`` with a quadratic time-varying tracking cost.

    X_ref (N_ref + 1, n_x) reference states, U_ref (N_ref, n_u) reference
    controls (zeros for pure state tracking), on or moved to the base's
    device and dtype.  The result has ``n_x = base.n_x + 1`` (a trailing
    clock); use `augment_x0` / `strip_clock` at the boundary.
    """
    device, dtype = base.device, base.dtype
    params = dict(
        base=base.params,
        X_ref=as_tensor(X_ref, device, dtype),
        U_ref=as_tensor(U_ref, device, dtype),
        Q=as_tensor(Q, device, dtype),
        R=as_tensor(R, device, dtype),
        Q_f=as_tensor(Q_f, device, dtype),
        dt=as_tensor(base.dt, device, dtype),
    )
    rule = _f_discrete if base.integrator == "discrete" else _f_cont
    return System(
        params=params,
        n_x=base.n_x + 1,
        n_u=base.n_u,
        dt=base.dt,
        f_cont=functools.partial(rule, base.f_cont),
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        integrator=base.integrator,
        newton_iters=base.newton_iters,
    )


def augment_x0(x0, k0: float = 0.0):
    """[x0; k0]: the initial state of a tracking system (clock at k0)."""
    x0 = torch.as_tensor(x0)
    return torch.cat([x0, torch.tensor([k0], dtype=x0.dtype,
                                       device=x0.device)])


def strip_clock(X):
    """The states without their trailing clock (any leading axes)."""
    return X[..., :-1]
