"""Carry weights and state from numpy copies of JAX objects into the port.

The JAX package and the port share no tensor type, so objects cross as
numpy arrays: ``{k: np.asarray(v) for k, v in jax_system.params.items()}``
for a system's parameters, the nine fields of a JAX `TrajectoryExpansion`
for an expansion, and the (nested) params dict of a JAX `ConstraintSet`
for a constraint set.  These functions rebuild the port's
objects from them on a given device (the GPU unless the caller names one)
and dtype.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ilqr_tpu_torch import constrained
from ilqr_tpu_torch.models import (
    car,
    cartpole,
    chain,
    double_pendulum,
    linear,
    neural,
    pendulum,
    quadrotor,
    quadrotor3d,
    rate,
    tracking,
)
from ilqr_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    System,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion

# System kinds the port has, by name: f_cont, under the quadratic tracking
# costs unless `_COSTS` names the kind's own.
KINDS = {
    "pendulum": pendulum.f_cont,
    "double_pendulum": double_pendulum.f_cont,
    "cartpole": cartpole.f_cont,
    "quadrotor": quadrotor.f_cont,
    "quadrotor3d": quadrotor3d.f_cont,
    "quadrotor3d_rotor": quadrotor3d.f_cont_rotor,
    "car": car.f_cont,
    "lti": linear.lti_f_cont,
    "chain": chain._f_cont,
}
_COSTS = {"chain": (chain._stage_cost, chain._terminal_cost)}
# Wrapper kinds: each wraps a converted base system.
WRAPPERS = ("tracking", "rate")

_EXPANSION_FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu",
                     "v_x", "v_xx")


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> dict:
    """A parameter dict of numpy arrays as tensors on device and dtype."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params.items()}


def system_from_numpy(kind, params_np: Mapping[str, np.ndarray],
                      n_x: int, n_u: int, dt: float,
                      integrator: str = "rk4", newton_iters: int = 10,
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> System:
    """The port's `System` of ``kind`` with the given parameters.

    ``kind`` is a key of `KINDS` (the model's own costs, quadratic unless
    `_COSTS` says otherwise), or a pair (wrapper, base kind) with the
    wrapper in `WRAPPERS`, which nest as the wrappers do.  A wrapper's
    ``params_np`` holds the base's parameters under 'base' (where JAX's
    tracking system keeps them; for JAX's rate system, its base system's
    params) beside its own: X_ref, U_ref, Q, R and Q_f for 'tracking', S
    for 'rate'.  n_x and n_u are the wrapped system's.  ``integrator`` and
    ``newton_iters`` are the base's: a tracking system runs its base's, a
    rate system is 'discrete' and steps its base with them.
    """
    if isinstance(kind, (tuple, list)):
        wrapper, base_kind = kind
        if wrapper not in WRAPPERS:
            raise ValueError(f"unknown wrapper {wrapper!r}; have {WRAPPERS}")
        own = {k: v for k, v in params_np.items() if k != "base"}
        if wrapper == "tracking":
            base = system_from_numpy(base_kind, params_np["base"], n_x - 1,
                                     n_u, dt, integrator, newton_iters,
                                     device, dtype)
            p = params_from_numpy(
                {k: own[k] for k in ("X_ref", "U_ref", "Q", "R", "Q_f")},
                device, dtype)
            return tracking.make_tracking_system(base, **p)
        base = system_from_numpy(base_kind, params_np["base"], n_x - n_u,
                                 n_u, dt, integrator, newton_iters, device,
                                 dtype)
        return rate.make_rate_penalized_system(
            base, torch.tensor(np.asarray(own["S"]), dtype=dtype,
                               device=device))
    if kind not in KINDS:
        raise ValueError(f"unknown system kind {kind!r}; have {sorted(KINDS)}")
    stage, terminal = _COSTS.get(
        kind, (quadratic_stage_cost, quadratic_terminal_cost))
    return System(
        params=params_from_numpy(params_np, device, dtype),
        n_x=n_x, n_u=n_u, dt=dt, f_cont=KINDS[kind],
        stage_cost=stage, terminal_cost=terminal,
        integrator=integrator, newton_iters=newton_iters,
    )


def neural_from_numpy(base: System, layers_np) -> System:
    """A neural residual (`models/neural.py`) over the converted ``base``
    with the layers of a JAX one: ``layers_np`` is the numpy copy of JAX's
    ``net.params["mlp"]``, a list of ``{"W": (fan_in, fan_out), "b":
    (fan_out,)}``.  The layers land on the base's device and dtype; the
    result's integrator and ``newton_iters`` are the base's, as JAX's
    `make_neural_residual` takes them."""
    net = neural.make_neural_residual(
        base, hidden=[np.shape(layer["b"])[0] for layer in layers_np[:-1]])
    device, dtype = base.device, base.dtype
    mlp = [{k: torch.tensor(np.asarray(layer[k]), dtype=dtype, device=device)
            for k in ("W", "b")} for layer in layers_np]
    for got, want in zip(mlp, net.params["mlp"]):
        if got["W"].shape != want["W"].shape:
            raise ValueError(f"a layer of shape {tuple(got['W'].shape)} where "
                             f"the base takes {tuple(want['W'].shape)}")
    return net.replace(params={**net.params, "mlp": mlp})


def expansion_from_numpy(exp: Any, device=DEFAULT_DEVICE,
                         dtype=torch.float32) -> TrajectoryExpansion:
    """A `TrajectoryExpansion` from an object with the nine fields as
    attributes (a JAX expansion) or a mapping of them to arrays."""
    get = exp.__getitem__ if isinstance(exp, Mapping) else exp.__getattribute__
    return TrajectoryExpansion(*(
        torch.tensor(np.asarray(get(f)), dtype=dtype, device=device)
        for f in _EXPANSION_FIELDS))


# Constraint factories by name, each from its params dict.
CONSTRAINT_KINDS = {
    "box_control": lambda p, **kw: constrained.box_control_constraints(
        p["lo"], p["hi"], **kw),
    "state_bound": lambda p, **kw: constrained.state_bound_constraints(
        p["lo"], p["hi"], **kw),
    "state_bound_stage": lambda p, **kw: constrained.state_bound_constraints(
        p["lo"], p["hi"], terminal=False, **kw),
    "goal": lambda p, **kw: constrained.goal_constraint(p["x_goal"], **kw),
}


def constraints_from_numpy(kind, params_np: Mapping, device=DEFAULT_DEVICE,
                           dtype=torch.float32) -> constrained.ConstraintSet:
    """The port's `ConstraintSet` from the numpy copy of a JAX set's params.

    ``kind`` names the factory that built the set (a key of
    `CONSTRAINT_KINDS`: 'box_control', 'state_bound', 'state_bound_stage'
    for ``terminal=False``, 'goal'), or is a pair (kind_a, kind_b) for
    ``merge_constraints(a, b)``, whose params are ``{'a': ..., 'b': ...}``;
    pairs nest as merges do.
    """
    if isinstance(kind, (tuple, list)):
        kind_a, kind_b = kind
        return constrained.merge_constraints(
            constraints_from_numpy(kind_a, params_np["a"], device, dtype),
            constraints_from_numpy(kind_b, params_np["b"], device, dtype))
    if kind not in CONSTRAINT_KINDS:
        raise ValueError(f"unknown constraint kind {kind!r}; have "
                         f"{sorted(CONSTRAINT_KINDS)}")
    params = {k: np.array(v) for k, v in params_np.items()}
    return CONSTRAINT_KINDS[kind](params, device=device, dtype=dtype)
