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
from ilqr_tpu_torch.models import double_pendulum, pendulum
from ilqr_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    System,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion

# System kinds the port has, by name.
KINDS = {
    "pendulum": pendulum.f_cont,
    "double_pendulum": double_pendulum.f_cont,
}

_EXPANSION_FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu",
                     "v_x", "v_xx")


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> dict:
    """A parameter dict of numpy arrays as tensors on device and dtype."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params.items()}


def system_from_numpy(kind: str, params_np: Mapping[str, np.ndarray],
                      n_x: int, n_u: int, dt: float,
                      integrator: str = "rk4", newton_iters: int = 10,
                      device=DEFAULT_DEVICE, dtype=torch.float32) -> System:
    """The port's `System` of ``kind`` (a key of `KINDS`) with the given
    parameters, for the quadratic tracking costs the models use."""
    if kind not in KINDS:
        raise ValueError(f"unknown system kind {kind!r}; have {sorted(KINDS)}")
    return System(
        params=params_from_numpy(params_np, device, dtype),
        n_x=n_x, n_u=n_u, dt=dt, f_cont=KINDS[kind],
        stage_cost=quadratic_stage_cost,
        terminal_cost=quadratic_terminal_cost,
        integrator=integrator, newton_iters=newton_iters,
    )


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
