"""Carry weights and state from numpy copies of JAX objects into the port.

The JAX package and the port share no tensor type, so objects cross as
numpy arrays: ``{k: np.asarray(v) for k, v in jax_system.params.items()}``
for a system's parameters, and the nine fields of a JAX
`TrajectoryExpansion` for an expansion.  These functions rebuild the port's
objects from them on a given device (the GPU unless the caller names one)
and dtype.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

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
