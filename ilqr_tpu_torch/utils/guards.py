"""Numerical guards at API boundaries.

PyTorch counterpart of `ilqr_tpu/utils/guards.py`.  The failure mode these
catch is NaN/Inf from indefinite Q_uu solves or diverging rollouts.  The
solver already guards its accept step (finite costs and gains required)
and reports LINESEARCH_FAILED instead of propagating garbage; these helpers
check results explicitly, for debugging.  They walk the tensor fields of
the port's dataclasses, dicts, lists and tuples (`utils.tree`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ilqr_tpu_torch.utils.tree import leaves_with_path


def _floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def finite_leaves(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of ``tree`` is finite.  On the
    device of the first tensor leaf (the CPU if there is none); no host
    sync."""
    leaves = [leaf for _, leaf in leaves_with_path(tree) if _floating(leaf)]
    device = next((l.device for l in leaves if isinstance(l, torch.Tensor)),
                  torch.device("cpu"))
    flags = [torch.isfinite(torch.as_tensor(l, device=device)).all()
             for l in leaves]
    if not flags:
        return torch.tensor(True, device=device)
    return torch.stack(flags).all()


def assert_finite(tree: Any, name: str = "pytree") -> None:
    """Host-side check (syncs): raise if any leaf holds NaN or Inf."""
    for path, leaf in leaves_with_path(tree):
        if not _floating(leaf):
            continue
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        if not np.all(np.isfinite(arr)):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def solve_checked(system, x0, U_init, config):
    """`ilqr_tpu_torch.solve` followed by a host-side finiteness check of
    the solution's X, U and cost.  For interactive debugging."""
    from ilqr_tpu_torch.solver import solve

    sol = solve(system, x0, U_init, config)
    assert_finite((sol.X, sol.U, sol.cost), "IlqrSolution")
    return sol
