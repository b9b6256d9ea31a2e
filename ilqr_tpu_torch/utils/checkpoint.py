"""Checkpoint and resume of solver state.

PyTorch counterpart of `ilqr_tpu/utils/checkpoint.py`.  Any result object
(an `IlqrSolution`, an `MpcResult`, a warm-start dict) round-trips through
a flat .npz of its leaves (`utils.tree` order) and the structure of a
donor object of the same shape, ``like``.  Loading rebuilds each tensor on
the device and in the dtype of ``like``'s tensor at the same place, and
each Python number as its type.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ilqr_tpu_torch.utils.tree import leaves_with_path, map_leaves


def _norm(path: str) -> str:
    # np.savez appends '.npz' to extensionless paths; keep load symmetric.
    return path if path.endswith(".npz") else path + ".npz"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    np.savez(_norm(path), **{f"leaf_{i}": _as_numpy(l)
                             for i, l in enumerate(leaves)})


def load_pytree(path: str, like: Any) -> Any:
    """Load leaves saved by `save_pytree` into the structure of ``like``."""
    with np.load(_norm(path)) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n_like = sum(1 for _ in leaves_with_path(like))
    if len(arrays) != n_like:
        raise ValueError(f"checkpoint has {len(arrays)} leaves, structure "
                         f"needs {n_like}")
    it = iter(arrays)

    def rebuild(leaf):
        arr = next(it)
        if isinstance(leaf, torch.Tensor):
            return torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(arr.item())
        return arr

    return map_leaves(rebuild, like)
