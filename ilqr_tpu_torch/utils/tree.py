"""Leaves of the port's result objects, by path.

The JAX package flattens pytrees with `jax.tree_util`; the port's results
are frozen dataclasses, dicts, lists and tuples of tensors and Python
numbers, which this module walks in one fixed order: dataclass fields in
declaration order, dict keys sorted (as `jax.tree_util` sorts them), list
and tuple items in order.  None is an empty subtree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _children(tree: Any):
    """[(path step, child)] of a container, or None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf, e.g. ``(".lam_stage_ineq", tensor)``."""
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        if not isinstance(tree, LEAF_TYPES):
            raise TypeError(f"unsupported leaf {type(tree).__name__} at "
                            f"{prefix or 'the root'}")
        yield prefix, tree
        return
    for step, child in children:
        yield from leaves_with_path(child, prefix + step)


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``, in the order of
    `leaves_with_path`."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)
