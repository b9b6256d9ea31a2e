"""Timing discipline: warm-up, then measurement that waits for the device.

PyTorch counterpart of `ilqr_tpu/utils/timing.py`, the reference's
protocol (warm every pass up on representative arrays, wait for the
device, then time; MPC per-step averaging).  Where JAX blocks on its
arrays, these functions end in `torch.cuda.synchronize()` when the call
touched a CUDA tensor.  `timed` reads CUDA events on CUDA and
`time.perf_counter` on the CPU.  On the card the first call holds the
kernels' nvcc build and CUDA's lazy initialization, which is what
`compile_time` reports.  `trace` records a `torch.profiler` trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Tuple

import torch


def _on_cuda(tree) -> bool:
    """Whether ``tree`` (arguments or results: tensors, and dataclasses such
    as systems and solutions, dicts, lists and tuples of them) holds a
    CUDA tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return any(_on_cuda(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return False


def _wait(*trees) -> None:
    if _on_cuda(trees):
        torch.cuda.synchronize()


def warmup(fn: Callable, *args, **kwargs) -> Any:
    """Call ``fn`` once and wait for the device (the reference's warm-up
    block): on the card this builds the kernels and initializes CUDA."""
    out = fn(*args, **kwargs)
    _wait(out, args, kwargs)
    return out


def timed(fn: Callable, *args, reps: int = 10, warmup_reps: int = 2,
          **kwargs) -> Tuple[float, Any]:
    """Average seconds per call after ``warmup_reps`` untimed calls.
    Returns (sec, out of the last call).  CUDA events time the calls when
    they touch a CUDA tensor, the host clock otherwise."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    out = None
    for _ in range(warmup_reps):
        out = fn(*args, **kwargs)
    cuda = _on_cuda((args, kwargs, out))
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps, out
    _wait(out)
    return (time.perf_counter() - t0) / reps, out


def compile_time(fn: Callable, *args, **kwargs) -> float:
    """Seconds the first call spends beyond a steady call (first call less
    the steady-state time): the nvcc build and lazy initialization."""
    t0 = time.perf_counter()
    warmup(fn, *args, **kwargs)
    first = time.perf_counter() - t0
    steady, _ = timed(fn, *args, reps=3, warmup_reps=1, **kwargs)
    return max(first - steady, 0.0)


@contextlib.contextmanager
def trace(logdir: str):
    """Record a `torch.profiler` trace of the block (CPU, and CUDA when a
    card is present) and write it to ``logdir/trace.json`` (Chrome trace
    format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
