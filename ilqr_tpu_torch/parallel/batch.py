"""Batch-parallel solving: many trajectory and MPC problems on one GPU.

PyTorch counterpart of `ilqr_tpu/parallel/batch.py`.  JAX batches with
``jit(vmap(solve))`` and shards the batch axis over a device mesh; the port
batches with `solver.solve_batch` (B problems in one host loop, through the
batched kernels B4 and B5, B6 over the batch for the limited and DDP/iLQG
parallel passes, and B3 over the batch for the defect line search) on one
GPU, with every option of `solve` per instance: control limits, DDP, iLQG
noise, adaptive regularization and the parallel-in-time line searches
('defect', 'chunked', each instance with its own latch); 'auto' stays the
sequential engine.  A ``mesh`` other than None raises: sharding over
several GPUs is ROADMAP item A19.
"""
from __future__ import annotations

import dataclasses

import torch

from ilqr_tpu_torch.models.base import System
from ilqr_tpu_torch.mpc import run_mpc_batched
from ilqr_tpu_torch.solver import (
    LINESEARCH_FAILED,
    IlqrConfig,
    IlqrSolution,
    solve_batch,
)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharding a batch over a device mesh is ROADMAP item A19")


def solve_batched(
    system: System,
    x0_batch: torch.Tensor,
    U_init_batch: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    mesh=None,
) -> IlqrSolution:
    """Solve B independent problems: x0_batch (B, n_x), U_init_batch
    (B, N, n_u) or (N, n_u) shared.  Fields of the result lead with B."""
    _no_mesh(mesh)
    return solve_batch(system, x0_batch, U_init_batch, config)


def solve_multistart(
    system: System,
    x0: torch.Tensor,
    U_inits: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    mesh=None,
):
    """Solve from S initial control guesses U_inits (S, N, n_u) and keep the
    best local optimum: the lowest cost among the starts that did not end
    LINESEARCH_FAILED, or among all of them if every start failed.

    Returns (best, sols): the best start's `IlqrSolution` (fields without
    the S axis, ``iterations``/``status`` as Python ints) and the batched
    solutions of all starts."""
    _no_mesh(mesh)
    x0, U_inits = system.inputs(x0, U_inits)
    x0_batch = x0.expand((U_inits.shape[0],) + tuple(x0.shape))
    sols = solve_batch(system, x0_batch, U_inits, config)
    bad = sols.status == LINESEARCH_FAILED
    ranked = torch.where(bad & ~bad.all(), torch.inf, sols.cost)
    i = int(torch.argmin(ranked))
    best = IlqrSolution(**{
        f.name: getattr(sols, f.name)[i] for f in dataclasses.fields(sols)})
    best = dataclasses.replace(best, iterations=int(best.iterations),
                               status=int(best.status),
                               defect_latch=bool(best.defect_latch))
    return best, sols


def run_mpc_sharded(
    solver_system: System,
    plant_system: System,
    x0_batch: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    mesh=None,
):
    """Closed-loop MPC for a batch of initial states (`run_mpc_batched`);
    on one GPU, as ``mesh`` must be None."""
    _no_mesh(mesh)
    return run_mpc_batched(solver_system, plant_system, x0_batch, U_init,
                           n_sim, config)
