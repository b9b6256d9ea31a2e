"""Batch parallelism of the port (counterpart of `ilqr_tpu/parallel`).

Only the batch surfaces exist so far, on one GPU; the mesh, the horizon-
sharded backward pass and solve are ROADMAP item A19.
"""
from ilqr_tpu_torch.parallel.batch import (
    run_mpc_sharded,
    solve_batched,
    solve_multistart,
)

__all__ = ["solve_batched", "solve_multistart", "run_mpc_sharded"]
