"""ilqr_tpu_torch — the PyTorch and CUDA port of ilqr_tpu.

Counterpart of `ilqr_tpu/__init__.py`.  The JAX package `ilqr_tpu` is the
reference; this package carries its main path to PyTorch: the pendulum and
double-pendulum models, the integrators, trajectory linearization, the
sequential and associative Riccati backward passes, the rollouts, the
parallel-in-time (defect and chunked) rollouts, the iLQR `solve` and the
multiple-shooting `solve_ms`.  Its kernel engines are CUDA C++ written for
Hopper (sm_90a), built with nvcc at first use: the fused backward pass
(``backward='pallas'``, `ops/fused_riccati.py`, with GNMS defects), the
line-search rollout kernels (``rollout='pallas'``, `ops/fused_rollout.py`)
and the multi-candidate affine prefix scan (``defect_engine`` and
``MsConfig.update_engine`` 'pallas', `ops/affine_scan.py`).  On CPU
tensors every kernel wrapper runs its plain PyTorch version.  Nothing here
imports JAX.
"""
from ilqr_tpu_torch.models.base import (
    INTEGRATORS,
    System,
    full_f32_matmuls,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)
from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum
from ilqr_tpu_torch.models.pendulum import make_pendulum
from ilqr_tpu_torch.ops.affine_scan import affine_prefix_scan_multi
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.ops.fused_rollout import (
    closed_loop_rollout_fused,
    linesearch_costs_fused,
)
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion, linearize_trajectory
from ilqr_tpu_torch.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops.rollout import (
    closed_loop_rollout,
    linesearch_rollouts,
    rollout,
)
from ilqr_tpu_torch.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    MAXITER,
    IlqrConfig,
    IlqrSolution,
    solve,
)
from ilqr_tpu_torch.shooting import (
    MsConfig,
    MsSolution,
    interpolate_states,
    solve_ms,
)

__version__ = "0.1.0"

__all__ = [
    "System", "INTEGRATORS", "full_f32_matmuls", "quadratic_cost_params",
    "quadratic_stage_cost", "quadratic_terminal_cost",
    "make_pendulum", "make_double_pendulum", "step",
    "TrajectoryExpansion", "linearize_trajectory",
    "backward_pass", "backward_pass_associative", "backward_pass_fused",
    "rollout", "closed_loop_rollout", "linesearch_rollouts",
    "linesearch_costs_fused", "closed_loop_rollout_fused",
    "affine_prefix_scan_multi",
    "solve", "IlqrConfig", "IlqrSolution",
    "CONVERGED", "LINESEARCH_FAILED", "MAXITER",
    "solve_ms", "MsConfig", "MsSolution", "interpolate_states",
]
