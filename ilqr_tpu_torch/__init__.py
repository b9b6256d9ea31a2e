"""ilqr_tpu_torch — the PyTorch and CUDA port of ilqr_tpu.

Counterpart of `ilqr_tpu/__init__.py`.  The JAX package `ilqr_tpu` is the
reference; this package carries its main path to PyTorch: the models
(pendulum, double pendulum, cart-pole, planar and 3-D quadrotors, car,
LTI, spring chain, the tracking and control-rate wrappers, and learned
dynamics: an MLP residual on any of them, `make_neural_residual` and
`fit_dynamics`), the collocation oracle (`collocation`), one-shot
LQR and TVLQR tracking, the integrators, trajectory linearization, the
sequential and associative Riccati backward passes, the rollouts, the
parallel-in-time (defect and chunked) rollouts, the iLQR `solve` and the
multiple-shooting `solve_ms`, batched solving (`solve_batch`,
`parallel.solve_batched`, `parallel.solve_multistart`) and MPC (`mpc`:
`run_mpc`, `run_mpc_rti`, `run_mpc_batched`, `run_mpc_ms`,
`run_mpc_constrained`, `run_mpc_barrier`), control limits (`ops/boxqp.py`,
the sequential and parallel limited backward passes), full DDP
(`dynamics_hessians`), iLQG (`ilqg`), each of them in batched solves
too, the augmented-Lagrangian and
relaxed-barrier constrained solvers (`constrained`, `barrier`), the
differentiable solve (`diff`: `solve_implicit`, `run_mpc_implicit`),
sampling MPC (`mppi`), the EKF/UKF/RTS estimators (`estimation`) and
their parallel-in-time forms (`estimation_parallel`), the
reference-compatible facade (`compat`), `utils` (timing, guards,
checkpoints) and `viz` (plots).  Its kernel
engines are CUDA C++ written for Hopper (sm_90a), built with nvcc at first
use: the fused backward pass (``backward='pallas'``,
`ops/fused_riccati.py`, with GNMS defects), the rollout kernels of the
line search and the initial rollout (``rollout='pallas'``,
`ops/fused_rollout.py`), the
multi-candidate affine prefix scan (``defect_engine`` and
``MsConfig.update_engine`` 'pallas', `ops/affine_scan.py`), the batched
backward pass and rollouts of batched solves (`ops/batched.py`), and the
standalone Riccati suffix scan of the limited, DDP and iLQG parallel
passes (`ops/suffix_scan.py`).  On CPU tensors every kernel wrapper runs
its plain PyTorch version.  Systems are built on the GPU unless the caller
names another device, and the entry points run on the system's device.
Nothing here imports JAX.
"""
from ilqr_tpu_torch.models.base import (
    INTEGRATORS,
    System,
    full_f32_matmuls,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)
from ilqr_tpu_torch.models.car import make_car, obstacle_constraints
from ilqr_tpu_torch.models.cartpole import make_cartpole
from ilqr_tpu_torch.models.chain import make_spring_chain
from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum
from ilqr_tpu_torch.models.linear import (
    cont2disc,
    make_discrete_lti,
    make_lti,
)
from ilqr_tpu_torch.models.neural import fit_dynamics, make_neural_residual
from ilqr_tpu_torch.models.pendulum import make_pendulum
from ilqr_tpu_torch.models.quadrotor import make_quadrotor
from ilqr_tpu_torch.models.quadrotor3d import (
    make_quadrotor3d,
    make_quadrotor3d_rotor,
)
from ilqr_tpu_torch.models.rate import (
    make_rate_penalized_system,
    rate_augment_x0,
    strip_rate,
)
from ilqr_tpu_torch.models.tracking import (
    augment_x0,
    make_tracking_system,
    strip_clock,
)
from ilqr_tpu_torch.ilqg import (
    NoiseExpansion,
    additive_noise,
    control_multiplicative_noise,
    noise_expansion,
    noise_expansion_batched,
    simulate_closed_loop,
)
from ilqr_tpu_torch.ops.affine_scan import (
    affine_prefix_scan_batched,
    affine_prefix_scan_multi,
)
from ilqr_tpu_torch.ops.batched import (
    backward_pass_batched,
    closed_loop_rollout_batched,
    linesearch_costs_batched,
    open_loop_rollout_batched,
)
from ilqr_tpu_torch.ops.boxqp import boxqp, boxqp_with_gains
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.ops.fused_rollout import (
    closed_loop_rollout_fused,
    linesearch_costs_fused,
    open_loop_rollout_fused,
)
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.lqr import LqrSolution, lqr_backward, lqr_solve
from ilqr_tpu_torch.ops.limited_parallel import backward_pass_limited_parallel
from ilqr_tpu_torch.ops.linearize import (
    DynamicsHessians,
    TrajectoryExpansion,
    dynamics_hessians,
    dynamics_hessians_batched,
    linearize_trajectory,
    linearize_trajectory_batched,
)
from ilqr_tpu_torch.ops.parallel_riccati import (
    backward_pass_associative,
    backward_pass_ddp_parallel,
)
from ilqr_tpu_torch.ops.riccati import backward_pass, backward_pass_limited
from ilqr_tpu_torch.ops.rollout import (
    closed_loop_rollout,
    linesearch_rollouts,
    rollout,
)
from ilqr_tpu_torch.ops.suffix_scan import (
    backward_pass_suffix_scan,
    suffix_scan_fused,
)
from ilqr_tpu_torch.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    MAXITER,
    IlqrConfig,
    IlqrSolution,
    solve,
    solve_batch,
)
from ilqr_tpu_torch.shooting import (
    MsConfig,
    MsSolution,
    interpolate_states,
    solve_ms,
)
from ilqr_tpu_torch.constrained import (
    INFEASIBLE,
    AlConfig,
    ConstrainedSolution,
    ConstraintSet,
    box_control_constraints,
    goal_constraint,
    merge_constraints,
    solve_constrained,
    solve_constrained_ms,
    state_bound_constraints,
)
from ilqr_tpu_torch.barrier import (
    BarrierConfig,
    BarrierSolution,
    relaxed_log_barrier,
    solve_barrier,
)
from ilqr_tpu_torch.mpc import (
    ConstrainedMpcResult,
    MpcResult,
    run_mpc,
    run_mpc_barrier,
    run_mpc_batched,
    run_mpc_constrained,
    run_mpc_ms,
    run_mpc_rti,
)
from ilqr_tpu_torch.tracking import track, track_solution, tvlqr_gains
from ilqr_tpu_torch.diff import IftConfig, run_mpc_implicit, solve_implicit
from ilqr_tpu_torch.mppi import MppiConfig, mppi_update, run_mpc_mppi, solve_mppi
from ilqr_tpu_torch.parallel import (
    run_mpc_sharded,
    solve_batched,
    solve_multistart,
)

__version__ = "0.1.0"

__all__ = [
    "System", "INTEGRATORS", "full_f32_matmuls", "quadratic_cost_params",
    "quadratic_stage_cost", "quadratic_terminal_cost",
    "make_pendulum", "make_double_pendulum", "make_cartpole",
    "make_quadrotor", "make_quadrotor3d", "make_quadrotor3d_rotor",
    "make_car", "obstacle_constraints", "make_lti", "make_discrete_lti",
    "cont2disc", "make_spring_chain", "make_tracking_system", "augment_x0",
    "strip_clock", "make_rate_penalized_system", "rate_augment_x0",
    "strip_rate", "make_neural_residual", "fit_dynamics", "lqr_backward",
    "lqr_solve", "LqrSolution",
    "tvlqr_gains", "track", "track_solution", "step",
    "TrajectoryExpansion", "linearize_trajectory",
    "linearize_trajectory_batched",
    "backward_pass", "backward_pass_associative", "backward_pass_fused",
    "backward_pass_batched", "backward_pass_limited",
    "backward_pass_limited_parallel", "backward_pass_ddp_parallel",
    "backward_pass_suffix_scan", "suffix_scan_fused",
    "boxqp", "boxqp_with_gains", "DynamicsHessians", "dynamics_hessians",
    "dynamics_hessians_batched", "NoiseExpansion", "noise_expansion",
    "noise_expansion_batched", "simulate_closed_loop",
    "additive_noise", "control_multiplicative_noise",
    "rollout", "closed_loop_rollout", "linesearch_rollouts",
    "linesearch_costs_fused", "closed_loop_rollout_fused",
    "open_loop_rollout_fused",
    "linesearch_costs_batched", "closed_loop_rollout_batched",
    "open_loop_rollout_batched",
    "affine_prefix_scan_batched",
    "affine_prefix_scan_multi",
    "solve", "solve_batch", "IlqrConfig", "IlqrSolution",
    "CONVERGED", "LINESEARCH_FAILED", "MAXITER",
    "solve_ms", "MsConfig", "MsSolution", "interpolate_states",
    "solve_constrained", "solve_constrained_ms",
    "ConstraintSet", "ConstrainedSolution", "AlConfig",
    "box_control_constraints", "goal_constraint", "state_bound_constraints",
    "merge_constraints", "INFEASIBLE",
    "solve_barrier", "BarrierConfig", "BarrierSolution", "relaxed_log_barrier",
    "MpcResult", "run_mpc", "run_mpc_rti", "run_mpc_batched", "run_mpc_ms",
    "ConstrainedMpcResult", "run_mpc_constrained", "run_mpc_barrier",
    "solve_batched", "solve_multistart", "run_mpc_sharded",
    "solve_implicit", "run_mpc_implicit", "IftConfig",
    "solve_mppi", "mppi_update", "run_mpc_mppi", "MppiConfig",
]
