"""Receding-horizon MPC: a warm-started iLQR solve per simulated step.

PyTorch counterpart of `ilqr_tpu/mpc.py`.  At each step the horizon problem
is solved from the current state with a small iteration budget, the first
control is applied to a plant model (which may differ from the solver's),
and the solution is shifted and held as the next warm start
(``U_next = concat(U[1:], U[-1:])``).  The JAX package runs the loop as one
``lax.scan``; here it is a host loop over ``n_sim`` steps, each one solve.

* `run_mpc`: the loop above, with the parallel line-search latch carried
  across steps as JAX carries it (``_LATCH_COOLDOWN``).
* `run_mpc_rti`: re-solve every ``resolve_every`` steps and track the plan
  with its own gains in between, ``u = U[j] + K[j] (x − X[j])``.
* `run_mpc_batched`: B closed loops in step, one `solver.solve_batch` per
  simulated step, each instance with its own latch cooldown — what
  ``jax.vmap(run_mpc)`` returns per instance.
* `run_mpc_ms`: the loop on the multiple-shooting solver, with the states
  shifted and held as well.
* `run_mpc_constrained`: the loop on the augmented-Lagrangian solver, with
  the stage multipliers shifted and held and the penalty carried.
* `run_mpc_barrier`: the loop on the relaxed-barrier solver at a fixed
  (μ, δ).

The JAX loops resolve 'auto' engines to parallel-in-time ones on a TPU
(``auto_parallel``, from TPU timings); the port has no such rule, so
'auto' means the sequential engines here.  Every loop runs on the solver system's device and dtype; x0 and U_init
(tensors on any device, or numpy arrays) move there.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ilqr_tpu_torch.barrier import BarrierConfig, solve_barrier
from ilqr_tpu_torch.constrained import (
    AlConfig,
    constraint_sizes,
    prepare,
    solve_constrained,
)
from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.rollout import rollout
from ilqr_tpu_torch.shooting import MsConfig, solve_ms
from ilqr_tpu_torch.solver import IlqrConfig, solve, solve_batch

# Steps to keep the parallel line search off after a solve that ended with
# its latch down, before probing it again; 0 probes every solve, as in the
# JAX package.
_LATCH_COOLDOWN = 0


@dataclasses.dataclass(frozen=True)
class MpcResult:
    """A closed-loop run; from `run_mpc_batched` every field leads with B."""

    X: Any             # (n_sim+1, n_x) closed-loop state trajectory
    U: Any             # (n_sim, n_u) applied controls
    cost: Any          # 0-d: plant stage costs along the loop + terminal
    solve_iters: Any   # (n_solves,) iLQR iterations of each solve
    solve_status: Any  # (n_solves,) status of each solve


def _next_cooldown(latch, cooldown):
    """The cooldown after a solve that ended with ``latch``: bools and
    ints, or per instance (B,) tensors."""
    if torch.is_tensor(latch):
        return torch.where(latch, 0, torch.where(
            cooldown == 0, _LATCH_COOLDOWN, cooldown - 1))
    if latch:
        return 0
    return _LATCH_COOLDOWN if cooldown == 0 else cooldown - 1


def _shift(T: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift-and-hold along the time axis (-2): drop the first ``n`` rows,
    repeat the last ``n`` times."""
    last = T[..., -1:, :].expand(T.shape[:-2] + (n, T.shape[-1]))
    return torch.cat([T[..., n:, :], last], dim=-2)


def _result(system: System, xs, us, costs, x_N, iters, status) -> MpcResult:
    """Stack a loop's records; the cost is the sum of the plant's stage
    costs plus its terminal cost at the final state.  The solve records are
    Python ints (one instance) or (B,) tensors (a batch)."""
    def record(values):
        if torch.is_tensor(values[0]):
            return torch.stack(values, dim=-1)
        return torch.tensor(values, device=x_N.device)

    cost = (torch.stack(costs).sum(0)
            + system.terminal_cost(system.params, x_N))
    return MpcResult(
        X=torch.stack(xs + [x_N], dim=-2), U=torch.stack(us, dim=-2),
        cost=cost, solve_iters=record(iters), solve_status=record(status))


@full_f32_matmuls()
def run_mpc(
    solver_system: System,
    plant_system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
) -> MpcResult:
    """Closed-loop MPC from x0 with the first warm start U_init (N, n_u)."""
    x0, U_init = solver_system.inputs(x0, U_init)
    x, U_warm, cooldown = x0, U_init, 0
    xs, us, costs, iters, status = [], [], [], [], []
    for _ in range(n_sim):
        sol = solve(solver_system, x, U_warm, config,
                    defect_latch=cooldown == 0)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        costs.append(plant_system.stage_cost(plant_system.params, x, u0))
        iters.append(sol.iterations)
        status.append(sol.status)
        x = step(plant_system, x, u0)
        U_warm = _shift(sol.U)
        cooldown = _next_cooldown(sol.defect_latch, cooldown)
    return _result(plant_system, xs, us, costs, x, iters, status)


@full_f32_matmuls()
def run_mpc_rti(
    solver_system: System,
    plant_system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    resolve_every: int = 1,
) -> MpcResult:
    """Real-time-iteration MPC: solve every ``resolve_every`` steps and
    track the plan in between with its gains, ``u = U[j] + K[j] (x − X[j])``,
    clipped to the control limits when the config has them; the warm start
    shifts by the block length.  ``n_sim`` must be divisible by
    ``resolve_every``; the solve records have n_sim / resolve_every
    entries."""
    if n_sim % resolve_every != 0:
        raise ValueError(
            f"n_sim={n_sim} not divisible by resolve_every={resolve_every}")
    x0, U_init = solver_system.inputs(x0, U_init)
    limits = config.limit_arrays(U_init.shape[-1], U_init.dtype,
                                 U_init.device)
    x, U_warm, cooldown = x0, U_init, 0
    xs, us, costs, iters, status = [], [], [], [], []
    for _ in range(n_sim // resolve_every):
        sol = solve(solver_system, x, U_warm, config,
                    defect_latch=cooldown == 0)
        for j in range(resolve_every):
            u = sol.U[j] + sol.K[j] @ (x - sol.X[j])
            if limits is not None:
                u = torch.clamp(u, *limits)
            xs.append(x)
            us.append(u)
            costs.append(plant_system.stage_cost(plant_system.params, x, u))
            x = step(plant_system, x, u)
        iters.append(sol.iterations)
        status.append(sol.status)
        U_warm = _shift(sol.U, resolve_every)
        cooldown = _next_cooldown(sol.defect_latch, cooldown)
    return _result(plant_system, xs, us, costs, x, iters, status)


@full_f32_matmuls()
def run_mpc_batched(
    solver_system: System,
    plant_system: System,
    x0_batch: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
) -> MpcResult:
    """B closed loops from x0_batch (B, n_x) in step, with the first warm
    start U_init (N, n_u) shared or (B, N, n_u).  Every field of the result
    gains a leading B axis.

    Each simulated step is one `solve_batch` of all B problems, under
    every option it takes (limits, DDP, iLQG, adaptive_reg, the parallel
    line searches, each instance on its own); each instance carries its
    own latch cooldown across steps, as `run_mpc` does."""
    x0_batch, U_init = solver_system.inputs(x0_batch, U_init)
    x = x0_batch
    U_warm = U_init.expand((x.shape[0],) + tuple(U_init.shape[-2:]))
    cooldown = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    xs, us, costs, iters, status = [], [], [], [], []
    for _ in range(n_sim):
        sol = solve_batch(solver_system, x, U_warm, config,
                          defect_latch=cooldown == 0)
        u0 = sol.U[:, 0]
        xs.append(x)
        us.append(u0)
        costs.append(plant_system.stage_cost(plant_system.params, x, u0))
        iters.append(sol.iterations)
        status.append(sol.status)
        x = step(plant_system, x, u0)
        U_warm = _shift(sol.U)
        cooldown = _next_cooldown(sol.defect_latch, cooldown)
    return _result(plant_system, xs, us, costs, x, iters, status)


@full_f32_matmuls()
def run_mpc_ms(
    solver_system: System,
    plant_system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    ms: MsConfig | None = None,
) -> MpcResult:
    """Closed-loop MPC on the multiple-shooting solver (`solve_ms`): the
    controls and the state nodes are both shifted and held,
    ``X_next = concat(X[1:], X[-1:])``.  The shifted plan does not start at
    the measured state; `solve_ms` takes it as it is and closes the gap as
    one more defect.  The first nodes are the rollout of U_init.  With
    ``config.maxiter=1`` this is one Gauss-Newton iteration per step."""
    if ms is None:
        ms = MsConfig()
    x0, U_init = solver_system.inputs(x0, U_init)
    X_warm, _ = rollout(solver_system, x0, U_init)
    x, U_warm = x0, U_init
    xs, us, costs, iters, status = [], [], [], [], []
    for _ in range(n_sim):
        sol = solve_ms(solver_system, x, U_warm, X_init=X_warm,
                       config=config, ms=ms)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        costs.append(plant_system.stage_cost(plant_system.params, x, u0))
        iters.append(sol.iterations)
        status.append(sol.status)
        x = step(plant_system, x, u0)
        U_warm, X_warm = _shift(sol.U), _shift(sol.X)
    return _result(plant_system, xs, us, costs, x, iters, status)


@dataclasses.dataclass(frozen=True)
class ConstrainedMpcResult:
    X: Any             # (n_sim+1, n_x) closed-loop state trajectory
    U: Any             # (n_sim, n_u) applied controls
    cost: Any          # 0-d: plant stage costs along the loop + terminal
    violation: Any     # (n_sim,) per-step max constraint violation at the plan
    solve_iters: Any   # (n_sim,) inner iLQR iterations used per step
    solve_status: Any  # (n_sim,) per-step solver status


def _constrained_result(system: System, xs, us, costs, x_N, viols, iters,
                        status) -> ConstrainedMpcResult:
    res = _result(system, xs, us, costs, x_N, iters, status)
    return ConstrainedMpcResult(
        X=res.X, U=res.U, cost=res.cost, violation=torch.stack(viols),
        solve_iters=res.solve_iters, solve_status=res.solve_status)


@full_f32_matmuls()
def run_mpc_constrained(
    solver_system: System,
    plant_system: System,
    constraints,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    al_config: AlConfig | None = None,
) -> ConstrainedMpcResult:
    """Receding-horizon MPC with general constraints (augmented
    Lagrangian).  Each step runs `solve_constrained` with a small budget,
    warm-started on the shifted controls AND the shifted stage multipliers
    (terminal multipliers and the penalty carried as they are), so across
    steps the multipliers converge (the ALTRO-MPC pattern).  The first
    step starts cold: zero multipliers of the shapes one call of each
    constraint callable at (x0, U_init[0]) gives, and ``al_config.mu0``."""
    if al_config is None:
        al_config = AlConfig(max_outer=3, ctol=1e-3)
    cons, x0, U_init = prepare(solver_system, constraints, x0, U_init)
    N = U_init.shape[0]
    n_gi, n_he, n_gti, n_hte = constraint_sizes(cons, x0, U_init[0])
    zeros = lambda *shape: U_init.new_zeros(shape)
    lams = dict(gi=zeros(N, n_gi), he=zeros(N, n_he), gti=zeros(n_gti),
                hte=zeros(n_hte))
    x, U_warm, mu = x0, U_init, al_config.mu0
    xs, us, costs, viols, iters, status = [], [], [], [], [], []
    for _ in range(n_sim):
        sol = solve_constrained(solver_system, cons, x, U_warm, config,
                                al_config, lam_init=lams, mu_init=mu)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        costs.append(plant_system.stage_cost(plant_system.params, x, u0))
        viols.append(sol.violation)
        iters.append(sol.inner_iterations)
        status.append(sol.status)
        x = step(plant_system, x, u0)
        U_warm = _shift(sol.U)
        lams = dict(gi=_shift(sol.lam_stage_ineq), he=_shift(sol.lam_stage_eq),
                    gti=sol.lam_terminal_ineq, hte=sol.lam_terminal_eq)
        mu = sol.mu
    return _constrained_result(plant_system, xs, us, costs, x, viols, iters,
                               status)


@full_f32_matmuls()
def run_mpc_barrier(
    solver_system: System,
    plant_system: System,
    constraints,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    mu: float = 1e-2,
    delta: float = 0.05,
) -> ConstrainedMpcResult:
    """Relaxed-barrier MPC at a FIXED (μ, δ) every step (Feller & Ebenbauer
    2017): each step solves one smooth barrier-penalized problem from the
    shifted warm start, so the per-step work is constant; infeasible states
    get finite costs and the controller steers back to the interior."""
    bc = BarrierConfig(n_outer=1, mu0=mu, delta=delta, delta_factor=1.0)
    x0, U_init = solver_system.inputs(x0, U_init)
    x, U_warm = x0, U_init
    xs, us, costs, viols, iters, status = [], [], [], [], [], []
    for _ in range(n_sim):
        sol = solve_barrier(solver_system, constraints, x, U_warm, config, bc)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        costs.append(plant_system.stage_cost(plant_system.params, x, u0))
        viols.append(sol.violation)
        iters.append(sol.inner_iterations)
        status.append(sol.status)
        x = step(plant_system, x, u0)
        U_warm = _shift(sol.U)
    return _constrained_result(plant_system, xs, us, costs, x, viols, iters,
                               status)
