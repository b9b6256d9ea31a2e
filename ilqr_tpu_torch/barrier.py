"""Relaxed log-barrier constrained iLQR (interior-point style).

PyTorch counterpart of `ilqr_tpu/barrier.py`.  Inequality constraints

    min_{U}  Σ l(x_k, u_k) + l_f(x_N)
    s.t.     g(x_k, u_k) <= 0   (stage),   g_f(x_N) <= 0   (terminal)

are handled by adding the RELAXED log-barrier penalty  μ Σ β(−g_i; δ)  to
the cost, where β(z; δ) = −ln z for z ≥ δ and the C² quadratic extension

    β(z; δ) = ((z − 2δ)² / δ² − 1) / 2 − ln δ         for z < δ

below it (Feller & Ebenbauer 2017).  The relaxed barrier is defined
everywhere: no strictly feasible start is needed, and infeasible
line-search candidates get large but finite costs.  An outer loop shrinks μ
(and δ) along the central path; each inner problem is a smooth iLQR solve
(`constrained.penalized_inner_solve`), so every backward-pass engine
composes: ``config.backward='pallas'`` runs kernel B1.  The JAX package
runs the μ-schedule as a `lax.scan`; here it is a host loop.
"""
from __future__ import annotations

import dataclasses

import torch

from ilqr_tpu_torch.constrained import (
    INFEASIBLE,
    ConstraintSet,
    _violations,
    add_terms,
    constraint_sizes,
    penalized_inner_solve,
    prepare,
    stage_map,
    terminal_map,
)
from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.solver import CONVERGED, LINESEARCH_FAILED, IlqrConfig

_fn = torch.func


# --------------------------------------------------------------------------
# Relaxed log-barrier β(z; δ) on the slack z = −g (feasible ⇔ z > 0).
# C² everywhere; convex; β'' > 0, so the Gauss-Newton penalty Hessian
# Σ μ β''(z_i) ∇g_i ∇g_iᵀ is PSD by construction.
# --------------------------------------------------------------------------

def relaxed_log_barrier(z, delta):
    """β(z; δ): −ln z for z ≥ δ, quadratic C² extension below."""
    delta = torch.as_tensor(delta, dtype=z.dtype, device=z.device)
    zs = torch.maximum(z, delta)        # guard: ln only sees z ≥ δ > 0
    log_part = -torch.log(zs)
    quad_part = (0.5 * (((z - 2.0 * delta) / delta) ** 2 - 1.0)
                 - torch.log(delta))
    return torch.where(z >= delta, log_part, quad_part)


def _beta_d1(z, delta):
    """β'(z; δ)."""
    delta = torch.as_tensor(delta, dtype=z.dtype, device=z.device)
    zs = torch.maximum(z, delta)
    return torch.where(z >= delta, -1.0 / zs,
                       (z - 2.0 * delta) / (delta * delta))


def _beta_d2(z, delta):
    """β''(z; δ) > 0."""
    delta = torch.as_tensor(delta, dtype=z.dtype, device=z.device)
    zs = torch.maximum(z, delta)
    return torch.where(z >= delta, 1.0 / (zs * zs), 1.0 / (delta * delta))


@dataclasses.dataclass(frozen=True)
class BarrierConfig:
    """Outer-loop (central-path) configuration: the fields, defaults and
    validation of `ilqr_tpu.barrier.BarrierConfig`."""

    n_outer: int = 6            # μ-schedule length (fixed trip count)
    mu0: float = 1.0            # initial barrier weight
    mu_factor: float = 0.2      # μ shrink per outer iteration (< 1)
    delta: float = 0.1          # initial relaxation threshold on the slack
    # δ shrinks WITH μ: the infeasible branch's stiffness is μ/δ², so a
    # fixed δ would let violations grow as μ → 0.  None → mu_factor.
    delta_factor: float = None
    ctol: float = 1e-3          # violation tolerance for the CONVERGED status

    def __post_init__(self):
        if self.n_outer < 1:
            raise ValueError(f"n_outer must be >= 1, got {self.n_outer}")
        if not 0.0 < self.mu_factor < 1.0:
            raise ValueError(
                f"mu_factor must be in (0, 1), got {self.mu_factor}")
        if self.delta <= 0.0:
            raise ValueError(f"delta must be > 0, got {self.delta}")
        if self.delta_factor is not None and not 0.0 < self.delta_factor <= 1.0:
            raise ValueError(
                f"delta_factor must be in (0, 1], got {self.delta_factor}")


@dataclasses.dataclass(frozen=True)
class BarrierSolution:
    X: torch.Tensor                # (N+1, n_x) final trajectory
    U: torch.Tensor                # (N, n_u) final controls
    cost: torch.Tensor             # 0-d TRUE cost (no barrier terms)
    violation: torch.Tensor        # 0-d max constraint violation
    status: int                    # CONVERGED / LINESEARCH_FAILED / INFEASIBLE
    inner_iterations: int          # total iLQR iterations across the schedule
    mu: torch.Tensor               # 0-d final barrier weight
    violation_trace: torch.Tensor  # (n_outer,) max violation per outer iter
    cost_trace: torch.Tensor       # (n_outer,) true cost per outer iter


def _stage_barrier(cons, mu, delta, x, u):
    g = cons.stage_ineq(cons.params, x, u)
    return mu * torch.sum(relaxed_log_barrier(-g, delta))


def _terminal_barrier(cons, mu, delta, x):
    g = cons.terminal_ineq(cons.params, x)
    return mu * torch.sum(relaxed_log_barrier(-g, delta))


def _barrier_traj_cost(cons, mu, delta, X, U, base_cost):
    """True cost + barrier penalty of trajectories; leading axes batch."""
    pen = stage_map(lambda x, u: _stage_barrier(cons, mu, delta, x, u),
                    X, U).sum(-1)
    pen = pen + terminal_map(
        lambda x: _terminal_barrier(cons, mu, delta, x), X)
    return base_cost + pen


def _augment_expansion(exp: TrajectoryExpansion, cons, mu, delta, X, U
                       ) -> TrajectoryExpansion:
    """Add the barrier's exact gradient and Gauss-Newton Hessian to the
    trajectory expansion (constraint curvature dropped; β'' > 0 keeps the
    added blocks PSD)."""

    def stage_terms(x, u):
        pen = lambda xx, uu: _stage_barrier(cons, mu, delta, xx, uu)
        p_x, p_u = _fn.grad(pen, argnums=(0, 1))(x, u)
        g = cons.stage_ineq(cons.params, x, u)
        gx, gu = _fn.jacfwd(cons.stage_ineq, argnums=(1, 2))(cons.params,
                                                             x, u)
        w = mu * _beta_d2(-g, delta)            # (n_g,) positive weights
        p_xx = (gx.mT * w) @ gx
        p_uu = (gu.mT * w) @ gu
        p_ux = (gu.mT * w) @ gx
        return p_x, p_u, p_xx, p_ux, p_uu

    xN = X[-1]
    t_x = _fn.grad(lambda xx: _terminal_barrier(cons, mu, delta, xx))(xN)
    gt = cons.terminal_ineq(cons.params, xN)
    gtx = _fn.jacfwd(cons.terminal_ineq, argnums=1)(cons.params, xN)
    w_t = mu * _beta_d2(-gt, delta)
    t_xx = (gtx.mT * w_t) @ gtx
    return add_terms(exp, stage_map(stage_terms, X, U), (t_x, t_xx))


def _inner_solve(system, cons, x0, U_init, mu, delta, config: IlqrConfig):
    """iLQR on the barrier-augmented cost."""
    return penalized_inner_solve(
        system, x0, U_init, config,
        lambda exp, X, U: _augment_expansion(exp, cons, mu, delta, X, U),
        lambda X, U, base: _barrier_traj_cost(cons, mu, delta, X, U, base))


@full_f32_matmuls()
def solve_barrier(
    system: System,
    constraints: ConstraintSet,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    barrier_config: BarrierConfig = BarrierConfig(),
) -> BarrierSolution:
    """Solve the inequality-constrained problem on the central path, on the
    system's device and dtype.

    Inequality constraints only: equality constraints go to
    `solve_constrained` (a log-barrier has no interior for h = 0).  The
    inner problems are smooth, so ``config`` may select any backward
    engine.
    """
    cons, x0, U_init = prepare(system, constraints, x0, U_init)
    n_gi, n_he, n_gti, n_hte = constraint_sizes(cons, x0, U_init[0])
    if n_he + n_hte > 0:
        raise ValueError(
            "barrier solver handles inequality constraints only; "
            "use solve_constrained for equality constraints")
    if n_gi + n_gti == 0:
        raise ValueError("constraint set is empty; use ilqr_tpu_torch.solve "
                         "instead")

    dtype, device = U_init.dtype, U_init.device
    bc = barrier_config
    js = torch.arange(bc.n_outer, dtype=dtype, device=device)
    mus = bc.mu0 * bc.mu_factor ** js
    dfac = bc.mu_factor if bc.delta_factor is None else bc.delta_factor
    deltas = bc.delta * dfac ** js

    U, inner_total = U_init, 0
    costs, viols = [], []
    for mu, delta in zip(mus, deltas):
        X, U, base_cost, k_inner, status = _inner_solve(
            system, cons, x0, U, mu, delta, config)
        costs.append(base_cost)
        viols.append(_violations(cons, X, U))
        inner_total += k_inner

    viol_f = viols[-1]
    if viol_f.cpu().numpy() <= bc.ctol:   # compared in the dtype, as JAX
        status = CONVERGED
    elif status != LINESEARCH_FAILED:
        status = INFEASIBLE
    return BarrierSolution(
        X=X, U=U, cost=costs[-1], violation=viol_f, status=status,
        inner_iterations=inner_total, mu=mus[-1],
        violation_trace=torch.stack(viols), cost_trace=torch.stack(costs),
    )
