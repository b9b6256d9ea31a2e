"""Augmented-Lagrangian constrained iLQR (ALTRO-style).

PyTorch counterpart of `ilqr_tpu/constrained.py`.  It solves

    min_{U}  Σ l(x_k, u_k) + l_f(x_N)
    s.t.     g(x_k, u_k) <= 0,   h(x_k, u_k) = 0      (stage, k = 0..N-1)
             g_f(x_N)   <= 0,    h_f(x_N)   = 0       (terminal)

by the Powell-Hestenes-Rockafellar augmented Lagrangian: an outer loop
updates the multipliers and the penalty, an inner iLQR minimizes the
augmented cost.  The JAX package runs both loops as `lax.while_loop`s; here
they are host loops, with one host read per inner iteration (the candidate
costs and the backward pass's finite flag together) and one per outer
iteration (violation and cost).  The multiple-shooting inner solve reads
twice per iteration, as `shooting.solve_ms` does.

The penalty's gradient and Gauss-Newton Hessian are added to the
trajectory-wide `TrajectoryExpansion` (`torch.func` derivatives of the
constraints, vmapped over time), so every backward-pass engine composes
unchanged: ``config.backward='pallas'`` runs kernel B1, and the
multiple-shooting solve with ``MsConfig(update_engine='pallas')`` runs B1d
and B3.  Line-search candidates are scored under the exact augmented cost,
and the first α that does not raise it is accepted.  With
``config.rollout='pallas'`` the candidates are rolled out by the B2
kernels' trajectory entry, one launch per α, and the first rollout of each
inner solve by their open-loop entry; any other rollout engine runs the
plain batched rollouts (the JAX inner solve has one engine, an XLA scan).

Constraint callables take (params, x[, u]) with tensors and return 1-D
residuals.  They are called under `torch.func.vmap`, so they may be
written for one state.  Their parameters move to the system's device and
dtype at each solve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ilqr_tpu_torch.models.base import DEFAULT_DEVICE, System, full_f32_matmuls
from ilqr_tpu_torch.ops.fused_rollout import (
    closed_loop_rollout_fused,
    open_loop_rollout_fused,
)
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion, linearize_trajectory
from ilqr_tpu_torch.ops.rollout import linesearch_rollouts, rollout
from ilqr_tpu_torch.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    RUNNING,
    IlqrConfig,
    _backward,
)

# Additional status: AL outer loop exhausted with violation above tolerance.
INFEASIBLE = 4

_fn = torch.func


def _zero_con(params, x, *args):
    """Placeholder for an absent constraint block: a zero-size residual on
    x's device and dtype (a slice of x, so `vmap` and `jacfwd` carry it)."""
    return x[..., :0]


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Constraint functions as pure callables over (params, x[, u]).

    Residual conventions: inequality ``g(x,u) <= 0`` elementwise; equality
    ``h(x,u) = 0``.  Absent blocks default to zero-size residuals, so all
    downstream algebra is uniform.  ``params`` is a tensor, a (nested) dict
    of tensors, or None.
    """

    params: Any = None
    stage_ineq: Callable = _zero_con
    stage_eq: Callable = _zero_con
    terminal_ineq: Callable = _zero_con
    terminal_eq: Callable = _zero_con


def _params_to(p, device, dtype):
    """Constraint parameters (tensors, nested dicts of them) as tensors on
    device and dtype."""
    if p is None:
        return None
    if isinstance(p, dict):
        return {k: _params_to(v, device, dtype) for k, v in p.items()}
    return torch.as_tensor(p, dtype=dtype, device=device)


def box_control_constraints(u_min, u_max, *, device=DEFAULT_DEVICE,
                            dtype=torch.float32) -> ConstraintSet:
    """``u_min <= u <= u_max`` as a stage inequality block."""

    def g(params, x, u):
        return torch.cat([u - params["hi"], params["lo"] - u])

    return ConstraintSet(params=_params_to(dict(lo=u_min, hi=u_max), device,
                                           dtype),
                         stage_ineq=g)


def state_bound_constraints(x_min, x_max, terminal: bool = True, *,
                            device=DEFAULT_DEVICE,
                            dtype=torch.float32) -> ConstraintSet:
    """``x_min <= x <= x_max`` as stage (and optionally terminal)
    inequalities.  Bounds must be finite, of shape (n_x,): for a one-sided
    bound pick a large finite sentinel for the free side (±inf would poison
    the penalty terms)."""

    def g(params, x, u):
        return torch.cat([x - params["hi"], params["lo"] - x])

    def g_term(params, x):
        return torch.cat([x - params["hi"], params["lo"] - x])

    return ConstraintSet(
        params=_params_to(dict(lo=x_min, hi=x_max), device, dtype),
        stage_ineq=g,
        terminal_ineq=g_term if terminal else _zero_con,
    )


def goal_constraint(x_goal, *, device=DEFAULT_DEVICE,
                    dtype=torch.float32) -> ConstraintSet:
    """Exact terminal state ``x_N = x_goal`` as a terminal equality block."""

    def h(params, x):
        return x - params["x_goal"]

    return ConstraintSet(params=_params_to(dict(x_goal=x_goal), device, dtype),
                         terminal_eq=h)


def merge_constraints(a: ConstraintSet, b: ConstraintSet) -> ConstraintSet:
    """Concatenate two constraint sets into one (residuals stacked)."""

    def cat(fa, fb):
        def f(params, *args):
            return torch.cat([fa(params["a"], *args), fb(params["b"], *args)])
        return f

    return ConstraintSet(
        params=dict(a=a.params, b=b.params),
        stage_ineq=cat(a.stage_ineq, b.stage_ineq),
        stage_eq=cat(a.stage_eq, b.stage_eq),
        terminal_ineq=cat(a.terminal_ineq, b.terminal_ineq),
        terminal_eq=cat(a.terminal_eq, b.terminal_eq),
    )


@dataclasses.dataclass(frozen=True)
class AlConfig:
    """Outer-loop (augmented-Lagrangian) configuration: the fields,
    defaults and validation of `ilqr_tpu.constrained.AlConfig`."""

    max_outer: int = 20
    ctol: float = 1e-4          # max-violation convergence tolerance
    mu0: float = 1.0            # initial penalty
    mu_factor: float = 10.0     # penalty escalation per outer iteration
    mu_max: float = 1e8
    lam_max: float = 1e8        # multiplier clamp (safeguard)
    # Escalate mu only when the multiplier update alone is too slow: the
    # violation must shrink by this factor per outer iteration to hold mu.
    viol_decrease: float = 0.25

    def __post_init__(self):
        if self.max_outer < 1:
            raise ValueError(f"max_outer must be >= 1, got {self.max_outer}")
        if self.mu_factor <= 1.0:
            raise ValueError(
                f"mu_factor must be > 1, got {self.mu_factor}")


@dataclasses.dataclass(frozen=True)
class ConstrainedSolution:
    X: torch.Tensor             # (N+1, n_x) final trajectory
    U: torch.Tensor             # (N, n_u) final controls
    cost: torch.Tensor          # 0-d TRUE cost (no penalty terms)
    violation: torch.Tensor     # 0-d max constraint violation
    status: int                 # CONVERGED / LINESEARCH_FAILED / INFEASIBLE
    outer_iterations: int       # AL outer iterations executed
    inner_iterations: int       # total iLQR iterations across outer loop
    lam_stage_ineq: torch.Tensor     # (N, n_gi) final multipliers
    lam_stage_eq: torch.Tensor       # (N, n_he)
    lam_terminal_ineq: torch.Tensor  # (n_gti,)
    lam_terminal_eq: torch.Tensor    # (n_hte,)
    mu: torch.Tensor                 # 0-d final penalty
    violation_trace: torch.Tensor    # (max_outer,) max violation per outer
    cost_trace: torch.Tensor         # (max_outer,) true cost per outer


# --------------------------------------------------------------------------
# PHR penalty pieces.
#
# Inequality g <= 0:  phi(g; lam, mu) = (max(0, lam + mu g)^2 - lam^2) / (2 mu)
#   d phi / d g      = max(0, lam + mu g)            (the "effective" rho)
#   GN  d2 phi / dg2 = mu * 1[lam + mu g > 0]
# Equality h = 0:     phi(h; lam, mu) = lam h + (mu/2) h^2
#   d phi / d h = lam + mu h ;  d2 = mu
# Multiplier updates: lam <- max(0, lam + mu g) ;  lam <- lam + mu h.
# --------------------------------------------------------------------------

def _phi_ineq(g, lam, mu):
    rho = torch.clamp(lam + mu * g, min=0.0)
    return torch.sum((rho * rho - lam * lam) / (2.0 * mu))


def _phi_eq(h, lam, mu):
    return torch.sum(lam * h + 0.5 * mu * h * h)


def _stage_penalty(cons, lam_gi, lam_he, mu, x, u):
    g = cons.stage_ineq(cons.params, x, u)
    h = cons.stage_eq(cons.params, x, u)
    return _phi_ineq(g, lam_gi, mu) + _phi_eq(h, lam_he, mu)


def _terminal_penalty(cons, lam_gti, lam_hte, mu, x):
    g = cons.terminal_ineq(cons.params, x)
    h = cons.terminal_eq(cons.params, x)
    return _phi_ineq(g, lam_gti, mu) + _phi_eq(h, lam_hte, mu)


def stage_map(fn, X, U, *per_stage):
    """``fn(*per_stage rows, x_k, u_k)`` over every stage of trajectories X
    (..., N+1, n_x), U (..., N, n_u) by one `torch.func.vmap`; the
    per-stage tensors are (N, m), shared by the leading axes.  Returns the
    outputs shaped (..., N, ...)."""
    lead, N = U.shape[:-2], U.shape[-2]
    M = int(np.prod(lead, dtype=np.int64)) * N
    xs = X[..., :-1, :].reshape(M, X.shape[-1])
    us = U.reshape(M, U.shape[-1])
    rows = [p.expand(lead + p.shape).reshape((M,) + p.shape[1:])
            for p in per_stage]
    out = _fn.vmap(fn)(*rows, xs, us)
    shape = lambda t: t.reshape(lead + (N,) + t.shape[1:])
    return tuple(map(shape, out)) if isinstance(out, tuple) else shape(out)


def terminal_map(fn, X):
    """``fn(x_N)`` of trajectories X (..., N+1, n_x) by one vmap."""
    lead = X.shape[:-2]
    M = int(np.prod(lead, dtype=np.int64))
    out = _fn.vmap(fn)(X[..., -1, :].reshape(M, X.shape[-1]))
    return out.reshape(lead + out.shape[1:])


def _augmented_traj_cost(cons, lams, mu, X, U, base_cost):
    """True cost + AL penalty of trajectories; leading axes batch."""
    pen = stage_map(
        lambda lg, lh, x, u: _stage_penalty(cons, lg, lh, mu, x, u),
        X, U, lams["gi"], lams["he"]).sum(-1)
    pen = pen + terminal_map(
        lambda x: _terminal_penalty(cons, lams["gti"], lams["hte"], mu, x), X)
    return base_cost + pen


def _al_stage_terms(cons, lg, lh, mu, x, u):
    """Per-stage AL penalty gradient + Gauss-Newton Hessian terms
    (p_x, p_u, p_xx, p_ux, p_uu)."""
    pen = lambda xx, uu: _stage_penalty(cons, lg, lh, mu, xx, uu)
    p_x, p_u = _fn.grad(pen, argnums=(0, 1))(x, u)
    # Gauss-Newton Hessian: mu * J' D J with D the active mask, assembled
    # from constraint Jacobians, not the (discontinuous) penalty Hessian.
    g = cons.stage_ineq(cons.params, x, u)
    gx, gu = _fn.jacfwd(cons.stage_ineq, argnums=(1, 2))(cons.params, x, u)
    hx, hu = _fn.jacfwd(cons.stage_eq, argnums=(1, 2))(cons.params, x, u)
    # Curvature mask: active if violated OR carrying a multiplier (ALTRO's
    # projection set), not the exact-penalty set (lam + mu g > 0): a point
    # with lam > 0 just inside the boundary must stay stiff.
    act = ((g >= 0.0) | (lg > 0.0)).to(x.dtype)
    p_xx = mu * (gx.mT * act) @ gx + mu * hx.mT @ hx
    p_uu = mu * (gu.mT * act) @ gu + mu * hu.mT @ hu
    p_ux = mu * (gu.mT * act) @ gx + mu * hu.mT @ hx
    return p_x, p_u, p_xx, p_ux, p_uu


def _al_terminal_terms(cons, lgti, lhte, mu, xN):
    """Terminal AL penalty gradient + GN Hessian (t_x, t_xx)."""
    tpen = lambda xx: _terminal_penalty(cons, lgti, lhte, mu, xx)
    t_x = _fn.grad(tpen)(xN)
    gt = cons.terminal_ineq(cons.params, xN)
    gtx = _fn.jacfwd(cons.terminal_ineq, argnums=1)(cons.params, xN)
    htx = _fn.jacfwd(cons.terminal_eq, argnums=1)(cons.params, xN)
    act_t = ((gt >= 0.0) | (lgti > 0.0)).to(xN.dtype)
    t_xx = mu * (gtx.mT * act_t) @ gtx + mu * htx.mT @ htx
    return t_x, t_xx


def add_terms(exp: TrajectoryExpansion, stage, terminal) -> TrajectoryExpansion:
    """``exp`` with penalty terms added: ``stage`` = (p_x, p_u, p_xx, p_ux,
    p_uu) stacked over time, ``terminal`` = (t_x, t_xx).  Contiguous, as the
    CUDA backward pass reads the fields as they are."""
    p_x, p_u, p_xx, p_ux, p_uu = stage
    t_x, t_xx = terminal
    return TrajectoryExpansion(*(t.contiguous() for t in (
        exp.f_x, exp.f_u, exp.l_x + p_x, exp.l_u + p_u, exp.l_xx + p_xx,
        exp.l_ux + p_ux, exp.l_uu + p_uu, exp.v_x + t_x, exp.v_xx + t_xx)))


def _augment_expansion(exp: TrajectoryExpansion, cons, lams, mu, X, U
                       ) -> TrajectoryExpansion:
    """Add the AL penalty's gradient and Gauss-Newton Hessian to the
    trajectory expansion (constraint curvature dropped, as in ALTRO)."""
    stage = stage_map(
        lambda lg, lh, x, u: _al_stage_terms(cons, lg, lh, mu, x, u),
        X, U, lams["gi"], lams["he"])
    terminal = _al_terminal_terms(cons, lams["gti"], lams["hte"], mu, X[-1])
    return add_terms(exp, stage, terminal)


def _max0(*tensors):
    """max of every entry and 0 (an empty input gives 0)."""
    flat = [t.reshape(-1) for t in tensors]
    return torch.cat([flat[0].new_zeros(1)] + flat).amax()


def _violations(cons, X, U):
    """Max violation over the trajectory: max(g, 0) and |h|, stage+terminal."""
    g, h = stage_map(lambda x, u: (cons.stage_ineq(cons.params, x, u),
                                   cons.stage_eq(cons.params, x, u)), X, U)
    gt = cons.terminal_ineq(cons.params, X[-1])
    ht = cons.terminal_eq(cons.params, X[-1])
    return _max0(g.clamp(min=0.0), h.abs(), gt.clamp(min=0.0), ht.abs())


def constraint_sizes(cons, x0, u0):
    """(n_gi, n_he, n_gti, n_hte): each callable evaluated once at (x0, u0)."""
    p = cons.params
    return (cons.stage_ineq(p, x0, u0).shape[0],
            cons.stage_eq(p, x0, u0).shape[0],
            cons.terminal_ineq(p, x0).shape[0],
            cons.terminal_eq(p, x0).shape[0])


def prepare(system: System, constraints: ConstraintSet, x0, U_init):
    """Inputs on the system's device and dtype, the U_init shape check, and
    the constraint set with its parameters moved there too."""
    x0, U_init = system.inputs(x0, U_init)
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), "
            f"got {tuple(U_init.shape)}")
    cons = dataclasses.replace(constraints, params=_params_to(
        constraints.params, U_init.device, U_init.dtype))
    return cons, x0, U_init


def _host(*values) -> np.ndarray:
    """0-d or 1-d tensors as one host array (one sync)."""
    return torch.cat([v.reshape(-1) for v in values]).cpu().numpy()


def _candidates(system, x0, alphas, alpha_list, X, U, u_ff, K, limits,
                config: IlqrConfig):
    """Every α's closed-loop rollout: (X (A, N+1, n_x), U (A, N, n_u),
    base costs (A,)).  rollout='pallas': one trajectory launch of the B2
    kernels per α; otherwise the plain batched rollouts."""
    if config.resolved_rollout() == "pallas":
        outs = [closed_loop_rollout_fused(system, x0, a, X, U, u_ff, K)
                for a in alpha_list]
        return tuple(torch.stack(t) for t in zip(*outs))
    return linesearch_rollouts(system, x0, alphas, X, U, u_ff, K,
                               u_limits=limits)


def penalized_inner_solve(system, x0, U_init, config: IlqrConfig, augment,
                          augmented_cost):
    """iLQR on a penalized cost: `solver.solve`'s loop with
    ``augment(exp, X, U)`` adding the penalty's terms to the expansion
    before the backward pass, and candidates scored by
    ``augmented_cost(X, U, base_cost)`` (leading axes batch).  Shared by
    the AL and barrier solvers.  Returns (X, U, base_cost, iterations,
    status)."""
    dtype, device = U_init.dtype, U_init.device
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    alpha_list = config.alpha_schedule()
    alphas = torch.tensor(alpha_list, dtype=dtype, device=device)
    n_alpha = len(alpha_list)
    limits = config.limit_arrays(U_init.shape[-1], dtype, device)

    if config.resolved_rollout() == "pallas":
        X, base = open_loop_rollout_fused(system, x0, U_init)
    else:
        X, base = rollout(system, x0, U_init)
    U = U_init
    cost_t = augmented_cost(X, U, base)
    cost = cost_t.cpu().numpy()
    prev_cost = np.asarray(np.inf, dtype=np_dtype)
    k, status = 0, RUNNING
    while status == RUNNING and k < config.maxiter:
        if k > 0 and np.abs(cost - prev_cost) <= config.tol:
            status = CONVERGED
            break
        exp = augment(linearize_trajectory(system, X, U), X, U)
        u_ff, K, _, ok = _backward(exp, U, config.reg_init, config, limits)
        X_c, U_c, base_c = _candidates(system, x0, alphas, alpha_list, X, U,
                                       u_ff, K, limits, config)
        costs = augmented_cost(X_c, U_c, base_c)
        host = _host(costs, ok.to(dtype))   # the iteration's one host read
        costs_h = host[:n_alpha]
        accept = (costs_h <= cost) & np.isfinite(costs_h) & (host[-1] != 0)
        if not accept.any():
            status = LINESEARCH_FAILED
            break
        idx = int(np.argmax(accept))   # the first α, in schedule order
        X, U, base = X_c[idx], U_c[idx], base_c[idx]
        prev_cost, cost = cost, costs_h[idx]
        k += 1
    return X, U, base, k, status


def _inner_solve(system, cons, x0, U_init, lams, mu, config: IlqrConfig):
    """iLQR on the augmented cost."""
    return penalized_inner_solve(
        system, x0, U_init, config,
        lambda exp, X, U: _augment_expansion(exp, cons, lams, mu, X, U),
        lambda X, U, base: _augmented_traj_cost(cons, lams, mu, X, U, base))


def _inner_solve_ms(system, cons, x0, U_init, X_init, lams, mu,
                    config: IlqrConfig, ms):
    """Multiple-shooting inner solve on the augmented cost (GNMS × ALTRO):
    the defect-aware backward pass on the penalty-augmented expansion, the
    affine multi-candidate update pass, acceptance on the L1 exact-penalty
    merit φ = J_aug + ν·Σ‖d‖₁ (see `shooting`).  Returns (X, U, base_cost,
    iterations, status)."""
    from ilqr_tpu_torch.ops.parallel_rollout import trajectory_cost
    from ilqr_tpu_torch.shooting import (
        _backward_ms,
        _node_defects,
        _update_pass_multi,
    )

    dtype, device = U_init.dtype, U_init.device
    alphas = torch.tensor(config.alpha_schedule(), dtype=dtype, device=device)
    n_alpha = alphas.shape[0]
    X, U = X_init, U_init
    base = trajectory_cost(system, X, U)
    aug = _augmented_traj_cost(cons, lams, mu, X, U, base)
    prev_merit, nu = np.inf, ms.nu0
    k, status = 0, RUNNING
    while status == RUNNING and k < config.maxiter:
        d = _node_defects(system, X, U)
        d_abs = d.abs()
        defect, merit = _host(d_abs.max(), aug + nu * d_abs.sum())
        if k > 0 and abs(merit - prev_merit) <= config.tol and defect <= ms.dtol:
            status = CONVERGED
            break
        exp = _augment_expansion(linearize_trajectory(system, X, U), cons,
                                 lams, mu, X, U)
        u_ff, K, _, ok = _backward_ms(exp, d, config.reg_init, config)
        dXs, dUs = _update_pass_multi(alphas, exp, d, u_ff, K,
                                      ms.update_engine)
        X_cs, U_cs = X[None] + dXs, U[None] + dUs
        bases = trajectory_cost(system, X_cs, U_cs)
        augs = _augmented_traj_cost(cons, lams, mu, X_cs, U_cs, bases)
        merits = augs + nu * _node_defects(system, X_cs, U_cs).abs().sum((1, 2))
        host = _host(merits, ok.to(dtype))
        merits_h = host[:n_alpha]
        accept = (merits_h <= merit) & np.isfinite(merits_h) & (host[-1] != 0)
        if accept.any():
            idx = int(np.argmax(accept))
            X, U, base, aug = X_cs[idx], U_cs[idx], bases[idx], augs[idx]
            prev_merit = merit
        else:
            stationary = (defect <= ms.dtol
                          and merits_h.min() >= merit - config.tol)
            new_nu = nu * ms.nu_factor
            status = (CONVERGED if stationary else
                      LINESEARCH_FAILED if new_nu > ms.nu_max else RUNNING)
            nu, prev_merit = min(new_nu, ms.nu_max), np.inf
        k += 1
    return X, U, base, k, status


def _initial_multipliers(N, sizes, dtype, device, lam_init):
    """Zero multipliers of the shapes ``sizes`` gives, or ``lam_init``'s
    (keys gi, he, gti, hte) reshaped to them."""
    n_gi, n_he, n_gti, n_hte = sizes
    shapes = dict(gi=(N, n_gi), he=(N, n_he), gti=(n_gti,), hte=(n_hte,))
    if lam_init is None:
        return {k: torch.zeros(s, dtype=dtype, device=device)
                for k, s in shapes.items()}
    return {k: torch.as_tensor(lam_init[k], dtype=dtype, device=device)
            .reshape(s) for k, s in shapes.items()}


def _sizes(cons, x0, U, solver: str):
    """`constraint_sizes`, refusing an empty set."""
    sizes = constraint_sizes(cons, x0, U[0])
    if sum(sizes) == 0:
        raise ValueError(f"constraint set is empty; use {solver} instead")
    return sizes


def _outer_loop(cons, sizes, U, X, lam_init, mu_init, al_config: AlConfig,
                inner):
    """The AL outer loop shared by `solve_constrained` and
    `solve_constrained_ms`: ``inner(U, X, lams, mu)`` → (X, U, base_cost,
    iterations, status).  Returns the `ConstrainedSolution`."""
    dtype, device = U.dtype, U.device
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    lams = _initial_multipliers(U.shape[0], sizes, dtype, device, lam_init)
    if mu_init is None:
        mu_init = al_config.mu0
    elif torch.is_tensor(mu_init):
        mu_init = mu_init.cpu().numpy()
    mu = np.asarray(mu_init, dtype=np_dtype)
    violation = np.asarray(np.inf, dtype=np_dtype)
    cost_t = torch.tensor(np.inf, dtype=dtype, device=device)
    viol_t = cost_t
    traces = np.full((2, al_config.max_outer), np.nan, dtype=np_dtype)
    j, inner_total, status = 0, 0, RUNNING
    p = cons.params
    while status == RUNNING and j < al_config.max_outer:
        mu_t = torch.as_tensor(mu, device=device)
        X, U, cost_t, k_inner, _ = inner(U, X, lams, mu_t)
        # An inner line-search failure is treated as inner convergence
        # ("the augmented cost cannot be improved at this penalty level"):
        # the multiplier and penalty update typically restores progress.
        viol_t = _violations(cons, X, U)

        # Multiplier updates at the inner solution.
        g, h = stage_map(lambda x, u: (cons.stage_ineq(p, x, u),
                                       cons.stage_eq(p, x, u)), X, U)
        gt = cons.terminal_ineq(p, X[-1])
        ht = cons.terminal_eq(p, X[-1])
        clamp = lambda l: torch.clamp(l, -al_config.lam_max, al_config.lam_max)
        lams = dict(gi=clamp(torch.clamp(lams["gi"] + mu_t * g, min=0.0)),
                    he=clamp(lams["he"] + mu_t * h),
                    gti=clamp(torch.clamp(lams["gti"] + mu_t * gt, min=0.0)),
                    hte=clamp(lams["hte"] + mu_t * ht))

        viol, cost = _host(viol_t, cost_t)   # the outer iteration's read
        feasible = viol <= al_config.ctol
        # Stall exit: penalty at its cap and the violation no longer
        # shrinking (in f32 the violation floors near the augmented cost's
        # relative resolution).
        stalled = mu >= al_config.mu_max and viol >= 0.99 * violation
        status = (CONVERGED if feasible else
                  INFEASIBLE if stalled else RUNNING)
        # Hold mu while the multiplier update alone contracts the
        # violation fast enough; escalate otherwise.
        if not viol <= al_config.viol_decrease * violation:
            mu = np.minimum(mu * al_config.mu_factor,
                            np.asarray(al_config.mu_max, dtype=np_dtype))
        violation = viol
        traces[:, j] = (viol, cost)
        inner_total += k_inner
        j += 1

    if status == RUNNING:
        status = INFEASIBLE
    trace = torch.from_numpy(traces).to(device)
    return ConstrainedSolution(
        X=X, U=U, cost=cost_t, violation=viol_t, status=status,
        outer_iterations=j, inner_iterations=inner_total,
        lam_stage_ineq=lams["gi"], lam_stage_eq=lams["he"],
        lam_terminal_ineq=lams["gti"], lam_terminal_eq=lams["hte"],
        mu=torch.as_tensor(mu, device=device), violation_trace=trace[0],
        cost_trace=trace[1],
    )


@full_f32_matmuls()
def solve_constrained_ms(
    system: System,
    constraints: ConstraintSet,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    X_init: torch.Tensor | None = None,
    config: IlqrConfig = IlqrConfig(),
    al_config: AlConfig = AlConfig(),
    ms=None,
    lam_init: dict = None,
    mu_init=None,
) -> ConstrainedSolution:
    """Constrained solve with a MULTIPLE-SHOOTING inner solver (augmented
    Lagrangian × infeasible-start Gauss-Newton shooting).  The contract of
    `solve_constrained`, plus:

    * ``X_init``: any (N+1, n_x) state warm start, dynamically infeasible
      allowed; defaults to the rollout of ``U_init`` (with
      ``config.init_rollout='defect'`` the parallel Newton sweeps build it,
      and non-finite nodes fall back to the constant x0);
    * the state trajectory carries over between outer iterations;
    * every inner stage is parallel-in-time (the defect-aware backward
      pass, kernel B1d under ``backward='pallas'``, and the multi-candidate
      affine update, kernel B3 under ``MsConfig(update_engine='pallas')``).
    """
    from ilqr_tpu_torch.shooting import MsConfig, _initial_nodes

    if ms is None:
        ms = MsConfig()
    cons, x0, U_init = prepare(system, constraints, x0, U_init)
    N = U_init.shape[0]
    sizes = _sizes(cons, x0, U_init, "ilqr_tpu_torch.solve_ms")
    if X_init is None:
        X_init = _initial_nodes(system, x0, U_init, config)
    X_init = system.inputs(X_init)
    if tuple(X_init.shape) != (N + 1, system.n_x):
        raise ValueError(
            f"X_init must have shape ({N + 1}, {system.n_x}), "
            f"got {tuple(X_init.shape)}")
    X_init = torch.cat([x0[None], X_init[1:]])

    def inner(U, X, lams, mu):
        return _inner_solve_ms(system, cons, x0, U, X, lams, mu, config, ms)

    return _outer_loop(cons, sizes, U_init, X_init, lam_init, mu_init,
                       al_config, inner)


@full_f32_matmuls()
def solve_constrained(
    system: System,
    constraints: ConstraintSet,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    al_config: AlConfig = AlConfig(),
    lam_init: dict = None,
    mu_init=None,
) -> ConstrainedSolution:
    """Solve the constrained problem on the system's device and dtype (x0,
    U_init and the constraint parameters move there).

    Multiplier shapes come from one call of each constraint callable at
    (x0, U_init[0]).  ``lam_init`` warm-starts the multipliers: a dict
    with keys ``gi (N, n_gi) / he (N, n_he) / gti (n_gti,) / hte (n_hte,)``
    (e.g. the ``lam_*`` fields of a previous `ConstrainedSolution`, shifted
    along the horizon for MPC).  ``mu_init`` warm-starts the penalty.  Both
    default to the cold start (zeros / ``al_config.mu0``).  Control limits
    in ``config`` clip the rollouts and go to the backward pass.
    """
    cons, x0, U_init = prepare(system, constraints, x0, U_init)
    sizes = _sizes(cons, x0, U_init, "ilqr_tpu_torch.solve")
    X0 = torch.zeros((U_init.shape[0] + 1, system.n_x), dtype=U_init.dtype,
                     device=U_init.device)

    def inner(U, X, lams, mu):
        return _inner_solve(system, cons, x0, U, lams, mu, config)

    return _outer_loop(cons, sizes, U_init, X0, lam_init, mu_init,
                       al_config, inner)
