"""Gauss-Newton multiple shooting (GNMS): iLQR over an (X, U) node pair.

PyTorch counterpart of `ilqr_tpu/shooting.py`.  The states are decision
variables too, coupled by the gaps d_k = f(x_k, u_k) − x_{k+1}, so a solve
can start from an infeasible X (`interpolate_states`) and no step of an
iteration is a nonlinear chain over time:

  1. defects and node costs: one evaluation over the whole trajectory;
  2. `linearize_trajectory` at the nodes;
  3. the defect-aware backward pass (V_x → V_x + V_xx·d in the linear
     Q-terms; `_backward_ms`, kernel B1d under backward='pallas');
  4. the affine update pass for every α at once, δu = α·u_ff + K δx,
     δx⁺ = f_x δx + f_u δu + α·d — one closed-loop transition chain shared
     by the candidates (`_update_pass_multi`, kernel B3 under
     update_engine='pallas');
  5. accept the first α that does not raise the L1 exact-penalty merit
     φ = J + ν·Σ|d|; ν escalates when no α is accepted.

The JAX `while_loop` is a host loop here with two syncs per iteration (the
merit and convergence test, then the candidates' costs and merits).  Like
the JAX `solve_ms`, it reads the solver fields it uses (maxiter, tol, the α
schedule, backward, init_rollout, defect_iters, defect_engine and the
regularization fields) and no others.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.affine_scan import affine_prefix_scan_multi
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.linearize import linearize_trajectory
from ilqr_tpu_torch.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu_torch.ops.parallel_rollout import (
    open_loop_defect_rollout,
    trajectory_cost,
)
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops.rollout import rollout
from ilqr_tpu_torch.ops.suffix_scan import backward_pass_suffix_scan
from ilqr_tpu_torch.solver import (
    CONVERGED,
    LINESEARCH_FAILED,
    MAXITER,
    RUNNING,
    IlqrConfig,
)


@dataclasses.dataclass(frozen=True)
class MsConfig:
    """Multiple-shooting extras on top of `IlqrConfig`: the fields, defaults
    and validation of `ilqr_tpu.shooting.MsConfig`.

    nu0/nu_factor/nu_max: the L1 penalty weight ν of the merit
    φ = J + ν·Σ|d| and its escalation on a rejected line search.
    dtol: max-norm defect required for convergence.  update_engine: how
    the multi-α affine update pass runs — 'seq' (host loop over time),
    'xla' (the plain prefix scan of `ops/affine_scan.py`), 'pallas' (its
    CUDA kernel on CUDA tensors) or 'auto' ('seq' until GPU measurements
    set a rule).  All compute the same affine recursion exactly.
    """

    nu0: float = 10.0
    nu_factor: float = 10.0
    nu_max: float = 1e8
    dtol: float = 1e-4
    update_engine: str = "auto"

    def __post_init__(self):
        if self.update_engine not in ("auto", "seq", "xla", "pallas"):
            raise ValueError(
                f"update_engine must be 'auto'|'seq'|'xla'|'pallas', "
                f"got {self.update_engine!r}"
            )


@dataclasses.dataclass(frozen=True)
class MsSolution:
    X: torch.Tensor             # (N+1, n_x) nodes, feasible at convergence
    U: torch.Tensor             # (N, n_u) controls
    cost: torch.Tensor          # 0-d cost of the (X, U) node pair
    defect: torch.Tensor        # 0-d max-norm shooting gap
    iterations: int
    status: int                 # CONVERGED / LINESEARCH_FAILED / MAXITER
    u_ff: torch.Tensor
    K: torch.Tensor
    cost_trace: torch.Tensor    # (maxiter,) nan-padded
    defect_trace: torch.Tensor  # (maxiter,) nan-padded
    alpha_trace: torch.Tensor   # (maxiter,) nan-padded


def interpolate_states(x0: torch.Tensor, x_goal, N: int) -> torch.Tensor:
    """Straight-line (N+1, n_x) state warm start from x0 to x_goal."""
    w = torch.linspace(0.0, 1.0, N + 1, dtype=x0.dtype, device=x0.device)
    goal = torch.as_tensor(x_goal, dtype=x0.dtype, device=x0.device)
    return (1.0 - w[:, None]) * x0[None] + w[:, None] * goal[None]


def _node_defects(system: System, X, U):
    """d_k = f(x_k, u_k) − x_{k+1}; leading axes batch."""
    return step(system, X[..., :-1, :], U) - X[..., 1:, :]


@full_f32_matmuls()
def _update_pass(alpha, exp, d, u_ff, K):
    """The affine update from δx₀ = 0: δu = α·u_ff + K δx,
    δx⁺ = f_x δx + f_u δu + α·d, by a host loop over time.  ``alpha`` is a
    number or an (A,) tensor of candidates.  Returns (δX (…, N+1, n_x),
    δU (…, N, n_u))."""
    alpha = torch.as_tensor(alpha, dtype=d.dtype, device=d.device)
    a = alpha[..., None]
    dx = d.new_zeros(alpha.shape + d.shape[-1:])
    dXs, dUs = [], []
    for k in range(d.shape[0]):
        du = a * u_ff[k] + dx @ K[k].T
        dXs.append(dx)
        dUs.append(du)
        dx = dx @ exp.f_x[k].T + du @ exp.f_u[k].T + a * d[k]
    return torch.stack(dXs + [dx], dim=-2), torch.stack(dUs, dim=-2)


@full_f32_matmuls()
def _update_pass_multi(alphas, exp, d, u_ff, K, engine: str):
    """Every candidate's affine update at once.

    With δu = α·u_ff + K δx the update is δx⁺ = (f_x + f_u K) δx +
    α·(f_u u_ff + d): one transition chain shared by all α, per-candidate
    drives — the shape of `affine_prefix_scan_multi`.  Exact for every
    engine.  Returns (δX (A, N+1, n_x), δU (A, N, n_u)).
    """
    if engine == "auto":
        engine = "seq"
    if engine == "seq":
        return _update_pass(alphas, exp, d, u_ff, K)
    P = exp.f_x + exp.f_u @ K
    base = (exp.f_u @ u_ff[..., None])[..., 0] + d
    q = alphas[:, None, None] * base[None]
    dX = affine_prefix_scan_multi(P, q, d.new_zeros((alphas.shape[0],
                                                     d.shape[-1])),
                                  engine=engine)
    dU = (alphas[:, None, None] * u_ff[None]
          + torch.einsum("kij,akj->aki", K, dX[:, :-1]))
    return dX, dU


def _backward_ms(exp, d, reg: float, config: IlqrConfig):
    """The defect-aware backward pass under `config.backward`: 'scan'
    (and 'auto') sequential, 'pscan' associative, 'pallas' the fused CUDA
    kernel with defects for n_u <= 6 (B1's reach; JAX's own threshold, 4,
    is its kernel's) and the suffix-scan kernel B6 beyond."""
    backward = config.resolved_backward()
    if backward == "pscan":
        return backward_pass_associative(exp, reg, defects=d)
    if backward == "pallas":
        if exp.l_u.shape[-1] <= 6:
            return backward_pass_fused(exp, reg, defects=d)
        return backward_pass_suffix_scan(exp, reg, defects=d)
    return backward_pass(exp, reg, defects=d)


def _initial_nodes(system: System, x0, U, config: IlqrConfig):
    """The default state warm start: the rollout of U.  With
    init_rollout='defect' the parallel Newton sweeps build it and no
    sequential fallback is needed — residual gaps are what the MS iteration
    closes; only a non-finite result falls back, to the constant x0."""
    if config.resolved_init_rollout() == "defect":
        X, _, _ = open_loop_defect_rollout(
            system, x0, U, iters=config.defect_iters,
            engine=config.defect_engine)
        if bool(torch.isfinite(X).all()):
            return X
        return x0.expand(U.shape[0] + 1, x0.shape[0])
    return rollout(system, x0, U)[0]


@full_f32_matmuls()
def solve_ms(
    system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    X_init: torch.Tensor | None = None,
    config: IlqrConfig = IlqrConfig(),
    ms: MsConfig = MsConfig(),
) -> MsSolution:
    """Multiple-shooting trajectory optimization.

    X_init: optional (N+1, n_x) state warm start, which may be dynamically
    infeasible; row 0 is replaced by x0.  By default the rollout of U_init
    (then iteration 1 matches single-shooting iLQR, d ≡ 0).  The solve runs
    on the system's device and dtype; x0, U_init and X_init move there.
    """
    x0, U_init, X_init = system.inputs(x0, U_init, X_init)
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), "
            f"got {tuple(U_init.shape)}")
    if tuple(x0.shape) != (system.n_x,):
        raise ValueError(f"x0 must have shape ({system.n_x},), "
                         f"got {tuple(x0.shape)}")
    N, n_u = U_init.shape
    n_x = x0.shape[0]
    if X_init is None:
        X_init = _initial_nodes(system, x0, U_init, config)
    if tuple(X_init.shape) != (N + 1, n_x):
        raise ValueError(f"X_init must have shape ({N + 1}, {n_x}), "
                         f"got {tuple(X_init.shape)}")
    X = torch.cat([x0[None], X_init[1:]])
    U = U_init
    dtype, device = U.dtype, U.device
    alpha_list = config.alpha_schedule()
    alphas = torch.tensor(alpha_list, dtype=dtype, device=device)
    n_alpha = len(alpha_list)

    cost = trajectory_cost(system, X, U)
    u_ff = U.new_zeros((N, n_u))
    K = U.new_zeros((N, n_u, n_x))
    prev_merit, nu, reg = np.inf, ms.nu0, config.reg_init
    traces = np.full((3, config.maxiter), np.nan)
    k, status = 0, RUNNING
    while status == RUNNING and k < config.maxiter:
        d = _node_defects(system, X, U)
        d_abs = d.abs()
        defect, merit = torch.stack([
            d_abs.max(), cost + nu * d_abs.sum()]).cpu().numpy()
        if k > 0 and abs(merit - prev_merit) <= config.tol and defect <= ms.dtol:
            status = CONVERGED
            break
        exp = linearize_trajectory(system, X, U)
        u_ff_k, K_k, _, ok = _backward_ms(exp, d, reg, config)
        dXs, dUs = _update_pass_multi(alphas, exp, d, u_ff_k, K_k,
                                      ms.update_engine)
        X_cs, U_cs = X[None] + dXs, U[None] + dUs
        costs = trajectory_cost(system, X_cs, U_cs)
        gaps = _node_defects(system, X_cs, U_cs).abs()
        merits = costs + nu * gaps.sum((1, 2))
        host = torch.cat([costs, merits, gaps.amax((1, 2)),
                          ok.to(dtype)[None]]).cpu().numpy()
        costs_h, merits_h = host[:n_alpha], host[n_alpha:2 * n_alpha]
        accept = (merits_h <= merit) & np.isfinite(merits_h) & (host[-1] != 0)
        if accept.any():
            idx = int(np.argmax(accept))  # the first α, in schedule order
            X, U, cost = X_cs[idx], U_cs[idx], costs[idx]
            u_ff, K = u_ff_k, K_k
            prev_merit = merit
            if config.adaptive_reg:
                reg = max(reg / config.reg_factor, 0.0)
            traces[:, k] = (costs_h[idx], host[2 * n_alpha + idx],
                            alpha_list[idx])
        else:
            # Feasible with no candidate better than tol: stationary.
            # Otherwise escalate ν (and reg, if adaptive) and retry.
            stationary = defect <= ms.dtol and merits_h.min() >= merit - config.tol
            if config.adaptive_reg:
                reg = max(reg, 1e-6) * config.reg_factor
            new_nu = nu * ms.nu_factor
            status = (CONVERGED if stationary else
                      LINESEARCH_FAILED if new_nu > ms.nu_max else RUNNING)
            nu, prev_merit = min(new_nu, ms.nu_max), np.inf
        k += 1

    if status == RUNNING:
        status = MAXITER
    trace = torch.tensor(traces, dtype=dtype, device=device)
    return MsSolution(
        X=X, U=U, cost=cost, defect=_node_defects(system, X, U).abs().max(),
        iterations=k, status=status, u_ff=u_ff, K=K, cost_trace=trace[0],
        defect_trace=trace[1], alpha_trace=trace[2])
