"""Parallel-in-time rollouts by defect correction (Newton sweeps).

PyTorch counterpart of `ilqr_tpu/ops/parallel_rollout.py`.  The exact
rollout x_{k+1} = f(x_k, u_k) is an O(N)-deep recurrence; these functions
solve it iteratively with O(log N) depth per sweep:

    repeat up to `iters` times:
      1. F_k = f(x_k, u_k) for all k at once;
      2. defects d_k = F_k − x_{k+1};
      3. corrections through the linearized dynamics, δ_{k+1} = A_k δ_k + d_k
         (closed loop: A_k = f_x + f_u K from the surrounding expansion; open
         loop: A_k = ∂f/∂x along the current iterate), by the affine prefix
         scan of `ops/affine_scan.py` (kernel B3 under engine 'pallas'/'auto'
         on CUDA);
      4. X ← X + δ.

The JAX `while_loop`s are host loops here: each sweep makes one scalar sync
for the early-exit test (defect ≤ exit_tol).  f is evaluated on the whole
trajectory at once (the models are written over the trailing axis, so a
batched call is the vmap over time) and the open-loop Jacobians with
`torch.func.vmap` of `jacfwd` over time, as in `ops/linearize.py`.  The
returned max defect certifies the result; callers fall back to the
sequential rollout when it is not small.

`linesearch_defect_rollouts_batched` is the line search over a batch of B
instances (JAX's ``jax.vmap`` of `defect_rollout` and
`linesearch_defect_rollouts`): one launch of B3's batched entry a sweep,
and each instance stops sweeping on its own, as vmap of JAX's
``while_loop`` stops it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.affine_scan import (
    affine_prefix_scan_batched,
    affine_prefix_scan_multi,
)
from ilqr_tpu_torch.ops.integrators import step


def affine_prefix_scan(A: torch.Tensor, d: torch.Tensor,
                       delta0: torch.Tensor) -> torch.Tensor:
    """Solve δ_{k+1} = A_k δ_k + d_k for one drive: A (N, n, n), d (N, n),
    delta0 (n,) → δ (N+1, n), by the plain prefix scan."""
    return affine_prefix_scan_multi(A, d[None], delta0[None], engine="xla")[0]


def _guarded_max_defect(d: torch.Tensor, dims) -> torch.Tensor:
    """max |d| over ``dims`` with non-finite mapped to +inf (a NaN defect
    must read as 'not converged', not poison the early-exit test)."""
    m = d.abs().amax(dim=dims)
    return torch.where(torch.isfinite(m), m, torch.full_like(m, torch.inf))


def trajectory_cost(system: System, X: torch.Tensor, U: torch.Tensor):
    """Σ l(x_k, u_k) + l_f(x_N) along (X, U), feasible or not; leading
    axes batch."""
    p = system.params
    return (system.stage_cost(p, X[..., :-1, :], U).sum(-1)
            + system.terminal_cost(p, X[..., -1, :]))


@full_f32_matmuls()
def defect_rollout(
    system: System, x0, alpha, X_old, U_old, u_ff, K, A_cl, iters: int = 6,
    engine: str = "auto", exit_tol: float = 0.0, u_limits=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop line-search rollout by parallel defect correction.

    The contract of `ops.rollout.closed_loop_rollout` plus the final max
    defect ‖f(x_k, u_k) − x_{k+1}‖∞: returns (X, U, cost, defect).
    ``A_cl`` is the closed-loop transition f_x + f_u K, (N, n_x, n_x).
    ``u_limits`` = (lo, hi) clips the controls: the limited backward passes
    zero the feedback rows of clamped controls, so A_cl stays the sweep's
    Jacobian for the frozen set, and the defect certifies the rest.
    """
    def controls(X):
        u = U_old + alpha * u_ff + ((X[:-1] - X_old[:-1])[:, None]
                                    @ K.transpose(-1, -2))[:, 0]
        return u if u_limits is None else torch.clamp(u, *u_limits)

    X, U = X_old, controls(X_old)
    F = step(system, X[:-1], U)
    defect = _guarded_max_defect(F - X[1:], (0, 1))
    for _ in range(iters):
        if not float(defect) > exit_tol:
            break
        deltas = affine_prefix_scan_multi(
            A_cl, (F - X[1:])[None], (x0 - X[0])[None], engine=engine)[0]
        X = X + deltas
        U = controls(X)
        F = step(system, X[:-1], U)
        defect = _guarded_max_defect(F - X[1:], (0, 1))
    return X, U, trajectory_cost(system, X, U), defect


@full_f32_matmuls()
def open_loop_defect_rollout(
    system: System, x0, U, X_guess=None, iters: int = 8,
    engine: str = "auto", exit_tol: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Open-loop rollout by parallel-in-time Newton sweeps.

    The initial rollout of a solve has no expansion to borrow, so each
    sweep re-linearizes along the current iterate (A_k = ∂f/∂x at
    (x_k, u_k)).  X_guess defaults to the constant trajectory at x0.  May
    diverge from a poor guess on unstable dynamics: check the returned
    defect.  Returns (X (N+1, n_x), cost, max defect).
    """
    N = U.shape[0]
    # The constant guess is materialized: forward-mode duals of a view that
    # repeats the row of a larger tensor (x0 = x0s[i]) raise.
    X = (x0.expand(N + 1, x0.shape[0]).contiguous() if X_guess is None
         else X_guess)
    jac_x = torch.func.vmap(torch.func.jacfwd(
        lambda x, u: step(system, x, u), argnums=0))
    F = step(system, X[:-1], U)
    defect = _guarded_max_defect(F - X[1:], (0, 1))
    for _ in range(iters):
        if not float(defect) > exit_tol:
            break
        A = jac_x(X[:-1], U)
        deltas = affine_prefix_scan_multi(
            A, (F - X[1:])[None], (x0 - X[0])[None], engine=engine)[0]
        X = X + deltas
        F = step(system, X[:-1], U)
        defect = _guarded_max_defect(F - X[1:], (0, 1))
    return X, trajectory_cost(system, X, U), defect


@full_f32_matmuls()
def linesearch_defect_rollouts(system: System, x0, alphas, X_old, U_old,
                               u_ff, K, exp, iters: int = 6,
                               engine: str = "auto", exit_tol: float = 0.0,
                               u_limits=None):
    """Every α of ``alphas`` (A,) by defect-correction sweeps that share one
    scan: A_cl = f_x + f_u K does not depend on α, so each sweep runs one
    multi-candidate affine prefix scan.  Sweeps stop once every
    candidate's defect is ≤ exit_tol; ``u_limits`` = (lo, hi) clips the
    controls as in `defect_rollout`.  Returns (X (A, N+1, n_x),
    U (A, N, n_u), costs (A,), defects (A,))."""
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    A_cl = exp.f_x + exp.f_u @ K

    def controls(X):
        dx = X[:, :-1] - X_old[None, :-1]
        u = (U_old[None] + alphas[:, None, None] * u_ff[None]
             + torch.einsum("kij,akj->aki", K, dx))
        return u if u_limits is None else torch.clamp(u, *u_limits)

    X = X_old.expand((alphas.shape[0],) + X_old.shape)
    U = controls(X)
    F = step(system, X[:, :-1], U)
    defects = _guarded_max_defect(F - X[:, 1:], (1, 2))
    for _ in range(iters):
        if not float(defects.max()) > exit_tol:
            break
        deltas = affine_prefix_scan_multi(A_cl, F - X[:, 1:],
                                          x0[None] - X[:, 0], engine=engine)
        X = X + deltas
        U = controls(X)
        F = step(system, X[:, :-1], U)
        defects = _guarded_max_defect(F - X[:, 1:], (1, 2))
    return X, U, trajectory_cost(system, X, U), defects


@full_f32_matmuls()
def linesearch_defect_rollouts_batched(
    system: System, x0s, alphas, X_old, U_old, u_ff, K, A_cl,
    iters: int = 6, engine: str = "auto", exit_tol=0.0, u_limits=None,
    active=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`linesearch_defect_rollouts` over B instances: x0s (B, n_x), X_old
    (B, N+1, n_x), U_old and u_ff (B, N, n_u), K (B, N, n_u, n_x), the
    closed-loop transitions A_cl (B, N, n_x, n_x); ``alphas`` (A,) shared.

    An instance sweeps while it is ``active`` ((B,) bool, default all),
    any of its candidates' defects exceeds its ``exit_tol`` (a number or
    (B,)) and it has sweeps left; an instance that stopped keeps its
    iterate bit for bit (`torch.where` on every carry) and the loop ends
    when none sweeps: one host read and one launch of B3's batched entry
    (`affine_prefix_scan_batched` under ``engine``) a sweep.  Returns (X
    (B, A, N+1, n_x), U (B, A, N, n_u), costs (B, A), defects (B, A)).
    """
    B = x0s.shape[0]
    alphas = torch.as_tensor(alphas, dtype=x0s.dtype, device=x0s.device)
    exit_tol = torch.as_tensor(exit_tol, dtype=x0s.dtype,
                               device=x0s.device).expand(B)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=x0s.device)

    def controls(X):
        dx = X[:, :, :-1] - X_old[:, None, :-1]
        u = (U_old[:, None] + alphas[:, None, None] * u_ff[:, None]
             + torch.einsum("bkij,bakj->baki", K, dx))
        return u if u_limits is None else torch.clamp(u, *u_limits)

    X = X_old[:, None].expand((B, alphas.shape[0]) + X_old.shape[1:])
    U = controls(X)
    F = step(system, X[:, :, :-1], U)
    defects = _guarded_max_defect(F - X[:, :, 1:], (2, 3))
    for _ in range(iters):
        sweeping = active & (defects.amax(dim=1) > exit_tol)
        if not bool(sweeping.any()):
            break
        deltas = affine_prefix_scan_batched(
            A_cl, F - X[:, :, 1:], x0s[:, None] - X[:, :, 0], engine=engine)
        X_new = X + deltas
        U_new = controls(X_new)
        F_new = step(system, X_new[:, :, :-1], U_new)
        s = sweeping[:, None, None, None]
        X = torch.where(s, X_new, X)
        U = torch.where(s, U_new, U)
        F = torch.where(s, F_new, F)
        defects = torch.where(sweeping[:, None], _guarded_max_defect(
            F_new - X_new[:, :, 1:], (2, 3)), defects)
    return X, U, trajectory_cost(system, X, U), defects
