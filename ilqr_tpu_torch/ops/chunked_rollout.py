"""Chunked (multiple-shooting) parallel-in-time closed-loop rollouts.

PyTorch counterpart of `ilqr_tpu/ops/chunked_rollout.py`.  The per-step
defect sweeps of `ops/parallel_rollout.py` contract only near their
linearization; this scheme trades depth for a larger contraction region:

    split the horizon into C chunks of length L;
    guess the chunk boundary states s_c from the previous trajectory;
    repeat:
      1. roll every chunk out exactly from its boundary state (a host loop
         of depth L over a batch of chunks × line-search candidates);
      2. boundary defects d_c = end_c − s_{c+1};
      3. Newton-correct the boundaries through the chunk transitions
         Φ_c = Π_{k∈c} A_k: δ_{c+1} = Φ_c δ_c + d_c, an O(C) affine prefix
         scan.

As in JAX, the boundary scan runs the plain prefix scan (engine 'xla'):
it is C steps long, not N.  Within chunks the dynamics hold exactly, so the
boundary defect after the last roll certifies the assembled trajectory.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.affine_scan import affine_prefix_scan_multi
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.parallel_rollout import _guarded_max_defect


def auto_chunk_len(N: int) -> int:
    """≈ √N, clamped to [16, 512]: balances the roll's depth L against the
    boundary system's size C = N/L."""
    return max(16, min(512, int(round(N ** 0.5))))


def coarse_chunk_len(N: int) -> int:
    """Chunk length of the phase-2 line search, ~8× the fine one: longer
    chunks propagate more of each aggressive candidate's nonlinearity
    exactly, so the boundary Newton certifies farther out."""
    return max(64, min(4096, 8 * auto_chunk_len(N)))


def chunk_transition_products(A: torch.Tensor, L: int) -> torch.Tensor:
    """Per-chunk products Φ_c = A_{cL+L−1} ⋯ A_{cL}: (C·L, n, n) → (C, n, n)."""
    n = A.shape[-1]
    A_c = A.reshape(-1, L, n, n)
    Phi = torch.eye(n, dtype=A.dtype, device=A.device).expand(A_c.shape[0],
                                                               n, n)
    for l in range(L):
        Phi = A_c[:, l] @ Phi
    return Phi


@full_f32_matmuls()
def linesearch_chunked_rollouts(
    system: System, x0, alphas, X_old, U_old, u_ff, K, A_cl, sweeps: int = 3,
    chunk_len: int = 0, exit_tol: float = 0.0, u_limits=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every α candidate by chunked multiple-shooting rollouts.

    The contract of `ops.parallel_rollout.linesearch_defect_rollouts`:
    returns (X (A, N+1, n_x), U (A, N, n_u), costs (A,), defects (A,)),
    the defect being the largest boundary gap of the assembled trajectory.
    ``A_cl`` = f_x + f_u K serves the boundary correction only; ``sweeps``
    bounds the corrections, which stop once every defect is ≤ exit_tol.
    ``u_limits`` = (lo, hi) clips every applied control.
    """
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    N, n_u = U_old.shape
    n_x = x0.shape[0]
    n_alpha = alphas.shape[0]
    L = min(chunk_len if chunk_len > 0 else auto_chunk_len(N), N)
    C = -(-N // L)
    pad = C * L - N
    p = system.params

    def padded(a, fill):
        return torch.cat([a, fill.expand((pad,) + a.shape[1:])])

    # Padded steps hold the state and add no cost, so the last chunk's end
    # is x_N; (C−1)·L < N, so every chunk start is a real step.
    zero_u = U_old.new_zeros(())
    Xo = padded(X_old[:-1], X_old[-1])
    Uo, uf = padded(U_old, zero_u), padded(u_ff, zero_u)
    Kp = padded(K, zero_u)
    mask = torch.arange(C * L, device=x0.device) < N

    def chunk_major(a):  # (C·L, ...) → (L, C, ...)
        return a.reshape((C, L) + a.shape[1:]).transpose(0, 1)

    Xo_c, Uo_c, uf_c, K_c = map(chunk_major, (Xo, Uo, uf, Kp))
    mask_c = mask.reshape(C, L).T
    eye = torch.eye(n_x, dtype=A_cl.dtype, device=A_cl.device)
    Phi = chunk_transition_products(padded(A_cl, eye), L)

    def roll(s):
        """One exact rollout of all chunks from boundaries s (A, C, n_x)."""
        x, acc, Xs, Us = s, s.new_zeros((n_alpha, C)), [], []
        for l in range(L):
            u = (Uo_c[l] + alphas[:, None, None] * uf_c[l]
                 + torch.einsum("cij,acj->aci", K_c[l], x - Xo_c[l]))
            if u_limits is not None:
                u = torch.clamp(u, *u_limits)
            m = mask_c[l]
            acc = acc + torch.where(m, system.stage_cost(p, x, u), 0.0)
            Xs.append(x)
            Us.append(u)
            x = torch.where(m[:, None], step(system, x, u), x)
        costs = acc.sum(1) + system.terminal_cost(p, x[:, -1])
        defects = (_guarded_max_defect(x[:, :-1] - s[:, 1:], (1, 2)) if C > 1
                   else x.new_zeros((n_alpha,)))
        return torch.stack(Xs), torch.stack(Us), x, costs, defects

    # Boundary guesses: the previous trajectory at the chunk starts.
    s = X_old[torch.arange(C, device=x0.device) * L].expand(n_alpha, C, n_x)
    s = torch.cat([x0.expand(n_alpha, 1, n_x), s[:, 1:]], dim=1)
    Xs, Us, e, costs, defects = roll(s)
    if C > 1:
        zeros = x0.new_zeros((n_alpha, n_x))
        for _ in range(sweeps):
            if not float(defects.max()) > exit_tol:
                break
            deltas = affine_prefix_scan_multi(
                Phi[:-1], e[:, :-1] - s[:, 1:], zeros, engine="xla")[:, 1:]
            s = torch.cat([s[:, :1], s[:, 1:] + deltas], dim=1)
            Xs, Us, e, costs, defects = roll(s)

    # Assemble: (L, A, C, ·) → (A, C·L, ·); X[c·L] = s_c by construction.
    X = Xs.permute(1, 2, 0, 3).reshape(n_alpha, C * L, n_x)[:, :N]
    U = Us.permute(1, 2, 0, 3).reshape(n_alpha, C * L, n_u)[:, :N]
    return torch.cat([X, e[:, -1:]], dim=1), U, costs, defects


def chunked_rollout(system, x0, alpha, X_old, U_old, u_ff, K, A_cl,
                    sweeps: int = 3, chunk_len: int = 0,
                    exit_tol: float = 0.0, u_limits=None):
    """Single-candidate chunked rollout: (X, U, cost, defect)."""
    alphas = torch.as_tensor(alpha, dtype=x0.dtype, device=x0.device)
    X, U, costs, defects = linesearch_chunked_rollouts(
        system, x0, alphas.reshape(1), X_old, U_old, u_ff, K, A_cl,
        sweeps=sweeps, chunk_len=chunk_len, exit_tol=exit_tol,
        u_limits=u_limits)
    return X[0], U[0], costs[0], defects[0]
