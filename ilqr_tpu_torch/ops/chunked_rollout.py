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

`linesearch_chunked_rollouts_batched` is the line search over a batch of B
instances (JAX's ``jax.vmap`` of `linesearch_chunked_rollouts`): each
instance stops its boundary corrections on its own, and its boundary scan
is the plain batched scan (`affine_scan.prefix_scan_batched`), so it
launches no kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.affine_scan import affine_prefix_scan_batched
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
    """Per-chunk products Φ_c = A_{cL+L−1} ⋯ A_{cL}: (…, C·L, n, n) →
    (…, C, n, n)."""
    n = A.shape[-1]
    A_c = A.reshape(A.shape[:-3] + (-1, L, n, n))
    Phi = torch.eye(n, dtype=A.dtype, device=A.device).expand(
        A_c.shape[:-3] + (n, n))
    for l in range(L):
        Phi = A_c[..., l, :, :] @ Phi
    return Phi


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
    ``u_limits`` = (lo, hi) clips every applied control.  The batch of one
    of `linesearch_chunked_rollouts_batched`.
    """
    out = linesearch_chunked_rollouts_batched(
        system, x0[None], alphas, X_old[None], U_old[None], u_ff[None],
        K[None], A_cl[None], sweeps=sweeps, chunk_len=chunk_len,
        exit_tol=exit_tol, u_limits=u_limits)
    return tuple(t[0] for t in out)


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


@full_f32_matmuls()
def linesearch_chunked_rollouts_batched(
    system: System, x0s, alphas, X_old, U_old, u_ff, K, A_cl,
    sweeps: int = 3, chunk_len: int = 0, exit_tol=0.0, u_limits=None,
    active=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`linesearch_chunked_rollouts` over B instances, with the inputs of
    `parallel_rollout.linesearch_defect_rollouts_batched`: x0s (B, n_x),
    X_old (B, N+1, n_x), U_old and u_ff (B, N, n_u), K (B, N, n_u, n_x),
    A_cl (B, N, n_x, n_x), ``alphas`` (A,) shared, the chunk length shared.

    An instance corrects its boundaries while it is ``active`` ((B,)
    bool, default all), any of its candidates' defects exceeds its
    ``exit_tol`` (a number or (B,)) and it has sweeps left; one that
    stopped keeps its rolls bit for bit, and the loop ends when none
    corrects (one host read a sweep).  Every roll carries B·A·C states
    through L steps and keeps them, B·A·C·L states in all (16·10·500 at a
    batched DP line search).  Returns (X (B, A, N+1, n_x), U (B, A, N,
    n_u), costs (B, A), defects (B, A)).
    """
    dev = x0s.device
    alphas = torch.as_tensor(alphas, dtype=x0s.dtype, device=dev)
    B, N, n_u = U_old.shape
    n_x = x0s.shape[-1]
    n_alpha = alphas.shape[0]
    exit_tol = torch.as_tensor(exit_tol, dtype=x0s.dtype,
                               device=dev).expand(B)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    L = min(chunk_len if chunk_len > 0 else auto_chunk_len(N), N)
    C = -(-N // L)
    pad = C * L - N
    p = system.params

    def padded(a, fill):  # along time, axis 1
        return torch.cat([a, fill.expand((B, pad) + a.shape[2:])], dim=1)

    # Padded steps hold the state and add no cost, so the last chunk's end
    # is x_N; (C−1)·L < N, so every chunk start is a real step.
    zero = U_old.new_zeros(())
    Xo = padded(X_old[:, :-1], X_old[:, -1:])
    Uo, uf, Kp = padded(U_old, zero), padded(u_ff, zero), padded(K, zero)
    mask_c = (torch.arange(C * L, device=dev) < N).reshape(C, L).T

    def chunk_major(a):  # (B, C·L, ...) → (L, B, C, ...)
        return a.reshape((B, C, L) + a.shape[2:]).movedim(2, 0)

    Xo_c, Uo_c, uf_c, K_c = map(chunk_major, (Xo, Uo, uf, Kp))
    eye = torch.eye(n_x, dtype=A_cl.dtype, device=dev)
    Phi = chunk_transition_products(
        padded(A_cl, eye.expand((1, n_x, n_x))), L)   # (B, C, n_x, n_x)

    def roll(s):
        """One exact rollout of all chunks from boundaries s (B, A, C, n)."""
        x, acc, Xs, Us = s, s.new_zeros((B, n_alpha, C)), [], []
        for l in range(L):
            u = (Uo_c[l][:, None] + alphas[:, None, None] * uf_c[l][:, None]
                 + torch.einsum("bcij,bacj->baci", K_c[l],
                                x - Xo_c[l][:, None]))
            if u_limits is not None:
                u = torch.clamp(u, *u_limits)
            m = mask_c[l]
            acc = acc + torch.where(m, system.stage_cost(p, x, u), 0.0)
            Xs.append(x)
            Us.append(u)
            x = torch.where(m[:, None], step(system, x, u), x)
        costs = acc.sum(-1) + system.terminal_cost(p, x[:, :, -1])
        defects = (_guarded_max_defect(x[:, :, :-1] - s[:, :, 1:], (2, 3))
                   if C > 1 else x.new_zeros((B, n_alpha)))
        return torch.stack(Xs), torch.stack(Us), x, costs, defects

    # Boundary guesses: the previous trajectory at the chunk starts.
    s = X_old[:, torch.arange(C, device=dev) * L][:, None].expand(
        B, n_alpha, C, n_x)
    s = torch.cat([x0s[:, None, None].expand(B, n_alpha, 1, n_x),
                   s[:, :, 1:]], dim=2)
    Xs, Us, e, costs, defects = roll(s)
    if C > 1:
        zeros = x0s.new_zeros((B, n_alpha, n_x))
        for _ in range(sweeps):
            fixing = active & (defects.amax(dim=1) > exit_tol)
            if not bool(fixing.any()):
                break
            deltas = affine_prefix_scan_batched(
                Phi[:, :-1], e[:, :, :-1] - s[:, :, 1:], zeros,
                engine="xla")[:, :, 1:]
            s_new = torch.cat([s[:, :, :1], s[:, :, 1:] + deltas], dim=2)
            new = roll(s_new)
            f2, f4 = fixing[:, None], fixing[:, None, None, None]
            s = torch.where(f4, s_new, s)
            Xs = torch.where(f4[None], new[0], Xs)
            Us = torch.where(f4[None], new[1], Us)
            e = torch.where(f4, new[2], e)
            costs = torch.where(f2, new[3], costs)
            defects = torch.where(f2, new[4], defects)

    # Assemble: (L, B, A, C, ·) → (B, A, C·L, ·); X[c·L] = s_c by
    # construction.
    X = Xs.permute(1, 2, 3, 0, 4).reshape(B, n_alpha, C * L, n_x)[:, :, :N]
    U = Us.permute(1, 2, 3, 0, 4).reshape(B, n_alpha, C * L, n_u)[:, :, :N]
    return torch.cat([X, e[:, :, -1:]], dim=2), U, costs, defects
