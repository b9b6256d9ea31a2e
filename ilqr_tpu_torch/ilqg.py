"""iLQG: trajectory optimization for stochastic dynamics (Todorov & Li 2005).

PyTorch counterpart of `ilqr_tpu/ilqg.py`.  The model is

    x⁺ = f(x, u) + C(x, u) · ξ,    ξ ~ N(0, I_{n_w}),

with a user ``noise_fn(x, u) -> C`` of shape (n_x, n_w) for one point.
Minimizing the expected cost changes only the backward pass: the
Q-expansion gains the noise-covariance terms of
`ops.riccati._noise_q_terms`.  Additive noise (constant C) changes nothing
(certainty equivalence); state- or control-dependent noise gives cautious
gains.  The nominal trajectory, line search and convergence test stay
deterministic.  Use: ``solve(system, x0, U0, IlqrConfig(noise=noise_fn))``.
This module holds the expansion helper and a Monte-Carlo closed-loop
simulator for checking policies under the actual noise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.utils import random


class NoiseExpansion(NamedTuple):
    """Stacked noise model along a trajectory (time-major)."""

    C: torch.Tensor    # (N, n_x, n_w)
    C_x: torch.Tensor  # (N, n_x, n_w, n_x): ∂C/∂x
    C_u: torch.Tensor  # (N, n_x, n_w, n_u): ∂C/∂u


def noise_expansion(noise_fn: Callable, X: torch.Tensor,
                    U: torch.Tensor) -> NoiseExpansion:
    """C and its Jacobians at every stage point (X (N+1, n_x), U (N, n_u)),
    vmapped over time like `linearize_trajectory`.  The fields take X's
    dtype: a Python float times a tangent-carrying 0-d tensor can give a
    float64 tangent under vmap(jacfwd)."""
    return _noise_points(noise_fn, X[:-1], U)


def _noise_points(noise_fn: Callable, X: torch.Tensor,
                  U: torch.Tensor) -> NoiseExpansion:
    """C and its Jacobians at the points (X[k], U[k])."""
    def one(x, u):
        return (noise_fn(x, u),
                *torch.func.jacfwd(noise_fn, argnums=(0, 1))(x, u))

    return NoiseExpansion(*(t.to(X.dtype).contiguous() for t in
                            torch.func.vmap(one)(X, U)))


def noise_expansion_batched(noise_fn: Callable, X: torch.Tensor,
                            U: torch.Tensor) -> NoiseExpansion:
    """`noise_expansion` of B trajectories, X (B, N+1, n_x) and U
    (B, N, n_u): the B·N stage points through one call; every field leads
    with B."""
    B, N = U.shape[:2]
    flat = _noise_points(noise_fn, X[:, :-1].reshape(B * N, -1),
                         U.reshape(B * N, -1))
    return NoiseExpansion(*(t.reshape((B, N) + t.shape[1:]) for t in flat))


@full_f32_matmuls()
def simulate_closed_loop(
    system: System,
    noise_fn: Callable,
    X_ref: torch.Tensor,
    U_ref: torch.Tensor,
    K: torch.Tensor,
    generator: torch.Generator,
    n_rollouts: int = 32,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo cost of tracking (X_ref, U_ref) with feedback K under
    x⁺ = f(x, u) + C(x, u)·ξ, u_k = U_ref_k + α·K_k (x_k − X_ref_k).

    The noise ξ is drawn from ``generator`` (JAX takes a key) by
    `utils.random.normal`, on the generator's device, and the
    ``n_rollouts`` realizations run as one batch.  Returns (mean, std) of the cost (population std, as jnp.std).
    """
    N = U_ref.shape[0]
    n_w = noise_fn(X_ref[0], U_ref[0]).shape[-1]
    xis = random.normal(generator, (N, n_rollouts, n_w), X_ref.dtype,
                        generator.device).to(X_ref.device)
    batch_noise = torch.func.vmap(noise_fn)
    p = system.params
    x = X_ref[0].expand(n_rollouts, X_ref.shape[-1])
    cost = x.new_zeros((n_rollouts,))
    for k in range(N):
        u = U_ref[k] + alpha * ((x - X_ref[k]) @ K[k].T)
        cost = cost + system.stage_cost(p, x, u)
        x = step(system, x, u) + (batch_noise(x, u) @ xis[k, :, :, None])[
            ..., 0]
    cost = cost + system.terminal_cost(p, x)
    return cost.mean(), cost.std(correction=0)


def additive_noise(C) -> Callable:
    """Constant (state- and control-independent) noise model: certainty
    equivalent, the gains equal deterministic iLQR's."""
    C = torch.as_tensor(C)

    def fn(x, u):
        return C.to(dtype=x.dtype, device=x.device)

    return fn


def control_multiplicative_noise(sigma: float, B) -> Callable:
    """Effort-proportional actuation noise, iLQG's cautious-control setting:
    noise column j is σ·u_j·B[:, j], each actuator's disturbance growing
    with its commanded effort through its input channel B[:, j] (n_x, n_u)."""
    B = torch.as_tensor(B)

    def fn(x, u):
        return sigma * B.to(dtype=u.dtype, device=u.device) * u[None, :]

    return fn
