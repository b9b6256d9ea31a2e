"""Trajectory-wide dynamics linearization and cost quadratization.

PyTorch counterpart of `ilqr_tpu/ops/linearize.py`: the whole derivative
surface along (X, U) in one `torch.func.vmap` over time of
`jacfwd`/`grad`/`hessian`, leaving only the Riccati algebra sequential.

Layout (time-major, as in JAX):
    X: (N+1, n_x)    U: (N, n_u)
All stacked derivative tensors lead with the time axis.  `dynamics_hessians`
gives the second derivatives of the step for full DDP; the ``_batched``
forms take B trajectories, (B, N+1, n_x) and (B, N, n_u).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import IMPLICIT, newton_polish, step


@dataclasses.dataclass(frozen=True)
class TrajectoryExpansion:
    """Stacked first/second-order expansion of dynamics and cost along (X, U).

    Shapes (N = horizon length):
        f_x:  (N, n_x, n_x)    f_u:  (N, n_x, n_u)
        l_x:  (N, n_x)         l_u:  (N, n_u)
        l_xx: (N, n_x, n_x)    l_ux: (N, n_u, n_x)   l_uu: (N, n_u, n_u)
        v_x:  (n_x,)           v_xx: (n_x, n_x)      (terminal cost expansion)
    """

    f_x: torch.Tensor
    f_u: torch.Tensor
    l_x: torch.Tensor
    l_u: torch.Tensor
    l_xx: torch.Tensor
    l_ux: torch.Tensor
    l_uu: torch.Tensor
    v_x: torch.Tensor
    v_xx: torch.Tensor


class DynamicsHessians(NamedTuple):
    """Second-order dynamics terms for full DDP (a NamedTuple, so that
    `torch.func.vmap` maps over its fields as it does over
    `ilqg.NoiseExpansion`'s).

    Index convention (JAX's): ``f_xx[k, i, a, b] = ∂²f_i/∂x_a∂x_b`` at step
    k, ``f_ux[k, i, u, x] = ∂²f_i/∂u∂x``.  Shapes: f_xx (N, n_x, n_x, n_x),
    f_ux (N, n_x, n_u, n_x), f_uu (N, n_x, n_u, n_u).
    """

    f_xx: torch.Tensor
    f_ux: torch.Tensor
    f_uu: torch.Tensor


@full_f32_matmuls()
def dynamics_hessians(system: System, X: torch.Tensor,
                      U: torch.Tensor) -> DynamicsHessians:
    """Second derivatives of the discrete step along (X, U): forward over
    forward mode, vmapped over time.  For the implicit integrators the
    differentiated map is `integrators.newton_polish` from the converged
    step (JAX differentiates its custom_jvp tangent rule instead; both give
    the second derivatives of the implicit solution)."""
    return _stage_hessians(system, X[:-1], U)


@full_f32_matmuls()
def dynamics_hessians_batched(system: System, X: torch.Tensor,
                              U: torch.Tensor) -> DynamicsHessians:
    """`dynamics_hessians` of B trajectories, X (B, N+1, n_x) and U
    (B, N, n_u): the B·N stage points through one vmap, as
    `linearize_trajectory_batched` takes them (the implicit rules still
    differentiate `newton_polish`).  Every field leads with B."""
    B, N = U.shape[:2]
    h = _stage_hessians(system, X[:, :-1].reshape(B * N, -1),
                        U.reshape(B * N, -1))
    return DynamicsHessians(*(t.reshape((B, N) + t.shape[1:]) for t in h))


def _stage_hessians(system: System, X: torch.Tensor,
                    U: torch.Tensor) -> DynamicsHessians:
    """The step's second derivatives at the stage points (X[k], U[k]),
    X (P, n_x) and U (P, n_u)."""
    implicit = system.integrator in IMPLICIT
    X1 = step(system, X, U) if implicit else U

    def f(x, u, x1):
        if implicit:
            return newton_polish(system, x1, x, u)
        return step(system, x, u)

    def stage(x, u, x1):
        (f_xx, _), (f_ux, f_uu) = torch.func.jacfwd(
            torch.func.jacfwd(f, argnums=(0, 1)), argnums=(0, 1))(x, u, x1)
        return f_xx, f_ux, f_uu

    return DynamicsHessians(*(t.contiguous() for t in
                              torch.func.vmap(stage)(X, U, X1)))


def _stage_expansion(system: System, x, u):
    """All seven per-step derivative blocks of one (x, u) point.

    The cost's second derivatives come from one Hessian over z = (x, u):
    l_xx, l_ux and l_uu are its blocks.
    """
    n_x = system.n_x

    def f(xx, uu):
        return step(system, xx, uu)

    def l_z(z):
        return system.stage_cost(system.params, z[:n_x], z[n_x:])

    f_x, f_u = torch.func.jacfwd(f, argnums=(0, 1))(x, u)
    z = torch.cat([x, u])
    g = torch.func.grad(l_z)(z)
    H = torch.func.hessian(l_z)(z)
    return (f_x, f_u, g[:n_x], g[n_x:],
            H[:n_x, :n_x], H[n_x:, :n_x], H[n_x:, n_x:])


@full_f32_matmuls()
def linearize_trajectory(system: System, X: torch.Tensor,
                         U: torch.Tensor) -> TrajectoryExpansion:
    """Expand dynamics/cost along a nominal trajectory, vmapped over time.

    X: (N+1, n_x), U: (N, n_u).
    """
    f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu = torch.func.vmap(
        lambda x, u: _stage_expansion(system, x, u))(X[:-1], U)

    def lf(xx):
        return system.terminal_cost(system.params, xx)

    v_x = torch.func.grad(lf)(X[-1])
    v_xx = torch.func.hessian(lf)(X[-1])
    # Contiguous, as the CUDA backward pass reads the tensors as they are.
    return TrajectoryExpansion(*(t.contiguous() for t in (
        f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx)))


@full_f32_matmuls()
def linearize_trajectory_batched(system: System, X: torch.Tensor,
                                 U: torch.Tensor) -> TrajectoryExpansion:
    """The expansions of B trajectories: X (B, N+1, n_x), U (B, N, n_u).

    The B·N stage points go through one vmap, as the JAX batched expansion
    flattens them; the terminal expansion is vmapped over B.  Every field
    leads with B and is contiguous (the batched CUDA backward pass reads
    the (B, N, …) layout as it is).
    """
    B, N = U.shape[:2]
    stages = torch.func.vmap(lambda x, u: _stage_expansion(system, x, u))(
        X[:, :-1].reshape(B * N, -1), U.reshape(B * N, -1))

    def lf(xx):
        return system.terminal_cost(system.params, xx)

    v_x = torch.func.vmap(torch.func.grad(lf))(X[:, -1])
    v_xx = torch.func.vmap(torch.func.hessian(lf))(X[:, -1])
    return TrajectoryExpansion(*(
        [t.reshape((B, N) + t.shape[1:]).contiguous() for t in stages]
        + [v_x.contiguous(), v_xx.contiguous()]))
