"""Implicit differentiation through the converged iLQR solve.

PyTorch counterpart of `ilqr_tpu/diff.py`.  The solver is a host loop that
autograd cannot reverse usefully (and the gradient of a converged solution
should not depend on the path the solver took), so ``solve_implicit``
wraps it in a `torch.autograd.Function` whose backward pass applies the
implicit function theorem.  At convergence the controls U* satisfy

    G(U*, θ, x0) := ∇_U J(U*, θ, x0) = 0,

J the cost of the open-loop rollout of U from x0 under parameters θ, so

    dU*/dθ = −H⁻¹ ∂G/∂θ,      H := ∇²_UU J.

The backward pass solves H z = ḡ_U by conjugate gradients (the port's
`cg`, which mirrors ``jax.scipy.sparse.linalg.cg`` as JAX's module calls
it) and adds −(∂G/∂θ)ᵀ z to the direct term.  Each Hessian-vector product
is forward over reverse along the trajectory: the tangent recursion
δx_{k+1} = f_x δx_k + f_u v_k (forward) over the second-order adjoint
recursion of the costates (reverse), on the expansion and the dynamics'
second derivatives at (X*, U*) (`ops/linearize.py`).  That is the product
JAX takes by ``jax.jvp`` of ``jax.grad``, in O(N) small products instead of
an eager pass through the whole rollout per CG iteration.  The direct term
and the parameters' part come from the same recursions: the x0 gradient
from the costates, the parameters' from one reverse pass over all steps
at once (a vmap over time of each step's stage cost and dynamics and
their directional derivatives, `_param_grads`), not through the rollout's
chain of steps.  Under the implicit integrators, whose `autograd.Function`
carries forward tangents only, each step is taken again by
`integrators.newton_polish` from its converged point, which has the
implicit step's first and second derivatives in (x, u, θ).  No derivative
goes through a kernel.

Gradients reach ``system.params`` and ``x0`` through the ``X``, ``U`` and
``cost`` fields only; the other fields are detached, and ``U_init`` gets a
zero gradient.  Control limits are refused, as in JAX.  The forward pass
is ``solve`` on detached parameters, bit for bit: the rollout kernels'
parameter cache (`ops/fused_rollout._params_on`) holds the tensors it is
given, so it never sees a tensor that carries the caller's graph.
"""
from __future__ import annotations

import dataclasses

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import IMPLICIT, newton_polish, step
from ilqr_tpu_torch.ops.linearize import dynamics_hessians, linearize_trajectory
from ilqr_tpu_torch.solver import IlqrConfig, IlqrSolution, solve
from ilqr_tpu_torch.utils.tree import leaves_with_path, map_leaves


@dataclasses.dataclass(frozen=True)
class IftConfig:
    """Settings of the implicit-function-theorem backward pass."""

    cg_iters: int = 100
    cg_tol: float = 1e-8
    # Tikhonov damping of the CG solve, (H + reg·I) z = ḡ_U: exact at 0 at
    # a strict minimum; a small value steadies loosely converged solves at
    # the price of a slightly biased gradient.
    reg: float = 0.0


def cg(matvec, b: torch.Tensor, tol: float, maxiter: int) -> torch.Tensor:
    """Conjugate gradients for A x = b from x = 0, as
    ``jax.scipy.sparse.linalg.cg(A, b, tol=tol, maxiter=maxiter)``: stops
    when r·r ≤ tol²·b·b or after ``maxiter`` iterations (one host read
    each)."""
    x = torch.zeros_like(b)
    r = b
    gamma = torch.sum(r * r)
    atol2 = tol * tol * torch.sum(b * b)
    p = r
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        Ap = matvec(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.sum(r * r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


def _step(system: System, x, u):
    """One step with reverse-mode derivatives in (x, u, params) to second
    order: the implicit rules through `newton_polish` from the converged
    point, the explicit ones as they are."""
    if system.integrator in IMPLICIT:
        with torch.no_grad():
            x1 = step(system, x.detach(), u.detach())
        return newton_polish(system, x1, x, u)
    return step(system, x, u)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class _Adjoint:
    """The first- and second-order adjoints of the rollout cost J(U) along
    (X, U), X the rollout of U, on the expansion and the dynamics' second
    derivatives there.

    Costates λ_N = ∇l_f, λ_k = l_x + f_xᵀ λ_{k+1}; with the stage
    Lagrangian L_k = l + λ_{k+1}·f, a direction v of U has the tangents
    δx_0 = 0, δx_{k+1} = f_x δx_k + f_u v_k and the second-order costates
    δλ_N = l_f,xx δx_N, δλ_k = L_xx δx_k + L_uxᵀ v_k + f_xᵀ δλ_{k+1}, and
    (∇²_UU J v)_k = L_ux δx_k + L_uu v_k + f_uᵀ δλ_{k+1}."""

    def __init__(self, system: System, X, U):
        self.exp = exp = linearize_trajectory(system, X, U)
        hess = dynamics_hessians(system, X, U)
        self.N = U.shape[0]
        self.A, self.B = exp.f_x, exp.f_u
        self.AT = exp.f_x.transpose(-1, -2)
        self.BT = exp.f_u.transpose(-1, -2)
        self.lam_next = lam_next = self.costates(exp.l_x, exp.v_x)
        self.L_xx = exp.l_xx + torch.einsum("ki,kiab->kab", lam_next,
                                            hess.f_xx)
        self.L_ux = exp.l_ux + torch.einsum("ki,kiab->kab", lam_next,
                                            hess.f_ux)
        self.L_uu = exp.l_uu + torch.einsum("ki,kiab->kab", lam_next,
                                            hess.f_uu)
        self.L_uxT = self.L_ux.transpose(-1, -2)

    def costates(self, c, last):
        """μ_N = last, μ_k = c_k + f_xᵀ μ_{k+1} (k = N−1 … 1): the
        stacked μ_{k+1}, k = 0 … N−1."""
        mu = [last]
        for k in range(self.N - 1, 0, -1):
            mu.append(torch.addmv(c[k], self.AT[k], mu[-1]))
        return torch.stack(mu[::-1])

    def tangents(self, v):
        """(δx_0 … δx_N, δλ_1 … δλ_N) of the direction v."""
        Bv = _mv(self.B, v)
        dx = [torch.zeros_like(self.exp.v_x)]
        for k in range(self.N):
            dx.append(torch.addmv(Bv[k], self.A[k], dx[-1]))
        DX = torch.stack(dx)
        c = _mv(self.L_xx, DX[:-1]) + _mv(self.L_uxT, v)
        return DX, self.costates(c, self.exp.v_xx @ DX[-1])

    def hvp(self, reg: float):
        """v ↦ (∇²_UU J + reg I) v."""
        def product(v):
            DX, dlam_next = self.tangents(v)
            h = (_mv(self.L_ux, DX[:-1]) + _mv(self.L_uu, v)
                 + _mv(self.BT, dlam_next))
            return h + reg * v if reg else h
        return product


def _tensor_leaves(params):
    return [t for _, t in leaves_with_path(params)
            if isinstance(t, torch.Tensor)]


def _with_leaves(params, leaves):
    """``params`` with its tensor leaves replaced by ``leaves`` in order."""
    it = iter(leaves)
    return map_leaves(lambda t: next(it) if isinstance(t, torch.Tensor)
                      else t, params)


def _param_grads(system: System, X, U, a, w_next, lam_next, DX, z):
    """∇_θ of Ψ(θ) = Σ_k [a l_k + w_{k+1}·f_k − D(l_k + λ_{k+1}·f_k)[δx_k,
    z_k]] + a l_f − D l_f[δx_N] at the floating parameter leaves θ, the
    states, controls and multipliers held: one vmap over the steps (the
    implicit rules by `newton_polish` from the converged X[k+1]).  With w
    = μ − δλ this is the direct term ∂_θ(a J + ⟨g_X, X⟩) less the implicit
    one, (∂G/∂θ)ᵀ z.  Returns one gradient or None per leaf."""
    leaves = [t.detach() for t in _tensor_leaves(system.params)]
    idx = [i for i, t in enumerate(leaves) if t.is_floating_point()]
    implicit = system.integrator in IMPLICIT

    def psi(*floating):
        ls = list(leaves)
        for i, t in zip(idx, floating):
            ls[i] = t
        sp = system.replace(params=_with_leaves(system.params, ls))
        p = sp.params

        def stage(x, u, x1, w, lam, dx, zk):
            def lf(xx, uu):
                f = newton_polish(sp, x1, xx, uu) if implicit \
                    else step(sp, xx, uu)
                return sp.stage_cost(p, xx, uu), f
            (l, f), (dl, df) = torch.func.jvp(lf, (x, u), (dx, zk))
            return a * l + w @ f - dl - lam @ df

        def term(x, dx):
            lf_, dlf = torch.func.jvp(lambda xx: sp.terminal_cost(p, xx),
                                      (x,), (dx,))
            return a * lf_ - dlf
        return (torch.func.vmap(stage)(X[:-1], U, X[1:], w_next, lam_next,
                                       DX[:-1], z).sum()
                + term(X[-1], DX[-1]))

    grads = torch.func.grad(psi, argnums=tuple(range(len(idx))))(
        *[leaves[i] for i in idx])
    out = [None] * len(leaves)
    for i, g in zip(idx, grads):
        out[i] = g
    return out


class _SolveIft(torch.autograd.Function):
    """(x0, U_init, *parameter leaves) ↦ (X, U, cost) of the converged
    solve; the whole solution rides along in ``box``."""

    @staticmethod
    def forward(ctx, system, config, ift, box, x0, U_init, *leaves):
        ctx.set_materialize_grads(False)
        detached = system.replace(params=_with_leaves(
            system.params, [t.detach() for t in leaves]))
        sol = solve(detached, x0.detach(), U_init.detach(), config)
        box.append(sol)
        ctx.system, ctx.ift = detached, ift
        ctx.save_for_backward(sol.X, sol.U)
        return sol.X, sol.U, sol.cost

    @staticmethod
    @full_f32_matmuls()
    def backward(ctx, g_X, g_U, g_cost):
        X, U = ctx.saved_tensors
        system, ift = ctx.system, ctx.ift
        adj = _Adjoint(system, X, U)
        exp = adj.exp
        # The direct term of F = g_cost J + ⟨g_X, X⟩ with U held, by the
        # costates μ_N = a ∇l_f + g_X[N], μ_k = a l_x + g_X[k] + f_xᵀ μ_{k+1}.
        a = 0.0 if g_cost is None else g_cost
        g_bar = torch.zeros_like(U) if g_U is None else g_U
        g_x0 = torch.zeros_like(X[0])
        w_next = torch.zeros_like(adj.lam_next)
        if g_X is not None or g_cost is not None:
            gX = torch.zeros_like(X) if g_X is None else g_X
            w_next = adj.costates(a * exp.l_x + gX[:-1], a * exp.v_x + gX[-1])
            g_bar = g_bar + a * exp.l_u + _mv(adj.BT, w_next)
            g_x0 = gX[0] + a * exp.l_x[0] + adj.AT[0] @ w_next[0]
        # dU*/dθ = −H⁻¹ ∂G/∂θ: the implicit term −(∂G/∂θ)ᵀ z, H z = ḡ_U,
        # and −(∂G/∂x0)ᵀ z = −δλ_0 with the tangents of z (δx_0 = 0).
        z = cg(adj.hvp(ift.reg), g_bar, ift.cg_tol, ift.cg_iters)
        DX, dlam_next = adj.tangents(z)
        g_x0 = g_x0 - (adj.L_uxT[0] @ z[0] + adj.AT[0] @ dlam_next[0])
        leaf_grads = _param_grads(system, X, U, a, w_next - dlam_next,
                                  adj.lam_next, DX, z)
        return (None, None, None, None, g_x0, torch.zeros_like(U),
                *leaf_grads)


@full_f32_matmuls()
def solve_implicit(
    system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    ift: IftConfig = IftConfig(),
) -> IlqrSolution:
    """iLQR solve that autograd differentiates with respect to the
    system's parameter tensors and ``x0``.

    The forward pass is ``solve(system, x0, U_init, config)``; the backward
    pass applies the implicit function theorem at the converged point (see
    the module docstring).  Gradients flow through ``X``, ``U`` and
    ``cost``.
    """
    if config.u_min is not None:
        raise ValueError(
            "solve_implicit requires the unconstrained solve; control limits "
            "change the stationarity condition (clamped arcs) in a way the "
            "IFT backward pass does not model"
        )
    x0, U_init = system.inputs(x0, U_init)
    box: list = []
    X, U, cost = _SolveIft.apply(system, config, ift, box, x0, U_init,
                                 *_tensor_leaves(system.params))
    return dataclasses.replace(box[0], X=X, U=U, cost=cost)


@full_f32_matmuls()
def run_mpc_implicit(
    solver_system: System,
    plant_system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    config: IlqrConfig = IlqrConfig(maxiter=10),
    ift: IftConfig = IftConfig(),
):
    """Closed-loop MPC that autograd differentiates end to end.

    The receding-horizon loop of `mpc.run_mpc` (shift-and-hold warm
    starts, solver/plant mismatch) with every solve by ``solve_implicit``
    and the graph carried from step to step, so the closed-loop cost
    differentiates with respect to the solver's and the plant's
    parameters and ``x0``.  Warm starts get no gradient (a converged solve
    does not depend on its initialization): keep ``config.maxiter`` high
    enough that each solve converges.  Returns ``(X, U, cost)``: closed-loop
    states (n_sim+1, n_x), applied controls (n_sim, n_u), accumulated plant
    cost plus the terminal cost.
    """
    x, U_warm = solver_system.inputs(x0, U_init)
    p = plant_system.params
    xs, us, cost = [], [], 0.0
    for _ in range(n_sim):
        sol = solve_implicit(solver_system, x, U_warm, config, ift)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        cost = cost + plant_system.stage_cost(p, x, u0)
        x = _step(plant_system, x, u0)
        U_warm = torch.cat([sol.U[1:], sol.U[-1:]], dim=0)
    cost = cost + plant_system.terminal_cost(p, x)
    return torch.stack(xs + [x]), torch.stack(us), cost
