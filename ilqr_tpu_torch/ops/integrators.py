"""Discrete-time step functions from continuous dynamics.

PyTorch counterpart of `ilqr_tpu/ops/integrators.py`: explicit Euler,
midpoint (RK2), RK4, 'discrete' (f_cont is the map itself), and the implicit
backward-Euler and trapezoidal rules.

The implicit rules run a fixed number of quasi-Newton corrections with the
Jacobian evaluated once at the explicit-Euler predictor and inverted once
(stale inverse), as the JAX package does.  Their tangents come from the
implicit-function theorem at the converged point: each rule is a
`torch.autograd.Function` with a forward-mode ``jvp`` and
``generate_vmap_rule=True``, so `torch.func.jacfwd` under `torch.func.vmap`
gives the exact IFT Jacobian rather than differentiating the Newton loop.
Tangents with respect to the parameters are not carried (the differentiable
solve of ROADMAP A18 needs them).  Nested forward mode does not reach
through the tangent rule (torch gives zero second derivatives there), so
second derivatives come from `newton_polish`: exact Newton steps on the
rule's residual from the converged point.

Every rule accepts a single state (n_x,) or a batch (..., n_x).
"""
from __future__ import annotations

import torch

from ilqr_tpu_torch.models.base import System


def _euler(f, dt, x, u):
    return x + dt * f(x, u)


def _midpoint(f, dt, x, u):
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    return x + dt * k2


def _rk4(f, dt, x, u):
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _jac_x(f, x, u):
    """∂f/∂x at (x, u), batched over the leading axes of ``x``.

    Outside any `torch.func` transform (the rollouts) the rows come from
    n_x reverse-mode passes over the batch — the points are independent, so
    the gradient of a batch sum is each point's own row — which costs a
    fraction of `jacfwd`'s per-op overhead in eager mode.  Under a
    transform (linearization) `jacfwd` composes with it.  Whether a
    transform is active is read from functorch's interpreter stack, a
    private torch API (present since torch 2.0).
    """
    if torch._C._functorch.peek_interpreter_stack() is None:
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            y = f(xr, u)
            n = y.shape[-1]
            rows = [torch.autograd.grad(y[..., i].sum(), xr,
                                        retain_graph=i < n - 1)[0]
                    for i in range(n)]
        return torch.stack(rows, dim=-2)
    jac = torch.func.jacfwd(f, argnums=0)
    if x.ndim == 1:
        return jac(x, u)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    uf = torch.broadcast_to(u, lead + u.shape[-1:]).reshape(-1, u.shape[-1])
    J = torch.func.vmap(jac)(xf, uf)
    return J.reshape(lead + J.shape[-2:])


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def _be_solve(f, dt, newton_iters, x, u):
    """x1 = x + dt*f(x1, u) by quasi-Newton with a stale inverse."""
    x1 = x + dt * f(x, u)  # explicit-Euler predictor
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    Ji = torch.linalg.inv(eye - dt * _jac_x(f, x1, u))
    for _ in range(newton_iters):
        x1 = x1 - _matvec(Ji, x1 - x - dt * f(x1, u))
    return x1


def _trap_solve(f, dt, newton_iters, x, u):
    """x1 = x + dt/2*(f(x, u) + f(x1, u)) by quasi-Newton."""
    f0 = f(x, u)
    x1 = x + dt * f0
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    Ji = torch.linalg.inv(eye - 0.5 * dt * _jac_x(f, x1, u))
    for _ in range(newton_iters):
        x1 = x1 - _matvec(Ji, x1 - x - 0.5 * dt * (f0 + f(x1, u)))
    return x1


def _u_tangent(f, x1, u, du):
    """(∂f/∂u)·du at (x1, u) with x1 held fixed."""
    return torch.func.jvp(lambda v: f(x1, v), (u,), (du,))[1]


class _BackwardEuler(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, u, f, dt, newton_iters):
        return _be_solve(f, dt, newton_iters, x, u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, u, f, dt, _ = inputs
        ctx.f, ctx.dt = f, dt
        ctx.save_for_forward(x, u, output)

    @staticmethod
    def jvp(ctx, dx, du, *_):
        """IFT: (I − dt·J_x(x1)) dx1 = dx + dt·J_u(x1)·du."""
        x, u, x1 = ctx.saved_tensors
        f, dt = ctx.f, ctx.dt
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        A = eye - dt * _jac_x(f, x1, u)
        rhs = torch.zeros_like(x1) if dx is None else dx
        if du is not None:
            rhs = rhs + dt * _u_tangent(f, x1, u, du)
        return torch.linalg.solve(A, rhs)


class _Trapezoidal(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, u, f, dt, newton_iters):
        return _trap_solve(f, dt, newton_iters, x, u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, u, f, dt, _ = inputs
        ctx.f, ctx.dt = f, dt
        ctx.save_for_forward(x, u, output)

    @staticmethod
    def jvp(ctx, dx, du, *_):
        """IFT at the converged point:
        (I − dt/2·J_x(x1)) dx1 = dx + dt/2·(df(x, u) + df(x1, u)|x1 fixed)."""
        x, u, x1 = ctx.saved_tensors
        f, dt = ctx.f, ctx.dt
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        A = eye - 0.5 * dt * _jac_x(f, x1, u)
        dx = torch.zeros_like(x) if dx is None else dx
        du = torch.zeros_like(u) if du is None else du
        d_f0 = torch.func.jvp(f, (x, u), (dx, du))[1]
        d_f1 = _u_tangent(f, x1, u, du)
        return torch.linalg.solve(A, dx + 0.5 * dt * (d_f0 + d_f1))


IMPLICIT = ("backward_euler", "trapezoidal")


def _residual(system: System, x1, x, u):
    """The implicit rule's residual G(x1; x, u), zero at the step's x1."""
    p, dt = system.params, system.dt
    if system.integrator == "backward_euler":
        return x1 - x - dt * system.f_cont(p, x1, u)
    return x1 - x - 0.5 * dt * (system.f_cont(p, x, u)
                                + system.f_cont(p, x1, u))


def newton_polish(system: System, x1, x, u):
    """Two exact Newton steps on an implicit rule's residual from x1, one
    point (x (n_x,), u (n_u,)).

    From the converged x1 = step(x, u), held constant, one step reproduces
    the implicit solution to first order in (x, u) only; the second, by
    Newton's quadratic convergence, to third order, so the first and second
    derivatives of the result are those of the implicit step.  Exactly two
    are needed: `linearize.dynamics_hessians` differentiates this twice
    where nested forward mode cannot reach through the tangent rule.
    """
    for _ in range(2):
        G_y = torch.func.jacfwd(lambda y: _residual(system, y, x, u))(x1)
        # inv, not linalg.solve: under vmap of nested jacfwd, solve gives
        # wrong tangents at every other batch entry (torch 2.13).
        x1 = x1 - _matvec(torch.linalg.inv(G_y), _residual(system, x1, x, u))
    return x1


def step(system: System, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One discrete dynamics step under the system's integrator."""
    p, dt = system.params, system.dt

    def f(xx, uu):
        return system.f_cont(p, xx, uu)

    name = system.integrator
    if name == "euler":
        return _euler(f, dt, x, u)
    if name == "midpoint":
        return _midpoint(f, dt, x, u)
    if name == "rk4":
        return _rk4(f, dt, x, u)
    if name == "backward_euler":
        return _BackwardEuler.apply(x, u, f, dt, system.newton_iters)
    if name == "trapezoidal":
        return _Trapezoidal.apply(x, u, f, dt, system.newton_iters)
    if name == "discrete":
        return f(x, u)
    raise ValueError(f"Unknown integrator {name!r}")
