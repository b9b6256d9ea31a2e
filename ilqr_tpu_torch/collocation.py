"""Direct collocation oracle: the same OCP as a simultaneous NLP.

PyTorch counterpart of `ilqr_tpu/collocation.py`.  The reference checks its
solver against a CasADi/IPOPT collocation NLP (states and controls as
decision variables, dynamics as equality constraints;
`nonlinear_iLQR.m:54-103`).  This is that oracle without CasADi: a damped
Newton-KKT SQP on z = (X₁…X_N, U₀…U_{N−1}),

    min  Σₖ l(xₖ, uₖ) + l_f(x_N)
    s.t. cₖ(z) = 0,   k = 0…N−1,

with two defect forms:

* ``defect='step'`` (default): cₖ = step(system, xₖ, uₖ) − xₖ₊₁, the
  system's own discrete dynamics, so the NLP optimum is the discrete
  optimum iLQR targets, for any integrator;
* ``defect='trapezoidal'``: cₖ = xₖ + dt/2·(f_c(xₖ, uₖ) + f_c(xₖ₊₁, uₖ))
  − xₖ₊₁, trapezoidal collocation on the continuous dynamics.

The derivative blocks of each step (the cost's gradients and Hessians, the
constraint Jacobians A, B, C and the Lagrangian Hessian W over (xₖ, uₖ,
xₖ₊₁), constraint curvature included) are `torch.func` vmaps over the
horizon of `grad`, `hessian` and `jacfwd`, on the system's device.  The
Newton algebra runs on the host: numpy assembly of the block-tridiagonal
KKT matrix, scipy's sparse LU (SuperLU), an ℓ1-merit backtracking line
search in a Python loop.  No Riccati recursion and no kernel: an oracle
independent of the solver stack.

Under the implicit integrators (backward Euler, trapezoidal) the 'step'
defect's W is the Hessian of `integrators.newton_polish` from the
converged step: nested forward mode through their `autograd.Function`
gives zeros (`ops/linearize.py::dynamics_hessians` does the same).

Precision: the oracle computes in float64 whatever the caller's dtype
(the system's parameters are converted), as JAX's runs under
``jax.enable_x64``; the returned tensors are float64, on the system's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.integrators import IMPLICIT, newton_polish, step
from ilqr_tpu_torch.ops.rollout import rollout
from ilqr_tpu_torch.utils.tree import map_leaves

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class CollocationSolution:
    X: Any              # (N+1, n_x) states (x0 prepended)
    U: Any              # (N, n_u) controls
    cost: Any           # scalar objective at the solution
    kkt_residual: Any   # scalar: max |∇L| ∪ |c| at the solution
    iterations: Any


def _as_f64(system: System) -> System:
    """The system with every floating parameter tensor in float64."""
    return system.replace(params=map_leaves(
        lambda t: t.to(F64) if isinstance(t, torch.Tensor)
        and t.is_floating_point() else t, system.params))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _make_eval_fns(system: System, defect: str, n_x: int, n_u: int):
    """The per-step derivative and merit evaluators (f64 system)."""
    dt = system.dt
    p = system.params
    implicit = defect == "step" and system.integrator in IMPLICIT
    vmap, grad, jacfwd = torch.func.vmap, torch.func.grad, torch.func.jacfwd

    def stage(x, u):
        return system.stage_cost(p, x, u)

    def terminal(x):
        return system.terminal_cost(p, x)

    def con(x, u, xn):
        # c_k(x_k, u_k, x_{k+1}) for one step.
        if defect == "step":
            return step(system, x, u) - xn
        f = system.f_cont
        return x + 0.5 * dt * (f(p, x, u) + f(p, xn, u)) - xn

    def lag_w(w, lam, x1):
        """c_k(w)·λ_k; under the implicit rules the step is `newton_polish`
        from x1, the converged step at w, which has its second
        derivatives."""
        x, u, xn = w[:n_x], w[n_x:n_x + n_u], w[n_x + n_u:]
        if implicit:
            return (newton_polish(system, x1, x, u) - xn) @ lam
        return con(x, u, xn) @ lam

    def derivs(X, U, lam):
        """All KKT blocks at (X, U, lam), vmapped over the horizon, as
        numpy arrays."""
        Xk, Xn = X[:-1], X[1:]
        X1 = step(system, Xk, U) if implicit else Xn
        d = dict(
            lx=vmap(grad(stage, argnums=0))(Xk, U),
            lu=vmap(grad(stage, argnums=1))(Xk, U),
            lxx=vmap(torch.func.hessian(stage, argnums=0))(Xk, U),
            luu=vmap(torch.func.hessian(stage, argnums=1))(Xk, U),
            lux=vmap(jacfwd(grad(stage, argnums=1), argnums=0))(Xk, U),
            lfx=grad(terminal)(X[-1]),
            lfxx=torch.func.hessian(terminal)(X[-1]),
            c=vmap(con)(Xk, U, Xn),
            A=vmap(jacfwd(con, argnums=0))(Xk, U, Xn),
            B=vmap(jacfwd(con, argnums=1))(Xk, U, Xn),
            C=vmap(jacfwd(con, argnums=2))(Xk, U, Xn),
            W=vmap(jacfwd(jacfwd(lag_w, argnums=0), argnums=0))(
                torch.cat([Xk, U, Xn], dim=1), lam, X1),
        )
        return {k: _host(v) for k, v in d.items()}

    def obj_con(X, U):
        cost = torch.sum(vmap(stage)(X[:-1], U)) + terminal(X[-1])
        return cost, vmap(con)(X[:-1], U, X[1:])

    def merit_candidates(X, U, dX, dU, alphas, rho):
        out = []
        for a in alphas:
            cost, c = obj_con(X + a * dX, U + a * dU)
            out.append(float(cost) + rho * float(torch.sum(torch.abs(c))))
        return np.asarray(out)

    return derivs, obj_con, merit_candidates


def _assemble_kkt(d, N, n_x, n_u, mu):
    """Block-tridiagonal KKT matrix + residual in interleaved ordering.

    Variable block k (k = 0…N−1): [u_k (n_u), λ_k (n_x), x_{k+1} (n_x)];
    x_0 is data, not a variable.  Constraint c_k couples (x_k, u_k, x_{k+1})
    and the stage cost couples (x_k, u_k), so every nonzero lives within two
    adjacent blocks: bandwidth O(n_x + n_u), independent of N.
    """
    m = n_u + 2 * n_x
    n = N * m
    iu = np.arange(N) * m                     # u_k start
    il = iu + n_u                             # λ_k start
    ix = il + n_x                             # x_{k+1} start
    # Column index of x_k as a variable: ix[k-1] for k ≥ 1; x_0 is fixed.
    ixk = np.concatenate([[-1], ix[:-1]])     # -1 marks "not a variable"

    rows, cols, vals = [], [], []

    def put(r0, c0, block):
        """Scatter dense (N, a, b) blocks at per-step offsets r0, c0 (N,)."""
        _, a, b = block.shape
        r = r0[:, None, None] + np.arange(a)[None, :, None]
        cc = c0[:, None, None] + np.arange(b)[None, None, :]
        keep = (r0 >= 0)[:, None, None] & (c0 >= 0)[:, None, None]
        keep = np.broadcast_to(keep, block.shape)
        rows.append(np.broadcast_to(r, block.shape)[keep])
        cols.append(np.broadcast_to(cc, block.shape)[keep])
        vals.append(block[keep])

    def put_sym(r0, c0, block):
        put(r0, c0, block)
        put(c0, r0, np.swapaxes(block, 1, 2))

    # Hessian of the Lagrangian (exact): stage-cost blocks + constraint
    # curvature W_k over (x_k, u_k, x_{k+1}) + terminal l_f_xx.
    put(iu, iu, d["luu"])
    put(ixk, ixk, d["lxx"])
    put_sym(iu, ixk, d["lux"])
    put(ix[-1:], ix[-1:], d["lfxx"][None])
    W = d["W"]
    sl_x, sl_u, sl_n = (slice(0, n_x), slice(n_x, n_x + n_u),
                        slice(n_x + n_u, None))
    put(ixk, ixk, W[:, sl_x, sl_x])
    put(iu, iu, W[:, sl_u, sl_u])
    put(ix, ix, W[:, sl_n, sl_n])
    put_sym(iu, ixk, W[:, sl_u, sl_x])
    put_sym(ix, ixk, W[:, sl_n, sl_x])
    put_sym(ix, iu, W[:, sl_n, sl_u])
    # Levenberg damping on the primal diagonal only.
    prim = np.concatenate([(iu[:, None] + np.arange(n_u)).ravel(),
                           (ix[:, None] + np.arange(n_x)).ravel()])
    rows.append(prim)
    cols.append(prim)
    vals.append(np.full(prim.shape, mu))
    # Constraint Jacobian rows (λ_k) and symmetric transposes.
    put_sym(il, ixk, d["A"])
    put_sym(il, iu, d["B"])
    put_sym(il, ix, d["C"])

    KKT = scipy.sparse.csc_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))

    # Residual (negated RHS): stationarity wrt u_k / x_k, and c_k.
    lam = d["lam"]
    r_u = d["lu"] + np.einsum("kiu,ki->ku", d["B"], lam)
    r_x = np.empty((N, n_x))
    r_x[:-1] = (d["lx"][1:]
                + np.einsum("kij,ki->kj", d["A"][1:], lam[1:])
                + np.einsum("kij,ki->kj", d["C"][:-1], lam[:-1]))
    r_x[-1] = d["lfx"] + d["C"][-1].T @ lam[-1]
    rhs = np.zeros(n)
    rhs[(iu[:, None] + np.arange(n_u)).ravel()] = -r_u.ravel()
    rhs[(ix[:, None] + np.arange(n_x)).ravel()] = -r_x.ravel()
    rhs[(il[:, None] + np.arange(n_x)).ravel()] = -d["c"].ravel()
    kkt_inf = max(np.max(np.abs(r_u)), np.max(np.abs(r_x)),
                  np.max(np.abs(d["c"])))
    return KKT, rhs, kkt_inf, (iu, il, ix)


@full_f32_matmuls()
def solve_collocation(
    system: System,
    x0,
    U_init,
    defect: str = "step",
    maxiter: int = 150,
    tol: float = 1e-6,
    damping: float = 1e-6,
    X_init=None,
) -> CollocationSolution:
    """Solve the OCP as a simultaneous NLP (sparse damped Newton-KKT, f64).

    ``X_init=None`` seeds the states with the rollout of ``U_init`` (a
    feasible start); pass e.g. a straight-line interpolation to start
    infeasible: collocation does not need dynamically consistent iterates.
    """
    if defect not in ("step", "trapezoidal"):
        raise ValueError(f"defect must be 'step'|'trapezoidal', got {defect}")
    system = _as_f64(system)
    x0, U = system.inputs(x0, U_init)
    N, n_u = U.shape
    n_x = x0.shape[0]
    derivs, obj_con, merit_candidates = _make_eval_fns(system, defect, n_x,
                                                       n_u)
    if X_init is None:
        X, _ = rollout(system, x0, U)
    else:
        X = torch.cat([x0[None], system.inputs(X_init)[1:]])
    lam = torch.zeros((N, n_x), dtype=F64, device=x0.device)
    alphas = [0.5 ** i for i in range(16)]

    def kkt(X, U, lam, mu):
        d = derivs(X, U, lam)
        d["lam"] = _host(lam)
        return _assemble_kkt(d, N, n_x, n_u, mu)

    mu = float(damping)
    iters = 0
    kkt_inf = np.inf
    for _ in range(maxiter):
        KKT, rhs, kkt_inf, (iu, il, ix) = kkt(X, U, lam, mu)
        if kkt_inf < tol:
            break
        iters += 1
        sol = scipy.sparse.linalg.spsolve(KKT, rhs)
        if not np.all(np.isfinite(sol)):
            mu = max(mu, damping) * 10.0
            if mu > 1e8:
                break
            continue

        def block(i0, n):
            return torch.as_tensor(
                sol[(i0[:, None] + np.arange(n)).ravel()].reshape(N, n),
                dtype=F64, device=x0.device)

        dU, dXt, dlam = block(iu, n_u), block(ix, n_x), block(il, n_x)
        dX = torch.cat([torch.zeros((1, n_x), dtype=F64, device=x0.device),
                        dXt])

        # ℓ1-merit backtracking (first improving α); the exact-penalty
        # weight must dominate the multipliers.
        rho = max(10.0, 2.0 * float(torch.max(torch.abs(lam + dlam))))
        cand = merit_candidates(X, U, dX, dU, alphas, rho)
        cost0, c0 = obj_con(X, U)
        m0 = float(cost0) + rho * float(torch.sum(torch.abs(c0)))
        ok = np.isfinite(cand) & (cand < m0)
        if ok.any():
            a = alphas[int(np.argmax(ok))]
            X = X + a * dX
            U = U + a * dU
            lam = lam + a * dlam
            # Adaptive floor: strong Levenberg damping globalizes the stiff
            # swing-up cascades far from the solution, but a fixed floor
            # stalls the Newton tail: the floor tracks the KKT residual so
            # that the final iterations are (near-)undamped.
            mu = max(mu * 0.3, min(damping, kkt_inf))
        else:
            mu = max(mu, damping) * 10.0
            if mu > 1e8:
                break

    # kkt_inf above is measured at the top of the loop, before the final
    # accepted step: on a maxiter exit it is one iterate stale.
    kkt_inf = kkt(X, U, lam, mu)[2]
    cost, _ = obj_con(X, U)
    return CollocationSolution(
        X=X, U=U, cost=cost,
        kkt_residual=torch.tensor(kkt_inf, dtype=F64, device=X.device),
        iterations=torch.tensor(iters))


# ---------------------------------------------------------------------------
# Inequality-constrained oracle: log-barrier continuation on the Newton-KKT
# collocation solver above.  For a decreasing barrier weight μ_b, solve the
# equality-constrained barrier NLP
#
#     min  Σ l(x,u) − μ_b·Σ log(−g(x,u))   s.t. dynamics defects = 0
#
# with `solve_collocation` (the barrier terms ride the stage and terminal
# costs), warm-starting each level from the previous one.  Infeasible
# line-search candidates give NaN barrier values, which the ℓ1 merit's
# isfinite gate rejects.  At the final level the stationarity residual of
# the barrier problem is that of the original KKT system with multiplier
# estimates z = μ_b/(−g) ≥ 0, and the complementarity gap is μ_b per
# constraint; both are reported.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstrainedCollocationSolution:
    X: Any              # (N+1, n_x) states (f64)
    U: Any              # (N, n_u) controls (f64)
    cost: Any           # scalar original objective (no barrier terms)
    kkt_residual: Any   # stationarity + feasibility of the original KKT
    comp_gap: Any       # complementarity gap per constraint (= final μ_b)
    violation: Any      # max(0, g) over all stages (≤ 0 means feasible)
    iterations: Any     # total inner Newton iterations


def _barrier_system(system: System, cons, mu_b: float) -> System:
    """Wrap a system so that its costs carry the −μ_b·Σlog(−g) barrier
    terms of the constraint set ``cons`` (`constrained.ConstraintSet`)."""
    base_f = system.f_cont
    base_l = system.stage_cost
    base_lf = system.terminal_cost
    gi, gt = cons.stage_ineq, cons.terminal_ineq

    def f_cont(params, x, u):
        return base_f(params["base"], x, u)

    def stage(params, x, u):
        c = base_l(params["base"], x, u)
        g = gi(params["cp"], x, u)
        if g.shape[-1]:
            c = c - params["mu_b"] * torch.sum(torch.log(-g), dim=-1)
        return c

    def term(params, x):
        c = base_lf(params["base"], x)
        g = gt(params["cp"], x)
        if g.shape[-1]:
            c = c - params["mu_b"] * torch.sum(torch.log(-g), dim=-1)
        return c

    mu = torch.tensor(mu_b, dtype=F64, device=system.device)
    return system.replace(
        params=dict(base=system.params, cp=cons.params, mu_b=mu),
        f_cont=f_cont, stage_cost=stage, terminal_cost=term)


def solve_collocation_constrained(
    system: System,
    constraints,
    x0,
    U_init,
    defect: str = "step",
    mu_b0: float = 1.0,
    mu_b_min: float = 1e-6,
    mu_b_factor: float = 0.1,
    maxiter_inner: int = 60,
    tol: float = 1e-7,
    X_init=None,
) -> ConstrainedCollocationSolution:
    """Inequality-constrained OCP as a barrier-collocation NLP (f64, host).

    ``constraints`` is a `constrained.ConstraintSet` with inequality blocks
    only (g ≤ 0; equality blocks beyond the dynamics are not supported
    here).  The seed must be strictly feasible: every g(x_k, u_k) < 0 along
    the rollout of ``U_init`` (or along ``X_init``); barrier methods start
    inside the feasible region.
    """
    system = _as_f64(system)
    x0, U = system.inputs(x0, U_init)
    cons = dataclasses.replace(constraints, params=map_leaves(
        lambda t: torch.as_tensor(t, dtype=F64, device=x0.device),
        constraints.params))
    p = cons.params
    if cons.stage_eq(p, x0, U[0]).shape[-1] or cons.terminal_eq(
            p, x0).shape[-1]:
        raise ValueError(
            "solve_collocation_constrained handles inequality blocks only "
            "(stage/terminal equality constraints beyond the dynamics are "
            "not supported)")

    X = X_init
    total_iters = 0
    mu_b = float(mu_b0)
    while True:
        wrapped = _barrier_system(system, cons, mu_b)
        # The inner tolerance tracks the barrier level (solving each level
        # to death wastes Newton steps: Fiacco-McCormick).
        inner_tol = max(tol, 1e-2 * mu_b)
        sol = solve_collocation(wrapped, x0, U, defect=defect,
                                maxiter=maxiter_inner, tol=inner_tol,
                                X_init=X)
        X, U = sol.X, sol.U
        total_iters += int(sol.iterations)
        kkt = float(sol.kkt_residual)
        if mu_b <= mu_b_min:
            break
        mu_b = max(mu_b * mu_b_factor, mu_b_min)

    # The original objective and the violation at the solution.
    vmap = torch.func.vmap
    cost = (torch.sum(vmap(lambda x, u: system.stage_cost(
        system.params, x, u))(X[:-1], U))
        + system.terminal_cost(system.params, X[-1]))
    gs = vmap(lambda x, u: cons.stage_ineq(p, x, u))(X[:-1], U)
    gt = cons.terminal_ineq(p, X[-1])
    parts = [t.max() for t in (gs, gt) if t.numel()]
    viol = (torch.clamp(torch.stack(parts).max(), min=0.0) if parts
            else torch.tensor(0.0, dtype=F64, device=X.device))
    return ConstrainedCollocationSolution(
        X=X, U=U, cost=cost,
        kkt_residual=torch.tensor(kkt, dtype=F64, device=X.device),
        comp_gap=torch.tensor(mu_b, dtype=F64, device=X.device),
        violation=viol,
        iterations=torch.tensor(total_iters))
