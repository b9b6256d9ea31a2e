"""iLQR solver: a host loop over device tensors.

PyTorch counterpart of `ilqr_tpu/solver.py`.  The JAX solver is one
`lax.while_loop`; here the loop runs on the host and makes one scalar sync
per iteration (the candidate costs, the ``ok`` flag and max |u_ff| come back
together).  The accept rules are the JAX ones:

* the whole α schedule is rolled out at once and the first α whose cost
  does not exceed the current cost is accepted (the parallel-in-time
  engines first try the first α alone, see `_parallel_linesearch`);
* the solve stops when no α is accepted (LINESEARCH_FAILED);
* convergence, |Δcost| ≤ tol, is tested at the top of every iteration but
  the first;
* ``cost_trace``, ``alpha_trace`` and ``grad_trace`` are nan-padded.

Engines: ``backward`` is 'scan' (sequential Riccati), 'pscan' (associative
scan) or 'pallas' (the hand-written CUDA backward pass of
`ops/fused_riccati.py`, or for n_u > 6 the suffix-scan kernel of
`ops/suffix_scan.py`); ``rollout`` is 'scan' (the host-loop rollout
batch), 'pallas' (the CUDA rollout kernels of `ops/fused_rollout.py`:
candidate costs first, then only the accepted α is materialized; the
initial rollout too, open loop), 'defect'
(parallel-in-time Newton sweeps, `ops/parallel_rollout.py`) or 'chunked'
(multiple-shooting chunks, `ops/chunked_rollout.py`); ``init_rollout`` is
'scan' or 'defect'; ``defect_engine`` picks the sweeps' affine prefix scan
('pallas'/'auto': the CUDA kernel of `ops/affine_scan.py` on CUDA tensors;
'xla': its plain version).  'auto' resolves to 'scan' on every device
until end-to-end GPU measurements set a rule.  The engine names are the
JAX ones, so a JAX config carries over.

Control limits (``u_min``/``u_max``), full DDP (``ddp``) and iLQG
(``noise``) change the backward pass: 'scan'/'auto' run the sequential
box-QP (`riccati.backward_pass_limited`) and second-order recursions,
'pscan'/'pallas' their parallel forms (`ops/limited_parallel.py`,
`parallel_riccati.backward_pass_ddp_parallel`), whose suffix scans go
through kernel B6 under 'pallas'.  Limits also clip every rollout.
``adaptive_reg`` divides the regularization by ``reg_factor`` after an
accepted step and, after a failed line search, multiplies it and retries.

`solve_batch` is the port's ``jax.vmap(solve)``: B independent problems in
one host loop, with per-instance masks (see its docstring), under every
option above, the parallel-in-time line searches and their latch
included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ilqr_tpu_torch.ilqg import noise_expansion, noise_expansion_batched
from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.batched import (
    backward_pass_batched,
    closed_loop_rollout_batched,
    linesearch_costs_batched,
    open_loop_rollout_batched,
    vmap_backward,
)
from ilqr_tpu_torch.ops.chunked_rollout import (
    chunked_rollout,
    coarse_chunk_len,
    linesearch_chunked_rollouts,
    linesearch_chunked_rollouts_batched,
)
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.ops.fused_rollout import (
    closed_loop_rollout_fused,
    linesearch_costs_fused,
    open_loop_rollout_fused,
)
from ilqr_tpu_torch.ops.limited_parallel import backward_pass_limited_parallel
from ilqr_tpu_torch.ops.linearize import (
    dynamics_hessians,
    dynamics_hessians_batched,
    linearize_trajectory,
    linearize_trajectory_batched,
)
from ilqr_tpu_torch.ops.parallel_riccati import (
    backward_pass_associative,
    backward_pass_ddp_parallel,
)
from ilqr_tpu_torch.ops.parallel_rollout import (
    defect_rollout,
    linesearch_defect_rollouts,
    linesearch_defect_rollouts_batched,
    open_loop_defect_rollout,
)
from ilqr_tpu_torch.ops.riccati import backward_pass, backward_pass_limited
from ilqr_tpu_torch.ops.rollout import linesearch_rollouts, rollout
from ilqr_tpu_torch.ops.suffix_scan import backward_pass_suffix_scan

# Solve status codes (returned in IlqrSolution.status).
RUNNING, CONVERGED, LINESEARCH_FAILED, MAXITER = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class IlqrConfig:
    """Solver configuration: the fields, defaults, accepted strings and
    validation of `ilqr_tpu.solver.IlqrConfig`."""

    maxiter: int = 100
    tol: float = 1e-5
    alpha0: float = 1.0
    alpha_factor: float = 0.5
    n_alphas: int = 10
    min_alpha: float = 1e-8
    backward: str = "auto"
    ddp: bool = False
    ddp_sweeps: int = 3
    rollout: str = "auto"
    defect_iters: int = 8
    defect_tol: float = 1e-3
    chunk_len: int = 0
    init_rollout: str = "auto"
    defect_engine: str = "auto"
    reg_init: float = 0.0
    reg_factor: float = 10.0
    reg_max: float = 1e9
    adaptive_reg: bool = False
    u_min: Any = None
    u_max: Any = None
    boxqp_iters: int = 8
    active_set_sweeps: int = 12
    noise: Any = None

    def __post_init__(self):
        if self.backward not in ("auto", "scan", "pscan", "pallas"):
            raise ValueError(
                f"backward must be 'auto'|'scan'|'pscan'|'pallas', "
                f"got {self.backward!r}"
            )
        if self.rollout not in ("auto", "scan", "pallas", "defect", "chunked"):
            raise ValueError(
                f"rollout must be 'auto'|'scan'|'pallas'|'defect'|'chunked', "
                f"got {self.rollout!r}"
            )
        if self.init_rollout not in ("auto", "scan", "defect"):
            raise ValueError(
                f"init_rollout must be 'auto'|'scan'|'defect', "
                f"got {self.init_rollout!r}"
            )
        if self.defect_engine not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"defect_engine must be 'auto'|'pallas'|'xla', "
                f"got {self.defect_engine!r}"
            )
        if (self.u_min is None) != (self.u_max is None):
            raise ValueError("u_min and u_max must be set together")
        if self.u_min is not None:
            if self.rollout not in ("auto", "scan", "defect", "chunked"):
                raise ValueError(
                    "control limits require rollout='scan', 'defect' or "
                    "'chunked' (the pallas rollout kernels do not clamp)")
        if self.ddp_sweeps < 1:
            raise ValueError(f"ddp_sweeps must be >= 1, got {self.ddp_sweeps}")
        if self.maxiter < 1:
            raise ValueError(f"maxiter must be >= 1, got {self.maxiter}")

    def resolved_backward(self) -> str:
        return "scan" if self.backward == "auto" else self.backward

    def resolved_rollout(self) -> str:
        return "scan" if self.rollout == "auto" else self.rollout

    def resolved_init_rollout(self) -> str:
        return "scan" if self.init_rollout == "auto" else self.init_rollout

    def limit_arrays(self, n_u: int, dtype, device=None):
        """(lo, hi) broadcast to (n_u,), or None if unconstrained."""
        if self.u_min is None:
            return None
        return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                     .broadcast_to((n_u,)) for v in (self.u_min, self.u_max))

    def alpha_schedule(self) -> Tuple[float, ...]:
        """The backtracking schedule (α0, α0·γ, …), truncated at min_alpha."""
        out, a = [], self.alpha0
        for _ in range(self.n_alphas):
            out.append(a)
            a *= self.alpha_factor
            if a < self.min_alpha:
                break
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class IlqrSolution:
    """A solve's result.  From `solve_batch` every field gains a leading
    batch axis B, and ``iterations``, ``status`` and ``defect_latch`` are
    (B,) tensors (int64, int64, bool) instead of Python scalars."""

    X: torch.Tensor            # (N+1, n_x) optimal state trajectory
    U: torch.Tensor            # (N, n_u) optimal controls
    cost: torch.Tensor         # 0-d converged cost
    iterations: int            # number of outer iterations executed
    status: int                # CONVERGED / LINESEARCH_FAILED / MAXITER
    u_ff: torch.Tensor         # (N, n_u) last accepted feedforward
    K: torch.Tensor            # (N, n_u, n_x) last accepted feedback gains
    cost_trace: torch.Tensor   # (maxiter,) cost after each iteration
    alpha_trace: torch.Tensor  # (maxiter,) accepted α per iteration
    grad_trace: torch.Tensor   # (maxiter,) max |u_ff| per iteration
    # Final state of the parallel line-search latch: True while the
    # 'defect'/'chunked' line search was still certifying when the solve
    # ended.  Feed it back as `solve(..., defect_latch=...)` to warm-start a
    # related solve; always False for the other line-search engines.
    defect_latch: bool = False


def _backward(exp, U, reg: float, config: IlqrConfig, limits=None,
              hess=None, noise=None):
    """The backward pass under ``config.backward`` for the problem's
    options: box limits, DDP Hessians, iLQG noise terms."""
    backward = config.resolved_backward()
    parallel = backward in ("pscan", "pallas")
    engine = "pallas" if backward == "pallas" else "xla"
    if limits is not None:
        if parallel:
            return backward_pass_limited_parallel(
                exp, U, *limits, reg, sweeps=config.active_set_sweeps,
                engine=engine, hess=hess, noise=noise)
        return backward_pass_limited(exp, U, *limits, reg,
                                     qp_iters=config.boxqp_iters, hess=hess,
                                     noise=noise)
    if hess is not None or noise is not None:
        if parallel:
            return backward_pass_ddp_parallel(
                exp, reg, hess=hess, noise=noise, sweeps=config.ddp_sweeps,
                engine=engine)
        return backward_pass(exp, reg, hess=hess, noise=noise)
    if backward == "pscan":
        return backward_pass_associative(exp, reg)
    if backward == "pallas":
        # B1 takes n_u <= 6, as JAX's fused kernel; wider controls scan
        # prebuilt elements through B6.
        if exp.l_u.shape[-1] <= 6:
            return backward_pass_fused(exp, reg)
        return backward_pass_suffix_scan(exp, reg)
    return backward_pass(exp, reg)


def _initial_rollout(system: System, x0, U, config: IlqrConfig):
    """(X, cost) of U from x0.  init_rollout='defect' runs the parallel
    Newton sweeps and falls back to the sequential rollout unless their
    defect certifies below defect_tol; otherwise rollout='pallas' runs the
    open-loop entry of the B2 kernels (as JAX's solver runs the chain as
    one device program), and the rest the plain rollout."""
    if config.resolved_init_rollout() == "defect":
        X, cost, defect = open_loop_defect_rollout(
            system, x0, U, iters=config.defect_iters,
            engine=config.defect_engine, exit_tol=1e-3 * config.defect_tol)
        if float(defect) < config.defect_tol:
            return X, cost
    elif config.resolved_rollout() == "pallas":
        return open_loop_rollout_fused(system, x0, U)
    return rollout(system, x0, U)


def _parallel_linesearch(system: System, x0, alphas, X, U, cost, u_ff, K,
                         exp, config: IlqrConfig, limits=None):
    """The two-phase line search of rollout='defect'|'chunked'.

    Returns (X_c, U_c, costs, certified, par_success): candidate
    trajectories (leading α axis), their costs (tensor), which of them the
    accept rule may take (numpy bool), and whether the parallel path
    answered (False: the exact sequential rollouts did).

    Phase 1 sweeps the first α alone and ends the search if it certifies
    and improves.  Phase 2 sweeps the whole schedule with one shared scan;
    its answer stands only if some certified candidate improves and no
    uncertified candidate comes before the first of them (accepting the
    first improving α needs every earlier cost).  Otherwise the exact
    rollouts decide.  Tolerances scale with the trajectory: defects are
    certified below defect_tol·(1 + max|X|), sweeps exit at 1e-3 of that.
    """
    n_alpha = alphas.shape[0]
    cert_tol = config.defect_tol * (1.0 + float(X.abs().max()))
    exit_tol = 1e-3 * cert_tol
    A_cl = exp.f_x + exp.f_u @ K
    if config.resolved_rollout() == "chunked":
        X1, U1, c1, d1 = chunked_rollout(
            system, x0, alphas[0], X, U, u_ff, K, A_cl,
            sweeps=config.defect_iters, chunk_len=config.chunk_len,
            exit_tol=exit_tol, u_limits=limits)
    else:
        X1, U1, c1, d1 = defect_rollout(
            system, x0, alphas[0], X, U, u_ff, K, A_cl,
            iters=config.defect_iters, engine=config.defect_engine,
            exit_tol=exit_tol, u_limits=limits)
    c1_h, d1_h = torch.stack([c1, d1]).cpu().numpy()
    if d1_h < cert_tol and np.isfinite(c1_h) and c1_h <= cost:
        costs = torch.full((n_alpha,), torch.inf, dtype=c1.dtype,
                           device=c1.device)
        costs[0] = c1
        certified = np.arange(n_alpha) == 0
        return X1[None], U1[None], costs, certified, True

    if config.resolved_rollout() == "chunked":
        X_c, U_c, costs, defects = linesearch_chunked_rollouts(
            system, x0, alphas, X, U, u_ff, K, A_cl,
            sweeps=config.defect_iters,
            chunk_len=config.chunk_len or coarse_chunk_len(U.shape[0]),
            exit_tol=exit_tol, u_limits=limits)
    else:
        X_c, U_c, costs, defects = linesearch_defect_rollouts(
            system, x0, alphas, X, U, u_ff, K, exp,
            iters=config.defect_iters, engine=config.defect_engine,
            exit_tol=exit_tol, u_limits=limits)
    costs_h, defects_h = torch.stack([costs, defects]).cpu().numpy()
    certified = defects_h < cert_tol
    acc = (costs_h <= cost) & np.isfinite(costs_h) & certified
    if acc.any() and certified[:int(np.argmax(acc))].all():
        return X_c, U_c, costs, certified, True
    X_c, U_c, costs = linesearch_rollouts(system, x0, alphas, X, U, u_ff, K,
                                          limits)
    return X_c, U_c, costs, np.ones(n_alpha, bool), False


@full_f32_matmuls()
def solve(
    system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    defect_latch: Any = None,
) -> IlqrSolution:
    """Solve the trajectory-optimization problem.

    Time-major layout: U_init (N, n_u); returns X (N+1, n_x).  The solve
    runs on the device and in the dtype of the system's parameters; ``x0``
    and ``U_init`` (tensors on any device, or numpy arrays) move there.
    With control limits U_init is clipped to them first.

    ``defect_latch`` (a bool) warm-starts the parallel line-search latch
    from a related solve's `IlqrSolution.defect_latch`; ``None`` starts it
    set whenever the line search is 'defect' or 'chunked'.  Once the
    parallel path fails to certify and the exact rollouts decide, the latch
    drops and later iterations run the exact line search directly.
    """
    x0, U_init = system.inputs(x0, U_init)
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {tuple(U_init.shape)}"
        )
    if tuple(x0.shape) != (system.n_x,):
        raise ValueError(f"x0 must have shape ({system.n_x},), got {tuple(x0.shape)}")

    device, dtype = U_init.device, U_init.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    alpha_list = config.alpha_schedule()
    alphas = torch.tensor(alpha_list, dtype=dtype, device=device)
    n_alpha = len(alpha_list)
    N, n_u = U_init.shape
    n_x = x0.shape[0]
    reg = config.reg_init
    pallas_rollout = config.resolved_rollout() == "pallas"
    parallel = config.resolved_rollout() in ("defect", "chunked")
    use_defect = parallel and (defect_latch is None or bool(defect_latch))
    limits = config.limit_arrays(n_u, dtype, device)
    if limits is not None:
        # A feasible initial guess: the initial rollout applies it as is.
        U_init = torch.clamp(U_init, *limits)

    X, cost_t = _initial_rollout(system, x0, U_init, config)
    U = U_init
    u_ff = torch.zeros((N, n_u), dtype=dtype, device=device)
    K = torch.zeros((N, n_u, n_x), dtype=dtype, device=device)
    cost = cost_t.detach().cpu().numpy()
    prev_cost = np.asarray(np.inf, dtype=np_dtype)
    traces = np.full((3, config.maxiter), np.nan, dtype=np_dtype)
    k, status = 0, RUNNING

    while status == RUNNING and k < config.maxiter:
        # Convergence test at the top of the iteration, skipped on the first.
        if k > 0 and np.abs(cost - prev_cost) <= config.tol:
            status = CONVERGED
            break
        exp = linearize_trajectory(system, X, U)
        hess = dynamics_hessians(system, X, U) if config.ddp else None
        noise = (None if config.noise is None
                 else tuple(noise_expansion(config.noise, X, U)))
        u_ff_k, K_k, _, ok = _backward(exp, U, reg, config, limits, hess,
                                       noise)
        certified, par_success = np.ones(n_alpha, bool), not parallel
        if pallas_rollout:
            costs = linesearch_costs_fused(system, x0, alphas, X, U, u_ff_k,
                                           K_k)
        elif use_defect:
            X_c, U_c, costs, certified, par_success = _parallel_linesearch(
                system, x0, alphas, X, U, cost, u_ff_k, K_k, exp, config,
                limits)
        else:
            X_c, U_c, costs = linesearch_rollouts(system, x0, alphas, X, U,
                                                  u_ff_k, K_k, limits)
        # The accept decision's one host sync.
        host = torch.cat([costs, ok.to(dtype)[None],
                          u_ff_k.abs().max()[None]]).cpu().numpy()
        costs_h = host[:n_alpha]
        accept = ((costs_h <= cost) & np.isfinite(costs_h)
                  & (host[n_alpha] != 0) & certified)
        if not accept.any():
            if not config.adaptive_reg:
                status = LINESEARCH_FAILED
                break
            # Escalate the regularization and retry; the retry consumes an
            # iteration, and prev_cost = inf keeps it from reading as
            # convergence.  Past reg_max the solve gives up.
            reg = max(reg, 1e-6) * config.reg_factor
            if reg > config.reg_max:
                status = LINESEARCH_FAILED
            prev_cost = np.asarray(np.inf, dtype=np_dtype)
            use_defect = use_defect and par_success
            k += 1
            continue
        idx = int(np.argmax(accept))
        if pallas_rollout:
            # Materialize only the accepted α's trajectory.
            X, U, _ = closed_loop_rollout_fused(system, x0, alpha_list[idx],
                                                X, U, u_ff_k, K_k)
        else:
            X, U = X_c[idx], U_c[idx]
        u_ff, K = u_ff_k, K_k
        use_defect = use_defect and par_success
        if config.adaptive_reg:
            reg = max(reg / config.reg_factor, 0.0)
        prev_cost, cost = cost, costs_h[idx]
        traces[:, k] = (cost, alpha_list[idx], host[n_alpha + 1])
        k += 1

    if status == RUNNING:
        status = MAXITER
    trace = torch.from_numpy(traces).to(device)
    return IlqrSolution(
        X=X, U=U, cost=torch.as_tensor(cost, device=device), iterations=k,
        status=status, u_ff=u_ff, K=K, cost_trace=trace[0],
        alpha_trace=trace[1], grad_trace=trace[2], defect_latch=use_defect,
    )


def _backward_batch(exp, reg, config: IlqrConfig, U=None, limits=None,
                    hess=None, noise=None):
    """`_backward` over a batch: ``exp``, U (B, N, n_u; read under limits
    only), ``hess`` and ``noise`` lead with B, ``reg`` is a number or
    (B,).  Limits, DDP Hessians or noise
    terms: 'scan'/'auto' run the sequential box-QP or second-order
    recursion per instance (`vmap_backward`), 'pscan'/'pallas' the parallel
    passes on the whole batch, whose suffix scans under 'pallas' are one
    launch of kernel B6's batched entry each.  Without them 'scan',
    'pallas' and 'auto' run the batched sequential recursion (kernel B4 on
    CUDA tensors where it takes the shape and dtype; there 'pallas' raises
    and the others run the plain version), 'pscan' the associative scan
    per instance."""
    backward = config.resolved_backward()
    parallel = backward in ("pscan", "pallas")
    engine = "pallas" if backward == "pallas" else "xla"
    if limits is not None:
        if parallel:
            return backward_pass_limited_parallel(
                exp, U, *limits, reg, sweeps=config.active_set_sweeps,
                engine=engine, hess=hess, noise=noise)
        return vmap_backward(
            lambda e, r, U, **terms: backward_pass_limited(
                e, U, *limits, r, qp_iters=config.boxqp_iters, **terms),
            exp, reg, U=U, hess=hess, noise=noise)
    if hess is not None or noise is not None:
        if parallel:
            return backward_pass_ddp_parallel(
                exp, reg, hess=hess, noise=noise, sweeps=config.ddp_sweeps,
                engine=engine)
        return vmap_backward(backward_pass, exp, reg, hess=hess, noise=noise)
    if backward == "pscan":
        return vmap_backward(backward_pass_associative, exp, reg)
    return backward_pass_batched(exp, reg, backward)


def _initial_rollout_batch(system: System, x0s, U, config: IlqrConfig):
    """(X, cost) of every instance: B5's open-loop entry under
    rollout='pallas', the plain batched rollout otherwise (init_rollout=
    'defect' included, as JAX's batched rule does)."""
    if (config.resolved_rollout() == "pallas"
            and config.resolved_init_rollout() != "defect"):
        return open_loop_rollout_batched(system, x0s, U)
    return rollout(system, x0s, U)


def _parallel_linesearch_batch(system: System, x0s, alphas, X, U, cost, u_ff,
                               K, exp, config: IlqrConfig, limits, par,
                               exact):
    """`_parallel_linesearch` over a batch, per instance as
    ``jax.vmap(solve)`` runs it, with masks in place of vmap's selects.

    ``par`` (B,) marks the instances that run the two-phase search (running,
    latch set), ``exact`` those that go straight to the exact rollouts
    (running, latch clear).  Phase 1 sweeps α0 for ``par``; an instance
    whose α0 certifies below its cert_tol[b] = defect_tol·(1 + max|X_b|),
    is finite and does not raise its cost takes it.  Phase 2 sweeps the
    whole schedule for the rest of ``par`` (one shared scan a sweep); an
    instance keeps its answer if some certified candidate improves and no
    uncertified one precedes the first of them, and else joins ``exact``.
    Sweeps stop per instance at exit_tol[b] = 1e-3·cert_tol[b].  The host
    reads whether any instance needs phase 2, then the exact rollouts, so
    a batch that certifies in phase 1 skips both.

    Returns (X_c (B, A, N+1, n_x), U_c (B, A, N, n_u), costs (B, A),
    certified (B, A), par_success (B,)), as `_parallel_linesearch` per
    instance; rows of instances in neither mask are not meaningful.
    """
    B, N = U.shape[:2]
    n_alpha = alphas.shape[0]
    cert_tol = config.defect_tol * (1.0 + X.abs().amax(dim=(1, 2)))
    A_cl = exp.f_x + exp.f_u @ K
    if config.resolved_rollout() == "chunked":
        def sweep(alphas_, active, chunk_len):
            return linesearch_chunked_rollouts_batched(
                system, x0s, alphas_, X, U, u_ff, K, A_cl,
                sweeps=config.defect_iters, chunk_len=chunk_len,
                exit_tol=1e-3 * cert_tol, u_limits=limits, active=active)
    else:
        def sweep(alphas_, active, chunk_len):
            return linesearch_defect_rollouts_batched(
                system, x0s, alphas_, X, U, u_ff, K, A_cl,
                iters=config.defect_iters, engine=config.defect_engine,
                exit_tol=1e-3 * cert_tol, u_limits=limits, active=active)

    X1, U1, c1, d1 = sweep(alphas[:1], par, config.chunk_len)
    c1, d1 = c1[:, 0], d1[:, 0]
    took1 = par & (d1 < cert_tol) & torch.isfinite(c1) & (c1 <= cost)
    X_c = X1.expand((B, n_alpha) + X1.shape[2:])
    U_c = U1.expand((B, n_alpha) + U1.shape[2:])
    costs = torch.cat([c1[:, None], c1.new_full((B, n_alpha - 1), torch.inf)],
                      dim=1)
    certified = (torch.arange(n_alpha, device=X.device) == 0).expand(
        B, n_alpha)
    phase2 = par & ~took1
    if bool(phase2.any()):
        X2, U2, c2, d2 = sweep(alphas, phase2, config.chunk_len
                               or coarse_chunk_len(N))
        cert2 = d2 < cert_tol[:, None]
        acc = (c2 <= cost[:, None]) & torch.isfinite(c2) & cert2
        first = acc.to(torch.uint8).argmax(dim=1)
        preceding = (~cert2 & (torch.arange(n_alpha, device=X.device)
                               < first[:, None])).any(dim=1)
        keep = phase2 & acc.any(dim=1) & ~preceding
        exact = exact | (phase2 & ~keep)
        X_c = torch.where(phase2[:, None, None, None], X2, X_c)
        U_c = torch.where(phase2[:, None, None, None], U2, U_c)
        costs = torch.where(phase2[:, None], c2, costs)
        certified = torch.where(phase2[:, None], cert2, certified)
    if bool(exact.any()):
        X_e, U_e, c_e = linesearch_rollouts(system, x0s, alphas, X, U, u_ff,
                                            K, limits)
        X_c = torch.where(exact[:, None, None, None], X_e, X_c)
        U_c = torch.where(exact[:, None, None, None], U_e, U_c)
        costs = torch.where(exact[:, None], c_e, costs)
        certified = certified | exact[:, None]
    return X_c, U_c, costs, certified, ~exact


@full_f32_matmuls()
def solve_batch(
    system: System,
    x0s: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    defect_latch: Any = None,
) -> IlqrSolution:
    """Solve B independent problems at once: what ``jax.vmap(solve)``
    returns, per instance.

    x0s (B, n_x); U_init (B, N, n_u), or (N, n_u) shared by every instance.
    One host loop runs the iterations of all instances, with per-instance
    masks in place of JAX's batched ``while_loop``:

    * each instance tests |Δcost| ≤ tol at the top of every iteration but
      its first, accepts the first α whose cost is finite and not above its
      own, stops with LINESEARCH_FAILED when none is (or its gains are not
      finite) and with MAXITER after ``maxiter`` iterations;
    * under ``adaptive_reg`` each instance carries its own regularization:
      an instance that accepts nothing multiplies it and retries, which
      counts as an iteration with NaN trace slots and resets its previous
      cost to inf (past ``reg_max`` it stops with LINESEARCH_FAILED); one
      that accepts divides it;
    * a stopped instance's X, U, cost, gains, reg and traces never change
      again (the loop still computes them; `torch.where` keeps the old
      values);
    * every running instance moves its iteration count by one in every
      pass of the loop, accepted or retried, so one loop counter serves
      them all.

    The accept decision stays on the device; the one host read per
    iteration is whether any instance still runs (the parallel line
    searches add theirs: one a sweep, and whether any instance needs phase
    2 or the exact rollouts).  Engines and options:
    `_backward_batch` (limits, DDP and noise included; ``backward``
    'scan'/'pallas'/'auto' without them → `ops.batched.backward_pass_batched`,
    B4, fed the (B,) regularization), ``rollout`` 'pallas' → B5 (costs of
    every (instance, α), then one trajectory at each instance's α, and the
    open-loop initial rollout), 'scan'/'auto' → the plain batched rollouts,
    which clip every control to the limits (U_init is clipped first),
    'defect'/'chunked' → the two-phase parallel line search per instance
    (`_parallel_linesearch_batch`: the defect sweeps through one launch of
    B3's batched entry a sweep, the chunked ones through the plain
    boundary scan), each instance with its own latch.  ``defect_latch``
    ((B,) bool, or one bool for all; None sets them all) warm-starts the
    latches, and `IlqrSolution.defect_latch` returns them.  x0s and U_init
    move to the system's device and dtype.
    """
    x0s, U_init = system.inputs(x0s, U_init)
    if x0s.ndim != 2 or x0s.shape[1] != system.n_x:
        raise ValueError(f"x0s must have shape (B, n_x={system.n_x}), "
                         f"got {tuple(x0s.shape)}")
    B = x0s.shape[0]
    if U_init.ndim == 2:
        U_init = U_init.expand((B,) + tuple(U_init.shape))
    if U_init.ndim != 3 or U_init.shape[0] != B or U_init.shape[2] != system.n_u:
        raise ValueError(
            f"U_init must have shape ({B}, N, n_u={system.n_u}) or "
            f"(N, {system.n_u}), got {tuple(U_init.shape)}")

    x0s, U = x0s.contiguous(), U_init.contiguous()
    device, dtype = U.device, U.dtype
    alpha_list = config.alpha_schedule()
    alphas = torch.tensor(alpha_list, dtype=dtype, device=device)
    _, N, n_u = U.shape
    n_x = system.n_x
    reg = torch.full((B,), config.reg_init, dtype=dtype, device=device)
    pallas_rollout = config.resolved_rollout() == "pallas"
    parallel = config.resolved_rollout() in ("defect", "chunked")
    use_defect = torch.full((B,), parallel, dtype=torch.bool, device=device)
    if parallel and defect_latch is not None:
        use_defect = torch.as_tensor(defect_latch, device=device).to(
            torch.bool).expand(B).clone()
    rows = torch.arange(B, device=device)
    limits = config.limit_arrays(n_u, dtype, device)
    if limits is not None:
        # A feasible initial guess: the initial rollout applies it as is.
        U = torch.clamp(U, *limits).contiguous()

    X, cost = _initial_rollout_batch(system, x0s, U, config)
    u_ff = U.new_zeros((B, N, n_u))
    K = U.new_zeros((B, N, n_u, n_x))
    prev_cost = torch.full((B,), torch.inf, dtype=dtype, device=device)
    status = torch.full((B,), RUNNING, dtype=torch.int64, device=device)
    iterations = torch.zeros((B,), dtype=torch.int64, device=device)
    traces = torch.full((3, B, config.maxiter), torch.nan, dtype=dtype,
                        device=device)

    for k in range(config.maxiter):
        running = status == RUNNING
        # Convergence test at the top of the iteration, skipped on the
        # first: every running instance has made k iterations.
        if k > 0:
            converged = running & ((cost - prev_cost).abs() <= config.tol)
            status = torch.where(converged, CONVERGED, status)
            running = running & ~converged
        # The iteration's host read: whether any instance runs (and any
        # runs the parallel search).
        any_running, any_par = torch.stack(
            [running.any(), (running & use_defect).any()]).tolist()
        if not any_running:
            break
        exp = linearize_trajectory_batched(system, X, U)
        hess = dynamics_hessians_batched(system, X, U) if config.ddp else None
        noise = (None if config.noise is None
                 else noise_expansion_batched(config.noise, X, U))
        u_ff_k, K_k, _, ok = _backward_batch(exp, reg, config, U, limits,
                                             hess, noise)
        certified, par_success = True, None
        if pallas_rollout:
            costs = linesearch_costs_batched(system, x0s, alphas, X, U,
                                             u_ff_k, K_k)
        elif parallel and any_par:
            X_c, U_c, costs, certified, par_success = (
                _parallel_linesearch_batch(
                    system, x0s, alphas, X, U, cost, u_ff_k, K_k, exp, config,
                    limits, running & use_defect, running & ~use_defect))
        else:
            X_c, U_c, costs = linesearch_rollouts(system, x0s, alphas, X, U,
                                                  u_ff_k, K_k, limits)
        accept = ((costs <= cost[:, None]) & torch.isfinite(costs)
                  & ok[:, None] & certified)
        found = accept.any(dim=1)
        take = running & found
        failed = running & ~found
        if config.adaptive_reg:
            # A rejected instance escalates its regularization and retries
            # (an iteration, with prev_cost = inf so that the retry cannot
            # read as convergence), and gives up past reg_max; an accepted
            # one relaxes it.
            raised = torch.clamp(reg, min=1e-6) * config.reg_factor
            prev_cost = torch.where(failed, torch.inf, prev_cost)
            status = torch.where(failed & (raised > config.reg_max),
                                 LINESEARCH_FAILED, status)
            reg = torch.where(failed, raised, torch.where(
                take, torch.clamp(reg / config.reg_factor, min=0.0), reg))
        else:
            status = torch.where(failed, LINESEARCH_FAILED, status)
        idx = accept.to(torch.uint8).argmax(dim=1)  # the first accepted α
        alpha_b = alphas[idx]
        if pallas_rollout:
            # Materialize only each instance's accepted α.
            X_new, U_new, _ = closed_loop_rollout_batched(
                system, x0s, alpha_b, X, U, u_ff_k, K_k)
        else:
            X_new, U_new = X_c[rows, idx], U_c[rows, idx]
        new_cost = costs[rows, idx]
        t3, t4 = take[:, None, None], take[:, None, None, None]
        X = torch.where(t3, X_new, X)
        U = torch.where(t3, U_new, U)
        u_ff = torch.where(t3, u_ff_k, u_ff)
        K = torch.where(t4, K_k, K)
        prev_cost = torch.where(take, cost, prev_cost)
        cost = torch.where(take, new_cost, cost)
        traces[:, :, k] = torch.where(
            take, torch.stack([new_cost, alpha_b,
                               u_ff_k.abs().amax(dim=(1, 2))]),
            traces[:, :, k])
        moved = running if config.adaptive_reg else take
        iterations = iterations + moved.to(torch.int64)
        if par_success is not None:
            # The latch drops once the exact rollouts decided; a stopped
            # instance's latch, and that of one that failed without
            # adaptive_reg, stays as it was.
            use_defect = torch.where(moved, use_defect & par_success,
                                     use_defect)

    status = torch.where(status == RUNNING, MAXITER, status)
    return IlqrSolution(
        X=X, U=U, cost=cost, iterations=iterations, status=status, u_ff=u_ff,
        K=K, cost_trace=traces[0], alpha_trace=traces[1],
        grad_trace=traces[2], defect_latch=use_defect,
    )
