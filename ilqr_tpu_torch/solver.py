"""iLQR solver: a host loop over device tensors.

PyTorch counterpart of `ilqr_tpu/solver.py`.  The JAX solver is one
`lax.while_loop`; here the loop runs on the host and makes one scalar sync
per iteration (the candidate costs, the ``ok`` flag and max |u_ff| come back
together).  The accept rules are the JAX ones:

* the whole α schedule is rolled out at once and the first α whose cost
  does not exceed the current cost is accepted;
* the solve stops when no α is accepted (LINESEARCH_FAILED);
* convergence, |Δcost| ≤ tol, is tested at the top of every iteration but
  the first;
* ``cost_trace``, ``alpha_trace`` and ``grad_trace`` are nan-padded.

Engines: ``backward`` is 'scan' (sequential Riccati), 'pscan' (associative
scan) or 'pallas' (the hand-written CUDA backward pass of
`ops/fused_riccati.py`); ``rollout`` is 'scan' (the host-loop rollout
batch) or 'pallas' (the CUDA rollout kernels of `ops/fused_rollout.py`:
candidate costs first, then only the accepted α is materialized).  'auto'
resolves to 'scan' on every device until end-to-end GPU measurements set a
rule.  The engine names are the JAX ones, so a JAX config carries over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.ops.fused_rollout import (
    closed_loop_rollout_fused,
    linesearch_costs_fused,
)
from ilqr_tpu_torch.ops.linearize import linearize_trajectory
from ilqr_tpu_torch.ops.parallel_riccati import backward_pass_associative
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops.rollout import linesearch_rollouts, rollout

# Solve status codes (returned in IlqrSolution.status).
RUNNING, CONVERGED, LINESEARCH_FAILED, MAXITER = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class IlqrConfig:
    """Solver configuration: the fields, defaults, accepted strings and
    validation of `ilqr_tpu.solver.IlqrConfig`.

    `solve` raises `NotImplementedError` (naming the ROADMAP item) for the
    options this port does not run yet: rollout 'defect'/'chunked',
    init_rollout 'defect', a non-'auto' defect_engine, control limits,
    ddp, noise and adaptive_reg.
    """

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
    # State of the parallel line-search latch; always False until the
    # parallel line searches land (ROADMAP A11).
    defect_latch: bool = False


def _unsupported(config: IlqrConfig, defect_latch) -> str | None:
    """The ROADMAP item of the first option set that this port lacks."""
    if config.resolved_rollout() in ("defect", "chunked"):
        return f"rollout={config.rollout!r} is ROADMAP item A11"
    if config.resolved_init_rollout() == "defect":
        return "init_rollout='defect' is ROADMAP item A11"
    if config.defect_engine != "auto" or defect_latch is not None:
        return "the defect engine and its latch are ROADMAP item A11"
    if config.u_min is not None:
        return "control limits (u_min/u_max) are ROADMAP item A14"
    if config.ddp or config.noise is not None:
        return "ddp and noise are ROADMAP item A15"
    if config.adaptive_reg:
        return "adaptive_reg is ROADMAP item A6b"
    return None


def _backward(exp, reg: float, config: IlqrConfig):
    backward = config.resolved_backward()
    if backward == "pscan":
        return backward_pass_associative(exp, reg)
    if backward == "pallas":
        return backward_pass_fused(exp, reg)
    return backward_pass(exp, reg)


@full_f32_matmuls()
def solve(
    system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    config: IlqrConfig = IlqrConfig(),
    defect_latch: Any = None,
) -> IlqrSolution:
    """Solve the trajectory-optimization problem.

    Time-major layout: U_init (N, n_u); returns X (N+1, n_x).  ``x0`` and
    ``U_init`` set the device and dtype of the solve.
    """
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got {tuple(U_init.shape)}"
        )
    if tuple(x0.shape) != (system.n_x,):
        raise ValueError(f"x0 must have shape ({system.n_x},), got {tuple(x0.shape)}")
    missing = _unsupported(config, defect_latch)
    if missing is not None:
        raise NotImplementedError(missing)

    device, dtype = U_init.device, U_init.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    alpha_list = config.alpha_schedule()
    alphas = torch.tensor(alpha_list, dtype=dtype, device=device)
    n_alpha = len(alpha_list)
    N, n_u = U_init.shape
    n_x = x0.shape[0]
    reg = config.reg_init
    pallas_rollout = config.resolved_rollout() == "pallas"

    X, cost_t = rollout(system, x0, U_init)
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
        u_ff_k, K_k, _, ok = _backward(exp, reg, config)
        if pallas_rollout:
            costs = linesearch_costs_fused(system, x0, alphas, X, U, u_ff_k,
                                           K_k)
        else:
            X_c, U_c, costs = linesearch_rollouts(system, x0, alphas, X, U,
                                                  u_ff_k, K_k)
        # The iteration's one host sync.
        host = torch.cat([costs, ok.to(dtype)[None],
                          u_ff_k.abs().max()[None]]).cpu().numpy()
        costs_h = host[:n_alpha]
        accept = (costs_h <= cost) & np.isfinite(costs_h) & (host[n_alpha] != 0)
        if not accept.any():
            status = LINESEARCH_FAILED
            break
        idx = int(np.argmax(accept))
        if pallas_rollout:
            # Materialize only the accepted α's trajectory.
            X, U, _ = closed_loop_rollout_fused(system, x0, alpha_list[idx],
                                                X, U, u_ff_k, K_k)
        else:
            X, U = X_c[idx], U_c[idx]
        u_ff, K = u_ff_k, K_k
        prev_cost, cost = cost, costs_h[idx]
        traces[:, k] = (cost, alpha_list[idx], host[n_alpha + 1])
        k += 1

    if status == RUNNING:
        status = MAXITER
    trace = torch.from_numpy(traces).to(device)
    return IlqrSolution(
        X=X, U=U, cost=torch.as_tensor(cost, device=device), iterations=k,
        status=status, u_ff=u_ff, K=K, cost_trace=trace[0],
        alpha_trace=trace[1], grad_trace=trace[2],
    )
