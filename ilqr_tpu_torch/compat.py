"""Reference-compatible object-oriented facade.

PyTorch counterpart of `ilqr_tpu/compat.py`.  Users of the reference
package (`iLQR` classes, the (dim, time) array layout, the 13-function
derivative surface) switch with few edits: this module has the same names,
constructor signatures and layouts on top of the port's functional core.
New code should call `ilqr_tpu_torch.solve` directly.

``optimize_trajectory`` runs `solver.solve` with the facade's
`IlqrConfig`, whose engines stay at ``'auto'``: the port's 'auto' means
the sequential host-loop engines (`solver.py`), so a facade solve runs no
CUDA kernel.  Pass a config of your own to `solve` for the kernels.
"""
from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from ilqr_tpu_torch.models.base import DEFAULT_DEVICE, System as _System
from ilqr_tpu_torch.ops.integrators import step as _step
from ilqr_tpu_torch.ops.linearize import linearize_trajectory
from ilqr_tpu_torch.ops.riccati import backward_pass as _bp
from ilqr_tpu_torch.ops.rollout import closed_loop_rollout, rollout
from ilqr_tpu_torch.solver import (
    LINESEARCH_FAILED,
    MAXITER,
    IlqrConfig,
    solve as _solve,
)


class SystemAdapter:
    """Wraps a functional `System` with the reference's 13-method surface:
    f_fcn, f_x_fcn, f_u_fcn, l_fcn, l_x_fcn, l_u_fcn, l_xx_fcn, l_ux_fcn,
    l_uu_fcn, l_f_fcn, l_f_x_fcn, l_f_xx_fcn, built with `torch.func`
    (`jacfwd`, `grad`, `hessian`, and `jacfwd(grad)` for l_ux).  Each takes
    tensors on any device, numpy arrays or sequences, and evaluates on the
    system's device and dtype.

    ``use_jit`` is accepted for the reference's constructor signature and
    changes nothing: torch runs eagerly, so breakpoints and prints inside
    user dynamics and costs fire on every call either way.
    """

    def __init__(self, system: _System, use_jit: bool = True):
        self._sys = system
        self.n_x, self.n_u, self.dt = system.n_x, system.n_u, system.dt
        self.use_jit = bool(use_jit)

        def f(x, u):
            return _step(system, x, u)

        def l(x, u):
            return system.stage_cost(system.params, x, u)

        def lf(x):
            return system.terminal_cost(system.params, x)

        fn = torch.func
        wrap = self._on_device
        self.f_fcn: Callable = wrap(f)
        self.f_x_fcn: Callable = wrap(fn.jacfwd(f, argnums=0))
        self.f_u_fcn: Callable = wrap(fn.jacfwd(f, argnums=1))
        self.l_fcn: Callable = wrap(l)
        self.l_x_fcn: Callable = wrap(fn.grad(l, argnums=0))
        self.l_u_fcn: Callable = wrap(fn.grad(l, argnums=1))
        self.l_xx_fcn: Callable = wrap(fn.hessian(l, argnums=0))
        self.l_uu_fcn: Callable = wrap(fn.hessian(l, argnums=1))
        self.l_ux_fcn: Callable = wrap(
            fn.jacfwd(fn.grad(l, argnums=1), argnums=0))
        self.l_f_fcn: Callable = wrap(lf)
        self.l_f_x_fcn: Callable = wrap(fn.grad(lf))
        self.l_f_xx_fcn: Callable = wrap(fn.hessian(lf))

    def _on_device(self, fn: Callable) -> Callable:
        def call(*args):
            return fn(*(torch.as_tensor(a, dtype=self._sys.dtype,
                                        device=self._sys.device)
                        for a in args))
        return call

    @property
    def system(self) -> _System:
        return self._sys


def MyPendulum(dt, x_target, Q, R, Q_f, g=9.81, l=1.0, d=0.01,
               use_jit=True, integrator="rk4", *, device=DEFAULT_DEVICE,
               dtype=torch.float32) -> SystemAdapter:
    """Constructor-compatible with the reference `MyPendulum`; built on
    ``device`` (the GPU unless named) in ``dtype``."""
    from ilqr_tpu_torch.models.pendulum import make_pendulum

    return SystemAdapter(
        make_pendulum(dt, x_target, Q, R, Q_f, g=g, l=l, d=d,
                      integrator=integrator, device=device, dtype=dtype),
        use_jit=use_jit,
    )


def MyDoublePendulum(dt, x_target, Q, R, Q_f, g=9.81, m1=1.0, m2=1.0,
                     l1=1.0, l2=1.0, d1=0.01, d2=0.01, theta1=0.0,
                     theta2=0.0, use_jit=True, integrator="rk4", *,
                     device=DEFAULT_DEVICE,
                     dtype=torch.float32) -> SystemAdapter:
    """Constructor-compatible with the reference `MyDoublePendulum`."""
    from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum

    return SystemAdapter(
        make_double_pendulum(dt, x_target, Q, R, Q_f, g=g, m1=m1, m2=m2,
                             l1=l1, l2=l2, d1=d1, d2=d2, theta1=theta1,
                             theta2=theta2, integrator=integrator,
                             device=device, dtype=dtype),
        use_jit=use_jit,
    )


def MyUADoublePendulum(dt, x_target, Q, R, Q_f, g=9.81, m1=1.0, m2=1.0,
                       l1=1.0, l2=1.0, d1=0.01, d2=0.01, theta1=0.0,
                       theta2=0.0, use_jit=True, integrator="rk4", *,
                       device=DEFAULT_DEVICE,
                       dtype=torch.float32) -> SystemAdapter:
    """Constructor-compatible with the reference `MyUADoublePendulum`."""
    from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum

    return SystemAdapter(
        make_double_pendulum(dt, x_target, Q, R, Q_f, g=g, m1=m1, m2=m2,
                             l1=l1, l2=l2, d1=d1, d2=d2, theta1=theta1,
                             theta2=theta2, underactuated=True,
                             integrator=integrator, device=device,
                             dtype=dtype),
        use_jit=use_jit,
    )


class iLQR:
    """Reference-compatible solver class: the same constructor, the same
    (dim, time) trajectory layout, the same ``optimize_trajectory() ->
    (X, U, cost)`` contract, and ``backward_pass`` / ``forward_pass``
    attributes for warm-up code written against the reference.  Solves on
    the system's device and dtype; ``x_0`` and ``U`` may be reassigned
    between solves (the reference's MPC pattern)."""

    def __init__(self, system: Union[SystemAdapter, _System], T: float,
                 x_0, U_init, tol: float = 1e-5, maxiter: int = 100,
                 alpha_factor: float = 0.5, min_alpha: float = 1e-8,
                 verbose: bool = True):
        self._sys = system.system if isinstance(system, SystemAdapter) else system
        self.system = system
        self.T = T
        self.x_0 = self._sys.inputs(x_0)
        self.tol, self.maxiter = tol, maxiter
        self.alpha_factor, self.min_alpha = alpha_factor, min_alpha
        self.verbose = verbose

        self.n_x, self.n_u, self.dt = self._sys.n_x, self._sys.n_u, self._sys.dt
        # N from the same float arange the reference takes.
        self.tspan = torch.as_tensor(np.arange(0, T + self.dt, self.dt),
                                     dtype=self._sys.dtype,
                                     device=self._sys.device)
        self.N = len(self.tspan) - 1

        expected = (self.n_u, self.N)
        if tuple(U_init.shape) != expected:
            raise ValueError(
                f"U_init must have shape {expected}, but got "
                f"{tuple(U_init.shape)}"
            )
        zeros = lambda *shape: torch.zeros(shape, dtype=self._sys.dtype,
                                           device=self._sys.device)
        # (dim, time) layout, like the reference.
        self.X = zeros(self.n_x, self.N + 1)
        self.U = self._sys.inputs(U_init)
        self.K = zeros(self.N, self.n_u, self.n_x)
        self.U_ff = zeros(self.n_u, self.N)

        self._config = IlqrConfig(
            maxiter=maxiter, tol=tol, alpha_factor=alpha_factor,
            min_alpha=min_alpha,
        )

    def backward_pass(self, X_nom, U_nom):
        """Gains along a (dim, time) nominal: (U_ff (n_u, N), K (N, n_u,
        n_x)), by the sequential backward pass."""
        X_nom, U_nom = self._sys.inputs(X_nom, U_nom)
        exp = linearize_trajectory(self._sys, X_nom.T, U_nom.T)
        u_ff, K, _, _ = _bp(exp)
        return u_ff.T, K

    def forward_pass(self, x0, alpha, X_old, U_old, U_ff, K):
        """Closed-loop rollout of one α in (dim, time) layout: (X_new,
        U_new, cost)."""
        x0, X_old, U_old, U_ff, K = self._sys.inputs(x0, X_old, U_old,
                                                     U_ff, K)
        X_new, U_new, cost = closed_loop_rollout(
            self._sys, x0, alpha, X_old.T, U_old.T, U_ff.T, K)
        return X_new.T, U_new.T, cost

    def optimize_trajectory(self):
        """Run the solve; returns (X, U, cost) in (dim, time) layout.

        ``verbose`` reproduces the reference's per-iteration output from
        the solution's cost and α traces: the initial cost, one line per
        accepted iteration with its α, then the convergence, line-search
        failure or iteration-limit message.
        """
        x0 = self._sys.inputs(self.x_0)
        U0 = self._sys.inputs(self.U).T
        sol = _solve(self._sys, x0, U0, self._config)
        if self.verbose:
            # The α = 0 rollout cost, the reference's first print.
            print(f"Initial cost: "
                  f"{float(rollout(self._sys, x0, U0)[1]):.4f}")
        self.X, self.U = sol.X.T, sol.U.T
        self.U_ff, self.K = sol.u_ff.T, sol.K
        if self.verbose:
            k = int(sol.iterations)
            ct = sol.cost_trace.cpu().numpy()
            at = sol.alpha_trace.cpu().numpy()
            for i in range(k):
                print(f"  Iter {i + 1} (alpha={at[i]:.2e}): "
                      f"Cost improved to {ct[i]:.4f}")
            status = int(sol.status)
            if status == LINESEARCH_FAILED:
                print(f"Warning: Line search failed at iteration {k + 1}. "
                      "Cost did not improve.")
            elif status == MAXITER:
                print(f"Warning: Reached max iterations ({self.maxiter}) "
                      "without converging.")
            else:
                print(f"Converged at iteration {k}")
        return self.X, self.U, sol.cost
