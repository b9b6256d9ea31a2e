"""Torque-limited receding-horizon MPC, three ways, on the port.

The twin of `examples/constrained_mpc.py`: pendulum swing-up under a
binding torque limit |u| <= 6 (the unconstrained plan peaks at ~11.4),
with a backward_euler solver against a midpoint plant, comparing

  1. `run_mpc_constrained`: a per-step augmented-Lagrangian solve, its
     multipliers and penalty warm-started by shifting along the horizon;
  2. `run_mpc_barrier`: a fixed-(mu, delta) relaxed-barrier solve per step;
  3. `run_mpc` with `IlqrConfig(u_min/u_max)`: box-QP limits in the plain
     MPC loop.

The backward passes are kernels (``backward='pallas'``: B1 in 1-2, the
limited parallel pass's suffix scan B6 in 3); the line-search candidates
of 1-2 are rolled out by the B2 kernels (``rollout='pallas'``), those of 3
by host loops (the kernels do not clamp).  ``main(n_sim=...)`` cuts the
simulated steps.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import time
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.mpc import run_mpc, run_mpc_barrier, run_mpc_constrained


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    kw = dict(device=device, dtype=dtype)

    def mk(integ):
        return itt.make_pendulum(
            0.01, [np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
            Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integ, **kw)

    N_h, n_sim, lim = sm(200, 12), sm(400, 6), 6.0
    return SimpleNamespace(
        solver=mk("backward_euler"), plant=mk("midpoint"), n_sim=n_sim,
        lim=lim, x0=torch.zeros(2, **kw), U0=torch.zeros((N_h, 1), **kw),
        constraints=itt.box_control_constraints([-lim], [lim], **kw),
        al_config=itt.AlConfig(max_outer=2, ctol=1e-3, mu0=1.0),
        config_al=itt.IlqrConfig(maxiter=sm(15, 3), tol=1e-6,
                                 backward="pallas", rollout="pallas"),
        config_barrier=itt.IlqrConfig(maxiter=sm(10, 3), tol=1e-6,
                                      backward="pallas", rollout="pallas"),
        barrier=dict(mu=1e-2, delta=0.05),
        config_boxqp=itt.IlqrConfig(maxiter=sm(10, 3), tol=1e-6,
                                    backward="pallas", u_min=-lim,
                                    u_max=lim))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, n_sim=None):
    """The three loops; returns {'al': ..., 'barrier': ..., 'boxqp': ...}.
    ``plot`` is accepted for the drivers' common signature (this driver
    prints only)."""
    p = problem(device, dtype)
    n_sim = p.n_sim if n_sim is None else n_sim

    def bench(name, fn):
        fn(1)                                     # build the kernels
        sync = torch.cuda.synchronize if p.x0.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        res = fn(n_sim)
        sync()
        dt_ms = (time.perf_counter() - t0) * 1e3
        print(f"{name:12s}  cost {float(res.cost):8.3f}   "
              f"max|u| {float(res.U.abs().max()):6.3f}   "
              f"xN [{float(res.X[-1, 0]):+.4f} {float(res.X[-1, 1]):+.4f}]   "
              f"{dt_ms:7.1f} ms / {n_sim} steps")
        return res

    return dict(
        al=bench("AL warm", lambda steps: run_mpc_constrained(
            p.solver, p.plant, p.constraints, p.x0, p.U0, steps, p.config_al,
            p.al_config)),
        barrier=bench("barrier", lambda steps: run_mpc_barrier(
            p.solver, p.plant, p.constraints, p.x0, p.U0, steps,
            p.config_barrier, **p.barrier)),
        boxqp=bench("boxQP", lambda steps: run_mpc(
            p.solver, p.plant, p.x0, p.U0, steps, p.config_boxqp)))


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
