"""Under-actuated double-pendulum swing-up (the hardest open-loop
problem), on the port.

The twin of `examples/ua_double_pendulum_open_loop.py`: the reference's
workload (dt=0.01, T=8, only joint 1 actuated, Q=diag(1,1,.1,.1), R=[1],
Q_f=diag(1000,1000,100,100), backward_euler, maxiter=700) through the
kernels (``backward='pallas', rollout='pallas'``: B1, B2).  The JAX twin
also exports an mp4 of the solution; the port has no animation yet.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt, T = 0.01, sm(8.0, 0.2)
    N = len(np.arange(0, T + dt, dt)) - 1
    system = itt.make_double_pendulum(
        dt, x_target=[np.pi, 0.0, 0.0, 0.0],
        Q=np.diag([1.0, 1.0, 0.1, 0.1]), R=np.diag([1.0]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12,
        underactuated=True, integrator="backward_euler",
        device=device, dtype=dtype,
    )
    return SimpleNamespace(
        system=system, dt=dt, x_target=[np.pi, 0, 0, 0],
        x0=torch.zeros(4, dtype=dtype, device=device),
        U0=torch.zeros((N, 1), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(700, 5), tol=1e-5,
                              backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=1):
    p = problem(device, dtype)

    def solve(x, U, config=p.config):
        return itt.solve(p.system, x, U, config)

    print("Warming up…")
    warmup(solve, p.x0, p.U0, dataclasses.replace(p.config, maxiter=1))
    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"Solve: iters={int(sol.iterations)} cost={float(sol.cost):.3f} "
          f"x_N={sol.X[-1].cpu().numpy()}  wall={sec:.3f} s")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X, sol.U, p.dt, x_target=p.x_target,
                        state_labels=["q1", "q2", "q̇1", "q̇2"],
                        title="UA double pendulum swing-up",
                        save_path=os.path.join(out,
                                               "ua_double_pendulum_ol.png"))
    return sol


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
