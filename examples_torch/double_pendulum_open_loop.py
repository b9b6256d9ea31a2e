"""Fully-actuated double-pendulum swing-up, open-loop iLQR, on the port.

The twin of `examples/double_pendulum_open_loop.py`: the reference's
workload (dt=0.01, T=5, Q=diag(10,10,.1,.1), R=diag(.1,.1),
Q_f=diag(1000,1000,100,100), euler, tol=1e-6, maxiter=200) through the
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
    dt, T = 0.01, sm(5.0, 0.2)
    N = len(np.arange(0, T + dt, dt)) - 1
    system = itt.make_double_pendulum(
        dt, x_target=[np.pi, 0.0, 0.0, 0.0],
        Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=np.diag([0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="euler",
        device=device, dtype=dtype,
    )
    return SimpleNamespace(
        system=system, dt=dt, x_target=[np.pi, 0, 0, 0],
        x0=torch.zeros(4, dtype=dtype, device=device),
        U0=torch.zeros((N, 2), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(200, 5), tol=1e-6,
                              backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=3):
    p = problem(device, dtype)

    def solve(x, U, config=p.config):
        return itt.solve(p.system, x, U, config)

    print("Warming up…")
    warmup(solve, p.x0, p.U0, dataclasses.replace(p.config, maxiter=1))
    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"Solve: iters={int(sol.iterations)} cost={float(sol.cost):.3f} "
          f"x_N={sol.X[-1].cpu().numpy()}  wall={sec * 1e3:.1f} ms")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X, sol.U, p.dt, x_target=p.x_target,
                        state_labels=["q1", "q2", "q̇1", "q̇2"],
                        title="Double pendulum swing-up",
                        save_path=os.path.join(out, "double_pendulum_ol.png"))
    return sol


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
