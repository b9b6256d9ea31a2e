"""Pendulum swing-up, open-loop iLQR, on the port.

The twin of `examples/pendulum_open_loop.py`: the reference's workload
(dt=0.01, T=4, Q=I, R=I, Q_f=0, x0=[1,0], backward_euler, tol=1e-5,
maxiter=100) and its measurement protocol (warm-up, then a timed solve).
The engines are the kernels: ``backward='pallas', rollout='pallas'`` (B1,
B2; on CPU tensors their plain versions).  Run from the repository root:

    python examples_torch/pendulum_open_loop.py             # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/pendulum_open_loop.py --cpu
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
    dt, T = 0.01, sm(4.0, 0.2)
    N = len(np.arange(0, T + dt, dt)) - 1
    system = itt.make_pendulum(
        dt, x_target=[np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
        Q_f=np.zeros((2, 2)), g=9.81, l=1.0, d=0.0,
        integrator="backward_euler", device=device, dtype=dtype,
    )
    return SimpleNamespace(
        system=system, dt=dt, x_target=[np.pi, 0.0],
        x0=torch.tensor([1.0, 0.0], dtype=dtype, device=device),
        U0=torch.zeros((N, 1), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(100, 5), tol=1e-5,
                              backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=5):
    p = problem(device, dtype)

    def solve(x, U, config=p.config):
        return itt.solve(p.system, x, U, config)

    print("Warming up (building the kernels)…")
    warmup(solve, p.x0, p.U0, dataclasses.replace(p.config, maxiter=1))

    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"Solve: status={int(sol.status)} iters={int(sol.iterations)} "
          f"cost={float(sol.cost):.4f}  wall={sec * 1e3:.2f} ms (warmed)")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_convergence, plot_trajectory

        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X, sol.U, p.dt, x_target=p.x_target,
                        state_labels=["θ", "θ̇"], title="Pendulum swing-up",
                        save_path=os.path.join(out, "pendulum_ol.png"))
        plot_convergence(sol, save_path=os.path.join(out,
                                                     "pendulum_ol_conv.png"))
        print(f"Plots written to {out}/")
    return sol


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
