"""Pendulum receding-horizon MPC, on the port.

The twin of `examples/pendulum_mpc.py`: the reference's workload (horizon
T=2 solved every step for T_sim=4, maxiter=10, backward_euler solver
against a midpoint plant, shift-and-hold warm start), each step's solve
through the kernels (``backward='pallas', rollout='pallas'``: B1, B2).
``main(n_sim=...)`` cuts the simulated steps.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import os
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.mpc import run_mpc
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt = 0.01
    N_h = len(np.arange(0, sm(2.0, 0.12) + dt, dt)) - 1    # horizon
    N_sim = len(np.arange(0, sm(4.0, 0.06) + dt, dt)) - 1  # simulation steps

    def mk(integ):
        return itt.make_pendulum(
            dt, x_target=[np.pi, 0.0], Q=np.diag([10.0, 1.0]), R=np.eye(1),
            Q_f=np.diag([10.0, 10.0]), d=0.0, integrator=integ,
            device=device, dtype=dtype)

    return SimpleNamespace(
        solver=mk("backward_euler"), plant=mk("midpoint"), dt=dt,
        x_target=[np.pi, 0.0], n_sim=N_sim,
        x0=torch.zeros(2, dtype=dtype, device=device),
        U0=torch.zeros((N_h, 1), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(10, 3), tol=1e-5,
                              backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=3,
         n_sim=None):
    p = problem(device, dtype)
    n_sim = p.n_sim if n_sim is None else n_sim

    def mpc(x0, U0, steps=n_sim):
        return run_mpc(p.solver, p.plant, x0, U0, steps, p.config)

    print("Warming up…")
    warmup(mpc, p.x0, p.U0, 1)
    sec, res = timed(mpc, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"MPC: {n_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / n_sim * 1e6:.1f} µs/step), final x={res.X[-1].cpu().numpy()}, "
          f"closed-loop cost={float(res.cost):.3f}")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
        plot_trajectory(res.X, res.U, p.dt, x_target=p.x_target,
                        state_labels=["θ", "θ̇"], title="Pendulum MPC",
                        save_path=os.path.join(out, "pendulum_mpc.png"))
    return res


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
