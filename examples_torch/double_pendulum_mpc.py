"""Double-pendulum MPC (fully actuated and under-actuated), on the port.

The twin of `examples/double_pendulum_mpc.py`: the reference's workloads,
fully actuated (T=1 horizon, T_sim=3, maxiter=50, rk4 solver and plant,
initial velocity [0,0,-10,10]) and under-actuated (T=2, T_sim=5, rk4
solver against a backward_euler plant, Q=diag(5,5,.1,.1), R=[50],
Q_f=diag(1000,1000,10,10)), each step's solve through the kernels
(``backward='pallas', rollout='pallas'``: B1, B2).  ``main(n_sim=...)``
cuts the simulated steps of both.
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


def problem(device=DEFAULT_DEVICE, dtype=torch.float32,
            underactuated=False) -> SimpleNamespace:
    dt = 0.01
    if underactuated:
        T, T_sim, n_u = 2.0, 5.0, 1
        weights = dict(Q=np.diag([5.0, 5.0, 0.1, 0.1]), R=np.diag([50.0]),
                       Q_f=np.diag([1000.0, 1000.0, 10.0, 10.0]))
        integrators, x0 = ("rk4", "backward_euler"), [0.0, 0.0, 0.0, 0.0]
    else:
        T, T_sim, n_u = 1.0, 3.0, 2
        weights = dict(Q=np.diag([10.0, 10.0, 0.1, 0.1]),
                       R=np.diag([0.1, 0.1]),
                       Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]))
        integrators, x0 = ("rk4", "rk4"), [0.0, 0.0, -10.0, 10.0]
    N_h = len(np.arange(0, sm(T, 0.12) + dt, dt)) - 1
    N_sim = len(np.arange(0, sm(T_sim, 0.06) + dt, dt)) - 1

    def mk(integ):
        return itt.make_double_pendulum(
            dt, x_target=[np.pi, 0.0, 0.0, 0.0], d1=0.1, d2=0.1,
            theta1=1 / 12, theta2=1 / 12, underactuated=underactuated,
            integrator=integ, device=device, dtype=dtype, **weights)

    solver, plant = (mk(i) for i in integrators)
    return SimpleNamespace(
        solver=solver, plant=plant, dt=dt, x_target=[np.pi, 0, 0, 0],
        n_sim=N_sim, x0=torch.tensor(x0, dtype=dtype, device=device),
        U0=torch.zeros((N_h, n_u), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(50, 3), tol=1e-5,
                              backward="pallas", rollout="pallas"))


def _run(label, p, reps, n_sim, out):
    n_sim = p.n_sim if n_sim is None else n_sim

    def mpc(x0, U0, steps=n_sim):
        return run_mpc(p.solver, p.plant, x0, U0, steps, p.config)

    warmup(mpc, p.x0, p.U0, 1)
    sec, res = timed(mpc, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"{label} double-pendulum MPC: {n_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / n_sim * 1e6:.1f} µs/step), final x={res.X[-1].cpu().numpy()}")
    if out is not None:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        name = "double_pendulum_mpc" if label == "FA" else \
            "ua_double_pendulum_mpc"
        plot_trajectory(res.X, res.U, p.dt, x_target=p.x_target,
                        title=f"{label} double-pendulum MPC",
                        save_path=os.path.join(out, f"{name}.png"))
    return res


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32,
         reps=(2, 1), n_sim=None):
    """Both loops; ``reps`` = (FA, UA) timed repetitions.  Returns
    {'fa': MpcResult, 'ua': MpcResult}."""
    out = None
    if plot:
        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
    return dict(
        fa=_run("FA", problem(device, dtype), reps[0], n_sim, out),
        ua=_run("UA", problem(device, dtype, underactuated=True), reps[1],
                n_sim, out))


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
