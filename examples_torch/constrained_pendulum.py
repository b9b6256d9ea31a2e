"""Constrained pendulum swing-up: augmented-Lagrangian iLQR, on the port.

The twin of `examples/constrained_pendulum.py`: a torque-limited pumping
swing-up (|u| <= 3 < mgl = 9.81, so the pendulum must pump over several
swings) with an exact terminal goal, solved by
`ilqr_tpu_torch.solve_constrained`.  The backward pass is kernel B1
(``backward='pallas'``) and the line-search candidates are rolled out by
the B2 kernels (``rollout='pallas'``: the JAX twin's rollouts are a
compiled device scan, the port's host loops take ~1 s a line search at
this size on a GPU).
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
    dt, T = 0.01, sm(4.0, 0.16)
    N = len(np.arange(0, T + dt, dt)) - 1
    goal = [np.pi, 0.0]
    kw = dict(device=device, dtype=dtype)
    system = itt.make_pendulum(
        dt, x_target=goal, Q=np.eye(2), R=np.eye(1), Q_f=100.0 * np.eye(2),
        g=9.81, l=1.0, d=0.0, integrator="rk4", **kw)
    box = itt.box_control_constraints([-3.0], [3.0], **kw)
    return SimpleNamespace(
        system=system, dt=dt, goal=torch.tensor(goal, **kw), box=box,
        constraints=itt.merge_constraints(box, itt.goal_constraint(goal,
                                                                   **kw)),
        x0=torch.zeros(2, **kw), U0=torch.zeros((N, 1), **kw),
        config=itt.IlqrConfig(maxiter=sm(100, 5), tol=1e-7,
                              backward="pallas", rollout="pallas"),
        al_config=itt.AlConfig(max_outer=sm(15, 2), ctol=1e-4))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=5):
    p = problem(device, dtype)

    def solve(x, U, config=p.config):
        return itt.solve_constrained(p.system, p.constraints, x, U, config,
                                     p.al_config)

    print("Warming up (building the kernels)…")
    warmup(solve, p.x0, p.U0, dataclasses.replace(p.config, maxiter=1))

    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"Constrained solve: status={int(sol.status)} "
          f"outer={int(sol.outer_iterations)} inner={int(sol.inner_iterations)} "
          f"cost={float(sol.cost):.4f} violation={float(sol.violation):.2e} "
          f"wall={sec * 1e3:.2f} ms (warmed)")
    print(f"max |u| = {float(sol.U.abs().max()):.4f} (limit 3.0), "
          f"terminal error = {float((sol.X[-1] - p.goal).abs().max()):.2e}")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = os.path.join(os.path.dirname(__file__), "out")
        os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X, sol.U, p.dt, x_target=p.goal,
                        state_labels=["θ", "θ̇"],
                        title="Torque-limited swing-up (AL-iLQR)",
                        save_path=os.path.join(out, "constrained_pendulum.png"))
        print(f"Plot written to {out}/")
    return sol


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
