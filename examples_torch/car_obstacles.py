"""Car obstacle avoidance: augmented-Lagrangian iLQR on the kinematic
bicycle, on the port.

The twin of `examples/car_obstacles.py`: from the origin to a goal 8 m
ahead around two keep-out discs on the straight line, with acceleration
and steering boxes, every constraint handled by
`ilqr_tpu_torch.solve_constrained` (dt 0.05, N = 120).  The inner solves
run the fused backward pass (B1 at (4, 2)) and the car's rollout kernels
(B2): the boxes are AL penalties, not solver limits, so
``rollout='pallas'`` holds.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt, N = 0.05, sm(120, 16)
    kw = dict(device=device, dtype=dtype)
    goal = torch.tensor([8.0, 0.0, 0.0, 0.0], **kw)
    system = itt.make_car(
        dt, x_target=goal,
        Q=torch.diag(torch.tensor([0.1, 0.1, 0.01, 0.1], **kw)),
        R=torch.diag(torch.tensor([1.0, 5.0], **kw)),
        Q_f=100.0 * torch.diag(torch.tensor([1.0, 1.0, 0.1, 1.0], **kw)),
        **kw)
    centers = torch.tensor([[3.0, 0.3], [5.5, -0.4]], **kw)
    radii = torch.tensor([1.0, 0.8], **kw)
    constraints = itt.merge_constraints(
        itt.obstacle_constraints(centers, radii, **kw),
        itt.box_control_constraints([-3.0, -0.5], [3.0, 0.5], **kw))
    return SimpleNamespace(
        system=system, constraints=constraints, goal=goal, centers=centers,
        radii=radii, x0=torch.zeros(4, **kw), U0=torch.zeros((N, 2), **kw),
        config=itt.IlqrConfig(maxiter=sm(100, 5), tol=1e-7,
                              backward="pallas", rollout="pallas"),
        # Gentler escalation: large mu jumps right after the iterate
        # crosses into a disc stall the inner solve on this problem.
        al_config=itt.AlConfig(max_outer=sm(15, 2), ctol=1e-3, mu0=50.0,
                               mu_factor=5.0))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=1):
    p = problem(device, dtype)

    def solve(x, U):
        return itt.solve_constrained(p.system, p.constraints, x, U, p.config,
                                     p.al_config)

    print("Warming up (building the kernels)…")
    warmup(solve, p.x0, p.U0)
    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    d_min = [float((sol.X[:, :2] - c).norm(dim=-1).min()) for c in p.centers]
    print(f"Constrained solve: status={int(sol.status)} "
          f"outer={int(sol.outer_iterations)} inner={int(sol.inner_iterations)} "
          f"cost={float(sol.cost):.3f} violation={float(sol.violation):.2e} "
          f"wall={sec * 1e3:.2f} ms (warmed)")
    print(f"goal error={float((sol.X[-1] - p.goal).abs().max()):.3f}, "
          f"obstacle clearances={d_min} (radii {p.radii.tolist()})")

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        fig, ax = plt.subplots(figsize=(9, 4))
        for c, r in zip(p.centers.tolist(), p.radii.tolist()):
            ax.add_patch(plt.Circle(c, r, color="#c44", alpha=0.35))
        X = sol.X.cpu()
        ax.plot(X[:, 0], X[:, 1], "-", lw=2, label="constrained path")
        ax.set_aspect("equal")
        ax.legend()
        fig.savefig(_os.path.join(out, "car_obstacles.png"), dpi=120)
    return sol


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
