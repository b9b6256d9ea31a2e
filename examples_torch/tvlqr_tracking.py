"""TVLQR tracking: stabilize a solved swing-up under disturbances, on the
port.

The twin of `examples/tvlqr_tracking.py`: solve the pendulum swing-up once
(N = 400, rk4, through the kernels: B1, B2), then run it closed loop from
four perturbed initial states on a mismatched plant (damping 0.13, midpoint)
with the solver's own time-varying gains (`track_solution`), against
open-loop replay of the same controls.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.tracking import track_solution


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt, N = 0.01, sm(400, 16)
    kw = dict(device=device, dtype=dtype)

    def mk(d, integrator):
        return itt.make_pendulum(dt, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                                 Q_f=100.0 * np.eye(2), d=d,
                                 integrator=integrator, **kw)

    x0 = torch.zeros(2, **kw)
    return SimpleNamespace(
        system=mk(0.1, "rk4"), plant=mk(0.13, "midpoint"), dt=dt, x0=x0,
        U0=torch.zeros((N, 1), **kw),
        starts=x0 + torch.tensor([[0.2, 0.0], [-0.2, 0.1], [0.1, -0.3],
                                  [0.0, 0.4]], **kw),
        config=itt.IlqrConfig(maxiter=sm(200, 5), tol=1e-6,
                              backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32):
    p = problem(device, dtype)
    sol = itt.solve(p.system, p.x0, p.U0, p.config)
    print(f"Swing-up solved: cost={float(sol.cost):.4f} terminal "
          f"θ={float(sol.X[-1, 0]):.4f} (π={np.pi:.4f})")
    tracked = [track_solution(p.plant, x, sol)[0] for x in p.starts]
    replay = [itt.rollout(p.plant, x, sol.U)[0] for x in p.starts]
    err_cl = [float((X[-1] - sol.X[-1]).abs().max()) for X in tracked]
    err_ol = [float((X[-1] - sol.X[-1]).abs().max()) for X in replay]
    for i, (a, b) in enumerate(zip(err_cl, err_ol)):
        print(f"  start {i}: terminal error tracked={a:.4f} open-loop={b:.4f}")

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        t = np.arange(sol.X.shape[0]) * p.dt
        fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
        for Xt, Xo in zip(tracked, replay):
            axes[0].plot(t, Xt[:, 0].cpu(), lw=1)
            axes[1].plot(t, Xo[:, 0].cpu(), lw=1)
        for ax, title in zip(axes, ["TVLQR tracked", "open-loop replay"]):
            ax.plot(t, sol.X[:, 0].cpu(), "k--", lw=1.5)
            ax.set_title(title)
        fig.savefig(_os.path.join(out, "tvlqr_tracking.png"), dpi=110)
    return SimpleNamespace(sol=sol, err_cl=err_cl, err_ol=err_ol)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
