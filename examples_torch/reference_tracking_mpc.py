"""Time-varying reference tracking MPC: follow a moving target, on the port.

The twin of `examples/reference_tracking_mpc.py`: the pendulum follows a
sinusoidal angle reference through `make_tracking_system` (the step index
rides in the state, so the receding-horizon window shifts with the plant's
clock): 600 steps at dt 0.01, horizon 50, maxiter 8.  Each solve's backward
pass is the fused kernel (B1w at the augmented (3, 1)); the rollouts are
the host loops of rollout='auto', and rollout='pallas' runs them through
the rollout kernels' tracking form instead.  ``main(n_sim=...)`` cuts the
simulated steps.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.mpc import run_mpc
from ilqr_tpu_torch.utils.timing import timed


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt = 0.01
    N_sim, horizon = sm(600, 6), sm(50, 10)
    kw = dict(device=device, dtype=dtype)
    base = itt.make_pendulum(dt, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.zeros((2, 2)), d=0.05, integrator="rk4",
                             **kw)
    t = torch.arange(N_sim + horizon + 1, **kw) * dt
    theta_ref = 0.8 * torch.sin(2.0 * t)
    X_ref = torch.stack([theta_ref, 1.6 * torch.cos(2.0 * t)], dim=-1)
    trk = itt.make_tracking_system(
        base, X_ref, torch.zeros((N_sim + horizon, 1), **kw),
        Q=torch.diag(torch.tensor([100.0, 1.0], **kw)),
        R=0.01 * torch.eye(1, **kw), Q_f=torch.zeros((2, 2), **kw))
    return SimpleNamespace(
        system=trk, theta_ref=theta_ref, n_sim=N_sim,
        x0=itt.augment_x0(torch.zeros(2, **kw)),
        U0=torch.zeros((horizon, 1), **kw),
        config=itt.IlqrConfig(maxiter=8, tol=1e-6, backward="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=1,
         n_sim=None):
    p = problem(device, dtype)
    n_sim = p.n_sim if n_sim is None else n_sim

    def mpc(x):
        return run_mpc(p.system, p.system, x, p.U0, n_sim, p.config)

    sec, res = timed(mpc, p.x0, reps=reps, warmup_reps=0)
    theta = itt.strip_clock(res.X)[:, 0]
    rms = float(torch.sqrt(torch.mean((theta - p.theta_ref[:n_sim + 1]) ** 2)))
    print(f"tracking MPC: {n_sim} steps in {sec * 1e3:.1f} ms "
          f"({sec / n_sim * 1e3:.2f} ms/step), RMS angle error {rms:.4f} rad")

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        ts = np.arange(n_sim + 1) * p.system.dt
        fig, ax = plt.subplots(figsize=(9, 3))
        ax.plot(ts, p.theta_ref[:n_sim + 1].cpu(), "k--", label="reference")
        ax.plot(ts, theta.cpu(), label="closed loop")
        ax.legend()
        fig.savefig(_os.path.join(out, "reference_tracking_mpc.png"),
                    dpi=110)
    return SimpleNamespace(res=res, rms=rms)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
