"""Planar-quadrotor dash: thrust-limited optimization and TVLQR tracking
under model mismatch, on the port.

The twin of `examples/quadrotor_dash.py`: from hover to 3 m right and 1 m
up in 3 s (dt 0.01, N = 300) with rotor thrusts in [0, m g], then the plan
replayed on a 20 % heavier plant open loop and TVLQR-tracked
(`ilqr_tpu_torch.tracking`, gains synthesized fresh with tracking weights:
at convergence the limited pass's free-direction gains can be enormous).
The limited parallel backward pass scans through the suffix-scan kernel
(B6w at n = 6), the TVLQR synthesis through the fused backward pass (B1w
at (6, 2)).
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.models.quadrotor import hover_controls
from ilqr_tpu_torch.ops.fused_riccati import backward_pass_fused
from ilqr_tpu_torch.tracking import track, tvlqr_gains
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt, T = 0.01, sm(3.0, 0.15)
    N = int(T / dt)
    kw = dict(device=device, dtype=dtype)
    target = [3.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    weights = dict(
        Q=torch.diag(torch.tensor([1.0, 1.0, 0.5, 0.1, 0.1, 0.1], **kw)),
        R=0.1 * torch.eye(2, **kw),
        Q_f=torch.diag(torch.tensor([200.0, 200.0, 50.0, 20.0, 20.0, 10.0],
                                    **kw)))
    system = itt.make_quadrotor(dt, target, **weights, **kw)
    m, g = float(system.params["m"]), float(system.params["g"])
    f_max = 2.0 * 0.5 * m * g   # each rotor lifts the whole craft at most
    return SimpleNamespace(
        system=system, plant=itt.make_quadrotor(dt, target, m=1.2 * m,
                                                **weights, **kw),
        target=torch.tensor(target, **kw), f_max=f_max,
        x0=torch.zeros(6, **kw),
        U0=hover_controls(system.params).repeat(N, 1),
        config=itt.IlqrConfig(maxiter=sm(200, 5), tol=1e-6, u_min=0.0,
                              u_max=f_max, adaptive_reg=True,
                              backward="pallas"),
        track_weights=dict(
            Q=torch.diag(torch.tensor([10.0, 10.0, 10.0, 1.0, 1.0, 1.0],
                                      **kw)),
            R=torch.eye(2, **kw),
            Q_f=torch.diag(torch.tensor([100.0, 100.0, 100.0, 10.0, 10.0,
                                         10.0], **kw))))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=1):
    p = problem(device, dtype)

    def solve(x, U):
        return itt.solve(p.system, x, U, p.config)

    print("Warming up (building the kernels)…")
    warmup(solve, p.x0, p.U0)
    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"thrust-limited dash: {sec * 1e3:.1f} ms  cost={float(sol.cost):.3f}"
          f"  iters={int(sol.iterations)}  status={int(sol.status)}")
    print(f"rotor thrust range [{float(sol.U.min()):.3f}, "
          f"{float(sol.U.max()):.3f}] N  (limits [0, {p.f_max:.3f}])")
    print(f"final state err: {float((sol.X[-1] - p.target).norm()):.4f}")

    X_ol, _ = itt.rollout(p.plant, p.x0, sol.U)
    err_ol = float((X_ol[-1] - p.target).norm())
    K = tvlqr_gains(p.system, sol.X, sol.U, backward=backward_pass_fused,
                    **p.track_weights)
    X_tr, U_tr, _ = track(p.plant, p.x0, sol.X, sol.U, K,
                          u_limits=(0.0, p.f_max))
    err_tr = float((X_tr[-1] - p.target).norm())
    print(f"20% heavier plant, final error: open-loop {err_ol:.3f}  "
          f"TVLQR-tracked {err_tr:.3f}")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        plot_trajectory(X_tr, U_tr, p.system.dt, x_target=p.target,
                        title="Planar quadrotor dash, TVLQR on a heavy plant",
                        save_path=_os.path.join(out, "quadrotor_dash.png"))
    return SimpleNamespace(sol=sol, K=K, X_ol=X_ol, X_tr=X_tr, err_ol=err_ol,
                           err_tr=err_tr)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
