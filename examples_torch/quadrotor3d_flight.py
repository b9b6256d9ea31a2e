"""3-D quadrotor flight (n_x = 12, n_u = 4): thrust-limited open loop and
MPC, on the port.

The twin of `examples/quadrotor3d_flight.py`: a flight to (2, 1, 1.5) at
dt 0.02 over 3 s (N = 150) with every rotor's thrust in [0, 0.6 m g] and
adaptive regularization, then a receding-horizon loop (H = 50, 150 steps)
with an rk4 solver model against an euler plant.  The open loop's limited
parallel backward pass scans through the suffix-scan kernel (B6w at
n = 12; its line search is the clipped host loop, as limits refuse the
rollout kernels); the MPC solves run the fused backward pass (B1w at
(12, 4)) and the quadrotor's rollout kernels (B2).  ``main(n_sim=...)``
cuts the simulated steps.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.models.quadrotor3d import default_weights, hover_controls
from ilqr_tpu_torch.mpc import run_mpc
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    dt, T = 0.02, sm(3.0, 0.3)
    N = int(T / dt)
    target = [2.0, 1.0, 1.5] + [0.0] * 9
    kw = dict(device=device, dtype=dtype)
    Q, R, Q_f = default_weights(**kw)
    system = itt.make_quadrotor3d(dt, target, Q, R, Q_f, integrator="rk4",
                                  **kw)
    plant = itt.make_quadrotor3d(dt, target, Q, R, Q_f, integrator="euler",
                                 **kw)
    m, g = float(system.params["m"]), float(system.params["g"])
    f_max = 0.6 * m * g   # each rotor lifts about 2.4x its hover share
    H = sm(50, 10)
    hover = hover_controls(system.params)
    return SimpleNamespace(
        system=system, plant=plant, dt=dt, target=target, f_max=f_max,
        x0=torch.zeros(12, **kw), U0=hover.repeat(N, 1),
        U0_mpc=hover.repeat(H, 1), n_sim=sm(150, 5),
        config=itt.IlqrConfig(maxiter=sm(200, 5), tol=1e-6, u_min=0.0,
                              u_max=f_max, adaptive_reg=True,
                              backward="pallas"),
        config_mpc=itt.IlqrConfig(maxiter=sm(5, 2), tol=1e-5,
                                  backward="pallas", rollout="pallas"))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float32, reps=1,
         n_sim=None):
    p = problem(device, dtype)
    n_sim = p.n_sim if n_sim is None else n_sim

    def solve(x, U):
        return itt.solve(p.system, x, U, p.config)

    print("Warming up (building the kernels)…")
    warmup(solve, p.x0, p.U0)
    sec, sol = timed(solve, p.x0, p.U0, reps=reps, warmup_reps=0)
    print(f"open-loop flight: {sec * 1e3:.1f} ms  status={int(sol.status)}  "
          f"iters={int(sol.iterations)}  cost={float(sol.cost):.3f}")
    print(f"  final pos {sol.X[-1, :3].cpu().numpy().round(3)}  max rotor "
          f"thrust {float(sol.U.max()):.3f} (limit {p.f_max:.3f})")

    def mpc(x):
        return run_mpc(p.system, p.plant, x, p.U0_mpc, n_sim, p.config_mpc)

    sec, res = timed(mpc, p.x0, reps=reps, warmup_reps=0)
    print(f"MPC (horizon {p.U0_mpc.shape[0]}, {n_sim} steps, rk4 solver / "
          f"euler plant): {sec / n_sim * 1e3:.2f} ms/step  closed-loop cost "
          f"{float(res.cost):.3f}")
    print(f"  final pos {res.X[-1, :3].cpu().numpy().round(3)}")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X[:, :3], sol.U, p.dt, x_target=p.target[:3],
                        state_labels=["x", "y", "z"],
                        title="3-D quadrotor flight",
                        save_path=_os.path.join(out, "quadrotor3d_flight.png"))
    return sol, res


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
