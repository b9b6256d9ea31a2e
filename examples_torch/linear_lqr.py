"""Linear double-integrator LQR, the exactly linear one-shot case, on the
port.

The twin of `examples/linear_lqr.py`: exact ZOH discretization
(`cont2disc`) and the one-shot finite-horizon LQR (`lqr_solve`), cross-
checked against the iLQR solver, which converges on a linear problem in
one step, its backward pass the fused kernel (``backward='pallas'``, B1).
The discrete LTI system has no device model, so its rollouts are the host
loops.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from types import SimpleNamespace

import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE


def problem(device=DEFAULT_DEVICE, dtype=torch.float64) -> SimpleNamespace:
    dt, T = 0.1, 5.0
    kw = dict(device=device, dtype=dtype)
    A_c = torch.tensor([[0.0, 1.0], [0.0, 0.0]], **kw)
    B_c = torch.tensor([[0.0], [1.0]], **kw)
    A_d, B_d = itt.cont2disc(A_c, B_c, dt)
    return SimpleNamespace(
        dt=dt, N=int(round(T / dt)), A_d=A_d, B_d=B_d,
        Q=torch.eye(2, **kw), R=torch.eye(1, **kw), Q_f=10.0 * torch.eye(2, **kw),
        x0=torch.tensor([2.0, 0.0], **kw))


def main(plot=True, device=DEFAULT_DEVICE, dtype=torch.float64):
    p = problem(device, dtype)
    print(f"ZOH discretization:\nA_d=\n{p.A_d.cpu().numpy()}\n"
          f"B_d=\n{p.B_d.cpu().numpy()}")
    sol = itt.lqr_solve(p.A_d, p.B_d, p.Q, p.R, p.Q_f, p.x0, p.N)
    print(f"One-shot LQR cost: {float(sol.cost):.5f}, "
          f"x_N={sol.X[-1].cpu().numpy()}")
    # The same problem through iLQR: one step from zero controls.  The
    # kernels take float32, so the check runs in it.
    f32 = dict(device=device, dtype=torch.float32)
    lti = itt.make_discrete_lti(p.A_d.float(), p.B_d.float(), p.dt,
                                torch.zeros(2, **f32), p.Q.float(), p.R.float(),
                                p.Q_f.float(), **f32)
    it_sol = itt.solve(lti, p.x0.float(), torch.zeros((p.N, 1), **f32),
                       itt.IlqrConfig(maxiter=5, tol=1e-9, backward="pallas"))
    print(f"iLQR on the same problem: cost {float(it_sol.cost):.5f} after "
          f"{int(it_sol.iterations)} iterations (the stage cost is "
          f"dt-scaled there)")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        plot_trajectory(sol.X, sol.U, p.dt, x_target=[0.0, 0.0],
                        state_labels=["pos", "vel"],
                        title="Double-integrator LQR",
                        save_path=_os.path.join(out, "linear_lqr.png"))
    return SimpleNamespace(lqr=sol, ilqr=it_sol)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
