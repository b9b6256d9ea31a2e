"""MPPI against iLQR on the torque-limited pendulum swing-up, on the port.

The twin of `examples/mppi_pendulum.py`; three controllers on one task
(rk4 solver, midpoint plant, |u| <= 8):

  1. sampling MPC (`ilqr_tpu_torch.mppi.run_mpc_mppi`, 512 samples x 4
     updates a step, H = 30, 120 steps): each update's samples in one
     launch of B5's open-loop entry, the mean's rollout by B2's open loop;
  2. gradient MPC (`mpc.run_mpc` with box-QP control limits);
  3. MPPI as a global explorer (1024 samples x 60 updates, N = 80) whose
     result warm-starts an iLQR polish, beside iLQR from zeros.

The draws come from seeded `torch.Generator`s on the device.  Run from
the repository root:

    python examples_torch/mppi_pendulum.py                  # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/mppi_pendulum.py --cpu
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
from ilqr_tpu_torch.mppi import MppiConfig, run_mpc_mppi, solve_mppi
from ilqr_tpu_torch.utils.timing import timed

U_LIM = 8.0


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    opts = dict(dtype=dtype, device=device)
    dt, N_h, N_ol = 0.05, sm(30, 8), sm(80, 10)
    system = itt.make_pendulum(
        dt, [np.pi, 0.0], Q=np.diag([5.0, 0.5]), R=0.1 * np.eye(1),
        Q_f=np.diag([50.0, 5.0]), integrator="rk4", device=device,
        dtype=dtype)
    return SimpleNamespace(
        system=system, plant=system.with_integrator("midpoint"),
        x0=torch.zeros(2, **opts), U0=torch.zeros((N_h, 1), **opts),
        U0_ol=torch.zeros((N_ol, 1), **opts), n_sim=sm(120, 6), seed=0,
        mppi_config=MppiConfig(samples=sm(512, 16), iters=sm(4, 2),
                               temperature=0.2, sigma=1.0, noise_beta=0.8,
                               u_min=-U_LIM, u_max=U_LIM),
        ilqr_config=itt.IlqrConfig(maxiter=sm(8, 3), tol=1e-6,
                                   u_min=-U_LIM, u_max=U_LIM),
        explore_config=MppiConfig(samples=sm(1024, 16), iters=sm(60, 2),
                                  temperature=0.1, sigma=1.2,
                                  noise_beta=0.8, u_min=-U_LIM,
                                  u_max=U_LIM),
        ol_config=itt.IlqrConfig(maxiter=sm(100, 5), tol=1e-8,
                                 u_min=-U_LIM, u_max=U_LIM))


def mppi_mpc(p, n_sim=None):
    return run_mpc_mppi(p.system, p.plant, p.x0, p.U0,
                        p.n_sim if n_sim is None else n_sim, p.seed,
                        p.mppi_config)


def explore(p):
    return solve_mppi(p.system, p.x0, p.U0_ol, p.seed, p.explore_config)


def main(plot=False, device=DEFAULT_DEVICE, dtype=torch.float32):
    p = problem(device, dtype)
    out = {}

    def run(name, key, fn, *args):
        sec, res = timed(fn, *args, reps=1, warmup_reps=0)
        print(f"{name:34s} cost {float(res.cost):8.3f}   "
              f"{sec * 1e3:7.1f} ms")
        out[key] = res
        return res

    run(f"MPPI MPC ({p.mppi_config.samples} samples x "
        f"{p.mppi_config.iters} iters)", "mppi_mpc", mppi_mpc, p)
    run("iLQR MPC (boxQP limits)", "ilqr_mpc", lambda x: run_mpc(
        p.system, p.plant, x, p.U0, p.n_sim, p.ilqr_config), p.x0)
    # Global, then local: MPPI explores, iLQR polishes.
    warm = run("MPPI open-loop explore", "explore", explore, p)
    run("iLQR polish (MPPI warm start)", "polish", lambda u: itt.solve(
        p.system, p.x0, u, p.ol_config), warm.U)
    run("iLQR from zeros (reference)", "from_zeros", lambda u: itt.solve(
        p.system, p.x0, u, p.ol_config), p.U0_ol)
    return SimpleNamespace(**out)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
