"""Parallel-in-time state estimation on a long pendulum record, on the port.

The twin of `examples/parallel_estimation.py`: estimate a noise-driven
pendulum (dt = 0.001, rk4, damping 0.05) observed through its angle alone
from a 100000-step record with

  1. the sequential EKF and RTS smoother (`ilqr_tpu_torch.estimation`),
     host loops over time, and
  2. the associative-scan filter and iterated smoother
     (`ilqr_tpu_torch.estimation_parallel`), O(log N) deep per sweep, whose
     linearization trajectory comes from the defect-parallel sweeps (kernel
     B3 on the card),

and compare time and RMS-to-truth.  The record's noise comes from numpy
(seed 0), so that a test can rebuild it; the true trajectory is the
rollout of its controls (B2's open loop on a CUDA float32 record).
``main(seq_N=...)`` runs the sequential estimators on the record's first
``seq_N`` steps.  Run from the repository root:

    python examples_torch/parallel_estimation.py            # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/parallel_estimation.py --cpu
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import os
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.estimation import EkfState, run_ekf, run_eks
from ilqr_tpu_torch.estimation_parallel import run_ekf_parallel, run_eks_parallel
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.utils.timing import timed


def obs(x):
    """Measure θ only."""
    return x[:1]


def record_arrays(N: int):
    """The record's numpy inputs, seed 0: controls U (N, 1) and the
    measurement noise (N, 1)."""
    rng = np.random.default_rng(0)
    U = 0.6 * np.sin(np.linspace(0, 40, N))[:, None] \
        + 0.05 * rng.standard_normal((N, 1))
    return U, 0.03 * rng.standard_normal((N, 1))


def problem(N: int, device=DEFAULT_DEVICE, dtype=torch.float32
            ) -> SimpleNamespace:
    system = itt.make_pendulum(0.001, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                               Q_f=np.zeros((2, 2)), d=0.05,
                               integrator="rk4", device=device, dtype=dtype)
    U_np, V_np = record_arrays(N)
    x0, U, V = system.inputs([0.3, 0.0], U_np, V_np)
    rollout = (itt.open_loop_rollout_fused if dtype == torch.float32
               else itt.rollout)
    X_true = rollout(system, x0, U)[0]
    return SimpleNamespace(
        system=system, U=U, Y=X_true[1:, :1] + V, X_true=X_true,
        s0=EkfState(x0, 0.1 * torch.eye(2, dtype=dtype, device=device)),
        Q_proc=1e-6 * torch.eye(2, dtype=dtype, device=device),
        R_obs=1e-3 * torch.eye(1, dtype=dtype, device=device))


def estimators(p, n=None):
    """{name: fn()} of the four estimators, the sequential ones on the
    record's first n steps; each returns its estimates (n or N, 2)."""
    a = (p.system, obs, p.s0)
    n = p.U.shape[0] if n is None else n
    U, Y, Qp, Ro = p.U, p.Y, p.Q_proc, p.R_obs
    return {
        "EKF  sequential ": lambda: run_ekf(*a, U[:n], Y[:n], Qp, Ro)[1],
        "EKF  parallel   ": lambda: run_ekf_parallel(*a, U, Y, Qp, Ro)[0],
        "EKS  sequential ": lambda: run_eks(*a, U[:n], Y[:n], Qp, Ro)[0],
        "EKS  parallel(2)": lambda: run_eks_parallel(*a, U, Y, Qp, Ro,
                                                     iters=2)[0],
    }


def rms(p, X_hat) -> float:
    """RMS-to-truth of estimates of x_1 … x_n."""
    n = X_hat.shape[0]
    return float(torch.sqrt(torch.mean((X_hat - p.X_true[1:n + 1]) ** 2)))


def main(N: int = 100_000, device=DEFAULT_DEVICE, dtype=torch.float32,
         seq_N=None, reps=3):
    p = problem(N, device, dtype)
    out = {}
    for name, fn in estimators(p, seq_N).items():
        sec, Xh = timed(fn, reps=reps, warmup_reps=1)
        out[name.strip()] = (Xh, sec, rms(p, Xh))
        print(f"{name} (N={Xh.shape[0]}): {sec * 1e3:8.1f} ms   "
              f"RMS-to-truth {rms(p, Xh):.2e}")
    return out


if __name__ == "__main__":
    main(int(os.environ.get("N_HORIZON", sm(100_000, 512))),
         device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
