"""Long-horizon stretch workload: a 100k-step cart-pole, on the port.

The twin of `examples/long_horizon.py`: the cart-pole (dt = 0.0005, a 50 s
horizon at N = 100000) through the parallel-in-time path — the fused
backward pass (B1), the open-loop defect rollout and the 'defect' line
search (Newton sweeps on the affine scan, B3), and multiple shooting
(`solve_ms`: B1 with defects, B3's update pass) — beside the sequential
rollout and line search.  On CPU tensors the kernels run their plain
versions.  Run from the repository root:

    python examples_torch/long_horizon.py                  # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/long_horizon.py --cpu

``N_HORIZON`` overrides the horizon.
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
from ilqr_tpu_torch.ops.parallel_rollout import open_loop_defect_rollout
from ilqr_tpu_torch.utils.timing import timed


def horizon() -> int:
    return int(os.environ.get("N_HORIZON", sm(100_000, 512)))


def problem(device=DEFAULT_DEVICE, dtype=torch.float32, N=None
            ) -> SimpleNamespace:
    N = horizon() if N is None else N
    system = itt.make_cartpole(
        0.0005, [0.0, np.pi, 0.0, 0.0], Q=np.diag([1.0, 5.0, 0.1, 0.1]),
        R=0.1 * np.eye(1), Q_f=np.diag([100.0, 500.0, 50.0, 50.0]),
        device=device, dtype=dtype)
    base = dict(tol=1e-6, backward="pallas", init_rollout="defect")
    return SimpleNamespace(
        system=system, x0=torch.zeros(4, dtype=dtype, device=device),
        U0=torch.zeros((N, 1), dtype=dtype, device=device),
        # Every stage parallel-in-time; the exact rollouts guard the
        # uncertified candidates.
        config=itt.IlqrConfig(maxiter=sm(10, 2), adaptive_reg=True,
                              rollout="defect", **base),
        config_seq=itt.IlqrConfig(maxiter=sm(10, 2), adaptive_reg=True,
                                  **base),
        config_ms=itt.IlqrConfig(maxiter=sm(30, 2), **base),
        ms=itt.MsConfig(update_engine="pallas"))


def main(N=None, plot=False, device=DEFAULT_DEVICE, dtype=torch.float32):
    p = problem(device, dtype, N)
    sys_, x0, U0 = p.system, p.x0, p.U0
    N = U0.shape[0]

    # Per-stage timings at this horizon.
    t_roll, (X, _) = timed(itt.rollout, sys_, x0, U0, reps=1, warmup_reps=1)
    t_lin, exp = timed(itt.linearize_trajectory, sys_, X, U0, reps=1,
                       warmup_reps=1)
    t_bp, _ = timed(itt.backward_pass_fused, exp, 0.0, reps=3)
    print(f"N={N}: rollout={t_roll * 1e3:.1f}ms "
          f"linearize={t_lin * 1e3:.1f}ms fused-backward={t_bp * 1e3:.1f}ms "
          f"({N / t_bp / 1e6:.2f}M timesteps/s)")

    # Parallel-in-time initial rollout (Newton sweeps + affine prefix scan).
    t_roll_p, (_, _, defect) = timed(open_loop_defect_rollout, sys_, x0,
                                     U0, iters=8, reps=1, warmup_reps=1)
    print(f"initial rollout: sequential={t_roll * 1e3:.1f}ms "
          f"defect-parallel={t_roll_p * 1e3:.1f}ms "
          f"(certified defect {float(defect):.1e})")

    out = {"defect": defect}
    for key, what, cfg in (
            ("sol", "all stages parallel-in-time", p.config),
            ("sol_seq", "sequential line search", p.config_seq)):
        t, sol = timed(itt.solve, sys_, x0, U0, cfg, reps=1, warmup_reps=0)
        print(f"{cfg.maxiter}-iteration solve ({what}): {t:.2f}s  "
              f"cost={float(sol.cost):.4f} iters={sol.iterations}")
        out[key] = sol

    # Multiple shooting: the line search needs no nonlinear rollout at all
    # (affine update pass + defect evaluation), so every stage of every
    # iteration is O(log N) deep.
    t_ms, sol_ms = timed(itt.solve_ms, sys_, x0, U0, config=p.config_ms,
                         ms=p.ms, reps=1, warmup_reps=0)
    print(f"multiple-shooting solve (all stages O(log N)): {t_ms:.2f}s  "
          f"cost={float(sol_ms.cost):.4f} iters={sol_ms.iterations} "
          f"defect={float(sol_ms.defect):.1e}")
    out["sol_ms"] = sol_ms
    return SimpleNamespace(**out)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
