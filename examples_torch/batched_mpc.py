"""Batched solves: hundreds of double-pendulum instances on one GPU, on the
port.

The twin of `examples/batched_mpc.py`: B double-pendulum swing-ups (rk4,
dt 0.01, horizon 100) from random initial states, solved at once by
`parallel.solve_batched` (`solver.solve_batch`, the port's
``jax.vmap(solve)``) with ``mesh=None`` on one card, and the throughput in
solves per second.  The JAX driver shards the batch over a device mesh
when there are several; sharding over GPUs is ROADMAP item A19.  The
initial states come from a seeded `torch.Generator` on the device (JAX
draws them from its own key).  Run from the repository root:

    python examples_torch/batched_mpc.py                  # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/batched_mpc.py --cpu
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.parallel import solve_batched
from ilqr_tpu_torch.utils.random import generator, normal
from ilqr_tpu_torch.utils.timing import timed, warmup


def problem(device=DEFAULT_DEVICE, dtype=torch.float32,
            B: int = 512) -> SimpleNamespace:
    B = sm(B, 8)
    dt = 0.01
    N_h = sm(100, 12)
    system = itt.make_double_pendulum(
        dt, x_target=[np.pi, 0.0, 0.0, 0.0],
        Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=np.diag([0.1, 0.1]),
        Q_f=np.diag([1000.0, 1000.0, 100.0, 100.0]),
        d1=0.1, d2=0.1, theta1=1 / 12, theta2=1 / 12, integrator="rk4",
        device=device, dtype=dtype)
    gen = generator(0, device)
    return SimpleNamespace(
        system=system,
        x0s=0.3 * normal(gen, (B, 4), dtype, device),
        U0=torch.zeros((N_h, 2), dtype=dtype, device=device),
        config=itt.IlqrConfig(maxiter=sm(10, 3), tol=1e-5))


def main(device=DEFAULT_DEVICE, dtype=torch.float32, B: int = 512,
         reps: int = 3):
    """Solve the batch ``reps`` times after a warm-up and print the
    throughput.  Returns the batched `IlqrSolution`."""
    p = problem(device, dtype, B)
    print(f"device={device} (one card; mesh=None)")

    def fn(xs):
        return solve_batched(p.system, xs, p.U0, p.config, mesh=None)

    warmup(fn, p.x0s)
    sec, sols = timed(fn, p.x0s, reps=reps)
    B = p.x0s.shape[0]
    print(f"batched open-loop solves: B={B}  {sec * 1e3:.1f} ms "
          f"-> {B / sec:.0f} solves/s; mean cost={float(sols.cost.mean()):.3f}")
    return sols


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
