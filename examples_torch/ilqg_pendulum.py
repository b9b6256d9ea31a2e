"""iLQG against deterministic iLQR under control-multiplicative noise, on
the port.

The twin of `examples/ilqg_pendulum.py`: the pendulum swing-up with
effort-proportional actuation noise x⁺ = f(x, u) + σ·B·u·ξ
(`ilqr_tpu_torch.ilqg`).  The deterministic policy commands large torques
whose noise blows the closed loop up; the iLQG policy trades tracking for
caution and stays bounded.  Both policies are scored by Monte-Carlo
closed loops on the same seeded draws.  Run from the repository root:

    python examples_torch/ilqg_pendulum.py                 # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/ilqg_pendulum.py --cpu

``SIGMA`` sets the noise scale (1.5).
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import os
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ilqg import (
    control_multiplicative_noise,
    simulate_closed_loop,
)
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE


def problem(device=DEFAULT_DEVICE, dtype=torch.float32, sigma=1.5
            ) -> SimpleNamespace:
    system = itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2),
                               R=0.1 * np.eye(1), Q_f=10.0 * np.eye(2),
                               d=0.1, integrator="rk4", device=device,
                               dtype=dtype)
    noise_fn = control_multiplicative_noise(sigma, [[0.0], [1.0]])
    cfg = dict(maxiter=sm(80, 5), tol=1e-7)
    return SimpleNamespace(
        system=system, noise_fn=noise_fn, sigma=sigma,
        x0=torch.zeros(2, dtype=dtype, device=device),
        U0=torch.zeros((sm(200, 16), 1), dtype=dtype, device=device),
        config=itt.IlqrConfig(**cfg),
        config_ilqg=itt.IlqrConfig(noise=noise_fn, **cfg),
        n_rollouts=sm(256, 8), seed=0)


def main(sigma=1.5, plot=False, device=DEFAULT_DEVICE, dtype=torch.float32):
    p = problem(device, dtype, sigma)
    out = {}
    for key, name, cfg in (("det", "deterministic", p.config),
                           ("ilqg", f"iLQG (σ={sigma})", p.config_ilqg)):
        sol = itt.solve(p.system, p.x0, p.U0, cfg)
        print(f"{name} nominal cost: {float(sol.cost):.3f} "
              f"(iters {sol.iterations})")
        out[key] = sol
    for key, name in (("det", "deterministic"), ("ilqg", "iLQG")):
        sol = out[key]
        gen = torch.Generator(device=p.x0.device).manual_seed(p.seed)
        mean, std = simulate_closed_loop(p.system, p.noise_fn, sol.X, sol.U,
                                         sol.K, gen, n_rollouts=p.n_rollouts)
        print(f"{name:>13} policy under the noise: "
              f"E[cost] = {float(mean):.2f} ± {float(std):.2f}")
        out[f"{key}_stats"] = (mean, std)
    return SimpleNamespace(**out)


if __name__ == "__main__":
    main(float(os.environ.get("SIGMA", "1.5")),
         device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
