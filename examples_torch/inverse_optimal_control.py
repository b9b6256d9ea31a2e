"""Inverse optimal control: learn cost weights from demonstrations by
differentiating through the iLQR solve, on the port.

The twin of `examples/inverse_optimal_control.py`: an expert demonstrates
pendulum swing-ups (rk4, N = 60) from four initial states under hidden
weights (q_θ, q_θ̇, r) = (2, 0.5, 0.25); the learner recovers them by
backtracked gradient descent on the mismatch between its optimal controls
and the demonstrations, the gradient taken through each converged solve
by the implicit function theorem (`ilqr_tpu_torch.diff.solve_implicit`).
JAX vmaps the demonstrations; here a loop solves them in turn.
``main(config=...)`` overrides the solver's configuration (e.g. the
kernel engines ``backward='pallas', rollout='pallas'``: B1, B2),
``main(outer_steps=...)`` cuts the descent.  Run from the repository root:

    python examples_torch/inverse_optimal_control.py        # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/inverse_optimal_control.py --cpu
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import time
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.diff import solve_implicit
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE


def make_system(log_w, device=DEFAULT_DEVICE, dtype=torch.float32):
    """Pendulum whose cost weights are exp(log_w) = (q_θ, q_θ̇, r);
    differentiable in log_w."""
    w = torch.exp(log_w)
    return itt.make_pendulum(
        0.05, [np.pi, 0.0], Q=torch.diag(w[:2]),
        R=w[2] * torch.eye(1, dtype=dtype, device=device),
        Q_f=10.0 * np.eye(2), integrator="rk4", device=device, dtype=dtype)


def problem(device=DEFAULT_DEVICE, dtype=torch.float32,
            config=None) -> SimpleNamespace:
    opts = dict(dtype=dtype, device=device)
    N = sm(60, 10)
    return SimpleNamespace(
        N=N, device=device, dtype=dtype,
        config=(itt.IlqrConfig(maxiter=sm(150, 10), tol=1e-9)
                if config is None else config),
        U0=torch.zeros((N, 1), **opts),
        x0s=torch.tensor([[0.2, 0.0], [0.6, 0.0], [-0.4, 0.5], [1.0, -0.5]],
                         **opts),
        log_w_true=torch.log(torch.tensor([2.0, 0.5, 0.25], **opts)),
        log_w0=torch.zeros(3, **opts),   # all-ones weights
        outer_steps=sm(60, 2))


def demonstrations(p) -> torch.Tensor:
    """The expert's optimal controls from each initial state, (4, N, 1)."""
    expert = make_system(p.log_w_true, p.device, p.dtype)
    return torch.stack([itt.solve(expert, x0, p.U0, p.config).U
                        for x0 in p.x0s])


def loss_and_grad(p, log_w, demo_U, config=None):
    """(loss, d loss / d log_w, the four solutions): the mean squared
    mismatch of the learner's controls against the demonstrations."""
    log_w = log_w.detach().requires_grad_(True)
    sys_ = make_system(log_w, p.device, p.dtype)
    sols = [solve_implicit(sys_, x0, p.U0,
                           p.config if config is None else config)
            for x0 in p.x0s]
    loss = torch.mean((torch.stack([s.U for s in sols]) - demo_U) ** 2)
    (g,) = torch.autograd.grad(loss, log_w)
    return loss.detach(), g, sols


def main(plot=False, device=DEFAULT_DEVICE, dtype=torch.float32, config=None,
         outer_steps=None):
    p = problem(device, dtype, config)
    steps = p.outer_steps if outer_steps is None else outer_steps
    demo_U = demonstrations(p)

    t0 = time.perf_counter()
    log_w, lr = p.log_w0, 1.0
    val, g, first_sols = loss_and_grad(p, log_w, demo_U)
    first = (val, g)
    for k in range(steps):
        # Backtracked gradient descent: the landscape is stiff in the
        # small-R direction, so a fixed step diverges.
        cand = log_w - lr * g
        val_c, g_c, _ = loss_and_grad(p, cand, demo_U)
        if float(val_c) < float(val):
            log_w, val, g = cand, val_c, g_c
            lr = min(lr * 1.5, 4.0)
        else:
            lr *= 0.3
        if k % 10 == 0:
            print(f"iter {k:3d}  loss {float(val):.6f}  lr {lr:.3f}  "
                  f"weights {torch.exp(log_w).cpu().numpy()}")
    secs = time.perf_counter() - t0
    print(f"\nlearned weights: {torch.exp(log_w).cpu().numpy()}")
    print(f"true weights:    {torch.exp(p.log_w_true).cpu().numpy()}")
    print(f"final loss {float(val):.2e}  ({secs:.1f}s)")
    return SimpleNamespace(log_w=log_w, loss=val, grad=g, first_loss=first[0],
                           first_grad=first[1], first_sols=first_sols,
                           demo_U=demo_U, seconds=secs)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
