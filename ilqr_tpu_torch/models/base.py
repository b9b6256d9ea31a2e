"""System abstraction: pure-function dynamics and costs over tensors.

PyTorch counterpart of `ilqr_tpu/models/base.py`.  A `System` is a frozen
dataclass holding a dict of parameter tensors and three pure functions

    f_cont(params, x, u)        -> xdot          (continuous dynamics)
    stage_cost(params, x, u)    -> scalar        (running cost l)
    terminal_cost(params, x)    -> scalar        (terminal cost l_f)

Every function here is written over the trailing axis, so it accepts one
state (n_x,) or a batch (..., n_x) alike; `torch.func` derives the rest
(`ilqr_tpu_torch.ops`).  There is no `nn.Module`: the learned residual
(`models/neural.py`) trains its parameter tensors with `torch.optim`.

`full_f32_matmuls` is the counterpart of `f32_matmuls`: on the GPU it keeps
float32 matrix products and convolutions out of TF32, under which long
Riccati recursions lose the digits they need.

Systems are built on `DEFAULT_DEVICE`, the GPU, unless the caller names
another device (the CPU tests pass ``device="cpu"``); without CUDA such a
build fails as torch fails.  The entry points (`solve`, the MPC loops, ...)
run on the device of the system's parameters and move their inputs there
with `System.inputs`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import torch

# Where the model factories and `convert.py` put parameters by default.
DEFAULT_DEVICE = "cuda"


@contextlib.contextmanager
def full_f32_matmuls():
    """Scope (usable as a decorator) with TF32 off for matmul and cuDNN.

    The previous settings are restored on exit, so user code outside the
    library's entry points is left as it was.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def lin_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A⁻¹B, batched, without the singularity check of `torch.linalg.solve`:
    a singular A gives non-finite entries, which the callers' ``ok`` flags
    and accept rules see (JAX's small solves behave so), and on the GPU no
    host sync waits for the check."""
    return torch.linalg.solve_ex(A, B)[0]


def lin_inv(A: torch.Tensor) -> torch.Tensor:
    """A⁻¹, batched, without the singularity check (see `lin_solve`)."""
    return torch.linalg.inv_ex(A)[0]


# Integrator names accepted framework-wide (same set as the JAX package).
INTEGRATORS = ("euler", "midpoint", "rk4", "backward_euler", "trapezoidal",
               "discrete")


@dataclasses.dataclass(frozen=True)
class System:
    """A controlled dynamical system with costs.

    ``params`` maps names to tensors (or, for a wrapped system, to the
    base's dict; for a neural residual, to its list of layers) that all
    live on one device with one floating dtype; the other fields are
    static metadata.
    """

    params: Dict[str, torch.Tensor]
    n_x: int
    n_u: int
    dt: float
    f_cont: Callable
    stage_cost: Callable
    terminal_cost: Callable
    integrator: str = "rk4"
    # Fixed quasi-Newton iteration count of the implicit integrators.
    newton_iters: int = 10

    def tensors(self):
        """The parameter tensors, those of nested dicts and lists included:
        a wrapped system's base, and a neural residual's layers, which are
        a list of ``{W, b}`` dicts as JAX's MLP is (`models/neural.py`)."""
        stack = [self.params]
        while stack:
            node = stack.pop()
            for v in node.values() if isinstance(node, dict) else node:
                if isinstance(v, (dict, list, tuple)):
                    stack.append(v)
                elif v is not None:
                    yield v

    @property
    def device(self) -> torch.device:
        """The one device of the parameters; raises if they span devices."""
        devices = {t.device for t in self.tensors()}
        if len(devices) != 1:
            raise ValueError(f"the system's parameters span devices "
                             f"{sorted(map(str, devices))}")
        return devices.pop()

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype of the parameters."""
        return next(t.dtype for t in self.tensors() if t.is_floating_point())

    def inputs(self, *arrays):
        """``arrays`` (numpy arrays, sequences, or tensors on any device) as
        tensors on the system's device and dtype; None stays None."""
        device, dtype = self.device, self.dtype
        out = tuple(None if a is None else as_tensor(a, device, dtype)
                    for a in arrays)
        return out[0] if len(out) == 1 else out

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    def with_integrator(self, integrator: str) -> "System":
        if integrator not in INTEGRATORS:
            raise ValueError(
                f"Unknown integrator {integrator!r}; supported: {INTEGRATORS}"
            )
        return self.replace(integrator=integrator)


def as_tensor(v, device, dtype) -> torch.Tensor:
    """``v`` (number, sequence, numpy array or tensor) on device and dtype."""
    return torch.as_tensor(v, dtype=dtype, device=device)


def quadratic_cost_params(x_target, Q, R, Q_f, *, device=DEFAULT_DEVICE,
                          dtype=torch.float32) -> dict:
    """Quadratic tracking-cost parameter block shared by all models.

    Model constructors add a ``dt`` entry (the stage cost is dt-scaled).
    """
    return dict(
        x_target=as_tensor(x_target, device, dtype),
        Q=as_tensor(Q, device, dtype),
        R=as_tensor(R, device, dtype),
        Q_f=as_tensor(Q_f, device, dtype),
    )


def quad_form(v, M):
    """v'Mv over the trailing axis of ``v``."""
    return torch.sum(v[..., :, None] * M * v[..., None, :], dim=(-2, -1))


def quadratic_stage_cost(params, x, u):
    """l(x,u) = 0.5 (dx'Q dx + u'R u) * dt."""
    dx = x - params["x_target"]
    return 0.5 * (quad_form(dx, params["Q"]) + quad_form(u, params["R"])) * params["dt"]


def quadratic_terminal_cost(params, x):
    """l_f(x) = 0.5 dx'Q_f dx (not dt-scaled)."""
    dx = x - params["x_target"]
    return 0.5 * quad_form(dx, params["Q_f"])
