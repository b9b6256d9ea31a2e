"""Neural-augmented dynamics: an MLP residual on any System's f_cont.

PyTorch counterpart of `ilqr_tpu/models/neural.py`.  Grey-box system
identification for the control stack: take an analytic model, add a small
MLP residual to its continuous dynamics,

    ẋ = f_base(θ_base, x, u) + MLP(θ_mlp, [x, u]),

fit θ_mlp to trajectory data by reverse mode through the rollout, and hand
the learned `System` to `solve`, the MPC loops, MPPI or `solve_implicit`.

Layout: ``params = {"base": base.params, "mlp": [{"W", "b"}, ...]}``, the
layers a list of dicts as JAX's are (W is (fan_in, fan_out), applied as
z @ W + b), which `System.tensors()` walks.  JAX threads the base's
callables through ``params`` as `Partial` leaves; a tensor dict cannot hold
callables, so here the base `System` is bound into the three functions by
`functools.partial`, as the rate wrapper binds its base
(`models/rate.py`), and its parameters are read from ``params["base"]``:
`solve_implicit` and ``fit_dynamics(trainable='all')`` differentiate the
base's tensors and the MLP's alike.  The costs are the base's.

The output layer starts at zero, so a freshly wrapped system is bit for
bit its base.  `fit_dynamics` trains with `torch.optim.Adam`, whose update
m̂ / (√v̂ + ε) with ε = 1e-8 is optax.adam's, recording each loss before
its update as JAX's scan does.

The rollout kernels (B2, B5) run a neural residual through its device form
(`csrc/forms.cuh`, NeuralForm; `ops/fused_rollout.py`): the base's register
model plus the MLP under euler, midpoint and rk4 ('discrete' too over an
LTI base), over every base B2 runs under the quadratic costs.  Its caps:
at most 4 hidden tanh layers (`fused_rollout.NEURAL_MAX_HIDDEN`) of at most
64 units (`NEURAL_MAX_WIDTH`), inputs n_x + n_u at most 20 (the rotor-lag
quadrotor's (16, 4), the widest register model).  The implicit rules, a
neural residual over a wrapper or another residual, and wider MLPs raise on
CUDA (ROADMAP item B2x).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

from ilqr_tpu_torch.models.base import System
from ilqr_tpu_torch.ops.integrators import IMPLICIT, newton_polish, step
from ilqr_tpu_torch.utils.tree import leaves_with_path, map_leaves


def _mlp_init(sizes: Sequence[int], generator: torch.Generator | None = None,
              device="cpu", dtype=torch.float32) -> list:
    """Glorot-initialized layers drawn from ``generator`` (on its device);
    the last layer zero, so the residual starts at zero."""
    gen_device = generator.device if generator is not None else "cpu"
    layers = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        if i == len(sizes) - 2:
            W = torch.zeros((fan_in, fan_out), dtype=dtype, device=device)
        else:
            scale = math.sqrt(2.0 / (fan_in + fan_out))
            W = scale * torch.randn((fan_in, fan_out), generator=generator,
                                    dtype=dtype, device=gen_device)
        layers.append(dict(W=W.to(device),
                           b=torch.zeros((fan_out,), dtype=dtype,
                                         device=device)))
    return layers


def _mlp_apply(layers, z):
    for layer in layers[:-1]:
        z = torch.tanh(z @ layer["W"] + layer["b"])
    return z @ layers[-1]["W"] + layers[-1]["b"]


def _inputs(x, u):
    """z = [x, u], the two broadcast over their leading axes."""
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    return torch.cat([x.expand(lead + x.shape[-1:]),
                      u.expand(lead + u.shape[-1:])], dim=-1)


def f_cont(base: System, params, x, u):
    return (base.f_cont(params["base"], x, u)
            + _mlp_apply(params["mlp"], _inputs(x, u)))


def stage_cost(base: System, params, x, u):
    return base.stage_cost(params["base"], x, u)


def terminal_cost(base: System, params, x):
    return base.terminal_cost(params["base"], x)


def make_neural_residual(
    base: System,
    hidden: Sequence[int] = (32, 32),
    generator: torch.Generator | None = None,
) -> System:
    """Wrap ``base`` with an MLP residual on its continuous dynamics.

    The returned system starts bit for bit as ``base`` (zero output layer);
    its layers live at ``system.params['mlp']``.  ``generator`` draws the
    hidden layers' weights (default: a CPU generator seeded with 0); JAX's
    initializer draws from another generator, so comparisons carry JAX's
    weights across (`convert.neural_from_numpy`).
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    sizes = [base.n_x + base.n_u, *hidden, base.n_x]
    params = dict(base=base.params,
                  mlp=_mlp_init(sizes, generator, base.device, base.dtype))
    return System(
        params=params,
        n_x=base.n_x,
        n_u=base.n_u,
        dt=base.dt,
        f_cont=functools.partial(f_cont, base),
        stage_cost=functools.partial(stage_cost, base),
        terminal_cost=functools.partial(terminal_cost, base),
        integrator=base.integrator,
        newton_iters=base.newton_iters,
    )


def _step(system: System, x, u):
    """`step`; under the implicit rules with autograd recording, the
    converged step taken again by `newton_polish` (their
    `autograd.Function` carries forward tangents only; the polish has the
    implicit step's derivatives in x, u and the parameters)."""
    if system.integrator not in IMPLICIT or not torch.is_grad_enabled():
        return step(system, x, u)
    with torch.no_grad():
        x1 = step(system, x, u)
    lead = x.shape[:-1]
    flat = [t.reshape(-1, t.shape[-1]) for t in (x1, x, u)]
    out = torch.func.vmap(lambda a, b, c: newton_polish(system, a, b, c))(
        *flat)
    return out.reshape(lead + out.shape[-1:])


def prediction_loss(system: System, X, U, horizon: int = 1) -> torch.Tensor:
    """Mean squared ``horizon``-step prediction error over all windows.

    X: (..., N+1, n_x), U: (..., N, n_u), leading batch axes allowed.
    ``horizon=1`` is the teacher-forced one-step error; ``horizon=K`` rolls
    the model K steps from every window start s = 0 … N − K and compares
    the segment, as JAX's windows do (`ilqr_tpu/models/neural.py:107-138`):
    the mean over a window's (K, n_x) errors, then over windows, then over
    trajectories.  All windows roll at once, a batch of states.
    """
    X, U = system.inputs(X, U)
    Xf = X.reshape((-1,) + X.shape[-2:])
    Uf = U.reshape((-1,) + U.shape[-2:])
    K = horizon
    Xw = Xf.unfold(1, K + 1, 1).movedim(-1, 2)   # (B, S, K+1, n_x)
    Uw = Uf.unfold(1, K, 1).movedim(-1, 2)       # (B, S, K, n_u)
    x, preds = Xw[:, :, 0], []
    for k in range(K):
        x = _step(system, x, Uw[:, :, k])
        preds.append(x)
    err = (torch.stack(preds, dim=2) - Xw[:, :, 1:]) ** 2
    return err.mean(dim=(-2, -1)).mean(dim=-1).mean()


def fit_dynamics(
    system: System,
    X,
    U,
    steps: int = 500,
    learning_rate: float = 1e-2,
    trainable: str = "mlp",
    horizon: int = 1,
) -> Tuple[System, torch.Tensor]:
    """Fit the system's parameters to trajectory data with Adam.

    ``trainable='mlp'`` updates only the residual's layers (the physics
    prior frozen); ``'all'`` co-adapts every floating parameter tensor,
    the base's too.  ``horizon`` is the prediction window
    (`prediction_loss`).  Returns the fitted system (new tensors; the
    given system is unchanged) and the (steps,) losses, each taken before
    its update.
    """
    if trainable not in ("mlp", "all"):
        raise ValueError(f"trainable must be 'mlp'|'all', got {trainable!r}")
    X, U = system.inputs(X, U)

    def fresh(t):
        return t.detach().clone() if isinstance(t, torch.Tensor) else t

    params = dict(system.params)
    if trainable == "mlp":
        params["mlp"] = map_leaves(fresh, params["mlp"])
        train = params["mlp"]
    else:
        params = map_leaves(fresh, params)
        train = params
    leaves = [t for _, t in leaves_with_path(train)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    fitted = system.replace(params=params)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = prediction_loss(fitted, X, U, horizon=horizon)
        loss.backward()
        losses.append(loss.detach())
        opt.step()
    for t in leaves:
        t.requires_grad_(False)
    out = (torch.stack(losses) if losses
           else torch.zeros((0,), dtype=system.dtype, device=system.device))
    return fitted, out
