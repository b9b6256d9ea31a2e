"""Fused rollouts: the line-search costs, the accepted trajectory and the
open-loop rollout of one instance in CUDA.

PyTorch counterpart of `ilqr_tpu/ops/pallas_rollout.py`
(`linesearch_costs_pallas` / `_ls_cost_kernel` and
`closed_loop_rollout_pallas` / `_traj_kernel`).  The kernels,
`csrc/chain_rollout.cu`, run the closed-loop recursion
u = u_old + α·u_ff + K(x − x_old) for every α at once with the model, the
integrator and the quadratic costs inlined from `csrc/models.cuh`; the
open-loop entry runs u = U_old (the solver's initial rollout under
``rollout='pallas'``).  A producer warp feeds the chain with bulk copies
and places each run at its own 16-byte phase (`csrc/runs.cuh`), so the
kernels take views that start anywhere (a row slice such as
``U_prev[1:]``), as JAX's entries take any array; the wrappers make
strided inputs contiguous.  B5, the batched rollouts of `ops/batched.py`,
are the same kernels with lanes carrying (instance, α) pairs; here each
launch is the batch of one instance.

Dispatch follows the tensor: on the CPU the wrappers run their plain
versions (`rollout.linesearch_rollouts(...)[2]`,
`rollout.closed_loop_rollout` and `rollout.rollout`); on a CUDA tensor they
launch the kernel or raise.  A hand-written kernel cannot trace a model's
Python the way Pallas traces JAX, so the CUDA path covers the models with
a device function under the quadratic costs: the pendulum and the double
pendulum under euler, midpoint, rk4, backward_euler and trapezoidal (the
implicit ones with the system's ``newton_iters``), and the cart-pole, the
planar and 3-D quadrotors, the rotor-lag quadrotor and the car under the
explicit three.  Anything else raises `NotImplementedError` on CUDA: the
new models' implicit rules and the systems without a device function (the
tracking and rate wrappers, which wrap another system's Python, and the
LTI and chain systems, whose matrices have any size) name ROADMAP item
B2m-rest, other costs or integrators item B2m.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch

from ilqr_tpu_torch.models import (
    car,
    cartpole,
    double_pendulum,
    pendulum,
    quadrotor,
    quadrotor3d,
)
from ilqr_tpu_torch.models.base import (
    System,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.rollout import (
    closed_loop_rollout,
    linesearch_rollouts,
    rollout,
)

KERNEL_COSTS = "linesearch_costs"
KERNEL_TRAJECTORY = "closed_loop_rollout"
KERNEL_OPEN_LOOP = "open_loop_rollout"

# f_cont -> model id of the rollout kernels (csrc/chain_rollout.cu, B2 and
# B5), with its device model block.
_Q3 = ("g", "m", "arm", "km", "Jx", "Jy", "Jz")
_MODELS = {
    pendulum.f_cont: (0, ("g", "l", "d")),
    double_pendulum.f_cont: (1, ("m1", "m2", "l1", "l2", "g", "d1", "d2",
                                 "theta1", "theta2", "S")),
    cartpole.f_cont: (2, ("g", "m_cart", "m_pole", "l")),
    quadrotor.f_cont: (3, ("g", "m", "arm", "inertia")),
    quadrotor3d.f_cont: (4, _Q3),
    quadrotor3d.f_cont_rotor: (5, _Q3 + ("rotor_tau",)),
    car.f_cont: (6, ("L",)),
}
# Models with the implicit integrators on the card (B2m); the rest run the
# explicit ones there.
_IMPLICIT_MODELS = (0, 1)
# integrator -> id of csrc/models.cuh's Integrator.
_INTEGRATORS = {"euler": 0, "midpoint": 1, "rk4": 2, "backward_euler": 3,
                "trapezoidal": 4}
_EXPLICIT = ("euler", "midpoint", "rk4")


def device_model(system: System) -> Tuple[int, int]:
    """(model id, integrator id) of the system's device functions."""
    if system.f_cont not in _MODELS:
        raise NotImplementedError(
            "the CUDA rollout kernels have device functions for the "
            "pendulum, double pendulum, cart-pole, planar and 3-D quadrotors "
            "and car; this system (a tracking or rate wrapper, an LTI or "
            "chain system, or another model) has none: ROADMAP item "
            "B2m-rest")
    if (system.stage_cost is not quadratic_stage_cost
            or system.terminal_cost is not quadratic_terminal_cost):
        raise NotImplementedError(
            "the CUDA rollout kernels take the quadratic costs only: "
            "ROADMAP item B2m")
    model = _MODELS[system.f_cont][0]
    if system.integrator not in _INTEGRATORS:
        raise NotImplementedError(
            f"the CUDA rollout kernels run {', '.join(_INTEGRATORS)}, not "
            f"{system.integrator!r}: ROADMAP item B2m")
    if model not in _IMPLICIT_MODELS and system.integrator not in _EXPLICIT:
        raise NotImplementedError(
            f"the CUDA rollout kernels run this model under "
            f"{', '.join(_EXPLICIT)}, not {system.integrator!r}: ROADMAP "
            f"item B2m-rest")
    return model, _INTEGRATORS[system.integrator]


def params_buffer(system: System) -> torch.Tensor:
    """The flat float32 parameter buffer that `csrc/models.cuh` reads:

        [dt, x_target (n_x), Q (n_x²), R (n_u²), Q_f (n_x²), model block]

    matrices row-major; each model's block is its parameters in the order
    `_MODELS` names them (the pendulum's [g, l, d], the double pendulum's
    [m1, m2, l1, l2, g, d1, d2, theta1, theta2, S (2 × n_u)], ...).
    """
    p = system.params
    names = ("dt", "x_target", "Q", "R", "Q_f") + _MODELS[system.f_cont][1]
    return torch.cat([p[n].reshape(-1) for n in names]).to(torch.float32)


# Parameter buffers already built, keyed by the identity and version counter
# of the tensors each was built from.  An entry holds those tensors, so no
# other tensor takes their ids while it lives, and an in-place change of a
# parameter bumps its version: a launch reuses the buffer of unchanged
# parameters instead of concatenating them on the device again.
_PARAMS: "OrderedDict[tuple, Tuple[tuple, torch.Tensor]]" = OrderedDict()
_PARAMS_KEPT = 64


def _params_on(system: System, device) -> torch.Tensor:
    """`params_buffer(system)` on ``device``, built once per set of
    parameter tensors (the least recently used of `_PARAMS_KEPT` buffers
    goes first)."""
    tensors = tuple(system.params.values())
    try:
        key = (_MODELS[system.f_cont][0],) + tuple(
            (id(t), t._version) for t in tensors)
    except RuntimeError:   # inference tensors keep no version counter
        key = None
    hit = _PARAMS.get(key) if key is not None else None
    if hit is not None:
        _PARAMS.move_to_end(key)
        params = hit[1]
    else:
        params = params_buffer(system)
        if key is not None:
            _PARAMS[key] = (tensors, params)
            if len(_PARAMS) > _PARAMS_KEPT:
                _PARAMS.popitem(last=False)
    if params.device != device:
        raise ValueError(f"the system's parameters are on {params.device}, "
                         f"the trajectory on {device}")
    return params


def _check(system, x0, X_old, U_old, u_ff, K) -> int:
    """N, after checking what the B = 1 kernels take: float32, contiguous
    tensors of the expected shapes on x0's device, at any offset.  The
    open-loop rollout passes None for X_old, u_ff and K."""
    N = U_old.shape[0]
    n_x, n_u = system.n_x, system.n_u
    shapes = dict(x0=(n_x,), X_old=(N + 1, n_x), U_old=(N, n_u),
                  u_ff=(N, n_u), K=(N, n_u, n_x))
    for name, t in zip(shapes, (x0, X_old, U_old, u_ff, K)):
        if t is None:
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA rollouts take float32, {name} is {t.dtype}")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return N


def kernel_inputs(system, x0, X_old, U_old, u_ff, K):
    """What the B = 1 kernels are handed: each of X_old, U_old, u_ff and K
    as it is when it is contiguous, at whatever offset it starts (a row
    view such as ``U_prev[1:]`` is not copied), else a contiguous copy;
    then `_check`.  The open-loop rollout passes None for X_old, u_ff and
    K."""
    X_old, U_old, u_ff, K = (None if t is None else t.contiguous()
                             for t in (X_old, U_old, u_ff, K))
    _check(system, x0, X_old, U_old, u_ff, K)
    return X_old, U_old, u_ff, K


def chunk_steps(lib) -> int:
    """Steps per stage of the chain kernels' shared-memory ring."""
    return lib.ilqr_chain_chunk_steps()


def ring_stages(lib) -> int:
    """Stages in the chain kernels' ring."""
    return lib.ilqr_chain_ring_stages()


def launch_costs(lib, system, x0, alphas, X_old, U_old, u_ff, K, stream):
    """Candidate costs (A,); inputs must already have passed `_check`."""
    model, integ = device_model(system)
    N = U_old.shape[0]
    params = _params_on(system, x0.device)
    costs = torch.empty(alphas.shape, dtype=torch.float32, device=x0.device)
    code = lib.ilqr_linesearch_costs(
        model, integ, system.newton_iters, system.n_x, system.n_u,
        params.data_ptr(),
        params.numel(), x0.data_ptr(), alphas.data_ptr(), alphas.numel(),
        X_old.data_ptr(), U_old.data_ptr(), u_ff.data_ptr(), K.data_ptr(), N,
        costs.data_ptr(), stream)
    _build.check(lib, code, "line-search costs kernel")
    return costs


def launch_trajectory(lib, system, x0, alpha: float, X_old, U_old, u_ff, K,
                      stream):
    """(X, U, cost) of one α; inputs must already have passed `_check`."""
    model, integ = device_model(system)
    N = U_old.shape[0]
    params = _params_on(system, x0.device)
    opts = dict(dtype=torch.float32, device=x0.device)
    X = torch.empty((N + 1, system.n_x), **opts)
    U = torch.empty((N, system.n_u), **opts)
    cost = torch.empty((1,), **opts)
    code = lib.ilqr_closed_loop_rollout(
        model, integ, system.newton_iters, system.n_x, system.n_u,
        params.data_ptr(),
        params.numel(), x0.data_ptr(), alpha, X_old.data_ptr(),
        U_old.data_ptr(), u_ff.data_ptr(), K.data_ptr(), N, cost.data_ptr(),
        X.data_ptr(), U.data_ptr(), stream)
    _build.check(lib, code, "closed-loop rollout kernel")
    return X, U, cost[0]


def launch_open_loop(lib, system, x0, U, stream):
    """(X, cost) of U from x0; inputs must already have passed `_check`."""
    model, integ = device_model(system)
    N = U.shape[0]
    params = _params_on(system, x0.device)
    opts = dict(dtype=torch.float32, device=x0.device)
    X = torch.empty((N + 1, system.n_x), **opts)
    cost = torch.empty((1,), **opts)
    code = lib.ilqr_open_loop_rollout(
        model, integ, system.newton_iters, system.n_x, system.n_u,
        params.data_ptr(),
        params.numel(), x0.data_ptr(), U.data_ptr(), N, cost.data_ptr(),
        X.data_ptr(), stream)
    _build.check(lib, code, "open-loop rollout kernel")
    return X, cost[0]


def linesearch_costs_fused(system: System, x0, alphas, X_old, U_old, u_ff, K):
    """Cost of the closed-loop rollout of every α in ``alphas`` (A,)."""
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    if x0.device.type == "cpu":
        return linesearch_rollouts(system, x0, alphas, X_old, U_old, u_ff,
                                   K)[2]
    if x0.device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {x0.device}")
    X_old, U_old, u_ff, K = kernel_inputs(system, x0, X_old, U_old, u_ff, K)
    with _build.on_device(x0.device):
        lib = _build.load().lib
        costs = launch_costs(lib, system, x0, alphas.contiguous(), X_old,
                             U_old, u_ff, K,
                             _build.current_stream(x0.device))
    _build.count_launch(KERNEL_COSTS)
    return costs


def closed_loop_rollout_fused(system: System, x0, alpha: float, X_old, U_old,
                              u_ff, K):
    """The closed-loop rollout of one α: (X (N+1, n_x), U (N, n_u), cost)."""
    if x0.device.type == "cpu":
        return closed_loop_rollout(system, x0, alpha, X_old, U_old, u_ff, K)
    if x0.device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {x0.device}")
    X_old, U_old, u_ff, K = kernel_inputs(system, x0, X_old, U_old, u_ff, K)
    with _build.on_device(x0.device):
        lib = _build.load().lib
        out = launch_trajectory(
            lib, system, x0, float(alpha), X_old, U_old, u_ff, K,
            _build.current_stream(x0.device))
    _build.count_launch(KERNEL_TRAJECTORY)
    return out


def open_loop_rollout_fused(system: System, x0, U):
    """`rollout.rollout` of one instance: x0 (n_x,), U (N, n_u).  Returns
    (X (N+1, n_x), cost)."""
    if x0.device.type == "cpu":
        return rollout(system, x0, U)
    if x0.device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {x0.device}")
    U = kernel_inputs(system, x0, None, U, None, None)[1]
    with _build.on_device(x0.device):
        lib = _build.load().lib
        out = launch_open_loop(
            lib, system, x0, U, _build.current_stream(x0.device))
    _build.count_launch(KERNEL_OPEN_LOOP)
    return out
