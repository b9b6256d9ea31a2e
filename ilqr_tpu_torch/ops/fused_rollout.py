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
Python the way Pallas traces JAX, so each system the kernels run has a
device form (`csrc/models.cuh`, `csrc/forms.cuh`), picked by its functions
(`device_model`):

* the register models under the quadratic costs: the pendulum and the
  double pendulum under euler, midpoint, rk4, backward_euler and
  trapezoidal; the cart-pole, the planar and 3-D quadrotors, the rotor-lag
  quadrotor and the car under the same five (the implicit rules with the
  system's ``newton_iters``); the LTI systems (`models/linear.py`) at
  (n_x, n_u) in `LTI_SHAPES` under the explicit three and 'discrete';
* the tracking wrapper (`models/tracking.py`) over each of those bases
  whose tracked state has at most 16 entries (all but the rotor variant
  and the LTI (16, 4)), and the rate wrapper (`models/rate.py`) over each
  base with n_x + n_u at most 16 (all but the rotor variant and the LTI
  (16, 4)), the base under the explicit three ('discrete' too for LTI
  bases);
* the spring chain (`models/chain.py`) at 16 masses and 16 controls
  (n_x = 32) under the explicit three;
* the neural residual (`models/neural.py`) over each register model and
  LTI shape above under the quadratic costs, its MLP of at most
  `NEURAL_MAX_HIDDEN` tanh hidden layers of at most `NEURAL_MAX_WIDTH`
  units, under the explicit three ('discrete' too over LTI bases).

Anything else (physical models under 'discrete', wrappers or neural
residuals over implicit rules, over other wrappers or residuals, wider
MLPs, other costs, shapes or integrators) raises `NotImplementedError` on
CUDA, naming ROADMAP item B2x.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Tuple

import torch

from ilqr_tpu_torch.models import (
    car,
    cartpole,
    chain,
    double_pendulum,
    linear,
    neural,
    pendulum,
    quadrotor,
    quadrotor3d,
    rate,
    tracking,
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

# f_cont -> model id of the rollout kernels (csrc/chain_kernel.cuh's
# ModelId, B2 and B5), with its device model block.
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
    linear.lti_f_cont: (7, ("A", "B")),
}
LTI = 7
# The spring chain, and the wrappers' offsets (plus the base's id).
SPRING_CHAIN = 8
TRACKING = 16
RATE = 32
NEURAL = 64
# The (n_x, n_u) of the LTI instantiations, and the spring chain's.
LTI_SHAPES = ((2, 1), (4, 1), (4, 2), (6, 2), (12, 4), (16, 4))
CHAIN_SHAPE = (32, 16)
# The largest state a wrapper's instantiation holds.
MAX_WRAPPED = 16
# The caps of the neural residual's MLP in its device form (csrc/forms.cuh,
# kNeuralMaxHidden, kNeuralMaxWidth): hidden tanh layers and their units.
NEURAL_MAX_HIDDEN = 4
NEURAL_MAX_WIDTH = 64
# integrator -> id of csrc/models.cuh's Integrator.
_INTEGRATORS = {"euler": 0, "midpoint": 1, "rk4": 2, "backward_euler": 3,
                "trapezoidal": 4, "discrete": 5}
_EXPLICIT = ("euler", "midpoint", "rk4")
# The chain's parameters in its buffer's order (csrc/forms.cuh, ChainForm).
_CHAIN_PARAMS = ("dt", "k", "c", "s", "wq", "wv", "wu", "wqf", "wvf",
                 "q_target", "S")


def _refuse(what: str):
    raise NotImplementedError(
        f"the CUDA rollout kernels have no device form for {what}: ROADMAP "
        f"item B2x")


def _register_model(f_cont, n_x: int, n_u: int, integrator: str,
                    wrapped: int | None = None) -> int:
    """The model id of a register model (`_MODELS`) at (n_x, n_u) under
    ``integrator``, after checking that an instantiation takes it;
    ``wrapped``: the n_x of a wrapper around it, which must not exceed
    `MAX_WRAPPED`."""
    if f_cont not in _MODELS:
        _refuse("this system (a nested wrapper, the spring chain inside a "
                "wrapper, or another model)" if wrapped is not None
                else "this model")
    model = _MODELS[f_cont][0]
    if model == LTI:
        if (n_x, n_u) not in LTI_SHAPES:
            _refuse(f"an LTI system at (n_x, n_u) = {(n_x, n_u)} "
                    f"(instantiated at {LTI_SHAPES})")
        if integrator not in _EXPLICIT + ("discrete",):
            _refuse(f"an LTI system under {integrator!r}")
    elif integrator == "discrete":
        _refuse("a physical model under 'discrete' (its f_cont as the map)")
    elif integrator not in _INTEGRATORS:
        _refuse(f"the integrator {integrator!r}")
    if wrapped is not None:
        if wrapped > MAX_WRAPPED:
            _refuse(f"a wrapper whose state has {wrapped} entries (at most "
                    f"{MAX_WRAPPED})")
        if integrator not in _EXPLICIT + ("discrete",):
            _refuse(f"a wrapper over {integrator!r}")
    return model


def _quadratic(system: System) -> bool:
    return (system.stage_cost is quadratic_stage_cost
            and system.terminal_cost is quadratic_terminal_cost)


def _wrapper(system: System):
    """('tracking' | 'rate' | 'neural', base) of a wrapped system, else
    None: the tracking wrapper's base is its f_cont's bound function, the
    rate wrapper's and the neural residual's the System bound into their
    functions."""
    f = system.f_cont
    if not isinstance(f, functools.partial):
        return None
    if f.func in (tracking._f_cont, tracking._f_discrete):
        return "tracking", f.args[0]
    if f.func is rate._f_disc:
        return "rate", f.args[0]
    if f.func is neural.f_cont:
        return "neural", f.args[0]
    return None


def mlp_widths(layers) -> list:
    """[w_0, w_1, ..., w_L] of a neural residual's layers: its inputs, the
    hidden widths, its outputs."""
    return [layers[0]["W"].shape[0]] + [layer["W"].shape[1]
                                        for layer in layers]


def _neural_model(system: System, base: System) -> int:
    """The model id of a neural residual's device form, after checking
    that an instantiation takes it."""
    if base.f_cont not in _MODELS:
        _refuse("a neural residual over a wrapper, another neural residual "
                "or a model without a register form")
    costs = (system.stage_cost, system.terminal_cost)
    if not (all(isinstance(c, functools.partial) for c in costs)
            and costs[0].func is neural.stage_cost
            and costs[1].func is neural.terminal_cost
            and _quadratic(base)):
        _refuse("a neural residual with other costs than its base's "
                "quadratic ones")
    if system.integrator not in _EXPLICIT + ("discrete",):
        _refuse(f"a neural residual under {system.integrator!r}")
    hidden = mlp_widths(system.params["mlp"])[1:-1]
    if (len(hidden) > NEURAL_MAX_HIDDEN
            or any(w > NEURAL_MAX_WIDTH for w in hidden)):
        _refuse(f"a neural residual with hidden widths {hidden} (at most "
                f"{NEURAL_MAX_HIDDEN} layers of at most {NEURAL_MAX_WIDTH})")
    return NEURAL + _register_model(base.f_cont, system.n_x, system.n_u,
                                    system.integrator)


def device_model(system: System) -> Tuple[int, int]:
    """(model id, integrator id) of the system's device form; for the rate
    wrapper the integrator is the base's (the wrapper's map is
    'discrete').  Raises `NotImplementedError` for what no instantiation
    takes."""
    wrapped = _wrapper(system)
    if wrapped is not None and wrapped[0] == "neural":
        return (_neural_model(system, wrapped[1]),
                _INTEGRATORS[system.integrator])
    if wrapped is not None and wrapped[0] == "tracking":
        if (system.stage_cost is not tracking.stage_cost
                or system.terminal_cost is not tracking.terminal_cost):
            _refuse("a tracking system with other costs")
        base_id = _register_model(wrapped[1], system.n_x - 1, system.n_u,
                                  system.integrator, wrapped=system.n_x)
        return TRACKING + base_id, _INTEGRATORS[system.integrator]
    if wrapped is not None:
        base = wrapped[1]
        costs = (system.stage_cost, system.terminal_cost)
        if not (all(isinstance(c, functools.partial) for c in costs)
                and costs[0].func is rate._stage_cost
                and costs[1].func is rate._terminal_cost
                and _quadratic(base)):
            _refuse("a rate system with other costs")
        base_id = _register_model(base.f_cont, base.n_x, base.n_u,
                                  base.integrator, wrapped=system.n_x)
        return RATE + base_id, _INTEGRATORS[base.integrator]
    if system.f_cont is chain._f_cont:
        if (system.stage_cost is not chain._stage_cost
                or system.terminal_cost is not chain._terminal_cost):
            _refuse("a spring chain with other costs")
        if (system.n_x, system.n_u) != CHAIN_SHAPE:
            _refuse(f"the spring chain at (n_x, n_u) = "
                    f"{(system.n_x, system.n_u)} (instantiated at "
                    f"{CHAIN_SHAPE})")
        if system.integrator not in _EXPLICIT:
            _refuse(f"the spring chain under {system.integrator!r}")
        return SPRING_CHAIN, _INTEGRATORS[system.integrator]
    if system.f_cont in _MODELS and not _quadratic(system):
        _refuse("a model with other costs than the quadratic ones")
    model = _register_model(system.f_cont, system.n_x, system.n_u,
                            system.integrator)
    return model, _INTEGRATORS[system.integrator]


def _flat(*tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors]).to(torch.float32)


def _quadratic_buffer(params: dict, f_cont) -> torch.Tensor:
    names = ("dt", "x_target", "Q", "R", "Q_f") + _MODELS[f_cont][1]
    return _flat(*(params[n] for n in names))


def params_buffer(system: System) -> torch.Tensor:
    """The flat float32 parameter buffer that the system's device form
    reads (`csrc/models.cuh`, `csrc/forms.cuh`), matrices row-major:

    * a register model: [dt, x_target (n_x), Q (n_x²), R (n_u²), Q_f (n_x²),
      model block], each model's block its parameters in the order `_MODELS`
      names them (the pendulum's [g, l, d], the double pendulum's [m1, m2,
      l1, l2, g, d1, d2, theta1, theta2, S (2 × n_u)], LTI's [A, B], ...);
    * the tracking wrapper: [dt, rows of X_ref, rows of U_ref, Q, R, Q_f,
      the base's model block, X_ref, U_ref];
    * the rate wrapper: the base's buffer, then S (n_u²);
    * the spring chain: [dt, k, c, s, wq, wv, wu, wqf, wvf, q_target, S];
    * the neural residual: the base's buffer, then [L (the layer count,
      the output layer's included), the widths w_0 = n_x + n_u, w_1, ...,
      w_L = n_x, then W_0 (w_0 × w_1), b_0 (w_1), W_1, b_1, ... of each
      layer in turn], W as JAX's layers hold it (z @ W + b), the counts as
      floats.
    """
    model = device_model(system)[0]
    p = system.params
    if model >= NEURAL:
        base = _wrapper(system)[1]
        layers = p["mlp"]
        head = torch.tensor([len(layers)] + mlp_widths(layers),
                            dtype=torch.float32, device=p["base"]["dt"].device)
        return torch.cat([
            _quadratic_buffer(p["base"], base.f_cont), head,
            _flat(*(t for layer in layers for t in (layer["W"], layer["b"])))])
    if model >= RATE:
        base = _wrapper(system)[1]
        return torch.cat([_quadratic_buffer(p["base"], base.f_cont),
                          _flat(p["S"])])
    if model >= TRACKING:
        base_f = _wrapper(system)[1]
        n_rows = (p["X_ref"].shape[0], p["U_ref"].shape[0])
        if not all(1 <= n < 2 ** 24 for n in n_rows):
            raise ValueError("the tracking kernels take 1 to 2^24 - 1 "
                             "reference rows")
        rows = torch.tensor(n_rows, dtype=torch.float32,
                            device=p["dt"].device)
        block = (p["base"][n] for n in _MODELS[base_f][1])
        return _flat(p["dt"], rows, p["Q"], p["R"], p["Q_f"], *block,
                     p["X_ref"], p["U_ref"])
    if model == SPRING_CHAIN:
        return _flat(*(p[n] for n in _CHAIN_PARAMS))
    return _quadratic_buffer(p, system.f_cont)


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
    tensors = tuple(system.tensors())
    try:
        key = (device_model(system)[0],) + tuple(
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
