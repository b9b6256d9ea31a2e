"""Batched kernels: the backward pass and the rollouts of B instances at once.

PyTorch counterpart of `ilqr_tpu/ops/pallas_batched.py`.  Two CUDA kernels
serve batched solving and batched MPC (`solver.solve_batch`):

* B4, `csrc/batched_riccati.cu`: the sequential Riccati recursion of
  `ops/riccati.py::backward_pass` for every instance, a lane group each,
  with the finite flag formed in the kernel (`backward_pass_batched`);
* B5, the batched entries of `csrc/chain_rollout.cu`: B2's chain kernels
  with lanes carrying (instance, α) pairs — the candidate costs of a shared
  α schedule (`linesearch_costs_batched`), the trajectory at a
  per-instance α (`closed_loop_rollout_batched`) and the open-loop rollout
  (`open_loop_rollout_batched`).

Dispatch follows the tensor, as in `ops/fused_rollout.py`: on the CPU each
wrapper runs its plain version — the single-instance function with a
leading batch axis (`torch.func.vmap` of `riccati.backward_pass`, so its
small solves run on (B, n_u, n_u); `rollout.linesearch_rollouts`
and `rollout.rollout`, whose host loop over time carries (B, A, n_x)
states) — and on a CUDA tensor it launches the kernel or raises.  B4 takes
float32 at every n_x, n_u <= 16: its register form at the (n_x, n_u)
of `fused_riccati.SHAPES`, its wide form (a warp an instance,
`csrc/group_linalg.cuh`) elsewhere.
Outside those, the backward pass follows JAX's batched rule
(`pallas_batched.py:277-297`): engine 'auto' or 'scan' runs the plain
version on the tensors' own device (f64, and the chain's n_x = 32), and
'pallas' raises.  The rollouts take every system with a device form
(`fused_rollout.device_model`: the register models under the explicit
integrators, the LTI systems, the tracking and rate wrappers and the
spring chain under the explicit integrators and, where JAX's `_kernel_ok`
takes it, 'discrete'), and beyond JAX's set the pendulum and the double
pendulum under the implicit rules with the system's ``newton_iters``
(`batched_model`); anything else raises on CUDA (ROADMAP item B2x).  The kernels
read instance rows at any 4-byte alignment.  JAX swaps its kernels in
under `jax.vmap(solve)` by `custom_vmap` rules; the port calls them from
its explicitly batched solve.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.fused_rollout import _params_on, device_model
from ilqr_tpu_torch.ops.integrators import IMPLICIT
from ilqr_tpu_torch.ops.linearize import TrajectoryExpansion
from ilqr_tpu_torch.ops.riccati import backward_pass
from ilqr_tpu_torch.ops.rollout import linesearch_rollouts, rollout

KERNEL_RICCATI = "batched_riccati"
KERNEL_COSTS = "linesearch_costs_batched"
KERNEL_TRAJECTORY = "closed_loop_rollout_batched"
KERNEL_OPEN_LOOP = "open_loop_rollout_batched"
# The largest n_x and n_u of B4's wide form (JAX's kernel takes the same).
MAX_WIDTH = 16
ENGINES = ("auto", "scan", "pallas")
_FIELDS = ("f_x", "f_u", "l_x", "l_u", "l_xx", "l_ux", "l_uu", "v_x", "v_xx")


def _reg_vector(reg, B: int, like: torch.Tensor):
    """``reg`` as B4 takes it: a float when it is one number, else a (B,)
    tensor of ``like``'s kind."""
    if isinstance(reg, (int, float)):
        return float(reg)
    reg = torch.as_tensor(reg, dtype=like.dtype, device=like.device)
    if reg.ndim == 0:
        return float(reg)
    if tuple(reg.shape) != (B,):
        raise ValueError(f"reg must be a number or of shape ({B},), "
                         f"got {tuple(reg.shape)}")
    return reg.contiguous()


def vmap_backward(backward, exp: TrajectoryExpansion, reg, **batched):
    """A single-instance backward pass over the leading batch axis of every
    field of ``exp``; ``reg`` is a number or (B,).  ``batched`` holds more
    per-instance inputs (tensors or NamedTuples of them leading with B,
    such as the controls of a limited pass or DDP Hessians, or None),
    which reach ``backward(exp, reg, **batched)`` one instance at a time.
    Returns (u_ff (B, N, n_u), K (B, N, n_u, n_x), dV (B, 2), ok (B,))."""
    reg = torch.as_tensor(reg, dtype=exp.f_x.dtype, device=exp.f_x.device)
    fields = tuple(getattr(exp, f) for f in _FIELDS)
    batched = {k: v for k, v in batched.items() if v is not None}
    out = torch.func.vmap(
        lambda fs, r, kw: backward(TrajectoryExpansion(*fs), r, **kw),
        in_dims=(0, 0 if reg.ndim else None, 0))(fields, reg, batched)
    # Contiguous, as the batched CUDA rollouts read the gains as they are.
    return tuple(t.contiguous() for t in out)


def _check_expansion(exp: TrajectoryExpansion) -> None:
    B, N, n_x = exp.f_x.shape[:3]
    n_u = exp.l_u.shape[-1]
    shapes = dict(f_x=(B, N, n_x, n_x), f_u=(B, N, n_x, n_u),
                  l_x=(B, N, n_x), l_u=(B, N, n_u), l_xx=(B, N, n_x, n_x),
                  l_ux=(B, N, n_u, n_x), l_uu=(B, N, n_u, n_u),
                  v_x=(B, n_x), v_xx=(B, n_x, n_x))
    if B < 1 or N < 1:
        raise ValueError("the batched CUDA backward pass needs B >= 1, N >= 1")
    for name in _FIELDS:
        t = getattr(exp, name)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the batched CUDA backward pass takes float32, "
                            f"{name} is {t.dtype}")
        if t.device != exp.f_x.device:
            raise ValueError(f"{name} is on {t.device}, f_x on {exp.f_x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_riccati(lib, exp: TrajectoryExpansion, reg, stream):
    """Run B4 on ``stream``; inputs must already have passed
    `_check_expansion`, ``reg`` is a float or (B,) float32 on the same
    device (`_reg_vector`)."""
    B, N, n_x = exp.f_x.shape[:3]
    n_u = exp.l_u.shape[-1]
    opts = dict(dtype=torch.float32, device=exp.f_x.device)
    u_ff = torch.empty((B, N, n_u), **opts)
    K = torch.empty((B, N, n_u, n_x), **opts)
    dV = torch.empty((B, 2), **opts)
    ok = torch.empty((B,), dtype=torch.bool, device=exp.f_x.device)
    code = lib.ilqr_batched_riccati(
        n_x, n_u, B, N, *((reg, None) if isinstance(reg, float)
                          else (0.0, reg.data_ptr())),
        *(getattr(exp, f).data_ptr() for f in _FIELDS), u_ff.data_ptr(),
        K.data_ptr(), dV.data_ptr(), ok.data_ptr(), stream)
    _build.check(lib, code, "batched Riccati kernel")
    return u_ff, K, dV, ok


def kernel_takes(exp: TrajectoryExpansion) -> bool:
    """Whether B4 takes this expansion's shape and dtype: float32 with
    n_x and n_u at most `MAX_WIDTH`."""
    n_x, n_u = exp.f_x.shape[-1], exp.l_u.shape[-1]
    return (exp.f_x.dtype == torch.float32
            and 1 <= n_x <= MAX_WIDTH and 1 <= n_u <= MAX_WIDTH)


@full_f32_matmuls()
def backward_pass_batched(
    exp: TrajectoryExpansion, reg=0.0, engine: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sequential backward pass of B instances: ``exp`` fields lead
    with B, ``reg`` is a number or (B,).  Returns (u_ff (B, N, n_u),
    K (B, N, n_u, n_x), dV (B, 2), ok (B,)) — `riccati.backward_pass` per
    instance.  ``engine`` 'auto' and 'scan' run the plain version where
    B4 does not take the shape or dtype (`kernel_takes`), 'pallas' raises
    there."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto'|'scan'|'pallas', "
                         f"got {engine!r}")
    device = exp.f_x.device
    if device.type == "cpu":
        return vmap_backward(backward_pass, exp, reg)
    if not kernel_takes(exp):
        if engine == "pallas":
            n_x, n_u = exp.f_x.shape[-1], exp.l_u.shape[-1]
            raise NotImplementedError(
                f"the batched CUDA backward pass takes float32 with n_x, "
                f"n_u <= {MAX_WIDTH}, got {(n_x, n_u)} in {exp.f_x.dtype}")
        return vmap_backward(backward_pass, exp, reg)
    if device.type != "cuda":
        raise ValueError(f"no batched backward pass kernel for device {device}")
    _check_expansion(exp)
    reg_b = _reg_vector(reg, exp.f_x.shape[0], exp.f_x)
    with _build.on_device(device):
        lib = _build.load().lib
        out = launch_riccati(lib, exp, reg_b,
                             _build.current_stream(device))
    _build.count_launch(KERNEL_RICCATI)
    return out


def _check_rollout(system: System, x0s, U_old, X_old=None, u_ff=None,
                   K=None) -> Tuple[int, int]:
    """(B, N) of a batched rollout's inputs; raises on what B5 does not
    take.  X_old, u_ff and K are absent for the open-loop rollout."""
    if U_old.ndim != 3:
        raise ValueError(f"U has shape {tuple(U_old.shape)}, expected "
                         f"(B, N, {system.n_u})")
    B, N = U_old.shape[:2]
    n_x, n_u = system.n_x, system.n_u
    if B < 1:
        raise ValueError("the batched CUDA rollouts need B >= 1")
    shapes = dict(x0s=(B, n_x), U=(B, N, n_u), X_old=(B, N + 1, n_x),
                  u_ff=(B, N, n_u), K=(B, N, n_u, n_x))
    given = dict(x0s=x0s, U=U_old, X_old=X_old, u_ff=u_ff, K=K)
    for name, t in given.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the batched CUDA rollouts take float32, "
                            f"{name} is {t.dtype}")
        if t.device != x0s.device:
            raise ValueError(f"{name} is on {t.device}, x0s on {x0s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, N


# The models whose implicit rules B5 runs: the pendulum and the double
# pendulum (JAX's batched kernel runs no implicit rule).
_IMPLICIT_MODELS = (0, 1)


def batched_model(system: System) -> Tuple[int, int]:
    """`device_model` of a system B5 takes; raises `NotImplementedError`
    for the implicit rules of the other models, which run through B2
    only."""
    model, integ = device_model(system)
    if system.integrator in IMPLICIT and model not in _IMPLICIT_MODELS:
        raise NotImplementedError(
            f"the batched CUDA rollouts run {system.integrator!r} on the "
            f"pendulum and the double pendulum only (JAX's batched kernel "
            f"on none): ROADMAP item B2x")
    return model, integ


def launch_costs(lib, system, x0s, alphas, X_old, U_old, u_ff, K, stream):
    """Candidate costs (B, A); inputs must already have passed
    `_check_rollout`, ``alphas`` is (A,) float32 and contiguous."""
    model, integ = batched_model(system)
    B, N = U_old.shape[:2]
    params = _params_on(system, x0s.device)
    costs = torch.empty((B, alphas.numel()), dtype=torch.float32,
                        device=x0s.device)
    code = lib.ilqr_linesearch_costs_batched(
        model, integ, system.newton_iters, system.n_x, system.n_u,
        params.data_ptr(),
        params.numel(), B, x0s.data_ptr(), alphas.data_ptr(), alphas.numel(),
        X_old.data_ptr(), U_old.data_ptr(), u_ff.data_ptr(), K.data_ptr(), N,
        costs.data_ptr(), stream)
    _build.check(lib, code, "batched line-search costs kernel")
    return costs


def launch_trajectory(lib, system, x0s, alpha_b, X_old, U_old, u_ff, K,
                      stream):
    """(X, U, cost) at one α per instance, or (X, None, cost), the
    open-loop rollout of U_old, when X_old, u_ff and K are None; inputs
    must already have passed `_check_rollout`, ``alpha_b`` is (B,) float32
    (ignored open loop)."""
    model, integ = batched_model(system)
    B, N = U_old.shape[:2]
    params = _params_on(system, x0s.device)
    opts = dict(dtype=torch.float32, device=x0s.device)
    X = torch.empty((B, N + 1, system.n_x), **opts)
    cost = torch.empty((B,), **opts)
    head = (model, integ, system.newton_iters, system.n_x, system.n_u,
            params.data_ptr(), params.numel(), B, x0s.data_ptr())
    if u_ff is None:
        code = lib.ilqr_open_loop_rollout_batched(
            *head, U_old.data_ptr(), N, cost.data_ptr(), X.data_ptr(),
            stream)
        _build.check(lib, code, "batched open-loop rollout kernel")
        return X, None, cost
    U = torch.empty((B, N, system.n_u), **opts)
    code = lib.ilqr_closed_loop_rollout_batched(
        *head, alpha_b.data_ptr(), X_old.data_ptr(), U_old.data_ptr(),
        u_ff.data_ptr(), K.data_ptr(), N, cost.data_ptr(), X.data_ptr(),
        U.data_ptr(), stream)
    _build.check(lib, code, "batched closed-loop rollout kernel")
    return X, U, cost


def _cuda(x0s, what: str):
    if x0s.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x0s.device}")
    return _build.current_stream(x0s.device)


def linesearch_costs_batched(system: System, x0s, alphas, X_old, U_old,
                             u_ff, K) -> torch.Tensor:
    """Cost of every (instance, α): x0s (B, n_x), alphas (A,) shared,
    X_old (B, N+1, n_x), U_old and u_ff (B, N, n_u), K (B, N, n_u, n_x).
    Returns (B, A)."""
    alphas = torch.as_tensor(alphas, dtype=x0s.dtype, device=x0s.device)
    if x0s.device.type == "cpu":
        return linesearch_rollouts(system, x0s, alphas, X_old, U_old, u_ff,
                                   K)[2]
    stream = _cuda(x0s, "batched rollout")
    _check_rollout(system, x0s, U_old, X_old, u_ff, K)
    with _build.on_device(x0s.device):
        lib = _build.load().lib
        costs = launch_costs(lib, system, x0s, alphas.contiguous(), X_old,
                             U_old, u_ff, K, stream)
    _build.count_launch(KERNEL_COSTS)
    return costs


def closed_loop_rollout_batched(system: System, x0s, alpha_b, X_old, U_old,
                                u_ff, K):
    """The closed-loop rollout of every instance at its own α, alpha_b
    (B,).  Returns (X (B, N+1, n_x), U (B, N, n_u), cost (B,))."""
    alpha_b = torch.as_tensor(alpha_b, dtype=x0s.dtype, device=x0s.device)
    if x0s.device.type == "cpu":
        X, U, cost = linesearch_rollouts(system, x0s, alpha_b[:, None],
                                         X_old, U_old, u_ff, K)
        return X[:, 0], U[:, 0], cost[:, 0]
    stream = _cuda(x0s, "batched rollout")
    B, _ = _check_rollout(system, x0s, U_old, X_old, u_ff, K)
    if tuple(alpha_b.shape) != (B,):
        raise ValueError(f"alpha_b has shape {tuple(alpha_b.shape)}, "
                         f"expected ({B},)")
    with _build.on_device(x0s.device):
        lib = _build.load().lib
        out = launch_trajectory(lib, system, x0s, alpha_b.contiguous(), X_old,
                                U_old, u_ff, K, stream)
    _build.count_launch(KERNEL_TRAJECTORY)
    return out


def open_loop_rollout_batched(system: System, x0s, U):
    """`rollout.rollout` of B instances: x0s (B, n_x), U (B, N, n_u).
    Returns (X (B, N+1, n_x), cost (B,))."""
    if x0s.device.type == "cpu":
        return rollout(system, x0s, U)
    stream = _cuda(x0s, "batched rollout")
    _check_rollout(system, x0s, U)
    with _build.on_device(x0s.device):
        lib = _build.load().lib
        X, _, cost = launch_trajectory(lib, system, x0s, None, None, U, None,
                                       None, stream)
    _build.count_launch(KERNEL_OPEN_LOOP)
    return X, cost
