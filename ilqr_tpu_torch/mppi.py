"""MPPI: Model Predictive Path Integral control (sampling-based MPC).

PyTorch counterpart of `ilqr_tpu/mppi.py`.  Each update perturbs the mean
control sequence with S Gaussian draws, rolls the S candidates out and
re-weights them by a softmax over their trajectory costs (Williams et al.,
ICRA 2017):

    U ← Σ_s w_s (U + E_s),    w_s ∝ exp(−(J_s − min_s J_s) / λ).

The S rollouts are one call of `ops.batched.open_loop_rollout_batched`,
which on a CUDA tensor launches kernel B5's open-loop entry; the mean
sequence's rollout after each update (the cost trace, and the returned
trajectory) is one call of `ops.fused_rollout.open_loop_rollout_fused`,
kernel B2's open loop.  Where a kernel does not take the system (no device
form, `batched.batched_model`/`fused_rollout.device_model`) or the dtype
is not float32, that rollout runs its plain version on the same device:
a static test of the system and dtype (ROADMAP C2's rule), made before
anything is built.

JAX's ``key`` is a `torch.Generator` on the system's device (or an int
seed for one): `solve_mppi` draws its ``iters`` updates and `run_mpc_mppi`
its ``n_sim`` solves from it in the order JAX splits its key, every draw
through `utils.random.normal`.  The temperature prices the full
trajectory cost of each sample (the "generalized cost" variant), as in
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls
from ilqr_tpu_torch.ops.batched import batched_model, open_loop_rollout_batched
from ilqr_tpu_torch.ops.fused_rollout import device_model, open_loop_rollout_fused
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.rollout import rollout as plain_rollout
from ilqr_tpu_torch.utils import random as _random

@dataclasses.dataclass(frozen=True)
class MppiConfig:
    """MPPI configuration: the fields, defaults and validation of
    `ilqr_tpu.mppi.MppiConfig`."""

    samples: int = 256
    # Softmax temperature λ: small → greedy (winner takes all), large → mean.
    temperature: float = 1.0
    # Exploration noise std per control dim (scalar or length-n_u tuple).
    sigma: Any = 0.5
    # Update iterations per solve (each re-samples around the current mean).
    iters: int = 1
    # Iteration k samples with σ·sigma_decay^k (1.0: fixed σ).
    sigma_decay: float = 1.0
    # Time correlation of the noise: ε_t = β·ε_{t−1} + √(1−β²)·w_t.
    noise_beta: float = 0.0
    # Optional box limits applied to every sampled control.
    u_min: Any = None
    u_max: Any = None
    # Softmax over the best ⌈frac·S⌉ samples only (1.0: classic MPPI).
    elite_frac: float = 1.0

    def __post_init__(self):
        if self.samples < 2:
            raise ValueError(f"samples must be >= 2, got {self.samples}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if not (0.0 < self.elite_frac <= 1.0):
            raise ValueError(f"elite_frac must be in (0, 1], got {self.elite_frac}")
        if not (0.0 < self.sigma_decay <= 1.0):
            raise ValueError(f"sigma_decay must be in (0, 1], got {self.sigma_decay}")
        if not (0.0 <= self.noise_beta < 1.0):
            raise ValueError(f"noise_beta must be in [0, 1), got {self.noise_beta}")
        if (self.u_min is None) != (self.u_max is None):
            raise ValueError("u_min and u_max must be set together")

    def sigma_array(self, n_u: int, dtype, device=None) -> torch.Tensor:
        return torch.broadcast_to(
            torch.as_tensor(self.sigma, dtype=dtype, device=device), (n_u,))

    def limit_arrays(self, n_u: int, dtype, device=None):
        if self.u_min is None:
            return None
        return tuple(torch.broadcast_to(
            torch.as_tensor(v, dtype=dtype, device=device), (n_u,))
            for v in (self.u_min, self.u_max))


@dataclasses.dataclass(frozen=True)
class MppiSolution:
    X: Any           # (N+1, n_x) rollout of the returned mean controls
    U: Any           # (N, n_u) updated mean control sequence
    cost: Any        # scalar cost of the mean sequence
    cost_trace: Any  # (iters,) mean-sequence cost after each update
    ess_trace: Any   # (iters,) effective sample size Σw / Σw² per update


@dataclasses.dataclass(frozen=True)
class MppiMpcResult:
    X: Any          # (n_sim+1, n_x) closed-loop states
    U: Any          # (n_sim, n_u) applied controls
    cost: Any       # accumulated plant cost (+ terminal)
    ess: Any        # (n_sim,) effective sample size at each step


def _clip(U, limits):
    return U if limits is None else torch.clamp(U, limits[0], limits[1])


def _takes(check, system: System, dtype) -> bool:
    """Whether a rollout kernel takes the system in ``dtype``: float32 and
    a device form ``check`` accepts (it raises NotImplementedError for the
    systems ROADMAP B2x lists)."""
    if dtype != torch.float32:
        return False
    try:
        check(system)
    except NotImplementedError:
        return False
    return True


def _on_kernel(check, system: System, x) -> bool:
    # On the CPU the wrappers run their plain versions.
    return x.device.type == "cpu" or _takes(check, system, x.dtype)


def _sample_costs(system: System, x0, U_cand):
    """Trajectory costs of the S candidates (S, N, n_u) from x0."""
    x0s = x0.expand(U_cand.shape[0], x0.shape[0]).contiguous()
    if _on_kernel(batched_model, system, x0):
        return open_loop_rollout_batched(system, x0s, U_cand)[1]
    return plain_rollout(system, x0s, U_cand)[1]


def _mean_rollout(system: System, x0, U):
    """(X, cost) of one control sequence."""
    if _on_kernel(device_model, system, x0):
        return open_loop_rollout_fused(system, x0, U.contiguous())
    return plain_rollout(system, x0, U)


def _candidates(U, key, config: MppiConfig, sigma_scale):
    """The S sampled control sequences (S, N, n_u) around U: one normal
    draw from ``key``, low-passed when noise_beta > 0, scaled by σ and
    clipped to the limits."""
    N, n_u = U.shape
    dtype, device = U.dtype, U.device
    sigma = sigma_scale * config.sigma_array(n_u, dtype, device)
    gen = _random.generator(key, device)
    eps = _random.normal(gen, (config.samples, N, n_u), dtype, device)
    if config.noise_beta > 0.0:
        b = torch.tensor(config.noise_beta, dtype=dtype, device=device)
        s = torch.sqrt(1.0 - b * b)
        c = torch.zeros((config.samples, n_u), dtype=dtype, device=device)
        low = []
        for t in range(N):
            c = b * c + s * eps[:, t]
            low.append(c)
        eps = torch.stack(low, dim=1)
    return _clip(U[None] + sigma * eps,
                 config.limit_arrays(n_u, dtype, device))


@full_f32_matmuls()
def mppi_update(
    system: System,
    x0: torch.Tensor,
    U: torch.Tensor,
    key,
    config: MppiConfig = MppiConfig(),
    sigma_scale=1.0,
):
    """One MPPI iteration: sample → roll out every candidate → softmax
    re-weight.  ``key``: a `torch.Generator` on the system's device or an
    int seed.  Returns ``(U_new, ess)``, ess the effective sample size
    (→ 1/S when one sample dominates: lower λ or σ)."""
    x0, U = system.inputs(x0, U)
    U_cand = _candidates(U, key, config, sigma_scale)
    costs = _sample_costs(system, x0, U_cand)
    inf = torch.full_like(costs, torch.inf)
    costs = torch.where(torch.isfinite(costs), costs, inf)

    if config.elite_frac < 1.0:
        n_elite = max(2, int(config.elite_frac * config.samples))
        cutoff = torch.sort(costs).values[n_elite - 1]
        costs = torch.where(costs <= cutoff, costs, inf)

    w = torch.softmax(-(costs - torch.min(costs)) / config.temperature, dim=0)
    limits = config.limit_arrays(U.shape[1], U.dtype, U.device)
    U_new = _clip(torch.einsum("s,snu->nu", w, U_cand), limits)
    ess = 1.0 / (config.samples * torch.sum(w ** 2))
    return U_new, ess


@full_f32_matmuls()
def solve_mppi(
    system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    key,
    config: MppiConfig = MppiConfig(),
) -> MppiSolution:
    """Iterated MPPI as a trajectory optimizer: ``config.iters`` updates,
    iteration k at σ·sigma_decay^k, each drawn from ``key`` in turn."""
    x0, U_init = system.inputs(x0, U_init)
    if U_init.ndim != 2 or U_init.shape[1] != system.n_u:
        raise ValueError(
            f"U_init must have shape (N, n_u={system.n_u}), got "
            f"{tuple(U_init.shape)}")
    dtype, device = U_init.dtype, U_init.device
    gen = _random.generator(key, device)
    U = _clip(U_init, config.limit_arrays(system.n_u, dtype, device))
    scales = (torch.tensor(config.sigma_decay, dtype=dtype, device=device)
              ** torch.arange(config.iters, dtype=dtype, device=device))
    costs, esss = [], []
    for k in range(config.iters):
        U, ess = mppi_update(system, x0, U, gen, config, scales[k])
        X, cost = _mean_rollout(system, x0, U)
        costs.append(cost)
        esss.append(ess)
    return MppiSolution(X=X, U=U, cost=cost, cost_trace=torch.stack(costs),
                        ess_trace=torch.stack(esss))


@full_f32_matmuls()
def run_mpc_mppi(
    solver_system: System,
    plant_system: System,
    x0: torch.Tensor,
    U_init: torch.Tensor,
    n_sim: int,
    key,
    config: MppiConfig = MppiConfig(),
) -> MppiMpcResult:
    """Closed-loop MPPI MPC: per plant step one `solve_mppi` on the
    horizon, the first control applied to the plant, the rest shifted and
    held as the next warm start (`mpc.run_mpc`'s pattern).  The steps draw
    from ``key`` in turn."""
    x, U_warm = solver_system.inputs(x0, U_init)
    gen = _random.generator(key, U_warm.device)
    U_warm = _clip(U_warm, config.limit_arrays(
        solver_system.n_u, U_warm.dtype, U_warm.device))
    p = plant_system.params
    xs, us, cs, esss = [], [], [], []
    for _ in range(n_sim):
        sol = solve_mppi(solver_system, x, U_warm, gen, config)
        u0 = sol.U[0]
        xs.append(x)
        us.append(u0)
        cs.append(plant_system.stage_cost(p, x, u0))
        esss.append(sol.ess_trace[-1])
        x = step(plant_system, x, u0)
        U_warm = torch.cat([sol.U[1:], sol.U[-1:]], dim=0)
    cost = torch.sum(torch.stack(cs)) + plant_system.terminal_cost(p, x)
    return MppiMpcResult(X=torch.stack(xs + [x]), U=torch.stack(us),
                         cost=cost, ess=torch.stack(esss))
