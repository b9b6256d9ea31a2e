"""Parallel-in-time Kalman filtering and smoothing (associative scans).

PyTorch counterpart of `ilqr_tpu/estimation_parallel.py`: the Bayesian
filter and smoother in O(log N) depth with the associative elements of
Särkkä & García-Fernández (IEEE TAC 2021).  The filtering element is the
Riccati element (A, b, C, η, J) of `ops/parallel_riccati.py` under its
`combine`, scanned as a prefix (`parallel_riccati.prefix_scan`); the
smoother's elements (E, g, L) are scanned as a suffix
(`parallel_riccati.suffix_scan` with `smoother_combine`).  Both scans
double recursively; XLA's ``associative_scan`` associates the same
products in another order, so float32 results part from JAX's by rounding
(float64 agrees to ~1e-10).

Nonlinear systems take the iterated scheme: linearize the dynamics and the
observation along a reference trajectory, run the exact affine filter and
smoother, re-linearize along the smoothed means.  The first reference is
the open-loop trajectory of U by the defect-parallel Newton sweeps
(`ops.parallel_rollout.open_loop_defect_rollout`, engine 'auto'), which on
a CUDA float32 record launch kernel B3, the affine prefix scan.

Conventions match `estimation.run_ekf`/`run_eks`: U (N, n_u), Y (N, n_y)
with Y[k] measured after applying U[k], so estimate k is x_{k+1}.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ilqr_tpu_torch.estimation import EkfState
from ilqr_tpu_torch.models.base import System, full_f32_matmuls, lin_solve
from ilqr_tpu_torch.ops.integrators import step
from ilqr_tpu_torch.ops.parallel_riccati import (
    RiccatiElement,
    combine,
    prefix_scan,
    suffix_scan,
)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _filter_elements(F, c, H, d, Q_proc, R_obs, m0, P0, Y) -> RiccatiElement:
    """Associative filtering elements of the affine chain
    x_{t+1} = F_t x_t + c_t + w,  y_t = H_t x_{t+1} + d_t + v.

    Element k ≥ 1 conditions on y_k alone; element 0 also carries the
    prior (m0, P0).  The prefix e_0 ⊗ … ⊗ e_k has b and C the filtered
    mean and covariance of x_{k+1} | y_{0..k}.
    """
    n_x = m0.shape[0]
    eye = torch.eye(n_x, dtype=m0.dtype, device=m0.device)
    HT = H.transpose(-1, -2)
    FT = F.transpose(-1, -2)
    S = H @ Q_proc @ HT + R_obs
    K = lin_solve(S, H @ Q_proc).transpose(-1, -2)      # Q Hᵀ S⁻¹
    resid = Y - _mv(H, c) - d
    IKH = eye - K @ H
    HtSinv = lin_solve(S, H).transpose(-1, -2)          # Hᵀ S⁻¹
    A = IKH @ F
    b = c + _mv(K, resid)
    C = IKH @ Q_proc
    eta = _mv(FT, _mv(HtSinv, resid))
    J = FT @ (HtSinv @ H) @ F

    # Element 0: the prior through step 0, then the update on y_0 (Joseph
    # form, as `estimation.ekf_update`).
    m_pred = F[0] @ m0 + c[0]
    P_pred = F[0] @ P0 @ F[0].T + Q_proc
    S0 = H[0] @ P_pred @ H[0].T + R_obs
    K0 = lin_solve(S0, H[0] @ P_pred).T
    IKH0 = eye - K0 @ H[0]
    C0 = IKH0 @ P_pred @ IKH0.T + K0 @ R_obs @ K0.T
    zero_m = torch.zeros_like(P0)[None]
    return RiccatiElement(
        A=torch.cat([zero_m, A[1:]]),
        b=torch.cat([(m_pred + K0 @ (Y[0] - H[0] @ m_pred - d[0]))[None],
                     b[1:]]),
        C=torch.cat([_sym(C0)[None], C[1:]]),
        eta=torch.cat([torch.zeros_like(m0)[None], eta[1:]]),
        J=torch.cat([zero_m, J[1:]]),
    )


@full_f32_matmuls()
def kalman_filter_parallel(F, c, H, d, Q_proc, R_obs, m0, P0, Y
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact affine-model Kalman filter in O(log N) depth.

    F (N, n_x, n_x), c (N, n_x), H (N, n_y, n_x), d (N, n_y), Y (N, n_y);
    time-invariant Q_proc and R_obs.  Returns (X_hat (N, n_x),
    P (N, n_x, n_x)), the filtered moments of x_{k+1} | y_{0..k}, aligned
    as `estimation.run_ekf`'s.
    """
    prefix = prefix_scan(_filter_elements(F, c, H, d, Q_proc, R_obs, m0, P0,
                                          Y))
    return prefix.b, _sym(prefix.C)


class SmootherElement(NamedTuple):
    E: torch.Tensor  # (..., n_x, n_x) conditional gain
    g: torch.Tensor  # (..., n_x) offset
    L: torch.Tensor  # (..., n_x, n_x) conditional covariance


def smoother_combine(ei: SmootherElement, ej: SmootherElement
                     ) -> SmootherElement:
    """Associative combine of an earlier element ei with a later ej."""
    return SmootherElement(
        E=ei.E @ ej.E,
        g=_mv(ei.E, ej.g) + ei.g,
        L=ei.E @ ej.L @ ei.E.transpose(-1, -2) + ei.L,
    )


@full_f32_matmuls()
def kalman_smoother_parallel(F, c, Q_proc, X_f, P_f
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RTS smoothing of filtered moments in O(log N) depth.

    F[k], c[k] map estimate k to estimate k+1 (the transition applied after
    (X_f[k], P_f[k])); the last filtered moment is its own smoothed one.
    Returns (X_s, P_s), shaped and aligned as the inputs.
    """
    Pf, mf = P_f[:-1], X_f[:-1]
    Pp = F @ Pf @ F.transpose(-1, -2) + Q_proc
    E = lin_solve(Pp, F @ Pf).transpose(-1, -2)          # Pf Fᵀ Pp⁻¹
    elems = SmootherElement(
        E=torch.cat([E, torch.zeros_like(P_f[-1:])]),
        g=torch.cat([mf - _mv(E, _mv(F, mf) + c), X_f[-1:]]),
        L=torch.cat([_sym(Pf - E @ F @ Pf), P_f[-1:]]),
    )
    suffix = suffix_scan(elems, smoother_combine)
    return suffix.g, _sym(suffix.L)


def _default_x_lin(system: System, x0: torch.Tensor, U: torch.Tensor):
    """Linearization trajectory for the iterated schemes: the open-loop
    trajectory of U by the defect-parallel Newton sweeps (kernel B3 on a
    CUDA float32 record), or the constant trajectory at x0 where the
    sweeps diverge (non-finite, or a defect ≥ 1e-3 of the trajectory's
    scale), as JAX's rule; no host read decides between them."""
    from ilqr_tpu_torch.ops.parallel_rollout import open_loop_defect_rollout

    X_lin, _, defect = open_loop_defect_rollout(system, x0, U, iters=8,
                                                exit_tol=1e-6)
    scale = 1.0 + torch.max(torch.abs(X_lin))
    ok = torch.isfinite(defect) & (defect < 1e-3 * scale)
    return torch.where(ok, X_lin, x0.expand(X_lin.shape))


def _linearize_models(system: System, obs_fn: Callable, X_lin, U):
    """Affine dynamics and observation models along X_lin (N+1, n_x):
    X_lin[k] for the transition with U[k], X_lin[k+1] for the observation
    of x_{k+1}.  Returns (F, c, H, d)."""

    def one(x_k, x_k1, u):
        F = torch.func.jacfwd(lambda x: step(system, x, u))(x_k)
        c = step(system, x_k, u) - F @ x_k
        H = torch.func.jacfwd(obs_fn)(x_k1)
        d = obs_fn(x_k1) - H @ x_k1
        return F, c, H, d

    return torch.func.vmap(one)(X_lin[:-1], X_lin[1:], U)


@full_f32_matmuls()
def run_eks_parallel(
    system: System,
    obs_fn: Callable,
    s0: EkfState,
    U,
    Y,
    Q_proc,
    R_obs,
    iters: int = 2,
    X_lin=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterated extended RTS smoother, every sweep O(log N) deep (IEKS).

    Each iteration linearizes the dynamics and the observation along the
    current reference (first the open-loop trajectory of U, unless
    ``X_lin`` is given), runs the exact affine filter and smoother in
    parallel, and re-linearizes along the smoothed means.  Returns
    (X_s (N, n_x), P_s (N, n_x, n_x)) aligned like `estimation.run_eks`.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    x0, P0 = system.inputs(*s0)
    U, Y, Q_proc, R_obs = system.inputs(U, Y, Q_proc, R_obs)
    X_ref = _default_x_lin(system, x0, U) if X_lin is None \
        else system.inputs(X_lin)
    for _ in range(iters):
        F, c, H, d = _linearize_models(system, obs_fn, X_ref, U)
        X_f, P_f = kalman_filter_parallel(F, c, H, d, Q_proc, R_obs, x0, P0,
                                          Y)
        X_s, P_s = kalman_smoother_parallel(F[1:], c[1:], Q_proc, X_f, P_f)
        X_ref = torch.cat([x0[None], X_s], dim=0)
    return X_s, P_s


@full_f32_matmuls()
def run_ekf_parallel(
    system: System,
    obs_fn: Callable,
    s0: EkfState,
    U,
    Y,
    Q_proc,
    R_obs,
    X_lin=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass parallel extended Kalman filter at a fixed linearization
    (``X_lin``, by default the open-loop trajectory of U by the
    defect-parallel sweeps), exact affine filter in O(log N) depth.  The
    sequential EKF linearizes at the running estimate; on strongly
    nonlinear records prefer `run_eks_parallel` with iters ≥ 2.  Returns
    (X_hat, P) aligned like `estimation.run_ekf`.
    """
    x0, P0 = system.inputs(*s0)
    U, Y, Q_proc, R_obs = system.inputs(U, Y, Q_proc, R_obs)
    if X_lin is None:
        X_lin = _default_x_lin(system, x0, U)
    F, c, H, d = _linearize_models(system, obs_fn, system.inputs(X_lin), U)
    return kalman_filter_parallel(F, c, H, d, Q_proc, R_obs, x0, P0, Y)
