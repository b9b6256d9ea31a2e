"""State estimation: EKF and UKF filters, RTS smoother, output-feedback LQG.

PyTorch counterpart of `ilqr_tpu/estimation.py`.  Model:

    x⁺ = f(x, u) + w,   w ~ N(0, Q_proc)      (process noise)
    y  = h(x) + v,      v ~ N(0, R_obs)       (measurement noise)

Three estimators share one `EkfState`: the EKF (Jacobian linearization,
Joseph-form update), the UKF (scaled sigma points) and the extended RTS
smoother.  `simulate_output_feedback` runs LQG execution on either filter.
JAX's ``lax.scan``s are `_scan` here: a host loop on the CPU, one step
captured as a CUDA graph and replayed on the card (`simulate_output_feedback`
stays a host loop); the Jacobians come from `torch.func.jacfwd` or reverse
rows (`_jac_step`), the small solves from `models.base.lin_solve` (JAX's
closed-form `smallmat.solve_small`), and the Cholesky factors from
``torch.linalg.cholesky_ex``, NaN where the matrix is not positive
definite as JAX's are (no exception, no host sync).  Observation functions
map one state (n_x,) to (n_y,) and must work under `torch.func` (and be
capturable on the card, see `_scan`).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import torch

from ilqr_tpu_torch.models.base import System, full_f32_matmuls, lin_solve
from ilqr_tpu_torch.ops.integrators import IMPLICIT, _jac_x, step
from ilqr_tpu_torch.utils import random as _random


class EkfState(NamedTuple):
    x_hat: torch.Tensor  # (n_x,) state estimate
    P: torch.Tensor      # (n_x, n_x) estimate covariance


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A; where A is not positive definite its
    lower triangle is NaN (``jnp.linalg.cholesky``'s behaviour)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.tril(torch.where((info == 0)[..., None, None], L,
                                  torch.full_like(L, torch.nan)))


def _jac_step(system: System, x, u):
    """∂step/∂x at (x, u): by n_x reverse passes (`integrators._jac_x`,
    several times cheaper than `jacfwd` per eager call), by `jacfwd`
    under the implicit rules (whose steps carry forward tangents only)."""
    if system.integrator in IMPLICIT:
        return torch.func.jacfwd(lambda xx: step(system, xx, u))(x)
    return _jac_x(lambda xx, uu: step(system, xx, uu), x, u)


def ekf_predict(system: System, s: EkfState, u: torch.Tensor,
                Q_proc: torch.Tensor) -> EkfState:
    """Propagate the estimate through the (discrete) dynamics."""
    A = _jac_step(system, s.x_hat, u)
    return EkfState(x_hat=step(system, s.x_hat, u),
                    P=_sym(A @ s.P @ A.T + Q_proc))


def ekf_update(obs_fn: Callable, s: EkfState, y: torch.Tensor,
               R_obs: torch.Tensor) -> EkfState:
    """Measurement update (Joseph-form covariance)."""
    H = torch.func.jacfwd(obs_fn)(s.x_hat)        # (n_y, n_x)
    S = H @ s.P @ H.T + R_obs                     # innovation covariance
    K = lin_solve(S, H @ s.P).T                   # P Hᵀ S⁻¹, (n_x, n_y)
    x_new = s.x_hat + K @ (y - obs_fn(s.x_hat))
    I_KH = _eye(s.P.shape[0], s.P) - K @ H
    P_new = I_KH @ s.P @ I_KH.T + K @ R_obs @ K.T
    return EkfState(x_hat=x_new, P=_sym(P_new))


def ekf_step(system: System, obs_fn: Callable, s: EkfState, u, y, Q_proc,
             R_obs) -> EkfState:
    """One predict(u) → update(y) cycle: y is measured AFTER applying u."""
    return ekf_update(obs_fn, ekf_predict(system, s, u, Q_proc), y, R_obs)


def _loop(body, carry, xs):
    """`_scan` as a host loop of eager steps (its form on the CPU)."""
    ys = []
    for k in range(xs[0].shape[0]):
        carry, y = body(carry, tuple(x[k] for x in xs))
        ys.append(y)
    return carry, tuple(torch.stack(t) for t in zip(*ys))


def _scan(body, carry, xs):
    """``jax.lax.scan`` over the leading axis of the tensors ``xs``:
    ``body(carry, x_k) -> (carry, y_k)`` on tuples of tensors; returns the
    last carry and the y's stacked.  On the CPU a host loop.  On a CUDA
    device one step is captured as a CUDA graph (after a warm-up step on
    a side stream) that reads x_k at a step index kept on the device,
    writes y_k into the stacked outputs and the new carry over its inputs,
    and is replayed once a step: one graph launch a step in place of each
    of the body's operations, and no host sync.  So the body must be
    capturable, as JAX's scan body must be traceable: no host reads, no
    copies from the host, no shapes that depend on data."""
    if carry[0].device.type != "cuda":
        return _loop(body, carry, xs)
    N, dev = xs[0].shape[0], carry[0].device
    carry = tuple(c.clone() for c in carry)
    k = torch.zeros(1, dtype=torch.long, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _, y0 = body(carry, tuple(x[0] for x in xs))
    torch.cuda.current_stream(dev).wait_stream(side)
    ys = tuple(torch.empty((N,) + y.shape, dtype=y.dtype, device=dev)
               for y in y0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new, y = body(carry, tuple(x.index_select(0, k)[0] for x in xs))
        for out, t in zip(ys, y):
            out.index_copy_(0, k, t[None])
        for c, t in zip(carry, new):
            c.copy_(t)
        k.add_(1)
    for _ in range(N):
        graph.replay()
    return carry, ys


def _run(step_fn, system, obs_fn, s0, U, Y, Q_proc, R_obs):
    s0 = EkfState(*system.inputs(*s0))
    U, Y, Q_proc, R_obs = system.inputs(U, Y, Q_proc, R_obs)

    def body(carry, uy):
        s = step_fn(system, obs_fn, EkfState(*carry), *uy, Q_proc, R_obs)
        return tuple(s), tuple(s)
    s, (xs, Ps) = _scan(body, tuple(s0), (U, Y))
    return EkfState(*s), xs, Ps


@full_f32_matmuls()
def run_ekf(system: System, obs_fn: Callable, s0: EkfState, U, Y, Q_proc,
            R_obs) -> Tuple[EkfState, torch.Tensor, torch.Tensor]:
    """Filter a recorded (U, Y) sequence.  U: (N, n_u); Y: (N, n_y) with
    Y[k] measured after U[k].  Returns (final state, X_hat (N, n_x),
    P (N, n_x, n_x))."""
    return _run(ekf_step, system, obs_fn, s0, U, Y, Q_proc, R_obs)


@full_f32_matmuls()
def simulate_output_feedback(
    system: System,
    obs_fn: Callable,
    X_ref: torch.Tensor,
    U_ref: torch.Tensor,
    K_fb: torch.Tensor,
    s0: EkfState,
    x0_true: torch.Tensor,
    key,
    Q_proc: torch.Tensor,
    R_obs: torch.Tensor,
    filter_step: Callable = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop LQG execution: control from the filter estimate.

    Per step k: u_k = U_ref_k + K_fb_k (x̂_k − X_ref_k); the TRUE plant
    steps with process noise w_k; a noisy measurement y = h(x⁺) + v_k
    feeds the filter.  ``key``: a `torch.Generator` or an int seed; the
    process noise is drawn first, then the measurement noise (JAX's split
    order).  `filter_step` has the `ekf_step` signature (default EKF).
    Returns (X_true (N+1, n_x), X_hat (N+1, n_x), U (N, n_u), cost).
    """
    if filter_step is None:
        filter_step = ekf_step
    X_ref, U_ref, K_fb, x0_true, Q_proc, R_obs = system.inputs(
        X_ref, U_ref, K_fb, x0_true, Q_proc, R_obs)
    s = EkfState(*system.inputs(*s0))
    N, n_x = U_ref.shape[0], x0_true.shape[0]
    n_y = obs_fn(x0_true).shape[0]
    dtype, device = X_ref.dtype, X_ref.device
    gen = _random.generator(key, device)
    Lw = cholesky(Q_proc + 1e-12 * _eye(n_x, Q_proc))
    Lv = cholesky(R_obs + 1e-12 * _eye(n_y, R_obs))
    Ws = _random.normal(gen, (N, n_x), dtype, device) @ Lw.T
    Vs = _random.normal(gen, (N, n_y), dtype, device) @ Lv.T

    p = system.params
    x, cost = x0_true, 0.0
    Xs, Xh, Us = [x0_true], [s.x_hat], []
    for k in range(N):
        u = U_ref[k] + K_fb[k] @ (s.x_hat - X_ref[k])
        cost = cost + system.stage_cost(p, x, u)
        x = step(system, x, u) + Ws[k]
        y = obs_fn(x) + Vs[k]
        s = filter_step(system, obs_fn, s, u, y, Q_proc, R_obs)
        Xs.append(x)
        Xh.append(s.x_hat)
        Us.append(u)
    cost = cost + system.terminal_cost(p, x)
    return torch.stack(Xs), torch.stack(Xh), torch.stack(Us), cost


# ---------------------------------------------------------------------------
# Unscented Kalman filter (Wan & van der Merwe 2000 scaled sigma points).
# ---------------------------------------------------------------------------


def _sigma_points(x, P, alpha, beta, kappa):
    """Scaled sigma points and mean/covariance weights: (pts (2n+1, n),
    Wm, Wc)."""
    n = x.shape[0]
    lam = alpha * alpha * (n + kappa) - n
    # Cholesky factor of (n+lam) P; the jitter keeps f32 positive definite.
    L = cholesky((n + lam) * (P + 1e-9 * _eye(n, P)))
    pts = torch.cat([x[None], x[None] + L.T, x[None] - L.T], dim=0)
    # No item assignment of a host number: that copies from the host,
    # which a CUDA graph capture (`_scan`) refuses.
    full = partial(torch.full, dtype=P.dtype, device=P.device)
    Wm = torch.cat([full((1,), lam / (n + lam)),
                    full((2 * n,), 0.5 / (n + lam))])
    Wc = torch.cat([Wm[:1] + (1.0 - alpha * alpha + beta), Wm[1:]])
    return pts, Wm, Wc


def ukf_predict(system: System, s: EkfState, u: torch.Tensor,
                Q_proc: torch.Tensor, alpha: float = 1e-1, beta: float = 2.0,
                kappa: float = 0.0) -> EkfState:
    """Unscented propagation of the estimate through the dynamics."""
    pts, Wm, Wc = _sigma_points(s.x_hat, s.P, alpha, beta, kappa)
    fpts = step(system, pts, u.expand(pts.shape[0], u.shape[-1]))
    x_pred = Wm @ fpts
    d = fpts - x_pred[None]
    P_pred = (Wc[:, None] * d).T @ d + Q_proc
    return EkfState(x_hat=x_pred, P=_sym(P_pred))


def ukf_update(obs_fn: Callable, s: EkfState, y: torch.Tensor,
               R_obs: torch.Tensor, alpha: float = 1e-1, beta: float = 2.0,
               kappa: float = 0.0) -> EkfState:
    """Unscented measurement update."""
    n = s.x_hat.shape[0]
    pts, Wm, Wc = _sigma_points(s.x_hat, s.P, alpha, beta, kappa)
    ypts = torch.func.vmap(obs_fn)(pts)
    y_pred = Wm @ ypts
    dy = ypts - y_pred[None]
    dx = pts - s.x_hat[None]
    S = (Wc[:, None] * dy).T @ dy + R_obs        # innovation covariance
    C = (Wc[:, None] * dx).T @ dy                # state-obs cross covariance
    K = lin_solve(S, C.T).T                      # C S⁻¹, (n_x, n_y)
    x_new = s.x_hat + K @ (y - y_pred)
    # P − K S Kᵀ, re-symmetrized and jittered to stay PSD under f32.
    P_new = _sym(s.P - K @ S @ K.T) + 1e-10 * _eye(n, s.P)
    return EkfState(x_hat=x_new, P=P_new)


def ukf_step(system: System, obs_fn: Callable, s: EkfState, u, y, Q_proc,
             R_obs) -> EkfState:
    """One unscented predict(u) → update(y) cycle (drop-in for
    `ekf_step`)."""
    return ukf_update(obs_fn, ukf_predict(system, s, u, Q_proc), y, R_obs)


@full_f32_matmuls()
def run_ukf(system: System, obs_fn: Callable, s0: EkfState, U, Y, Q_proc,
            R_obs) -> Tuple[EkfState, torch.Tensor, torch.Tensor]:
    """Unscented filter over a recorded (U, Y) sequence (see `run_ekf`)."""
    return _run(ukf_step, system, obs_fn, s0, U, Y, Q_proc, R_obs)


# ---------------------------------------------------------------------------
# Extended Rauch–Tung–Striebel smoother: a forward EKF pass, then a reverse
# pass with the smoother gain G_k = P_k A_{k+1}ᵀ P⁻_{k+1}⁻¹.
# ---------------------------------------------------------------------------


@full_f32_matmuls()
def run_eks(system: System, obs_fn: Callable, s0: EkfState, U, Y, Q_proc,
            R_obs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extended RTS smoother over a recorded (U, Y) sequence.

    Conventions match `run_ekf`: Y[k] is measured after applying U[k], so
    X_s[k] is the smoothed estimate of x_{k+1}.  Returns (X_s (N, n_x),
    P_s (N, n_x, n_x)).
    """
    s0 = EkfState(*system.inputs(*s0))
    U, Y, Q_proc, R_obs = system.inputs(U, Y, Q_proc, R_obs)

    def forward(carry, uy):
        s = EkfState(*carry)
        A = _jac_step(system, s.x_hat, uy[0])
        sp = EkfState(x_hat=step(system, s.x_hat, uy[0]),
                      P=_sym(A @ s.P @ A.T + Q_proc))
        s = ekf_update(obs_fn, sp, uy[1], R_obs)
        return tuple(s), (s.x_hat, s.P, sp.x_hat, sp.P, A)
    _, (Xf, Pf, Xp, Pp, As) = _scan(forward, tuple(s0), (U, Y))
    if Xf.shape[0] == 1:
        return Xf, Pf

    # Backward from the final filtered state; step k uses the prediction
    # made from k into k+1.
    def backward(carry, z):
        xs, Ps = carry
        xf, P, xp, Pp1, A1 = z
        G = lin_solve(Pp1, A1 @ P).T                # P Aᵀ Pp⁻¹
        xs = xf + G @ (xs - xp)
        Ps = _sym(P + G @ (Ps - Pp1) @ G.T)
        return (xs, Ps), (xs, Ps)
    _, (X_s, P_s) = _scan(backward, (Xf[-1], Pf[-1]), tuple(
        t.flip(0) for t in (Xf[:-1], Pf[:-1], Xp[1:], Pp[1:], As[1:])))
    return (torch.cat([X_s.flip(0), Xf[-1:]]),
            torch.cat([P_s.flip(0), Pf[-1:]]))
