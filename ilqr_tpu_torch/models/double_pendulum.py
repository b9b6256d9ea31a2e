"""Double pendulum (fully-actuated and underactuated) in manipulator form.

PyTorch counterpart of `ilqr_tpu/models/double_pendulum.py`: uniform rods
(COM at l/2), joint inertias θᵢ, joint damping dᵢ, angles measured from the
hanging-down configuration, M(q) q̈ = h(q, q̇, τ) solved by the 2×2 adjugate.
The actuation map S (2 × n_u) selects the variant: S = I₂ is the
fully-actuated system, S = [[1], [0]] drives joint 1 only.  Its CUDA twin
for the rollout kernel is `double_pendulum_f` in `csrc/models.cuh`.
"""
from __future__ import annotations

import torch

from ilqr_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    System,
    as_tensor,
    quadratic_cost_params,
    quadratic_stage_cost,
    quadratic_terminal_cost,
)


def f_cont(params, x, u):
    q1, q2, q1d, q2d = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    p = params
    m1, m2, l1, l2, g = p["m1"], p["m2"], p["l1"], p["l2"], p["g"]
    lc1, lc2 = 0.5 * l1, 0.5 * l2
    th1, th2 = p["theta1"], p["theta2"]

    c2, s2 = torch.cos(q2), torch.sin(q2)
    s1, s12 = torch.sin(q1), torch.sin(q1 + q2)

    # Mass matrix entries M(q) for uniform rods + joint inertias.
    m11 = th1 + th2 + m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2.0 * l1 * lc2 * c2)
    m12 = th2 + m2 * (lc2**2 + l1 * lc2 * c2)
    m22 = th2 + m2 * lc2**2

    # Generalized forces h = S τ − C(q,q̇)q̇ − G(q) − D q̇, componentwise.
    hc = m2 * l1 * lc2 * s2
    S = p["S"]
    tau1 = sum(S[0, j] * u[..., j] for j in range(S.shape[1]))
    tau2 = sum(S[1, j] * u[..., j] for j in range(S.shape[1]))
    # (q1d + q1d) is 2·q1d exactly.  A Python float times a 0-d tensor that
    # carries a tangent gives a float64 tangent under vmap(jacfwd) in
    # PyTorch, so no such product appears on a state-dependent term.
    h1 = (tau1 + hc * ((q1d + q1d) * q2d + q2d**2)
          - g * ((m1 * lc1 + m2 * l1) * s1 + m2 * lc2 * s12) - p["d1"] * q1d)
    h2 = tau2 - hc * q1d**2 - g * m2 * lc2 * s12 - p["d2"] * q2d

    # q̈ = M⁻¹ h by the 2×2 adjugate.
    det = m11 * m22 - m12 * m12
    qdd1 = (m22 * h1 - m12 * h2) / det
    qdd2 = (m11 * h2 - m12 * h1) / det
    return torch.stack([q1d, q2d, qdd1, qdd2], dim=-1)


def make_double_pendulum(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m1: float = 1.0,
    m2: float = 1.0,
    l1: float = 1.0,
    l2: float = 1.0,
    d1: float = 0.01,
    d2: float = 0.01,
    theta1: float = 0.0,
    theta2: float = 0.0,
    underactuated: bool = False,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    """Build the double pendulum. ``underactuated=True`` drives joint 1 only
    (n_u=1)."""
    S = [[1.0], [0.0]] if underactuated else [[1.0, 0.0], [0.0, 1.0]]
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    for name, v in dict(g=g, m1=m1, m2=m2, l1=l1, l2=l2, d1=d1, d2=d2,
                        theta1=theta1, theta2=theta2, S=S, dt=dt).items():
        params[name] = as_tensor(v, device, dtype)
    return System(
        params=params,
        n_x=4,
        n_u=len(S[0]),
        dt=dt,
        f_cont=f_cont,
        stage_cost=quadratic_stage_cost,
        terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
