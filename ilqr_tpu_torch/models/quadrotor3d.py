"""3-D quadrotor: n_x = 12, n_u = 4, and the rotor-lag variant (n_x = 16).

PyTorch counterpart of `ilqr_tpu/models/quadrotor3d.py`.  State
x = [p (3), Θ (3), v (3), ω (3)]: world position (z up), ZYX Euler angles
(roll φ, pitch θ, yaw ψ), world velocity, body rates.  Controls
u = [F1, F2, F3, F4], rotor thrusts in a "+" configuration:

    ṗ = v,  Θ̇ = W(φ, θ) ω,  v̇ = (T/m) R(Θ) e₃ − g e₃,  ω̇ = J⁻¹(τ − ω × Jω)

The pitch guard is JAX's, in meaning bit for bit: 1/cos θ is taken of
cos θ clamped to ±1e-3 where |cos θ| < 1e-3 (to +1e-3 at cos θ = 0), so a
line-search candidate that pitches through vertical stays finite.  The
rotor variant adds four first-order actuator states, ḟ = (u − f)/τ, and
drives the body with f.  Their CUDA twins for the rollout kernels are
`Quadrotor3dRegs` and `Quadrotor3dRotorRegs` in `csrc/models.cuh`.
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
    p = params
    m, g, arm, km = p["m"], p["g"], p["arm"], p["km"]
    Jx, Jy, Jz = p["Jx"], p["Jy"], p["Jz"]
    phi, th, psi = x[..., 3], x[..., 4], x[..., 5]
    vx, vy, vz = x[..., 6], x[..., 7], x[..., 8]
    wx, wy, wz = x[..., 9], x[..., 10], x[..., 11]
    F1, F2, F3, F4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]

    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(th), torch.cos(th)
    sps, cps = torch.sin(psi), torch.cos(psi)
    # The Euler-singularity guard.  A Python float times a tensor that
    # carries a tangent gives a float64 tangent under vmap(jacfwd), so the
    # clamp is a tensor of cth's dtype.
    eps = torch.full_like(cth, 1e-3)
    inv_cth = torch.reciprocal(torch.where(
        cth.abs() < eps, torch.sign(cth) * eps + (cth == 0.0) * eps, cth))
    tth = sth * inv_cth

    thrust = F1 + F2 + F3 + F4
    tau_x = arm * (F2 - F4)
    tau_y = arm * (F3 - F1)
    tau_z = km * (F1 - F2 + F3 - F4)

    # Body z axis in the world frame: third column of Rz(ψ) Ry(θ) Rx(φ).
    e3x = cps * sth * cph + sps * sph
    e3y = sps * sth * cph - cps * sph
    e3z = cth * cph

    ax = thrust * e3x / m
    ay = thrust * e3y / m
    az = thrust * e3z / m - g

    dphi = wx + sph * tth * wy + cph * tth * wz
    dth = cph * wy - sph * wz
    dpsi = (sph * wy + cph * wz) * inv_cth

    dwx = (tau_x - (Jz - Jy) * wy * wz) / Jx
    dwy = (tau_y - (Jx - Jz) * wz * wx) / Jy
    dwz = (tau_z - (Jy - Jx) * wx * wy) / Jz
    return torch.stack([vx, vy, vz, dphi, dth, dpsi, ax, ay, az,
                        dwx, dwy, dwz], dim=-1)


def hover_controls(params) -> torch.Tensor:
    """Per-rotor thrust that cancels gravity at level attitude (U_init)."""
    m = params["m"]
    return 0.25 * m * params["g"] * torch.ones(4, dtype=m.dtype,
                                               device=m.device)


def _params(x_target, Q, R, Q_f, dt, device, dtype, **scalars):
    params = quadratic_cost_params(x_target, Q, R, Q_f, device=device,
                                   dtype=dtype)
    for name, v in dict(scalars, dt=dt).items():
        params[name] = as_tensor(v, device, dtype)
    return params


def make_quadrotor3d(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    g: float = 9.81,
    m: float = 0.5,
    arm: float = 0.17,
    km: float = 0.016,
    Jx: float = 0.0023,
    Jy: float = 0.0023,
    Jz: float = 0.004,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    """Crazyflie-scale parameters by default; quadratic costs."""
    params = _params(x_target, Q, R, Q_f, dt, device, dtype, g=g, m=m,
                     arm=arm, km=km, Jx=Jx, Jy=Jy, Jz=Jz)
    return System(
        params=params, n_x=12, n_u=4, dt=dt, f_cont=f_cont,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )


def default_weights(device=DEFAULT_DEVICE, dtype=torch.float32):
    """(Q, R, Q_f) of the hover-repositioning workloads."""
    kw = dict(device=device, dtype=dtype)
    Q = torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.5, 0.5, 0.5,
                                 0.1, 0.1, 0.1, 0.05, 0.05, 0.05], **kw))
    R = 0.1 * torch.eye(4, **kw)
    Q_f = torch.diag(torch.tensor([200.0, 200.0, 200.0, 50.0, 50.0, 50.0,
                                   20.0, 20.0, 20.0, 5.0, 5.0, 5.0], **kw))
    return Q, R, Q_f


def f_cont_rotor(params, x, u):
    """x = [p, Θ, v, ω, f (4)]; ḟ = (u − f)/τ, the body driven by f."""
    f = x[..., 12:16]
    body = f_cont(params, x[..., :12], f)
    df = (u - f) / params["rotor_tau"]
    return torch.cat([body, df], dim=-1)


def make_quadrotor3d_rotor(
    dt: float,
    x_target,
    Q,
    R,
    Q_f,
    rotor_tau: float = 0.03,
    g: float = 9.81,
    m: float = 0.5,
    arm: float = 0.17,
    km: float = 0.016,
    Jx: float = 0.0023,
    Jy: float = 0.0023,
    Jz: float = 0.004,
    integrator: str = "rk4",
    *,
    device=DEFAULT_DEVICE,
    dtype=torch.float32,
) -> System:
    """n_x = 16: the quadrotor and four rotor-lag states (x_target, Q and
    Q_f are 16-dimensional)."""
    params = _params(x_target, Q, R, Q_f, dt, device, dtype, g=g, m=m,
                     arm=arm, km=km, Jx=Jx, Jy=Jy, Jz=Jz,
                     rotor_tau=rotor_tau)
    return System(
        params=params, n_x=16, n_u=4, dt=dt, f_cont=f_cont_rotor,
        stage_cost=quadratic_stage_cost, terminal_cost=quadratic_terminal_cost,
        integrator=integrator,
    )
