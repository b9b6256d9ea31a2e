"""The JAX package's f32 results that chip_smoke.py holds the port's solves to.

chip_smoke.py imports nothing of JAX, so it carries these results as
constants (`JAX_F32`, `LIMITED_PEND_SEQ_COST`, `DDP_PEND_SEQ_COST`).  Each
is recomputed here by `ilqr_tpu` in f32 on the CPU, at the configuration
chip_smoke.py runs, and compared with the constant.  Run this file as a
script to print them all:

    JAX_PLATFORMS=cpu python tests/test_torch_chip_refs.py
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ilqr_tpu as it
from ilqr_tpu.models.car import make_car, obstacle_constraints
from ilqr_tpu.models.quadrotor import hover_controls as q2_hover
from ilqr_tpu.models.quadrotor import make_quadrotor
from ilqr_tpu.models.quadrotor3d import default_weights
from ilqr_tpu.models.quadrotor3d import hover_controls as q3_hover
from ilqr_tpu.models.quadrotor3d import make_quadrotor3d
from ilqr_tpu.models.linear import make_discrete_lti
from ilqr_tpu.models.rate import make_rate_penalized_system
from ilqr_tpu.mpc import run_mpc

CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
MPC_STEPS = 20   # chip_smoke.py's WIDE_STEPS
# chip_smoke.py's P4_STEPS, P5_B, P5_N and P6_N (phase 35).
P4_STEPS = 50
P5_B, P5_N = 256, 100
P6_N = 50

# chip_smoke.py's P7_SEQ_DEMOS, P9_N and P9_SEQ_N (phase 36).
P7_SEQ_DEMOS = (2, 3)
P9_N, P9_SEQ_N = 100_000, 2000

# Between the f32 result of the host that runs this and the constant (taken
# on an x86 host): another host's BLAS blocking may move the last digits.
# The chip's gates are 1e-3 (phases 21, 29, 34) and 1e-4 (phase 21's DDP
# pendulum).
RTOL = 1e-5


def _cost(fn, *args):
    return float(jax.jit(fn)(*args))


def limited_pendulum():
    """Phase 21: the torque-limited pendulum (tests/test_limited_parallel.py
    :66-79), N = 300, |u| <= 2, the sequential box-QP solve."""
    sys_ = it.make_pendulum(0.01, [np.pi, 0.0], Q=jnp.eye(2),
                            R=0.1 * jnp.eye(1), Q_f=100.0 * jnp.eye(2),
                            d=0.0, integrator="rk4")
    cfg = it.IlqrConfig(maxiter=200, tol=1e-7, u_min=-2.0, u_max=2.0,
                        backward="scan")
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost,
                 jnp.zeros(2), jnp.zeros((300, 1)))


def ddp_pendulum():
    """Phase 21: DDP on the pendulum (tests/test_ddp.py:138-150), N = 300,
    the sequential solve."""
    sys_ = it.make_pendulum(0.01, [np.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=100.0 * jnp.eye(2), d=0.1, integrator="rk4")
    cfg = it.IlqrConfig(maxiter=150, tol=1e-8, ddp=True, adaptive_reg=True,
                        reg_init=1e-6, backward="scan")
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost,
                 jnp.zeros(2), jnp.zeros((300, 1)))


def _flight():
    Q, R, Q_f = default_weights()
    target = [2.0, 1.0, 1.5] + [0.0] * 9
    sys_ = make_quadrotor3d(0.02, target, Q, R, Q_f, integrator="rk4")
    plant = make_quadrotor3d(0.02, target, Q, R, Q_f, integrator="euler")
    return sys_, plant


def flight():
    """Phase 29: examples/quadrotor3d_flight.py's thrust-limited open loop
    (N = 150)."""
    sys_, _ = _flight()
    f_max = 0.6 * float(sys_.params["m"]) * float(sys_.params["g"])
    cfg = it.IlqrConfig(maxiter=200, tol=1e-6, u_min=0.0, u_max=f_max,
                        adaptive_reg=True)
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost, jnp.zeros(12),
                 jnp.tile(q3_hover(sys_.params), (150, 1)))


def flight_mpc():
    """Phase 29: the flight's MPC loop (H = 50, rk4 solver, euler plant),
    cut to MPC_STEPS steps."""
    sys_, plant = _flight()
    cfg = it.IlqrConfig(maxiter=5, tol=1e-5)
    U0 = jnp.tile(q3_hover(sys_.params), (50, 1))
    return _cost(lambda x: run_mpc(sys_, plant, x, U0, MPC_STEPS, cfg).cost,
                 jnp.zeros(12))


def dash():
    """Phase 29: examples/quadrotor_dash.py's thrust-limited solve
    (N = 300)."""
    sys_ = make_quadrotor(
        0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        jnp.diag(jnp.array([1.0, 1.0, 0.5, 0.1, 0.1, 0.1])), 0.1 * jnp.eye(2),
        jnp.diag(jnp.array([200.0, 200.0, 50.0, 20.0, 20.0, 10.0])))
    f_max = 2.0 * 0.5 * float(sys_.params["m"]) * float(sys_.params["g"])
    cfg = it.IlqrConfig(maxiter=200, tol=1e-6, u_min=0.0, u_max=f_max,
                        adaptive_reg=True)
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost, jnp.zeros(6),
                 jnp.tile(q2_hover(sys_.params), (300, 1)))


def cartpole_mpc():
    """Phase 29: bench.py:795-810's cart-pole MPC (H = 200), cut to
    MPC_STEPS steps."""
    sys_ = it.make_cartpole(
        0.01, [0.0, jnp.pi, 0.0, 0.0],
        Q=jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1])), R=0.1 * jnp.eye(1),
        Q_f=jnp.diag(jnp.array([100.0, 500.0, 10.0, 10.0])),
        integrator="rk4")
    cfg = it.IlqrConfig(maxiter=10, tol=1e-5)
    U0 = jnp.zeros((200, 1))
    return _cost(lambda x: run_mpc(sys_, sys_, x, U0, MPC_STEPS, cfg).cost,
                 jnp.array([0.0, 0.3, 0.0, 0.0]))


def car():
    """Phase 29: examples/car_obstacles.py's AL solve (N = 120)."""
    goal = jnp.array([8.0, 0.0, 0.0, 0.0])
    sys_ = make_car(0.05, x_target=goal,
                    Q=jnp.diag(jnp.array([0.1, 0.1, 0.01, 0.1])),
                    R=jnp.diag(jnp.array([1.0, 5.0])),
                    Q_f=100.0 * jnp.diag(jnp.array([1.0, 1.0, 0.1, 1.0])))
    cons = it.merge_constraints(
        obstacle_constraints(jnp.array([[3.0, 0.3], [5.5, -0.4]]),
                             jnp.array([1.0, 0.8])),
        it.box_control_constraints(jnp.array([-3.0, -0.5]),
                                   jnp.array([3.0, 0.5])))
    cfg = it.IlqrConfig(maxiter=100, tol=1e-7)
    al = it.AlConfig(max_outer=15, ctol=1e-3, mu0=50.0, mu_factor=5.0)
    return _cost(lambda x, U: it.solve_constrained(sys_, cons, x, U, cfg,
                                                   al).cost,
                 jnp.zeros(4), jnp.zeros((120, 2)))


def _p1():
    """Phase 34's P1 problem (tests/test_quadrotor3d.py:27-29, 146-156):
    dt 0.02, target (1, 1, 1), hover controls, N = 80, maxiter 40, tol
    1e-5, JAX's default engines."""
    Q, R, Q_f = default_weights()
    sys_ = make_quadrotor3d(0.02, [1.0, 1.0, 1.0] + [0.0] * 9, Q, R, Q_f)
    return sys_, jnp.tile(q3_hover(sys_.params), (80, 1))


def _p1_x0(x):
    return jnp.zeros(12).at[0].set(x)


def p1(i):
    """Phase 34's P1: instance i of the x0 spread over [-0.2, 0.2] at B =
    256 (the spread's f32 linspace as torch makes it), CONVERGED."""
    sys_, U0 = _p1()
    x = float(np.linspace(-0.2, 0.2, 256, dtype=np.float32)[i])
    sol = jax.jit(lambda x0, U: it.solve(
        sys_, x0, U, it.IlqrConfig(maxiter=40, tol=1e-5)))(_p1_x0(x), U0)
    assert int(sol.status) == it.CONVERGED
    return float(sol.cost)


def p3_defect():
    """Phase 34's P3: P1's first instance by the defect line search with
    the defect initial rollout (JAX's 'scan' backward pass, XLA scan)."""
    sys_, U0 = _p1()
    cfg = it.IlqrConfig(maxiter=40, tol=1e-5, rollout="defect",
                        init_rollout="defect", backward="scan")
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost, _p1_x0(-0.2),
                 U0)


def p3_ms():
    """Phase 34's P3 by multiple shooting (update engine 'xla')."""
    from ilqr_tpu.shooting import MsConfig, solve_ms
    sys_, U0 = _p1()
    cfg = it.IlqrConfig(maxiter=40, tol=1e-5, backward="scan")
    return _cost(lambda x, U: solve_ms(sys_, x, U, config=cfg,
                                       ms=MsConfig(update_engine="xla")).cost,
                 _p1_x0(-0.2), U0)


def p4():
    """Phase 35's P4: examples/reference_tracking_mpc.py's tracking MPC
    (the tracked pendulum under rk4, H = 50, maxiter 8, tol 1e-6; the
    reference built for its 600 steps), cut to P4_STEPS steps: the
    closed-loop cost and the RMS angle error against the reference."""
    dt, n_sim, horizon = 0.01, 600, 50
    base = it.make_pendulum(dt, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")
    t = jnp.arange(n_sim + horizon + 1) * dt
    theta_ref = 0.8 * jnp.sin(2.0 * t)
    X_ref = jnp.stack([theta_ref, 1.6 * jnp.cos(2.0 * t)], axis=-1)
    trk = it.make_tracking_system(
        base, X_ref, jnp.zeros((n_sim + horizon, 1)),
        Q=jnp.diag(jnp.array([100.0, 1.0])), R=0.01 * jnp.eye(1),
        Q_f=jnp.zeros((2, 2)))
    res = jax.jit(lambda x: run_mpc(
        trk, trk, x, jnp.zeros((horizon, 1)), P4_STEPS,
        it.IlqrConfig(maxiter=8, tol=1e-6)))(it.augment_x0(jnp.zeros(2)))
    theta = it.strip_clock(res.X)[:, 0]
    rms = jnp.sqrt(jnp.mean((theta - theta_ref[:P4_STEPS + 1]) ** 2))
    return float(res.cost), float(rms)


def p5_x0s():
    """Phase 35's P5 initial states: bench.py:795-799's cart-pole near its
    upright target, x and the angle's offset drawn by numpy's seeded
    generator (chip_smoke.py's `p5_x0s`), u_prev = 0."""
    off = np.random.default_rng(35).uniform(-0.1, 0.1, (P5_B, 2))
    x0s = np.zeros((P5_B, 5), np.float32)
    x0s[:, 0] = off[:, 0]
    x0s[:, 1] = np.float32(np.pi) + off[:, 1].astype(np.float32)
    return x0s


def p5(samples):
    """Phase 35's P5: `jax.vmap(solve)` of the rate-penalized cart-pole
    (S = 0.1 I, rk4, dt 0.01, N = P5_N, maxiter 40, tol 1e-5) from the
    sampled instances of `p5_x0s`."""
    cart = it.make_cartpole(
        0.01, [0.0, jnp.pi, 0.0, 0.0],
        Q=jnp.diag(jnp.array([1.0, 10.0, 0.1, 0.1])), R=0.1 * jnp.eye(1),
        Q_f=jnp.diag(jnp.array([100.0, 500.0, 10.0, 10.0])),
        integrator="rk4")
    sys_ = make_rate_penalized_system(cart, 0.1 * jnp.eye(1))
    cfg = it.IlqrConfig(maxiter=40, tol=1e-5)
    x0s = jnp.asarray(p5_x0s()[list(samples)])
    sol = jax.jit(jax.vmap(lambda x: it.solve(
        sys_, x, jnp.zeros((P5_N, 1)), cfg)))(x0s)
    return [float(c) for c in sol.cost]


def p6():
    """Phase 35's P6: examples/linear_lqr.py's double integrator
    (cont2disc at dt 0.1, Q = R = I, Q_f = 10 I, x0 = (2, 0), N = 50) as
    make_discrete_lti's system, by `solve` (maxiter 20, tol 1e-6)."""
    A_d, B_d = it.cont2disc(jnp.array([[0.0, 1.0], [0.0, 0.0]]),
                            jnp.array([[0.0], [1.0]]), 0.1)
    sys_ = make_discrete_lti(A_d, B_d, 0.1, jnp.zeros(2), jnp.eye(2),
                                jnp.eye(1), 10.0 * jnp.eye(2))
    cfg = it.IlqrConfig(maxiter=20, tol=1e-6)
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost,
                 jnp.array([2.0, 0.0]), jnp.zeros((P6_N, 1)))


# chip_smoke.py's name of each constant, and the function that computes it.
def p7(demos=(0, 1, 2, 3)):
    """Phase 36's P7: examples/inverse_optimal_control.py at full size
    (N = 60, maxiter 150, tol 1e-9, the demonstrations vmapped), the loss
    and its gradient at log_w = 0, over all four or over P7_SEQ_DEMOS."""
    from ilqr_tpu.diff import solve_implicit

    def make_system(log_w):
        w = jnp.exp(log_w)
        return it.make_pendulum(0.05, [jnp.pi, 0.0],
                                Q=jnp.diag(jnp.array([w[0], w[1]])),
                                R=w[2] * jnp.eye(1), Q_f=10.0 * jnp.eye(2),
                                integrator="rk4")
    cfg = it.IlqrConfig(maxiter=150, tol=1e-9)
    U0 = jnp.zeros((60, 1))
    x0s = jnp.array([[0.2, 0.0], [0.6, 0.0], [-0.4, 0.5],
                     [1.0, -0.5]])[jnp.array(demos)]
    expert = make_system(jnp.log(jnp.array([2.0, 0.5, 0.25])))
    demo = jax.jit(jax.vmap(lambda x0: it.solve(expert, x0, U0, cfg).U))(x0s)

    def loss(log_w):
        sys_ = make_system(log_w)
        Us = jax.vmap(lambda x0: solve_implicit(sys_, x0, U0, cfg).U)(x0s)
        return jnp.mean((Us - demo) ** 2)
    val, g = jax.jit(jax.value_and_grad(loss))(jnp.zeros(3))
    return [float(val)] + [float(v) for v in g]


def p8_limited():
    """Phase 36's P8: examples/mppi_pendulum.py's limited iLQR from zeros
    (N = 80, |u| <= 8, maxiter 100, tol 1e-8), which the polish of the
    MPPI explore must reach."""
    sys_ = it.make_pendulum(0.05, [jnp.pi, 0.0],
                            Q=jnp.diag(jnp.array([5.0, 0.5])),
                            R=0.1 * jnp.eye(1),
                            Q_f=jnp.diag(jnp.array([50.0, 5.0])),
                            integrator="rk4")
    cfg = it.IlqrConfig(maxiter=100, tol=1e-8, u_min=-8.0, u_max=8.0)
    return _cost(lambda x, U: it.solve(sys_, x, U, cfg).cost, jnp.zeros(2),
                 jnp.zeros((80, 1)))


_P9 = {}


def p9():
    """Phase 36's P9: examples_torch/parallel_estimation.py's record (numpy
    seed 0) with JAX's own f32 rollout as the truth; RMS-to-truth of the
    parallel filter and smoother (iters 2) at P9_N and of the sequential
    EKF and RTS smoother on its first P9_SEQ_N steps."""
    if _P9:
        return _P9
    from ilqr_tpu.estimation import EkfState, run_ekf, run_eks
    from ilqr_tpu.estimation_parallel import run_ekf_parallel, run_eks_parallel
    from examples_torch.parallel_estimation import record_arrays

    sys_ = it.make_pendulum(0.001, [jnp.pi, 0.0], Q=jnp.eye(2), R=jnp.eye(1),
                            Q_f=jnp.zeros((2, 2)), d=0.05, integrator="rk4")
    U_np, V_np = record_arrays(P9_N)
    U = jnp.asarray(U_np, jnp.float32)
    x0 = jnp.array([0.3, 0.0])
    X_true = jax.jit(lambda u: it.rollout(sys_, x0, u)[0])(U)
    Y = X_true[1:, :1] + jnp.asarray(V_np, jnp.float32)
    s0 = EkfState(x0, 0.1 * jnp.eye(2))
    Qp, Ro = 1e-6 * jnp.eye(2), 1e-3 * jnp.eye(1)

    def obs(x):
        return x[:1]

    def rms(Xh):
        return float(jnp.sqrt(jnp.mean((Xh - X_true[1:Xh.shape[0] + 1]) ** 2)))
    n = P9_SEQ_N
    _P9.update(
        ekf_par=rms(jax.jit(lambda U, Y: run_ekf_parallel(
            sys_, obs, s0, U, Y, Qp, Ro)[0])(U, Y)),
        eks_par=rms(jax.jit(lambda U, Y: run_eks_parallel(
            sys_, obs, s0, U, Y, Qp, Ro, iters=2)[0])(U, Y)),
        ekf_seq=rms(jax.jit(lambda U, Y: run_ekf(
            sys_, obs, s0, U, Y, Qp, Ro)[1])(U[:n], Y[:n])),
        eks_seq=rms(jax.jit(lambda U, Y: run_eks(
            sys_, obs, s0, U, Y, Qp, Ro)[0])(U[:n], Y[:n])))
    return _P9


REFS = {
    "LIMITED_PEND_SEQ_COST": limited_pendulum,
    "DDP_PEND_SEQ_COST": ddp_pendulum,
    "JAX_F32['flight']": flight,
    "JAX_F32['flight_mpc_20']": flight_mpc,
    "JAX_F32['dash']": dash,
    "JAX_F32['cartpole_mpc_20']": cartpole_mpc,
    "JAX_F32['car']": car,
    "JAX_F32['p1_0']": lambda: p1(0),
    "JAX_F32['p1_127']": lambda: p1(127),
    "JAX_F32['p1_255']": lambda: p1(255),
    "JAX_F32['p3_defect']": p3_defect,
    "JAX_F32['p3_ms']": p3_ms,
    "JAX_F32['p4_cost']": lambda: p4()[0],
    "JAX_F32['p4_rms']": lambda: p4()[1],
    "JAX_F32['p5_0']": lambda: p5((0,))[0],
    "JAX_F32['p5_127']": lambda: p5((127,))[0],
    "JAX_F32['p5_255']": lambda: p5((255,))[0],
    "JAX_F32['p6']": p6,
    "JAX_F32['p7']": p7,
    "JAX_F32['p7_sub']": lambda: p7(P7_SEQ_DEMOS),
    "JAX_F32['p8_limited']": p8_limited,
    "JAX_F32['p9_ekf_par_rms']": lambda: p9()["ekf_par"],
    "JAX_F32['p9_eks_par_rms']": lambda: p9()["eks_par"],
    "JAX_F32['p9_ekf_seq_rms']": lambda: p9()["ekf_seq"],
    "JAX_F32['p9_eks_seq_rms']": lambda: p9()["eks_seq"],
}


def chip_smoke_constants() -> dict:
    """The constants of REFS as chip_smoke.py states them (read from its
    source: it is not imported here)."""
    values = {}
    for node in ast.parse(CHIP_SMOKE.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("LIMITED_PEND_SEQ_COST", "DDP_PEND_SEQ_COST"):
                values[name] = ast.literal_eval(node.value)
            elif name == "JAX_F32":
                for key, v in ast.literal_eval(node.value).items():
                    values[f"JAX_F32[{key!r}]"] = v
    return values


@pytest.mark.parametrize("name", list(REFS))
def test_chip_smoke_reference_is_jax_f32(name):
    stated = chip_smoke_constants()[name]
    np.testing.assert_allclose(REFS[name](), stated, rtol=RTOL)


if __name__ == "__main__":
    for name, fn in REFS.items():
        print(f"{name} = {fn()!r}")
