"""B2's device models for the other families, without a GPU.

`csrc/chain_rollout.cu` runs the line-search costs (B2a), the trajectory
(B2b) and the open-loop rollout of one instance with each model's twin in
`csrc/models.cuh`: the cart-pole, the planar and 3-D quadrotors, the
rotor-lag quadrotor and the car, under euler, midpoint and rk4 (their
implicit rules, the wrappers, the LTI systems and the spring chain are
`test_torch_wrapper_models_host.py`'s).  It is compiled with g++ as in
`test_torch_batched_host.py` (its fixture: `MOCK_RUNTIME`, the
`MOCK_ASYNC_COPY` mbarrier model, a ring of 2 stages of 8 steps), so that
N = 17 and 33 cross several chunk edges, and each result is held to the
plain rollouts in f64 within 1e-5 of each output's max, a repeated call
giving the same bits.  The wide models (n_x 6, 12, 16) read the stage
cost's x_target, Q and R from the block's shared copy.  Also the dispatch
rules that need no GPU: which systems and integrators the kernels take,
and what raises with which ROADMAP item; and that chip_smoke.py's phase 28
checks the 3-D quadrotors along nominals where a rounding does not grow.
"""
import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models import quadrotor3d
from ilqr_tpu_torch.ops import batched, fused_rollout
from test_torch_batched_host import _close, _f64, _twice, host_lib  # noqa: F401

torch.set_num_threads(1)

F32 = dict(dtype=torch.float32, device="cpu")


def _q3(rotor=False, integrator="rk4"):
    Q, R, Q_f = quadrotor3d.default_weights(**F32)
    if rotor:
        Q = torch.block_diag(Q, 0.01 * torch.eye(4))
        Q_f = torch.block_diag(Q_f, torch.eye(4))
        return itt.make_quadrotor3d_rotor(
            0.02, [2.0, 1.0, 1.5] + [0.0] * 9 + [1.226] * 4, Q, R, Q_f,
            integrator=integrator, **F32)
    return itt.make_quadrotor3d(0.02, [2.0, 1.0, 1.5] + [0.0] * 9, Q, R, Q_f,
                                integrator=integrator, **F32)


def _systems(integrator):
    return {
        "cartpole": itt.make_cartpole(
            0.02, [0.0, np.pi, 0.0, 0.0], np.diag([1.0, 10.0, 0.1, 0.1]),
            0.1 * np.eye(1), np.diag([100.0, 100.0, 10.0, 10.0]),
            integrator=integrator, **F32),
        "quadrotor": itt.make_quadrotor(
            0.01, [3.0, 1.0, 0.0, 0.0, 0.0, 0.0],
            np.diag([1.0, 1.0, 0.5, 0.1, 0.1, 0.1]), 0.1 * np.eye(2),
            np.diag([200.0, 200.0, 50.0, 20.0, 20.0, 10.0]),
            integrator=integrator, **F32),
        "quadrotor3d": _q3(False, integrator),
        "quadrotor3d_rotor": _q3(True, integrator),
        "car": itt.make_car(
            0.05, [8.0, 0.0, 0.0, 0.0], np.diag([0.1, 0.1, 0.01, 0.1]),
            np.diag([1.0, 5.0]), 100.0 * np.diag([1.0, 1.0, 0.1, 1.0]),
            integrator=integrator, **F32),
    }


def _nominal(name, system, N, seed):
    """x0, a nominal (X, U) near the model's operating point, gains."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32)
    x0 = torch.tensor(0.3 * rng.standard_normal(system.n_x), **f32)
    U = 0.3 * rng.standard_normal((N, system.n_u))
    if name.startswith("quadrotor"):
        U += 0.5 * 9.81 / system.n_u * (2.0 if name == "quadrotor" else 1.0)
    if name == "quadrotor3d_rotor":
        x0[12:] += 1.226
    U = torch.tensor(U, **f32)
    X, _ = itt.rollout(system, x0, U)
    u_ff = torch.tensor(0.2 * rng.standard_normal((N, system.n_u)), **f32)
    K = torch.tensor(-0.05 * rng.standard_normal((N, system.n_u,
                                                   system.n_x)), **f32)
    return x0, X.contiguous(), U, u_ff, K


def _check(lib, name, system, N, n_alphas, seed):
    x0, X, U, u_ff, K = _nominal(name, system, N, seed)
    alphas = torch.tensor([0.5 ** i for i in range(n_alphas)])
    s64 = _f64(system)
    args64 = (x0.double(), alphas.double(), X.double(), U.double(),
              u_ff.double(), K.double())
    ref = itt.linesearch_rollouts(s64, *args64)
    got = _twice(lambda: (fused_rollout.launch_costs(
        lib, system, x0, alphas, X, U, u_ff, K, 0),))
    _close(got, (ref[2],))
    a = min(1, n_alphas - 1)
    got = _twice(lambda: fused_rollout.launch_trajectory(
        lib, system, x0, float(alphas[a]), X, U, u_ff, K, 0))
    _close(got, tuple(r[a] for r in ref))
    got = _twice(lambda: fused_rollout.launch_open_loop(lib, system, x0, U,
                                                        0))
    _close(got, itt.rollout(s64, x0.double(), U.double()))


# (N, alphas): 8-step stages in a ring of 2.
@pytest.mark.parametrize("N,A", [(1, 1), (17, 10), (33, 33)])
@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("name", ["cartpole", "quadrotor", "quadrotor3d",
                                  "quadrotor3d_rotor", "car"])
def test_device_models_match_the_plain_rollouts(host_lib, name, integrator,
                                                N, A):
    _check(host_lib, name, _systems(integrator)[name], N, A, seed=N + A)


def test_device_models_at_misaligned_views(host_lib):
    """The quadrotor's rows at a 4-byte offset (a row view such as
    U_prev[1:]): the kernel places each run at its own 16-byte phase."""
    system = _systems("rk4")["quadrotor"]
    x0, X, U, u_ff, K = _nominal("quadrotor", system, 19, seed=3)
    pad = torch.zeros(1)
    views = []
    for t in (X, U, u_ff, K):
        buf = torch.cat([pad, t.reshape(-1)])[1:].view(t.shape)
        assert buf.data_ptr() % 16 == 4
        views.append(buf)
    alphas = torch.tensor([1.0, 0.5, 0.25])
    ref = itt.linesearch_rollouts(_f64(system), x0.double(), alphas.double(),
                                  X.double(), U.double(), u_ff.double(),
                                  K.double())
    got = _twice(lambda: (fused_rollout.launch_costs(
        host_lib, system, x0, alphas, *views, 0),))
    _close(got, (ref[2],))


def test_quadrotor3d_pitch_guard_on_the_device_model(host_lib):
    """A pitch within 1e-3 of vertical: the twin's clamp of cos θ is the
    torch model's (finite, and equal to the f64 plain rollout)."""
    system = _systems("euler")["quadrotor3d"]
    x0 = torch.zeros(12)
    x0[4] = np.pi / 2 - 4e-4
    x0[10] = 0.5
    U = torch.full((3, 4), 1.226)
    X, c = fused_rollout.launch_open_loop(host_lib, system, x0, U, 0)
    assert bool(torch.isfinite(X).all())
    _close((X, c), itt.rollout(_f64(system), x0.double(), U.double()))


def test_device_model_dispatch_and_refusals():
    """Model ids and integrators of the new families, their implicit rules
    (integrator ids 3 and 4) among them; what has no device form (a
    physical model under 'discrete', the spring chain at another size)
    raises with ROADMAP item B2x, in B2's entries and in B5's; the models
    reach B5's batched entries (B5n) under the explicit rules, and B5
    refuses their implicit ones (B2x)."""
    ids = {name: fused_rollout.device_model(s)
           for name, s in _systems("midpoint").items()}
    assert ids == {"cartpole": (2, 1), "quadrotor": (3, 1),
                   "quadrotor3d": (4, 1), "quadrotor3d_rotor": (5, 1),
                   "car": (6, 1)}
    cart = _systems("rk4")["cartpole"]
    for integ, i in (("backward_euler", 3), ("trapezoidal", 4)):
        assert fused_rollout.device_model(cart.with_integrator(integ)) == (
            2, i)
    refused = (cart.with_integrator("discrete"),
               itt.make_spring_chain(0.02, n_masses=2, **F32))
    for s in refused:
        with pytest.raises(NotImplementedError, match="B2x"):
            fused_rollout.device_model(s)
    # B5's batched entries take the new models (B5n): a stand-in library
    # records what each launcher hands it.
    class StandIn:
        calls = []

        def _record(self, *args):
            self.calls.append(args[:8])
            return 0

        ilqr_linesearch_costs_batched = _record
        ilqr_closed_loop_rollout_batched = _record
        ilqr_open_loop_rollout_batched = _record

    lib = StandIn()
    for integ in ("euler", "midpoint", "rk4"):
        for name, system in _systems(integ).items():
            x0, X, U, u_ff, K = _nominal(name, system, 3, 0)
            x0s, Xs, Us = x0.expand(2, -1), X.expand(2, -1, -1), U.expand(
                2, -1, -1)
            fs, Ks = u_ff.expand(2, -1, -1), K.expand(2, -1, -1, -1)
            batched.launch_costs(lib, system, x0s, torch.ones(2), Xs, Us, fs,
                                 Ks, 0)
            batched.launch_trajectory(lib, system, x0s, torch.ones(2), Xs,
                                      Us, fs, Ks, 0)
            batched.launch_trajectory(lib, system, x0s, None, None, Us, None,
                                      None, 0)
            want = fused_rollout.device_model(system) + (
                system.newton_iters, system.n_x, system.n_u)
            assert [c[:5] for c in lib.calls[-3:]] == [want] * 3
            assert all(c[7] == 2 for c in lib.calls[-3:])   # B
    with pytest.raises(NotImplementedError, match="B2x"):
        batched.launch_costs(None, cart.with_integrator("discrete"),
                             torch.zeros(2, 4), torch.ones(1), None,
                             torch.zeros(2, 3, 1), None, None, None)
    # Their implicit rules run through B2 only, as JAX's batched kernel
    # runs none.
    for integ in ("backward_euler", "trapezoidal"):
        with pytest.raises(NotImplementedError, match="B2x"):
            batched.launch_costs(None, cart.with_integrator(integ),
                                 torch.zeros(2, 4), torch.ones(1), None,
                                 torch.zeros(2, 3, 1), None, None, None)
    p = fused_rollout.params_buffer(_systems("rk4")["quadrotor3d_rotor"])
    assert p.numel() == 1 + 16 + 256 + 16 + 256 + 8


def test_new_models_reach_the_chain_entries():
    """What the B = 1 launchers hand the library for the new models (a
    stand-in library records it): the model id, the integrator id and the
    shapes, under each explicit integrator."""
    class StandIn:
        calls = []

        def _record(self, *args):
            self.calls.append(args[:5])
            return 0

        ilqr_linesearch_costs = ilqr_closed_loop_rollout = _record
        ilqr_open_loop_rollout = _record

    lib = StandIn()
    for integ in ("euler", "midpoint", "rk4"):
        for name, system in _systems(integ).items():
            x0, X, U, u_ff, K = _nominal(name, system, 3, 0)
            fused_rollout.launch_costs(lib, system, x0, torch.ones(2), X, U,
                                       u_ff, K, 0)
            fused_rollout.launch_trajectory(lib, system, x0, 0.5, X, U, u_ff,
                                            K, 0)
            fused_rollout.launch_open_loop(lib, system, x0, U, 0)
            want = fused_rollout.device_model(system) + (
                system.newton_iters, system.n_x, system.n_u)
            assert lib.calls[-3:] == [want] * 3
    assert len(lib.calls) == 3 * 5 * 3


def _x0_growth(system, inputs, alphas):
    """How far a relative change of 1e-7 in x0 moves the f64 closed loops
    of `alphas`, over the size of that change."""
    x0, X, U, u_ff, K = (t.double() for t in inputs)
    s64, alphas = _f64(system), alphas.double()
    base = itt.linesearch_rollouts(s64, x0, alphas, X, U, u_ff, K)[0]
    moved = itt.linesearch_rollouts(s64, x0 * (1 + 1e-7), alphas, X, U, u_ff,
                                    K)[0]
    return float((moved - base).abs().max() / (x0.abs().max() * 1e-7))


def _tumbling_nominal(system, rotor, seed):
    """Phase 28's first nominals: noise 0.3 on x0, U and u_ff, 129 steps
    (of the model at dt 0.02, as `_q3` makes it)."""
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(0.3 * rng.standard_normal(system.n_x), **F32)
    if rotor:
        x0[12:] += 1.226
    U = torch.tensor(0.3 * rng.standard_normal((129, 4)) + 0.5 * 9.81 / 4,
                     **F32)
    X, _ = itt.rollout(system, x0, U)
    u_ff = torch.tensor(0.3 * rng.standard_normal((129, 4)), **F32)
    K = torch.tensor(-0.05 * rng.standard_normal((129, 4, system.n_x)),
                     **F32)
    return x0, X, U, u_ff, K


@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("name", ["quadrotor3d", "quadrotor3d_rotor",
                                  "cartpole", "quadrotor", "car"])
def test_chip_smoke_b2_nominals_do_not_amplify_rounding(host_lib, name,
                                                        integrator):
    """chip_smoke.py's phase 28 holds B2 to max(RTOL_B2 of the output's max,
    F32_FLOOR times the plain version's own f32 error against f64), and
    phase 32 holds B5 on the same models to the plain f32 version.  Two
    f32 evaluations in other orders err alike only where the recursion
    does not amplify a rounding.  On phase 28's nominals (N = 500, its
    seeds; the cart-pole and both quadrotors at dt 0.005, the 3-D ones
    with noise 0.003) a relative change of 1e-7 in x0 grows at most
    100-fold along the closed loops of 10 alphas (38-fold at most for the
    3-D quadrotors on seeds 11-15), and the host build of the kernel meets
    that gate.  At the cart-pole's dt 0.02 and the planar quadrotor's 0.01
    the same change grew 255-fold (cart-pole, euler) and 2199-fold
    (quadrotor, midpoint).  On the 3-D quadrotors' first nominals (dt
    0.02, noise 0.3: the craft tumbles) it grows more than 1e6-fold
    within 129 steps on one of seeds 11-15 at least, and there two f32
    evaluations part from f64 by unrelated amounts."""
    import chip_smoke as cs

    system = cs.wide_model_systems(itt, F32, integrator)[name]
    cases = [(i, m) for i in ("euler", "midpoint", "rk4")
             for m in cs.WIDE_B2_MODELS]
    seed = 7 + cases.index((integrator, name)) + 500   # wide_plain's
    inputs = cs.wide_model_nominal(system, name, 500, seed, F32)
    alphas = torch.tensor([0.5 ** i for i in range(10)])
    assert _x0_growth(system, inputs, alphas) <= 100.0
    x0, X, U, u_ff, K = inputs
    ref = itt.linesearch_rollouts(_f64(system), *(t.double() for t in (
        x0, alphas, X, U, u_ff, K)))[2]
    plain = itt.linesearch_rollouts(system, x0, alphas, X, U, u_ff, K)[2]
    got = fused_rollout.launch_costs(host_lib, system, x0, alphas, X, U,
                                     u_ff, K, 0)
    err = float((got.double() - ref).abs().max())
    floor = float((plain.double() - ref).abs().max())
    assert err <= max(cs.RTOL_B2 * float(ref.abs().max()),
                      cs.F32_FLOOR * floor)
    if not name.startswith("quadrotor3d"):
        return
    rotor = name == "quadrotor3d_rotor"
    tumbling = _q3(rotor, integrator)
    assert max(_x0_growth(tumbling, _tumbling_nominal(tumbling, rotor, seed),
                          alphas) for seed in range(11, 16)) > 1e6
