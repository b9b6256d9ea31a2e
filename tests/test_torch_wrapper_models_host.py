"""B2's and B5's device forms for the LTI systems, the tracking and rate
wrappers, the implicit rules of the later models and the spring chain,
without a GPU.

`csrc/forms.cuh` with the translation units beside `csrc/chain_rollout.cu`
(`lti_rollout.cu`, `tracking_*.cu`, `rate_*.cu`, `implicit_models.cu`,
`spring_chain.cu`) are compiled with g++ through
`test_torch_batched_host.py`'s fixture (`MOCK_RUNTIME`, the
`MOCK_ASYNC_COPY` mbarrier model, a ring of 2 stages of 8 steps; the spring
chain's stages hold 4).  Every instantiation that chip_smoke.py's phase 35
launches runs here on its own nominal (`chip_smoke.wr_cases`,
`wr_nominal`) at N = 17 and 33, so that the runs cross chunk edges: B2's
three entries and (but for the implicit rules) B5's on 3 instances, each
held to the plain rollouts in f64 within 1e-5 of each output's max or, as
chip_smoke.py holds them, 4 times the plain version's own f32 error, a
repeated call giving the same bits.  Also the tracking reference's clamps,
the parameter buffers' layouts, and what `device_model` takes and refuses
(naming ROADMAP item B2x).
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import ilqr_tpu_torch as itt
from ilqr_tpu_torch.ops import batched, fused_rollout
from test_torch_batched_host import RTOL, _twice, host_lib  # noqa: F401

torch.set_num_threads(1)

F32 = dict(dtype=torch.float32, device="cpu")
CASES = cs.wr_cases()


def _f64(system):
    return system.replace(params=cs.params_f64(system.params))


def _close_floor(got, ref, ref32):
    """Each output within RTOL of its max against the f64 plain version,
    or within F32_FLOOR times the plain version's own f32 error: phase
    35's nominals of the 3-D quadrotors sit at hover with states near
    1e-3, where thrust and gravity cancel in f32 at 1e-6 of g a step."""
    for g, r, r32 in zip(got, ref, ref32):
        r = r.double()
        assert g.shape == r.shape
        err = float((g.double() - r).abs().max())
        floor = float((r32.double() - r).abs().max())
        assert err <= max(RTOL * float(r.abs().max()),
                          cs.F32_FLOOR * floor, 1e-30), (err, floor)


def _plain(system, dtype, *args):
    """The plain closed loops and open loop in ``dtype``: (X, U, costs),
    (X_open, cost_open)."""
    if dtype == torch.float64:
        system = _f64(system)
    x0, alphas, X, U, u_ff, K = (t.to(dtype) for t in args)
    return (itt.linesearch_rollouts(system, x0, alphas, X, U, u_ff, K),
            itt.rollout(system, x0, U))


def _check_b2(lib, system, inputs, alphas):
    x0, X, U, u_ff, K = inputs
    (ref, ref_o), (r32, r32_o) = (_plain(system, d, x0, alphas, X, U, u_ff, K)
                                  for d in (torch.float64, torch.float32))
    got = _twice(lambda: (fused_rollout.launch_costs(
        lib, system, x0, alphas, X, U, u_ff, K, 0),))
    _close_floor(got, (ref[2],), (r32[2],))
    a = min(1, alphas.numel() - 1)
    got = _twice(lambda: fused_rollout.launch_trajectory(
        lib, system, x0, float(alphas[a]), X, U, u_ff, K, 0))
    _close_floor(got, tuple(r[a] for r in ref), tuple(r[a] for r in r32))
    got = _twice(lambda: fused_rollout.launch_open_loop(lib, system, x0, U,
                                                        0))
    _close_floor(got, ref_o, r32_o)


def _check_b5(lib, system, inputs, alphas):
    x0s, X, U, u_ff, K = inputs
    (ref, ref_o), (r32, r32_o) = (
        _plain(system, d, x0s, alphas, X, U, u_ff, K)
        for d in (torch.float64, torch.float32))
    got = _twice(lambda: (batched.launch_costs(
        lib, system, x0s, alphas, X, U, u_ff, K, 0),))
    _close_floor(got, (ref[2],), (r32[2],))
    alpha_b = alphas[:x0s.shape[0]].contiguous()
    b = torch.arange(x0s.shape[0])
    got = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, alpha_b, X, U, u_ff, K, 0))
    _close_floor(got, tuple(r[b, b] for r in ref), tuple(r[b, b] for r in r32))
    got = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, None, None, U, None, None, 0)[::2])
    _close_floor(got, ref_o, r32_o)


@pytest.mark.parametrize("N", [17, 33])
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_device_forms_match_the_plain_rollouts(host_lib, case, N):
    """B2a (3 alphas), B2b and the open loop; then B5's entries on 3
    instances (the first's nominal among them), but for the implicit
    rules."""
    system = cs.wr_system(itt, case, F32)
    alphas = torch.tensor([1.0, 0.5, 0.25])
    x0s, X, U, u_ff, K = cs.wr_nominal(case, system, N, 11 + N, F32,
                                       batch=cs.WR_B5)
    _check_b2(host_lib, system, (x0s[0], X[0], U[0], u_ff[0], K[0]), alphas)
    if case[0] != "model":
        _check_b5(host_lib, system, (x0s, X, U, u_ff, K), alphas)


def _tracked_pendulum(n_xref, n_uref, integrator="rk4"):
    pend = itt.make_pendulum(0.01, [np.pi, 0.0], np.eye(2), np.eye(1),
                             np.eye(2), integrator=integrator, **F32)
    rng = np.random.default_rng(n_xref)
    return itt.make_tracking_system(
        pend, torch.tensor(rng.standard_normal((n_xref, 2)), **F32),
        torch.tensor(rng.standard_normal((n_uref, 1)), **F32),
        np.diag([10.0, 1.0]), 0.1 * np.eye(1), 5.0 * np.eye(2))


@pytest.mark.parametrize("n_xref,n_uref", [(10, 9), (12, 5), (40, 3)])
def test_tracking_reference_rows_clamp_as_the_plain_cost(host_lib, n_xref,
                                                         n_uref):
    """The reference row is clip(round(k), 0, rows of X_ref - 1) and the
    control row min(that, rows of U_ref - 1), the two counts apart: a run
    of 33 steps past a reference of 10 and 12 rows, and 3 control rows."""
    system = _tracked_pendulum(n_xref, n_uref)
    x0, X, U, u_ff, K = cs.wr_nominal(("tracking", "pendulum", "rk4"),
                                      system, 33, 5, F32)
    _check_b2(host_lib, system, (x0, X, U, u_ff, K),
              torch.tensor([1.0, 0.5]))


def test_tracking_clock_rounds_half_to_even(host_lib):
    """A clock started at 2.5 rounds to step 2, at 3.5 to step 4, as
    torch.round does; the kernel's stage costs follow them (under
    'discrete' over an LTI base the clock stays at k + 1/2)."""
    lti = itt.make_discrete_lti(np.array([[1.0, 0.1], [0.0, 1.0]]),
                                np.array([[0.005], [0.1]]), 0.1, np.zeros(2),
                                np.eye(2), np.eye(1), np.eye(2), **F32)
    rng = np.random.default_rng(3)
    trk = itt.make_tracking_system(
        lti, torch.tensor(rng.standard_normal((9, 2)), **F32),
        torch.tensor(rng.standard_normal((8, 1)), **F32), np.eye(2),
        np.eye(1), np.eye(2))
    U = torch.tensor(rng.standard_normal((5, 1)), **F32)
    for k0 in (2.5, 3.5):
        x0 = torch.tensor([0.3, -0.2, k0], **F32)
        got = _twice(lambda: fused_rollout.launch_open_loop(host_lib, trk, x0,
                                                            U, 0))
        _close_floor(got, itt.rollout(_f64(trk), x0.double(), U.double()),
                     itt.rollout(trk, x0, U))


def test_parameter_buffers_are_the_forms_layouts():
    """The buffer lengths the forms check (csrc/forms.cuh, params_ok):
    a register model's [dt, x_target, Q, R, Q_f, block]; LTI's block [A,
    B]; the tracking wrapper's [dt, rows, rows, Q, R, Q_f, base block,
    X_ref, U_ref]; the rate wrapper's base buffer and S; the chain's 9
    scalars, q_target and S."""
    lti = cs.wr_system(itt, ("lti", "lti_6x2", "rk4"), F32)
    assert fused_rollout.params_buffer(lti).numel() == (
        1 + 6 + 36 + 4 + 36 + 36 + 12)
    trk = _tracked_pendulum(12, 5)
    p = fused_rollout.params_buffer(trk)
    assert p.numel() == 3 + 4 + 1 + 4 + 3 + 12 * 2 + 5 * 1
    assert p[1:3].tolist() == [12.0, 5.0]
    rate = cs.wr_system(itt, ("rate", "quadrotor3d", "rk4"), F32)
    assert fused_rollout.params_buffer(rate).numel() == (
        1 + 12 + 144 + 16 + 144 + 7 + 16)
    chain = cs.wr_system(itt, ("chain", "chain", "euler"), F32)
    assert fused_rollout.params_buffer(chain).numel() == 9 + 16 + 16 * 16


def test_device_model_takes_every_form():
    """The model ids and integrator ids of each kind: LTI 7, the spring
    chain 8, tracking 16 + the base's, rate 32 + the base's with the
    base's integrator; the implicit rules of the later models."""
    ids = {c: fused_rollout.device_model(cs.wr_system(itt, c, F32))
           for c in CASES}
    integ = {"euler": 0, "midpoint": 1, "rk4": 2, "backward_euler": 3,
             "trapezoidal": 4, "discrete": 5}
    base_id = {"pendulum": 0, "ua_dp": 1, "dp": 1, "cartpole": 2,
               "quadrotor": 3, "quadrotor3d": 4, "quadrotor3d_rotor": 5,
               "car": 6}
    for (kind, base, i), got in ids.items():
        b = 7 if base.startswith("lti") else base_id.get(base, 8)
        want = {"lti": 7, "chain": 8, "model": b, "tracking": 16 + b,
                "rate": 32 + b}[kind]
        assert got == (want, integ[i]), (kind, base, i)
    assert len(ids) == 119


def _refused():
    pend = cs.wr_base(itt, "pendulum", "rk4", F32)
    rotor = cs.wr_base(itt, "quadrotor3d_rotor", "rk4", F32)
    lti16 = cs.wr_base(itt, "lti_16x4", "rk4", F32)
    rate_pend = itt.make_rate_penalized_system(pend, np.eye(1))
    eye = np.eye
    return {
        "tracked rotor variant (17 states)": itt.make_tracking_system(
            rotor, torch.zeros((5, 16)), torch.zeros((4, 4)), eye(16),
            eye(4), eye(16)),
        "rated rotor variant (20 states)": itt.make_rate_penalized_system(
            rotor, eye(4)),
        "tracked LTI (16, 4)": itt.make_tracking_system(
            lti16, torch.zeros((5, 16)), torch.zeros((4, 4)), eye(16),
            eye(4), eye(16)),
        "LTI (3, 1)": itt.make_lti(eye(3), np.ones((3, 1)), 0.1,
                                   np.zeros(3), eye(3), eye(1), eye(3),
                                   **F32),
        "pendulum under 'discrete'": pend.with_integrator("discrete"),
        "tracking over backward Euler": itt.make_tracking_system(
            pend.with_integrator("backward_euler"), torch.zeros((5, 2)),
            torch.zeros((4, 1)), eye(2), eye(1), eye(2)),
        "rate over trapezoidal": itt.make_rate_penalized_system(
            pend.with_integrator("trapezoidal"), eye(1)),
        "tracking over a rate wrapper": itt.make_tracking_system(
            rate_pend, torch.zeros((5, 3)), torch.zeros((4, 1)), eye(3),
            eye(1), eye(3)),
        "rate over a rate wrapper": itt.make_rate_penalized_system(
            rate_pend, eye(1)),
        "spring chain of 2 masses": itt.make_spring_chain(
            0.02, n_masses=2, **F32),
        "spring chain under backward Euler": itt.make_spring_chain(
            0.02, integrator="backward_euler", **F32),
        "pendulum with another stage cost": pend.replace(
            stage_cost=lambda p, x, u: (x * x).sum(-1)),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_device_model_refuses_with_roadmap_item(name):
    """What no instantiation takes raises NotImplementedError naming
    ROADMAP item B2x, in B2's launchers and in B5's, before any launch."""
    system = _refused()[name]
    with pytest.raises(NotImplementedError, match="B2x"):
        fused_rollout.device_model(system)
    with pytest.raises(NotImplementedError, match="B2x"):
        fused_rollout.launch_open_loop(None, system,
                                       torch.zeros(system.n_x),
                                       torch.zeros((3, system.n_u)), 0)
    with pytest.raises(NotImplementedError, match="B2x"):
        batched.launch_trajectory(None, system, torch.zeros(2, system.n_x),
                                  None, None,
                                  torch.zeros((2, 3, system.n_u)), None,
                                  None, 0)


IMPLICIT_CASES = [c for c in CASES if c[0] == "model"]


@pytest.mark.parametrize("case", IMPLICIT_CASES,
                         ids=["-".join(c) for c in IMPLICIT_CASES])
def test_b5_refuses_the_implicit_rules_that_b2_takes(case):
    """The implicit rules of the later models run through B2 only, as JAX's
    batched kernel runs no implicit rule: B5's three entries raise naming
    ROADMAP item B2x before any launch, while the pendulum's implicit rule
    still reaches B5 (a stand-in library records its launch)."""
    system = cs.wr_system(itt, case, F32)
    assert fused_rollout.device_model(system)[1] in (3, 4)
    x0s = torch.zeros(2, system.n_x)
    U = torch.zeros((2, 3, system.n_u))
    X = torch.zeros((2, 4, system.n_x))
    K = torch.zeros((2, 3, system.n_u, system.n_x))
    for launch in (
            lambda: batched.launch_costs(None, system, x0s, torch.ones(1), X,
                                         U, U, K, 0),
            lambda: batched.launch_trajectory(None, system, x0s,
                                              torch.ones(2), X, U, U, K, 0),
            lambda: batched.launch_trajectory(None, system, x0s, None, None,
                                              U, None, None, 0)):
        with pytest.raises(NotImplementedError, match="B2x"):
            launch()

    class StandIn:
        calls = []

        def ilqr_open_loop_rollout_batched(self, *args):
            self.calls.append(args[:2])
            return 0

    pend = cs.wr_base(itt, "pendulum", case[2], F32)
    batched.launch_trajectory(StandIn(), pend, torch.zeros(2, 2), None, None,
                              torch.zeros((2, 3, 1)), None, None, 0)
    assert StandIn.calls == [fused_rollout.device_model(pend)]
