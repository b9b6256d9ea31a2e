"""B2's and B5's device form for the neural residual, without a GPU.

`csrc/forms.cuh` (NeuralForm) with `csrc/neural_models.cu` and
`neural_lti.cu` is compiled with g++ through `test_torch_batched_host.py`'s
fixture (`MOCK_RUNTIME`, the `MOCK_ASYNC_COPY` mbarrier model, a ring of 2
stages of 8 steps), so that N = 17 and 33 cross several chunk edges.  Two
bases (the pendulum, n_x = 2, its costs in registers; the 3-D quadrotor,
n_x = 12, its costs in the block's shared copy) with two MLPs ((32, 32) and
(64, 64, 64), random output layers) run B2's three entries with 1, 10 and
33 alphas at N = 1, 17 and 33, and B5's three on 3 instances; each result
is held to the plain rollouts in f64 within 1e-5 of each output's max, or
4 times the plain version's own f32 error (`chip_smoke.F32_FLOOR`), and a
repeated call gives the same bits.  A zero output layer gives the base
form's bits; an MLP without hidden layers over an LTI base runs under
'discrete'; the parameter buffer's layout; what `device_model` refuses,
naming ROADMAP item B2x.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models import neural, quadrotor3d
from ilqr_tpu_torch.ops import batched, fused_rollout
from ilqr_tpu_torch.utils.tree import map_leaves
from test_torch_batched_host import RTOL, _twice, host_lib  # noqa: F401

torch.set_num_threads(1)

F32 = dict(dtype=torch.float32, device="cpu")
B5_INSTANCES = 3


def _base(name, integrator="rk4"):
    if name == "pendulum":
        return itt.make_pendulum(0.05, [np.pi, 0.0], np.diag([5.0, 0.5]),
                                 0.1 * np.eye(1), np.diag([50.0, 5.0]),
                                 integrator=integrator, **F32)
    Q, R, Q_f = quadrotor3d.default_weights(**F32)
    return itt.make_quadrotor3d(0.005, [1.0, 0.5, 1.0] + [0.0] * 9, Q, R,
                                Q_f, integrator=integrator, **F32)


def _net(base, hidden, seed, out_scale=0.05):
    """A residual over ``base`` whose output layer is drawn too (scale
    ``out_scale``), so that the MLP moves the dynamics."""
    net = neural.make_neural_residual(
        base, hidden=hidden, generator=torch.Generator().manual_seed(seed))
    layers = [dict(layer) for layer in net.params["mlp"]]
    gen = torch.Generator().manual_seed(seed + 1)
    layers[-1]["W"] = out_scale * torch.randn(layers[-1]["W"].shape,
                                              generator=gen)
    layers[-1]["b"] = out_scale * torch.randn(layers[-1]["b"].shape,
                                              generator=gen)
    for layer in layers[:-1]:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen)
    return net.replace(params={**net.params, "mlp": layers})


def _nominal(system, name, N, seed, batch=None):
    """(x0, X, U, u_ff, K): phase 28's seeded draws for the base
    (`chip_smoke.nominal_draws`), rolled out; ``batch`` instances stacked."""
    draws = [cs.nominal_draws(system, name, N, seed + b, F32)
             for b in range(batch or 1)]
    x0, U, u_ff, K = (torch.stack(t).contiguous() if batch else t[0]
                      for t in zip(*draws))
    X, _ = itt.rollout(system, x0, U)
    return x0, X.contiguous(), U.contiguous(), u_ff, K.contiguous()


def _f64(system):
    return system.replace(params=map_leaves(torch.Tensor.double,
                                            system.params))


def _plain(system, dtype, x0, alphas, X, U, u_ff, K):
    if dtype == torch.float64:
        system = _f64(system)
    x0, alphas, X, U, u_ff, K = (t.to(dtype)
                                 for t in (x0, alphas, X, U, u_ff, K))
    return (itt.linesearch_rollouts(system, x0, alphas, X, U, u_ff, K),
            itt.rollout(system, x0, U))


def _close(got, ref, ref32):
    """Each output within RTOL of its max against the f64 plain version,
    or within F32_FLOOR times the plain version's own f32 error."""
    for g, r, r32 in zip(got, ref, ref32):
        r = r.double()
        assert g.shape == r.shape
        err = float((g.double() - r).abs().max())
        floor = float((r32.double() - r).abs().max())
        assert err <= max(RTOL * float(r.abs().max()),
                          cs.F32_FLOOR * floor, 1e-30), (err, floor)


def _check_b2(lib, system, nominal, alphas):
    x0, X, U, u_ff, K = nominal
    (ref, ref_o), (r32, r32_o) = (_plain(system, d, x0, alphas, X, U, u_ff, K)
                                  for d in (torch.float64, torch.float32))
    got = _twice(lambda: (fused_rollout.launch_costs(
        lib, system, x0, alphas, X, U, u_ff, K, 0),))
    _close(got, (ref[2],), (r32[2],))
    a = alphas.numel() // 2
    got = _twice(lambda: fused_rollout.launch_trajectory(
        lib, system, x0, float(alphas[a]), X, U, u_ff, K, 0))
    _close(got, tuple(r[a] for r in ref), tuple(r[a] for r in r32))
    got = _twice(lambda: fused_rollout.launch_open_loop(lib, system, x0, U,
                                                        0))
    _close(got, ref_o, r32_o)


def _check_b5(lib, system, nominal, alphas):
    x0s, X, U, u_ff, K = nominal
    (ref, ref_o), (r32, r32_o) = (
        _plain(system, d, x0s, alphas, X, U, u_ff, K)
        for d in (torch.float64, torch.float32))
    got = _twice(lambda: (batched.launch_costs(
        lib, system, x0s, alphas, X, U, u_ff, K, 0),))
    _close(got, (ref[2],), (r32[2],))
    b = torch.arange(x0s.shape[0])
    a = b % alphas.numel()
    got = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, alphas[a].contiguous(), X, U, u_ff, K, 0))
    _close(got, tuple(r[b, a] for r in ref), tuple(r[b, a] for r in r32))
    got = _twice(lambda: batched.launch_trajectory(
        lib, system, x0s, None, None, U, None, None, 0)[::2])
    _close(got, ref_o, r32_o)


CASES = [("pendulum", (32, 32)), ("pendulum", (64, 64, 64)),
         ("quadrotor3d", (32, 32)), ("quadrotor3d", (64, 64, 64))]


@pytest.mark.parametrize("A", [1, 10, 33])
@pytest.mark.parametrize("N", [1, 17, 33])
@pytest.mark.parametrize("name,hidden", CASES,
                         ids=[f"{n}-{len(h)}x{h[0]}" for n, h in CASES])
def test_neural_form_matches_the_plain_rollouts(host_lib, name, hidden, N,
                                                A):
    """B2a (A alphas), B2b at the middle alpha and the open loop; then
    B5's three entries on 3 instances, the trajectory entry at alphas
    b mod A."""
    system = _net(_base(name), hidden, seed=N + A)
    alphas = torch.tensor([0.5 ** i for i in range(A)])
    _check_b2(host_lib, system, _nominal(system, name, N, 7 + N), alphas)
    _check_b5(host_lib, system,
              _nominal(system, name, N, 7 + N, batch=B5_INSTANCES), alphas)


@pytest.mark.parametrize("integrator", ["euler", "midpoint", "rk4"])
def test_neural_form_runs_every_explicit_rule(host_lib, integrator):
    system = _net(_base("pendulum", integrator), (16, 8, 4, 2), seed=3)
    _check_b2(host_lib, system, _nominal(system, "pendulum", 17, 2),
              torch.tensor([1.0, 0.5, 0.25]))


def test_mlp_without_hidden_layers_over_lti_under_discrete(host_lib):
    """A linear residual (one layer) over the LTI (4, 2) under 'discrete':
    the map A x + B u plus the MLP, the wider LTI's matrices beside the
    weights in shared memory at (6, 2)."""
    for n_x, n_u in ((4, 2), (6, 2)):
        rng = np.random.default_rng(n_x)
        A = np.eye(n_x) + 0.05 * rng.standard_normal((n_x, n_x))
        lti = itt.make_discrete_lti(A, 0.1 * rng.standard_normal((n_x, n_u)),
                                    0.1, np.zeros(n_x), np.eye(n_x),
                                    np.eye(n_u), np.eye(n_x), **F32)
        system = _net(lti, (), seed=n_x)
        assert fused_rollout.device_model(system) == (
            fused_rollout.NEURAL + fused_rollout.LTI, 5)
        x0, U, u_ff = (torch.tensor(0.3 * rng.standard_normal(s), **F32)
                       for s in (n_x, (33, n_u), (33, n_u)))
        K = torch.tensor(-0.05 * rng.standard_normal((33, n_u, n_x)), **F32)
        X, _ = itt.rollout(system, x0, U)
        _check_b2(host_lib, system, (x0, X.contiguous(), U, u_ff, K),
                  torch.tensor([1.0, 0.5]))


@pytest.mark.parametrize("name", ["pendulum", "quadrotor3d"])
def test_zero_output_layer_gives_the_base_forms_bits(host_lib, name):
    """make_neural_residual's zero output layer: B2's three entries and
    B5's costs equal the base form's bit for bit."""
    base = _base(name)
    net = neural.make_neural_residual(base, hidden=(32, 32))
    x0, X, U, u_ff, K = _nominal(base, name, 33, 5)
    alphas = torch.tensor([1.0, 0.5, 0.25])
    lib = host_lib
    outs = [(fused_rollout.launch_costs(lib, s, x0, alphas, X, U, u_ff, K,
                                        0),
             *fused_rollout.launch_trajectory(lib, s, x0, 0.5, X, U, u_ff, K,
                                              0),
             *fused_rollout.launch_open_loop(lib, s, x0, U, 0),
             batched.launch_costs(lib, s, x0[None], alphas, X[None], U[None],
                                  u_ff[None], K[None], 0))
            for s in (base, net)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_parameter_buffer_is_the_forms_layout():
    """[the base's buffer, L, w_0 ... w_L, W_0, b_0, W_1, b_1, ...]."""
    base = _base("pendulum")
    net = _net(base, (5, 3), seed=1)
    buf = fused_rollout.params_buffer(net)
    head = fused_rollout.params_buffer(base)
    layers = net.params["mlp"]
    want = torch.cat([head, torch.tensor([3.0, 3.0, 5.0, 3.0, 2.0])]
                     + [t.reshape(-1) for layer in layers
                        for t in (layer["W"], layer["b"])])
    assert torch.equal(buf, want)
    assert fused_rollout.mlp_widths(layers) == [3, 5, 3, 2]


def test_device_model_takes_each_base_and_refuses_with_roadmap_item():
    """Every register model under the explicit rules is taken (id 64 +
    the base's); the implicit rules, a residual over a wrapper or another
    residual, deeper or wider MLPs, a physical base under 'discrete' and
    other costs raise NotImplementedError naming B2x (B5 too)."""
    pend = _base("pendulum")
    net = neural.make_neural_residual(pend, hidden=(64, 64, 64, 64))
    assert fused_rollout.device_model(net) == (fused_rollout.NEURAL, 2)
    assert batched.batched_model(net) == (fused_rollout.NEURAL, 2)
    q3 = neural.make_neural_residual(_base("quadrotor3d"))
    assert fused_rollout.device_model(q3.with_integrator("euler")) == (
        fused_rollout.NEURAL + 4, 0)
    refused = [
        net.with_integrator("backward_euler"),
        net.with_integrator("trapezoidal"),
        net.with_integrator("discrete"),
        neural.make_neural_residual(net),
        neural.make_neural_residual(
            itt.make_rate_penalized_system(pend, np.eye(1))),
        neural.make_neural_residual(pend, hidden=(65,)),
        neural.make_neural_residual(pend, hidden=(8,) * 5),
        net.replace(stage_cost=lambda p, x, u: (x * x).sum(-1)),
    ]
    for system in refused:
        for check in (fused_rollout.device_model, batched.batched_model):
            with pytest.raises(NotImplementedError, match="B2x"):
                check(system)
