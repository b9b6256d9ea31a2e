"""The port's learned dynamics (`ilqr_tpu_torch.models.neural`) against
`ilqr_tpu.models.neural`.

The two initializers draw from different generators, so every comparison
starts from JAX's layers carried across (`convert.neural_from_numpy`), its
output layer redrawn from a numpy seed so that the residual moves the
dynamics.  f64 references run under `enable_x64_oracle` on JAX's f32
system and layers cast to f64, the port on the same numbers.  Tolerances:
f_cont and one step under euler, midpoint, rk4 and backward Euler within
1e-6 (f32) and 1e-12 (f64) of max |x|; `prediction_loss` at horizons 1
and 10 within 1e-12 relative (f64); `fit_dynamics`'s loss trace and fitted
tensors within 1e-10 relative of optax's after 5 Adam steps (B = 4, N = 20,
'mlp' and 'all'; 3 steps under backward Euler, whose gradients go through
`newton_polish`); a neural `solve` and a `solve_batch` of 4 against JAX's
`solve` and `jax.vmap(solve)` (iterations equal, costs within 1e-10); the
gradient of `solve_implicit`'s loss with respect to the layers ((8,),
N = 25) within 1e-8 of max |g| of `jax.grad`'s.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu as it
from ilqr_tpu.diff import solve_implicit as jax_solve_implicit
from ilqr_tpu.models import neural as jn
from ilqr_tpu.utils.x64 import enable_x64_oracle

import ilqr_tpu_torch as itt
from ilqr_tpu_torch import convert
from ilqr_tpu_torch.diff import solve_implicit
from ilqr_tpu_torch.models import neural

torch.set_num_threads(1)

DT = 0.05
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def _jax_pendulum(d=0.1, l=1.0, integrator="rk4"):
    return it.make_pendulum(
        DT, [jnp.pi, 0.0], Q=jnp.diag(jnp.array([5.0, 0.5])),
        R=0.1 * jnp.eye(1), Q_f=jnp.diag(jnp.array([50.0, 5.0])), d=d, l=l,
        integrator=integrator)


def _jax_net(hidden=(16, 16), integrator="rk4", seed=3, out_scale=0.3):
    """JAX's residual with its output layer redrawn (f32)."""
    net = jn.make_neural_residual(_jax_pendulum(integrator=integrator),
                                  hidden=hidden, key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    mlp = [dict(layer) for layer in net.params["mlp"]]
    mlp[-1] = {k: jnp.asarray(out_scale * rng.standard_normal(v.shape),
                              jnp.float32) for k, v in mlp[-1].items()}
    return net.replace(params={**net.params, "mlp": mlp})


def _layers_np(jnet):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in jnet.params["mlp"]]


def _port(jnet, dtype):
    base_np = {k: np.asarray(v) for k, v in jnet.params["base"].items()}
    base = convert.system_from_numpy("pendulum", base_np, 2, 1, jnet.dt,
                                     jnet.integrator, device="cpu",
                                     dtype=dtype)
    return convert.neural_from_numpy(base, _layers_np(jnet))


def _f64(jnet):
    """JAX's system with its arrays in f64 (call under x64)."""
    return jnet.replace(params=jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), jnet.params))


def _jax_ctx(dtype):
    return (enable_x64_oracle() if dtype == torch.float64
            else contextlib.nullcontext())


def _data(B, N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (B, N + 1, 2))
    U = rng.uniform(-3.0, 3.0, (B, N, 1))
    return X, U


def test_zero_init_residual_is_identity():
    """A fresh residual's f_cont and rollout equal its base's bit for bit
    (the output layer is zero)."""
    base = itt.make_pendulum(DT, [np.pi, 0.0], np.eye(2), np.eye(1),
                             np.eye(2), d=0.1, device="cpu")
    net = itt.make_neural_residual(base, hidden=(16,))
    assert all(torch.equal(layer[k], torch.zeros_like(layer[k]))
               for layer in net.params["mlp"][-1:] for k in ("W", "b"))
    x, u = torch.tensor([0.7, -0.2]), torch.tensor([0.5])
    assert torch.equal(base.f_cont(base.params, x, u),
                       net.f_cont(net.params, x, u))
    x0, U = torch.tensor([0.3, 0.0]), 0.4 * torch.ones((30, 1))
    for a, b in zip(itt.rollout(base, x0, U), itt.rollout(net, x0, U)):
        assert torch.equal(a, b)
    assert net.params["base"] is base.params
    assert len(list(net.tensors())) == len(list(base.tensors())) + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("integrator",
                         ["euler", "midpoint", "rk4", "backward_euler"])
def test_dynamics_match_jax(integrator, dtype):
    jnet = _jax_net(integrator=integrator)
    net = _port(jnet, dtype)
    rng = np.random.default_rng(1)
    x = rng.uniform(-2.0, 2.0, (16, 2))
    u = rng.uniform(-3.0, 3.0, (16, 1))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with _jax_ctx(dtype):
        js = _f64(jnet) if dtype == torch.float64 else jnet
        fc, st = jax.jit(jax.vmap(lambda a, b: (
            js.f_cont(js.params, a, b), it.step(js, a, b))))(
                jnp.asarray(x, jdt), jnp.asarray(u, jdt))
        ref = [np.asarray(fc), np.asarray(st)]
    xt, ut = torch.tensor(x, dtype=dtype), torch.tensor(u, dtype=dtype)
    got = [net.f_cont(net.params, xt, ut), itt.step(net, xt, ut)]
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=TOL[dtype] * np.abs(r).max())


@pytest.mark.parametrize("horizon", [1, 10])
def test_prediction_loss_matches_jax(horizon):
    jnet = _jax_net()
    X, U = _data(3, 20)
    with enable_x64_oracle():
        ref = float(jax.jit(lambda X, U: jn.prediction_loss(
            _f64(jnet), X, U, horizon=horizon))(jnp.asarray(X),
                                                jnp.asarray(U)))
    got = neural.prediction_loss(_port(jnet, torch.float64), X, U,
                                 horizon=horizon)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-12)
    # Leading batch axes fold into the trajectories.
    again = neural.prediction_loss(_port(jnet, torch.float64),
                                   X.reshape(3, 1, 21, 2),
                                   U.reshape(3, 1, 20, 1), horizon=horizon)
    np.testing.assert_allclose(float(again), ref, rtol=1e-12)


def _held_fit(jfit, jlosses, fitted, losses, steps):
    assert losses.shape == (steps,) and losses.dtype == torch.float64
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-10)
    ref = jax.tree_util.tree_leaves(jfit.params)
    got = [fitted.params["base"][k] for k in sorted(fitted.params["base"])]
    got += [layer[k] for layer in fitted.params["mlp"] for k in ("W", "b")]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-10 * max(np.abs(r).max(), 1e-30))


@pytest.mark.parametrize("trainable", ["mlp", "all"])
def test_fit_matches_optax(trainable):
    """5 Adam steps (lr 1e-2, horizon 3) on B = 4, N = 20: optax's adam and
    torch's Adam share m̂ / (√v̂ + ε); 'all' moves g, l and d too (the cost
    tensors get zero gradients and stay)."""
    jnet = _jax_net()
    X, U = _data(4, 20, seed=2)
    kw = dict(steps=5, learning_rate=1e-2, trainable=trainable, horizon=3)
    with enable_x64_oracle():
        jfit, jlosses = jn.fit_dynamics(_f64(jnet), jnp.asarray(X),
                                        jnp.asarray(U), **kw)
    net = _port(jnet, torch.float64)
    fitted, losses = neural.fit_dynamics(net, X, U, **kw)
    _held_fit(jfit, jlosses, fitted, losses, 5)
    moved = float((fitted.params["base"]["l"] - net.params["base"]["l"]
                   ).abs())
    assert (moved > 1e-4) == (trainable == "all")
    # The given system is unchanged, its tensors out of any graph.
    assert all(not t.requires_grad for t in fitted.tensors())
    assert not torch.equal(fitted.params["mlp"][0]["W"],
                           net.params["mlp"][0]["W"])


def test_fit_under_backward_euler_matches_optax():
    """The implicit rule's gradient by `newton_polish` from the converged
    step (its autograd.Function has no reverse rule): 3 steps, horizon 2."""
    jnet = _jax_net(hidden=(8,), integrator="backward_euler")
    X, U = _data(2, 8, seed=4)
    kw = dict(steps=3, learning_rate=1e-2, horizon=2)
    with enable_x64_oracle():
        jfit, jlosses = jn.fit_dynamics(_f64(jnet), jnp.asarray(X),
                                        jnp.asarray(U), **kw)
    fitted, losses = neural.fit_dynamics(_port(jnet, torch.float64), X, U,
                                         **kw)
    _held_fit(jfit, jlosses, fitted, losses, 3)


def test_fit_validates_trainable():
    net = _port(_jax_net(), torch.float32)
    with pytest.raises(ValueError, match="trainable"):
        neural.fit_dynamics(net, np.zeros((2, 5, 2)), np.zeros((2, 4, 1)),
                            trainable="weights")


X0S = np.array([[0.1, 0.0], [0.2, 0.0], [0.3, 0.0], [0.4, 0.0]])


def test_solve_and_solve_batch_match_jax():
    """A (8,) residual at N = 25 in f64: `solve` from X0S[0] against JAX's
    and `solve_batch` of 4 against `jax.vmap(solve)`."""
    jnet = _jax_net(hidden=(8,), seed=2, out_scale=0.1)
    net = _port(jnet, torch.float64)
    N, cfg = 25, dict(maxiter=15, tol=1e-6)
    with enable_x64_oracle():
        js = _f64(jnet)
        U0 = jnp.zeros((N, 1))
        jcfg = it.IlqrConfig(**cfg)
        one = jax.jit(lambda x: it.solve(js, x, U0, jcfg))
        ref = jax.tree_util.tree_map(np.asarray, one(jnp.asarray(X0S[0])))
        refs = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jax.vmap(one))(jnp.asarray(X0S)))
    tcfg = itt.IlqrConfig(**cfg)
    sol = itt.solve(net, X0S[0], np.zeros((N, 1)), tcfg)
    sols = itt.solve_batch(net, X0S, np.zeros((4, N, 1)), tcfg)
    for got, want in ((sol, ref), (sols, refs)):
        np.testing.assert_array_equal(np.asarray(got.iterations),
                                      want.iterations)
        np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-10)
        np.testing.assert_allclose(got.X.numpy(), want.X, atol=1e-8)
        np.testing.assert_allclose(got.U.numpy(), want.U, atol=1e-7)


def test_solve_implicit_gradient_wrt_the_layers_matches_jax():
    """d/dθ_mlp of Σ U*² through `solve_implicit` ((8,), N = 25, f64): the
    zero... JAX test's story with a drawn output layer, every layer's W and
    b within 1e-8 of max |g| of `jax.grad` of JAX's."""
    jnet = _jax_net(hidden=(8,), seed=2, out_scale=0.1)
    N, x0 = 25, X0S[0]
    with enable_x64_oracle():
        js = _f64(jnet)
        cfg = it.IlqrConfig(maxiter=60, tol=1e-12)

        def loss(mlp):
            s = js.replace(params={**js.params, "mlp": mlp})
            sol = jax_solve_implicit(s, jnp.asarray(x0), jnp.zeros((N, 1)),
                                     cfg)
            return jnp.sum(sol.U ** 2)
        ref = jax.jit(jax.grad(loss))(js.params["mlp"])
        ref = [np.asarray(layer[k]) for layer in ref for k in ("W", "b")]
    net = _port(jnet, torch.float64)
    mlp = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
           for layer in net.params["mlp"]]
    sol = solve_implicit(net.replace(params={**net.params, "mlp": mlp}), x0,
                         np.zeros((N, 1)),
                         itt.IlqrConfig(maxiter=60, tol=1e-12))
    (sol.U ** 2).sum().backward()
    got = [layer[k].grad.numpy() for layer in mlp for k in ("W", "b")]
    scale = max(np.abs(r).max() for r in ref)
    assert scale > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-8 * scale)


def test_package_exports_and_conversion_checks():
    assert itt.make_neural_residual is neural.make_neural_residual
    assert itt.fit_dynamics is neural.fit_dynamics
    for name in ("make_neural_residual", "fit_dynamics", "prediction_loss",
                 "f_cont", "stage_cost", "terminal_cost", "_mlp_init",
                 "_mlp_apply"):
        assert hasattr(neural, name) and hasattr(jn, name)
    base = convert.system_from_numpy(
        "pendulum", {k: np.asarray(v)
                     for k, v in _jax_pendulum().params.items()},
        2, 1, DT, device="cpu")
    layers = _layers_np(_jax_net(hidden=(4,)))
    layers[0]["W"] = np.zeros((2, 4), np.float32)
    with pytest.raises(ValueError, match="layer of shape"):
        convert.neural_from_numpy(base, layers)
    # A generator draws the hidden layers; the default one is seeded.
    a = neural.make_neural_residual(base)
    b = neural.make_neural_residual(base)
    c = neural.make_neural_residual(
        base, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a.params["mlp"][0]["W"], b.params["mlp"][0]["W"])
    assert not torch.equal(a.params["mlp"][0]["W"], c.params["mlp"][0]["W"])
    assert [layer["W"].shape for layer in a.params["mlp"]] == [
        (3, 32), (32, 32), (32, 2)]
