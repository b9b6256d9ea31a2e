"""Grey-box system identification and control, on the port.

The twin of `examples/neural_sysid.py`.  The true pendulum is strongly
damped (d = 0.5, l = 1.0); the nominal model believes l = 1.6 and no
damping.  Excite the plant over the swing-up's state range (32 sinusoidal
torque rollouts of 60 steps from large angles and rates), fit an MLP
residual (32, 32) on the nominal dynamics (`models/neural.py`) to 10-step
prediction error with Adam (1000 steps), then compare closed-loop MPC on
the true plant (H = 40, 80 steps, maxiter 8) planning with

  1. the wrong nominal model,
  2. the learned model (nominal + MLP residual),
  3. the true model (the oracle's floor).

Every solve runs through the kernels (``backward='pallas',
rollout='pallas'``): B1, and B2 on the learned model's device form
(`csrc/forms.cuh`, NeuralForm).  The excitation is
`examples/neural_sysid.py`'s own draws (`JAX_DRAWS`); the hidden layers
come from a torch generator seeded with 1.  Run from the repository root:

    python examples_torch/neural_sysid.py                 # on the GPU
    ILQR_TPU_SMOKE=1 python examples_torch/neural_sysid.py --cpu
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from examples_torch._smoke import sm  # noqa: E402
import time
from types import SimpleNamespace

import numpy as np
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.models.base import DEFAULT_DEVICE
from ilqr_tpu_torch.models.neural import prediction_loss
from ilqr_tpu_torch.mpc import run_mpc

DT = 0.05


def make(d, l=1.0, device=DEFAULT_DEVICE, dtype=torch.float32):
    return itt.make_pendulum(
        DT, [np.pi, 0.0], Q=np.diag([5.0, 0.5]), R=0.1 * np.eye(1),
        Q_f=np.diag([50.0, 5.0]), d=d, l=l, integrator="rk4", device=device,
        dtype=dtype)


# The excitation of `examples/neural_sysid.py` and tests/test_neural.py:
# JAX's draws from jax.random.key(0) split four ways (amplitudes in [1, 6),
# frequencies in [0.5, 3) rad/s, initial angles in [-3, 3) and rates in
# [-4, 4)), as float32 values: tests/test_neural.py validated its gates
# (the fitted loss below a hundredth of its start, the MPC costs) on these
# draws, and other draws of the same ranges need not meet them.  The smoke
# size takes the first four.
JAX_DRAWS = dict(
    amps=(5.2115707, 1.9118932, 2.1358905, 1.6036282, 1.9590673, 4.610075,
        4.827228, 1.7627022, 5.7585316, 1.1465523, 1.4935527,
        3.7657163, 1.6222355, 3.9728103, 5.797454, 4.466136,
        4.6204796, 2.5908217, 5.100357, 4.2051315, 2.3149338,
        1.96008, 4.8794527, 5.280379, 5.0907755, 2.5562325,
        5.0643096, 5.7502766, 1.0296849, 4.35338, 5.827077,
        1.6018502),
    freqs=(0.51823455, 0.552228, 1.9535663, 1.4045949, 1.0575943, 0.7982208,
        0.8135973, 2.042075, 0.73751825, 2.9585562, 1.5620552,
        2.5812001, 0.74153024, 1.0675521, 1.3864369, 2.1776035,
        0.79241085, 1.6809826, 0.92380303, 0.5626755, 0.8359112,
        1.4343109, 2.770738, 2.4791803, 0.8081599, 1.2337046,
        2.4760146, 2.8774939, 1.3528903, 1.8037199, 1.1459174,
        0.5964105),
    theta0=(2.414697, 2.473757, -0.95371413, -1.6794534, 0.8902602,
        0.045211315, 1.303226, -1.6461532, 0.54611206, -2.5908093,
        -1.9183538, 2.767873, -1.9883265, -1.001293, 1.7551932,
        2.3092017, -0.257452, -1.8999074, 2.4935017, 0.31056333,
        -1.3345206, -1.0662403, -1.2880611, 0.6527517,
        -0.39400935, 2.7126195, -1.5730441, 2.8744483, 1.998097,
        -2.7443583, -2.0695903, -0.75606894),
    omega0=(-1.8640842, 1.8716011, 3.6297846, -2.3236675, -3.9281168,
        2.5188742, 3.4259195, -1.7940397, 3.093709, 3.4399595,
        -3.6755428, -1.447092, -2.2408428, -2.6726055, 3.8557234,
        0.7388506, 1.6585274, -2.6721096, 2.3152285, 1.6285028,
        3.522913, -1.17591, -2.609562, -1.5712624, -3.9092493,
        -3.5053406, 2.209199, 1.2659531, -1.5501261, 2.8685484,
        -2.6169424, -3.8003454))


def excitation(plant, B, N):
    """(X (B, N+1, 2), U (B, N, 1)): rollouts of the plant under the
    sinusoidal torques of `JAX_DRAWS`' first B draws."""
    d = {k: torch.tensor(v[:B], dtype=plant.dtype, device=plant.device)
         for k, v in JAX_DRAWS.items()}
    t = torch.linspace(0.0, N * plant.dt, N, dtype=plant.dtype,
                       device=plant.device)
    U = (d["amps"][:, None] * torch.sin(d["freqs"][:, None] * t))[..., None]
    x0s = torch.stack([d["theta0"], d["omega0"]], dim=1)
    X, _ = itt.rollout(plant, x0s, U)
    return X, U


def problem(device=DEFAULT_DEVICE, dtype=torch.float32) -> SimpleNamespace:
    plant = make(0.5, 1.0, device, dtype)        # the truth
    nominal = make(0.0, 1.6, device, dtype)      # 60 % too long, undamped
    X, U = excitation(plant, sm(32, 4), sm(60, 10))
    net = itt.make_neural_residual(
        nominal, hidden=(32, 32), generator=torch.Generator().manual_seed(1))
    opts = dict(dtype=dtype, device=device)
    return SimpleNamespace(
        plant=plant, nominal=nominal, net=net, X=X, U=U, horizon=10,
        fit=dict(steps=sm(1000, 20), learning_rate=3e-3, horizon=10),
        x0=torch.zeros(2, **opts), U0=torch.zeros((sm(40, 8), 1), **opts),
        n_sim=sm(80, 6),
        config=itt.IlqrConfig(maxiter=sm(8, 3), tol=1e-6, backward="pallas",
                              rollout="pallas"))


def main(plot=False, device=DEFAULT_DEVICE, dtype=torch.float32):
    p = problem(device, dtype)
    loss0 = prediction_loss(p.net, p.X, p.U, horizon=p.horizon)
    print(f"10-step prediction MSE before fit: {float(loss0):.2e}")
    t0 = time.perf_counter()
    net, losses = itt.fit_dynamics(p.net, p.X, p.U, **p.fit)
    loss1 = prediction_loss(net, p.X, p.U, horizon=p.horizon)
    print(f"10-step prediction MSE after fit:  {float(loss1):.2e}  "
          f"({time.perf_counter() - t0:.1f} s, {p.fit['steps']} Adam steps)")

    mpc = {}
    for name, model in [("nominal", p.nominal), ("learned", net),
                        ("oracle", p.plant)]:
        res = run_mpc(model, p.plant, p.x0, p.U0, p.n_sim, p.config)
        mpc[name] = res
        x = res.X[-1].cpu().numpy()
        print(f"MPC with the {name:8s} model: closed-loop cost "
              f"{float(res.cost):8.3f}, final state [{x[0]:+.3f} "
              f"{x[1]:+.3f}] (target [+3.142 +0.000])")

    if plot:
        from ilqr_tpu_torch.viz.plots import plot_trajectory

        out = _os.path.join(_os.path.dirname(__file__), "out")
        _os.makedirs(out, exist_ok=True)
        plot_trajectory(mpc["learned"].X, mpc["learned"].U, DT,
                        x_target=[np.pi, 0.0], state_labels=["θ", "θ̇"],
                        title="MPC through the learned model",
                        save_path=_os.path.join(out, "neural_sysid.png"))
    return SimpleNamespace(net=net, losses=losses, loss0=loss0, loss1=loss1,
                           mpc=mpc)


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in _sys.argv else DEFAULT_DEVICE)
