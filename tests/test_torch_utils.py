"""The port's utils (timing, guards, checkpoints) and viz.plots, on the CPU.

As tests/test_viz_utils.py holds `ilqr_tpu.utils`: `timed`/`warmup`/
`compile_time` return their outputs and positive times (the host clock on
CPU tensors); the guards find a NaN in a dataclass field, a dict entry and
a list item and name its path; an `IlqrSolution`, an `MpcResult` and a
warm-start dict round-trip through an .npz, tensors back on the donor's
dtype, Python numbers back as their type; `trace` writes a Chrome trace;
the plots render tensors to files.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from ilqr_tpu_torch.utils import (
    assert_finite,
    compile_time,
    finite_leaves,
    load_pytree,
    save_pytree,
    solve_checked,
    timed,
    trace,
    warmup,
)
from ilqr_tpu_torch.viz import plot_convergence, plot_trajectory

torch.set_num_threads(1)


def _pendulum(dtype=torch.float32):
    return itt.make_pendulum(0.01, [np.pi, 0.0], Q=np.eye(2), R=np.eye(1),
                             Q_f=np.eye(2), d=0.0, integrator="rk4",
                             device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def solution():
    sys_ = _pendulum()
    return sys_, itt.solve(sys_, [0.0, 0.0], torch.zeros((30, 1)),
                           itt.IlqrConfig(maxiter=5))


def test_timing_helpers(solution):
    sys_, sol = solution
    calls = []

    def fn(x, U):
        calls.append(1)
        return itt.rollout(sys_, x, U)

    x0, U = torch.zeros(2), sol.U
    X, _ = warmup(fn, x0, U)
    assert X.shape == (31, 2) and len(calls) == 1
    sec, (X2, cost) = timed(fn, x0, U, reps=3, warmup_reps=1)
    assert sec > 0 and len(calls) == 5
    torch.testing.assert_close(X2, X)
    assert compile_time(fn, x0, U) >= 0.0
    with pytest.raises(ValueError, match="reps"):
        timed(fn, x0, U, reps=0)


def test_guards(solution):
    sys_, sol = solution
    # The traces are nan-padded past the iterations the solve took.
    assert not bool(finite_leaves(sol))
    assert bool(finite_leaves(dataclasses.replace(
        sol, cost_trace=None, alpha_trace=None, grad_trace=None)))
    assert_finite((sol.X, sol.U, sol.cost), "sol")
    U_nan = sol.U.clone()
    U_nan[3] = float("nan")
    bad = dataclasses.replace(sol, U=U_nan)
    with pytest.raises(FloatingPointError, match=r"sol\.U"):
        assert_finite(dataclasses.replace(bad, cost_trace=None), "sol")
    with pytest.raises(FloatingPointError, match=r"warm\['lam'\]\[1\]"):
        assert_finite({"lam": [torch.zeros(2), torch.tensor([np.inf])],
                       "mu": 1.0}, "warm")
    assert bool(finite_leaves({"k": 3, "ok": True}))   # no floating leaves
    checked = solve_checked(sys_, [0.0, 0.0], torch.zeros((30, 1)),
                            itt.IlqrConfig(maxiter=5))
    torch.testing.assert_close(checked.U, sol.U)


def test_checkpoint_roundtrip(tmp_path, solution):
    sys_, sol = solution
    path = str(tmp_path / "sol")          # '.npz' appended, as np.savez does
    save_pytree(path, sol)
    assert os.path.exists(path + ".npz")
    back = load_pytree(path, sol)
    assert type(back) is type(sol)
    for f in dataclasses.fields(sol):
        a, b = getattr(sol, f.name), getattr(back, f.name)
        if torch.is_tensor(a):
            assert b.dtype == a.dtype and b.device == a.device
            torch.testing.assert_close(b, a, equal_nan=True)
        else:
            assert type(b) is type(a) and b == a, f.name

    res = itt.run_mpc(sys_, sys_, torch.zeros(2), torch.zeros((20, 1)), 3,
                      itt.IlqrConfig(maxiter=2))
    save_pytree(str(tmp_path / "mpc.npz"), res)
    back = load_pytree(str(tmp_path / "mpc.npz"), res)
    torch.testing.assert_close(back.X, res.X)
    torch.testing.assert_close(back.solve_iters, res.solve_iters)

    # A warm start in f64 on a donor in f64.
    warm = {"U": sol.U.double(), "mu": 10.0, "lam": [torch.ones(3)]}
    save_pytree(str(tmp_path / "warm"), warm)
    back = load_pytree(str(tmp_path / "warm"), warm)
    assert back["U"].dtype == torch.float64 and back["mu"] == 10.0
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "warm"), {"U": sol.U})


def test_trace_writes_a_chrome_trace(tmp_path, solution):
    sys_, sol = solution
    with trace(str(tmp_path)):
        itt.rollout(sys_, torch.zeros(2), sol.U)
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_plots_render(tmp_path, solution):
    pytest.importorskip("matplotlib")
    sys_, sol = solution
    fig = plot_trajectory(sol.X, sol.U, 0.01,
                          x_target=torch.tensor([np.pi, 0.0]),
                          save_path=str(tmp_path / "traj.png"))
    assert fig is not None and (tmp_path / "traj.png").exists()
    plot_convergence(sol, save_path=str(tmp_path / "conv.png"))
    assert (tmp_path / "conv.png").exists()
