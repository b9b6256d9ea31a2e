"""chip_smoke.py phase 36's P7 gradient gate, on the CPU.

P7 holds the port's f32 inverse-optimal-control gradient
(examples_torch/inverse_optimal_control.py at full size: pendulum rk4,
N = 60, four demonstrations, maxiter 150, tol 1e-9, at log_w = 0) through
the kernels to the same gradient under the sequential engines, and both to
JAX's f32 gradient (``JAX_F32['p7']``, recomputed by
test_torch_chip_refs.py), within ``RTOL_P7`` of max |g|.  Here the port
runs on CPU tensors under the sequential engines and under
``backward='pallas', rollout='pallas'`` (the kernels' plain versions), and
both are held to that constant within the tolerance the chip applies, on
the loss of all four demonstrations and on that of ``P7_SEQ_DEMOS``
(``JAX_F32['p7_sub']``).
"""
import ast
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ilqr_tpu_torch as itt
from examples_torch import inverse_optimal_control as ioc

torch.set_num_threads(2)

CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _constants():
    out = {}
    for node in ast.parse(CHIP_SMOKE.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("JAX_F32", "RTOL_P7", "RTOL_P7_LOSS",
                        "P7_SEQ_DEMOS"):
                out[name] = ast.literal_eval(node.value)
    return out


@pytest.mark.parametrize("engines", [("scan", "scan"),
                                     ("pallas", "pallas")])
def test_ioc_gradient_within_the_chip_gate_of_jax(engines):
    c = _constants()
    loss_j, g_j = c["JAX_F32"]["p7"][0], np.array(c["JAX_F32"]["p7"][1:])
    cfg = itt.IlqrConfig(maxiter=150, tol=1e-9, backward=engines[0],
                         rollout=engines[1])
    p = ioc.problem("cpu", torch.float32, cfg)
    assert p.N == 60 and p.config.maxiter == 150
    demo = ioc.demonstrations(p)
    loss, g, sols = ioc.loss_and_grad(p, p.log_w0, demo)
    # tol 1e-9 sits below the f32 cost's resolution: a solve stops
    # CONVERGED or, at that floor, LINESEARCH_FAILED; never at maxiter.
    assert all(int(s.status) != itt.MAXITER for s in sols)
    err = np.abs(g.numpy() - g_j).max() / np.abs(g_j).max()
    assert err <= c["RTOL_P7"], (g.tolist(), g_j.tolist(), err)
    assert abs(float(loss) - loss_j) <= c["RTOL_P7_LOSS"] * loss_j
    # The loss over P7_SEQ_DEMOS alone, which P7 also holds to the
    # sequential engines on the card.
    demos = list(c["P7_SEQ_DEMOS"])
    sub = SimpleNamespace(**{**vars(p), "x0s": p.x0s[demos]})
    loss_s, g_s, _ = ioc.loss_and_grad(sub, p.log_w0, demo[demos])
    loss_sj = c["JAX_F32"]["p7_sub"][0]
    g_sj = np.array(c["JAX_F32"]["p7_sub"][1:])
    err = np.abs(g_s.numpy() - g_sj).max() / np.abs(g_sj).max()
    assert err <= c["RTOL_P7"], (g_s.tolist(), g_sj.tolist(), err)
    assert abs(float(loss_s) - loss_sj) <= c["RTOL_P7_LOSS"] * loss_sj
