"""Trajectory plotting: host-side matplotlib over the port's tensors.

The port's copy of `ilqr_tpu/viz/plots.py` (the port imports nothing of the
JAX package): state-versus-target panels and a control panel, and the
convergence traces of a solution.  Tensors on any device come to the host
through ``.detach().cpu().numpy()``.  matplotlib is imported inside each
function, so the package imports without it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """``a`` (a tensor on any device, an array or a sequence) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_trajectory(
    X,
    U,
    dt: float,
    x_target=None,
    state_labels: Sequence[str] | None = None,
    control_labels: Sequence[str] | None = None,
    title: str = "iLQR solution",
    save_path: str | None = None,
    show: bool = False,
):
    """State/control panel plot. X: (N+1, n_x), U: (N, n_u) time-major."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X = _host(X)
    U = _host(U)
    n_x, n_u = X.shape[1], U.shape[1]
    t = np.arange(X.shape[0]) * dt

    fig, axs = plt.subplots(n_x + 1, 1, figsize=(9, 2.2 * (n_x + 1)), sharex=True)
    for i in range(n_x):
        lbl = state_labels[i] if state_labels else f"x[{i}]"
        axs[i].plot(t, X[:, i], label=lbl)
        if x_target is not None:
            axs[i].axhline(float(_host(x_target)[i]), ls="--", c="gray",
                           label="target")
        axs[i].set_ylabel(lbl)
        axs[i].legend(loc="upper right", fontsize=8)
        axs[i].grid(alpha=0.3)
    for j in range(n_u):
        lbl = control_labels[j] if control_labels else f"u[{j}]"
        axs[-1].step(t[:-1], U[:, j], where="post", label=lbl)
    axs[-1].set_ylabel("control")
    axs[-1].set_xlabel("time [s]")
    axs[-1].legend(loc="upper right", fontsize=8)
    axs[-1].grid(alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    if show:
        plt.show()
    return fig


def plot_convergence(solution, save_path: str | None = None, show: bool = False):
    """Cost / accepted-α / ‖u_ff‖∞ traces from an IlqrSolution."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cost = _host(solution.cost_trace)
    alpha = _host(solution.alpha_trace)
    grad = _host(solution.grad_trace)
    k = np.arange(len(cost))
    m = ~np.isnan(cost)

    fig, axs = plt.subplots(3, 1, figsize=(8, 7), sharex=True)
    if not m.any():
        # No accepted iterations (e.g. line search failed immediately) —
        # render empty axes rather than crash on the failed solve.
        fig.suptitle("iLQR convergence (no accepted iterations)")
        if save_path:
            fig.savefig(save_path, dpi=110)
        return fig
    axs[0].semilogy(k[m], cost[m] - cost[m].min() + 1e-12, ".-")
    axs[0].set_ylabel("cost − best")
    axs[1].semilogy(k[m], alpha[m], ".-")
    axs[1].set_ylabel("accepted α")
    axs[2].semilogy(k[m], grad[m], ".-")
    axs[2].set_ylabel("max |u_ff|")
    axs[2].set_xlabel("iteration")
    for ax in axs:
        ax.grid(alpha=0.3)
    fig.suptitle("iLQR convergence")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=110)
    if show:
        plt.show()
    return fig
