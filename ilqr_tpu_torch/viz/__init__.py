from ilqr_tpu_torch.viz.plots import plot_convergence, plot_trajectory

__all__ = ["plot_trajectory", "plot_convergence"]
