"""Trajectory-optimization operators of the port (counterpart of
`ilqr_tpu/ops`): integrators, linearization, Riccati passes, rollouts and
the CUDA kernel wrappers."""
