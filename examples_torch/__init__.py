"""The port's example drivers: PyTorch twins of the JAX package's
reference workloads in `examples/`, each with a ``problem(device, dtype)``
function that builds its problem and a ``main(plot=True, ...)`` that
returns its result."""
