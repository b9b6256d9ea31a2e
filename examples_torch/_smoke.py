"""Smoke-mode switch for the port's example drivers.

``ILQR_TPU_SMOKE=1`` shrinks every driver's expensive knobs (horizons,
iteration budgets, simulated steps) to test size, as `examples/_smoke.py`
does for the JAX drivers; ``tests/test_torch_examples_smoke.py`` runs every
driver so.  The variable is read at each call, so one process can run a
driver at both sizes.
"""
import os


def smoke() -> bool:
    """Whether ILQR_TPU_SMOKE=1 is set."""
    return os.environ.get("ILQR_TPU_SMOKE") == "1"


def sm(full, smoke_value):
    """``full`` normally; ``smoke_value`` under ILQR_TPU_SMOKE=1."""
    return smoke_value if smoke() else full
