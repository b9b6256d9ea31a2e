"""Models of the port (counterpart of `ilqr_tpu/models/__init__.py`)."""
from ilqr_tpu_torch.models.base import (
    System, INTEGRATORS, full_f32_matmuls, quad_form,
    quadratic_cost_params, quadratic_stage_cost, quadratic_terminal_cost,
)
from ilqr_tpu_torch.models.pendulum import make_pendulum
from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum
