"""Models of the port (counterpart of `ilqr_tpu/models/__init__.py`)."""
from ilqr_tpu_torch.models.base import (
    System, INTEGRATORS, full_f32_matmuls, quad_form,
    quadratic_cost_params, quadratic_stage_cost, quadratic_terminal_cost,
)
from ilqr_tpu_torch.models.pendulum import make_pendulum
from ilqr_tpu_torch.models.double_pendulum import make_double_pendulum
from ilqr_tpu_torch.models.cartpole import make_cartpole
from ilqr_tpu_torch.models.chain import make_spring_chain
from ilqr_tpu_torch.models.quadrotor import make_quadrotor, hover_controls
from ilqr_tpu_torch.models.quadrotor3d import (
    make_quadrotor3d, make_quadrotor3d_rotor,
)
from ilqr_tpu_torch.models.car import make_car, obstacle_constraints
from ilqr_tpu_torch.models.linear import (
    cont2disc, make_discrete_lti, make_lti,
)
from ilqr_tpu_torch.models.tracking import (
    make_tracking_system, augment_x0, strip_clock,
)
from ilqr_tpu_torch.models.neural import (
    fit_dynamics, make_neural_residual, prediction_loss,
)
from ilqr_tpu_torch.models.rate import (
    make_rate_penalized_system, rate_augment_x0, strip_rate,
)
