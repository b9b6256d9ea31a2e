from ilqr_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from ilqr_tpu_torch.utils.guards import assert_finite, finite_leaves, solve_checked
from ilqr_tpu_torch.utils.timing import compile_time, timed, trace, warmup

__all__ = ["warmup", "timed", "compile_time", "trace", "save_pytree",
           "load_pytree", "finite_leaves", "assert_finite", "solve_checked"]
