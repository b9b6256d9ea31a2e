"""The port's constrained example drivers (examples_torch/
constrained_pendulum.py, constrained_mpc.py) in smoke mode, against the JAX
package's API on the same problems, as test_torch_examples_smoke.py holds
the reference workloads' drivers.
"""
import jax
import numpy as np
import torch

import ilqr_tpu as it
from ilqr_tpu import mpc as jax_mpc

from test_torch_examples_smoke import (
    _close,
    _jax_config,
    _jax_system,
    _jnp,
    smoke,  # noqa: F401  (the fixture)
)

torch.set_num_threads(1)


def _jax_box(cons):
    p = cons.params
    return it.box_control_constraints(_jnp(p["lo"]), _jnp(p["hi"]))


def test_constrained_pendulum_driver_matches_jax(smoke):
    mod = smoke("constrained_pendulum")
    sol = mod.main(plot=False, device="cpu", reps=1)
    p = mod.problem("cpu")
    cons = it.merge_constraints(_jax_box(p.box),
                                it.goal_constraint(_jnp(p.goal)))
    al = it.AlConfig(**{f: getattr(p.al_config, f) for f in (
        "max_outer", "ctol", "mu0", "mu_factor", "mu_max", "lam_max",
        "viol_decrease")})
    ref = jax.jit(lambda x, U: it.solve_constrained(
        _jax_system(p.system), cons, x, U, _jax_config(p.config), al))(
        _jnp(p.x0), _jnp(p.U0))
    assert (sol.status, sol.outer_iterations) == (
        int(ref.status), int(ref.outer_iterations))
    _close(sol.cost, ref.cost)


def test_constrained_mpc_driver_matches_jax(smoke):
    mod = smoke("constrained_mpc")
    out = mod.main(plot=False, device="cpu")
    p = mod.problem("cpu")
    solver, plant = _jax_system(p.solver), _jax_system(p.plant)
    box = _jax_box(p.constraints)
    x0, U0 = _jnp(p.x0), _jnp(p.U0)
    al = it.AlConfig(max_outer=p.al_config.max_outer,
                     ctol=p.al_config.ctol, mu0=p.al_config.mu0)
    refs = dict(
        al=jax.jit(lambda: jax_mpc.run_mpc_constrained(
            solver, plant, box, x0, U0, p.n_sim, _jax_config(p.config_al),
            al))(),
        barrier=jax.jit(lambda: jax_mpc.run_mpc_barrier(
            solver, plant, box, x0, U0, p.n_sim,
            _jax_config(p.config_barrier), **p.barrier))(),
        boxqp=jax.jit(lambda: jax_mpc.run_mpc(
            solver, plant, x0, U0, p.n_sim, _jax_config(p.config_boxqp)))())
    for key, ref in refs.items():
        # f32 inner iteration counts part at the tol boundary (3 against 2
        # in some steps); the closed-loop costs agree.
        _close(out[key].cost, ref.cost)
        assert float(out[key].U.abs().max()) <= p.lim + 1e-3
