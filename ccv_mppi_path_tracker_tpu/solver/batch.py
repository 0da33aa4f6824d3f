"""Fleet-scale batched control: many independent robots on one program.

The reference controls one robot per process. Here the whole solver is a
pure function, so a fleet of B robots — each with its own pose, warm start,
PRNG stream, and (optionally) its own course — is just ``vmap`` over the
controller state: one jitted program computes B complete MPPI updates
(B x K rollouts) per cycle. With B=256, K=1024 that is a quarter-million
trajectories per control tick on a single device — production serving shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ccv_mppi_path_tracker_tpu.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu.core.types import ControllerState
from ccv_mppi_path_tracker_tpu.models.registry import get_model
from ccv_mppi_path_tracker_tpu.solver.mppi import mppi_step


def init_fleet(cfg: SolverConfig, num_robots: int, seed: int = 0,
               dtype=jnp.float32) -> ControllerState:
    """Batched ControllerState: independent PRNG stream per robot."""
    model = get_model(cfg.model)
    keys = jax.random.split(jax.random.PRNGKey(seed), num_robots)
    return ControllerState(
        u_prev=jnp.zeros(
            (num_robots, cfg.horizon - 1, model.num_controls), dtype
        ),
        key=keys,
        step=jnp.zeros((num_robots,), jnp.int32),
    )


def build_fleet_step(cfg: SolverConfig, shared_path: bool = True,
                     use_kernel: bool = False, kernel_interpret: bool = False):
    """Jitted fleet step.

    Returns ``step(ctrls, states, path(s), dt, sp, cp, model_params=None)``
    where ctrls/states carry a leading robot axis; ``path`` is shared across
    the fleet when ``shared_path`` (one course, many robots) or per-robot
    batched otherwise. dt and params are shared.

    The fleet is ``jax.vmap`` over the single-robot step, on either solver
    path: with ``use_kernel`` the vmapped fused kernel gains a robot axis in
    its grid, so one launch covers B robots x K samples.
    """
    path_axis = None if shared_path else 0

    def one(ctrl, state, path, dt, sp, cp, model_params):
        return mppi_step(
            cfg, ctrl, state, path, dt, sp, cp, model_params=model_params,
            use_kernel=use_kernel, kernel_interpret=kernel_interpret,
        )

    vstep = jax.vmap(one, in_axes=(0, 0, path_axis, None, None, None, None))

    @jax.jit
    def step(ctrls, states, path, dt, sp, cp, model_params=None):
        return vstep(ctrls, states, path, dt, sp, cp, model_params)

    return step
