"""Sample-sharded MPPI via shard_map.

``mppi_step`` already threads ``axis_name`` through its reductions
(ops/softmax_update.py); here it is wrapped in ``jax.shard_map`` over the
"samples" mesh axis. Each shard draws its own noise (per-shard fold_in of the
cycle key), rolls out K/N trajectories, and the softmax update is globally
exact via pmin + two psums (NCCL all-reduces on GPUs). Every output is replicated, so the
controller state stays identical on all devices — bit-equivalent to a
single-device run fed the concatenated noise (tests/test_sharding.py).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ccv_mppi_path_tracker_tpu.core.config import SolverConfig
from ccv_mppi_path_tracker_tpu.parallel.mesh import SAMPLES_AXIS
from ccv_mppi_path_tracker_tpu.runtime.plant import Plant
from ccv_mppi_path_tracker_tpu.solver.mppi import mppi_step


def build_sharded_step(
    cfg: SolverConfig,
    mesh: Mesh,
    axis: str = SAMPLES_AXIS,
    use_kernel: bool = False,
    solver_options: Optional[dict] = None,
):
    """Jitted sample-sharded control step over ``mesh``.

    Returns ``step(ctrl, state, path, dt, sp, cp, model_params=None,
    noise=None)``. ``noise``, when given for parity tests, must be the full
    (T-1, K, U) tensor; it is split over the sample axis. All other inputs and
    all outputs are replicated. ``use_kernel`` runs the per-shard pipeline as
    the fused Pallas kernel (any per-shard K/N: the kernel masks the padded
    tail of its last block).
    ``solver_options`` forwards extra mppi_step keywords (shift_warm_start,
    delay, adapt_sigma, elite_frac, ...); elite_frac selects elites by
    GLOBAL cost rank across all shards (ops/softmax_update.py
    elite_threshold), matching single-device exactly.
    """
    n = mesh.shape[axis]
    if cfg.num_samples % n != 0:
        raise ValueError(
            f"num_samples={cfg.num_samples} not divisible by mesh size {n}"
        )
    k_local = cfg.num_samples // n

    rep = P()

    def local_step(ctrl, state, path, dt, sp, cp, model_params, noise):
        return mppi_step(
            cfg,
            ctrl,
            state,
            path,
            dt,
            sp,
            cp,
            model_params=model_params,
            noise=noise,
            axis_name=axis,
            num_samples=k_local,
            use_kernel=use_kernel,
            **(solver_options or {}),
        )

    # check_vma stays on for the XLA pipeline; the pallas_call has no vma
    # rule for its internals, so checking is relaxed there (its results are
    # verified against the XLA path in tests and chip_smoke.py --multi).
    check_vma = not use_kernel
    with_noise = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(rep, rep, rep, rep, rep, rep, rep, P(None, axis, None)),
            out_specs=rep,
            check_vma=check_vma,
        )
    )
    with_rng = jax.jit(
        jax.shard_map(
            lambda ctrl, state, path, dt, sp, cp, mp: local_step(
                ctrl, state, path, dt, sp, cp, mp, None
            ),
            mesh=mesh,
            in_specs=(rep,) * 7,
            out_specs=rep,
            check_vma=check_vma,
        )
    )

    def step(ctrl, state, path, dt, sp, cp, model_params=None, noise=None):
        if noise is None:
            return with_rng(ctrl, state, path, dt, sp, cp, model_params)
        return with_noise(ctrl, state, path, dt, sp, cp, model_params, noise)

    return step


def build_sharded_simulate(
    cfg: SolverConfig,
    mesh: Mesh,
    num_steps: int,
    plant: Optional[Plant] = None,
    axis: str = SAMPLES_AXIS,
    use_kernel: bool = False,
):
    """Closed-loop fused scan with the controller sample-sharded over ``mesh``.

    The plant runs replicated (it is a single robot); only the K rollouts are
    distributed. Returns ``sim(ctrl, state0, path, dt, sp, cp,
    model_params=None) -> (ctrl, logs)`` like build_simulate_scan.
    """
    n = mesh.shape[axis]
    if cfg.num_samples % n != 0:
        raise ValueError(
            f"num_samples={cfg.num_samples} not divisible by mesh size {n}"
        )
    k_local = cfg.num_samples // n
    if plant is None:
        plant = Plant(model_name=cfg.model)

    def local_sim(ctrl, state0, path, dt, sp, cp, model_params):
        def body(carry, _):
            ctrl, state = carry
            plant_key = jax.random.fold_in(ctrl.key, 1)
            ctrl, res = mppi_step(
                cfg,
                ctrl,
                state,
                path,
                dt,
                sp,
                cp,
                model_params=model_params,
                axis_name=axis,
                num_samples=k_local,
                use_kernel=use_kernel,
            )
            state = plant.step(plant_key, state, res.u0, dt)
            log = {"state": state, "u0": res.u0}
            log.update(res.stats)
            return (ctrl, state), log

        (ctrl, _), logs = jax.lax.scan(body, (ctrl, state0), None, length=num_steps)
        return ctrl, logs

    rep = P()
    sim = jax.shard_map(
        local_sim, mesh=mesh, in_specs=(rep,) * 7, out_specs=rep,
        check_vma=not use_kernel,
    )

    @jax.jit
    def run(ctrl, state0, path, dt, sp, cp, model_params=None):
        return sim(ctrl, state0, path, dt, sp, cp, model_params)

    return run
