"""Real-time host execution: native scheduler + gate + recorder + solver.

The production-shaped equivalent of the reference's node main loop
(ros::Rate(10) + spinOnce + publish, src/diff_drive_mppi.cpp:332-369): the
native absolute-deadline RateExecutor paces the cycle, the InputGate makes
stale-input policy explicit, the jitted solver produces the command, the
command geometry maps it to actuators, and the native background-thread CSV
recorder logs without blocking the control path. Deadline-miss and jitter
statistics come back with the results — the reference silently slips.
"""

from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ccv_mppi_path_tracker_tpu.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu.metrics.recorder import COLUMNS
from ccv_mppi_path_tracker_tpu.models.registry import get_model
from ccv_mppi_path_tracker_tpu.paths.resample import PathBuffer
from ccv_mppi_path_tracker_tpu.runtime.gating import InputGate
from ccv_mppi_path_tracker_tpu.runtime.loop import ControlLoop
from ccv_mppi_path_tracker_tpu.solver.command import (
    MODE_NO_NEED,
    command_from_solution,
    steering_mode,
)


def run_realtime_experiment(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course: np.ndarray,
    hz: float = 10.0,
    num_cycles: int = 100,
    record_path: Optional[str] = None,
    model_params=None,
    resolution: float = 0.1,
    lean: bool = True,
    use_kernel: bool = False,
):
    """Track ``course`` at a fixed wall-clock rate with an in-process plant.

    Returns {"metrics", "rate_stats", "logs"}. The plant is stepped with the
    measured dt (like the real robot integrating in real time).
    lean: run the solver in serving mode (StepResult carries only u_opt/u0;
    the control path here reads nothing else; solver/mppi.py ``lean``).
    use_kernel: solve via the fused Pallas kernel (GPU only).
    """
    from ccv_mppi_path_tracker_tpu.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu.runtime.native import (
        NativeCsvRecorder,
        RateExecutor,
    )

    path = PathBuffer.from_points(course, resolution, dtype=np.float32)
    opts = {}
    if lean:
        opts["lean"] = True
    if use_kernel:
        opts["use_kernel"] = True
    loop = ControlLoop(
        cfg=cfg, sp=sp, cp=cp, path=path, model_params=model_params,
        nominal_dt=1.0 / hz, solver_options=opts or None,
    )
    model = get_model(cfg.model)
    plant = get_model(cfg.model)

    gate = InputGate(stale_policy="hold")
    gate.add_channel("pose", max_age=3.0 / hz)

    rec = None
    if record_path is not None:
        rec = NativeCsvRecorder(record_path, COLUMNS)

    slope = math.atan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    state = jnp.asarray(
        [course[0, 0], course[0, 1], slope] + [0.0] * (model.num_states - 3),
        jnp.float32,
    )
    # Warm up (compile) before the schedule starts, then reset the controller
    # so the first real cycle is both on time and from a clean warm start.
    # The warmup must run the WHOLE first-cycle shape through to a host
    # fetch — a dispatched-but-unfetched warmup left the first timed cycle
    # blocking on compile+execute, which polluted the jitter statistic with
    # a ~10 s outlier.
    from ccv_mppi_path_tracker_tpu.core.types import ControllerState
    import jax as _jax

    warm_res = loop.step(state, dt=1.0 / hz)
    warm_cmd = command_from_solution(cfg.model, warm_res.u0, 1.0 / hz)
    steering_mode(warm_cmd.steer_r, warm_cmd.steer_l)
    np.asarray(plant.step(state, warm_res.u0, jnp.float32(1.0 / hz)))
    loop.ctrl = ControllerState.initial(
        _jax.random.PRNGKey(0), cfg.horizon, model.num_controls
    )
    loop._last_time = None

    rate = RateExecutor(hz)
    last_cmd = None
    traj = [np.asarray(state)]
    t = 0.0
    invalid_steer_cycles = 0
    for _ in range(num_cycles):
        dt = rate.sleep()
        gate.update("pose", state)
        res = loop.step(gate.get("pose"), dt=dt)
        cmd = command_from_solution(cfg.model, res.u0, dt)
        cmd = gate.resolve_command(cmd, last_cmd if last_cmd is not None else cmd)
        last_cmd = cmd
        # the reference flags opposite-sign measured steer angles on every
        # joint-state message (src/steering_diff_drive_mppi.cpp:75-76)
        if int(steering_mode(cmd.steer_r, cmd.steer_l)) == MODE_NO_NEED:
            invalid_steer_cycles += 1
        state = plant.step(state, res.u0, jnp.float32(dt))
        traj.append(np.asarray(state))
        t += dt
        if rec is not None:
            s = np.asarray(state)
            rec.row([
                t, s[0], s[1], float(cmd.w), s[2], s[0], s[1], float(cmd.v),
                float(cmd.v), float(cmd.steer_r), float(cmd.steer_l),
                float(cmd.roll), 0.0, 0.0, np.nan, np.nan,
            ])
    if rec is not None:
        rec.close()
    traj = np.stack(traj)
    return {
        "metrics": tracking_metrics(traj[:, :2], course, dt=1.0 / hz),
        "rate_stats": rate.stats(),
        "logs": {"state": traj},
        "stale_cycles": gate.stale_cycles,
        "invalid_steer_cycles": invalid_steer_cycles,
    }


_PLANT_NP_MODELS = ("unicycle", "steering_unicycle", "full_body",
                    "rate_limited_steering")


def _plant_step_np(model_name: str, state, u, dt: float):
    """One host-side Euler plant step (numpy; same kinematics as the jax
    models / the C++ oracle): the pipelined loop's 'robot' integrates in
    real time on the host while solves are in flight on the device.
    Built-in families only — a user-registered model's kinematics are not
    knowable here, so silently integrating it wrong is refused."""
    if model_name not in _PLANT_NP_MODELS:
        raise ValueError(
            f"run_pipelined_experiment's host plant supports the built-in "
            f"model families {_PLANT_NP_MODELS}; got {model_name!r}. "
            f"Drive custom models with run_realtime_experiment (jax plant) "
            f"or run_tracking_experiment."
        )
    s = np.array(state, dtype=np.float64)
    if model_name == "unicycle":
        heading = s[2]
    elif model_name == "rate_limited_steering":
        # u[2] is the steering RATE; position integrates with the CURRENT
        # steering-angle state (ops/rollout.py semantics)
        heading = s[2] + s[3]
    else:
        heading = s[2] + float(u[2])
    s[0] += float(u[0]) * math.cos(heading) * dt
    s[1] += float(u[0]) * math.sin(heading) * dt
    s[2] += float(u[1]) * dt
    if model_name == "full_body":
        s[3] += float(u[3]) * dt
        s[4] += float(u[4]) * dt
    elif model_name == "rate_limited_steering":
        from ccv_mppi_path_tracker_tpu.ops.rollout import steer_limits

        steer_max, rate_max = steer_limits(model_name)
        rate = min(max(float(u[2]), -rate_max), rate_max)
        s[3] = min(max(s[3] + rate * dt, -steer_max), steer_max)
    return s


def _async_to_host(arr):
    """Start a device->host copy without blocking (best effort)."""
    try:
        arr.copy_to_host_async()
    except Exception:
        pass


def run_pipelined_experiment(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course: np.ndarray,
    hz: float = 25.0,
    num_cycles: int = 250,
    model_params=None,
    resolution: float = 0.1,
    use_kernel: bool = False,
    micro_batch: int = 1,
    delay_compensation: bool = True,
    seed: int = 0,
):
    """Asynchronous pipelined serving loop (the round-4 missing call-stack
    shape): cycle n DISPATCHES the solve for cycle n+1 before FETCHING
    cycle n's command, so the host never blocks on an in-flight solve and a
    fetch round trip of up to one control period is hidden. The one-cycle
    actuation lag this introduces is compensated by planning from the state
    Euler-predicted one period ahead under the command currently in flight
    (``mppi_step(delay=1/hz)``, solver/mppi.py) — set
    ``delay_compensation=False`` for the naive (uncompensated) arm the
    closed-loop comparison quantifies.

    micro_batch=M > 1: a device-resident scan solves M consecutive cycles
    per host interaction and streams all M commands back in ONE fetch — for
    transports whose per-fetch round trip exceeds the control period (e.g. a
    remote accelerator). Within
    a batch the controller advances open-loop on its own plant model;
    sensed state re-enters at every batch boundary, and the next batch is
    dispatched from the model-predicted end-of-window state so the fetch of
    window b overlaps the solve of window b+1. The reference's
    sense->solve->actuate shape (src/diff_drive_mppi.cpp:332-369) runs at
    the paced rate either way; only the feedback latency changes — and is
    reported as ``feedback_latency_cycles``.

    The plant is a host-side numpy integrator of the same kinematics (the
    robot integrates in real time regardless of what the host does).
    ``num_cycles`` runs in whole windows: with micro_batch=M the schedule
    executes ``(num_cycles // M) * M`` paced cycles.
    Returns {"metrics", "rate_stats", "miss_rate", "fetch_ms", ...}.
    """
    import functools
    import time as _time

    import jax
    import jax.numpy as _jnp

    from ccv_mppi_path_tracker_tpu.core.types import ControllerState
    from ccv_mppi_path_tracker_tpu.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu.runtime.native import RateExecutor
    from ccv_mppi_path_tracker_tpu.solver.mppi import mppi_step

    assert micro_batch >= 1
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, resolution, dtype=np.float32)
    nominal_dt = 1.0 / hz
    # the plan is consumed one cycle (or one batch boundary) late
    delay = nominal_dt if delay_compensation else None

    slope = math.atan2(course[1, 1] - course[0, 1],
                       course[1, 0] - course[0, 0])
    state_h = np.array(
        [course[0, 0], course[0, 1], slope] + [0.0] * (model.num_states - 3),
        dtype=np.float64,
    )

    # dt_solve: the solver's rollout step stays at the course's nominal
    # 0.1 s lookahead grid regardless of the control rate (replanning
    # faster than the rollout step, as the device-resident session does).
    dt_solve = _jnp.float32(0.1)
    make_ctrl = lambda: ControllerState.initial(
        jax.random.PRNGKey(seed), cfg.horizon, model.num_controls
    )

    if micro_batch == 1:
        step = jax.jit(functools.partial(
            mppi_step, cfg, use_kernel=use_kernel, lean=True, delay=delay,
            model_params=model_params,
        ))

        def dispatch(ctrl, s_np):
            ctrl, res = step(
                ctrl, _jnp.asarray(s_np, _jnp.float32), path, dt_solve,
                sp, cp,
            )
            _async_to_host(res.u0)
            return ctrl, res
    else:
        def batch_body(carry, _):
            ctrl, state = carry
            # within the window the controller tracks its own model plant;
            # the window-boundary handoff supplies the sensed state, so no
            # per-cycle delay term is needed (the dispatch-ahead prediction
            # below plays that role across the window boundary)
            ctrl, res = mppi_step(
                cfg, ctrl, state, path, dt_solve, sp, cp,
                model_params=model_params, use_kernel=use_kernel, lean=True,
            )
            state = model.step(state, res.u0, _jnp.float32(nominal_dt))
            return (ctrl, state), res.u0

        @jax.jit
        def batch_step(ctrl, state0):
            (ctrl, _), u0s = jax.lax.scan(
                batch_body, (ctrl, state0), None, length=micro_batch
            )
            return ctrl, u0s  # (M, U)

        def dispatch(ctrl, s_np):
            ctrl, u0s = batch_step(ctrl, _jnp.asarray(s_np, _jnp.float32))
            _async_to_host(u0s)
            return ctrl, u0s

    # ---- warm-up: full first-cycle shape through to a host fetch --------
    ctrl, pending = dispatch(make_ctrl(), state_h)
    np.asarray(pending if micro_batch > 1 else pending.u0)
    ctrl = make_ctrl()

    num_batches = max(1, num_cycles // micro_batch)
    traj = [state_h.copy()]
    fetch_s = []
    rate = RateExecutor(hz)
    ctrl, pending = dispatch(ctrl, state_h)  # plan for the first window
    for b in range(num_batches):
        # fetch the commands planned in the previous window (in flight for
        # a full window: the RTT is hidden unless it exceeds the window)
        t0 = _time.perf_counter()
        u_win = np.asarray(pending if micro_batch > 1 else pending.u0)
        fetch_s.append(_time.perf_counter() - t0)
        if micro_batch == 1:
            u_win = u_win[None, :]
            # delay compensation happens IN the solver: mppi_step(delay=
            # 1/hz) predicts the fed state one period forward under
            # ctrl.u_prev[0] — which is exactly the command window being
            # actuated right now
            s_dispatch = state_h
        else:
            # window handoff: the next window's plan starts where the plant
            # will be after this window's M commands have been applied
            s_dispatch = state_h
            if delay_compensation:
                for m in range(micro_batch):
                    s_dispatch = _plant_step_np(
                        cfg.model, s_dispatch, u_win[m], nominal_dt
                    )
        # dispatch the next window BEFORE actuating this one (the solve and
        # its fetch overlap the whole actuation window)
        ctrl, pending = dispatch(ctrl, s_dispatch)
        # actuate this window at the paced rate on the live plant
        for m in range(micro_batch):
            dt = rate.sleep()
            state_h = _plant_step_np(cfg.model, state_h, u_win[m], dt)
            traj.append(state_h.copy())

    traj = np.stack(traj)
    rs = rate.stats()
    fetch_ms = np.asarray(fetch_s) * 1e3
    return {
        "metrics": tracking_metrics(traj[:, :2], course, dt=nominal_dt),
        "rate_stats": rs,
        "miss_rate": rs["deadline_misses"] / max(rs["cycles"], 1),
        "fetch_ms": {
            "mean": float(fetch_ms.mean()),
            "p95": float(np.percentile(fetch_ms, 95)),
            "max": float(fetch_ms.max()),
        },
        "feedback_latency_cycles": micro_batch,
        "delay_compensation": delay_compensation,
        "micro_batch": micro_batch,
        "logs": {"state": traj},
    }
