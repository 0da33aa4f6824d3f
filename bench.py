#!/usr/bin/env python
"""Time one full MPPI control update on the GPU, XLA pipeline vs fused kernel.

Workload: the complete control update (sampling, rollout, ZMP chain, cost,
softmax, weighted update) in serving mode (``lean``), chained through the
controller state: each step consumes the previous ControllerState, the chain
ends in ``block_until_ready``, and the median over ``--reps`` chains of
``--steps`` steps is reported. The step's inputs (state, path, params) are
put on the device once beforehand, so the time is the update's and not the
host-to-device copy of NumPy arguments.

Prints one JSON line per (model, K): both paths' ms per update, propagations
K*(T-1) per second, and the device (platform, device_kind, count, name and
power limit). Fails when JAX finds no GPU. With ``--robots B`` each update is
one fleet step of B robots (``solver/batch.py``, jax.vmap over the step,
full StepResult), and propagations count all B robots.

With ``--trace`` each path also runs one more chain of ``--steps`` updates
under ``jax.profiler`` and the line gains, per path, the per-update host
wall time under the tracer, device busy time, device idle share, fused
kernel time and device events (``utils/profiling.py``,
``summarize_device_trace``, says how each is reduced from the trace).

Usage: python bench.py [--model full_body] [--num-samples 102400 1048576]
                       [--horizon 30] [--robots B] [--steps 40] [--reps 7]
                       [--trace]
"""

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time

LAUNCHES = ("unicycle", "steering_unicycle", "rate_limited_steering",
            "full_body")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_update(step, make_ctrl, args, steps, reps):
    """Median seconds per chained update."""
    ctrl, res = step(make_ctrl(), *args)  # compile + warm up
    res.u0.block_until_ready()
    per = []
    for _ in range(reps):
        ctrl = make_ctrl()
        ctrl.u_prev.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(steps):
            ctrl, res = step(ctrl, *args)
        res.u0.block_until_ready()
        per.append((time.perf_counter() - t0) / steps)
    per.sort()
    return per[len(per) // 2]


def trace_update(step, make_ctrl, args, steps):
    """Device numbers per update from a profiler trace of one chain."""
    from ccv_mppi_path_tracker_tpu.utils.profiling import (
        device_trace, load_trace_events, summarize_device_trace,
    )

    with tempfile.TemporaryDirectory() as log_dir:
        ctrl = make_ctrl()
        ctrl.u_prev.block_until_ready()
        with device_trace(log_dir, perfetto=True):
            t0 = time.perf_counter()
            for _ in range(steps):
                ctrl, res = step(ctrl, *args)
            res.u0.block_until_ready()
            wall = time.perf_counter() - t0
        out = summarize_device_trace(load_trace_events(log_dir), steps)
    return {"host_ms": wall / steps * 1e3, **out}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="full_body", choices=LAUNCHES)
    p.add_argument("--num-samples", type=int, nargs="+", default=[102400])
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--robots", type=int, default=0,
                   help="time a fleet step of this many robots instead")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--trace", action="store_true",
                   help="add device busy time and idle share from a trace")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import (
        diff_drive_launch, full_body_launch, rate_limited_launch,
        steering_launch,
    )
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step
    from ccv_mppi_path_tracker_tpu.solver.batch import (
        build_fleet_step,
        init_fleet,
    )
    from ccv_mppi_path_tracker_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py times the GPU; JAX's default backend is "
                 f"{dev.platform}")
    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "name_power": gpu_name_and_power()}
    launch = dict(zip(LAUNCHES, (diff_drive_launch, steering_launch,
                                 rate_limited_launch, full_body_launch)))
    for k in args.num_samples:
        cfg, sp, cp, course = launch[args.model](num_samples=k,
                                                 horizon=args.horizon)
        path = PathBuffer.from_points(course, 0.1)
        state = jnp.zeros(cfg.num_states, jnp.float32).at[1].set(
            float(course[0, 1]))
        if args.robots:
            state = jnp.broadcast_to(state, (args.robots, cfg.num_states))
            make_ctrl = lambda: init_fleet(cfg, args.robots)
        else:
            make_ctrl = lambda: ControllerState.initial(
                jax.random.PRNGKey(0), cfg.horizon, cfg.num_controls)
        step_args = jax.device_put((state, path, jnp.float32(0.1), sp, cp))
        ms, traces = {}, {}
        for name, use_kernel in (("xla", False), ("kernel", True)):
            if args.robots:
                step = build_fleet_step(cfg, use_kernel=use_kernel)
            else:
                step = jax.jit(functools.partial(
                    mppi_step, cfg, use_kernel=use_kernel, lean=True),
                    donate_argnums=(0,))
            ms[name] = time_update(step, make_ctrl, step_args, args.steps,
                                   args.reps) * 1e3
            if args.trace:
                traces[name] = trace_update(step, make_ctrl, step_args,
                                            args.steps)
        props = k * (args.horizon - 1) * max(args.robots, 1)
        print(json.dumps({
            "metric": "mppi_control_update_ms",
            "model": cfg.model, "num_samples": k, "horizon": args.horizon,
            "robots": args.robots,
            "xla_ms": ms["xla"], "kernel_ms": ms["kernel"],
            "kernel_speedup": ms["xla"] / ms["kernel"],
            "kernel_propagations_per_s": props / (ms["kernel"] * 1e-3),
            **({"trace": traces} if args.trace else {}),
            "device": device,
        }), flush=True)


if __name__ == "__main__":
    main()
