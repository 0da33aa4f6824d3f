"""Command-line interface — the framework's ``roslaunch`` replacement.

    python -m ccv_mppi_path_tracker_tpu run --preset full_body --steps 200
    python -m ccv_mppi_path_tracker_tpu run --preset diff_drive --record log/ --plot out.png
    python -m ccv_mppi_path_tracker_tpu compare --preset diff_drive
    python -m ccv_mppi_path_tracker_tpu fleet --robots 256 --kernel
    python -m ccv_mppi_path_tracker_tpu course --kind dkan --out course.csv
    python -m ccv_mppi_path_tracker_tpu sysid

Each experiment the reference runs via launch XML (controller + path creator
+ recorder, e.g. launch/diff_drive_mppi.launch) is one ``run`` invocation:
preset selects the tuned operating point, ``--record`` writes the
reference-compatible CSV, ``--plot`` renders the graph2.py-style figure, and
the calc_e_rmse.py metrics print at the end.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_run_args(p, kernel_flags=True):
    p.add_argument("--preset", default="diff_drive",
                   choices=["diff_drive", "steering_diff_drive", "full_body"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--horizon", type=int, default=15)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record", default=None, help="log dir for CSV output")
    p.add_argument("--plot", default=None, help="save tracking figure to file")
    p.add_argument("--plot-yaw", default=None,
                   help="save yaw-vs-path-yaw figure (graph3 layout) to file")
    p.add_argument("--course", default="preset",
                   choices=["preset", "sin", "dkan", "square", "circle"],
                   help="override the preset's course (e.g. --course dkan "
                        "mirrors launch/dkan_diff_drive_mppi.launch)")
    p.add_argument("--save-ckpt", default=None,
                   help="save the final controller state + params (.npz)")
    p.add_argument("--resume-ckpt", default=None,
                   help="resume warm start/PRNG/step from a saved checkpoint")
    p.add_argument("--shift-warm-start", action="store_true",
                   help="center sampling on the one-step-shifted previous "
                        "optimum (standard receding-horizon practice; the "
                        "reference does not shift)")
    p.add_argument("--delay", type=float, default=None,
                   help="actuation-latency compensation in seconds: solve "
                        "from the delay-predicted state")
    p.add_argument("--elite-frac", type=float, default=None,
                   help="keep softmax weight only on this best global cost "
                        "fraction (CEM<->MPPI interpolation; works on the "
                        "XLA, kernel, and sharded paths)")
    p.add_argument("--animate", default=None,
                   help="export a per-cycle animation (.html or .gif) of "
                        "candidate/optimal/reference paths — the rviz "
                        "live-view equivalent")
    p.add_argument("--animate-candidates", type=int, default=24,
                   help="candidate rollouts drawn per frame (XLA path only)")
    if not kernel_flags:
        return  # export pins the XLA path (jax.export of StableHLO)
    kg = p.add_mutually_exclusive_group()
    kg.add_argument("--kernel", action="store_true",
                    help="force the fused Pallas kernel path (GPU only; "
                         "default: auto — kernel iff measured faster for "
                         "this model/size on this GPU kind, "
                         "kernels.should_use_kernel)")
    kg.add_argument("--no-kernel", action="store_true",
                    help="force the XLA pipeline (disable auto selection)")


def _kernel_choice(args, cfg):
    """Resolve --kernel / --no-kernel / auto to a use_kernel bool.

    Auto (neither flag) picks the measured-faster path for this
    model/workload on the current backend (kernels.should_use_kernel).
    argparse enforces the flags' mutual exclusion (_add_run_args).
    """
    if args.kernel:
        return True
    if args.no_kernel:
        return False
    from ccv_mppi_path_tracker_tpu.kernels import should_use_kernel

    return should_use_kernel(cfg.num_samples, cfg.horizon, model=cfg.model)


def _resolve(args):
    """(cfg, sp, cp, course) from the preset + optional course override."""
    from ccv_mppi_path_tracker_tpu.core.presets import PRESETS

    kwargs = {"horizon": args.horizon}
    if args.num_samples:
        kwargs["num_samples"] = args.num_samples
    cfg, sp, cp, course = PRESETS[args.preset](**kwargs)
    if getattr(args, "course", "preset") != "preset":
        from ccv_mppi_path_tracker_tpu.paths import (
            circle_course,
            dkan_course,
            filtered_square_course,
            spline_resample_course,
            sum_of_cosines_course,
        )

        course = {
            "sin": lambda: sum_of_cosines_course(
                amplitudes=(1.0, 0, 0), frequencies=(0.25, 0, 0),
                deltas=(0, 0, 0), resolution=0.1, course_length=10.0,
            ),
            # raw dkan corners are unreachable kinks; the corridor test uses
            # the spline-smoothed variant (tests/test_paths.py)
            "dkan": lambda: spline_resample_course(
                dkan_course(resolution=0.5), resolution=0.1
            ),
            "square": lambda: filtered_square_course(),
            "circle": lambda: circle_course(radius=10.0, resolution=0.1),
        }[args.course]().astype(np.float32)
    return cfg, sp, cp, course


def cmd_run(args):
    from ccv_mppi_path_tracker_tpu.runtime import run_tracking_experiment

    cfg, sp, cp, course = _resolve(args)
    extra = {}
    if args.resume_ckpt:
        from ccv_mppi_path_tracker_tpu.runtime.checkpoint import load_checkpoint

        ck_cfg, ctrl, trees = load_checkpoint(args.resume_ckpt, sp=sp, cp=cp)
        assert ck_cfg.model == cfg.model and ck_cfg.horizon == cfg.horizon, (
            f"checkpoint is for {ck_cfg.model} T={ck_cfg.horizon}, "
            f"requested {cfg.model} T={cfg.horizon}"
        )
        sp, cp = trees["sp"], trees["cp"]
        extra["ctrl"] = ctrl
        print(f"resumed from {args.resume_ckpt} (cycle {int(ctrl.step)})")
    opts = {}
    if getattr(args, "shift_warm_start", False):
        opts["shift_warm_start"] = True
    if getattr(args, "delay", None) is not None:
        opts["delay"] = args.delay
    if getattr(args, "elite_frac", None) is not None:
        opts["elite_frac"] = args.elite_frac
    animate = getattr(args, "animate", None)
    # path selection: --kernel / --no-kernel force; default auto picks the
    # measured-faster path (kernel only on a GPU kind with a measured
    # threshold, at or above it). --animate needs the XLA-only candidate debug output, so
    # auto stays on XLA for it.
    if animate and not (args.kernel or args.no_kernel):
        use_kernel = False
    else:
        use_kernel = _kernel_choice(args, cfg)
    if animate:
        if not use_kernel:
            # candidate rollouts are an XLA-path debug output
            opts["debug_candidates"] = args.animate_candidates
        extra["with_paths"] = True
    print(f"solver path: {'fused kernel' if use_kernel else 'xla'}"
          f"{'' if args.kernel or args.no_kernel else ' (auto)'}")
    out = run_tracking_experiment(
        cfg, sp, cp, course, num_steps=args.steps, dt=args.dt, seed=args.seed,
        use_kernel=use_kernel, solver_options=opts or None, **extra,
    )
    if animate:
        from ccv_mppi_path_tracker_tpu.metrics.animate import animate_tracking

        n = animate_tracking(out, animate)
        print(f"animation: {animate} ({n} frames)")
    if args.save_ckpt:
        from ccv_mppi_path_tracker_tpu.runtime.checkpoint import save_checkpoint

        save_checkpoint(args.save_ckpt, cfg, out["ctrl"], sp=sp, cp=cp)
        print(f"checkpoint: {args.save_ckpt}")
    m = out["metrics"]
    print(f"Time: {round(m['time'], 1)}")
    print(f"Max Error: {round(m['max_error'], 3)}")
    print(f"RMSE Error: {round(m['rmse'], 3)}")
    if args.record:
        _record(args, out, cfg)
    if args.plot:
        from ccv_mppi_path_tracker_tpu.metrics.plots import plot_tracking

        plot_tracking(out, out=args.plot)
        print(f"figure: {args.plot}")
    if args.plot_yaw:
        from ccv_mppi_path_tracker_tpu.metrics.plots import plot_yaw_comparison

        plot_yaw_comparison(out, out=args.plot_yaw)
        print(f"figure: {args.plot_yaw}")
    return 0


def _record(args, out, cfg):
    from ccv_mppi_path_tracker_tpu.metrics import Recorder
    from ccv_mppi_path_tracker_tpu.solver.command import command_from_solution

    rec = Recorder(args.record, method=args.preset)
    logs = out["logs"]
    for i, (state, u0) in enumerate(zip(logs["state"], logs["u0"])):
        cmd = command_from_solution(cfg.model, u0, args.dt)
        rec.write_cycle(i * args.dt, state, cmd)
    rec.close(out["course"])
    print(f"recorded: {rec.path}")


def cmd_compare(args):
    """MPPI vs the pure-pursuit baseline on the same course."""
    from ccv_mppi_path_tracker_tpu.runtime import run_tracking_experiment
    from ccv_mppi_path_tracker_tpu.runtime.pure_pursuit import (
        PurePursuitConfig,
        run_pure_pursuit_experiment,
    )

    cfg, sp, cp, course = _resolve(args)
    mppi = run_tracking_experiment(
        cfg, sp, cp, course, num_steps=args.steps, dt=args.dt, seed=args.seed,
        use_kernel=_kernel_choice(args, cfg),
    )
    pp = run_pure_pursuit_experiment(
        course, num_steps=args.steps, dt=args.dt,
        cfg=PurePursuitConfig(v_ref=float(np.asarray(cp.v_ref))),
    )
    for name, r in (("mppi", mppi), ("pure_pursuit", pp)):
        m = r["metrics"]
        print(f"{name}: RMSE={m['rmse']:.3f} max={m['max_error']:.3f}")
    if args.plot:
        from ccv_mppi_path_tracker_tpu.metrics.plots import (
            plot_tracking_comparison,
        )

        plot_tracking_comparison(
            {"MPPI": mppi, "Pure Pursuit": pp}, out=args.plot
        )
        print(f"wrote comparison figure {args.plot}")
    return 0


def cmd_realtime(args):
    """Wall-clock fixed-rate run with the native scheduler + recorder."""
    import os

    from ccv_mppi_path_tracker_tpu.runtime.realtime import (
        run_pipelined_experiment,
        run_realtime_experiment,
    )

    cfg, sp, cp, course = _resolve(args)
    rec = None
    if args.record:
        os.makedirs(args.record, exist_ok=True)
        rec = os.path.join(args.record, f"{args.preset}_realtime.csv")
    if args.pipelined or args.micro_batch > 1:
        if rec is not None:
            print("note: --record is not supported by the pipelined loop "
                  "(no per-cycle command CSV); running without recording")
            rec = None
        out = run_pipelined_experiment(
            cfg, sp, cp, course, hz=args.hz, num_cycles=args.steps,
            use_kernel=_kernel_choice(args, cfg),
            micro_batch=args.micro_batch,
        )
        fm = out["fetch_ms"]
        print(f"pipelined: micro_batch={args.micro_batch} "
              f"fetch p95 {fm['p95']:.2f} ms (max {fm['max']:.2f})")
    else:
        out = run_realtime_experiment(
            cfg, sp, cp, course, hz=args.hz, num_cycles=args.steps,
            record_path=rec, use_kernel=_kernel_choice(args, cfg),
        )
    m, rs = out["metrics"], out["rate_stats"]
    print(f"Time: {round(m['time'], 1)}")
    print(f"Max Error: {round(m['max_error'], 3)}")
    print(f"RMSE Error: {round(m['rmse'], 3)}")
    print(
        f"rate: {rs['cycles']} cycles, {rs['deadline_misses']} misses, "
        f"mean dt {rs['mean_dt']*1e3:.2f} ms, max jitter "
        f"{rs['max_abs_jitter']*1e3:.2f} ms"
    )
    if rec:
        print(f"recorded: {rec}")
    return 0


def cmd_export(args):
    """Serialize the compiled control step for deployment (jax.export)."""
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.runtime.export import export_control_step

    cfg, sp, cp, course = _resolve(args)
    blob = export_control_step(
        cfg, path_capacity=len(course), sp=sp, cp=cp
    )
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {cfg.model} K={cfg.num_samples} T={cfg.horizon} "
          f"({len(blob)} bytes) -> {args.out}")
    return 0


def cmd_profile(args):
    """Capture a jax.profiler device trace of control cycles (xprof/
    TensorBoard viewable) plus a host-side phase-time summary."""
    import jax
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import MPPISolver
    from ccv_mppi_path_tracker_tpu.utils.profiling import PhaseTimer, device_trace

    cfg, sp, cp, course = _resolve(args)
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, 0.1)
    state = jnp.zeros(model.num_states, jnp.float32).at[1].set(
        float(course[0, 1])
    )
    dt = jnp.float32(args.dt)
    solver = MPPISolver(cfg, use_kernel=_kernel_choice(args, cfg))
    ctrl = solver.init(args.seed)
    timer = PhaseTimer()
    with timer.phase("compile"):
        ctrl, res = solver.step(ctrl, state, path, dt, sp, cp)
        jax.block_until_ready(res.u0)
    with device_trace(args.out):
        for _ in range(args.steps):
            with timer.phase("control_cycle", block_on=None):
                ctrl, res = solver.step(ctrl, state, path, dt, sp, cp)
        jax.block_until_ready(res.u0)
    print(json.dumps(timer.summary()))
    print(f"trace: {args.out} (view with xprof / TensorBoard)")
    return 0


def cmd_course(args):
    from ccv_mppi_path_tracker_tpu.paths import (
        circle_course,
        dkan_course,
        filtered_square_course,
        sum_of_cosines_course,
    )

    kinds = {
        "sin": lambda: sum_of_cosines_course(
            amplitudes=(args.amplitude, 0, 0), frequencies=(args.frequency, 0, 0),
            deltas=(0, 0, 0), resolution=args.resolution,
            course_length=args.length,
        ),
        "circle": lambda: circle_course(radius=args.radius,
                                        resolution=args.resolution),
        "dkan": lambda: dkan_course(resolution=args.resolution),
        "square": lambda: filtered_square_course(length=args.length,
                                                 amplitude=args.amplitude),
    }
    course = kinds[args.kind]()
    np.savetxt(args.out, course, delimiter=",", header="x,y", comments="")
    print(f"{args.kind} course: {len(course)} points -> {args.out}")
    return 0


def cmd_sysid(args):
    """System-ID demo: recover actuator gains from a droopy plant."""
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.diff import fit_control_gains
    from ccv_mppi_path_tracker_tpu.models import get_model

    rng = np.random.RandomState(args.seed)
    true_gains = np.array([0.85, 1.1])
    m = get_model("unicycle")
    states = jnp.asarray(rng.randn(2048, 3))
    controls = jnp.asarray(rng.randn(2048, 2))
    next_states = m.step(states, controls * true_gains, 0.1)
    fitted, losses = fit_control_gains(
        "unicycle", states, controls, next_states, 0.1, num_steps=400
    )
    print(json.dumps({
        "true_gains": true_gains.tolist(),
        "fitted_gains": np.asarray(fitted.gains).round(4).tolist(),
        "final_loss": float(losses[-1]),
    }))
    return 0


def cmd_fleet(args):
    """Fleet serving demo: B robots per jitted tick on one chip."""
    import time

    import jax
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver.batch import (
        build_fleet_step,
        init_fleet,
    )

    cfg, sp, cp, course = _resolve(args)
    path = PathBuffer.from_points(course, 0.1)
    model = get_model(cfg.model)
    B = args.robots
    states = jnp.zeros((B, model.num_states), jnp.float32)
    states = states.at[:, 1].set(float(course[0, 1]))
    dt = jnp.float32(args.dt)
    use_kernel = _kernel_choice(args, cfg)
    step = build_fleet_step(cfg, use_kernel=use_kernel)
    plant = jax.jit(jax.vmap(lambda s, u: model.step(s, u, dt)))
    ctrls = init_fleet(cfg, B, seed=args.seed)
    traj = [np.asarray(states)]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = plant(states, res.u0)
        traj.append(np.asarray(states))
    wall = time.perf_counter() - t0
    traj = np.stack(traj)  # (steps+1, B, S)
    rmses = [
        tracking_metrics(traj[:, b, :2], course, dt=args.dt)["rmse"]
        for b in range(B)
    ]
    print(f"fleet: {B} robots x K={cfg.num_samples}, {args.steps} ticks, "
          f"{'kernel' if use_kernel else 'xla'} path")
    print(f"RMSE mean={np.mean(rmses):.3f} worst={np.max(rmses):.3f}")
    print(f"wall: {wall:.2f} s = {B * args.steps / wall:,.0f} robot-updates/s "
          f"(host loop; bench.py times the device-side update)")
    return 0


def main(argv=None):
    from ccv_mppi_path_tracker_tpu.utils import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="ccv_mppi_path_tracker_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="closed-loop tracking experiment")
    _add_run_args(pr)
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser("compare", help="MPPI vs pure-pursuit baseline")
    _add_run_args(pc)
    pc.set_defaults(fn=cmd_compare)

    po = sub.add_parser("course", help="generate a course CSV")
    po.add_argument("--kind", default="sin",
                    choices=["sin", "circle", "dkan", "square"])
    po.add_argument("--out", default="course.csv")
    po.add_argument("--length", type=float, default=10.0)
    po.add_argument("--amplitude", type=float, default=1.0)
    po.add_argument("--frequency", type=float, default=0.25)
    po.add_argument("--radius", type=float, default=10.0)
    po.add_argument("--resolution", type=float, default=0.1)
    po.set_defaults(fn=cmd_course)

    ps = sub.add_parser("sysid", help="system-identification demo")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_sysid)

    prt = sub.add_parser(
        "realtime", help="fixed-rate native-runtime tracking experiment"
    )
    _add_run_args(prt)
    prt.add_argument("--hz", type=float, default=10.0)
    prt.add_argument("--pipelined", action="store_true",
                     help="asynchronous depth-1 pipelined loop: dispatch "
                          "cycle n+1 before fetching cycle n's command, "
                          "actuation lag compensated in-solver (delay=1/hz)")
    prt.add_argument("--micro-batch", type=int, default=1,
                     help="stream this many commands per device fetch "
                          "(device-resident scan window; implies --pipelined)")
    prt.set_defaults(fn=cmd_realtime)

    pf = sub.add_parser("fleet", help="batched multi-robot serving demo")
    _add_run_args(pf)
    pf.add_argument("--robots", type=int, default=64)
    pf.set_defaults(fn=cmd_fleet)

    pp = sub.add_parser("profile", help="capture a jax.profiler device trace")
    _add_run_args(pp)
    pp.add_argument("--out", default="/tmp/ccv_trace")
    pp.set_defaults(fn=cmd_profile)

    pe = sub.add_parser("export", help="serialize the compiled control step")
    _add_run_args(pe, kernel_flags=False)
    pe.add_argument("--out", default="control_step.bin")
    pe.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
