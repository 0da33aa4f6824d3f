#!/usr/bin/env python
"""Smoke run of the MPPI controller on one NVIDIA GPU, through its public
entry points, at the flagship size (full_body, K=102400, T=30).

Phases (any failure exits non-zero before the result line):

  a. device: a GPU must be JAX's default backend; prints its kind, count,
     name and power limit (nvidia-smi), the JAX version and XLA_FLAGS.
  b. XLA pipeline vs the float64 NumPy oracle, f32 on the card, injected
     noise, all four models at K=4096 T=15.
  c. closed loop at the flagship through run_tracking_experiment on the
     launch course, XLA pipeline and fused kernel: tracking RMSE finite and
     under 0.15 m.
  d. fused kernel (compiled for the card) vs the XLA pipeline under
     injected noise: all four models at K=102400 T=30, full_body at
     K=1048576 T=30, unicycle at K=1000 T=15 and a fleet of 256 robots at
     K=1024 T=15 through jax.vmap; prints the flagship step's
     memory_analysis().
  e. the served loop: run_realtime_experiment at 10 Hz, 50 cycles, at the
     flagship; prints the native scheduler's library (and whether this run
     built it) and the deadline misses.

``--multi`` runs only the sample-sharded step (parallel/sharded.py) on a
4-device "samples" mesh at K=4*102400 against the same injected noise on
one device.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--multi]
"""

import argparse
import json
import os
import subprocess
import sys
import time

# tolerances, with their reasons
# (b) f32 on the card vs the f64 oracle: per-sample costs agree to ~1e-6
#     relative; the softmax turns a cost error dc into a weight error of
#     dc/lam, so the update agrees to ~1e-5 absolute on O(1) controls.
ORACLE_ATOL = 2e-4
# (d) kernel vs XLA, both f32 on the card: libdevice vs XLA sin/cos/exp and
#     per-block vs XLA summation order move costs by ~1e-6 relative and the
#     update by a few 1e-6; 1e-4 absolute leaves ~20x headroom at T=30.
KERNEL_ATOL = 1e-4
COST_RTOL = 1e-5
RMSE_MAX = 0.15

# sizes (the flagship of BASELINE.md, the reference's own points, a fleet)
FLAGSHIP_K, FLAGSHIP_T = 102400, 30
LARGE_K = 1048576
REF_K, REF_T = 1000, 15
FLEET_B, FLEET_K, FLEET_T = 256, 1024, 15
ORACLE_K, ORACLE_T = 4096, 15
LOOP_STEPS = 150
SERVED_CYCLES = 50


def log(msg):
    print(msg, flush=True)


def gpu_name_and_power():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def phase_device(jax, want_count):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {devs[0].platform}")
    if len(devs) < want_count:
        raise SystemExit(f"need {want_count} GPUs, JAX sees {len(devs)}")
    log(f"[a] device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[a] {gpu_name_and_power()}")
    return devs


def _problem(launch, k, t, seed=2):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer

    cfg, sp, cp, course = launch(num_samples=k, horizon=t, dtype=np.float32)
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    u = cfg.num_controls
    ctrl = ControllerState(
        u_prev=jnp.asarray(np.random.RandomState(1).randn(t - 1, u) * 0.1,
                           jnp.float32),
        key=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(cfg.num_states, jnp.float32).at[1].set(
        float(course[0, 1]) - 0.1)
    noise = jax.random.normal(jax.random.PRNGKey(seed), (t - 1, k, u),
                              jnp.float32)
    return cfg, sp, cp, course, path, ctrl, state, noise


LAUNCH_NAMES = ("diff_drive", "steering_diff_drive", "rate_limited_steering",
                "full_body")


def phase_oracle():
    import jax
    import numpy as np

    from ccv_mppi_path_tracker_tpu.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.oracle import oracle_step
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    for name in LAUNCH_NAMES:
        cfg, sp, cp, course, path, ctrl, state, noise = _problem(
            PRESETS[name], ORACLE_K, ORACLE_T)
        mp = get_model(cfg.model).default_params
        _, res = jax.jit(lambda c, s, n: mppi_step(
            cfg, c, s, path, 0.1, sp, cp, noise=n))(ctrl, state, noise)
        kw = {}
        if cfg.model == "full_body":
            kw = dict(mass=float(mp.mass), base2com=float(mp.base2com),
                      inertia=np.asarray(mp.inertia, np.float64),
                      gravity_z=float(mp.gravity_z),
                      zmp_weight=float(cp.zmp_weight),
                      roll_v_weight=float(cp.roll_v_weight),
                      back_weight=float(cp.back_weight),
                      yaw_weight=float(cp.yaw_weight))
        ora = oracle_step(
            cfg.model, np.asarray(ctrl.u_prev), np.asarray(state), course,
            0.1, 0.1, np.asarray(noise),
            control_noise=np.asarray(sp.control_noise, np.float64),
            lam=float(sp.lam), u_min=np.asarray(sp.u_min),
            u_max=np.asarray(sp.u_max), v_ref=float(cp.v_ref),
            path_weight=float(cp.path_weight), v_weight=float(cp.v_weight),
            steer_off=cfg.steer_off, **kw,
        )
        du = float(np.max(np.abs(np.asarray(res.u_opt, np.float64)
                                 - ora["u_opt"])))
        dc = abs(float(res.stats["min_cost"]) - float(ora["costs"].min()))
        log(f"[b] xla vs oracle {cfg.model} K={ORACLE_K} T={ORACLE_T}: "
            f"max|du_opt|={du:.3e} "
            f"|dmin_cost|={dc:.3e} (tol {ORACLE_ATOL:g})")
        if not du <= ORACLE_ATOL:
            raise AssertionError(f"{cfg.model}: XLA vs oracle {du} > "
                                 f"{ORACLE_ATOL}")


def phase_closed_loop():
    import numpy as np

    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.runtime import run_tracking_experiment

    cfg, sp, cp, course = full_body_launch(num_samples=FLAGSHIP_K,
                                           horizon=FLAGSHIP_T)
    for use_kernel in (False, True):
        t0 = time.perf_counter()
        out = run_tracking_experiment(cfg, sp, cp, course,
                                      num_steps=LOOP_STEPS,
                                      use_kernel=use_kernel)
        rmse = float(out["metrics"]["rmse"])
        log(f"[c] closed loop full_body K={FLAGSHIP_K} T={FLAGSHIP_T} "
            f"{LOOP_STEPS} cycles "
            f"{'kernel' if use_kernel else 'xla'}: rmse={rmse:.4f} m "
            f"({time.perf_counter() - t0:.1f} s with compile)")
        if not (np.isfinite(rmse) and rmse < RMSE_MAX):
            raise AssertionError(f"closed-loop rmse {rmse} (max {RMSE_MAX})")


def _compare(tag, a, b):
    import numpy as np

    du = float(np.max(np.abs(np.asarray(a.u_opt) - np.asarray(b.u_opt))))
    ca, cb = np.asarray(a.stats["min_cost"]), np.asarray(b.stats["min_cost"])
    dc = float(np.max(np.abs(ca - cb) / np.maximum(np.abs(ca), 1e-6)))
    log(f"[d] kernel vs xla {tag}: max|du_opt|={du:.3e} "
        f"max rel|dmin_cost|={dc:.3e} (tol {KERNEL_ATOL:g}, {COST_RTOL:g})")
    if not (du <= KERNEL_ATOL and dc <= COST_RTOL):
        raise AssertionError(f"kernel vs xla {tag}: du={du} dc={dc}")
    return du


def phase_kernel():
    import jax
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.core.presets import PRESETS
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    shapes = [(name, FLAGSHIP_K, FLAGSHIP_T) for name in LAUNCH_NAMES]
    shapes += [("full_body", LARGE_K, FLAGSHIP_T), ("diff_drive", REF_K, REF_T)]
    for name, k, t in shapes:
        cfg, sp, cp, _, path, ctrl, state, noise = _problem(PRESETS[name], k, t)

        def run(use_kernel):
            f = jax.jit(lambda c, s, n: mppi_step(
                cfg, c, s, path, 0.1, sp, cp, noise=n, use_kernel=use_kernel))
            return f, f(ctrl, state, noise)[1]

        _, a = run(False)
        fk, b = run(True)
        _compare(f"{cfg.model} K={k} T={t}", a, b)
        if (name, k) == ("full_body", FLAGSHIP_K):
            mem = fk.lower(ctrl, state, noise).compile().memory_analysis()
            log(f"[d] flagship kernel step memory_analysis: {mem}")
        del noise

    # fleet: jax.vmap over the single-robot step, per-robot poses and noise
    B, k, t = FLEET_B, FLEET_K, FLEET_T
    cfg, sp, cp, _, path, ctrl, state, _ = _problem(PRESETS["diff_drive"], k, t)
    ctrls = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), ctrl)
    states = jnp.broadcast_to(state, (B,) + state.shape).at[:, 1].add(
        jnp.linspace(-0.3, 0.3, B, dtype=jnp.float32))
    noise = jax.random.normal(jax.random.PRNGKey(9), (B, t - 1, k, 2),
                              jnp.float32)

    def fleet(use_kernel):
        one = lambda c, s, n: mppi_step(cfg, c, s, path, 0.1, sp, cp, noise=n,
                                        use_kernel=use_kernel)
        return jax.jit(jax.vmap(one))(ctrls, states, noise)[1]

    _compare(f"fleet B={B} K={k} T={t} (vmap)", fleet(False), fleet(True))


def phase_served():
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.runtime import native
    from ccv_mppi_path_tracker_tpu.runtime.realtime import (
        run_realtime_experiment,
    )

    prebuilt = os.path.exists(native._SO)
    lib = native.load_library()  # a failed g++ build raises with its output
    log(f"[e] rate scheduler: native {lib._name} "
        f"({'prebuilt' if prebuilt else 'built by g++ in this run'})")
    cycles = SERVED_CYCLES
    cfg, sp, cp, course = full_body_launch(num_samples=FLAGSHIP_K,
                                           horizon=FLAGSHIP_T)
    for use_kernel in (False, True):
        out = run_realtime_experiment(cfg, sp, cp, course, hz=10.0,
                                      num_cycles=cycles, use_kernel=use_kernel)
        rs = out["rate_stats"]
        log(f"[e] served loop 10 Hz {cycles} cycles "
            f"{'kernel' if use_kernel else 'xla'}: "
            f"deadline_misses={rs['deadline_misses']} of {rs['cycles']}, "
            f"rmse={float(out['metrics']['rmse']):.4f} m")
        if rs["cycles"] != cycles:
            raise AssertionError(f"served {rs['cycles']} of {cycles} cycles")


def phase_multi(n=4):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.parallel import samples_mesh
    from ccv_mppi_path_tracker_tpu.parallel.sharded import build_sharded_step
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    k = n * FLAGSHIP_K
    cfg, sp, cp, _, path, ctrl, state, noise = _problem(full_body_launch, k,
                                                        FLAGSHIP_T)
    mesh = samples_mesh(num_devices=n)
    for use_kernel in (False, True):
        step_n = build_sharded_step(cfg, mesh, use_kernel=use_kernel)
        _, res_n = step_n(ctrl, state, path, 0.1, sp, cp, noise=noise)
        _, res_1 = jax.jit(lambda c, s, z: mppi_step(
            cfg, c, s, path, 0.1, sp, cp, noise=z, use_kernel=use_kernel))(
                ctrl, state, noise)
        du = float(np.max(np.abs(np.asarray(res_n.u_opt)
                                 - np.asarray(res_1.u_opt))))
        tag = "kernel" if use_kernel else "xla"
        log(f"[multi] {n}-device vs 1-device full_body K={k} "
            f"T={FLAGSHIP_T} {tag}: "
            f"max|du_opt|={du:.3e} (tol {KERNEL_ATOL:g})")
        if not du <= KERNEL_ATOL:
            raise AssertionError(f"{n}-device vs 1-device {tag}: {du}")
        # the served form: each device draws its own samples (no noise
        # input); inputs already on the devices, replicated
        rep = NamedSharding(mesh, P())
        args_n = jax.device_put((ctrl, state, path, 0.1, sp, cp), rep)
        args_1 = jax.device_put((ctrl, state, path, 0.1, sp, cp))
        one = jax.jit(lambda c, s, p, d, a, b: mppi_step(
            cfg, c, s, p, d, a, b, use_kernel=use_kernel))
        for label, f in ((f"{n}-device", lambda: step_n(*args_n)),
                         ("1-device", lambda: one(*args_1))):
            f()[1].u_opt.block_until_ready()
            t0 = time.perf_counter()
            for _ in range(20):
                res = f()[1]
            res.u_opt.block_until_ready()
            log(f"[multi] {label} {tag} step K={k}: "
                f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-device sample-sharded phase")
    args = p.parse_args()

    import jax

    from ccv_mppi_path_tracker_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    n = 4 if args.multi else 1
    devs = phase_device(jax, n)
    if args.multi:
        phase_multi(n)
    else:
        for phase in (phase_oracle, phase_closed_loop, phase_kernel,
                      phase_served):
            t0 = time.perf_counter()
            phase()
            log(f"phase {phase.__name__} done in "
                f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:  # any failed phase: no result line
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
