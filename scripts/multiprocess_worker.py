#!/usr/bin/env python
"""One process of a multi-process (multi-host-style) sharded MPPI run.

Launched N times (by tests/test_multiprocess.py or by hand) with a shared
coordinator address; each process owns ``--devices-per-process`` virtual CPU
devices and the "samples" mesh spans all N*devices_per_process global devices,
exactly as hosts of a cluster would span it (SURVEY.md section 2.5: the
softmax reductions run within a process and across processes — here over
gRPC/gloo). Writes the replicated solve result and a measured
steady-state step time to --out as npz.

Example (2 processes x 4 devices):

    python scripts/multiprocess_worker.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 0 --out /tmp/p0.npz &
    python scripts/multiprocess_worker.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 1 --out /tmp/p1.npz
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--num-samples", type=int, default=64)
    p.add_argument("--horizon", type=int, default=10)
    p.add_argument("--timing-iters", type=int, default=30,
                   help="steady-state chained steps to time (0 = skip)")
    p.add_argument("--elite", action="store_true",
                   help="also time an elite_frac=0.25 sharded step (adds "
                        "the radix-select rank threshold's 8 digit-histogram "
                        "psum rounds to the 3 vanilla collectives)")
    p.add_argument("--overlap", action="store_true",
                   help="also time a two-cycle pipelined step: next cycle's "
                        "noise generation is placed in the SAME program as "
                        "this cycle's pmin/psum collectives with no data "
                        "dependency between them, so the scheduler may "
                        "overlap sampling with the in-flight collectives "
                        "(SURVEY.md section 7 'overlap with next-step "
                        "sampling where legal')")
    p.add_argument("--grad-batch", type=int, default=0,
                   help="if > 0: run the system-ID gradient all-reduce "
                        "benchmark over this global transition batch — "
                        "sequential (num_chunks=1) vs backward-overlapped "
                        "bucketed psum (num_chunks=4, 8)")
    p.add_argument("--grad-horizon", type=int, default=32)
    p.add_argument("--x64", action="store_true")
    args = p.parse_args()

    # Backend setup must precede the jax import: each process gets its own
    # block of virtual CPU devices.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags
        + f" --xla_force_host_platform_device_count={args.devices_per_process}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)

    from ccv_mppi_path_tracker_tpu.parallel import initialize_multihost

    ok = initialize_multihost(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert ok, "jax.distributed.initialize failed"
    assert jax.process_count() == args.num_processes
    n_global = len(jax.devices())
    assert n_global == args.num_processes * args.devices_per_process

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.parallel import SAMPLES_AXIS, samples_mesh
    from ccv_mppi_path_tracker_tpu.parallel.sharded import build_sharded_step
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer

    dtype = np.float64 if args.x64 else np.float32
    T, K = args.horizon, args.num_samples
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T, dtype=dtype)
    path = PathBuffer.from_points(course, 0.1, dtype=dtype)
    ctrl = ControllerState(
        u_prev=jnp.zeros((T - 1, 5), dtype),
        key=jax.random.PRNGKey(3),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(5, dtype).at[1].set(float(course[0, 1]))
    dt = jnp.asarray(0.1, dtype)

    mesh = samples_mesh()  # spans all global devices across processes
    step = build_sharded_step(cfg, mesh)

    # Same deterministic noise in every process; hand jit the GLOBAL array by
    # building it from this process's sample slice (the multi-process
    # equivalent of passing the full tensor single-process). Device order in
    # the mesh is jax.devices() order, so process p owns the p-th contiguous
    # block of the sample axis.
    noise_np = np.random.RandomState(0).randn(T - 1, K, 5).astype(dtype)
    k_proc = K // args.num_processes
    local = noise_np[:, args.process_id * k_proc:(args.process_id + 1) * k_proc]
    noise_sh = NamedSharding(mesh, P(None, SAMPLES_AXIS, None))
    noise = jax.make_array_from_process_local_data(
        noise_sh, local, global_shape=noise_np.shape
    )

    rep = NamedSharding(mesh, P())
    put = lambda t: jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(rep, np.asarray(x)), t
    )
    ctrl, state, path, dt, sp, cp = map(put, (ctrl, state, path, dt, sp, cp))

    ctrl2, res = step(ctrl, state, path, dt, sp, cp, noise=noise)
    u_opt = np.asarray(res.u_opt.addressable_data(0))
    min_cost = float(np.asarray(res.stats["min_cost"].addressable_data(0)))
    ess = float(np.asarray(res.stats["ess"].addressable_data(0)))

    # Steady-state chained step time (RNG mode — the production path).
    step_s = 0.0
    if args.timing_iters:
        c = ctrl2
        _, r = step(c, state, path, dt, sp, cp)  # warm the RNG-mode compile
        float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
        t0 = time.perf_counter()
        for _ in range(args.timing_iters):
            c, r = step(c, state, path, dt, sp, cp)
        float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
        step_s = (time.perf_counter() - t0) / args.timing_iters

    # elite_frac sharded step: the rank-threshold radix select adds 8
    # digit-histogram psum rounds (f64) to the 3 vanilla collectives —
    # measure what that costs per step across the process boundary.
    step_elite_s = 0.0
    if args.elite and args.timing_iters:
        from ccv_mppi_path_tracker_tpu.parallel.sharded import (
            build_sharded_step as _bss,
        )

        step_e = _bss(cfg, mesh, solver_options={"elite_frac": 0.25})
        c = ctrl2
        c, r = step_e(c, state, path, dt, sp, cp)  # warm
        float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
        t0 = time.perf_counter()
        for _ in range(args.timing_iters):
            c, r = step_e(c, state, path, dt, sp, cp)
        float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
        step_elite_s = (time.perf_counter() - t0) / args.timing_iters

    # Two-cycle pipelined (collective/compute overlap) step: cycle n's
    # solve consumes PRE-DRAWN noise; cycle n+1's standard normals are drawn
    # inside the same jitted program, dependent only on the carried PRNG key
    # — never on this cycle's pmin/psum — so XLA is free to overlap
    # generation with the collectives. Chained timing vs the sequential
    # RNG-mode step isolates whatever overlap the backend actually realizes.
    step_overlap_s = 0.0
    if args.overlap and args.timing_iters:
        from ccv_mppi_path_tracker_tpu.core.random import shard_key
        from ccv_mppi_path_tracker_tpu.ops.sampling import (
            draw_standard_normals,
        )
        from ccv_mppi_path_tracker_tpu.solver import mppi_step as _mstep

        k_local_dev = K // n_global
        eps_spec = P(None, SAMPLES_AXIS, None)

        def local_pipelined(ctrl_in, eps, state_, path_, dt_, sp_, cp_):
            ctrl_out, res_ = _mstep(
                cfg, ctrl_in, state_, path_, dt_, sp_, cp_, noise=eps,
                axis_name=SAMPLES_AXIS, num_samples=k_local_dev,
            )
            # SAME generator as the sequential arm's in-step draw (rbg via
            # draw_standard_normals) so the only difference between the arms
            # is WHERE the draw sits relative to the collectives
            nk = shard_key(jax.random.fold_in(ctrl_out.key, 7), SAMPLES_AXIS)
            eps_next = draw_standard_normals(
                nk, (T - 1, k_local_dev, 5), dtype
            )
            return ctrl_out, eps_next, res_

        pipe = jax.jit(jax.shard_map(
            local_pipelined, mesh=mesh,
            in_specs=(P(), eps_spec, P(), P(), P(), P(), P()),
            out_specs=(P(), eps_spec, P()),
        ))

        def local_draw(ctrl_in):
            nk = shard_key(jax.random.fold_in(ctrl_in.key, 7), SAMPLES_AXIS)
            return draw_standard_normals(nk, (T - 1, k_local_dev, 5), dtype)

        draw0 = jax.jit(jax.shard_map(
            local_draw, mesh=mesh, in_specs=(P(),), out_specs=eps_spec,
        ))
        c = ctrl2
        eps = draw0(c)
        c, eps, r = pipe(c, eps, state, path, dt, sp, cp)  # warm
        float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
        # interleave the two arms against load drift (same discipline as
        # _grad_bench); min over reps per arm. Overwrites the earlier
        # sequential number with the interleaved one so the committed
        # comparison is same-window.
        reps = 4
        inner = max(2, args.timing_iters // reps)
        seq_t, pipe_t = [], []
        for _ in range(reps):
            cs = ctrl2
            t0 = time.perf_counter()
            for _ in range(inner):
                cs, rs = step(cs, state, path, dt, sp, cp)
            float(np.asarray(rs.u_opt.addressable_data(0))[0, 0])
            seq_t.append((time.perf_counter() - t0) / inner)
            t0 = time.perf_counter()
            for _ in range(inner):
                c, eps, r = pipe(c, eps, state, path, dt, sp, cp)
            float(np.asarray(r.u_opt.addressable_data(0))[0, 0])
            pipe_t.append((time.perf_counter() - t0) / inner)
        step_s = min(seq_t)
        step_overlap_s = min(pipe_t)

    grad_extra = {}
    if args.grad_batch:
        grad_extra = _grad_bench(args, mesh, dtype, put)

    np.savez(
        args.out,
        u_opt=u_opt,
        min_cost=min_cost,
        ess=ess,
        step_s=step_s,
        step_elite_s=step_elite_s,
        step_overlap_s=step_overlap_s,
        n_global_devices=n_global,
        process_count=jax.process_count(),
        **grad_extra,
    )
    print(f"process {args.process_id}: ok, {n_global} global devices, "
          f"step={step_s * 1e3:.2f} ms", flush=True)


def grad_bench_data(batch, horizon, dtype):
    """Deterministic synthetic transitions, shared by every process and by
    tests/test_multiprocess.py's single-process cross-check."""
    import numpy as np

    state0 = np.zeros((batch, 3), dtype)
    controls = np.random.RandomState(1).randn(horizon, batch, 2).astype(dtype) * 0.5
    observed = np.random.RandomState(2).randn(horizon, batch, 3).astype(dtype) * 0.1
    return state0, controls, observed


def _grad_bench(args, mesh, dtype, put):
    """System-ID gradient all-reduce: sequential (one psum after the whole
    backward) vs backward-overlapped bucketed psums
    (diff/system_id.py rollout_prediction_value_and_grad)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ccv_mppi_path_tracker_tpu.diff.system_id import (
        ControlGains,
        rollout_prediction_value_and_grad,
    )
    from ccv_mppi_path_tracker_tpu.parallel import SAMPLES_AXIS

    B, Tg = args.grad_batch, args.grad_horizon
    state0, controls, observed = grad_bench_data(B, Tg, dtype)
    b_proc = B // args.num_processes
    sl = slice(args.process_id * b_proc, (args.process_id + 1) * b_proc)
    mk = jax.make_array_from_process_local_data
    state0_g = mk(NamedSharding(mesh, P(SAMPLES_AXIS, None)), state0[sl],
                  global_shape=state0.shape)
    csh = NamedSharding(mesh, P(None, SAMPLES_AXIS, None))
    controls_g = mk(csh, controls[:, sl], global_shape=controls.shape)
    observed_g = mk(csh, observed[:, sl], global_shape=observed.shape)
    params = put(ControlGains(gains=jnp.ones((2,), dtype)))

    def make(num_chunks):
        def f(p, s0, c, o):
            return rollout_prediction_value_and_grad(
                "unicycle", p, s0, c, o, jnp.asarray(0.1, dtype),
                axis_name=SAMPLES_AXIS, num_chunks=num_chunks,
            )

        return jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(), P(SAMPLES_AXIS, None), P(None, SAMPLES_AXIS, None),
                      P(None, SAMPLES_AXIS, None)),
            out_specs=(P(), P()),
        ))

    chunk_counts = (1, 4, 8)
    fns = {c: make(c) for c in chunk_counts}
    out = {}
    for c, fn in fns.items():  # warm + record values
        loss, grad = fn(params, state0_g, controls_g, observed_g)
        out[f"grad_loss_{c}"] = float(np.asarray(loss.addressable_data(0)))
        out[f"grad_gains_{c}"] = np.asarray(grad.gains.addressable_data(0))
    reps, inner = 5, 10
    times = {c: [] for c in chunk_counts}
    for _ in range(reps):  # interleave the arms against load drift
        for c, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(inner):
                loss, grad = fn(params, state0_g, controls_g, observed_g)
            float(np.asarray(grad.gains.addressable_data(0))[0])
            times[c].append((time.perf_counter() - t0) / inner)
    for c in chunk_counts:
        out[f"grad_ms_{c}"] = min(times[c]) * 1e3
    return out


if __name__ == "__main__":
    main()
