"""Native C++ runtime: build, primitives, and cross-language oracle parity."""

import time

import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu.runtime.native import (
    NativeCsvRecorder,
    RateExecutor,
    SpscRing,
    load_library,
    native_oracle_bench_ns,
    native_oracle_step,
)
from ccv_mppi_path_tracker_tpu.oracle import oracle_step
from ccv_mppi_path_tracker_tpu.paths import sum_of_cosines_course
from ccv_mppi_path_tracker_tpu.models.full_body import default_params


def test_library_builds_and_loads():
    lib = load_library()
    assert lib is not None


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s own diagnostics and
    leaves no library behind for a later load to pick up."""
    from ccv_mppi_path_tracker_tpu.runtime import native as native_mod

    src = tmp_path / "broken.cpp"
    src.write_text("int f() { return undeclared_name; }\n")
    so = tmp_path / "libbroken.so"
    monkeypatch.setattr(native_mod, "_SRC", str(src))
    monkeypatch.setattr(native_mod, "_SO", str(so))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native_mod._build()
    assert not so.exists()


def _overloaded(threshold: float = 1.5) -> bool:
    """True when the box is too loaded for wall-clock timing assertions to
    mean anything (1-min loadavg per core above ``threshold``)."""
    import os

    try:
        return os.getloadavg()[0] / (os.cpu_count() or 1) > threshold
    except OSError:
        return False


def test_rate_executor_accounting_is_self_consistent():
    """Load-independent invariants: cycle count, non-negative dt, and the
    stats' mean_dt agreeing with an external wall clock."""
    r = RateExecutor(200.0)  # 5 ms period
    t0 = time.perf_counter()
    dts = [r.sleep() for _ in range(50)]
    wall = time.perf_counter() - t0
    s = r.stats()
    assert s["cycles"] == 50
    assert all(dt >= 0.0 for dt in dts)
    # executor's own accounting vs an external clock: first sleep() returns
    # the creation->tick delta, so compare totals within a lenient 20%.
    np.testing.assert_allclose(s["mean_dt"] * 50, wall, rtol=0.2)
    # a rate executor can never run FASTER than its period on average
    assert s["mean_dt"] >= 0.005 * 0.99


def test_rate_executor_holds_rate_or_accounts_for_misses():
    """The timing CONTRACT, asserted unconditionally (no load skip): an
    absolute-deadline executor may only deviate from its period when the
    kernel stalls it past a deadline, and every such stall must show up in
    ``deadline_misses`` (the re-anchor + miss accounting,
    native/ccv_runtime.cpp). So on EVERY box, loaded or not:
    either mean_dt is within tolerance of the period, or misses > 0 explain
    the deviation — silent drift is a failure anywhere. The tight
    wall-clock quality bound additionally applies on a quiet box."""
    last = None
    for attempt in range(4):
        r = RateExecutor(200.0)  # 5 ms period
        [r.sleep() for _ in range(50)]
        s = r.stats()
        assert s["cycles"] == 50
        # never faster than the period on average (load-independent)
        assert s["mean_dt"] >= 0.005 * 0.99, s
        # contract: deviation beyond jitter tolerance requires accounted
        # deadline misses
        held = abs(s["mean_dt"] - 0.005) < 0.001
        assert held or s["deadline_misses"] > 0, (
            f"drift without accounted misses: {s}"
        )
        last = s
        if held:
            return  # quality bound met — done, loaded box or not
        if _overloaded():
            # contract held (misses accounted); quality bound is
            # unachievable under this load — accept after asserting it
            return
    raise AssertionError(f"rate not held on a quiet box: {last}")


def test_spsc_ring_latest_wins():
    q = SpscRing(capacity=4, record_len=3)
    assert q.latest() == (None, None)
    for i in range(10):
        q.push([i, i * 2.0, i * 3.0])
    seq, rec = q.latest()
    assert seq == 9
    np.testing.assert_allclose(rec, [9, 18, 27])
    # pop drains oldest retained records (capacity 4)
    first = q.pop()
    assert first is not None and first[0] == 6.0
    assert len(q) == 3


def test_native_csv_recorder(tmp_path):
    p = str(tmp_path / "out.csv")
    rec = NativeCsvRecorder(p, ["a", "b", "c"])
    for i in range(100):
        rec.row([i, i * 0.5, np.nan])
    rec.close()
    lines = open(p).read().strip().split("\n")
    assert lines[0] == "a,b,c"
    assert len(lines) == 101
    assert lines[1] == "0,0,"  # NaN -> empty cell
    assert lines[100].startswith("99,49.5,")


@pytest.mark.parametrize("model,u_dim", [
    ("unicycle", 2), ("steering_unicycle", 3), ("full_body", 5),
])
def test_cpp_oracle_matches_python_oracle(model, u_dim):
    """The C++ oracle and the NumPy oracle implement identical semantics."""
    rng = np.random.RandomState(0)
    T, K = 10, 32
    course = sum_of_cosines_course(course_length=10.0)
    u_prev = rng.randn(T - 1, u_dim) * 0.1
    state = np.zeros(5 if model == "full_body" else 3)
    state[2] = 0.1
    noise = rng.randn(T - 1, K, u_dim)
    u_min = np.full(u_dim, -2.0)
    u_max = np.full(u_dim, 2.0)
    p = default_params(np.float64)

    py = oracle_step(
        model, u_prev, state, course, 0.1, 0.1, noise,
        control_noise=0.5, lam=1.0, u_min=u_min, u_max=u_max, v_ref=0.8,
        mass=float(p.mass), base2com=float(p.base2com),
        inertia=np.asarray(p.inertia), gravity_z=float(p.gravity_z),
    )
    cc = native_oracle_step(
        model, u_prev, state, course, 0.1, 0.1, noise,
        control_noise=0.5, lam=1.0, u_min=u_min, u_max=u_max, v_ref=0.8,
        model_params=p,
    )
    np.testing.assert_allclose(cc["costs"], py["costs"], rtol=1e-12)
    np.testing.assert_allclose(cc["u_opt"], py["u_opt"], rtol=1e-12)


def test_cpp_oracle_bench_runs():
    rng = np.random.RandomState(1)
    T, K = 15, 256
    course = sum_of_cosines_course(course_length=10.0)
    noise = rng.randn(T - 1, K, 2)
    ns = native_oracle_bench_ns(
        "unicycle", np.zeros((T - 1, 2)), np.zeros(3), course, 0.1, 0.1,
        noise, 0.5, 1.0, [-1.2, -2.0], [1.2, 2.0], 0.8, iters=3,
    )
    assert ns > 0


def test_realtime_experiment_holds_rate_and_tracks():
    """Full native-runtime integration: RateExecutor + InputGate + solver +
    native CSV recorder at 50 Hz on CPU."""
    import tempfile, os
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.runtime.realtime import run_realtime_experiment

    cfg, sp, cp, course = diff_drive_launch(num_samples=128)
    with tempfile.TemporaryDirectory() as d:
        rec = os.path.join(d, "rt.csv")
        out = run_realtime_experiment(
            cfg, sp, cp, course, hz=50.0, num_cycles=60, record_path=rec
        )
        lines = open(rec).read().strip().split("\n")
        assert len(lines) == 61
    rs = out["rate_stats"]
    # functional assertions — load-independent
    assert rs["cycles"] == 60
    assert out["metrics"]["rmse"] < 0.5
    # a stale cycle = the gate catching a real >3-period solver stall; on a
    # shared CI box an occasional OS/GC stall is expected and is exactly
    # what the gate exists to detect — assert it stays rare, not zero
    assert out["stale_cycles"] <= 3, out["stale_cycles"]
    assert rs["mean_dt"] >= 0.02 * 0.99  # never faster than the period
    # timing CONTRACT, asserted regardless of load: deviation from the 50 Hz
    # period beyond jitter tolerance must be explained by accounted deadline
    # misses (silent drift fails everywhere); the tight quality bound
    # additionally applies on a quiet box, with retries for transient spikes
    for _ in range(3):
        held = abs(rs["mean_dt"] - 0.02) < 0.006
        assert held or rs["deadline_misses"] > 0, (
            f"drift without accounted misses: {rs}"
        )
        if held or _overloaded():
            return
        out = run_realtime_experiment(cfg, sp, cp, course, hz=50.0, num_cycles=60)
        rs = out["rate_stats"]
    assert abs(rs["mean_dt"] - 0.02) < 0.006, rs


def test_pipelined_loop_tracks_and_compensates_lag():
    """run_pipelined_experiment (async pipeline): dispatch the next window
    before fetching this one's commands. The lag-compensation claim is
    asserted where it is robust — the micro_batch window handoff, whose
    model prediction bridges an M-cycle feedback latency (at depth-1 the
    one-cycle lag is benign at these operating points and the arms tie)."""
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.runtime.realtime import (
        run_pipelined_experiment,
    )

    cfg, sp, cp, course = diff_drive_launch(num_samples=256)
    out_c = run_pipelined_experiment(
        cfg, sp, cp, course, hz=50.0, num_cycles=96, micro_batch=8,
        delay_compensation=True,
    )
    out_n = run_pipelined_experiment(
        cfg, sp, cp, course, hz=50.0, num_cycles=96, micro_batch=8,
        delay_compensation=False,
    )
    assert out_c["rate_stats"]["cycles"] == 96
    assert out_c["metrics"]["rmse"] < 0.5
    # predicting the plant across the 8-cycle window must beat dispatching
    # the next window from the (8-cycles-stale) window-start state
    assert out_c["metrics"]["rmse"] < out_n["metrics"]["rmse"], (
        out_c["metrics"]["rmse"], out_n["metrics"]["rmse"])


def test_pipelined_micro_batch_streams_windows():
    """micro_batch=M: one device interaction (and one fetch) per M-cycle
    window; the window handoff predicts the end-of-window state so the plan
    stream stays continuous. Tracking must stay tight despite the M-cycle
    feedback latency."""
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.runtime.realtime import (
        run_pipelined_experiment,
    )

    cfg, sp, cp, course = diff_drive_launch(num_samples=256)
    out = run_pipelined_experiment(
        cfg, sp, cp, course, hz=50.0, num_cycles=96, micro_batch=8
    )
    assert out["feedback_latency_cycles"] == 8
    assert out["rate_stats"]["cycles"] == 96
    assert len(out["fetch_ms"]) == 3 and out["fetch_ms"]["p95"] >= 0
    assert out["metrics"]["rmse"] < 0.5, out["metrics"]


def test_pipelined_rate_limited_plant_kinematics():
    """The host-side numpy plant must match the jax model for the
    rate-limited steering family too (u[2] is a steering RATE; heading
    integrates with the steering-angle STATE, slewed and box-limited)."""
    import jax.numpy as jnp
    import numpy as np

    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.runtime.realtime import _plant_step_np

    m = get_model("rate_limited_steering")
    rng = np.random.RandomState(3)
    s = np.array([0.1, -0.2, 0.3, 0.05])
    for _ in range(20):
        u = rng.randn(3).astype(np.float32)
        s_np = _plant_step_np("rate_limited_steering", s, u, 0.1)
        s_jx = np.asarray(m.step(jnp.asarray(s, jnp.float64),
                                 jnp.asarray(u, jnp.float64),
                                 jnp.float64(0.1)))
        np.testing.assert_allclose(s_np, s_jx, rtol=1e-12, atol=1e-12)
        s = s_np
