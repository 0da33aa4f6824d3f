"""Input gating and profiling utilities."""

import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu.runtime.gating import InputGate
from ccv_mppi_path_tracker_tpu.utils.profiling import (
    PhaseTimer,
    device_trace,
    load_trace_events,
    summarize_device_trace,
)


def test_input_gate_readiness_and_staleness():
    g = InputGate(stale_policy="hold")
    g.add_channel("path", max_age=1.0)
    g.add_channel("pose", max_age=0.1)
    assert not g.ready()
    g.update("path", "P", stamp=100.0)
    g.update("pose", np.array([1.0, 2.0]), stamp=100.0)
    assert g.ready()
    assert g.stale(now=100.05) == {}
    stale = g.stale(now=100.5)
    assert "pose" in stale and "path" not in stale


def test_input_gate_stale_policies():
    g = InputGate(stale_policy="hold")
    g.add_channel("pose", max_age=0.1)
    g.update("pose", 1.0, stamp=0.0)
    fresh, last = np.array([1.0, 2.0]), np.array([0.5, 0.5])
    np.testing.assert_array_equal(g.resolve_command(fresh, last, now=0.05), fresh)
    np.testing.assert_array_equal(g.resolve_command(fresh, last, now=5.0), last)
    assert g.stale_cycles == 1

    gz = InputGate(stale_policy="zero")
    gz.add_channel("pose", max_age=0.1)
    gz.update("pose", 1.0, stamp=0.0)
    np.testing.assert_array_equal(
        gz.resolve_command(fresh, last, now=5.0), np.zeros(2)
    )


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0


def _meta(kind, pid, name, tid=None):
    e = {"ph": "M", "name": kind, "pid": pid, "args": {"name": name}}
    if tid is not None:
        e["tid"] = tid
    return e


def _x(pid, tid, ts, dur, name="fusion"):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": name}


def _gpu_trace(with_summary_line):
    """Two updates on one stream (us): a kernel [0,100) overlapping a fusion
    [50,150), a gap, then a kernel [400,500). A host event and, optionally,
    a per-op summary timeline repeating the kernels must not count."""
    ev = [
        _meta("process_name", 1, "/host:CPU"),
        _meta("process_name", 2, "/device:GPU:0"),
        _meta("thread_name", 2, "Stream #13(Compute)", tid=13),
        _x(1, 7, -1000, 5000, "python"),
        _x(2, 13, 0, 100, "mppi_fused_full_body"),
        _x(2, 13, 50, 100),
        _x(2, 13, 400, 100, "mppi_fused_full_body"),
    ]
    if with_summary_line:
        ev += [_meta("thread_name", 2, "XLA Ops", tid=99),
               _x(2, 99, 0, 100, "mppi_fused_full_body"),
               _x(2, 99, 400, 100, "mppi_fused_full_body")]
    return ev


@pytest.mark.parametrize("with_summary_line", [False, True])
def test_summarize_device_trace_unions_stream_events(with_summary_line):
    out = summarize_device_trace(_gpu_trace(with_summary_line), steps=2)
    # busy = |[0,150) u [400,500)| = 250 us over 2 updates, span 500 us
    assert out["device_busy_ms"] == pytest.approx(0.125)
    assert out["idle_share"] == pytest.approx(0.5)
    assert out["kernel_ms"] == pytest.approx(0.1)
    assert out["events"] == 1.5
    assert out["timelines"] == {"Stream #13(Compute)": 3}


def test_summarize_device_trace_ignores_non_stream_device_lines():
    ev = [_meta("process_name", 2, "/device:GPU:0"),
          _meta("thread_name", 2, "XLA Ops", tid=5),
          _x(2, 5, 0, 10), _x(2, 5, 30, 10, "mppi_fused_unicycle")]
    with pytest.raises(ValueError, match="no device events"):
        summarize_device_trace(ev, steps=1)


def test_host_only_trace_is_refused(tmp_path):
    """A real trace taken on the CPU holds host events only; the reduction
    refuses it rather than report a device that did no work."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((16, 16))
    f(x).block_until_ready()
    with device_trace(str(tmp_path), perfetto=True):
        f(x).block_until_ready()
    events = load_trace_events(str(tmp_path))
    assert any(e.get("ph") == "X" for e in events)
    with pytest.raises(ValueError, match="no device events"):
        summarize_device_trace(events, steps=1)
