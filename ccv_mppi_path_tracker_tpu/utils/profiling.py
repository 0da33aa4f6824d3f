"""Tracing / profiling utilities.

The reference's only observability is std::cout dt prints
(src/steering_diff_drive_mppi.cpp:382). Here: jax.profiler trace capture
around control cycles, the reduction of such a trace to per-update device
time and idle share, and a lightweight per-phase wall-clock timer whose
results feed the metrics stream.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import Counter, defaultdict

import jax


@contextlib.contextmanager
def device_trace(log_dir: str, perfetto: bool = False):
    """Capture a jax.profiler trace (view with TensorBoard / xprof).

    ``perfetto=True`` also writes the Chrome-format ``perfetto_trace.json.gz``
    that :func:`load_trace_events` reads."""
    jax.profiler.start_trace(log_dir, create_perfetto_trace=perfetto)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def load_trace_events(log_dir: str) -> list:
    """Events of the newest ``perfetto_trace.json.gz`` under ``log_dir``."""
    paths = glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "perfetto_trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no perfetto_trace.json.gz under {log_dir}")
    with gzip.open(max(paths)) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list) -> tuple[list, Counter]:
    """Complete ("X") events on the stream timelines (threads whose name
    holds "stream") of processes named ``/device:...``; a summary timeline
    over the same kernels would count them twice. Also returns the events
    per timeline name, to show what was counted."""
    meta = [e for e in events if e.get("ph") == "M"]
    procs = {e["pid"]: e["args"]["name"] for e in meta
             if e.get("name") == "process_name"}
    threads = {(e["pid"], e.get("tid")): e["args"]["name"] for e in meta
               if e.get("name") == "thread_name"}
    line = lambda e: threads.get((e["pid"], e.get("tid")), "")
    picked = [e for e in events if e.get("ph") == "X"
              and procs.get(e["pid"], "").startswith("/device:")
              and "stream" in line(e).lower()]
    return picked, Counter(line(e) for e in picked)


def summarize_device_trace(events: list, steps: int,
                           kernel_prefix: str = "mppi_fused") -> dict:
    """Per-update device numbers of a trace of ``steps`` chained updates.

    - ``device_busy_ms``: length of the union of device event intervals;
    - ``idle_share``: 1 - busy / span, where the span runs from the first
      device event's start to the last one's end (host time before the
      first event is not counted);
    - ``kernel_ms``: summed duration of events named ``kernel_prefix...``;
    - ``events``: device events per update.

    Raises ValueError when no operation ran on a device."""
    picked, lines = device_events(events)
    if not picked:
        raise ValueError("no device events in the trace")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in picked)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:  # union of intervals, in microseconds
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    span = end - spans[0][0]
    kernel = sum(e["dur"] for e in picked
                 if e.get("name", "").startswith(kernel_prefix))
    return {
        "device_busy_ms": busy / steps / 1e3,
        "idle_share": 1.0 - busy / span if span > 0 else 0.0,
        "kernel_ms": kernel / steps / 1e3,
        "events": len(picked) / steps,
        "timelines": dict(lines),
    }


class PhaseTimer:
    """Accumulating wall-clock timer: ``with timer.phase("rollout"): ...``.

    Blocks on device results when entered with a pytree via :meth:`tick` so
    async dispatch doesn't hide device time.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
