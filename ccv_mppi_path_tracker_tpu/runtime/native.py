"""ctypes bindings to the native host runtime (native/ccv_runtime.cpp).

Compiled on demand with g++ (no pybind11 needed); the .so is cached next to
the source. Exposes:

- :class:`RateExecutor` — absolute-deadline periodic scheduler (the
  reference's ros::Rate with honest deadline-miss accounting);
- :class:`SpscRing` — wait-free latest-wins record queue (the reference's
  queue_size=1 topic subscriptions);
- :class:`NativeCsvRecorder` — background-thread CSV writer;
- :func:`native_oracle_step` / :func:`native_oracle_bench_ns` — the C++
  double-precision pipeline oracle for cross-language parity and measured CPU
  baselines.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "ccv_runtime.cpp",
)
_SO = os.path.join(os.path.dirname(_SRC), "libccv_runtime.so")
_lock = threading.Lock()
_lib = None


def _build():
    # Link to a private name and rename into place, so a process that loads
    # the library while another is building it never maps a partial file.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-o", tmp, _SRC,
    ]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build {_SO} (exit {out.returncode}):\n{out.stderr}"
        )
    os.replace(tmp, _SO)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        c_d, c_vp, c_i, c_st = (
            ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
        )
        dp = ctypes.POINTER(ctypes.c_double)
        lib.ccv_rate_new.restype = c_vp
        lib.ccv_rate_new.argtypes = [c_d]
        lib.ccv_rate_sleep.restype = c_d
        lib.ccv_rate_sleep.argtypes = [c_vp]
        lib.ccv_rate_stats.argtypes = [c_vp, dp]
        lib.ccv_rate_free.argtypes = [c_vp]
        lib.ccv_ring_new.restype = c_vp
        lib.ccv_ring_new.argtypes = [c_st, c_st]
        lib.ccv_ring_push.argtypes = [c_vp, ctypes.c_void_p]
        lib.ccv_ring_pop.restype = c_i
        lib.ccv_ring_pop.argtypes = [c_vp, ctypes.c_void_p]
        lib.ccv_ring_latest.restype = ctypes.c_int64
        lib.ccv_ring_latest.argtypes = [c_vp, ctypes.c_void_p]
        lib.ccv_ring_size.restype = c_st
        lib.ccv_ring_size.argtypes = [c_vp]
        lib.ccv_ring_free.argtypes = [c_vp]
        lib.ccv_csv_open.restype = c_vp
        lib.ccv_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, c_i]
        lib.ccv_csv_row.argtypes = [c_vp, dp, c_i]
        lib.ccv_csv_close.argtypes = [c_vp]
        lib.ccv_oracle_step.argtypes = [
            c_i, c_i, c_i, c_i, dp, dp, dp, c_i, dp, dp, dp, c_vp, dp, dp,
        ]
        lib.ccv_oracle_bench_ns.restype = c_d
        lib.ccv_oracle_bench_ns.argtypes = [
            c_i, c_i, c_i, c_i, dp, dp, dp, c_i, dp, dp, dp, c_vp, c_i,
        ]
        _lib = lib
        return lib


class _OracleParams(ctypes.Structure):
    _fields_ = [
        ("control_noise", ctypes.c_double),
        ("lambda_", ctypes.c_double),
        ("v_ref", ctypes.c_double),
        ("resolution", ctypes.c_double),
        ("dt", ctypes.c_double),
        ("path_weight", ctypes.c_double),
        ("v_weight", ctypes.c_double),
        ("zmp_weight", ctypes.c_double),
        ("roll_v_weight", ctypes.c_double),
        ("back_weight", ctypes.c_double),
        ("yaw_weight", ctypes.c_double),
        ("mass", ctypes.c_double),
        ("base2com", ctypes.c_double),
        ("inertia", ctypes.c_double * 3),
        ("gravity_z", ctypes.c_double),
        ("steer_off", ctypes.c_int),
        ("steer_max", ctypes.c_double),
        ("rate_max", ctypes.c_double),
    ]


MODEL_IDS = {
    "unicycle": 0,
    "steering_unicycle": 1,
    "full_body": 2,
    "rate_limited_steering": 3,
}


class RateExecutor:
    """Fixed-rate loop: ``for _ in range(n): dt = rate.sleep()``."""

    def __init__(self, hz: float):
        self._lib = load_library()
        self._h = self._lib.ccv_rate_new(hz)

    def sleep(self) -> float:
        return self._lib.ccv_rate_sleep(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_double * 4)()
        self._lib.ccv_rate_stats(self._h, out)
        return {
            "cycles": int(out[0]),
            "deadline_misses": int(out[1]),
            "mean_dt": out[2],
            "max_abs_jitter": out[3],
        }

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ccv_rate_free(self._h)
            self._h = None


class SpscRing:
    """Latest-wins ring of float64 records of fixed length.

    Strictly single-producer/single-consumer. When the ring is full the
    producer drops the oldest unread record (queue_size=1 topic semantics);
    a consumer popping concurrently with an overwrite of the same slot can
    observe a dropped record — size the capacity above the expected burst if
    every record matters, or use :meth:`latest` (the control-loop pattern),
    which only ever reads the newest slot."""

    def __init__(self, capacity: int, record_len: int):
        self._lib = load_library()
        self.record_len = record_len
        self._h = self._lib.ccv_ring_new(capacity, record_len * 8)

    def push(self, record) -> None:
        rec = np.ascontiguousarray(record, np.float64)
        assert rec.size == self.record_len
        self._lib.ccv_ring_push(self._h, rec.ctypes.data_as(ctypes.c_void_p))

    def pop(self):
        out = np.empty(self.record_len, np.float64)
        if self._lib.ccv_ring_pop(self._h, out.ctypes.data_as(ctypes.c_void_p)):
            return out
        return None

    def latest(self):
        """Returns (seq, record) of the newest write, or (None, None)."""
        out = np.empty(self.record_len, np.float64)
        seq = self._lib.ccv_ring_latest(self._h, out.ctypes.data_as(ctypes.c_void_p))
        if seq < 0:
            return None, None
        return int(seq), out

    def __len__(self):
        return int(self._lib.ccv_ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ccv_ring_free(self._h)
            self._h = None


class NativeCsvRecorder:
    """CSV writer whose fwrite happens on a native background thread."""

    def __init__(self, path: str, columns):
        self._lib = load_library()
        self.ncols = len(columns)
        self._h = self._lib.ccv_csv_open(
            path.encode(), ",".join(columns).encode(), self.ncols
        )
        if not self._h:
            raise OSError(f"cannot open {path}")

    def row(self, values) -> None:
        vals = np.ascontiguousarray(values, np.float64)
        self._lib.ccv_csv_row(
            self._h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            vals.size,
        )

    def close(self) -> None:
        if self._h:
            self._lib.ccv_csv_close(self._h)
            self._h = None


def _pack_params(
    resolution, dt, control_noise, lam, v_ref, cp=None, model_params=None,
    steer_off=False,
):
    p = _OracleParams()
    p.control_noise = float(control_noise)
    p.lambda_ = float(lam)
    p.v_ref = float(v_ref)
    p.resolution = float(resolution)
    p.dt = float(dt)
    weights = dict(
        path_weight=1.0, v_weight=1.0, zmp_weight=1.0, roll_v_weight=1.0,
        back_weight=1.0, yaw_weight=1.0,
    )
    if cp is not None:
        for k in weights:
            weights[k] = float(np.asarray(getattr(cp, k)))
    for k, v in weights.items():
        setattr(p, k, v)
    if model_params is not None:
        p.mass = float(np.asarray(model_params.mass))
        p.base2com = float(np.asarray(model_params.base2com))
        for i in range(3):
            p.inertia[i] = float(np.asarray(model_params.inertia)[i])
        p.gravity_z = float(np.asarray(model_params.gravity_z))
    else:
        p.mass, p.base2com, p.gravity_z = 60.0, 0.8075 / 2, -9.8
    p.steer_off = int(steer_off)
    from ccv_mppi_path_tracker_tpu.models.rate_limited_steering import (
        RATE_MAX,
        STEER_MAX,
    )

    p.steer_max = STEER_MAX
    p.rate_max = RATE_MAX
    return p


def native_oracle_step(
    model, u_prev, state, path_xy, resolution, dt, noise, control_noise, lam,
    u_min, u_max, v_ref, cp=None, model_params=None, steer_off=False,
):
    """C++ oracle control update. Returns dict(u_opt (T-1,U), costs (K,))."""
    lib = load_library()
    u_prev = np.ascontiguousarray(u_prev, np.float64)
    state = np.ascontiguousarray(state, np.float64)
    path_xy = np.ascontiguousarray(path_xy, np.float64)
    noise = np.ascontiguousarray(noise, np.float64)
    u_min = np.ascontiguousarray(u_min, np.float64)
    u_max = np.ascontiguousarray(u_max, np.float64)
    tm1, k, u_dim = noise.shape
    params = _pack_params(
        resolution, dt, control_noise, lam, v_ref, cp, model_params, steer_off
    )
    u_opt = np.zeros((tm1, u_dim))
    costs = np.zeros(k)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ccv_oracle_step(
        MODEL_IDS[model], tm1 + 1, k, u_dim,
        state.ctypes.data_as(dp), u_prev.ctypes.data_as(dp),
        path_xy.ctypes.data_as(dp), len(path_xy), noise.ctypes.data_as(dp),
        u_min.ctypes.data_as(dp), u_max.ctypes.data_as(dp),
        ctypes.byref(params), u_opt.ctypes.data_as(dp),
        costs.ctypes.data_as(dp),
    )
    return {"u_opt": u_opt, "costs": costs}


def native_oracle_bench_ns(
    model, u_prev, state, path_xy, resolution, dt, noise, control_noise, lam,
    u_min, u_max, v_ref, cp=None, model_params=None, steer_off=False,
    iters=10,
):
    """Measured serial-CPU ns per full control update (the honest baseline)."""
    lib = load_library()
    u_prev = np.ascontiguousarray(u_prev, np.float64)
    state = np.ascontiguousarray(state, np.float64)
    path_xy = np.ascontiguousarray(path_xy, np.float64)
    noise = np.ascontiguousarray(noise, np.float64)
    u_min = np.ascontiguousarray(u_min, np.float64)
    u_max = np.ascontiguousarray(u_max, np.float64)
    tm1, k, u_dim = noise.shape
    params = _pack_params(
        resolution, dt, control_noise, lam, v_ref, cp, model_params, steer_off
    )
    dp = ctypes.POINTER(ctypes.c_double)
    return lib.ccv_oracle_bench_ns(
        MODEL_IDS[model], tm1 + 1, k, u_dim,
        state.ctypes.data_as(dp), u_prev.ctypes.data_as(dp),
        path_xy.ctypes.data_as(dp), len(path_xy), noise.ctypes.data_as(dp),
        u_min.ctypes.data_as(dp), u_max.ctypes.data_as(dp),
        ctypes.byref(params), iters,
    )
