"""Named experiment presets — the reference's *launch-file* operating points.

The node constructor defaults (core/config.py) are deliberately untuned; the
actual experiments override them per launch file. These presets reproduce
those operating points, each returning (cfg, sp, cp, course):

- :func:`diff_drive_launch` — launch/diff_drive_mppi.launch:6-17
  (path_weight 10, v_ref 1.2, v_max 2.0; sine course A=1.0, f=0.25, delta=0).
- :func:`steering_launch` — launch/steering_diff_drive_mppi.launch:7-28
  (K=1000 override, same weights/course).
- :func:`full_body_launch` — launch/full_body_mppi.launch:7-22,29-31
  (v_ref 2.0, path 10, zmp 10, roll_v 0.5, yaw 2, back 1, roll_off true;
  course A=1.5, f=0.127, delta=0).
"""

from __future__ import annotations

import numpy as np

from ccv_mppi_path_tracker_tpu.core.config import (
    diff_drive_config,
    full_body_config,
    rate_limited_steering_config,
    steering_diff_drive_config,
)
from ccv_mppi_path_tracker_tpu.paths.courses import sum_of_cosines_course


def _course(amplitude, frequency, length, dtype):
    return sum_of_cosines_course(
        amplitudes=(amplitude, 0.0, 0.0),
        frequencies=(frequency, 0.0, 0.0),
        deltas=(0.0, 0.0, 0.0),
        resolution=0.1,
        course_length=length,
        dtype=dtype,
    )


def diff_drive_launch(num_samples=1000, horizon=15, dtype=np.float32):
    cfg, sp, cp = diff_drive_config(
        num_samples=num_samples,
        horizon=horizon,
        path_weight=10.0,
        v_weight=1.0,
        v_ref=1.2,
        v_max=2.0,
        dtype=dtype,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


def steering_launch(num_samples=1000, horizon=15, dtype=np.float32):
    cfg, sp, cp = steering_diff_drive_config(
        num_samples=num_samples,
        horizon=horizon,
        path_weight=10.0,
        v_weight=1.0,
        v_ref=1.2,
        v_max=2.0,
        dtype=dtype,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


def full_body_launch(num_samples=10000, horizon=15, dtype=np.float32, roll_off=True):
    cfg, sp, cp = full_body_config(
        num_samples=num_samples,
        horizon=horizon,
        v_ref=2.0,
        v_max=2.0,
        path_weight=10.0,
        v_weight=1.0,
        zmp_weight=10.0,
        roll_v_weight=0.5,
        back_weight=1.0,
        yaw_weight=2.0,
        roll_off=roll_off,
        dtype=dtype,
    )
    return cfg, sp, cp, _course(1.5, 0.127, 20.0, dtype)


def rate_limited_launch(num_samples=10000, horizon=15, dtype=np.float32):
    """Tuned operating point for the rate-limited steering family (a
    beyond-reference model, BASELINE.md) on the diff-drive course. Single
    home for the config bench.py and chip_smoke.py share."""
    cfg, sp, cp = rate_limited_steering_config(
        num_samples=num_samples, horizon=horizon, path_weight=10.0,
        dtype=dtype,
    )
    return cfg, sp, cp, _course(1.0, 0.25, 10.0, dtype)


PRESETS = {
    "diff_drive": diff_drive_launch,
    "steering_diff_drive": steering_launch,
    "full_body": full_body_launch,
    "rate_limited_steering": rate_limited_launch,
}
