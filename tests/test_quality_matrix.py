"""CI gate on representative tracking-quality-matrix cells.

The committed artifact (artifacts/quality_matrix.json, built by
scripts/quality_matrix.py) sweeps the reference's full evaluation
grid — controllers x courses x v_ref in {0.4, 1.2, 2.0}, MPPI vs
pure-pursuit, ZMP controlled-vs-uncontrolled (src/calc_e_rmse.py metric,
launch/full_body_mppi.launch operating points). These tests re-run a small
representative subset at reduced K on CPU so a solver regression that would
flip matrix cells fails CI; the ZMP-reduction cell is gated separately in
tests/test_full_stack_sim.py.
"""

import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "scripts")
)

import quality_matrix as qm  # noqa: E402


def _cell(ctrl_name, course_name, v_ref, quick=True, **kw):
    course = qm.courses()[course_name]
    cfg, sp, cp = qm.controller_configs(v_ref, quick=quick)[ctrl_name]
    cell = qm.eval_mppi(cfg, sp, cp, course, v_ref, quick=quick, **kw)
    pp = qm.eval_pure_pursuit(course, v_ref, quick=quick)
    return cell, pp


def test_diff_drive_beats_pure_pursuit_on_launch_course():
    # the reference's own diff-drive operating point (A=1.0 f=0.25, v=1.2)
    cell, pp = _cell("diff_drive", "cosine_A1.0_f0.25", 1.2)
    assert cell["completed"], cell
    assert cell["rmse_m"] <= pp["rmse_m"], (cell, pp)
    assert cell["rmse_m"] < 0.15, cell


def test_steering_beats_pure_pursuit_on_filtered_square():
    # the square-wave course at its launch params (fs=10, wave_hz=0.2).
    # At v_ref=1.2 the corners are tight enough that the controller slows
    # far below v_ref (so the quick-K run does not finish inside the CI step
    # budget); the gate here is tracking quality vs the baseline.
    cell, pp = _cell("steering", "filtered_square", 1.2)
    assert cell["rmse_m"] <= pp["rmse_m"], (cell, pp)
    assert cell["max_error_m"] < pp["max_error_m"], (cell, pp)


def test_full_body_tracks_at_v2_with_zmp_cost():
    # flagship at the v_ref=2.0 operating point, ZMP cost active
    cell, pp = _cell("full_body", "cosine_A1.5_f0.127", 2.0)
    assert cell["completed"], cell
    assert cell["rmse_m"] <= max(pp["rmse_m"], 0.12), (cell, pp)


def test_completion_truncation():
    course = np.stack([np.linspace(0, 10, 101), np.zeros(101)], axis=-1)
    xy = np.stack([np.linspace(0, 12, 121), np.zeros(121)], axis=-1)
    n, completed = qm.truncate_at_completion(xy, course)
    assert completed
    # the docstring criterion (ADVICE r4): the first sample whose NEAREST
    # course point is the final one AND that is within 0.5 m of it —
    # x = 9.96 at index 100, not merely the first sample within 0.5 m
    assert n == 101
    n2, completed2 = qm.truncate_at_completion(xy[:50], course)
    assert not completed2 and n2 == 50


def test_completion_truncation_self_near_course():
    """A course whose early segment passes near its own ENDPOINT must not
    truncate there (the ADVICE r4 failure mode): an out-and-back course
    where the start is 0.3 m from the endpoint."""
    fwd = np.stack([np.linspace(0, 5, 51), np.zeros(51)], axis=-1)
    back = np.stack([np.linspace(5, 0.0, 50), np.full(50, 0.3)], axis=-1)
    course = np.concatenate([fwd, back])
    xy = np.concatenate([fwd, back])  # perfect tracking of the whole loop
    n, completed = qm.truncate_at_completion(xy, course)
    assert completed
    # must run to the actual end, not cut at the start (0.3 m from (0,0.3))
    assert n == len(xy), n
