#!/usr/bin/env python
"""Regenerate examples/figures/ — the reference's paper-figure set.

Each figure restates one of the reference's matplotlib scripts (SURVEY.md
section 2.4) from a framework run:
  diff_drive_tracking / full_body_tracking  <- graph2.py layout
  yaw_comparison                            <- graph3.py layout
  zmp_controlled                            <- zmp_graph.py layout
  solver_debug                              <- rviz candidate/optimal view
  feasible_region                           <- v_w_performance.py
  course_curvature / square_wave_course     <- calc_curveture.py / ref_path_analyze.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/root/repo/.jax_cache")

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])

from ccv_mppi_path_tracker_tpu.core import ControllerState
from ccv_mppi_path_tracker_tpu.core.presets import (
    diff_drive_launch,
    full_body_launch,
)
from ccv_mppi_path_tracker_tpu.metrics import plots
from ccv_mppi_path_tracker_tpu.paths import PathBuffer
from ccv_mppi_path_tracker_tpu.runtime import run_tracking_experiment
from ccv_mppi_path_tracker_tpu.solver import mppi_step

OUT = os.path.join(os.path.dirname(__file__), "..", "examples", "figures")


def main():
    os.makedirs(OUT, exist_ok=True)

    cfg, sp, cp, course = diff_drive_launch(num_samples=1024)
    dd = run_tracking_experiment(cfg, sp, cp, course, num_steps=120)
    plots.plot_tracking(dd, out=f"{OUT}/diff_drive_tracking.png")
    plots.plot_yaw_comparison(dd, out=f"{OUT}/yaw_comparison.png")
    print("diff_drive RMSE:", dd["metrics"]["rmse"])

    cfg, sp, cp, course = full_body_launch(num_samples=4096)
    fb = run_tracking_experiment(cfg, sp, cp, course, num_steps=150)
    plots.plot_tracking(fb, out=f"{OUT}/full_body_tracking.png", label="Full-body MPPI")
    print("full_body RMSE:", fb["metrics"]["rmse"])

    # ZMP figure from the full-stack sensing->estimation->control pipeline
    # (controlled vs uncontrolled, zmp_graph.py layout / the reference's
    # log/full_body/robo_sym PNG pair)
    from ccv_mppi_path_tracker_tpu.runtime.sim_sensors import (
        run_full_stack_experiment,
    )

    on = run_full_stack_experiment(roll_off=False, cycles=80)
    t = np.arange(len(on["zmp"])) * 0.1
    plots.plot_zmp(t, on["zmp"], v=None, roll=on["traj"][1:, 3],
                   true_zmp=on["true_zmp"], out=f"{OUT}/zmp_controlled.png")
    print("full-stack (controlled) RMSE:", on["metrics"]["rmse"])

    # TWO-RUN overlay comparisons — the reference's actual headline figures
    # (graph2.py:37-41 with/without steering; zmp_graph2.py + the archived
    # controlled/uncontrolled PNG pair).
    from ccv_mppi_path_tracker_tpu.core.presets import steering_launch

    scfg, ssp, scp, scourse = steering_launch(num_samples=2048)
    steered = run_tracking_experiment(scfg, ssp, scp, scourse, num_steps=150)
    dcfg, dsp, dcp, _ = diff_drive_launch(num_samples=2048)
    unsteered = run_tracking_experiment(dcfg, dsp, dcp, scourse,
                                        num_steps=150)
    plots.plot_tracking_comparison(
        {"With Steering Robot": steered, "Without Steering Robot": unsteered},
        out=f"{OUT}/tracking_comparison.png",
    )
    print("steered RMSE:", steered["metrics"]["rmse"],
          "unsteered RMSE:", unsteered["metrics"]["rmse"])

    from ccv_mppi_path_tracker_tpu.models.full_body import default_params

    # NOTE: full_body_launch DEFAULTS to roll_off=True (the reference's
    # launch default); the controlled arm must ask for the roll controller
    ccfg, csp, ccp, ccourse = full_body_launch(num_samples=4096,
                                               roll_off=False)
    controlled = run_tracking_experiment(ccfg, csp, ccp, ccourse,
                                         num_steps=150)
    ucfg, usp, ucp, _ = full_body_launch(num_samples=4096, roll_off=True)
    uncontrolled = run_tracking_experiment(ucfg, usp, ucp, ccourse,
                                           num_steps=150)
    plots.plot_zmp_comparison(
        {"Controlled": controlled, "Not Controlled": uncontrolled},
        default_params(np.float32), out=f"{OUT}/zmp_comparison.png",
    )

    # solver debug (rviz candidate/optimal/reference view)
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=12)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), 12, 2)
    state = jnp.asarray([0.0, float(course[0, 1]), 0.0], jnp.float32)
    _, res = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                       debug_candidates=48)
    plots.plot_solver_debug(res, course=course, out=f"{OUT}/solver_debug.png")

    plots.plot_feasible_region(out=f"{OUT}/feasible_region.png", n=40)
    plots.plot_course_curvature(course, out=f"{OUT}/course_curvature.png")
    plots.plot_filtered_square_analysis(out=f"{OUT}/square_wave_course.png")
    print("figures ->", os.path.abspath(OUT))


if __name__ == "__main__":
    main()
