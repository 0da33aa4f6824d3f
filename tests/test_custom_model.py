"""Extensibility proof: a FIFTH, user-registered dynamics model
(examples/custom_model.py kinematic bicycle) traverses every major surface
— single-device step, use_kernel="auto" XLA fallback, the sharded path with
bit-tight single-vs-8-device agreement, and a closed loop with tracking
RMSE — with zero framework-core edits. (The reference's only extension
mechanism was copy-pasting a whole controller node,
src/steering_diff_drive_mppi.cpp.)
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "examples"),
)

import custom_model as cm  # noqa: E402  (registers kinematic_bicycle)

from ccv_mppi_path_tracker_tpu.core import ControllerState  # noqa: E402
from ccv_mppi_path_tracker_tpu.models import get_model  # noqa: E402
from ccv_mppi_path_tracker_tpu.solver import MPPISolver, mppi_step  # noqa: E402


def test_registration_and_config_resolution():
    m = get_model("kinematic_bicycle")
    assert m is cm.BICYCLE
    cfg, sp, cp, course, path = cm.make_problem(num_samples=64, horizon=8)
    # SolverConfig resolves S/U through the registry for custom models
    assert (cfg.num_states, cfg.num_controls) == (3, 2)


def test_auto_kernel_falls_back_to_xla():
    from ccv_mppi_path_tracker_tpu.kernels import should_use_kernel

    assert not should_use_kernel(
        1 << 20, 30, model="kinematic_bicycle",
        device_kind="NVIDIA H100 80GB HBM3",
    )
    cfg, *_ = cm.make_problem(num_samples=1 << 14, horizon=30)
    solver = MPPISolver(cfg, use_kernel="auto")
    assert solver.use_kernel is False


def test_single_device_step_and_sharded_match():
    from ccv_mppi_path_tracker_tpu.parallel import (
        build_sharded_step,
        samples_mesh,
    )

    K, T = 256, 10
    cfg, sp, cp, course, path = cm.make_problem(num_samples=K, horizon=T)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 2)
    state = jnp.asarray([0.0, float(course[0, 1]), 0.0], jnp.float32)
    noise = jnp.asarray(
        np.random.RandomState(3).randn(T - 1, K, 2), jnp.float32
    )
    dt = jnp.float32(0.1)
    _, res1 = jax.jit(
        lambda c, s, n: mppi_step(cfg, c, s, path, dt, sp, cp, noise=n)
    )(ctrl, state, noise)
    assert res1.u_opt.shape == (T - 1, 2)
    assert np.isfinite(np.asarray(res1.u_opt)).all()

    mesh = samples_mesh(num_devices=8)
    step8 = build_sharded_step(cfg, mesh)
    _, res8 = step8(ctrl, state, path, dt, sp, cp, noise=noise)
    np.testing.assert_allclose(
        np.asarray(res8.u_opt), np.asarray(res1.u_opt), rtol=1e-6, atol=1e-7
    )


def test_closed_loop_tracks():
    m = cm.closed_loop_rmse(steps=100, num_samples=1024, horizon=16)
    assert m["rmse"] < 0.15, m
    assert m["max_error"] < 0.35, m


def test_custom_cost_fn_changes_objective():
    """Model.cost_fn extension point: the steering-effort variant must
    produce a lower-|steer| update than the plain bicycle under identical
    noise, and gradient refinement must differentiate the custom cost."""
    from ccv_mppi_path_tracker_tpu.core import SolverConfig

    K, T = 512, 12
    cfg_a, sp, cp, course, path = cm.make_problem(num_samples=K, horizon=T)
    cfg_b = SolverConfig(
        model="kinematic_bicycle_effort", num_samples=K, horizon=T
    )
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 2)
    # start off-path so tracking demands steering; effort cost should damp it
    state = jnp.asarray([0.0, float(course[0, 1]) + 0.4, 0.0], jnp.float32)
    noise = jnp.asarray(
        np.random.RandomState(4).randn(T - 1, K, 2), jnp.float32
    )
    dt = jnp.float32(0.1)
    _, ra = mppi_step(cfg_a, ctrl, state, path, dt, sp, cp, noise=noise)
    _, rb = mppi_step(cfg_b, ctrl, state, path, dt, sp, cp, noise=noise)
    # the solver actually used the registered custom objective: its
    # min_cost equals min(tracking + effort) recomputed from first
    # principles on the same sampled rollouts
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.ops.costs import tracking_cost
    from ccv_mppi_path_tracker_tpu.ops.rollout import rollout
    from ccv_mppi_path_tracker_tpu.ops.sampling import sample_controls

    u = sample_controls(None, ctrl.u_prev, sp, K, noise=noise)
    states = rollout(
        get_model("kinematic_bicycle").step,
        jnp.broadcast_to(state, (K, 3)), u, dt,
    )
    base = tracking_cost(states, u, rb.ref, cp)
    effort = 2.0 * jnp.sum(u[..., 1] ** 2, axis=0)
    np.testing.assert_allclose(
        float(rb.stats["min_cost"]), float(jnp.min(base + effort)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(ra.stats["min_cost"]), float(jnp.min(base)), rtol=1e-6
    )
    # the two objectives produce genuinely different updates
    assert float(jnp.max(jnp.abs(ra.u_opt - rb.u_opt))) > 1e-3

    # gradient refinement differentiates the registered custom cost
    _, rr = mppi_step(cfg_b, ctrl, state, path, dt, sp, cp, noise=noise,
                      refine_steps=3, refine_step_size=0.01)
    assert np.isfinite(np.asarray(rr.u_opt)).all()
    from ccv_mppi_path_tracker_tpu.diff.gradients import make_trajectory_cost

    cost_fn = make_trajectory_cost(cfg_b)
    c0 = float(cost_fn(rb.u_opt, state, rb.ref, dt, cp))
    c1 = float(cost_fn(rr.u_opt, state, rr.ref, dt, cp))
    assert c1 <= c0 + 1e-6, (c0, c1)
