"""Sample-sharded solver on the 8-virtual-device CPU mesh.

Key invariant: with identical injected noise, the sharded update is allclose
to the single-device update (the psum/pmin reductions are globally exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu.core import ControllerState
from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch, full_body_launch
from ccv_mppi_path_tracker_tpu.parallel import (
    build_sharded_simulate,
    build_sharded_step,
    samples_mesh,
)
from ccv_mppi_path_tracker_tpu.paths import PathBuffer
from ccv_mppi_path_tracker_tpu.solver import mppi_step

T = 10
K = 64


def _setup(launch, k=K, dtype=np.float64):
    cfg, sp, cp, course = launch(num_samples=k, horizon=T, dtype=dtype)
    path = PathBuffer.from_points(course, 0.1, dtype=dtype)
    model_dim = {"unicycle": 2, "steering_unicycle": 3, "full_body": 5}[cfg.model]
    ctrl = ControllerState(
        u_prev=jnp.zeros((T - 1, model_dim), dtype),
        key=jax.random.PRNGKey(3),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros((cfg.num_states,), dtype).at[1].set(course[0, 1])
    return cfg, sp, cp, path, ctrl, state


@pytest.mark.parametrize("launch", [diff_drive_launch, full_body_launch])
def test_sharded_equals_single_device_with_injected_noise(launch):
    assert jax.device_count() >= 8
    cfg, sp, cp, path, ctrl, state = _setup(launch)
    u_dim = ctrl.u_prev.shape[1]
    noise = jnp.asarray(np.random.RandomState(0).randn(T - 1, K, u_dim))
    dt = jnp.asarray(0.1, jnp.float64)

    # single device
    _, res1 = jax.jit(
        lambda c, s, n: mppi_step(cfg, c, s, path, dt, sp, cp, noise=n)
    )(ctrl, state, noise)

    # 8-way sharded
    mesh = samples_mesh(num_devices=8)
    step = build_sharded_step(cfg, mesh)
    _, res8 = step(ctrl, state, path, dt, sp, cp, noise=noise)

    np.testing.assert_allclose(
        np.asarray(res8.u_opt), np.asarray(res1.u_opt), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        float(res8.stats["min_cost"]), float(res1.stats["min_cost"]), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(res8.stats["ess"]), float(res1.stats["ess"]), rtol=1e-9
    )


def test_sharded_rng_runs_and_is_deterministic():
    cfg, sp, cp, path, ctrl, state = _setup(diff_drive_launch)
    mesh = samples_mesh(num_devices=4)
    step = build_sharded_step(cfg, mesh)
    dt = jnp.asarray(0.1, jnp.float64)
    _, res_a = step(ctrl, state, path, dt, sp, cp)
    _, res_b = step(ctrl, state, path, dt, sp, cp)
    np.testing.assert_array_equal(np.asarray(res_a.u_opt), np.asarray(res_b.u_opt))
    assert np.isfinite(np.asarray(res_a.u_opt)).all()


def test_sharded_closed_loop_tracks():
    cfg, sp, cp, course = diff_drive_launch(num_samples=512, horizon=15)
    path = PathBuffer.from_points(course, 0.1)
    mesh = samples_mesh(num_devices=8)
    sim = build_sharded_simulate(cfg, mesh, num_steps=80)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), 15, 2)
    slope = np.arctan2(course[1, 1] - course[0, 1], course[1, 0] - course[0, 0])
    state0 = jnp.asarray([course[0, 0], course[0, 1], slope], jnp.float32)
    ctrl, logs = sim(ctrl, state0, path, jnp.float32(0.1), sp, cp)
    from ccv_mppi_path_tracker_tpu.metrics import tracking_metrics

    m = tracking_metrics(np.asarray(logs["state"])[:, :2], course)
    assert m["rmse"] < 0.15, m
    assert int(ctrl.step) == 80


def test_mesh_divisibility_error():
    cfg, sp, cp, course = diff_drive_launch(num_samples=100)
    mesh = samples_mesh(num_devices=8)
    with pytest.raises(ValueError, match="not divisible"):
        build_sharded_step(cfg, mesh)


def test_sharded_kernel_path_matches_sharded_xla():
    """Fused Pallas kernel inside shard_map (interpreter on the CPU): same
    result as the sharded XLA pipeline under injected noise."""
    cfg, sp, cp, course = diff_drive_launch(
        num_samples=8192, horizon=T, dtype=np.float32
    )
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    ctrl = ControllerState(
        u_prev=jnp.zeros((T - 1, 2), jnp.float32),
        key=jax.random.PRNGKey(3),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(
        np.random.RandomState(0).randn(T - 1, 8192, 2), jnp.float32
    )
    dt = jnp.float32(0.1)
    mesh = samples_mesh(num_devices=2)  # K/N = 4096 = 8 kernel blocks
    step_xla = build_sharded_step(cfg, mesh)
    step_krn = build_sharded_step(cfg, mesh, use_kernel=True,
                                  solver_options={"kernel_interpret": True})
    _, res_x = step_xla(ctrl, state, path, dt, sp, cp, noise=noise)
    _, res_k = step_krn(ctrl, state, path, dt, sp, cp, noise=noise)
    np.testing.assert_allclose(
        np.asarray(res_k.u_opt), np.asarray(res_x.u_opt), rtol=2e-5, atol=2e-6
    )


def test_sharded_elite_frac_matches_single_device():
    """elite_frac under shard_map: the rank-threshold radix select uses only
    exact reductions (integer digit-histogram psums), so the sharded
    elite update equals the single-device one bit-tightly."""
    cfg, sp, cp, path, ctrl, state = _setup(full_body_launch)
    noise = jnp.asarray(np.random.RandomState(7).randn(T - 1, K, 5))
    dt = jnp.asarray(0.1, jnp.float64)
    from ccv_mppi_path_tracker_tpu.solver import mppi_step as _step

    _, res1 = jax.jit(
        lambda c, s, n: _step(cfg, c, s, path, dt, sp, cp, noise=n,
                              elite_frac=0.25)
    )(ctrl, state, noise)
    mesh = samples_mesh(num_devices=8)
    step8 = build_sharded_step(cfg, mesh, solver_options={"elite_frac": 0.25})
    _, res8 = step8(ctrl, state, path, dt, sp, cp, noise=noise)
    np.testing.assert_allclose(
        np.asarray(res8.u_opt), np.asarray(res1.u_opt), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        float(res8.stats["elite_thresh"]), float(res1.stats["elite_thresh"]),
        rtol=0, atol=0,
    )
    # elites by global rank: exactly ceil(0.25*K) samples weighted
    from ccv_mppi_path_tracker_tpu.ops.softmax_update import elite_threshold

    costs_thresh = float(res1.stats["elite_thresh"])
    assert np.isfinite(costs_thresh)


def test_sharded_kernel_elite_matches_single_device_xla():
    """All three at once — elite_frac on the fused kernel under shard_map:
    the rank threshold spans shards exactly (psum-count radix select) and the
    kernel's second (masked) pass regenerates identical samples per shard,
    so the result matches the single-device XLA elite update at f32
    round-off."""
    cfg, sp, cp, course = diff_drive_launch(
        num_samples=8192, horizon=T, dtype=np.float32
    )
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    ctrl = ControllerState(
        u_prev=jnp.zeros((T - 1, 2), jnp.float32),
        key=jax.random.PRNGKey(3),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(
        np.random.RandomState(11).randn(T - 1, 8192, 2), jnp.float32
    )
    dt = jnp.float32(0.1)
    from ccv_mppi_path_tracker_tpu.solver import mppi_step as _step

    _, res1 = jax.jit(
        lambda c, s, n: _step(cfg, c, s, path, dt, sp, cp, noise=n,
                              elite_frac=0.25)
    )(ctrl, state, noise)
    mesh = samples_mesh(num_devices=2)  # K/N = 4096 = 8 kernel blocks
    step = build_sharded_step(cfg, mesh, use_kernel=True,
                              solver_options={"elite_frac": 0.25,
                                              "kernel_interpret": True})
    _, res2 = step(ctrl, state, path, dt, sp, cp, noise=noise)
    np.testing.assert_allclose(
        np.asarray(res2.u_opt), np.asarray(res1.u_opt), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        float(res2.stats["elite_thresh"]), float(res1.stats["elite_thresh"]),
        rtol=1e-5,
    )


def test_sharded_elite_stale_matches_single_device():
    """Single-pass stale-threshold elite under shard_map: at a FIXED stale
    threshold the sharded masked update must match single-device
    bit-tightly, and the reported next-cycle threshold (exact rank select
    over all shards) must be identical."""
    cfg, sp, cp, path, ctrl, state = _setup(full_body_launch)
    noise = jnp.asarray(np.random.RandomState(12).randn(T - 1, K, 5))
    dt = jnp.asarray(0.1, jnp.float64)
    from ccv_mppi_path_tracker_tpu.solver import mppi_step as _step

    opts = {"elite_frac": 0.25, "elite_stale_thresh": 40.0}
    _, res1 = jax.jit(
        lambda c, s, n: _step(cfg, c, s, path, dt, sp, cp, noise=n, **opts)
    )(ctrl, state, noise)
    mesh = samples_mesh(num_devices=8)
    step8 = build_sharded_step(cfg, mesh, solver_options=opts)
    _, res8 = step8(ctrl, state, path, dt, sp, cp, noise=noise)
    np.testing.assert_allclose(
        np.asarray(res8.u_opt), np.asarray(res1.u_opt), rtol=1e-12, atol=1e-14
    )
    assert float(res8.stats["elite_thresh"]) == float(
        res1.stats["elite_thresh"])
