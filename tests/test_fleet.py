"""Fleet-scale batched control (vmapped multi-robot MPPI)."""

import jax
import jax.numpy as jnp
import numpy as np

from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu.models import get_model
from ccv_mppi_path_tracker_tpu.paths import PathBuffer
from ccv_mppi_path_tracker_tpu.solver.batch import build_fleet_step, init_fleet


def test_fleet_step_independent_robots():
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=10)
    path = PathBuffer.from_points(course, 0.1)
    B = 5
    ctrls = init_fleet(cfg, B, seed=0)
    states = jnp.zeros((B, 3), jnp.float32)
    states = states.at[:, 1].set(
        jnp.linspace(-0.5, 0.5, B, dtype=jnp.float32) + float(course[0, 1])
    )
    step = build_fleet_step(cfg)
    ctrls2, res = step(ctrls, states, path, jnp.float32(0.1), sp, cp)
    assert res.u0.shape == (B, 2)
    assert np.isfinite(np.asarray(res.u_opt)).all()
    assert np.all(np.asarray(ctrls2.step) == 1)
    # different poses + different PRNG streams -> different commands
    u0 = np.asarray(res.u0)
    assert np.ptp(u0[:, 1]) > 1e-3


def test_fleet_closed_loop_converges_to_course():
    """All robots, started fanned out, converge onto the same course."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=15)
    path = PathBuffer.from_points(course, 0.1)
    B = 4
    ctrls = init_fleet(cfg, B, seed=1)
    states = jnp.zeros((B, 3), jnp.float32)
    states = states.at[:, 1].set(
        float(course[0, 1]) + jnp.linspace(-0.4, 0.4, B, dtype=jnp.float32)
    )
    step = build_fleet_step(cfg)
    plant = get_model(cfg.model)
    dt = jnp.float32(0.1)
    for _ in range(60):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = plant.step(states, res.u0, dt)
    final = np.asarray(states)
    # every robot ends near the course
    d = np.min(
        np.linalg.norm(final[:, None, :2] - course[None, :, :], axis=-1), axis=1
    )
    assert np.all(d < 0.3), d
    assert np.all(final[:, 0] > 2.0)


def test_fleet_kernel_step_runs_and_converges():
    """Fleet on the fused kernel: jax.vmap over the single-robot kernel step
    (one launch for B robots x K samples, in-kernel generator, Pallas
    interpreter here); converges in closed loop."""
    B, K, T = 4, 512, 10
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    states = jnp.zeros((B, 3), jnp.float32).at[:, 1].set(float(course[0, 1]))
    dt = jnp.float32(0.1)
    step = build_fleet_step(cfg, use_kernel=True, kernel_interpret=True)
    plant = jax.jit(jax.vmap(lambda s, u: get_model(cfg.model).step(s, u, dt)))
    ctrls = init_fleet(cfg, B)
    for _ in range(40):
        ctrls, res = step(ctrls, states, path, dt, sp, cp)
        states = plant(states, res.u0)
    xy = np.asarray(states)
    err = np.abs(xy[:, 1] - np.interp(xy[:, 0], course[:, 0], course[:, 1]))
    assert np.isfinite(xy).all()
    assert float(err.mean()) < 0.3
    # independent per-robot streams: same pose, different commands
    assert np.ptp(np.asarray(res.u0)[:, 1]) > 0.0


def test_fleet_per_robot_paths():
    """shared_path=False: each robot tracks its own course in one program."""
    B, K, T = 4, 256, 10
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T)
    # four vertically offset copies of the course
    courses = np.stack([course + [0.0, 2.0 * b] for b in range(B)])
    paths = jax.vmap(lambda c: PathBuffer.from_points_jax(c, 0.1))(
        jnp.asarray(courses)
    ) if hasattr(PathBuffer, "from_points_jax") else jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[PathBuffer.from_points(c, 0.1) for c in courses],
    )
    states = jnp.asarray(
        [[c[0, 0], c[0, 1], 0.0] for c in courses], jnp.float32
    )
    step = build_fleet_step(cfg, shared_path=False)
    ctrls = init_fleet(cfg, B)
    model = get_model(cfg.model)
    plant = jax.jit(jax.vmap(lambda s, u: model.step(s, u, jnp.float32(0.1))))
    st = states
    for _ in range(30):
        ctrls, res = step(ctrls, st, paths, jnp.float32(0.1), sp, cp)
        st = plant(st, res.u0)
    xy = np.asarray(st)
    for b in range(B):
        err = abs(xy[b, 1] - np.interp(xy[b, 0], courses[b][:, 0],
                                       courses[b][:, 1]))
        assert err < 0.4, (b, err)
        assert xy[b, 0] > 1.0  # made progress along its own course
