"""Unit tests for the MPPI pipeline stages."""

import jax
import jax.numpy as jnp
import numpy as np

from ccv_mppi_path_tracker_tpu.core.config import make_solver_params
from ccv_mppi_path_tracker_tpu.ops import (
    min_sq_distance,
    rollout,
    sample_controls,
    softmax_weights,
    weighted_update,
)
from ccv_mppi_path_tracker_tpu.models import get_model


def test_sampling_mean_and_clamp():
    sp = make_solver_params(0.5, 1.0, [-1.2, -2.0], [1.2, 2.0], dtype=np.float64)
    u_prev = jnp.array([[1.1, 0.0]] * 9)  # near upper v bound
    key = jax.random.PRNGKey(0)
    u = sample_controls(key, u_prev, sp, 4096)
    assert u.shape == (9, 4096, 2)
    assert float(jnp.max(u[..., 0])) <= 1.2
    assert float(jnp.min(u[..., 0])) >= -1.2
    # mean of the clamped draw sits between the warm start and the bound
    assert 0.9 < float(jnp.mean(u[..., 1])) + 1.0 < 1.1  # w mean ~ 0


def test_sampling_noise_injection_exact():
    sp = make_solver_params(0.5, 1.0, [-10.0, -10.0], [10.0, 10.0], dtype=np.float64)
    u_prev = jnp.zeros((4, 2))
    noise = jnp.ones((4, 3, 2))
    u = sample_controls(jax.random.PRNGKey(0), u_prev, sp, 3, noise=noise)
    np.testing.assert_allclose(np.asarray(u), 0.5, rtol=1e-15)


def test_steer_off_zeroes_channel():
    sp = make_solver_params(0.5, 1.0, [-1] * 5, [1] * 5, dtype=np.float64)
    u = sample_controls(jax.random.PRNGKey(1), jnp.zeros((5, 5)), sp, 16, steer_off=True)
    np.testing.assert_array_equal(np.asarray(u[..., 2]), 0.0)


def test_min_sq_distance_matches_bruteforce_and_cap():
    rng = np.random.RandomState(3)
    xy = rng.randn(6, 11, 2) * 5
    ref = rng.randn(15, 2)
    out = np.asarray(min_sq_distance(jnp.array(xy), jnp.array(ref)))
    brute = np.min(
        np.sum((xy[:, :, None, :] - ref[None, None, :, :]) ** 2, axis=-1), axis=-1
    )
    # centered expanded form: |err| <= 10*eps*max(|p-c|^2, W^2) (mindist.py
    # docstring); operands here are ~(5 sigma)^2 ~ 6e2 -> atol ~ 1.3e-12 f64
    np.testing.assert_allclose(
        out, np.minimum(brute, 1e4), rtol=1e-12, atol=2e-12
    )
    # cap: points 200 m away report the 100 m cap squared
    far = jnp.full((1, 2), 200.0)
    np.testing.assert_allclose(np.asarray(min_sq_distance(far, jnp.array(ref)))[0], 1e4)


def test_expanded_form_error_bound():
    """The centered expanded form's f32 error stays within the documented
    bound 10*eps*max(|p-c|^2, W^2) even at adversarial near-zero distances
    on a window far from the origin (where the UNcentered expanded form
    would lose ~half the mantissa)."""
    rng = np.random.RandomState(7)
    # window ~6 m span, centered ~1 km from the origin (large coordinates)
    base = np.array([1000.0, -800.0])
    ref64 = base + np.cumsum(rng.rand(30, 2) * 0.2, axis=0)
    # query points ON and near the reference points: true d^2 ~ 0..1e-4
    xy64 = np.concatenate([ref64, ref64 + rng.randn(30, 2) * 1e-2], axis=0)
    exact = np.minimum(
        np.min(
            np.sum((xy64[:, None, :] - ref64[None, :, :]) ** 2, axis=-1),
            axis=-1,
        ),
        1e4,
    )
    got = np.asarray(
        min_sq_distance(jnp.asarray(xy64, jnp.float32),
                        jnp.asarray(ref64, jnp.float32))
    )
    w2 = float(np.max(np.sum((ref64 - ref64[0]) ** 2, axis=-1)))
    pn2 = float(np.max(np.sum((xy64 - ref64[0]) ** 2, axis=-1)))
    bound = 10 * np.finfo(np.float32).eps * max(w2, pn2)
    # f32 input rounding of the raw coordinates contributes up to
    # eps32*|coord| per component to p - ref_j before our arithmetic starts;
    # account for it separately from the algorithm's own bound.
    input_err = 4 * np.finfo(np.float32).eps * np.abs(base).max() * (
        np.sqrt(exact) + 1.0
    )
    assert np.all(np.abs(got - exact) <= bound + input_err), (
        np.abs(got - exact).max(), bound
    )


def test_rollout_straight_line():
    m = get_model("unicycle")
    controls = jnp.tile(jnp.array([1.0, 0.0]), (10, 4, 1))  # (T-1, K, U)
    states = rollout(m.step, jnp.zeros((4, 3)), controls, 0.1)
    assert states.shape == (11, 4, 3)
    np.testing.assert_allclose(np.asarray(states[-1, :, 0]), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(states[-1, :, 1]), 0.0, atol=1e-12)


def test_softmax_weights_normalized_and_baseline_invariant():
    costs = jnp.array([3.0, 1.0, 2.0, 50.0])
    w, stats = softmax_weights(costs, 1.0)
    np.testing.assert_allclose(float(jnp.sum(w)), 1.0, rtol=1e-12)
    w2, _ = softmax_weights(costs + 1000.0, 1.0)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w2), rtol=1e-12)
    assert float(stats["min_cost"]) == 1.0
    assert 1.0 <= float(stats["ess"]) <= 4.0


def test_softmax_weights_survive_huge_costs():
    """Documented fix: the reference underflows to 0/0 here."""
    costs = jnp.array([1e6, 1e6 + 1.0, 1e6 + 2.0])
    w, _ = softmax_weights(costs, 1.0)
    assert np.isfinite(np.asarray(w)).all()
    np.testing.assert_allclose(float(jnp.sum(w)), 1.0, rtol=1e-12)


def test_weighted_update_matches_einsum():
    rng = np.random.RandomState(0)
    samples = rng.randn(7, 64, 3)
    costs = rng.rand(64)
    w, _ = softmax_weights(jnp.array(costs), 0.7)
    u = weighted_update(w, jnp.array(samples))
    ref = np.einsum("k,tku->tu", np.asarray(w), samples)
    # f64 oracle tolerance: only summation order differs (the contraction
    # runs at Precision.HIGHEST, so a GPU never drops it to TF32)
    np.testing.assert_allclose(np.asarray(u), ref, rtol=1e-10)
    # f32: within a few ulps of the f64 result, far tighter than TF32's
    # ~1e-3 relative
    u32 = weighted_update(jnp.asarray(w, jnp.float32),
                          jnp.asarray(samples, jnp.float32))
    np.testing.assert_allclose(np.asarray(u32), ref, rtol=1e-5, atol=1e-6)


def test_colored_noise_statistics_and_identity():
    from ccv_mppi_path_tracker_tpu.ops.sampling import color_noise

    rng = np.random.RandomState(0)
    white = jnp.asarray(rng.randn(40, 4096, 1))
    # beta=0 is bit-exact identity (reference parity path)
    np.testing.assert_array_equal(
        np.asarray(color_noise(white, jnp.asarray(0.0))), np.asarray(white)
    )
    # beta=0.8: unit marginal variance, lag-1 autocorrelation ~ beta
    col = np.asarray(color_noise(white, jnp.asarray(0.8)))[..., 0]
    assert abs(col.std() - 1.0) < 0.05
    ac = np.mean(col[1:] * col[:-1]) / np.mean(col * col)
    assert abs(ac - 0.8) < 0.05


def test_colored_noise_kernel_matches_xla():
    import jax
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    cfg, sp, cp, course = diff_drive_launch(num_samples=4096, horizon=10,
                                            dtype=np.float32)
    import dataclasses as dc

    sp = dc.replace(sp, noise_beta=np.float32(0.6))
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), 10, 2)
    state = jnp.zeros(3, jnp.float32)
    noise = jnp.asarray(np.random.RandomState(1).randn(9, 4096, 2), jnp.float32)
    _, a = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp, noise=noise)
    _, b = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, use_kernel=True, kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=2e-5, atol=2e-6)


def test_min_sq_distance_scan_branch_matches_broadcast(monkeypatch):
    """Force the large-problem running-min scan path (_BCAST_LIMIT=0) and
    assert it equals the broadcast-min path exactly, under jit and under
    shard_map (the carry must inherit xy's device-varying type)."""
    from functools import partial

    from ccv_mppi_path_tracker_tpu.ops import mindist

    rng = np.random.RandomState(0)
    xy = jnp.asarray(rng.randn(6, 32, 2) * 3.0)
    ref = jnp.asarray(rng.randn(10, 2) * 3.0)
    want = np.asarray(jax.jit(min_sq_distance)(xy, ref))

    monkeypatch.setattr(mindist, "_BCAST_LIMIT", 0)
    got = np.asarray(jax.jit(mindist.min_sq_distance)(xy, ref))
    np.testing.assert_array_equal(got, want)

    # shard_map over the sample axis (8 virtual devices)
    from jax.sharding import PartitionSpec as P

    from ccv_mppi_path_tracker_tpu.parallel import SAMPLES_AXIS, samples_mesh

    mesh = samples_mesh(num_devices=8)
    f = jax.jit(
        jax.shard_map(
            mindist.min_sq_distance,
            mesh=mesh,
            in_specs=(P(None, SAMPLES_AXIS, None), P()),
            out_specs=P(None, SAMPLES_AXIS),
        )
    )
    got_sh = np.asarray(f(xy, ref))
    np.testing.assert_array_equal(got_sh, want)

    # the far-point cap applies on the scan path too
    far = jnp.full((1, 2), 1e6)
    np.testing.assert_allclose(
        np.asarray(mindist.min_sq_distance(far, ref))[0], 1e4
    )


def test_rollout_closed_form_matches_scan():
    """Scan-free cumsum rollout == sequential scan rollout (round-off), for
    every model that admits the closed form, single and batched."""
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.ops.rollout import (
        CLOSED_FORM_MODELS,
        rollout,
        rollout_closed_form,
    )

    rng = np.random.RandomState(0)
    dt = 0.1
    for model_name in CLOSED_FORM_MODELS:
        m = get_model(model_name)
        u = jnp.asarray(rng.randn(12, m.num_controls) * 0.5)
        s0 = jnp.asarray(rng.randn(m.num_states) * 0.3)
        a = rollout(m.step, s0, u, dt)
        b = rollout_closed_form(model_name, s0, u, dt)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-9, atol=1e-12)
        # batched (T-1, K, U)
        uk = jnp.asarray(rng.randn(12, 16, m.num_controls) * 0.5)
        s0k = jnp.broadcast_to(s0, (16, m.num_states))
        ak = rollout(m.step, s0k, uk, dt)
        bk = rollout_closed_form(model_name, s0k, uk, dt)
        np.testing.assert_allclose(np.asarray(bk), np.asarray(ak),
                                   rtol=1e-9, atol=1e-12)
