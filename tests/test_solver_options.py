"""Solver execution options: gradient refinement, large-horizon sharded sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu.core import ControllerState
from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu.diff.gradients import make_trajectory_cost
from ccv_mppi_path_tracker_tpu.parallel import build_sharded_step, samples_mesh
from ccv_mppi_path_tracker_tpu.paths import PathBuffer
from ccv_mppi_path_tracker_tpu.solver import mppi_step


def test_refined_step_reduces_realized_cost():
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=12,
                                            dtype=np.float64)
    path = PathBuffer.from_points(course, 0.1, dtype=np.float64)
    ctrl = ControllerState(
        u_prev=jnp.zeros((11, 2), jnp.float64),
        key=jax.random.PRNGKey(5),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.asarray([0.0, course[0, 1] + 0.3, 0.5])  # off path
    dt = jnp.asarray(0.1, jnp.float64)
    noise = jnp.asarray(np.random.RandomState(0).randn(11, 64, 2))

    _, plain = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, refined = mppi_step(
        cfg, ctrl, state, path, dt, sp, cp, noise=noise,
        refine_steps=8, refine_step_size=0.02,
    )
    cost_fn = make_trajectory_cost(cfg)
    c_plain = float(cost_fn(plain.u_opt, state, plain.ref, dt, cp))
    c_ref = float(cost_fn(refined.u_opt, state, refined.ref, dt, cp))
    assert c_ref < c_plain
    # refinement respects the bounds
    assert float(jnp.max(refined.u_opt[:, 0])) <= float(sp.u_max[0]) + 1e-12


def test_large_horizon_sharded_sweep():
    """CI-scale version of the K=100k x T=100 multi-host sweep config:
    K=8192 sharded over 8 virtual devices at T=100."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=8192, horizon=100)
    path = PathBuffer.from_points(course, 0.1)
    mesh = samples_mesh(num_devices=8)
    step = build_sharded_step(cfg, mesh)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), 100, 2)
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    ctrl, res = step(ctrl, state, path, jnp.float32(0.1), sp, cp)
    assert res.u_opt.shape == (99, 2)
    assert np.isfinite(np.asarray(res.u_opt)).all()
    assert 1.0 <= float(res.stats["ess"]) <= 8192.0


def test_refine_preserves_steer_off():
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.core.config import SolverConfig

    cfg, sp, cp, course = full_body_launch(num_samples=64, horizon=10,
                                           dtype=np.float64)
    cfg = SolverConfig(model=cfg.model, num_samples=64, horizon=10,
                       steer_off=True)
    path = PathBuffer.from_points(course, 0.1, dtype=np.float64)
    ctrl = ControllerState(
        u_prev=jnp.zeros((9, 5), jnp.float64),
        key=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(5, jnp.float64).at[1].set(course[0, 1])
    _, res = mppi_step(cfg, ctrl, state, path, jnp.asarray(0.1, jnp.float64),
                       sp, cp, refine_steps=5)
    np.testing.assert_array_equal(np.asarray(res.u_opt[:, 2]), 0.0)


def test_sigma_suggest_matches_weighted_std():
    """stats['sigma_suggest'] == std of the weighted sample distribution."""
    import numpy as np
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step
    from ccv_mppi_path_tracker_tpu.ops.sampling import sample_controls

    K, T = 512, 10
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 2)
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(0).randn(T - 1, K, 2), jnp.float32)
    _, res = mppi_step(
        cfg, ctrl, state, path, jnp.float32(0.1), sp, cp, noise=noise,
        adapt_sigma=True,
    )
    # recompute from first principles
    u = np.asarray(sample_controls(None, ctrl.u_prev, sp, K, noise=noise))
    from ccv_mppi_path_tracker_tpu.ops.costs import trajectory_costs
    from ccv_mppi_path_tracker_tpu.ops.rollout import rollout
    from ccv_mppi_path_tracker_tpu.ops.softmax_update import softmax_weights
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.paths.resample import resample_reference

    ref = resample_reference(path, state[:2], cp.v_ref, jnp.float32(0.1), T)
    states = rollout(
        get_model("unicycle").step,
        jnp.broadcast_to(state, (K, 3)), jnp.asarray(u), jnp.float32(0.1),
    )
    costs = trajectory_costs("unicycle", states, jnp.asarray(u), {}, ref, cp)
    w, _ = softmax_weights(costs, sp.lam)
    w = np.asarray(w)
    mean = np.einsum("k,tku->tu", w, u)
    var = np.einsum("k,tku->tu", w, u * u) - mean**2
    expected = np.sqrt(np.mean(np.maximum(var, 0), axis=0))
    np.testing.assert_allclose(
        np.asarray(res.stats["sigma_suggest"]), expected, rtol=2e-4, atol=1e-6
    )


def test_sigma_suggest_kernel_matches_xla():
    import numpy as np
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    K, T = 2048, 10
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 2)
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(1).randn(T - 1, K, 2), jnp.float32)
    _, a = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, adapt_sigma=True)
    _, b = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, adapt_sigma=True, use_kernel=True,
                     kernel_interpret=True)
    np.testing.assert_allclose(
        np.asarray(b.stats["sigma_suggest"]),
        np.asarray(a.stats["sigma_suggest"]), rtol=2e-4, atol=1e-6,
    )


def test_control_loop_sigma_adaptation_stays_bounded_and_tracks():
    import numpy as np
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.runtime.loop import ControlLoop

    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10)
    path = PathBuffer.from_points(course, 0.1)
    loop = ControlLoop(cfg=cfg, sp=sp, cp=cp, path=path, sigma_adapt=0.2)
    sigma0 = np.asarray(sp.control_noise).copy()
    model = get_model(cfg.model)
    state = jnp.asarray([0.0, float(course[0, 1]), 0.0], jnp.float32)
    for _ in range(30):
        res = loop.step(state, dt=0.1)
        state = model.step(state, res.u0, jnp.float32(0.1))
    sig = np.asarray(loop.sp.control_noise)
    assert (sig >= 0.25 * sigma0 - 1e-7).all()
    assert (sig <= 4.0 * sigma0 + 1e-7).all()
    assert not np.allclose(sig, sigma0)  # it actually adapted
    err = abs(float(state[1]) - np.interp(float(state[0]),
                                          course[:, 0], course[:, 1]))
    assert err < 0.4


def test_refine_method_gauss_newton_in_step():
    """mppi_step(refine_method='gauss_newton') runs and never degrades the
    realized trajectory cost vs the unrefined update (LM guard)."""
    import numpy as np
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step
    from ccv_mppi_path_tracker_tpu.core.types import RefWindow

    cfg, sp, cp, course = diff_drive_launch(num_samples=128, horizon=10)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), 10, 2)
    state = jnp.asarray([0.0, float(course[0, 1]) + 0.3, 0.4], jnp.float32)
    noise = jnp.asarray(
        np.random.RandomState(0).randn(9, 128, 2), jnp.float32
    )
    dt = jnp.float32(0.1)
    _, plain = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, gn = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                      refine_steps=3, refine_method="gauss_newton")
    cost_fn = make_trajectory_cost(cfg)
    ref = RefWindow(xy=plain.ref.xy, yaw=plain.ref.yaw)
    c_plain = float(cost_fn(plain.u_opt, state, ref, 0.1, cp))
    c_gn = float(cost_fn(gn.u_opt, state, ref, 0.1, cp))
    assert c_gn <= c_plain + 1e-6
    assert np.isfinite(np.asarray(gn.u_opt)).all()


def test_sigma_suggest_kernel_matches_xla_full_body():
    import numpy as np
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    K, T = 2048, 10
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 5)
    state = jnp.zeros(5, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(2).randn(T - 1, K, 5), jnp.float32)
    _, a = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, adapt_sigma=True)
    _, b = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, adapt_sigma=True, use_kernel=True,
                     kernel_interpret=True)
    np.testing.assert_allclose(
        np.asarray(b.stats["sigma_suggest"]),
        np.asarray(a.stats["sigma_suggest"]), rtol=2e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(b.u_opt), np.asarray(a.u_opt), rtol=2e-5, atol=2e-6,
    )


def test_shift_warm_start_centers_on_shifted_sequence():
    """With zero injected noise every sample equals the (clamped) shifted
    mean, so u_opt must be exactly the one-step-shifted warm start."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=32, horizon=8)
    path = PathBuffer.from_points(course, 0.1)
    u_prev = jnp.asarray(
        np.linspace(0.1, 0.7, 7)[:, None] * np.array([[1.0, -0.5]]), jnp.float32
    )
    ctrl = ControllerState(u_prev=u_prev, key=jax.random.PRNGKey(3),
                           step=jnp.zeros((), jnp.int32))
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.zeros((7, 32, 2), jnp.float32)
    _, res = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                       noise=noise, shift_warm_start=True)
    expected = np.concatenate([u_prev[1:], u_prev[-1:]], axis=0)
    expected = np.clip(expected, np.asarray(sp.u_min), np.asarray(sp.u_max))
    np.testing.assert_allclose(np.asarray(res.u_opt), expected, atol=1e-6)
    # and off by default: unshifted mean comes back
    _, plain = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                         noise=noise)
    np.testing.assert_allclose(np.asarray(plain.u_opt),
                               np.asarray(u_prev), atol=1e-6)


def test_shift_warm_start_kernel_matches_xla():
    cfg, sp, cp, course = diff_drive_launch(num_samples=2048, horizon=10)
    path = PathBuffer.from_points(course, 0.1)
    u_prev = jnp.asarray(
        np.random.RandomState(7).randn(9, 2) * 0.2, jnp.float32
    )
    ctrl = ControllerState(u_prev=u_prev, key=jax.random.PRNGKey(0),
                           step=jnp.zeros((), jnp.int32))
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(8).randn(9, 2048, 2), jnp.float32)
    _, a = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, shift_warm_start=True)
    _, b = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, shift_warm_start=True, use_kernel=True,
                     kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=2e-5, atol=2e-6)


def test_delay_compensation_predicts_state_forward():
    """mppi_step(delay=d) == mppi_step on the d-seconds-predicted state."""
    from ccv_mppi_path_tracker_tpu.models import get_model

    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=10)
    path = PathBuffer.from_points(course, 0.1)
    u_prev = jnp.full((9, 2), 0.4, jnp.float32)
    ctrl = ControllerState(u_prev=u_prev, key=jax.random.PRNGKey(1),
                           step=jnp.zeros((), jnp.int32))
    state = jnp.asarray([0.0, float(course[0, 1]), 0.2], jnp.float32)
    noise = jnp.asarray(np.random.RandomState(2).randn(9, 64, 2), jnp.float32)
    d = 0.05
    _, a = mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                     noise=noise, delay=d)
    pred = get_model(cfg.model).step(state, u_prev[0], jnp.float32(d))
    _, b = mppi_step(cfg, ctrl, pred, path, jnp.float32(0.1), sp, cp,
                     noise=noise)
    np.testing.assert_allclose(np.asarray(a.u_opt), np.asarray(b.u_opt),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.opt_states),
                               np.asarray(b.opt_states), atol=1e-6)


def test_elite_frac_weights():
    from ccv_mppi_path_tracker_tpu.ops.softmax_update import softmax_weights

    costs = jnp.asarray(np.random.RandomState(0).rand(256) * 5.0, jnp.float32)
    w_full, _ = softmax_weights(costs, 1.0)
    w_one, _ = softmax_weights(costs, 1.0, elite_frac=1.0)
    np.testing.assert_allclose(np.asarray(w_one), np.asarray(w_full), rtol=1e-6)

    w_elite, stats = softmax_weights(costs, 1.0, elite_frac=0.25)
    c = np.asarray(costs)
    thresh = np.quantile(c.astype(np.float32), 0.25)
    assert (np.asarray(w_elite)[c > thresh + 1e-6] == 0.0).all()
    np.testing.assert_allclose(float(np.asarray(w_elite).sum()), 1.0, rtol=1e-5)
    # trimming concentrates the weights: ESS can only drop
    _, full_stats = softmax_weights(costs, 1.0)
    assert float(stats["ess"]) <= float(full_stats["ess"]) + 1e-3


def test_elite_frac_in_step_matches_manual():
    from ccv_mppi_path_tracker_tpu.models import get_model
    from ccv_mppi_path_tracker_tpu.ops.costs import trajectory_costs
    from ccv_mppi_path_tracker_tpu.ops.rollout import rollout
    from ccv_mppi_path_tracker_tpu.ops.sampling import sample_controls
    from ccv_mppi_path_tracker_tpu.ops.softmax_update import (
        softmax_weights, weighted_update,
    )
    from ccv_mppi_path_tracker_tpu.paths.resample import resample_reference

    K, T = 256, 10
    cfg, sp, cp, course = diff_drive_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 2)
    state = jnp.asarray([0.0, float(course[0, 1]) + 0.2, 0.3], jnp.float32)
    noise = jnp.asarray(np.random.RandomState(5).randn(T - 1, K, 2), jnp.float32)
    dt = jnp.float32(0.1)
    _, res = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                       elite_frac=0.1)
    u = sample_controls(None, ctrl.u_prev, sp, K, noise=noise)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, T)
    states = rollout(get_model("unicycle").step,
                     jnp.broadcast_to(state, (K, 3)), u, dt)
    costs = trajectory_costs("unicycle", states, u, {}, ref, cp)
    w, _ = softmax_weights(costs, sp.lam, elite_frac=0.1)
    np.testing.assert_allclose(np.asarray(res.u_opt),
                               np.asarray(weighted_update(w, u)), atol=1e-6)


def test_delay_compensation_improves_tracking_under_actuation_lag():
    """Plant applies each command one full cycle late; compensating with
    delay=dt must track better than ignoring the lag."""
    from ccv_mppi_path_tracker_tpu.metrics.tracking import tracking_metrics
    from ccv_mppi_path_tracker_tpu.models import get_model

    cfg, sp, cp, course = diff_drive_launch(num_samples=512, horizon=12)
    path = PathBuffer.from_points(course, 0.1)
    model = get_model(cfg.model)
    dt = jnp.float32(0.1)

    def run(delay):
        step = jax.jit(lambda ctrl, state, u_pending: mppi_step(
            cfg, ctrl, state, path, dt, sp, cp, delay=delay))
        ctrl = ControllerState.initial(jax.random.PRNGKey(0), 12, 2)
        state = jnp.asarray([float(course[0, 0]), float(course[0, 1]),
                             float(np.arctan2(course[1, 1] - course[0, 1],
                                              course[1, 0] - course[0, 0]))],
                            jnp.float32)
        pending = jnp.zeros(2, jnp.float32)  # command in flight
        xs = [np.asarray(state[:2])]
        for _ in range(120):
            ctrl, res = step(ctrl, state, pending)
            state = model.step(state, pending, dt)  # lagged actuation
            pending = res.u0
            xs.append(np.asarray(state[:2]))
        return tracking_metrics(np.stack(xs), course, dt=0.1)["rmse"]

    rmse_naive = run(None)
    rmse_comp = run(0.1)
    assert rmse_comp < rmse_naive


def test_elite_threshold_is_kth_order_statistic():
    from ccv_mppi_path_tracker_tpu.ops.softmax_update import elite_threshold

    c = np.random.RandomState(11).randn(333).astype(np.float64) * 40.0
    for frac in (0.1, 0.25, 0.5, 1.0):
        t = float(elite_threshold(jnp.asarray(c), frac))
        k = max(1, int(round(frac * len(c))))
        kth = np.sort(c)[k - 1]
        # threshold sits on (or a hair above) the k-th smallest and below the
        # (k+1)-th, so `cost <= t` selects exactly the k best samples
        assert (c <= t).sum() == k, (frac, t, kth)
        np.testing.assert_allclose(t, kth, rtol=1e-12)


def test_elite_threshold_select_equals_sort_any_digit_width():
    """The scatter-free digit-descent select (round 5: compare+sum counts,
    no `.at[].add` scatters, no sort) must return the IDENTICAL k-th
    smallest as a sort at EVERY digit width, single-device and sharded —
    including with ties, negatives, infs, and NaN (canonicalized to +inf)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from ccv_mppi_path_tracker_tpu.ops.softmax_update import elite_threshold

    rng = np.random.RandomState(5)
    cases = [
        rng.randn(256).astype(np.float32) * 30.0,
        np.repeat(rng.randn(32).astype(np.float32), 8),  # heavy ties
        -np.abs(rng.randn(256)).astype(np.float32),      # all negative
    ]
    special = rng.randn(256).astype(np.float32)
    special[:4] = [np.inf, -np.inf, np.nan, -np.nan]
    cases.append(special)
    mesh = Mesh(np.array(jax.devices()[:1]), ("s",))
    for c in cases:
        cj = jnp.asarray(c)
        canon = np.where(np.isnan(c), np.inf, c)
        for frac in (0.1, 0.25, 0.5):
            k = max(1, int(round(frac * len(c))))
            want = np.sort(canon)[k - 1]
            for db in (1, 2, 4, 8):
                t = float(elite_threshold(cj, frac, digit_bits=db))
                assert t == want, (frac, db, t, want)
            t_shard = float(jax.jit(jax.shard_map(
                lambda x: elite_threshold(x, frac, axis_name="s")[None],
                mesh=mesh, in_specs=P("s"), out_specs=P("s"),
            ))(cj)[0])
            assert t_shard == want, (frac, t_shard, want)


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("k,t,model,kind,want", [
    (1000, 15, "unicycle", H100, True),          # smallest timed win
    (10000, 15, "full_body", H100, True),        # reference operating point
    (102400, 30, "full_body", H100, True),       # flagship
    (1048576, 30, "steering_unicycle", H100, True),
    (1000, 14, "unicycle", H100, False),         # below anything timed
    (500, 15, None, H100, False),
    (102400, 30, "custom", H100, False),         # no kernel for the model
    (102400, 30, "full_body", "NVIDIA A100-SXM4-80GB", False),  # not timed
])
def test_use_kernel_auto_policy(k, t, model, kind, want):
    """use_kernel='auto' follows the table timed per device kind: the
    kernel at or above the measured threshold on a timed kind, the XLA
    pipeline on any other kind and for models the kernel lacks."""
    from ccv_mppi_path_tracker_tpu.kernels import should_use_kernel

    assert should_use_kernel(k, t, model=model, device_kind=kind) is want


def test_use_kernel_auto_off_gpu_is_xla():
    """Without a GPU (this CPU backend) auto never picks the kernel."""
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.kernels import should_use_kernel
    from ccv_mppi_path_tracker_tpu.solver import MPPISolver

    assert not should_use_kernel(102400, 30, model="full_body")
    cfg, sp, cp, course = diff_drive_launch(num_samples=102400, horizon=30)
    assert MPPISolver(cfg, use_kernel="auto").use_kernel is False


def test_lean_mode_matches_full_result():
    """Serving mode (lean=True) must return bit-identical u_opt/u0 and an
    identical next ControllerState; only diagnostics are dropped."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=12)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(3), 12, 2)
    state = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    dt = jnp.float32(0.1)

    for use_kernel in (False, True):
        kw = dict(use_kernel=use_kernel)
        if use_kernel:
            cfgk, spk, cpk, _ = diff_drive_launch(num_samples=4096, horizon=12)
            args = (cfgk, ctrl, state, path, dt, spk, cpk)
            kw["kernel_interpret"] = True
            kw["noise"] = jnp.asarray(
                np.random.RandomState(7).randn(11, 4096, 2), jnp.float32
            )
        else:
            args = (cfg, ctrl, state, path, dt, sp, cp)
        c_full, full = mppi_step(*args, **kw)
        c_lean, leanr = mppi_step(*args, lean=True, **kw)
        np.testing.assert_array_equal(np.asarray(full.u_opt),
                                      np.asarray(leanr.u_opt))
        np.testing.assert_array_equal(np.asarray(full.u0), np.asarray(leanr.u0))
        np.testing.assert_array_equal(np.asarray(c_full.u_prev),
                                      np.asarray(c_lean.u_prev))
        assert leanr.ref is None and leanr.opt_states is None
        assert leanr.stats == {}
    # adapt_sigma keeps its feedback output in lean mode
    _, r = mppi_step(cfg, ctrl, state, path, dt, sp, cp, lean=True,
                     adapt_sigma=True)
    assert set(r.stats) == {"sigma_suggest"}
    # lean result flattens to just the two actuation leaves + sigma
    leaves = jax.tree_util.tree_leaves(r)
    assert len(leaves) == 3


def test_elite_stale_thresh_single_pass():
    """Single-pass stale-threshold elite (opt-in): masking this cycle at an
    externally supplied threshold. stale=+inf must equal vanilla exactly;
    stale = the cycle's own exact rank threshold must equal the two-pass
    elite flow exactly — on the XLA path and the fused kernel (injected
    noise, interpret mode)."""
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer

    K, T = 1024, 8
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(3), T, 5)
    state = jnp.zeros(5, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(9).randn(T - 1, K, 5),
                        jnp.float32)
    dt = jnp.float32(0.1)
    for kernel in (False, True):
        kw = dict(noise=noise, use_kernel=kernel,
                  kernel_interpret=kernel or None)
        _, vanilla = mppi_step(cfg, ctrl, state, path, dt, sp, cp, **kw)
        _, two_pass = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                                elite_frac=0.25, **kw)
        _, stale_inf = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                                 elite_frac=0.25,
                                 elite_stale_thresh=jnp.inf, **kw)
        np.testing.assert_array_equal(np.asarray(stale_inf.u_opt),
                                      np.asarray(vanilla.u_opt))
        t_exact = two_pass.stats["elite_thresh"]
        _, stale_t = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                               elite_frac=0.25,
                               elite_stale_thresh=t_exact, **kw)
        np.testing.assert_array_equal(np.asarray(stale_t.u_opt),
                                      np.asarray(two_pass.u_opt),
                                      err_msg=f"kernel={kernel}")
        # the stats still report the CURRENT cycle's exact threshold
        assert float(stale_t.stats["elite_thresh"]) == float(t_exact)


def test_elite_stale_scan_threads_threshold():
    """build_simulate_scan(solver_options={'elite_frac':..,
    'elite_stale': True}): cycle 0 runs unmasked, cycle 1 is masked at
    cycle 0's exact threshold — verified against a manual composition."""
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import diff_drive_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.runtime.loop import build_simulate_scan
    from ccv_mppi_path_tracker_tpu.runtime.plant import Plant

    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=8)
    path = PathBuffer.from_points(course, 0.1)
    state0 = jnp.zeros(3, jnp.float32).at[1].set(float(course[0, 1]))
    dt = jnp.float32(0.1)
    sim = build_simulate_scan(
        cfg, num_steps=2,
        solver_options={"elite_frac": 0.25, "elite_stale": True},
    )
    ctrl0 = ControllerState.initial(jax.random.PRNGKey(0), 8, 2)
    _, logs = sim(ctrl0, state0, path, dt, sp, cp)

    plant = Plant(model_name=cfg.model)
    ctrl, res0 = mppi_step(cfg, ctrl0, state0, path, dt, sp, cp,
                           elite_frac=0.25,
                           elite_stale_thresh=jnp.inf)
    s1 = plant.step(jax.random.fold_in(ctrl0.key, 1), state0, res0.u0, dt)
    _, res1 = mppi_step(cfg, ctrl, s1, path, dt, sp, cp, elite_frac=0.25,
                        elite_stale_thresh=res0.stats["elite_thresh"])
    # jitted-scan vs eager composition: identical math, fusion-level
    # rounding only
    np.testing.assert_allclose(np.asarray(logs["u0"][0]),
                               np.asarray(res0.u0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(logs["u0"][1]),
                               np.asarray(res1.u0), rtol=1e-6, atol=1e-7)


def test_elite_stale_empty_mask_holds_previous_plan():
    """A stale threshold BELOW every current cost (cost distribution
    jumped between cycles) must not produce 0/0 = NaN: both paths hold
    the sampling center (the previous plan), stay finite, and flag the
    cycle in stats["elite_stale_empty"]."""
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer

    K, T = 512, 8
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T)
    path = PathBuffer.from_points(course, 0.1)
    u_prev = jnp.asarray(
        np.random.RandomState(4).randn(T - 1, 5) * 0.1, jnp.float32
    )
    ctrl = ControllerState(u_prev=u_prev, key=jax.random.PRNGKey(3),
                           step=jnp.zeros((), jnp.int32))
    state = jnp.zeros(5, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(9).randn(T - 1, K, 5),
                        jnp.float32)
    dt = jnp.float32(0.1)
    for kernel in (False, True):
        _, res = mppi_step(
            cfg, ctrl, state, path, dt, sp, cp, noise=noise,
            elite_frac=0.25, elite_stale_thresh=jnp.float32(-1.0),
            use_kernel=kernel, kernel_interpret=kernel or None,
        )
        assert bool(res.stats["elite_stale_empty"]), f"kernel={kernel}"
        assert np.isfinite(np.asarray(res.u_opt)).all(), f"kernel={kernel}"
        # information-free cycle: hold the previous plan (the unshifted
        # sampling center, reference warm-start semantics)
        np.testing.assert_array_equal(np.asarray(res.u_opt),
                                      np.asarray(u_prev))
        # and the reported NEXT threshold is still the current exact rank
        # statistic, so the loop recovers by itself on the next cycle
        assert np.isfinite(float(res.stats["elite_thresh"]))
