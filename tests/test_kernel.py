"""Fused Pallas (Triton-route) kernel vs the XLA pipeline, in the Pallas
interpreter on the CPU.

With injected noise the kernel path must match the XLA path to float32
round-off on costs and the optimal sequence, for every model it implements.
The in-kernel generator is checked against jax's own Threefry and, end to
end, against the XLA path fed the same normals. The compiled kernel on the
GPU is checked by chip_smoke.py (phase d) and by the ``gpu``-marked test at
the end of this file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from ccv_mppi_path_tracker_tpu.core import ControllerState
from ccv_mppi_path_tracker_tpu.core.random import next_cycle_key
from ccv_mppi_path_tracker_tpu.core.presets import (
    diff_drive_launch,
    full_body_launch,
    rate_limited_launch,
    steering_launch,
)
from ccv_mppi_path_tracker_tpu.kernels import rollout_cost as rc
from ccv_mppi_path_tracker_tpu.paths import PathBuffer
from ccv_mppi_path_tracker_tpu.solver import mppi_step

T = 12
K = 4096

LAUNCHES = [diff_drive_launch, steering_launch, rate_limited_launch,
            full_body_launch]


def _setup(launch, k=K, horizon=T, seed=2):
    cfg, sp, cp, course = launch(num_samples=k, horizon=horizon,
                                 dtype=np.float32)
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    u_dim = cfg.num_controls
    ctrl = ControllerState(
        u_prev=jnp.asarray(
            np.random.RandomState(1).randn(horizon - 1, u_dim) * 0.1,
            jnp.float32,
        ),
        key=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(cfg.num_states, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(
        np.random.RandomState(seed).randn(horizon - 1, k, u_dim), jnp.float32
    )
    return cfg, sp, cp, path, ctrl, state, noise


@pytest.mark.parametrize(
    "launch", [diff_drive_launch, steering_launch, full_body_launch]
)
def test_kernel_matches_xla_with_injected_noise(launch):
    cfg, sp, cp, path, ctrl, state, noise = _setup(launch)
    dt = jnp.float32(0.1)
    _, res_xla = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, res_krn = mppi_step(
        cfg, ctrl, state, path, dt, sp, cp, noise=noise,
        use_kernel=True, kernel_interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(res_krn.u_opt), np.asarray(res_xla.u_opt), rtol=2e-5, atol=2e-6
    )
    np.testing.assert_allclose(
        float(res_krn.stats["min_cost"]),
        float(res_xla.stats["min_cost"]),
        rtol=2e-5,
    )
    np.testing.assert_allclose(
        float(res_krn.stats["ess"]), float(res_xla.stats["ess"]), rtol=1e-3
    )


def test_kernel_steer_off_zeroes_direction():
    cfg, sp, cp, course = full_body_launch(num_samples=K, horizon=T)
    cfg = cfg.__class__(
        model=cfg.model, num_samples=K, horizon=T, steer_off=True
    )
    path = PathBuffer.from_points(course, 0.1)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 5)
    state = jnp.zeros(5, jnp.float32)
    noise = jnp.asarray(np.random.RandomState(3).randn(T - 1, K, 5), jnp.float32)
    _, res = mppi_step(
        cfg, ctrl, state, path, jnp.float32(0.1), sp, cp, noise=noise,
        use_kernel=True, kernel_interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(res.u_opt[:, 2]), 0.0)


def test_kernel_rng_mode_statistics():
    """In-kernel generator: the update is deterministic for a fixed key,
    finite, inside the control box, and a new key gives a new update."""
    cfg, sp, cp, path, ctrl, state, _ = _setup(diff_drive_launch, k=1024)
    dt = jnp.float32(0.1)
    run = lambda c: mppi_step(cfg, c, state, path, dt, sp, cp,
                              use_kernel=True, kernel_interpret=True)[1]
    res_a, res_b = run(ctrl), run(ctrl)
    np.testing.assert_array_equal(
        np.asarray(res_a.u_opt), np.asarray(res_b.u_opt)
    )
    assert np.isfinite(np.asarray(res_a.u_opt)).all()
    assert float(jnp.max(res_a.u_opt[:, 0])) <= float(sp.u_max[0]) + 1e-6
    assert float(jnp.min(res_a.u_opt[:, 0])) >= float(sp.u_min[0]) - 1e-6
    res_c = run(dataclasses.replace(ctrl, key=jax.random.PRNGKey(1)))
    assert np.abs(np.asarray(res_c.u_opt - res_a.u_opt)).max() > 1e-4


def test_kernel_rate_limited_matches_xla():
    from ccv_mppi_path_tracker_tpu.core.config import rate_limited_steering_config

    cfg, sp, cp = rate_limited_steering_config(
        num_samples=K, horizon=T, path_weight=10.0
    )
    _, _, _, course = diff_drive_launch()
    path = PathBuffer.from_points(course, 0.1, dtype=np.float32)
    ctrl = ControllerState.initial(jax.random.PRNGKey(0), T, 3)
    state = jnp.zeros(4, jnp.float32).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(5).randn(T - 1, K, 3), jnp.float32)
    dt = jnp.float32(0.1)
    _, a = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, b = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                     use_kernel=True, kernel_interpret=True)
    # f32 rounding between the XLA reduction order and the kernel's per-block
    # sums grows with T; observed ~2e-5 max abs at T=60
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=5e-4, atol=5e-5)


def test_batched_kernel_matches_per_robot_loop():
    """Fleet mode is jax.vmap over the single-robot kernel: the vmapped call
    (robot axis added to the grid) == per-robot calls, injected noise."""
    B, Kb, Tb = 3, 1000, 8
    cfg, sp, cp, course = diff_drive_launch(num_samples=Kb, horizon=Tb)
    rng = np.random.RandomState(0)
    u_prev = jnp.asarray(rng.randn(B, Tb - 1, 2) * 0.1, jnp.float32)
    ref = jnp.asarray(rng.randn(B, Tb, 2), jnp.float32)
    state0 = jnp.asarray(rng.randn(B, 3), jnp.float32)
    scal = jnp.stack([
        rc.pack_scalars(jnp.float32(0.1), cp, float(b), lam=sp.lam)
        for b in range(B)
    ])
    seeds = jnp.arange(B, dtype=jnp.uint32)
    noise = jnp.asarray(rng.randn(B, Tb - 1, Kb, 2), jnp.float32)

    def one(u, r, s, sc, seed, n):
        return rc.fused_sample_rollout_cost(
            u, sp.control_noise, sp.u_min, sp.u_max, r, s, sc, seed,
            num_samples=Kb, model="unicycle", noise=n, interpret=True,
        )

    cv, pv = jax.vmap(one)(u_prev, ref, state0, scal, seeds, noise)
    assert cv.shape == (B, Kb)
    for b in range(B):
        c, p = one(u_prev[b], ref[b], state0[b], scal[b], seeds[b], noise[b])
        np.testing.assert_allclose(np.asarray(cv[b]), np.asarray(c), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(pv[b]), np.asarray(p), rtol=1e-6)


def test_kernel_matches_xla_at_tall_horizon_tile_switch():
    """T=60 widens the per-block partials row past 256 slots — parity must
    hold there, not just at the T=12 default."""
    Tt = 60
    assert rc.num_slots(Tt, 5, False) > rc.num_slots(T, 5, False)
    cfg, sp, cp, path, ctrl, state, noise = _setup(full_body_launch,
                                                   horizon=Tt)
    dt = jnp.float32(0.1)
    _, a = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, b = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                     use_kernel=True, kernel_interpret=True)
    # f32 rounding between the XLA reduction order and the kernel's
    # per-block sums grows with T; observed ~2e-5 max abs at T=60
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=5e-4, atol=5e-5)


def test_kernel_elite_frac_matches_xla():
    """elite_frac on the kernel path (costs-only pass, then a costs-in pass
    masked at the threshold) == the XLA path's rank-thresholded update."""
    cfg, sp, cp, path, ctrl, state, noise = _setup(full_body_launch)
    dt = jnp.float32(0.1)
    _, a = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                     elite_frac=0.1)
    _, b = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                     elite_frac=0.1, use_kernel=True, kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        float(b.stats["elite_thresh"]), float(a.stats["elite_thresh"]),
        rtol=1e-6,
    )


def test_kernel_masked_tail_matches_xla_at_reference_k():
    """ANY K is accepted: the reference's own full_body default K=10000
    (src/full_body_mppi.cpp:10, not a power of two) pads to whole blocks
    with the tail given no weight — the update and costs must match the XLA
    pipeline at the true K under injected noise."""
    Km = 10000
    assert Km % rc.block_size(Km) != 0  # genuinely exercises the mask
    cfg, sp, cp, path, ctrl, state, noise = _setup(full_body_launch, k=Km)
    dt = jnp.float32(0.1)
    _, a = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, b = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                     use_kernel=True, kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        float(b.stats["min_cost"]), float(a.stats["min_cost"]), rtol=2e-5
    )
    # elite_frac's two-pass flow must honor the same mask
    _, ae = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                      elite_frac=0.1)
    _, be = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                      elite_frac=0.1, use_kernel=True, kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(be.u_opt), np.asarray(ae.u_opt),
                               rtol=2e-4, atol=2e-5)


# Known-answer vectors of Threefry-2x32-20 (Random123's kat_vectors, also
# pinned by jax's own tests): (key, counter) -> output.
THREEFRY_KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def _threefry_in_kernel(k0, k1, x0, x1):
    """Run rc.threefry2x32 inside a Triton-route pallas_call (interpreter)."""
    n = x0.shape[0]

    def kern(k_ref, x0_ref, x1_ref, y0_ref, y1_ref):
        y0, y1 = rc.threefry2x32(k_ref[0], k_ref[1], x0_ref[...], x1_ref[...])
        y0_ref[...] = y0
        y1_ref[...] = y1

    return pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.uint32)] * 2,
        backend="triton",
        interpret=True,
    )(jnp.asarray([k0, k1], jnp.uint32), x0, x1)


@pytest.mark.parametrize("case", range(len(THREEFRY_KAT)))
def test_threefry_known_answers(case):
    (k0, k1), (c0, c1), (y0, y1) = THREEFRY_KAT[case]
    x0 = jnp.full((32,), c0, jnp.uint32)
    x1 = jnp.full((32,), c1, jnp.uint32)
    got0, got1 = _threefry_in_kernel(k0, k1, x0, x1)
    np.testing.assert_array_equal(np.asarray(got0), y0)
    np.testing.assert_array_equal(np.asarray(got1), y1)


def test_threefry_in_kernel_matches_jax_reference():
    """In-kernel Threefry output == jax's threefry2x32 primitive on the
    counters the kernel uses (sample index, t*ceil(U/2) + pair)."""
    from jax._src.prng import threefry2x32_p

    seed = np.uint32(0xDEADBEEF)
    x0 = jnp.arange(256, dtype=jnp.uint32)
    for c1 in (0, 1, 7, 2**31 + 5):
        x1 = jnp.full((256,), c1, jnp.uint32)
        got = _threefry_in_kernel(seed, 0, x0, x1)
        want = threefry2x32_p.bind(
            jnp.full((256,), seed, jnp.uint32), jnp.zeros((256,), jnp.uint32),
            x0, x1,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _kernel_stream(seed, k, horizon, u_dim):
    """The kernel's normals for every (t, sample, u), built outside the
    kernel from the same counters: (T-1, K, U)."""
    idx = jnp.arange(k, dtype=jnp.uint32)
    rows = [jnp.stack(rc.kernel_normals(seed, idx, jnp.int32(t), u_dim), -1)
            for t in range(horizon - 1)]
    return jnp.stack(rows)


@pytest.mark.parametrize("launch", LAUNCHES)
def test_kernel_rng_stream_matches_injected_reference(launch):
    """RNG mode end to end: the kernel drawing its own normals == the XLA
    pipeline fed those normals (rebuilt in plain jnp from the counters)."""
    Kr, Tr = 1000, 8
    cfg, sp, cp, path, ctrl, state, _ = _setup(launch, k=Kr, horizon=Tr)
    dt = jnp.float32(0.1)
    _, use_key = next_cycle_key(ctrl.key)  # the key mppi_step draws with
    seed = jax.random.bits(use_key, (), jnp.uint32)
    noise = _kernel_stream(seed, Kr, Tr, cfg.num_controls)
    assert abs(float(jnp.mean(noise))) < 0.05
    assert abs(float(jnp.std(noise)) - 1.0) < 0.05
    _, a = mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise)
    _, b = mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                     use_kernel=True, kernel_interpret=True)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=2e-5, atol=2e-6)


def test_block_partials_combine_matches_single_block(monkeypatch):
    """Many blocks, each summed under its own min and rescaled in
    combine_partials == one block holding every sample."""
    cfg, sp, cp, path, ctrl, state, noise = _setup(full_body_launch, k=1024)
    dt = jnp.float32(0.1)
    run = lambda: mppi_step(cfg, ctrl, state, path, dt, sp, cp, noise=noise,
                            use_kernel=True, kernel_interpret=True,
                            adapt_sigma=True)[1]
    monkeypatch.setattr(rc, "BLOCK", 1024)
    one = run()
    monkeypatch.setattr(rc, "BLOCK", 64)
    assert rc.block_size(1024) == 64
    many = run()
    np.testing.assert_allclose(np.asarray(many.u_opt), np.asarray(one.u_opt),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(many.stats["sigma_suggest"]),
                               np.asarray(one.stats["sigma_suggest"]),
                               rtol=1e-4, atol=1e-6)


def test_combine_partials_rescales_to_baseline():
    """Two blocks with mins m_b: their sums move to the common baseline by
    exp(-(m_b - baseline)/lam), exactly the single-softmax result."""
    rng = np.random.RandomState(0)
    costs = rng.rand(2, 8) * 3.0 + np.array([[1.0], [4.0]])
    u = rng.randn(2, 8, 3, 2)  # (block, sample, T-1, U)
    lam = 0.7
    npad = rc.num_slots(4, 2, False)
    parts = np.zeros((2, npad))
    for b in range(2):
        w = np.exp(-(costs[b] - costs[b].min()) / lam)
        parts[b, :6] = np.einsum("k,ktu->tu", w, u[b]).ravel()
        parts[b, 6] = w.sum()
        parts[b, 7] = costs[b].min()
    u_num, u2, norm = rc.combine_partials(jnp.asarray(parts), costs.min(),
                                          lam, 4, 2)
    w = np.exp(-(costs.ravel() - costs.min()) / lam)
    want = np.einsum("k,ktu->tu", w, u.reshape(16, 3, 2))
    assert u2 is None
    np.testing.assert_allclose(np.asarray(u_num), want, rtol=1e-12)
    np.testing.assert_allclose(float(norm), w.sum(), rtol=1e-12)


def test_kernel_non_power_of_two_k_pads_tail():
    """K=1000 is not a whole number of blocks: the padded lanes of the last
    block give no weight and no min, and the costs come back at the true K."""
    Kn = 1000
    blk = rc.block_size(Kn)
    nb = -(-Kn // blk)
    last = (nb - 1) * blk
    assert Kn % blk != 0
    cfg, sp, cp, path, ctrl, state, noise = _setup(diff_drive_launch, k=Kn)
    scal = rc.pack_scalars(jnp.float32(0.1), cp, 0.0, lam=sp.lam)
    ref_xy = jnp.asarray(np.random.RandomState(4).randn(T, 2), jnp.float32)
    args = (ctrl.u_prev, sp.control_noise, sp.u_min, sp.u_max, ref_xy,
            state, scal, jnp.uint32(0))
    costs, parts = rc.fused_sample_rollout_cost(
        *args, num_samples=Kn, model="unicycle", noise=noise, interpret=True)
    assert costs.shape == (Kn,)
    assert parts.shape == (nb, rc.num_slots(T, 2, False))
    n_sum = (T - 1) * 2
    # the last block's min and weight sum cover its real samples only
    tail = costs[last:]
    np.testing.assert_allclose(float(parts[-1, n_sum + 1]),
                               float(jnp.min(tail)), rtol=1e-6)
    w = jnp.exp(-(tail - jnp.min(tail)) / sp.lam)
    np.testing.assert_allclose(float(parts[-1, n_sum]), float(jnp.sum(w)),
                               rtol=1e-5)


def test_use_kernel_without_gpu_raises():
    """Off the GPU the compiled kernel does not exist: use_kernel=True must
    refuse instead of silently running the interpreter."""
    cfg, sp, cp, path, ctrl, state, noise = _setup(diff_drive_launch, k=256)
    with pytest.raises(ValueError, match="needs a GPU"):
        mppi_step(cfg, ctrl, state, path, jnp.float32(0.1), sp, cp,
                  use_kernel=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel agrees with the XLA pipeline under
    injected noise (full_body, K=102400, T=30)."""
    cfg, sp, cp, path, ctrl, state, noise = _setup(full_body_launch,
                                                   k=102400, horizon=30)
    dt = jnp.float32(0.1)
    _, a = jax.jit(lambda n: mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                                       noise=n))(noise)
    _, b = jax.jit(lambda n: mppi_step(cfg, ctrl, state, path, dt, sp, cp,
                                       noise=n, use_kernel=True))(noise)
    np.testing.assert_allclose(np.asarray(b.u_opt), np.asarray(a.u_opt),
                               rtol=1e-3, atol=1e-4)
