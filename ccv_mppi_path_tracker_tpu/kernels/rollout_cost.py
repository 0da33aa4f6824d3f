"""Fused sample + rollout + cost + weighted-update kernel (Pallas, Triton route).

The XLA pipeline writes the (T, K, S) rollout and the (T-1, K, U) noise and
sampled controls to device memory and reads them back for the cost and the
weighted update: ~120 MB per control step at K=1e5, T=30 (~1.2 GB at K=1M),
spread over dozens of fusions. This kernel keeps every sample's controls and
states in registers and writes only the K costs plus one small row of
partial sums per block of samples.

One program handles one power-of-two block of samples (``BLOCK`` of them; the
padded tail of the last block is masked):

- **Pass A** walks the horizon inside the block: draw the noise, colour it
  (``noise_beta``), clamp, take the Euler step, run the ZMP chain (full_body)
  and the min-distance scan over the reference window. Result: one cost per
  sample.
- **Block-local softmax**: block min ``m_b`` and weights
  ``w = exp(-(c - m_b)/lam)``, zeroed on the padded tail and above
  ``cost_thresh`` (elite masking).
- **Pass B** regenerates the same controls (counter-based RNG: same counters,
  same numbers) and reduces ``sum w*u`` per (t, u), ``sum w`` and, with
  ``second_moment``, ``sum w*u^2``. The (T-1)*U*BLOCK controls would not fit
  a block's registers, so they are drawn twice instead of stored.

Blocks run in parallel and in no order, so nothing is carried between them:
:func:`combine_partials` rescales each block's partials from ``m_b`` to the
global min in plain JAX — the same exact rescale algebra the sample-sharded
path uses across devices.

Random numbers are Threefry-2x32 (20 rounds, the generator behind
``jax.random``'s default keys) keyed by (seed, 0) over the counter (sample
index, t * ceil(U/2) + pair), followed by Box-Muller: each counter gives the
two normals of one control pair. The stream is deterministic for a seed but
differs from ``jax.random.normal``; parity tests inject the noise instead
(``noise``), which pass B then re-reads.

Cost semantics are those of ops/costs.py, including the 100 m distance cap
and the full-body ZMP chain (src/full_body_mppi.cpp:404-424, :445-486).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ccv_mppi_path_tracker_tpu.ops.mindist import DIST_CAP, center_ref
from ccv_mppi_path_tracker_tpu.ops.sampling import STEER_DIM

# Samples per program and warps per program: one sample per thread. On an
# H100 (700 W) this beat 64..512-sample blocks with 2..16 warps at full_body
# K=102400 and K=1048576, T=30 (PERF.md, Findings).
BLOCK = 128
NUM_WARPS = 4

# Model families the fused kernel implements; "auto" must fall back to the
# XLA pipeline for anything else (e.g. user-registered models).
KERNEL_MODELS = (
    "unicycle", "steering_unicycle", "rate_limited_steering", "full_body"
)

# use_kernel="auto": the fused kernel is chosen at or above this many state
# propagations per update, K * (T-1), on the device kinds it was timed on.
# Any other device kind gets the XLA pipeline (see should_use_kernel). On an
# H100 (700 W) the kernel's full control update beat XLA's at every size
# timed, unicycle and full_body, K=1000..1048576, T=15 and 30 (bench.py;
# PERF.md); the threshold is the smallest of them, unicycle K=1000 T=15.
KERNEL_MIN_PROPS_BY_KIND: dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 1000 * 14,
}

# scalar-parameter slots (pack_scalars)
# [dt, v_ref, path_w, v_w, zmp_w, roll_v_w, back_w, yaw_w, yaw_ref0,
#  mass, base2com, Ixx, Iyy, Izz, gravity_z, noise_beta, lam, cost_thresh]
# cost_thresh (+inf = vanilla) zeroes the weight of samples above it
# (elite_frac; ops/softmax_update.py elite_threshold supplies the exact rank
# threshold and the solver makes a second, costs-in pass with it).
_NSCAL = 18

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def should_use_kernel(num_samples: int, horizon: int,
                      model: Optional[str] = None,
                      device_kind: Optional[str] = None) -> bool:
    """use_kernel="auto" policy: the fused kernel iff the default backend is
    a GPU whose ``device_kind`` has a measured threshold, the model is one
    the kernel implements, and K*(T-1) reaches that threshold. ``device_kind``
    overrides the detected one (tests)."""
    if model is not None and model not in KERNEL_MODELS:
        return False
    if device_kind is None:
        if jax.default_backend() != "gpu":
            return False
        device_kind = jax.devices()[0].device_kind
    min_props = KERNEL_MIN_PROPS_BY_KIND.get(device_kind)
    if min_props is None:
        _log_unmeasured_kind(device_kind)
        return False
    return num_samples * (horizon - 1) >= min_props


@functools.cache
def _log_unmeasured_kind(device_kind: str) -> None:
    print(f"use_kernel='auto': no kernel timing for device kind "
          f"{device_kind!r}; using the XLA pipeline")


def block_size(num_samples: int) -> int:
    """Samples per program: ``BLOCK``, or the next power of two >= K when K
    is smaller (at least 32, one warp's width)."""
    return min(BLOCK, max(32, pl.next_power_of_2(num_samples)))


def num_slots(horizon: int, u_dim: int, second_moment: bool) -> int:
    """Width of one block's partials row: (T-1)*U sums of w*u, as many of
    w*u^2 with ``second_moment``, the sum of w, and the block min, padded to
    a power of two."""
    nu = (horizon - 1) * u_dim * (2 if second_moment else 1)
    return pl.next_power_of_2(nu + 2)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (jnp ops only, so the same
    code runs inside the kernel and outside it). Same function as
    ``jax.random``'s threefry2x32 for key (k0, k1) and counter (x0, x1)."""
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def box_muller(b0, b1):
    """Two uint32 words -> two independent standard normals. 24 bits each:
    u1 in (0, 1] keeps the log finite, u2 in [0, 1) sets the angle."""
    scale = np.float32(1.0 / (1 << 24))
    u1 = ((b0 >> np.uint32(8)) + np.uint32(1)).astype(jnp.float32) * scale
    u2 = (b1 >> np.uint32(8)).astype(jnp.float32) * scale
    r = jnp.sqrt(np.float32(-2.0) * jnp.log(u1))
    theta = np.float32(2.0 * np.pi) * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def kernel_normals(seed, sample_idx, t, u_dim: int):
    """The U standard normals the kernel draws for step ``t`` of the samples
    ``sample_idx`` (uint32) under ``seed`` (uint32): pair p of the controls
    comes from counter (sample, t*ceil(U/2) + p)."""
    n_pairs = (u_dim + 1) // 2
    etas = []
    for p in range(n_pairs):
        c1 = jax.lax.convert_element_type(t * n_pairs + p, jnp.uint32)
        b0, b1 = threefry2x32(seed, np.uint32(0), sample_idx,
                              jnp.broadcast_to(c1, sample_idx.shape))
        etas.extend(box_muller(b0, b1))
    return etas[:u_dim]


def _make_kernel(model: str, horizon: int, num_ref: int, u_dim: int,
                 n_state: int, block: int, num_samples: int, *,
                 noise_in: bool, steer_off: bool, second_moment: bool,
                 accumulate: bool, costs_in: bool):
    tm1 = horizon - 1
    nu = tm1 * u_dim
    n_sum = nu * (2 if second_moment else 1)
    npad = num_slots(horizon, u_dim, second_moment)
    cap2 = np.float32(DIST_CAP * DIST_CAP)
    # offsets into the packed parameter vector (see fused_sample_rollout_cost)
    o_u = _NSCAL
    o_sig = o_u + nu
    o_lo = o_sig + u_dim
    o_hi = o_lo + u_dim
    o_st = o_hi + u_dim
    o_ref = o_st + n_state
    steer_max = rate_max = None
    if model == "rate_limited_steering":
        from ccv_mppi_path_tracker_tpu.ops.rollout import steer_limits

        steer_max, rate_max = steer_limits(model)

    def kernel(*refs):
        refs = list(refs)
        prm, seed_ref = refs.pop(0), refs.pop(0)
        noise = refs.pop(0) if noise_in else None
        cin = refs.pop(0) if costs_in else None
        cost_out = None if costs_in else refs.pop(0)
        part_out = refs.pop(0) if accumulate else None

        start = pl.program_id(0) * block
        idx = start + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
        sc = lambda i: prm[i]
        beta = sc(15)
        bscale = jnp.sqrt(1.0 - beta * beta)
        seed = seed_ref[0]
        sample_idx = idx.astype(jnp.uint32)

        def draw(t, eps_prev):
            """Controls of step t (U vectors) and the coloured noise state."""
            if noise_in:
                etas = [noise[t, j, pl.ds(start, block)] for j in range(u_dim)]
            else:
                etas = kernel_normals(seed, sample_idx, t, u_dim)
            if eps_prev is None:
                eps = etas
            else:
                eps = [beta * e + bscale * n for e, n in zip(eps_prev, etas)]
            u = []
            for j in range(u_dim):
                val = sc(o_u + t * u_dim + j) + sc(o_sig + j) * eps[j]
                val = jnp.minimum(jnp.maximum(val, sc(o_lo + j)), sc(o_hi + j))
                if steer_off and j == STEER_DIM:
                    val = jnp.zeros_like(val)
                u.append(val)
            return u, eps

        if costs_in:
            cost = cin[...]
        else:
            cost = _rollout_cost(model, draw, sc, horizon, num_ref, block,
                                 o_st, o_ref, cap2, steer_max, rate_max)
            cost_out[...] = cost
        if not accumulate:
            return

        # block-local softmax; padded lanes carry no weight and no min
        valid = idx < num_samples
        m_b = jnp.min(jnp.where(valid, cost, jnp.inf))
        w = jnp.exp((cost - m_b) * (-1.0 / sc(16)))
        w = jnp.where(valid & (cost <= sc(17)), w, 0.0)

        slot = jax.lax.broadcasted_iota(jnp.int32, (npad,), 0)

        def accumulate_row(t, u, acc):
            for j in range(u_dim):
                wu = w * u[j]
                acc = jnp.where(slot == t * u_dim + j, jnp.sum(wu), acc)
                if second_moment:
                    acc = jnp.where(slot == nu + t * u_dim + j,
                                    jnp.sum(wu * u[j]), acc)
            return acc

        acc = jnp.zeros((npad,), jnp.float32)
        acc = jnp.where(slot == n_sum, jnp.sum(w), acc)
        acc = jnp.where(slot == n_sum + 1, m_b, acc)
        u, eps = draw(0, None)
        acc = accumulate_row(0, u, acc)

        def pass_b(t, carry):
            eps, acc = carry
            u, eps = draw(t, eps)
            return eps, accumulate_row(t, u, acc)

        _, acc = jax.lax.fori_loop(1, tm1, pass_b, (eps, acc))
        part_out[...] = acc

    return kernel


def _rollout_cost(model, draw, sc, horizon, num_ref, block, o_st, o_ref,
                  cap2, steer_max, rate_max):
    """Pass A: one cost per sample of the block (ops/costs.py semantics)."""
    tm1 = horizon - 1
    dt, v_ref = sc(0), sc(1)
    full = lambda v: jnp.full((block,), v, jnp.float32)

    def path_d2(x, y):
        # centered expanded form (ops/mindist.py), same expression tree
        m = full(jnp.inf)
        for j in range(num_ref):
            r = o_ref + 3 * j
            m = jnp.minimum(m, sc(r + 2) - x * sc(r) - y * sc(r + 1))
        return jnp.minimum(jnp.maximum(x * x + y * y + m, 0.0), cap2)

    x, y, yaw = full(sc(o_st)), full(sc(o_st + 1)), full(sc(o_st + 2))
    cost = full(0.0)
    u, eps = draw(0, None)

    if model == "full_body":
        roll, pitch = full(sc(o_st + 3)), full(sc(o_st + 4))
        mass, c, ixx, gz = sc(9), sc(10), sc(11), sc(14)
        bz = mass * gz
        hx = ixx / dt
        dyaw0 = yaw - sc(8)
        cost = cost + sc(7) * dyaw0 * dyaw0

        def body(t, carry):
            x, y, yaw, roll, pitch, cost, u, eps = carry
            u_next, eps = draw(t + 1, eps)
            v, w, direc, roll_v, pitch_v = u
            cost = cost + sc(2) * path_d2(x, y)
            dv = v - v_ref
            cost = cost + sc(3) * dv * dv
            droll_v = u_next[3] - roll_v
            cost = cost + sc(5) * droll_v * droll_v
            cost = cost + sc(6) * jnp.where(v < 0.0, v * v, 0.0)
            # ZMP chain (models/full_body.py zmp_chain), y component
            da = (u_next[0] - v) / dt
            ac = v * w
            ay = da * jnp.sin(direc) + ac * jnp.cos(direc)
            com_y = -c * jnp.sin(roll)
            com_z = c * jnp.cos(pitch) * jnp.cos(roll)
            mo_x = com_y * bz - com_z * (-mass * ay) - droll_v * hx
            zmp_y = mo_x / bz
            cost = cost + sc(4) * zmp_y * zmp_y
            heading = yaw + direc
            x = x + v * jnp.cos(heading) * dt
            y = y + v * jnp.sin(heading) * dt
            yaw = yaw + w * dt
            roll = roll + roll_v * dt
            pitch = pitch + pitch_v * dt
            return x, y, yaw, roll, pitch, cost, u_next, eps

        carry = jax.lax.fori_loop(
            0, horizon - 2, body, (x, y, yaw, roll, pitch, cost, u, eps)
        )
        return carry[5]

    # steering-angle state of rate_limited_steering (a placeholder otherwise)
    steer = full(sc(o_st + 3) if steer_max is not None else 0.0)

    def step(x, y, yaw, steer, cost, u):
        cost = cost + sc(2) * path_d2(x, y)
        v, w = u[0], u[1]
        dv = v - v_ref
        cost = cost + sc(3) * dv * dv
        if model == "unicycle":
            heading = yaw
        elif steer_max is not None:
            heading = yaw + steer
        else:
            heading = yaw + u[2]
        x = x + v * jnp.cos(heading) * dt
        y = y + v * jnp.sin(heading) * dt
        yaw = yaw + w * dt
        if steer_max is not None:
            rate = jnp.minimum(jnp.maximum(u[2], -rate_max), rate_max)
            steer = jnp.minimum(jnp.maximum(steer + rate * dt, -steer_max),
                                steer_max)
        return x, y, yaw, steer, cost

    def body(t, carry):
        x, y, yaw, steer, cost, u, eps = carry
        x, y, yaw, steer, cost = step(x, y, yaw, steer, cost, u)
        u, eps = draw(t + 1, eps)
        return x, y, yaw, steer, cost, u, eps

    x, y, yaw, steer, cost, u, _ = jax.lax.fori_loop(
        0, tm1 - 1, body, (x, y, yaw, steer, cost, u, eps))
    x, y, yaw, _, cost = step(x, y, yaw, steer, cost, u)
    return cost + sc(2) * path_d2(x, y)  # final state's path term


def fused_sample_rollout_cost(
    u_prev,
    sigma,
    u_min,
    u_max,
    ref_xy,
    state0,
    scal,
    seed,
    num_samples: int,
    model: str,
    steer_off: bool = False,
    noise: Optional[jax.Array] = None,
    interpret: bool = False,
    vma_axis: Optional[str] = None,
    second_moment: bool = False,
    accumulate: bool = True,
    costs_in: Optional[jax.Array] = None,
):
    """Run the fused kernel for one robot (``jax.vmap`` it for a fleet).

    u_prev: (T-1, U) sampling mean; sigma/u_min/u_max: (U,); ref_xy: (T_ref,
    2); state0: (S,); scal: (_NSCAL,) from :func:`pack_scalars`; seed: ()
    uint32. noise (optional, parity mode): (T-1, K, U) standard normals used
    instead of the in-kernel generator.

    Returns ``(costs, partials)``: costs (K,) and partials (K_pad/BLOCK,
    num_slots) for :func:`combine_partials`. ``accumulate=False`` skips pass
    B and returns ``(costs, None)``; ``costs_in`` (K,) skips pass A — the
    costs come in from an ``accumulate=False`` pass over the same samples —
    and returns ``(None, partials)``. ANY K is accepted: K is padded to whole
    blocks and the padded tail carries no weight.
    """
    assert model in KERNEL_MODELS, (
        f"fused kernel does not implement model {model!r}; use the XLA path"
    )
    assert accumulate or costs_in is None, "costs_in exists to accumulate"
    tm1, u_dim = u_prev.shape
    horizon = tm1 + 1
    num_ref = ref_xy.shape[0]
    n_state = state0.shape[0]
    block = block_size(num_samples)
    k_pad = -(-num_samples // block) * block
    n_blocks = k_pad // block

    # Centered expanded-form distance constants (ops/mindist.py): rows
    # [2*(ref-c), |ref-c|^2] and a start state translated by -c, c = ref[0].
    # Positions enter the cost only through distances, so the shift is
    # unobservable.
    c, rc2, rn = center_ref(ref_xy)
    refc = jnp.concatenate([rc2, rn[:, None]], axis=-1)
    state0 = jnp.concatenate([state0[:2] - c, state0[2:]])
    prm = jnp.concatenate([
        scal, u_prev.reshape(-1), sigma, u_min, u_max, state0,
        refc.reshape(-1),
    ]).astype(jnp.float32)
    inputs = [prm, jnp.reshape(seed, (1,)).astype(jnp.uint32)]
    in_specs = [pl.no_block_spec, pl.no_block_spec]
    if noise is not None:
        # (T-1, K, U) -> (T-1, U, K_pad): one contiguous row per (t, u)
        noise = jnp.transpose(noise, (0, 2, 1))
        noise = jnp.pad(noise, ((0, 0), (0, 0), (0, k_pad - num_samples)))
        inputs.append(noise)
        in_specs.append(pl.no_block_spec)
    if costs_in is not None:
        inputs.append(jnp.pad(costs_in, (0, k_pad - num_samples),
                              constant_values=jnp.inf))
        in_specs.append(pl.BlockSpec((block,), lambda i: (i,)))

    vma = frozenset({vma_axis}) if vma_axis is not None else frozenset()
    out_shape, out_specs = [], []
    if costs_in is None:
        out_shape.append(jax.ShapeDtypeStruct((k_pad,), jnp.float32, vma=vma))
        out_specs.append(pl.BlockSpec((block,), lambda i: (i,)))
    if accumulate:
        npad = num_slots(horizon, u_dim, second_moment)
        out_shape.append(
            jax.ShapeDtypeStruct((n_blocks, npad), jnp.float32, vma=vma))
        out_specs.append(pl.BlockSpec((None, npad), lambda i: (i, 0)))

    kernel = _make_kernel(
        model, horizon, num_ref, u_dim, n_state, block, num_samples,
        noise_in=noise is not None, steer_off=steer_off,
        second_moment=second_moment, accumulate=accumulate,
        costs_in=costs_in is not None,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, min(NUM_WARPS, block // 32))),
        interpret=interpret,
        name=f"mppi_fused_{model}",
    )(*inputs)
    outs = list(outs)
    costs = None if costs_in is not None else outs.pop(0)[:num_samples]
    partials = outs.pop(0) if accumulate else None
    return costs, partials


def combine_partials(partials, baseline, lam, horizon: int, u_dim: int,
                     second_moment: bool = False):
    """Fold the blocks' partials into (sum w*u (T-1, U), sum w*u^2 or None,
    sum w), all under the weights exp(-(c - baseline)/lam).

    Block b's sums were taken under its own min m_b; exp(-(m_b -
    baseline)/lam) moves them to ``baseline`` exactly. ``baseline`` is the
    min cost over every sample (over every shard when sample-sharded, where
    the caller then psums the three results)."""
    nu = (horizon - 1) * u_dim
    n_sum = nu * (2 if second_moment else 1)
    scale = jnp.exp(-(partials[:, n_sum + 1] - baseline) / lam)
    tot = jnp.sum(scale[:, None] * partials[:, :n_sum + 1], axis=0)
    u_num = tot[:nu].reshape(horizon - 1, u_dim)
    u2_num = tot[nu:n_sum].reshape(horizon - 1, u_dim) if second_moment else None
    return u_num, u2_num, tot[n_sum]


def pack_scalars(dt, cp, yaw_ref0, model_params=None, noise_beta=0.0,
                 lam=1.0, cost_thresh=None, dtype=jnp.float32):
    """Build the (_NSCAL,) scalar-parameter vector from the cost/model pytrees."""
    if cost_thresh is None:
        cost_thresh = jnp.inf
    zeros = jnp.zeros((), dtype)
    if model_params is not None:
        mp = [
            model_params.mass,
            model_params.base2com,
            model_params.inertia[0],
            model_params.inertia[1],
            model_params.inertia[2],
            model_params.gravity_z,
        ]
    else:
        mp = [zeros] * 6
    vals = [
        dt, cp.v_ref, cp.path_weight, cp.v_weight, cp.zmp_weight,
        cp.roll_v_weight, cp.back_weight, cp.yaw_weight, yaw_ref0, *mp,
        noise_beta, lam, cost_thresh,
    ]
    return jnp.stack([jnp.asarray(v, dtype) for v in vals])
