"""Softmax importance weights and the weighted control update.

Reference semantics (calc_Weights, src/diff_drive_mppi.cpp:212-223):
``w_i = exp(-cost_i / lambda) / sum_j exp(-cost_j / lambda)`` with NO
baseline subtraction — which underflows to all-zero weights (0/0) once costs
exceed ~700*lambda. This implementation subtracts the minimum cost before
exponentiating, which is mathematically identical whenever the reference is
finite and stays well-posed when it is not (documented divergence; the parity
suite uses cost scales where both are finite).

Under sample-axis sharding the baseline is a ``pmin`` and both reductions are
``psum`` over the mesh axis — this pair of collectives is the entire
communication pattern of distributed MPPI.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def elite_threshold(
    costs: jax.Array,
    frac: float,
    axis_name: Optional[str] = None,
    digit_bits: Optional[int] = None,
):
    """Global cost threshold selecting the best ``frac`` of ALL samples.

    Returns EXACTLY the ``round(frac * K_global)``-th smallest cost, found
    by radix descent over the order-preserving unsigned-integer transform of
    the float bits (sign bit flipped for non-negatives, all bits flipped for
    negatives — so unsigned key order == float order). Each round counts the
    keys still in contention per value of one ``digit_bits``-wide digit and
    descends into the bucket containing the target rank.

    The per-round counts are SCATTER-FREE: a dense (K, 2^digit_bits)
    equality-compare reduced over K, which vectorizes cleanly (no
    scatter-add). Whether a sort or ``lax.top_k`` is faster on the GPU is
    not measured yet. digit_bits trades rounds against per-round compare
    width: the default is 4 (8 rounds of 16-wide compares) on one device
    and 8 sharded — ceil(nbits/8) = 4 exact integer psum rounds for f32,
    so at DCN latencies the collectives, not the flops, bound the sharded
    elite step. Every reduction is an exact integer (p)sum, so the sharded
    selection is bit-identical to single-device at any digit width.
    """
    k_local = costs.shape[0]
    n_shards = 1
    if axis_name is not None:
        n_shards = jax.lax.axis_size(axis_name)
    target = max(1, int(round(frac * k_local * n_shards)))

    # Canonicalize NaN -> +inf: negative-sign NaNs would otherwise map below
    # -inf under the bit-key transform (a NaN cost carries zero softmax
    # weight either way).
    costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)

    nbits = costs.dtype.itemsize * 8
    udt = jnp.uint32 if nbits == 32 else jnp.uint64
    sign = jnp.asarray(1, udt) << (nbits - 1)
    b = jax.lax.bitcast_convert_type(costs, udt)
    key = jnp.where(b & sign != 0, ~b, b | sign)

    if digit_bits is None:
        digit_bits = 8 if axis_name is not None else 4
    assert nbits % digit_bits == 0
    nbuckets = 1 << digit_bits
    mask = jnp.asarray(nbuckets - 1, udt)
    buckets = jnp.arange(nbuckets, dtype=udt)
    prefix = jnp.zeros((), udt)  # selected high bits so far
    rank = jnp.asarray(target, jnp.int32)  # rank within the current bucket
    for r in range(nbits // digit_bits):
        shift = nbits - digit_bits * (r + 1)
        digit = (key >> shift) & mask
        eq = digit[:, None] == buckets[None, :]
        if r > 0:
            active = key >> (shift + digit_bits) == prefix
            eq = eq & active[:, None]
        hist = jnp.sum(eq, axis=0, dtype=jnp.int32)
        if axis_name is not None:
            hist = jax.lax.psum(hist, axis_name)
        cum = jnp.cumsum(hist)
        bucket = jnp.argmax(cum >= rank).astype(jnp.int32)
        below = jnp.where(bucket > 0, cum[bucket - 1], 0)
        rank = rank - below
        prefix = (prefix << digit_bits) | bucket.astype(udt)
    # invert the monotone transform: prefix is the k-th smallest key
    raw = jnp.where(prefix & sign != 0, prefix & ~sign, ~prefix)
    return jax.lax.bitcast_convert_type(raw, costs.dtype)


def softmax_weights(
    costs: jax.Array,
    lam,
    axis_name: Optional[str] = None,
    elite_frac: Optional[float] = None,
    elite_thresh=None,
):
    """Globally-normalized importance weights from per-sample costs.

    costs: (K_local,). Returns (weights (K_local,), stats dict). When
    ``axis_name`` is given the normalization spans all shards, so
    concatenating per-shard weights yields the global softmax.

    elite_frac: optional CEM<->MPPI interpolation — zero the weight of every
        sample whose cost is above the global ``elite_frac`` rank threshold
        (:func:`elite_threshold`) before normalizing; elite_frac=1.0 is
        exactly vanilla MPPI. Works sharded: the threshold radix select spans
        all shards and matches single-device bit-exactly. The threshold is
        reported in stats["elite_thresh"].

    elite_thresh: optional EXTERNALLY supplied mask threshold (a traced
        scalar) — the single-pass stale-threshold elite mode: weights are
        masked at THIS value (pass +inf for an unmasked cycle) while
        stats["elite_thresh"] still reports the exact rank threshold of the
        CURRENT costs (from ``elite_frac``) for the caller to feed back in
        next cycle.
    """
    baseline = jnp.min(costs)
    if axis_name is not None:
        baseline = jax.lax.pmin(baseline, axis_name)
    unnorm = jnp.exp(-(costs - baseline) / lam)
    thresh = None
    if elite_frac is not None:
        thresh = elite_threshold(costs, elite_frac, axis_name=axis_name)
    mask_at = elite_thresh if elite_thresh is not None else thresh
    if mask_at is not None:
        unnorm = jnp.where(costs <= mask_at, unnorm, 0.0)
    denom = jnp.sum(unnorm)
    if axis_name is not None:
        denom = jax.lax.psum(denom, axis_name)
    if elite_thresh is not None:
        # a STALE threshold can mask every sample; keep the weights finite
        # (all-zero) and report the empty cycle so the caller can hold the
        # previous plan instead of actuating 0/0 = NaN. The exact rank
        # threshold guarantees survivors, so only this mode needs the guard.
        empty = denom <= 0.0
        weights = unnorm / jnp.where(empty, 1.0, denom)
    else:
        weights = unnorm / denom

    sum_w2 = jnp.sum(weights * weights)
    mean_cost = jnp.sum(costs)
    if axis_name is not None:
        sum_w2 = jax.lax.psum(sum_w2, axis_name)
        mean_cost = jax.lax.psum(mean_cost, axis_name)
        k_total = costs.shape[0] * jax.lax.axis_size(axis_name)
    else:
        k_total = costs.shape[0]
    stats = {
        "min_cost": baseline,
        "mean_cost": mean_cost / k_total,
        # Effective sample size of the importance weights, in [1, K].
        "ess": 1.0 / sum_w2,
    }
    if thresh is not None:
        stats["elite_thresh"] = thresh
    if elite_thresh is not None:
        stats["elite_stale_empty"] = empty
    return weights, stats


def weighted_update(
    weights: jax.Array, samples: jax.Array, axis_name: Optional[str] = None
):
    """New optimal sequence = importance-weighted average of the samples.

    weights: (K,) globally normalized; samples: (T-1, K, U).
    Returns (T-1, U) (reference determine_OptimalSolution,
    src/diff_drive_mppi.cpp:225-246). The contraction over K runs at
    ``Precision.HIGHEST``: an f32 matmul on the GPU otherwise defaults to
    TF32 (~3 decimal digits), far outside the oracle tolerances.
    """
    u = jnp.einsum(
        "k,tku->tu", weights, samples, preferred_element_type=samples.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    if axis_name is not None:
        u = jax.lax.psum(u, axis_name)
    return u
