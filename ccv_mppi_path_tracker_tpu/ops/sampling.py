"""Gaussian control-perturbation sampling.

One batched draw replaces the reference's K x (T-1) x U serial
``std::normal_distribution`` loop (src/diff_drive_mppi.cpp:81-102). Semantics
preserved:

- samples are centered on the *previous optimal sequence* (warm start, no
  one-step shift — src/diff_drive_mppi.cpp:89-90);
- the draw is clamped to the box bounds afterwards (:98-99), so the sampling
  distribution is a censored Gaussian, exactly as in the reference;
- ``steer_off`` zeroes the direction channel after clamping
  (src/full_body_mppi.cpp:517).

Layout is time-major (T-1, K, U): ``lax.scan`` consumes the leading axis, and
K is the contiguous, vectorized axis of every elementwise op.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ccv_mppi_path_tracker_tpu.core.config import SolverParams

# Control-channel index of the steering/"direction" input in the steering and
# full-body models (models/steering_unicycle.py, models/full_body.py).
STEER_DIM = 2


def color_noise(white, beta):
    """First-order low-pass over the horizon: eps_t = b*eps_{t-1} +
    sqrt(1-b^2)*eta_t. Unit marginal variance for any b; b=0 is the exact
    identity (the reference's white sampling). beta is a traced SolverParams
    field (retuning never recompiles), so the b=0 fast path is a runtime
    ``lax.cond`` that skips the (T-1)-step sequential scan — ~30 extra
    (K, U)-sized fusions per solve — on the default white-noise path."""

    def colored(white):
        scale = jnp.sqrt(1.0 - beta * beta)

        def body(prev, eta):
            eps = beta * prev + scale * eta
            return eps, eps

        _, rest = jax.lax.scan(body, white[0], white[1:])
        return jnp.concatenate([white[:1], rest], axis=0)

    return jax.lax.cond(beta == 0.0, lambda n: n, colored, white)


def draw_standard_normals(key, shape, dtype):
    """The production exploration-noise draw, through the RBG generator
    (XLA's RngBitGenerator). Whether threefry would be faster on the GPU is
    not measured yet. The key is deterministically derived from the solver's
    threefry key, so resume/replay stay exact; the stream differs from
    threefry's but any fixed stream is equally valid for exploration noise
    (parity tests inject ``noise`` explicitly and never hit this path).

    The 4-word rbg key comes from TWO independent threefry children (one
    split block) rather than duplicating the 2-word parent — duplicated
    halves correlate the rbg key words. Note (MIGRATION.md):
    jax documents rbg output as unstable across XLA versions/backends, so
    seeded streams are reproducible within an environment, not across
    releases.
    """
    if not jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.wrap_key_data(key)  # legacy raw (2,) uint32
    k1, k2 = jax.random.split(key)
    rbg = jax.random.wrap_key_data(
        jnp.concatenate(
            [jax.random.key_data(k1), jax.random.key_data(k2)]
        ).astype(jnp.uint32),
        impl="rbg",
    )
    return jax.random.normal(rbg, shape, dtype=dtype)


def sample_controls(
    key,
    u_prev: jax.Array,
    params: SolverParams,
    num_samples: int,
    steer_off: bool = False,
    noise: Optional[jax.Array] = None,
):
    """Draw K clamped-Gaussian control sequences.

    u_prev: (T-1, U) sampling mean. Returns (T-1, K, U).
    noise: optional pre-drawn standard normals of shape (T-1, K, U); used by
        the parity harness to inject identical noise into solver and oracle
        (the reference RNG is reseeded from random_device each cycle and
        cannot be reproduced any other way).
    """
    tm1, u_dim = u_prev.shape
    if noise is None:
        noise = draw_standard_normals(
            key, (tm1, num_samples, u_dim), u_prev.dtype
        )
    noise = color_noise(noise, params.noise_beta)
    u = u_prev[:, None, :] + noise * params.control_noise
    u = jnp.clip(u, params.u_min, params.u_max)
    if steer_off:
        u = u.at[..., STEER_DIM].set(0.0)
    return u
