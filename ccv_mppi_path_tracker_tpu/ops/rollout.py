"""Batched trajectory rollout.

``lax.scan`` over the horizon with all K samples advanced per step — the
vectorized form of the reference's per-sample Euler loop
(src/diff_drive_mppi.cpp:111-124). The scan is sequential by physics (state
t+1 depends on state t); parallelism lives in the K batch axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rollout(step_fn, state0: jax.Array, controls: jax.Array, dt,
            unroll: int | bool | None = None):
    """Integrate ``controls`` from ``state0``.

    step_fn: batched model step (state, u, dt) -> state.
    state0: (..., S) initial state (broadcast across K happens in the caller).
    controls: (T-1, ..., U) time-major control sequences.
    Returns states (T, ..., S) including the initial state at index 0.

    unroll: forwarded to ``lax.scan``. Defaults to FULL unroll for a single
    trajectory (state0 is (S,)) — the optimal-sequence re-roll is T tiny
    scalar fusions that cost more in per-kernel launch overhead than in
    flops, so XLA should see straight-line code — and no unroll for batched
    (K, S) rollouts, where each step is already a big fused kernel.
    """
    if unroll is None:
        unroll = state0.ndim == 1

    def f(s, u):
        s_next = step_fn(s, u, dt)
        return s_next, s_next

    _, traj = jax.lax.scan(f, state0, controls, unroll=unroll)
    return jnp.concatenate([state0[None], traj], axis=0)


# Models whose Euler chain collapses to prefix sums. rate_limited_steering
# clips the steering STATE each step — that sub-chain stays a (cheap, (K,)-
# wide) sequential scan — but its position/yaw integrals are still prefix
# sums given the steering sequence, so it gets the hybrid closed form.
CLOSED_FORM_MODELS = (
    "unicycle", "steering_unicycle", "full_body", "rate_limited_steering"
)


def steer_limits(model_name: str):
    """(steer_max, rate_max) for a rate-limited steering variant, resolved
    from the REGISTERED model's constants — not the module defaults — so a
    custom-limit variant re-registered under the same name keeps the
    closed-form rollout and fused kernel in agreement with its own step
    function."""
    from ccv_mppi_path_tracker_tpu.models.rate_limited_steering import (
        RATE_MAX,
        STEER_MAX,
    )
    from ccv_mppi_path_tracker_tpu.models.registry import get_model

    consts = get_model(model_name).constants or {}
    return consts.get("steer_max", STEER_MAX), consts.get("rate_max", RATE_MAX)


def _steer_sequence(model_name, steer0, rates, dt):
    """(T-1, ...) commanded rates -> (T-1, ...) steering angles used by the
    position integral at steps 0..T-2 (the CURRENT angle integrates each
    step, models/rate_limited_steering.py), plus the final angle."""
    steer_max, rate_max = steer_limits(model_name)

    def body(s, rate):
        nxt = jnp.clip(
            s + jnp.clip(rate, -rate_max, rate_max) * dt,
            -steer_max, steer_max,
        )
        return nxt, s  # emit the angle BEFORE this step's slew

    last, used = jax.lax.scan(body, steer0, rates)
    return used, last


def rollout_closed_form(model_name: str, state0: jax.Array,
                        controls: jax.Array, dt):
    """Scan-free rollout via cumulative sums — same recurrence, parallel form.

    The Euler chains of the unicycle/steering/full-body models are affine in
    running integrals: yaw_t = yaw_0 + dt * sum_{s<t} w_s (independent of
    x, y), heading_t = yaw_t (+ steer_t from the controls), then
    x_t = x_0 + dt * sum_{s<t} v_s cos(heading_s) and likewise y; roll/pitch
    are plain control integrals. Replacing the T-step sequential scan with
    cumsums turns the single-trajectory optimal-sequence re-roll from ~T
    dependent micro-fusions into one parallel fusion.

    Float caveat: XLA's cumsum may associate differently than left-to-right
    scan, so results agree with :func:`rollout` to round-off (~1e-6 f32 rel),
    not bitwise — fine for the planned-path output, which no parity oracle
    consumes (tests/test_ops.py checks agreement).

    state0: (..., S); controls: (T-1, ..., U) time-major. Returns (T, ..., S).
    """
    assert model_name in CLOSED_FORM_MODELS, model_name
    v, w = controls[..., 0], controls[..., 1]
    batched = state0.ndim > 1
    if batched:
        # prefix sums as one lower-triangular (T-1, T-1) matmul (max |diff|
        # vs cumsum ~3e-7 f32). HIGHEST precision keeps f32 operands at f32
        # accuracy (no TF32 on the GPU). Whether cumsum or an associative
        # scan is faster on the GPU is not measured yet. The
        # single-trajectory re-roll keeps the cumsum — a (T,T) matmul over
        # one column is all launch overhead.
        tri = jnp.tril(jnp.ones((controls.shape[0],) * 2, controls.dtype))

    def integrate(rate):
        # (T-1, ...) rates -> (T, ...) running integral starting at 0
        if batched:
            run = jnp.einsum(
                "st,t...->s...", tri, rate,
                precision=jax.lax.Precision.HIGHEST,
            ) * dt
        else:
            run = jnp.cumsum(rate, axis=0) * dt
        zero = jnp.zeros_like(run[:1])
        return jnp.concatenate([zero, run], axis=0)

    yaw = state0[..., 2] + integrate(w)  # (T, ...)
    heading = yaw[:-1]
    steer_col = None
    if model_name == "rate_limited_steering":
        # hybrid: the clipped steering chain is sequential but only (K,)-
        # wide; positions are still prefix sums given the angle sequence
        steer_used, steer_last = _steer_sequence(
            model_name, state0[..., 3], controls[..., 2], dt
        )
        heading = heading + steer_used
        steer_col = jnp.concatenate([steer_used, steer_last[None]], axis=0)
    elif model_name != "unicycle":
        heading = heading + controls[..., 2]
    x = state0[..., 0] + integrate(v * jnp.cos(heading))
    y = state0[..., 1] + integrate(v * jnp.sin(heading))
    cols = [x, y, yaw]
    if steer_col is not None:
        cols.append(steer_col)
    if model_name == "full_body":
        cols.append(state0[..., 3] + integrate(controls[..., 3]))
        cols.append(state0[..., 4] + integrate(controls[..., 4]))
    return jnp.stack(cols, axis=-1)
