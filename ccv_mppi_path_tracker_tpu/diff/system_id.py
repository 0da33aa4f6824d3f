"""Dynamics-parameter system identification by backprop through rollouts.

Given observed transitions from a real/simulated plant, fit differentiable
dynamics parameters by gradient descent on one-step (or multi-step) state
prediction error. Two parameterizations:

- :class:`ControlGains` — per-channel actuator gains applied to the commanded
  controls (models droop/scaling miscalibration of the kinematic models);
- :class:`FullBodyParams` fitting (mass / CoM height) against observed ZMP.

Both losses are data-parallel: under a mesh the per-shard gradient is psum'd
(``axis_name``), the pattern the dry-run multichip entry exercises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ccv_mppi_path_tracker_tpu.models.full_body import FullBodyParams, zmp_chain
from ccv_mppi_path_tracker_tpu.models.registry import get_model


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
@dataclasses.dataclass
class ControlGains:
    gains: jax.Array  # (U,)


def gained_step(model_name: str):
    """Model step with learnable control gains: u_eff = gains * u."""
    step = get_model(model_name).step

    def f(params: ControlGains, state, u, dt):
        return step(state, u * params.gains, dt)

    return f


def prediction_loss(model_name, params, states_t, controls_t, states_t1, dt,
                    axis_name: Optional[str] = None):
    """Mean one-step prediction error over a batch of observed transitions."""
    pred = gained_step(model_name)(params, states_t, controls_t, dt)
    err = pred - states_t1
    loss = jnp.mean(jnp.sum(err * err, axis=-1))
    if axis_name is not None:
        loss = jax.lax.pmean(loss, axis_name)
    return loss


def fit_control_gains(
    model_name: str,
    states_t,
    controls_t,
    states_t1,
    dt,
    num_steps: int = 300,
    learning_rate: float = 0.1,
    axis_name: Optional[str] = None,
    init: Optional[ControlGains] = None,
):
    """Recover per-channel control gains from observed transitions."""
    u_dim = controls_t.shape[-1]
    if init is None:
        init = ControlGains(gains=jnp.ones((u_dim,), states_t.dtype))
    opt = optax.adam(learning_rate)

    def step(carry, _):
        params, opt_state = carry
        loss, g = jax.value_and_grad(
            lambda p: prediction_loss(
                model_name, p, states_t, controls_t, states_t1, dt, axis_name
            )
        )(params)
        if axis_name is not None:
            # data-parallel gradient all-reduce (the MPPI "training" collective)
            g = jax.lax.pmean(g, axis_name)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    (params, _), losses = jax.lax.scan(
        step, (init, opt.init(init)), None, length=num_steps
    )
    return params, losses


def rollout_prediction_loss(model_name, params, state0, controls, observed,
                            dt, axis_name: Optional[str] = None):
    """Multi-step prediction error: roll the gained model from ``state0``
    (B, S) under ``controls`` (T-1, B, U) and MSE against the observed
    trajectory ``observed`` (T-1, B, S). Backprop runs through the whole
    T-step scan — the heavy-backward workload of the system-ID path."""
    step = gained_step(model_name)

    def body(s, u):
        s1 = step(params, s, u, dt)
        return s1, s1

    _, pred = jax.lax.scan(body, state0, controls)
    err = pred - observed
    loss = jnp.mean(jnp.sum(err * err, axis=-1))
    if axis_name is not None:
        loss = jax.lax.pmean(loss, axis_name)
    return loss


def rollout_prediction_value_and_grad(
    model_name,
    params,
    state0,
    controls,
    observed,
    dt,
    axis_name: Optional[str] = None,
    num_chunks: int = 1,
):
    """Loss + parameter gradient of :func:`rollout_prediction_loss` over a
    (possibly shard_map'ed) batch, with the cross-shard all-reduce
    optionally OVERLAPPED with backward compute.

    num_chunks=1 is the sequential baseline: one backward over the whole
    local batch, then one blocking ``psum`` of the finished gradient —
    collective strictly after all compute. num_chunks=C splits the local
    batch into C equal buckets and issues each bucket's gradient psum right
    after that bucket's backward, so XLA's scheduler can run bucket i's
    collective while bucket i+1's forward+backward computes — the bucketed
    DP all-reduce (SURVEY.md section 2.5/section 5: "gradient all-reduce
    overlapped with backward"). The math is identical up to FP
    re-association of the equal-size bucket sums (measured bit-tight at
    f64: tests/test_multiprocess.py).
    """
    b_local = state0.shape[0]
    assert b_local % num_chunks == 0, (b_local, num_chunks)
    csz = b_local // num_chunks
    n_shards = 1
    # accumulators are built from the ORIGINAL (replicated) params so they
    # keep the replicated vma; the psum'd per-chunk terms folded into them
    # are replicated too
    loss = jnp.zeros((), state0.dtype)
    grad = jax.tree.map(jnp.zeros_like, params)
    if axis_name is not None:
        n_shards = jax.lax.axis_size(axis_name)
        # differentiate w.r.t. a device-VARYING copy of the params: grad of
        # a replicated input would be auto-psum'd by the pvary transpose,
        # hiding the collective we want to place (and double-counting it
        # once we psum explicitly below)
        params = jax.lax.pcast(params, axis_name, to="varying")

    def chunk_loss(p, sl):
        # per-chunk SUM of squared errors (not mean): exact bucket algebra
        step = gained_step(model_name)

        def body(s, u):
            s1 = step(p, s, u, dt)
            return s1, s1

        _, pred = jax.lax.scan(body, state0[sl], controls[:, sl])
        err = pred - observed[:, sl]
        return jnp.sum(err * err)

    for i in range(num_chunks):  # unrolled: buckets are independent until +=
        sl = slice(i * csz, (i + 1) * csz)
        l_i, g_i = jax.value_and_grad(chunk_loss)(params, sl)
        if axis_name is not None:
            # per-bucket all-reduce, issued as soon as this bucket's
            # backward finishes; buckets i+1..C-1 have no data dependency
            # on it, so their compute can hide the collective's latency
            l_i = jax.lax.psum(l_i, axis_name)
            g_i = jax.lax.psum(g_i, axis_name)
        loss = loss + l_i
        grad = jax.tree.map(jnp.add, grad, g_i)
    denom = controls.shape[0] * b_local * n_shards
    scale = 1.0 / denom
    return loss * scale, jax.tree.map(lambda g: g * scale, grad)


def zmp_loss(params: FullBodyParams, states, controls, observed_zmp_y, dt,
             axis_name: Optional[str] = None):
    """MSE of predicted vs observed lateral ZMP over rollouts.

    states (T, B, 5), controls (T-1, B, 5), observed_zmp_y (T-2, B).
    """
    zmp = zmp_chain(states, controls, dt, params)
    err = zmp[..., 1] - observed_zmp_y
    loss = jnp.mean(err * err)
    if axis_name is not None:
        loss = jax.lax.pmean(loss, axis_name)
    return loss


def fit_full_body_params(
    states,
    controls,
    observed_zmp_y,
    dt,
    init: FullBodyParams,
    num_steps: int = 300,
    learning_rate: float = 0.02,
    axis_name: Optional[str] = None,
):
    """Fit (mass, base2com) of the ZMP model; inertia/gravity held fixed."""
    opt = optax.adam(learning_rate)
    trainable = ("mass", "base2com")

    def mask_grad(g: FullBodyParams) -> FullBodyParams:
        return FullBodyParams(
            mass=g.mass,
            base2com=g.base2com,
            inertia=jnp.zeros_like(g.inertia),
            gravity_z=jnp.zeros_like(g.gravity_z),
        )

    def step(carry, _):
        params, opt_state = carry
        loss, g = jax.value_and_grad(
            lambda p: zmp_loss(p, states, controls, observed_zmp_y, dt, axis_name)
        )(params)
        g = mask_grad(g)
        if axis_name is not None:
            g = jax.lax.pmean(g, axis_name)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    (params, _), losses = jax.lax.scan(
        step, (init, opt.init(init)), None, length=num_steps
    )
    return params, losses
