"""Learned update rule for sampled MPC ("learning to optimize").

Implements the idea of PAPERS.md "Learning to Optimize in Model Predictive
Control" (arxiv 2212.02603): keep the sampling + rollout machinery of MPPI
and replace the HAND-DESIGNED softmax-weighted update (reference
calc_Weights/determine_OptimalSolution, src/diff_drive_mppi.cpp:212-246)
with a learned weighting of the sampled candidates, meta-trained end-to-end
through the differentiable rollouts to minimize the realized trajectory cost
after a fixed budget of solver iterations.

The learned rule strictly generalizes the classic update:

    z_k     = (cost_k - min cost) / lambda                (vanilla exponent)
    n_k     = (cost_k - min cost) / (mean - min + eps)    (scale-free feature)
    logit_k = -z_k + MLP([n_k, exp(-n_k)])
    w       = softmax(logit)
    u_opt   = clip(u_prev + gain * (sum_k w_k u_k - u_prev), bounds)

At identity initialization the MLP's output layer is zero and gain = 1, so
``w`` is exactly the MPPI softmax and the update is bit-identical to
``ops/softmax_update.py`` (asserted in tests/test_learned_optimizer.py).
Meta-training therefore starts FROM vanilla MPPI and only moves away where
it pays — e.g. sharpening or flattening the weight profile per cost scale,
or over/under-relaxing the step — and the rule stays permutation-equivariant
over samples (the MLP is applied pointwise per candidate).

Everything is plain jax + optax pytrees, shaped for matrix units: the per-sample
MLP is a (K, F) x (F, H) matmul, the update contraction a (K,) x (T-1, K, U)
einsum — identical compute pattern to the vanilla path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ccv_mppi_path_tracker_tpu.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu.core.random import next_cycle_key
from ccv_mppi_path_tracker_tpu.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu.models.registry import get_model
from ccv_mppi_path_tracker_tpu.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout
from ccv_mppi_path_tracker_tpu.ops.sampling import sample_controls
from ccv_mppi_path_tracker_tpu.paths.resample import PathBuffer, resample_reference


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
@dataclasses.dataclass
class UpdateRule:
    """Learned weighting/step parameters; identity-init == vanilla MPPI."""

    w1: jax.Array  # (F, H) per-sample feature MLP
    b1: jax.Array  # (H,)
    w2: jax.Array  # (H, 1) zero at init -> logit correction 0
    b2: jax.Array  # (1,)
    log_gain: jax.Array  # (U,) per-dim update relaxation, 0 at init -> gain 1

    NUM_FEATURES = 2

    @staticmethod
    def init_identity(key, u_dim: int, hidden: int = 16, dtype=jnp.float32):
        """Parameters that reproduce the classic MPPI update exactly."""
        k1 = key
        s1 = jnp.sqrt(2.0 / UpdateRule.NUM_FEATURES).astype(dtype)
        return UpdateRule(
            w1=jax.random.normal(k1, (UpdateRule.NUM_FEATURES, hidden), dtype) * s1,
            b1=jnp.zeros(hidden, dtype),
            w2=jnp.zeros((hidden, 1), dtype),
            b2=jnp.zeros(1, dtype),
            log_gain=jnp.zeros(u_dim, dtype),
        )

    def logit_correction(self, n):
        """Pointwise MLP over the scale-free cost feature n (K,) -> (K,)."""
        feats = jnp.stack([n, jnp.exp(-n)], axis=-1)  # (K, F)
        h = jnp.tanh(feats @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[..., 0]


def learned_weights(rule: UpdateRule, costs, lam, eps: float = 1e-6):
    """Per-sample weights from the learned rule; softmax(-z) at identity."""
    baseline = jnp.min(costs)
    centered = costs - baseline
    z = centered / lam
    n = centered / (jnp.mean(centered) + eps)
    logits = -z + rule.logit_correction(n)
    return jax.nn.softmax(logits)


def learned_update_step(
    cfg: SolverConfig,
    rule: UpdateRule,
    ctrl: ControllerState,
    state,
    path: PathBuffer,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    noise=None,
):
    """One control cycle with the learned update rule.

    Mirrors ``solver.mppi_step``'s XLA path (sample -> rollout -> cost) but
    the weighting and step size come from ``rule``. Returns
    (next ControllerState, StepResult); fully differentiable w.r.t. ``rule``.
    """
    model = get_model(cfg.model)
    if model_params is None:
        model_params = model.default_params
    carry_key, use_key = next_cycle_key(ctrl.key)

    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    u_samples = sample_controls(
        use_key, ctrl.u_prev, sp, cfg.num_samples, steer_off=cfg.steer_off,
        noise=noise,
    )
    state0 = jnp.broadcast_to(state, (cfg.num_samples,) + state.shape)
    states = rollout(model.step, state0, u_samples, dt)
    aux = {}
    if model.aux_from_rollout is not None:
        aux = model.aux_from_rollout(states, u_samples, dt, model_params)
    costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)

    weights = learned_weights(rule, costs, sp.lam)
    u_bar = jnp.einsum(
        "k,tku->tu", weights, u_samples, preferred_element_type=u_samples.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    gain = jnp.exp(rule.log_gain)
    u_opt = jnp.clip(
        ctrl.u_prev + gain * (u_bar - ctrl.u_prev), sp.u_min, sp.u_max
    )
    if cfg.steer_off:
        from ccv_mppi_path_tracker_tpu.ops.sampling import STEER_DIM

        u_opt = u_opt.at[:, STEER_DIM].set(0.0)

    opt_states = rollout(model.step, state, u_opt, dt)
    stats = {"min_cost": jnp.min(costs), "mean_cost": jnp.mean(costs),
             "ess": 1.0 / jnp.sum(weights * weights)}
    next_ctrl = ControllerState(u_prev=u_opt, key=carry_key, step=ctrl.step + 1)
    return next_ctrl, StepResult(
        u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
    )


def _random_poses(cfg, course, key, num, lateral_spread, yaw_spread):
    """Randomized start states near the course (same scheme as
    diff/learned_sampler.collect_imitation_data)."""
    model = get_model(cfg.model)
    pts = jnp.asarray(course, jnp.float32)

    def one(key):
        ka, kb, kc = jax.random.split(key, 3)
        i = jax.random.randint(ka, (), 0, len(course) - 2)
        base, nxt = pts[i], pts[i + 1]
        yaw0 = jnp.arctan2(nxt[1] - base[1], nxt[0] - base[0])
        state = jnp.zeros(model.num_states, jnp.float32)
        state = state.at[0].set(base[0])
        state = state.at[1].set(
            base[1] + lateral_spread * jax.random.normal(kb, (), state.dtype)
        )
        return state.at[2].set(
            yaw0 + yaw_spread * jax.random.normal(kc, (), state.dtype)
        )

    return jax.vmap(one)(jax.random.split(key, num))


def solved_cost(cfg, rule, state, path, dt, sp, cp, key,
                iterations: int = 2, noise=None):
    """Realized trajectory cost of the final update after ``iterations``
    solver cycles at a frozen state (cold start). ``rule=None`` runs the
    vanilla update (identity rule) for baselines. Differentiable in ``rule``.
    """
    from ccv_mppi_path_tracker_tpu.diff.gradients import make_trajectory_cost

    model = get_model(cfg.model)
    if rule is None:
        rule = UpdateRule.init_identity(jax.random.PRNGKey(0), model.num_controls)
    ctrl = ControllerState(
        u_prev=jnp.zeros((cfg.horizon - 1, model.num_controls), jnp.float32),
        key=key,
        step=jnp.zeros((), jnp.int32),
    )

    def body(ctrl, _):
        ctrl, _res = learned_update_step(
            cfg, rule, ctrl, state, path, dt, sp, cp, noise=noise
        )
        return ctrl, None

    ctrl, _ = jax.lax.scan(body, ctrl, None, length=iterations)
    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
    return make_trajectory_cost(cfg)(ctrl.u_prev, state, ref, dt, cp)


def meta_train(
    cfg: SolverConfig,
    sp: SolverParams,
    cp: CostParams,
    course,
    key,
    num_steps: int = 120,
    batch: int = 32,
    iterations: int = 2,
    dt: float = 0.1,
    hidden: int = 16,
    learning_rate: float = 3e-3,
    lateral_spread: float = 0.5,
    yaw_spread: float = 0.5,
):
    """Meta-train the update rule end-to-end through the rollouts.

    Loss = mean realized cost over a fresh batch of randomized start poses
    after ``iterations`` cold-start solver cycles. Gradients flow through
    sampling (reparameterized Gaussians), the rollout scan, the cost and
    the softmax — the full L2O objective. Returns (rule, losses).
    """
    model = get_model(cfg.model)
    path = PathBuffer.from_points(course, 0.1)
    dtj = jnp.float32(dt)
    k0, key = jax.random.split(key)
    rule = UpdateRule.init_identity(k0, model.num_controls, hidden)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(rule)

    def batch_loss(rule, key):
        kp, ks = jax.random.split(key)
        states = _random_poses(cfg, course, kp, batch, lateral_spread, yaw_spread)
        keys = jax.random.split(ks, batch)
        costs = jax.vmap(
            lambda s, k: solved_cost(cfg, rule, s, path, dtj, sp, cp, k,
                                     iterations=iterations)
        )(states, keys)
        return jnp.mean(costs)

    @jax.jit
    def train_step(rule, opt_state, key):
        loss, g = jax.value_and_grad(batch_loss)(rule, key)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(rule, updates), opt_state, loss

    losses = []
    for i in range(num_steps):
        key, kb = jax.random.split(key)
        rule, opt_state, loss = train_step(rule, opt_state, kb)
        losses.append(float(loss))
    return rule, np.asarray(losses)


def evaluate_rule(cfg, rule, sp, cp, course, key, num_states: int = 32,
                  iterations: int = 2, dt: float = 0.1,
                  lateral_spread: float = 0.5, yaw_spread: float = 0.5):
    """Mean realized cost over held-out randomized poses (rule=None: vanilla)."""
    path = PathBuffer.from_points(course, 0.1)
    dtj = jnp.float32(dt)
    kp, ks = jax.random.split(key)
    states = _random_poses(cfg, course, kp, num_states, lateral_spread, yaw_spread)
    keys = jax.random.split(ks, num_states)
    costs = jax.jit(jax.vmap(
        lambda s, k: solved_cost(cfg, rule, s, path, dtj, sp, cp, k,
                                 iterations=iterations)
    ))(states, keys)
    return float(jnp.mean(costs))
