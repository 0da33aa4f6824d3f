"""Differentiable MPPI: gradients through the rollout scan.

The reference has no differentiable path (plain C++ loops). Here the whole
pipeline — Euler scan, ZMP chain, min-distance cost — is differentiable, so:

- d(cost)/d(controls) flows through ``lax.scan`` for gradient-refined updates
  (sampled MPPI update followed by a few projected-gradient steps);
- d(cost)/d(dynamics params) enables system identification (diff/system_id.py).

The min-distance term uses a soft selection under gradient: ``jnp.minimum``
running-min is piecewise differentiable (subgradient at ties), which matches
what autodiff of the reference's scan-min would give.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from ccv_mppi_path_tracker_tpu.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu.core.types import RefWindow
from ccv_mppi_path_tracker_tpu.models.registry import get_model
from ccv_mppi_path_tracker_tpu.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu.ops.rollout import rollout


def make_trajectory_cost(cfg: SolverConfig):
    """Build a differentiable scalar cost of ONE control sequence.

    Returns ``cost(u_seq (T-1, U), state (S,), ref, dt, cp, model_params)``.
    Internally runs the batched pipeline with K=1 so the semantics are
    identical to the sampled solver's cost.
    """
    model = get_model(cfg.model)

    def cost_fn(u_seq, state, ref: RefWindow, dt, cp: CostParams, model_params=None):
        if model_params is None:
            model_params = model.default_params
        u = u_seq[:, None, :]  # (T-1, 1, U)
        states = rollout(model.step, state[None, :], u, dt)
        aux = {}
        if model.aux_from_rollout is not None:
            aux = model.aux_from_rollout(states, u, dt, model_params)
        return trajectory_costs(cfg.model, states, u, aux, ref, cp)[0]

    return cost_fn


def make_trajectory_residuals(cfg: SolverConfig):
    """Build the least-squares residual vector of ONE control sequence.

    The trajectory cost is a pure sum of squares (ops/costs.py):
    ``cost(u) == sum(residuals(u)**2)`` for every model family —
    path d(t), velocity error, [full body: zmp_y, roll-rate delta,
    min(v,0) backward term, initial-yaw error] — each scaled by the
    sqrt of its weight. This is the structure Gauss-Newton exploits
    (PAPERS.md: "Gauss-Newton accelerated MPPI Control").

    Returns ``residuals(u_seq (T-1, U), state, ref, dt, cp, model_params)
    -> (m,)``.
    """
    model = get_model(cfg.model)
    eps = 1e-12  # smooths sqrt(d^2) at d = 0

    def res_fn(u_seq, state, ref: RefWindow, dt, cp: CostParams,
               model_params=None):
        if model_params is None:
            model_params = model.default_params
        u = u_seq[:, None, :]
        states = rollout(model.step, state[None, :], u, dt)
        from ccv_mppi_path_tracker_tpu.ops.mindist import min_sq_distance

        if cfg.model == "full_body":
            aux = model.aux_from_rollout(states, u, dt, model_params)
            tm2 = states.shape[0] - 2
            d = jnp.sqrt(min_sq_distance(states[:tm2, ..., :2], ref.xy)[:, 0]
                         + eps)
            v = u_seq[:tm2, 0]
            zmp_y = aux["zmp"][..., 1][:, 0]
            roll_v = u_seq[:, 3]
            droll_v = roll_v[1:tm2 + 1] - roll_v[:tm2]
            back = jnp.minimum(v, 0.0)
            dyaw0 = states[0, 0, 2] - ref.yaw[0]
            return jnp.concatenate([
                jnp.sqrt(cp.path_weight) * d,
                jnp.sqrt(cp.v_weight) * (v - cp.v_ref),
                jnp.sqrt(cp.zmp_weight) * zmp_y,
                jnp.sqrt(cp.roll_v_weight) * droll_v,
                jnp.sqrt(cp.back_weight) * back,
                jnp.sqrt(cp.yaw_weight) * dyaw0[None],
            ])
        d = jnp.sqrt(min_sq_distance(states[..., :2], ref.xy)[:, 0] + eps)
        v = u_seq[:, 0]
        return jnp.concatenate([
            jnp.sqrt(cp.path_weight) * d,
            jnp.sqrt(cp.v_weight) * (v - cp.v_ref),
        ])

    return res_fn


def gauss_newton_refine(
    cfg: SolverConfig,
    u_opt,
    state,
    ref: RefWindow,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    num_steps: int = 3,
    damping: float = 1e-3,
):
    """Polish the sampled update with damped Gauss-Newton steps.

    Exploits the least-squares structure of the trajectory cost: solve
    ``(J^T J + damping*I) delta = J^T r`` with J = d(residuals)/d(u) via
    ``jacfwd`` through the rollout scan, then project to the control box.
    Steps are Levenberg-Marquardt guarded — a step that raises the cost is
    rejected and the damping increased, so refinement never degrades the
    sampled update on the nonconvex tracking cost. Quadratic cost terms
    converge in one step where first-order refinement needs many
    (PAPERS.md: "Gauss-Newton accelerated MPPI Control").
    """
    res_fn = make_trajectory_residuals(cfg)
    f = lambda u: res_fn(u, state, ref, dt, cp, model_params)
    n = u_opt.size
    eye = jnp.eye(n, dtype=u_opt.dtype)

    def body(_, carry):
        u, lam_damp, cost = carry
        r = f(u)
        jac = jax.jacfwd(f)(u).reshape(r.shape[0], n)
        # f32 products on the GPU default to TF32; keep full precision
        hi = jax.lax.Precision.HIGHEST
        g = jnp.matmul(jac.T, r, precision=hi)
        hess = jnp.matmul(jac.T, jac, precision=hi) + lam_damp * eye
        delta = jnp.linalg.solve(hess, g)
        u_new = jnp.clip(u - delta.reshape(u.shape), sp.u_min, sp.u_max)
        r_new = f(u_new)
        cost_new = jnp.sum(r_new * r_new)
        accept = cost_new < cost
        u = jnp.where(accept, u_new, u)
        cost = jnp.where(accept, cost_new, cost)
        lam_damp = jnp.where(accept, lam_damp * 0.5, lam_damp * 10.0)
        return u, lam_damp, cost

    r0 = f(u_opt)
    init = (u_opt, jnp.asarray(damping, u_opt.dtype), jnp.sum(r0 * r0))
    u, _, _ = jax.lax.fori_loop(0, num_steps, body, init)
    return u


def gradient_refine(
    cfg: SolverConfig,
    u_opt,
    state,
    ref: RefWindow,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    step_size: float = 0.05,
    num_steps: int = 5,
):
    """Polish the sampled MPPI update with projected gradient descent.

    u <- clip(u - step_size * dJ/du, bounds); the projection is the same box
    clamp as sampling. A few steps typically reduce the realized tracking
    cost beyond what K samples alone achieve (gradient-smoothed MPPI).
    """
    cost_fn = make_trajectory_cost(cfg)
    grad_fn = jax.grad(lambda u: cost_fn(u, state, ref, dt, cp, model_params))

    def body(_, u):
        g = grad_fn(u)
        return jnp.clip(u - step_size * g, sp.u_min, sp.u_max)

    return jax.lax.fori_loop(0, num_steps, body, u_opt)
