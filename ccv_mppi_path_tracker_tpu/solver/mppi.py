"""The MPPI control step.

One pure function fuses the reference's per-cycle sequence
sampling -> predict_States -> calc_Weights -> determine_OptimalSolution
(run loop, src/diff_drive_mppi.cpp:332-369) into a single jitted program:

    sample K Gaussian sequences around the warm start   (ops/sampling.py)
    scan-rollout all K trajectories                     (ops/rollout.py)
    [full body] vectorized ZMP chain                    (models/full_body.py)
    per-trajectory tracking cost                        (ops/costs.py)
    min-baseline softmax weights                        (ops/softmax_update.py)
    importance-weighted control update                  (ops/softmax_update.py)

Everything stays device-resident; the host only feeds (pose, dt) and reads
u[0]. ``dt`` is a traced scalar, mirroring the reference's wall-clock-measured
dt (src/diff_drive_mppi.cpp:346-348) without triggering recompiles. The same
function body serves single-device jit and shard_map over a "samples" mesh
axis (``axis_name`` switches the reductions to collectives).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ccv_mppi_path_tracker_tpu.core.config import CostParams, SolverConfig, SolverParams
from ccv_mppi_path_tracker_tpu.core.random import next_cycle_key, shard_key
from ccv_mppi_path_tracker_tpu.core.types import ControllerState, StepResult
from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import (
    combine_partials,
    fused_sample_rollout_cost,
    pack_scalars,
    should_use_kernel,
)
from ccv_mppi_path_tracker_tpu.models.registry import get_model
from ccv_mppi_path_tracker_tpu.ops.costs import trajectory_costs
from ccv_mppi_path_tracker_tpu.ops.rollout import (
    CLOSED_FORM_MODELS,
    rollout,
    rollout_closed_form,
)
from ccv_mppi_path_tracker_tpu.ops.sampling import sample_controls
from ccv_mppi_path_tracker_tpu.ops.softmax_update import (
    softmax_weights,
    weighted_update,
)
from ccv_mppi_path_tracker_tpu.paths.resample import PathBuffer, resample_reference


def mppi_step(
    cfg: SolverConfig,
    ctrl: ControllerState,
    state,
    path: PathBuffer,
    dt,
    sp: SolverParams,
    cp: CostParams,
    model_params=None,
    noise=None,
    axis_name: Optional[str] = None,
    num_samples: Optional[int] = None,
    use_kernel: bool = False,
    kernel_interpret: bool = False,
    refine_steps: int = 0,
    refine_step_size: float = 0.02,
    refine_method: str = "gradient",
    debug_candidates: int = 0,
    adapt_sigma: bool = False,
    shift_warm_start: bool = False,
    delay: Optional[float] = None,
    elite_frac: Optional[float] = None,
    elite_stale_thresh=None,
    lean: bool = False,
):
    """Run one MPPI control cycle. Returns (next ControllerState, StepResult).

    cfg: static structure (model, K, T). num_samples overrides cfg.num_samples
        for the per-shard K under shard_map.
    state: (S,) current measured state.
    noise: optional injected standard normals (T-1, K, U) for parity tests.
    axis_name: mesh axis for sample-sharded execution.
    use_kernel: run sample+rollout+cost+update as the fused Pallas kernel
        (kernels/rollout_cost.py) instead of the XLA pipeline. float32 only;
        any K (the kernel pads to whole blocks and gives the tail no
        weight). With ``noise=None`` the kernel draws its own (different but
        deterministic) stream. The kernel is compiled for the GPU only:
        elsewhere it raises unless ``kernel_interpret=True`` asks for the
        Pallas interpreter (tests).
    refine_steps: gradient-smoothed MPPI — polish the sampled update with
        this many refinement steps through the rollout (diff/gradients.py)
        before actuation. 0 = classic sampled MPPI. refine_method selects
        projected gradient descent ("gradient") or Levenberg-Marquardt
        guarded Gauss-Newton on the least-squares cost structure
        ("gauss_newton"; PAPERS.md).
    debug_candidates: include the first N candidate rollout xy paths in
        stats["candidates"] (N, T, 2) — the framework's equivalent of the
        reference's candidate-path MarkerArray debug topic
        (src/diff_drive_mppi.cpp:265-294). XLA path only.
    adapt_sigma: also compute stats["sigma_suggest"] (U,) — the per-dim std
        of the softmax-weighted sample distribution around the update,
        averaged over the horizon. Feed it back into
        SolverParams.control_noise for covariance-adaptive importance
        sampling (PAPERS.md: "MPPI using Covariance Variable Importance
        Sampling"; see runtime/loop.py ControlLoop.sigma_adapt). Off by
        default: reference semantics keep sigma fixed.
    shift_warm_start: center sampling on the ONE-STEP-SHIFTED previous
        optimal sequence (last control repeated) instead of the unshifted
        warm start. Standard receding-horizon MPPI practice; the reference
        deliberately does NOT shift (src/diff_drive_mppi.cpp:89-90), so this
        defaults off for parity. Works on both the XLA and kernel paths (the
        shift happens to the sampling mean before either).
    delay: actuation-latency compensation, in seconds. Euler-predicts the
        measured state forward by ``delay`` under the command currently in
        flight (ctrl.u_prev[0]) before solving, so the plan starts where the
        plant will be when u0 actually takes effect. None (default) = the
        reference's solve-from-measured-state semantics.
    elite_frac: keep softmax weight only on the best ``elite_frac`` fraction
        of samples by global cost rank (weights of the rest set to zero
        before normalizing) — the CEM<->MPPI interpolation; elite_frac=1.0
        is exactly vanilla MPPI. Works on every path: sharded (the rank
        threshold radix select spans all shards via exact psum counts,
        ops/softmax_update.py elite_threshold) and fused-kernel (a second
        kernel pass re-accumulates the update with the sub-threshold mask;
        the counter-based RNG regenerates identical samples).
    elite_stale_thresh: SINGLE-PASS elite mode (opt-in, a behavioral
        extension — defaults off per the reference-semantics contract):
        a traced scalar cost threshold at which THIS cycle's weights are
        masked, normally the previous cycle's exact rank threshold
        (stats["elite_thresh"], which always reports the current costs'
        exact ``elite_frac`` threshold for feeding back). Pass +inf for an
        unmasked first cycle. Cuts the elite kernel flow from two passes +
        select to one pass + select at the price of a one-cycle-stale elite
        set — in closed loop the cost distribution moves slowly, so the
        masked fraction tracks elite_frac closely. Requires elite_frac
        (used to compute the threshold reported for the next cycle).
        ``build_simulate_scan(solver_options={"elite_frac": f,
        "elite_stale": True})`` threads it through the scan carry.
    lean: serving mode — return a StepResult carrying only the actuation
        outputs (u_opt, u0; ref/opt_states None, stats empty except
        sigma_suggest when adapt_sigma). u_opt/u0 are bit-identical to the
        full result; only diagnostics are dropped (fewer output buffers and
        no planned-path re-roll per cycle). Incompatible with
        debug_candidates.
    """
    assert not (lean and debug_candidates), "lean drops debug outputs"
    model = get_model(cfg.model)
    if model_params is None:
        model_params = model.default_params
    k_local = num_samples if num_samples is not None else cfg.num_samples

    carry_key, use_key = next_cycle_key(ctrl.key)
    if axis_name is not None:
        use_key = shard_key(use_key, axis_name)

    if delay is not None:
        # Predict forward under the command currently in flight so the plan
        # starts where the plant will be when u0 takes effect.
        state = model.step(state, ctrl.u_prev[0], jnp.asarray(delay, state.dtype))
    u_mean = ctrl.u_prev
    if shift_warm_start:
        u_mean = jnp.concatenate([ctrl.u_prev[1:], ctrl.u_prev[-1:]], axis=0)

    ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)

    assert elite_stale_thresh is None or elite_frac is not None, (
        "elite_stale_thresh requires elite_frac (for the next threshold)"
    )
    if use_kernel:
        kernel = functools.partial(
            _kernel_sample_rollout_cost, cfg, u_mean, state, ref, dt, sp, cp,
            model_params, use_key, noise, k_local, kernel_interpret,
            axis_name, second_moment=adapt_sigma,
        )
        costs, partials = kernel(
            # with (two-pass) elite_frac this first pass only finds the
            # threshold, so it skips the update; the stale-threshold
            # single-pass mode accumulates here, masked at the stale
            # threshold
            accumulate=elite_frac is None or elite_stale_thresh is not None,
            cost_thresh=elite_stale_thresh,
        )
        _, stats = softmax_weights(
            costs, sp.lam, axis_name=axis_name, elite_frac=elite_frac,
            elite_thresh=elite_stale_thresh,
        )
        if elite_frac is not None and elite_stale_thresh is None:
            # Second pass over the same samples (same counters / same
            # injected noise), accumulating only the elites. Pass 1's costs
            # come back in, so this pass skips the rollout entirely.
            _, partials = kernel(cost_thresh=stats["elite_thresh"],
                                 costs_in=costs)
        # Each block accumulated under its own min cost; rescale to the
        # global (pmin under sample sharding) baseline, then sum.
        u_num, u2_num, norm = combine_partials(
            partials, stats["min_cost"], sp.lam, cfg.horizon,
            ctrl.u_prev.shape[1], second_moment=adapt_sigma,
        )
        if axis_name is not None:
            u_num = jax.lax.psum(u_num, axis_name)
            norm = jax.lax.psum(norm, axis_name)
            if adapt_sigma:
                u2_num = jax.lax.psum(u2_num, axis_name)
        if elite_stale_thresh is not None:
            # A STALE threshold can mask every sample (cost distribution
            # jumped since last cycle: disturbance, state reset, course
            # swap). 0/0 here would write NaN into u_prev and poison every
            # later cycle — hold the sampling center instead (an
            # information-free cycle keeps the previous plan) and report it.
            # The exact two-pass flow cannot hit this (its threshold is the
            # current costs' rank statistic), so this guard is scoped to
            # the stale mode and the production graphs are untouched.
            empty = norm <= 0.0
            stats["elite_stale_empty"] = empty
            u_opt = jnp.where(
                empty, u_mean, u_num / jnp.where(empty, 1.0, norm)
            )
        else:
            u_opt = u_num / norm
        if adapt_sigma:
            safe_norm = norm
            if elite_stale_thresh is not None:
                # empty stale cycle: suggest the configured sigma (no
                # information) instead of a NaN that would poison the
                # sigma-adaptation feedback
                safe_norm = jnp.where(norm <= 0.0, 1.0, norm)
            sig = _sigma_suggest(u2_num / safe_norm, u_opt)
            if elite_stale_thresh is not None:
                sig = jnp.where(norm <= 0.0, sp.control_noise, sig)
            stats["sigma_suggest"] = sig
        u_opt = _maybe_refine(
            cfg, u_opt, state, ref, dt, sp, cp, model_params,
            refine_steps, refine_step_size, refine_method,
        )
        next_ctrl = ControllerState(u_prev=u_opt, key=carry_key, step=ctrl.step + 1)
        if lean:
            return next_ctrl, _lean_result(u_opt, stats, adapt_sigma)
        opt_states = _opt_rollout(cfg.model, model, state, u_opt, dt)
        return next_ctrl, StepResult(
            u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
        )

    u_samples = sample_controls(
        use_key, u_mean, sp, k_local, steer_off=cfg.steer_off, noise=noise
    )

    state0 = jnp.broadcast_to(state, (k_local,) + state.shape)
    if axis_name is not None:
        # Under shard_map the per-shard rollout carry is device-varying
        # (each shard rolls its own K/N samples); mark the replicated start
        # state accordingly so the scan carry types line up.
        state0 = jax.lax.pcast(state0, axis_name, to="varying")
    if cfg.model in CLOSED_FORM_MODELS:
        # scan-free prefix-sum rollout: removes T-1 sequential (K, S)
        # fusions from the critical path (agrees with the scan to round-off;
        # tests/test_ops.py, parity suite at rtol 1e-9 f64)
        states = rollout_closed_form(cfg.model, state0, u_samples, dt)
    else:
        states = rollout(model.step, state0, u_samples, dt)  # (T, K, S)

    aux = {}
    if model.aux_from_rollout is not None:
        aux = model.aux_from_rollout(states, u_samples, dt, model_params)

    costs = trajectory_costs(cfg.model, states, u_samples, aux, ref, cp)
    weights, stats = softmax_weights(
        costs, sp.lam, axis_name=axis_name, elite_frac=elite_frac,
        elite_thresh=elite_stale_thresh,
    )
    if debug_candidates:
        stats["candidates"] = jnp.transpose(
            states[:, :debug_candidates, :2], (1, 0, 2)
        )
    u_opt = weighted_update(weights, u_samples, axis_name=axis_name)
    if elite_stale_thresh is not None:
        # empty stale cycle (every sample masked): hold the sampling
        # center instead of the all-zero-weights average (see the kernel
        # branch's guard above)
        u_opt = jnp.where(stats["elite_stale_empty"], u_mean, u_opt)
    if adapt_sigma:
        m2 = weighted_update(weights, u_samples * u_samples, axis_name=axis_name)
        sig = _sigma_suggest(m2, u_opt)
        if elite_stale_thresh is not None:
            sig = jnp.where(stats["elite_stale_empty"], sp.control_noise, sig)
        stats["sigma_suggest"] = sig
    u_opt = _maybe_refine(
        cfg, u_opt, state, ref, dt, sp, cp, model_params,
        refine_steps, refine_step_size, refine_method,
    )

    next_ctrl = ControllerState(u_prev=u_opt, key=carry_key, step=ctrl.step + 1)
    if lean:
        return next_ctrl, _lean_result(u_opt, stats, adapt_sigma)
    opt_states = _opt_rollout(cfg.model, model, state, u_opt, dt)  # (T, S)
    result = StepResult(
        u_opt=u_opt, u0=u_opt[0], ref=ref, opt_states=opt_states, stats=stats
    )
    return next_ctrl, result


def _lean_result(u_opt, stats, adapt_sigma):
    """Serving-mode StepResult: actuation outputs only (see ``lean``) —
    plus the feedback scalars a serving loop must thread into the next
    cycle (adaptive sigma; the stale-elite threshold)."""
    keep = {}
    if adapt_sigma:
        keep["sigma_suggest"] = stats["sigma_suggest"]
    if "elite_thresh" in stats:
        keep["elite_thresh"] = stats["elite_thresh"]
    return StepResult(
        u_opt=u_opt, u0=u_opt[0], ref=None, opt_states=None, stats=keep
    )


def _opt_rollout(model_name, model, state, u_opt, dt):
    """Planned-path re-roll of the optimal sequence (the reference's
    publish_OptimalPath re-roll, src/diff_drive_mppi.cpp:295-312). Uses the
    scan-free cumsum form where the model admits one — the sequential T-step
    micro-fusion chain was the largest non-kernel term in the flagship step
    (artifacts/profile_step.json)."""
    if model_name in CLOSED_FORM_MODELS:
        return rollout_closed_form(model_name, state, u_opt, dt)
    return rollout(model.step, state, u_opt, dt)


def _sigma_suggest(m2, u_opt):
    """Per-dim std of the weighted sample distribution, averaged over t."""
    var = jnp.maximum(m2 - u_opt * u_opt, 0.0)
    return jnp.sqrt(jnp.mean(var, axis=0))


def _maybe_refine(cfg, u_opt, state, ref, dt, sp, cp, model_params,
                  refine_steps, refine_step_size, refine_method="gradient"):
    if not refine_steps:
        return u_opt
    from ccv_mppi_path_tracker_tpu.diff.gradients import (
        gauss_newton_refine,
        gradient_refine,
    )
    from ccv_mppi_path_tracker_tpu.ops.sampling import STEER_DIM

    if refine_method == "gauss_newton":
        u_opt = gauss_newton_refine(
            cfg, u_opt, state, ref, dt, sp, cp, model_params=model_params,
            num_steps=refine_steps,
        )
    else:
        u_opt = gradient_refine(
            cfg, u_opt, state, ref, dt, sp, cp, model_params=model_params,
            step_size=refine_step_size, num_steps=refine_steps,
        )
    if cfg.steer_off:
        # the gradient has no reason to keep the disabled channel at zero
        u_opt = u_opt.at[:, STEER_DIM].set(0.0)
    return u_opt


def _kernel_sample_rollout_cost(
    cfg, u_mean, state, ref, dt, sp, cp, model_params, use_key, noise, k_local,
    kernel_interpret, axis_name=None, second_moment=False, cost_thresh=None,
    accumulate=True, costs_in=None,
):
    """Bridge the fused kernel into the step: returns (costs or None,
    per-block partials or None) — see fused_sample_rollout_cost."""
    if not kernel_interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "use_kernel=True needs a GPU: the fused kernel is compiled only "
            f"for the GPU, and the default backend is "
            f"{jax.default_backend()!r}. Pass kernel_interpret=True to run "
            "it in the Pallas interpreter (tests), or use the XLA pipeline."
        )
    mp = model_params if cfg.model == "full_body" else None
    scal = pack_scalars(dt, cp, ref.yaw[0], mp, noise_beta=sp.noise_beta,
                        lam=sp.lam, cost_thresh=cost_thresh)
    seed = jax.random.bits(use_key, (), jnp.uint32)
    return fused_sample_rollout_cost(
        u_mean,
        sp.control_noise,
        sp.u_min,
        sp.u_max,
        ref.xy,
        state,
        scal,
        seed,
        num_samples=k_local,
        model=cfg.model,
        steer_off=cfg.steer_off,
        noise=noise,
        interpret=bool(kernel_interpret),
        vma_axis=axis_name,
        second_moment=second_moment,
        accumulate=accumulate,
        costs_in=costs_in,
    )


class MPPISolver:
    """Convenience wrapper owning the jitted step for one configuration.

    Replaces the reference controller node classes (DiffDriveMPPI etc.) minus
    the ROS plumbing: construct with a config, call :meth:`step` each control
    cycle with the measured state.
    """

    def __init__(self, cfg: SolverConfig, donate: bool = True,
                 use_kernel=False):
        """use_kernel: False (XLA pipeline), True (fused Pallas kernel, GPU
        only), or "auto" — the kernel iff kernels.should_use_kernel says it
        was measured faster for this device kind at this size."""
        if use_kernel == "auto":
            use_kernel = should_use_kernel(
                cfg.num_samples, cfg.horizon, model=cfg.model
            )
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.model = get_model(cfg.model)
        step = functools.partial(mppi_step, cfg, use_kernel=use_kernel)
        self._step = jax.jit(step, donate_argnums=(0,) if donate else ())

    def init(self, seed: int = 0, dtype=jnp.float32) -> ControllerState:
        return ControllerState.initial(
            jax.random.PRNGKey(seed), self.cfg.horizon, self.model.num_controls, dtype
        )

    def step(self, ctrl, state, path, dt, sp, cp, model_params=None):
        return self._step(ctrl, state, path, dt, sp, cp, model_params)
