"""Cross-feature parity fuzz: kernel vs XLA under random option subsets.

The single-feature tests pin each solver option (elite_frac, warm-start
shift, adapt_sigma, lean, colored noise) in isolation. This fuzz draws
random COMBINATIONS and asserts, per draw with the same injected noise:

  1. fused-kernel u_opt == XLA-pipeline u_opt (f32 round-off tolerance),
  2. lean result == full result bit-exactly on u_opt/u0 (both paths),
  3. adapt_sigma's sigma_suggest agrees across kernel/XLA.

Guards against cross-feature regressions the per-feature tests can't see
(e.g. the elite two-pass interacting with the second-moment accumulators).
Seeds are fixed; failures reproduce exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccv_mppi_path_tracker_tpu.core.config import (
    SolverConfig,
    make_cost_params,
    make_solver_params,
)
from ccv_mppi_path_tracker_tpu.core.types import ControllerState
from ccv_mppi_path_tracker_tpu.models import get_model
from ccv_mppi_path_tracker_tpu.paths import PathBuffer, sum_of_cosines_course
from ccv_mppi_path_tracker_tpu.solver import mppi_step

MODELS = {
    "unicycle": (2, 3),
    "steering_unicycle": (3, 3),
    "rate_limited_steering": (3, 4),
    "full_body": (5, 5),
}
K = 1024  # eight 128-sample kernel blocks
T = 10


@pytest.mark.parametrize("trial", range(8))
def test_option_combination_kernel_matches_xla(trial):
    rng = np.random.RandomState(7000 + trial)
    model_name = list(MODELS)[trial % len(MODELS)]
    u_dim, s_dim = MODELS[model_name]

    elite_frac = rng.choice([None, 0.25, 0.6])
    shift = bool(rng.randint(2))
    adapt = bool(rng.randint(2))
    beta = float(rng.choice([0.0, 0.3]))
    steer_off = model_name == "full_body" and bool(rng.randint(2))
    opts = dict(
        elite_frac=None if elite_frac is None else float(elite_frac),
        shift_warm_start=shift,
        adapt_sigma=adapt,
    )

    course = sum_of_cosines_course(
        amplitudes=(1.0, 0.3, 0.0), frequencies=(0.2, 0.5, 0.0),
        resolution=0.1, course_length=10.0, dtype=np.float32,
    )
    cfg = SolverConfig(model=model_name, num_samples=K, horizon=T,
                       steer_off=steer_off)
    sp = make_solver_params(
        0.6, 1.2, -np.ones(u_dim) * 1.5, np.ones(u_dim) * 1.5,
        noise_beta=beta,
    )
    cp = make_cost_params(v_ref=1.0, path_weight=8.0, v_weight=1.0,
                          zmp_weight=2.0, roll_v_weight=0.5,
                          back_weight=1.0, yaw_weight=1.0)
    path = PathBuffer.from_points(course, 0.1)
    state = jnp.asarray(rng.randn(s_dim) * 0.2, jnp.float32)
    if model_name == "rate_limited_steering":
        state = state.at[3].set(jnp.clip(state[3], -0.4, 0.4))
    ctrl = ControllerState(
        u_prev=jnp.asarray(rng.randn(T - 1, u_dim) * 0.2, jnp.float32),
        key=jax.random.PRNGKey(trial),
        step=jnp.zeros((), jnp.int32),
    )
    noise = jnp.asarray(rng.randn(T - 1, K, u_dim), jnp.float32)
    dt = jnp.float32(0.1)
    args = (cfg, ctrl, state, path, dt, sp, cp)

    _, xla = mppi_step(*args, noise=noise, **opts)
    _, xla_lean = mppi_step(*args, noise=noise, lean=True, **opts)
    _, ker = mppi_step(*args, noise=noise, use_kernel=True,
                       kernel_interpret=True, **opts)
    _, ker_lean = mppi_step(*args, noise=noise, use_kernel=True,
                            kernel_interpret=True, lean=True, **opts)

    msg = (f"{model_name} elite={elite_frac} shift={shift} adapt={adapt} "
           f"beta={beta} steer_off={steer_off}")
    # f32 round-off between the kernel's rescaled online accumulation and
    # XLA's einsum reduction order: observed up to ~5e-6 abs across seeds
    np.testing.assert_allclose(
        np.asarray(ker.u_opt), np.asarray(xla.u_opt),
        rtol=2e-4, atol=2e-5, err_msg=msg,
    )
    # lean drops outputs, never changes the math — bit-equal per path
    np.testing.assert_array_equal(np.asarray(xla_lean.u_opt),
                                  np.asarray(xla.u_opt), err_msg=msg)
    np.testing.assert_array_equal(np.asarray(ker_lean.u_opt),
                                  np.asarray(ker.u_opt), err_msg=msg)
    assert xla_lean.ref is None and ker_lean.opt_states is None
    if adapt:
        np.testing.assert_allclose(
            np.asarray(ker.stats["sigma_suggest"]),
            np.asarray(xla.stats["sigma_suggest"]),
            rtol=2e-4, atol=2e-5, err_msg=msg,
        )
        # lean keeps only the serving feedback scalars: sigma_suggest, and
        # the elite threshold when elite_frac is on (fed forward by the
        # stale single-pass mode)
        expect = {"sigma_suggest"}
        if elite_frac is not None:
            expect.add("elite_thresh")
        assert set(ker_lean.stats) == expect
    if steer_off:
        np.testing.assert_array_equal(np.asarray(ker.u_opt[:, 2]), 0.0)
