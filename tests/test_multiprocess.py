"""REAL multi-process distributed execution of the sample-sharded solver.

The cross-process path: two OS processes,
each owning 4 virtual CPU devices, wired into one runtime by
``jax.distributed.initialize`` (gRPC coordinator + gloo CPU collectives —
the CPU stand-in for a cross-host network). The 8-way "samples" mesh
spans both processes, so the solve's pmin/psum reductions actually cross a
process boundary, and the replicated result from each process must match the
single-process 8-device result bit-tightly under injected noise
(SURVEY.md section 2.5; parallel/multihost.py).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiprocess_worker.py")

T, K = 10, 64
GRAD_B, GRAD_T = 1024, 32


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env():
    # The worker pins its own backend (cpu, 4 virtual devices); drop the
    # parent conftest's 8-device flags so they cannot fight the child's.
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def two_process_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    port = _free_port()
    outs = [str(tmp / f"p{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, WORKER,
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2",
                "--process-id", str(i),
                "--devices-per-process", "4",
                "--num-samples", str(K),
                "--horizon", str(T),
                "--out", outs[i],
                "--x64",
                "--elite",
                "--grad-batch", str(GRAD_B),
                "--grad-horizon", str(GRAD_T),
            ],
            env=_child_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [dict(np.load(o)) for o in outs]


def test_two_processes_match_single_process(two_process_results):
    """Replicated u_opt from both processes == single-process 8-device run."""
    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer
    from ccv_mppi_path_tracker_tpu.solver import mppi_step

    cfg, sp, cp, course = full_body_launch(
        num_samples=K, horizon=T, dtype=np.float64
    )
    path = PathBuffer.from_points(course, 0.1, dtype=np.float64)
    ctrl = ControllerState(
        u_prev=jnp.zeros((T - 1, 5), np.float64),
        key=jax.random.PRNGKey(3),
        step=jnp.zeros((), jnp.int32),
    )
    state = jnp.zeros(5, np.float64).at[1].set(float(course[0, 1]))
    noise = jnp.asarray(np.random.RandomState(0).randn(T - 1, K, 5))
    _, res1 = jax.jit(
        lambda c, s, n: mppi_step(
            cfg, c, s, path, jnp.float64(0.1), sp, cp, noise=n
        )
    )(ctrl, state, noise)

    for r in two_process_results:
        assert int(r["process_count"]) == 2
        assert int(r["n_global_devices"]) == 8
        np.testing.assert_allclose(
            r["u_opt"], np.asarray(res1.u_opt), rtol=1e-12, atol=1e-14
        )
        np.testing.assert_allclose(
            float(r["min_cost"]), float(res1.stats["min_cost"]), rtol=1e-12
        )
        np.testing.assert_allclose(
            float(r["ess"]), float(res1.stats["ess"]), rtol=1e-9
        )


def test_two_processes_agree_with_each_other(two_process_results):
    a, b = two_process_results
    np.testing.assert_array_equal(a["u_opt"], b["u_opt"])
    assert a["step_s"] > 0 and b["step_s"] > 0
    # elite_frac sharded step ran and was timed (radix-select threshold:
    # 8 digit-histogram psums on top of the 3 vanilla collectives)
    assert a["step_elite_s"] > 0 and b["step_elite_s"] > 0


def test_overlapped_grad_allreduce_matches_sequential(two_process_results):
    """System-ID gradient across a REAL process boundary: the
    backward-overlapped bucketed psum (num_chunks=4, 8) must equal the
    sequential single-psum gradient (num_chunks=1), both processes must
    agree, and both must match a single-process evaluation of the same
    batch."""
    import jax.numpy as jnp

    from ccv_mppi_path_tracker_tpu.diff.system_id import (
        ControlGains,
        rollout_prediction_value_and_grad,
    )

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from multiprocess_worker import grad_bench_data

    state0, controls, observed = grad_bench_data(GRAD_B, GRAD_T, np.float64)
    params = ControlGains(gains=jnp.ones((2,), jnp.float64))
    loss1, grad1 = rollout_prediction_value_and_grad(
        "unicycle", params, jnp.asarray(state0), jnp.asarray(controls),
        jnp.asarray(observed), jnp.float64(0.1),
    )
    for r in two_process_results:
        for c in (1, 4, 8):
            np.testing.assert_allclose(
                r[f"grad_gains_{c}"], np.asarray(grad1.gains),
                rtol=1e-12, atol=1e-14,
            )
            np.testing.assert_allclose(
                float(r[f"grad_loss_{c}"]), float(loss1), rtol=1e-12
            )
            assert r[f"grad_ms_{c}"] > 0
    a, b = two_process_results
    np.testing.assert_array_equal(a["grad_gains_4"], b["grad_gains_4"])
