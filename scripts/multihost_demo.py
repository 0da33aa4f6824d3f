#!/usr/bin/env python
"""Multi-host sample-sharded MPPI demo.

Run the same script on every host of a cluster (e.g. via your cluster
launcher); on a single machine it degrades gracefully to all local devices:

    python scripts/multihost_demo.py --num-samples 131072 --steps 50

Under a launcher, jax.distributed is initialized from JAX_COORDINATOR_ADDRESS
(with the process count and id from jax.distributed's environment); the
"samples" mesh then spans every device and the softmax reductions run over
NVLink within a host and the network across hosts.
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-samples", type=int, default=131072)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--kernel", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccv_mppi_path_tracker_tpu.core import ControllerState
    from ccv_mppi_path_tracker_tpu.core.presets import full_body_launch
    from ccv_mppi_path_tracker_tpu.parallel import (
        build_sharded_simulate,
        initialize_multihost,
        samples_mesh,
    )
    from ccv_mppi_path_tracker_tpu.paths import PathBuffer

    distributed = initialize_multihost()
    devices = jax.devices()
    if jax.process_index() == 0:
        print(f"distributed={distributed} processes={jax.process_count()} "
              f"devices={len(devices)}")

    n = len(devices)
    k = (args.num_samples // n) * n
    cfg, sp, cp, course = full_body_launch(num_samples=k, horizon=args.horizon)
    path = PathBuffer.from_points(course, 0.1)
    mesh = samples_mesh()
    sim = build_sharded_simulate(cfg, mesh, num_steps=args.steps)

    ctrl = ControllerState.initial(jax.random.PRNGKey(0), cfg.horizon, 5)
    slope = float(np.arctan2(course[1, 1] - course[0, 1],
                             course[1, 0] - course[0, 0]))
    state0 = jnp.asarray([course[0, 0], course[0, 1], slope, 0.0, 0.0],
                         jnp.float32)
    t0 = time.time()
    ctrl, logs = sim(ctrl, state0, path, jnp.float32(0.1), sp, cp)
    final = np.asarray(logs["state"][-1])
    wall = time.time() - t0
    if jax.process_index() == 0:
        from ccv_mppi_path_tracker_tpu.metrics import tracking_metrics

        m = tracking_metrics(np.asarray(logs["state"])[:, :2], course)
        print(f"{args.steps} cycles at K={k} over {n} devices in {wall:.1f}s "
              f"(incl. compile): RMSE={m['rmse']:.3f} final={final[:2]}")


if __name__ == "__main__":
    main()
