"""ccv_mppi_path_tracker_tpu — a GPU-accelerated MPPI path-tracking framework.

A ground-up re-design of the capabilities of the reference ROS/catkin package
``YoshikiMaekawa2000/ccv_mppi_path_tracker`` (three C++ MPPI controller nodes,
path generators, CSV metrics pipeline) as a batched, functional, sharded
JAX/Pallas framework:

- ``models``   — dynamics families (unicycle, steering unicycle, full-body+ZMP)
                 as pure, batched step functions (reference: the per-node
                 ``predict_NextState`` methods, e.g. src/diff_drive_mppi.cpp:104).
- ``ops``      — the MPPI pipeline stages: Gaussian control sampling, scan
                 rollout, min-distance tracking cost, softmax-weighted update.
- ``solver``   — the fused, jittable control step + command geometry.
- ``parallel`` — sample-axis sharding over a device mesh (shard_map + psum).
- ``paths``    — course generators and in-jit reference resampling.
- ``runtime``  — closed-loop simulation driver, state estimation adapters,
                 checkpoint/resume.
- ``diff``     — differentiable MPPI: gradients through rollouts, system ID.
- ``kernels``  — the fused Pallas (Triton-route) GPU kernel of the control
                 update.
- ``metrics``  — tracking RMSE/max-error evaluators, per-step solver stats,
                 CSV recording (reference: src/record_state.py, calc_e_rmse.py).
- ``oracle``   — NumPy re-statement of the C++ semantics for parity testing.
"""

from ccv_mppi_path_tracker_tpu.version import __version__

__all__ = ["__version__"]
