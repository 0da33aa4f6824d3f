from ccv_mppi_path_tracker_tpu.kernels.rollout_cost import (
    KERNEL_MODELS,
    combine_partials,
    fused_sample_rollout_cost,
    pack_scalars,
    should_use_kernel,
)

__all__ = [
    "KERNEL_MODELS",
    "combine_partials",
    "fused_sample_rollout_cost",
    "pack_scalars",
    "should_use_kernel",
]
