"""Multi-host initialization.

On a multi-host cluster, every host runs the same program;
``jax.distributed.initialize`` wires the hosts into one runtime so
``jax.devices()`` spans every device and the samples mesh covers it. The
softmax reductions then run over NVLink within a host and the network across
hosts — no other communication exists in sample-parallel MPPI, so scaling is
collective-latency bound (SURVEY.md section 2.5).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running under a multi-host launcher.

    The coordinator defaults from JAX_COORDINATOR_ADDRESS; nothing is
    auto-detected, so give num_processes and process_id with it (or set
    them through jax.distributed's own environment). Returns True if distributed mode was
    initialized, False when single-process (no coordinator configured) — the
    caller can proceed identically either way since the mesh is built from
    jax.devices().
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    already = getattr(jax.distributed, "is_initialized", None)
    if callable(already) and already():
        return True
    if coordinator_address is None:
        return False
    # A coordinator IS configured past this point (explicit argument or
    # launcher env): failure to join the pod must be loud, not a silent
    # degrade to single-process — a solver that quietly computes on 1/N of
    # its samples is the worst failure mode this framework has (the same
    # principle as runtime/gating.py's explicit stale-input policy).
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception as e:
        raise RuntimeError(
            "multi-host launch configured "
            f"(coordinator={coordinator_address!r}, "
            f"num_processes={num_processes}, process_id={process_id}) but "
            "jax.distributed.initialize failed — refusing to degrade to "
            "single-process; unset JAX_COORDINATOR_ADDRESS to run "
            "single-host"
        ) from e
    return True
