"""Device mesh construction for sample-parallel MPPI.

MPPI's one natural parallel axis is the K sample trajectories (the reference
runs them in a serial C++ loop, src/diff_drive_mppi.cpp:92-124). The mesh is
1-D over all devices (NVLink within a host, the network across hosts) and
the entire
communication pattern is the trio {pmin(baseline), psum(sum w), psum(sum w*u)}
in ops/softmax_update.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

SAMPLES_AXIS = "samples"


def samples_mesh(devices: Optional[Sequence] = None, num_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the sample axis.

    devices: explicit device list (defaults to all of jax.devices());
    num_devices: truncate to the first N (CI uses virtual CPU devices).
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (SAMPLES_AXIS,))
