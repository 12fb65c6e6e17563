"""Mesh construction and multi-host initialization.

The solver mesh is one-dimensional because the algorithm is: Krylov
iterations offer a single natural partition axis (matrix rows / grid
slabs).  The per-iteration ``psum`` and the neighbour halo ``ppermute`` run
over that axis; devices joined all to all (NVLink within a host) need no
other layout.  Multi-host runs extend the same axis via
``jax.distributed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


DEFAULT_AXIS = "rows"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = DEFAULT_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build the 1-D solver mesh.

    Parameters
    ----------
    n_devices : use the first ``n_devices`` visible devices (default: all).
    axis_name : mesh axis name (the axis solvers psum over).
    devices : explicit device list overriding discovery.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} visible"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (one process per host, devices pooled).

    Thin wrapper over ``jax.distributed.initialize``; after it returns,
    ``jax.devices()`` spans every host and :func:`make_mesh` builds a
    global mesh whose collectives run within and across hosts.  The reference has no equivalent (single-process only).
    No-op when already initialized or when running single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # Already initialized (or single-process auto-detection) — fine.
        pass
