"""Device mesh construction for multi-chip / multi-host search.

The reference has no distributed layer at all (SURVEY.md section 2:
cluster scripts only schedule independent single-node jobs). The
scaling design (BASELINE.md): a 1-D data mesh; the query batch is sharded
across chips, the index tables are replicated when they fit in HBM
(DataParallelEngine) or sharded along the entry axis with collective lookup
routing when they don't (ShardedIndexEngine).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first n_devices (default: all local devices)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def initialize_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Multi-host bring-up: jax.distributed.initialize passthrough.

    On a multi-host cluster call this once per host before make_mesh();
    jax.devices() then spans every host and the same pjit program runs
    SPMD across hosts (the tpufm replacement for the reference's SGE/SLURM
    job arrays)."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator, **kwargs)
    else:
        jax.distributed.initialize(**kwargs)
