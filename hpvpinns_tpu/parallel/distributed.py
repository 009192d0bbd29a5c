"""Multi-process initialization.

The reference is strictly single-process (CPU-pinned sessions,
Poisson-1D.py:105); this module is the scale-out entry: every process of a
cluster calls `initialize()` once before any JAX call, after which
`jax.devices()` spans every process's devices and the element-sharded meshes
in `parallel/sharding.py` work unchanged (they are host-count agnostic —
meshes are built from `jax.devices()`, and GSPMD inserts the cross-process
collectives the sharding requires).

The coordinator address, process count and process id are passed
explicitly or through the environment: nothing on a plain GPU or CPU host
describes the cluster.  Single-process runs (num_processes == 1, or no
cluster environment) are a no-op, so the same training script works from
one device to many hosts.
"""

from __future__ import annotations

import os
from typing import Optional

_initialized = False


def is_initialized() -> bool:
    return _initialized


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Idempotent jax.distributed bring-up; returns the process topology.

    Argument defaults come from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Returns
    {"process_index", "process_count", "local_devices", "global_devices"}.
    """
    global _initialized
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    multi_process = (
        coordinator_address is not None
        or (num_processes is not None and num_processes > 1)
    )
    if multi_process and not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
