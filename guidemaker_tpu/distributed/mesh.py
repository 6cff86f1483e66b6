"""Mesh/topology helpers for single-chip, single-host and multi-host runs."""
from __future__ import annotations

import logging
import math
from typing import Optional

import jax

from ..knn.sharded import make_mesh

logger = logging.getLogger(__name__)

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the JAX multi-host runtime (no-op when single-process).

    Pass the coordinator address (``host:port``), the process count and
    this process's id explicitly.  Call once per host before building
    meshes.
    """
    global _initialized
    if _initialized:
        return
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        logger.info("jax.distributed initialized: process %d of %d",
                    jax.process_index(), jax.process_count())
    _initialized = True


def auto_mesh(n_devices: Optional[int] = None):
    """A reasonable 2-D (q, d) mesh over the available devices.

    Database sharding ('d') is favored — it divides the memory footprint;
    query sharding ('q') takes any leftover factor of 2.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    q_shards = 1
    d_shards = n
    # peel one factor of 2 into the query axis for n >= 4
    if n >= 4 and n % 2 == 0:
        q_shards, d_shards = 2, n // 2
    return make_mesh(q_shards, d_shards, devices=devices[:n])


def device_summary() -> str:
    devices = jax.devices()
    kinds = {}
    for d in devices:
        kinds[getattr(d, "device_kind", d.platform)] = \
            kinds.get(getattr(d, "device_kind", d.platform), 0) + 1
    return (f"{len(devices)} device(s) across {jax.process_count()} "
            f"process(es): " +
            ", ".join(f"{v}x {k}" for k, v in kinds.items()))
