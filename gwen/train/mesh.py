"""Device mesh and sharding helpers.

Replaces the reference's NCCL process-group machinery (``init_process_group``,
``MASTER_ADDR=localhost:12355`` — models_gnn.py:321-324, single node only) with
the JAX SPMD model: one global ``Mesh`` with a ``data`` axis (ensemble
members / batch replication — what DDP did) and a ``graph`` axis
(edge-partitioned mesh-graph parallelism — the framework's scaling extension,
SURVEY §2.3). Multi-host initialization is a single
``jax.distributed.initialize()`` call per host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host setup (replaces torch rendezvous; no-op on one process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    data: int = -1,
    graph: int = 1,
    axis_names: Sequence[str] = ("data", "graph"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2-D device mesh. ``data=-1`` absorbs all remaining devices.

    Axis order puts ``graph`` innermost (consecutive devices share a
    partition ring). The cards of one host are joined all to all, so the
    layout follows the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        if n % graph:
            raise ValueError(f"{n} devices not divisible by graph={graph}")
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} devices")
    arr = np.asarray(devices).reshape(data, graph)
    return Mesh(arr, tuple(axis_names))


def data_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> NamedSharding:
    """Shard ``batch_axis`` over the data axis, replicate the rest."""
    spec = [None] * ndim
    spec[batch_axis] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def node_sharding(mesh: Mesh, ndim: int, node_axis: int = 0) -> NamedSharding:
    """Shard ``node_axis`` over the graph axis (partitioned node features)."""
    spec = [None] * ndim
    spec[node_axis] = mesh.axis_names[1]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def is_main_process() -> bool:
    """Rank-0 gate for logging/side effects (reference loggers_configs.py:35-38)."""
    return jax.process_index() == 0
