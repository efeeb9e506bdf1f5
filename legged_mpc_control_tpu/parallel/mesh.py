"""Device mesh construction and sharding helpers.

The reference's concurrency fabric is three threads + ROS pub/sub + UDP
(SURVEY.md §2.4). The equivalent here is scenario parallelism over a device
mesh: `vmap` within a device, `NamedSharding`/`shard_map` across devices and
hosts, with XLA's collectives between them (NCCL between GPUs).
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "scenario"


def scenario_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the scenario axis (the framework's primary scale-out
    dimension — robots/scenarios are embarrassingly parallel; QP block
    reductions and metric aggregation ride collectives)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(BATCH_AXIS,))


def shard_scenarios(mesh: Mesh, tree):
    """Place a scenario-batched pytree with the leading axis sharded."""
    def put(x):
        spec = P(BATCH_AXIS, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. RobotParams shared across scenarios)."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree.map(put, tree)


def batch_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(BATCH_AXIS))


def shard_mixed(mesh: Mesh, tree, batch: int):
    """Shard leaves whose leading axis equals `batch`; replicate the rest.

    For pytrees like a domain-randomized RobotParams where only some leaves
    carry the scenario axis (runner.randomize_params)."""
    def put(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == batch:
            spec = P(BATCH_AXIS, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)
