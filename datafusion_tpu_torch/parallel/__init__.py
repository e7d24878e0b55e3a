"""Partitioned and distributed execution (the JAX package's `parallel/`).

- `PartitionedContext` (partition.py): one process; a table's
  partitions shard over a mesh of device slots (mesh.py), a partial
  aggregate runs per shard and the partials combine along the shard
  axis;
- `DistributedContext` (coordinator.py): plan fragments (physical.py)
  travel as JSON in the frames of wire.py to worker processes
  (`python -m datafusion_tpu_torch.worker`, worker.py), which run them
  on their card and return partial aggregate states or rows; the
  coordinator merges them, with heartbeats, failover, hedged requests,
  circuit breakers, the retry budget and the hash-partitioned shuffle
  join (shuffle.py).
"""

from datafusion_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, mesh_axis
from datafusion_tpu_torch.parallel.physical import PhysicalPlan, PlanFragment
from datafusion_tpu_torch.parallel.partition import (
    PartitionedAggregateRelation,
    PartitionedContext,
    PartitionedDataSource,
)
from datafusion_tpu_torch.parallel.coordinator import DistributedContext, WorkerHandle

__all__ = [
    "make_mesh",
    "mesh_axis",
    "initialize_distributed",
    "PhysicalPlan",
    "PlanFragment",
    "PartitionedContext",
    "PartitionedDataSource",
    "PartitionedAggregateRelation",
    "DistributedContext",
    "WorkerHandle",
]
