"""Hash joins.

Two physical strategies behind one `HashJoinRelation` (relation.py):

- **dense-int device path**: a single integer key, unique on the build
  side, whose range fits `_dense_max_slots()`, direct-addresses a slot
  table built on the device by the hand-written CUDA kernel
  (`exec/cuda/hash_build.py`) and probed per batch by one torch
  function of gathers (hit mask, payload gather, validity and the
  selection mask).
- **host path**: everything else (multi-key, strings, duplicate
  keys, wide key ranges): a `HashIndex` (core.py) over the build rows,
  probed with numpy CSR expansion per batch.

The build side is always the RIGHT input.
"""

from datafusion_tpu_torch.join.core import HashIndex, partition_of
from datafusion_tpu_torch.join.relation import HashJoinRelation

__all__ = ["HashIndex", "HashJoinRelation", "partition_of"]
