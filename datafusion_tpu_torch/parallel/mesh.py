"""The shard mesh and multi-process bring-up (the JAX package's
`parallel/mesh.py`).

The port's mesh is an ordered list of `torch.device` shard slots along
one named axis, `MESH_AXIS`: partition i of a partitioned table runs on
slot i % n (parallel/partition.py).  A device may fill several slots:
a mesh of 8 slots of `cuda:0` runs the shard axis of 8 on one card (and
a mesh of 8 `cpu` slots in the tests), where the JAX package's tests
force 8 virtual host devices.

`initialize_distributed` is the multi-process bring-up: a
`torch.distributed` process group (gloo on the CPU, nccl on the card)
whose address, world size and rank the caller gives, as the worker's
`--coordinator`, `--num-processes` and `--process-id` do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.errors import ExecutionError

MESH_AXIS = "shards"


def mesh_axis() -> str:
    return MESH_AXIS


class Mesh:
    """A 1-D mesh: shard slot i is `devices[i]`."""

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise ExecutionError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({MESH_AXIS}={self.size}: {', '.join(map(str, self.devices))})"


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device, in index order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the partition axis.  `devices` names the slots
    (a device may repeat); without it the slots are the visible CUDA
    devices, and `n_devices` takes the first n of them, raising
    `ExecutionError` past the visible count (one on one H100)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = visible_devices()
        if not devs:
            raise ExecutionError(
                "no CUDA device available for a mesh; pass devices=['cpu', ...] "
                "to run on the CPU"
            )
    if n_devices is not None:
        if n_devices > len(devs):
            raise ExecutionError(
                f"requested mesh of {n_devices} devices, only {len(devs)} visible"
            )
        devs = devs[:n_devices]
    return Mesh(devs)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a `torch.distributed` process group: `coordinator_address`
    is the rank-0 host:port (`tcp://` is added), `num_processes` the
    world size, `process_id` this process's rank.  The backend is nccl
    when CUDA is available, else gloo."""
    import torch.distributed as dist

    if coordinator_address is None or num_processes is None or process_id is None:
        raise ExecutionError(
            "initialize_distributed needs the coordinator address, the number "
            "of processes and this process's id (nothing detects a cluster)"
        )
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes), rank=int(process_id))
