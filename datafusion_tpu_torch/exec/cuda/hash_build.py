"""Direct-address join build: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas kernel `hash_build.build_slot_table` of the JAX
package (`datafusion_tpu/exec/pallas/hash_build.py`, pallas_call at
line 70).  The join's dense-int path places build key k in slot
k - kmin; the build fills, per slot, the highest live row holding it
(-1 if none) and how many live rows hold it.

The kernel (`csrc/hash_build.cu`) is one thread per row with int32
atomicMax / atomicAdd, exact and repeatable since int32 max and add
commute; a row that finds its slot already counted raises a one-int
duplicate flag.  It is bound by device memory: N * 5 bytes read, S * 8
written.  One C call initialises the outputs (two memsets) and launches
the kernel, and the kernel bounds-checks `pos` itself: the join computes
it for dead rows too.

`build_slot_table` returns (row, count, has_duplicate), the flag as a
Python bool after one 4-byte copy to the host: the join keeps `row`
and asks only whether the keys are unique.  It takes the kernel for a
CUDA tensor and the plain version, `build_slot_table_torch` (the port
of `build_slot_table_xla`: `scatter_reduce_("amax")` plus `index_add_`,
which gives (row, count)), for a CPU tensor; there is no other route.
`LAUNCHES` counts wrapper calls that launched the kernel (one CUDA
kernel launch each).
"""

from __future__ import annotations

import ctypes

import torch

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.gate import host_wait

LAUNCHES = 0

_MAX_ROWS = 2**31 - 1  # row indices are int32


def _check(pos, live, num_slots: int) -> None:
    if not isinstance(num_slots, int) or num_slots < 1:
        raise ValueError(f"num_slots must be a positive int, got {num_slots!r}")
    for name, t in (("pos", pos), ("live", live)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
    if live.shape[0] != pos.shape[0]:
        raise ValueError(f"live has {live.shape[0]} rows, pos has {pos.shape[0]}")
    if live.device != pos.device:
        raise ValueError(f"live is on {live.device}, pos on {pos.device}")
    if pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32, got {pos.dtype}")
    if live.dtype != torch.bool:
        raise ValueError(f"live must be bool, got {live.dtype}")
    if pos.shape[0] > _MAX_ROWS:
        raise ValueError(f"{pos.shape[0]} rows exceed int32 row indices")


def build_slot_table_torch(pos, live, num_slots: int):
    """Plain PyTorch version of the kernel (the semantics of the numpy
    oracle `build_slot_table_numpy` of the Pallas module)."""
    _check(pos, live, num_slots)
    dev = pos.device
    sel = live & (pos >= 0) & (pos < num_slots)
    slots = pos[sel].long()
    rows = torch.arange(pos.shape[0], dtype=torch.int32, device=dev)[sel]
    row = torch.full((num_slots,), -1, dtype=torch.int32, device=dev)
    row.scatter_reduce_(0, slots, rows, "amax")
    count = torch.zeros(num_slots, dtype=torch.int32, device=dev)
    count.index_add_(0, slots, torch.ones_like(rows))
    return row, count


_FN = None


def _kernel_fn():
    """The kernel library's entry point with its C signature declared."""
    global _FN
    if _FN is None:
        from datafusion_tpu_torch.exec import cuda as _cuda

        fn = _cuda.load("hash_build").df_build_slot_table
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        _FN = fn
    return _FN


def _launch(pos, live, num_slots: int):
    """(row, count, dup): row its own int32 tensor (the join keeps it),
    count and the dup flag one allocation of num_slots + 1; the C call
    initialises and fills both."""
    global LAUNCHES
    from datafusion_tpu_torch.exec import cuda as _cuda

    for name, t in (("pos", pos), ("live", live)):
        if not t.is_contiguous():
            raise ExecutionError(f"build_slot_table kernel needs contiguous {name}")
    dev = pos.device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(pos, live, num_slots)
    fn = _kernel_fn()
    row = torch.empty(num_slots, dtype=torch.int32, device=dev)
    count = torch.empty(num_slots + 1, dtype=torch.int32, device=dev)
    rc = fn(pos.data_ptr(), live.data_ptr(), pos.shape[0], num_slots,
            row.data_ptr(), count.data_ptr(), _cuda.raw_stream(dev))
    if rc != 0:
        raise ExecutionError(f"build_slot_table kernel launch failed: CUDA error {rc}")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return row, count[:num_slots], count[num_slots]


def build_slot_table(pos, live, num_slots: int):
    """Per slot in [0, num_slots): the highest live row index whose
    `pos` is that slot (-1 if none) and the count of such rows, as two
    int32 tensors on the inputs' device, and whether some slot holds two
    or more live rows, as a Python bool.  Rows that are dead or whose
    pos lies outside [0, num_slots) count nowhere."""
    _check(pos, live, num_slots)
    if pos.device.type == "cpu":
        row, count = build_slot_table_torch(pos, live, num_slots)
        return row, count, bool(count.max() > 1)
    if pos.device.type != "cuda":
        raise ExecutionError(f"build_slot_table runs on cuda or cpu, not {pos.device}")
    row, count, dup = _launch(pos, live, num_slots)
    with host_wait():
        return row, count, bool(dup.item())  # df-lint: ok(DF001) — the build's duplicate flag, one pull a build, under host_wait
