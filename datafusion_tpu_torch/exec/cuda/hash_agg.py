"""Grouped reduce by dense group id: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas kernel `hash_agg.grouped_reduce` of the JAX package
(`datafusion_tpu/exec/pallas/hash_agg.py`, pallas_call at line 95).  The
host `GroupKeyEncoder` assigns dense group ids, so the id IS the
accumulator slot and no hash table is built on the device.

The kernel (`csrc/hash_agg.cu`) is bound by device memory: it reads
N * (4 + sizeof(val) + 1) bytes and writes G * sizeof(val).  It runs two
passes, partials per (row chunk, group) and then one fold per group, in
an order fixed by (N, G) and without atomics, so f64 results are
bit-identical from run to run.  The source says more.

`grouped_reduce` takes the kernel for a CUDA tensor and the plain
version, `grouped_reduce_torch`, for a CPU tensor; there is no other
route.  `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from datafusion_tpu_torch.errors import ExecutionError

LAUNCHES = 0

TILE_G = 512  # groups per block in pass 1 (shared memory: 8 warps x tile)
_BLOCK_ROWS = 256  # rows per 32-row step of all 8 warps of a block
_TARGET_BLOCKS = 528  # pass-1 blocks to aim for: 4 on each of 132 SMs
_MAX_TILES = 65535  # grid.y limit

_DTYPE_CODES = {
    torch.int8: 0,
    torch.int16: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.float32: 4,
    torch.float64: 5,
}
_KINDS = {"sum": 0, "min": 1, "max": 2}


def _identity(kind: str, dtype: torch.dtype):
    """The value an empty group holds (the Pallas module's `_identity`)."""
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.bool:
        return kind == "min"
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _check(ids, vals, live, num_groups: int, kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown reduce kind {kind!r}")
    if not isinstance(num_groups, int) or num_groups < 1:
        raise ValueError(f"num_groups must be a positive int, got {num_groups!r}")
    for name, t in (("ids", ids), ("vals", vals), ("live", live)):
        if not isinstance(t, torch.Tensor) or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
        if t.shape[0] != ids.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} rows, ids has {ids.shape[0]}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if live.dtype != torch.bool:
        raise ValueError(f"live must be bool, got {live.dtype}")


def grouped_reduce_torch(ids, vals, live, num_groups: int, kind: str):
    """Plain PyTorch version of the kernel (same dead-row, out-of-range
    and identity semantics as the numpy oracle `grouped_reduce_numpy`
    of the Pallas module)."""
    _check(ids, vals, live, num_groups, kind)
    out = torch.full((num_groups,), _identity(kind, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    sel = live & (ids >= 0) & (ids < num_groups)
    idx = ids[sel].long()
    v = vals[sel]
    if kind == "sum":
        return out.index_add_(0, idx, v)
    return out.scatter_reduce_(0, idx, v, "amin" if kind == "min" else "amax")


def geometry(n: int, num_groups: int) -> tuple[int, int, int]:
    """(tile_g, num_chunks, chunk_rows) of a launch: group tiles of at
    most TILE_G, and enough row chunks for about _TARGET_BLOCKS blocks.
    A function of (n, num_groups) only, so the combine order — and with
    it every float result — repeats exactly."""
    tile_g = min(TILE_G, -(-num_groups // 32) * 32)
    tiles = -(-num_groups // tile_g)
    chunks = max(1, min(-(-n // _BLOCK_ROWS), -(-_TARGET_BLOCKS // tiles)))
    chunk_rows = -(-max(n, 1) // chunks)
    chunk_rows = -(-chunk_rows // _BLOCK_ROWS) * _BLOCK_ROWS
    return tile_g, max(1, -(-n // chunk_rows)), chunk_rows


_FN = None


def _kernel_fn():
    """The kernel library's entry point with its C signature declared
    (pointers and the stream as c_void_p, so ctypes does not cut them
    to 32 bits)."""
    global _FN
    if _FN is None:
        from datafusion_tpu_torch.exec import cuda as _cuda

        fn = _cuda.load("hash_agg").df_grouped_reduce
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _FN = fn
    return _FN


def _launch(ids, vals, live, num_groups: int, kind: str):
    global LAUNCHES
    dtype = _DTYPE_CODES.get(vals.dtype)
    if dtype is None:
        raise ExecutionError(f"grouped_reduce kernel does not take {vals.dtype}")
    for name, t in (("ids", ids), ("vals", vals), ("live", live)):
        if not t.is_contiguous():
            raise ExecutionError(f"grouped_reduce kernel needs contiguous {name}")
    n = ids.shape[0]
    tile_g, chunks, chunk_rows = geometry(n, num_groups)
    if -(-num_groups // tile_g) > _MAX_TILES:
        raise ExecutionError(f"{num_groups} groups exceed the kernel's grid")
    fn = _kernel_fn()
    out = torch.empty(num_groups, dtype=vals.dtype, device=vals.device)
    scratch = torch.empty(chunks * num_groups, dtype=vals.dtype,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = fn(dtype, _KINDS[kind], ids.data_ptr(), vals.data_ptr(),
                live.data_ptr(), n, num_groups, chunks, chunk_rows, tile_g,
                scratch.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise ExecutionError(f"grouped_reduce kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def grouped_reduce(ids, vals, live, num_groups: int, kind: str):
    """Per-group reduction of `vals` by dense int32 `ids`.  `live`
    masks rows out; ids outside [0, num_groups) contribute nothing;
    empty groups hold the identity.  `kind` is "sum" | "min" | "max".
    Returns a [num_groups] tensor of vals.dtype on the inputs' device."""
    _check(ids, vals, live, num_groups, kind)
    if ids.device.type == "cpu":
        return grouped_reduce_torch(ids, vals, live, num_groups, kind)
    if ids.device.type != "cuda":
        raise ExecutionError(f"grouped_reduce runs on cuda or cpu, not {ids.device}")
    return _launch(ids, vals, live, num_groups, kind)
