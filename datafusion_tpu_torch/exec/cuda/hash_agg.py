"""Grouped reduce by dense group id: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas kernel `hash_agg.grouped_reduce` of the JAX package
(`datafusion_tpu/exec/pallas/hash_agg.py`, pallas_call at line 95).  The
host `GroupKeyEncoder` assigns dense group ids, so the id IS the
accumulator slot and no hash table is built on the device.

The kernel (`csrc/hash_agg.cu`) is bound by device memory: it reads
N * (4 + sizeof(val) + 1) bytes and writes G * sizeof(val).  One
cooperative launch reads every row once into per-lane or per-warp
partials in shared memory, writes one partial per (block, group) and,
after a grid barrier, folds them per group, in an order fixed by
`geometry` and the data and without float atomics, so f64 results are
bit-identical from run to run.  The source says more.

`grouped_reduce` takes the kernel for a CUDA tensor and the plain
version, `grouped_reduce_torch`, for a CPU tensor; there is no other
route.

The kernel has a query axis, which the serving megabatch needs:
`grouped_reduce_multi` runs Q queries over one set of ids, each with its
own live mask and either one shared value column or its own, in one
cooperative launch at the geometry of one query, so each query's result
is bit-identical to its own `grouped_reduce` on the same rows.  The
queries run in tiles (`query_tiles`): a tile's partials fit a block's
shared memory side by side, and one sweep of the rows serves the whole
tile, reading the ids (and shared values) once.  A solo call is the
launch with Q = 1: one kernel, one launch site (`_launch`).
Its plain version, `grouped_reduce_multi_torch`, is one reduction over
the offset ids q * G + id.  `LAUNCHES` counts every launch;
`MULTI_LAUNCHES` counts those that served more than one query.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec import cuda as _cuda

LAUNCHES = 0
MULTI_LAUNCHES = 0

MAX_WARPS = 8  # warps of a block; up to all of them own a partial in shared memory
ITEMS = 16  # 32-row steps a warp loads before it folds any (csrc kItems)
# queries of one query-axis launch: its scratch holds Q x blocks x G
# partials (32 x 132 x 8192 f64 are 277 MB); a wider call launches again
MAX_QUERIES = 32

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
    # every call of the aggregate passes here: plain comparisons only
    if kind not in _KINDS:
        raise ValueError(f"unknown reduce kind {kind!r}")
    if not isinstance(num_groups, int) or num_groups < 1:
        raise ValueError(f"num_groups must be a positive int, got {num_groups!r}")
    tensor = torch.Tensor
    if not (isinstance(ids, tensor) and isinstance(vals, tensor) and isinstance(live, tensor)
            and ids.dim() == vals.dim() == live.dim() == 1):
        raise ValueError("ids, vals and live must be 1-D tensors")
    n = ids.shape[0]
    if vals.shape[0] != n or live.shape[0] != n:
        raise ValueError(f"ids, vals and live have {n}, {vals.shape[0]} and "
                         f"{live.shape[0]} rows")
    dev = ids.device
    if vals.device != dev or live.device != dev:
        raise ValueError(f"ids, vals and live are on {dev}, {vals.device} and {live.device}")
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


@functools.lru_cache(maxsize=1024)
def geometry(n: int, num_groups: int, itemsize: int, sms: int,
             smem: int) -> tuple[int, int, bool, int, int, int]:
    """(warps, tile_g, lane_parts, blocks, chunk_rows, fold_lanes) of a
    launch.

    `warps` of a block's MAX_WARPS warps own a partial of `tile_g`
    groups in shared memory (`smem` bytes, what the kernel is granted
    per block: the card's opt-in limit less its static shared
    memory).  With `lane_parts` (a small G: 32 * G * itemsize per warp
    fits for all MAX_WARPS warps) each lane keeps its own partial;
    otherwise a warp keeps one value and one tag byte per group, so
    every G up to smem / (itemsize + 1) is one tile (8192 f64 groups
    are 72 KB: 3 warps) and every row is read once; a larger G takes
    ceil(G / tile_g) tiles of one warp, and each tile reads the rows
    again.  One block per SM (the launch is cooperative, so the grid
    must be resident), at most `sms` blocks, each a contiguous chunk of
    `chunk_rows` rows, a multiple of warps * 32, cut into one slice per
    owning warp.  All MAX_WARPS warps clear and combine the partials
    and fold them, and the fold gives each group `fold_lanes` threads (a
    power of two up to 32, as many as the grid has for every group).  A
    pure function of its arguments, so the combine order, and with it
    every float result, repeats exactly."""
    lane_parts = 32 * num_groups * itemsize * MAX_WARPS <= smem
    if lane_parts:
        warps, tile_g = MAX_WARPS, num_groups
    else:
        per_warp = smem // (itemsize + 1)
        if num_groups <= per_warp:
            tile_g = num_groups
            warps = min(MAX_WARPS, smem // (num_groups * (itemsize + 1)))
        else:
            tile_g = -(-num_groups // -(-num_groups // per_warp))
            warps = 1
    step = warps * 32
    blocks = max(1, min(sms, -(-n // step)))
    chunk_rows = -(-(-(-max(n, 1) // blocks)) // step) * step
    blocks = max(1, -(-n // chunk_rows))
    share = blocks * MAX_WARPS * 32 // num_groups
    fold_lanes = 1 << min(5, share.bit_length() - 1) if share else 1
    return warps, tile_g, lane_parts, blocks, chunk_rows, fold_lanes


@functools.lru_cache(maxsize=1024)
def query_tiles(n: int, num_groups: int, itemsize: int, sms: int, smem: int,
                queries: int) -> tuple[int, int]:
    """(tile, passes) of a launch of `queries` queries: the launch sweeps
    the rows `passes` times, each sweep serving `tile` queries (the last
    the rest), and reads the ids, and shared values, once a sweep.

    The tile is chosen from one query's `geometry`, which does not take
    Q, so every query keeps the row partition, route and fold of its
    solo launch: as many queries as keep their partials side by side in
    `smem` (with `lane_parts` warps * tile_g * 32 values each, otherwise
    warps * tile_g values each plus the warps' tag bytes once, which the
    queries use in turn), at least 1; then the queries are spread evenly
    over the fewest passes.  A pure function of its arguments."""
    warps, tile_g, lane_parts, _, _, _ = geometry(n, num_groups, itemsize, sms, smem)
    if lane_parts:
        fit = smem // (warps * tile_g * 32 * itemsize)
    else:
        fit = (smem - warps * tile_g) // (warps * tile_g * itemsize)
    passes = -(-queries // max(1, fit))
    return max(1, -(-queries // max(1, passes))), passes


_LIB = None
_LIMITS: dict = {}


def _library():
    """The kernel library's entry points with their C signatures
    declared (pointers and the stream as c_void_p, so ctypes does not
    cut them to 32 bits)."""
    global _LIB
    if _LIB is None:
        lib = _cuda.load("hash_agg")
        lib.df_grouped_reduce_limits.restype = ctypes.c_int
        lib.df_grouped_reduce_limits.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        fn = lib.df_grouped_reduce
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
    return _LIB


def _limits(index: int) -> tuple[int, int]:
    """(SM count, dynamic shared memory bytes per block the kernel is
    granted) of the current device, read once per device."""
    lim = _LIMITS.get(index)
    if lim is None:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        rc = _library().df_grouped_reduce_limits(ctypes.byref(sms), ctypes.byref(smem))
        if rc != 0:
            raise ExecutionError(f"grouped_reduce: device query failed: CUDA error {rc}")
        lim = _LIMITS[index] = (sms.value, smem.value)
    return lim


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


def _check_multi(ids, vals, live, num_groups: int, kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown reduce kind {kind!r}")
    if not isinstance(num_groups, int) or num_groups < 1:
        raise ValueError(f"num_groups must be a positive int, got {num_groups!r}")
    tensor = torch.Tensor
    if not (isinstance(ids, tensor) and isinstance(vals, tensor) and isinstance(live, tensor)
            and ids.dim() == 1 and live.dim() == 2 and vals.dim() in (1, 2)):
        raise ValueError("ids must be [N], vals [N] or [Q, N] and live [Q, N]")
    n = ids.shape[0]
    q = live.shape[0]
    if live.shape[1] != n or vals.shape[-1] != n or (vals.dim() == 2 and vals.shape[0] != q):
        raise ValueError(f"ids {tuple(ids.shape)}, vals {tuple(vals.shape)} and live "
                         f"{tuple(live.shape)} do not agree")
    dev = ids.device
    if vals.device != dev or live.device != dev:
        raise ValueError(f"ids, vals and live are on {dev}, {vals.device} and {live.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if live.dtype != torch.bool:
        raise ValueError(f"live must be bool, got {live.dtype}")


def grouped_reduce_multi_torch(ids, vals, live, num_groups: int, kind: str):
    """Plain PyTorch version of the query axis: query q's rows keyed
    q * G + id in one reduction over Q x N rows.  Returns [Q, G]."""
    _check_multi(ids, vals, live, num_groups, kind)
    q, n = live.shape
    out = torch.full((q * num_groups,), _identity(kind, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    sel = (live & ((ids >= 0) & (ids < num_groups))).reshape(-1)
    offset = torch.arange(q, dtype=torch.int64, device=ids.device)[:, None] * num_groups
    idx = (ids.long()[None, :] + offset).reshape(-1)[sel]
    v = vals.expand(q, n).reshape(-1)[sel]
    if kind == "sum":
        out.index_add_(0, idx, v)
    else:
        out.scatter_reduce_(0, idx, v, "amin" if kind == "min" else "amax")
    return out.view(q, num_groups)


def _launch(ids, vals, live, num_groups: int, kind: str):
    """Run the kernel on the inputs' device: one cooperative launch for
    one query (`live` [N]; returns [G]) or for the Q = live.shape[0]
    queries of `live` [Q, N] (at most MAX_QUERIES; returns [Q, G])."""
    global LAUNCHES, MULTI_LAUNCHES
    dtype = _DTYPE_CODES.get(vals.dtype)
    if dtype is None:
        raise ExecutionError(f"grouped_reduce kernel does not take {vals.dtype}")
    if not (ids.is_contiguous() and vals.is_contiguous() and live.is_contiguous()):
        raise ExecutionError("grouped_reduce kernel needs contiguous ids, vals and live")
    dev = vals.device
    current = torch.cuda.current_device()
    if dev.index is not None and dev.index != current:
        with torch.cuda.device(dev):
            return _launch(ids, vals, live, num_groups, kind)
    q = 1 if live.dim() == 1 else live.shape[0]
    n = ids.shape[0]
    lib = _library()
    limits = _limits(current)
    itemsize = vals.element_size()
    warps, tile_g, lane_parts, blocks, chunk_rows, fold_lanes = geometry(
        n, num_groups, itemsize, *limits)
    tile, _ = query_tiles(n, num_groups, itemsize, *limits, q)
    # the Q results, then Q rows of partials per block: one allocation
    buf = torch.empty(q * (1 + blocks) * num_groups, dtype=vals.dtype, device=dev)
    rc = lib.df_grouped_reduce(
        dtype, _KINDS[kind], ids.data_ptr(), vals.data_ptr(), n if vals.dim() == 2 else 0,
        live.data_ptr(), n, q, tile, num_groups, tile_g, warps, lane_parts, blocks,
        chunk_rows, fold_lanes, buf.data_ptr(), _cuda.raw_stream(dev))
    if rc != 0:
        raise ExecutionError(f"grouped_reduce kernel launch failed: CUDA error {rc}")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
        MULTI_LAUNCHES += int(q > 1)
    out = buf.resize_(q * num_groups)
    return out if live.dim() == 1 else out.view(q, num_groups)


def grouped_reduce_multi(ids, vals, live, num_groups: int, kind: str):
    """Q grouped reductions over one set of dense int32 `ids` [N]:
    query q reduces `vals[q]` (or the shared `vals` [N]) over the rows
    `live[q]` keeps, with `grouped_reduce`'s semantics.  Returns a
    [Q, num_groups] tensor of vals.dtype; on a CUDA device each row is
    bit-identical to that query's own `grouped_reduce`.  A call of more
    than MAX_QUERIES queries launches once per MAX_QUERIES."""
    _check_multi(ids, vals, live, num_groups, kind)
    if ids.device.type == "cpu":
        return grouped_reduce_multi_torch(ids, vals, live, num_groups, kind)
    if ids.device.type != "cuda":
        raise ExecutionError(f"grouped_reduce_multi runs on cuda or cpu, not {ids.device}")
    q = live.shape[0]
    if q <= MAX_QUERIES:
        return _launch(ids, vals, live, num_groups, kind)
    parts = [_launch(ids, vals if vals.dim() == 1 else vals[lo:lo + MAX_QUERIES],
                     live[lo:lo + MAX_QUERIES], num_groups, kind)
             for lo in range(0, q, MAX_QUERIES)]
    return torch.cat(parts)
