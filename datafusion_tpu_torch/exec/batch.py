"""Columnar batches on the host and their copies on the device.

Batches are the JAX package's layout (`datafusion_tpu/exec/batch.py`):

- **fixed-capacity and padded**: capacity is bucketed to a power of two;
- **validity-masked**: nulls are bool arrays (None = all valid);
- **selection-masked**: an upstream filter's row mask rides the batch;
- **dictionary-encoded for strings**: Utf8 columns hold int32 codes into
  a global, append-only `StringDictionary`, so codes are stable across
  batches and GROUP BY keys stay consistent for the whole scan.

Scanned batches hold numpy arrays.  `device_inputs` copies the
columns a kernel reads to the device as torch tensors: from pinned host
memory with `non_blocking=True` on a CUDA device, as zero-copy views on
the CPU.  A batch may also hold tensors already on the device (the
dense join probe yields such batches): `device_inputs` passes those
through, and `to_host` brings any column or mask back as numpy.  The
JAX package's wire codec, f64-pair split and link probes are not
ported (ROADMAP queue 1, "wire codec").
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.obs.device import LEDGER, note_h2d, profile_sync_active, record_d2h
from datafusion_tpu_torch.utils.metrics import stage_enter, stage_exit

MIN_CAPACITY = 1024


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (floor MIN_CAPACITY)."""
    cap = MIN_CAPACITY
    while cap < n:
        cap <<= 1
    return cap


class StringDictionary:
    """Global append-only string dictionary for one Utf8 column.

    `version` (== len) keys the host-side caches derived from the
    dictionary: comparison lookup tables and sort-rank tables are
    recomputed only when the dictionary has grown.  Those tables can be
    built over the first `n` strings alone (the dictionary as it stood
    at version `n`), so a thread that stages a batch while a reader
    still appends builds the same table as a serial scan would
    (`dict_versions`).
    """

    __slots__ = ("values", "index", "cmp_cache")

    def __init__(self):
        self.values: list[str] = []
        self.index: dict[str, int] = {}
        # derived tables keyed by use, each stored with the version it
        # was built at (host compare tables, join content hashes)
        self.cmp_cache: dict = {}

    @property
    def version(self) -> int:
        return len(self.values)

    def add(self, s: str) -> int:
        code = self.index.get(s)
        if code is None:
            code = len(self.values)
            self.values.append(s)
            self.index[s] = code
        return code

    def code_of(self, s: str, n: Optional[int] = None) -> int:
        """Code for `s` among the first `n` strings (all by default), or
        -1 if absent (a -1 never equals any row)."""
        code = self.index.get(s, -1)
        return code if n is None or code < n else -1

    def encode(self, strings) -> np.ndarray:
        """Encode a sequence of python strings (None for null) to int32
        codes; nulls encode as 0 (callers carry validity)."""
        obj = np.asarray(strings, dtype=object)
        isnull = np.fromiter((s is None for s in obj), dtype=bool, count=len(obj))
        if isnull.any():
            obj = obj.copy()
            obj[isnull] = ""
        uniq, inv = np.unique(obj.astype(str), return_inverse=True)
        lut = np.fromiter(
            (self.add(s) for s in uniq), dtype=np.int32, count=len(uniq)
        )
        codes = lut[inv].astype(np.int32)
        codes[isnull] = 0
        return codes

    def merge_codes(self, codes: np.ndarray, values: Sequence[str]) -> np.ndarray:
        """Remap codes expressed in a local dictionary `values` (a
        pyarrow per-batch dictionary) into this global dictionary."""
        lut = np.fromiter(
            (self.add(v) for v in values), dtype=np.int32, count=len(values)
        )
        if len(lut) == 0:
            return codes.astype(np.int32)
        return lut[codes].astype(np.int32)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        arr = np.asarray(self.values, dtype=object)
        return arr[codes]

    def compare_table(self, op, literal: str, n: Optional[int] = None) -> np.ndarray:
        """Bool table t where t[code] == (values[code] <op> literal), over
        the first `n` strings (all by default).

        Ordered comparisons on dictionary codes are meaningless (codes
        are append-ordered), so the host materializes this table and
        the device gathers from it.  Lexicographic order means ISO
        dates compare chronologically (the TPC-H shipdate filter).
        """
        vals = self.values if n is None else self.values[:n]
        if op == "<":
            return np.array([v < literal for v in vals], dtype=bool)
        if op == "<=":
            return np.array([v <= literal for v in vals], dtype=bool)
        if op == ">":
            return np.array([v > literal for v in vals], dtype=bool)
        if op == ">=":
            return np.array([v >= literal for v in vals], dtype=bool)
        raise ExecutionError(f"unsupported string comparison {op!r}")

    def sort_ranks(self, n: Optional[int] = None) -> np.ndarray:
        """rank[code] = position of values[code] in sorted order, over
        the first `n` strings (all by default)."""
        vals = self.values if n is None else self.values[:n]
        order = np.argsort(np.asarray(vals, dtype=object), kind="stable")
        ranks = np.empty(len(order), dtype=np.int32)
        ranks[order] = np.arange(len(order), dtype=np.int32)
        return ranks


class RecordBatch:
    """A padded columnar batch.

    `data[i]` is a numpy array or a torch tensor of length `capacity`;
    rows at index >= num_rows are padding.  `validity[i]` is a bool
    array (None = all valid).  `mask` is the row-selection mask
    produced by upstream filters (None = all rows live).  Utf8 columns store int32 codes and
    their StringDictionary in `dicts[i]`.  `cache` holds values derived
    from the batch (device copies, group ids) and dies with it.
    """

    __slots__ = ("schema", "data", "validity", "dicts", "num_rows", "mask",
                 "cache")

    def __init__(
        self,
        schema: Schema,
        data: list,
        validity: Optional[list] = None,
        dicts: Optional[list] = None,
        num_rows: Optional[int] = None,
        mask=None,
    ):
        self.schema = schema
        self.data = data
        self.validity = validity if validity is not None else [None] * len(data)
        self.dicts = dicts if dicts is not None else [None] * len(data)
        self.num_rows = num_rows if num_rows is not None else (len(data[0]) if data else 0)
        self.mask = mask
        self.cache: dict = {}

    @property
    def num_columns(self) -> int:
        return len(self.data)

    @property
    def capacity(self) -> int:
        return int(self.data[0].shape[0]) if self.data else 0


def dict_versions(batch: RecordBatch) -> tuple:
    """Each column's dictionary version for tables built for this batch
    (None for a column without a dictionary): the versions pinned on
    the batch, else the dictionaries' own."""
    pinned = batch.cache.get("dict_versions")
    if pinned is not None:
        return pinned
    return tuple(None if d is None else d.version for d in batch.dicts)


def pin_dict_versions(batch: RecordBatch, versions=None) -> None:
    """Pin on the batch the version of each of its dictionaries:
    `versions` where an operator carries them over from its input,
    else the dictionaries' versions now, unless the batch has them.

    A reader appends to its dictionaries while later batches parse, and
    the prefetch threads (`exec/prefetch.staged_pipeline`) build a
    batch's tables while the reader runs ahead.  Tables built at the
    versions pinned where the batch left its source are the ones a
    serial scan builds, so the tables' identities, and with them the
    fold's batch groups and its float sums, do not depend on thread
    timing.  The CSV reader pins each batch it yields; operators that
    hand a dictionary on (the pipeline, the join) carry the pins."""
    if versions is not None:
        if any(v is not None for v in versions):
            batch.cache["dict_versions"] = tuple(versions)
    elif "dict_versions" not in batch.cache and any(d is not None for d in batch.dicts):
        batch.cache["dict_versions"] = dict_versions(batch)


# host unsigned dtypes and their device containers (DataType.torch_dtype):
# uint16 and uint32 widen by value, uint64 is an int64 bit view
_WIDEN = {np.dtype(np.uint16): np.dtype(np.int32),
          np.dtype(np.uint32): np.dtype(np.int64),
          np.dtype(np.uint64): np.dtype(np.int64)}


def device_array(arr: np.ndarray) -> np.ndarray:
    """A host array in the dtype its device tensor holds: unsigned
    columns wider than 8 bits widen (uint64 as a bit view)."""
    wide = _WIDEN.get(arr.dtype)
    if wide is None:
        return arr
    if wide.itemsize == arr.dtype.itemsize:
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        return arr.view(wide)
    return arr.astype(wide)


def host_array(arr: np.ndarray, np_dtype) -> np.ndarray:
    """A host array pulled from the device, back in its column's numpy
    dtype: the inverse of `device_array` for unsigned columns (uint16
    and uint32 narrow, uint64 is viewed back); other dtypes pass."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind != "u" or arr.dtype == np_dtype:
        return arr
    if arr.dtype.itemsize == np_dtype.itemsize:
        return arr.view(np_dtype)
    return arr.astype(np_dtype)


def to_device(arr: np.ndarray, device: torch.device, owner: str = "batch") -> torch.Tensor:
    """One host array as a tensor on `device` (unsigned columns in
    their device dtype, `device_array`).  On a CUDA device the copy
    goes through pinned memory and is asynchronous on the current
    stream (the pinned buffer stays reserved by PyTorch's host
    allocator until the copy has run; inside `obs/device.profile_sync`
    the copy is waited for, so the `h2d` phase is the copy's time); on
    the CPU it is a view.

    Every call counts one `device.h2d.transfers` and its bytes in
    `h2d.bytes` (utils/metrics.py), on the CPU too, where the copy is
    a view, so a test there sees what a run on the card would send; the
    tensor registers in the device ledger under `owner`."""
    t = torch.from_numpy(np.ascontiguousarray(device_array(np.asarray(arr))))
    tok = stage_enter("h2d.dispatch")
    t0 = time.perf_counter()
    try:
        if device.type != "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
            if profile_sync_active():
                torch.cuda.current_stream(device).synchronize()
    finally:
        stage_exit(tok)
    note_h2d(t.numel() * t.element_size(), time.perf_counter() - t0)
    LEDGER.adopt(t, owner)
    return t


def to_host(x, np_dtype=None) -> np.ndarray:
    """A column, validity or mask as a numpy array, whether it is a
    host array or a tensor on any device (one device-to-host copy,
    counted in `d2h.bytes` and the `d2h.wait` timer).  With
    `np_dtype`, a device tensor of an unsigned column comes back in
    that dtype (`host_array`)."""
    if isinstance(x, torch.Tensor):
        tok = stage_enter("d2h.wait")
        t0 = time.perf_counter()
        try:
            out = x.cpu().numpy()
        finally:
            stage_exit(tok)
        record_d2h(out.nbytes, time.perf_counter() - t0)
        return out if np_dtype is None else host_array(out, np_dtype)
    return np.asarray(x)


def on_device(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor on `device`; a tensor
    already there passes through."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return to_device(np.asarray(x), device)


def param_tensors(values, device: torch.device) -> tuple:
    """A core's runtime literal values (numpy scalars,
    exec/kernels.parameterize_exprs) as 0-dim tensors on `device`, in
    their device dtypes."""
    return tuple(
        torch.from_numpy(device_array(np.asarray(v)).copy()).to(device)
        for v in values
    )


def device_inputs(batch: RecordBatch, device: torch.device):
    """(data, validity, mask) of `batch` as tensors on `device`, cached
    on the batch: a re-scanned in-memory batch crosses to the device
    once, not once per query run."""
    key = ("device", str(device))
    hit = batch.cache.get(key)
    if hit is not None:
        return hit
    data = tuple(on_device(c, device) for c in batch.data)
    validity = tuple(
        None if v is None else on_device(v, device) for v in batch.validity
    )
    mask = None if batch.mask is None else on_device(batch.mask, device)
    out = (data, validity, mask)
    batch.cache[key] = out
    return out


def subset_view(batch: RecordBatch, cols: Sequence[int]) -> RecordBatch:
    """A view batch holding only `cols`, cached on the parent batch so
    device copies made against the view survive re-scans of in-memory
    sources (device_inputs caches on the view object)."""
    if len(cols) == batch.num_columns:
        return batch
    key = ("subset_view", tuple(cols))
    hit = batch.cache.get(key)
    if hit is None:
        hit = RecordBatch(
            batch.schema.select(list(cols)),
            [batch.data[c] for c in cols],
            [batch.validity[c] for c in cols],
            [batch.dicts[c] for c in cols],
            num_rows=batch.num_rows,
            mask=batch.mask,
        )
        batch.cache[key] = hit
    return hit


def pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a 1-D host array with zeros up to `capacity`."""
    n = len(arr)
    if n == capacity:
        return np.ascontiguousarray(arr)
    if n > capacity:
        raise ExecutionError(f"batch of {n} rows exceeds capacity {capacity}")
    out = np.zeros(capacity, dtype=arr.dtype)
    out[:n] = arr
    return out


def make_host_batch(
    schema: Schema,
    columns: list[np.ndarray],
    validity: Optional[list[Optional[np.ndarray]]] = None,
    dicts: Optional[list[Optional[StringDictionary]]] = None,
) -> RecordBatch:
    """Assemble a RecordBatch from unpadded host columns, padding all of
    them to a common bucketed capacity."""
    if not columns:
        return RecordBatch(schema, [], num_rows=0)
    n = len(columns[0])
    cap = bucket_capacity(n)
    data = [pad_to(np.asarray(c), cap) for c in columns]
    vals: list[Optional[np.ndarray]] = []
    for i in range(len(columns)):
        v = validity[i] if validity is not None else None
        if v is None:
            vals.append(None)
        else:
            pv = np.zeros(cap, dtype=bool)
            pv[:n] = v
            vals.append(pv)
    return RecordBatch(schema, data, vals, dicts, num_rows=n)
