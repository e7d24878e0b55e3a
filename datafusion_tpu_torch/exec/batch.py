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

from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import ExecutionError

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
    recomputed only when the dictionary has grown.
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

    def code_of(self, s: str) -> int:
        """Code for `s`, or -1 if absent (a -1 never equals any row)."""
        return self.index.get(s, -1)

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

    def decode(self, codes: np.ndarray) -> np.ndarray:
        arr = np.asarray(self.values, dtype=object)
        return arr[codes]

    def compare_table(self, op, literal: str) -> np.ndarray:
        """Bool table t where t[code] == (values[code] <op> literal).

        Ordered comparisons on dictionary codes are meaningless (codes
        are append-ordered), so the host materializes this table and
        the device gathers from it.  Lexicographic order means ISO
        dates compare chronologically (the TPC-H shipdate filter).
        """
        vals = self.values
        if op == "<":
            return np.array([v < literal for v in vals], dtype=bool)
        if op == "<=":
            return np.array([v <= literal for v in vals], dtype=bool)
        if op == ">":
            return np.array([v > literal for v in vals], dtype=bool)
        if op == ">=":
            return np.array([v >= literal for v in vals], dtype=bool)
        raise ExecutionError(f"unsupported string comparison {op!r}")

    def sort_ranks(self) -> np.ndarray:
        """rank[code] = position of values[code] in sorted order."""
        order = np.argsort(np.asarray(self.values, dtype=object), kind="stable")
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


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on `device`.  On a CUDA device the
    copy goes through pinned memory and is asynchronous on the current
    stream (the pinned buffer stays reserved by PyTorch's host
    allocator until the copy has run); on the CPU it is a view."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(x) -> np.ndarray:
    """A column, validity or mask as a numpy array, whether it is a
    host array or a tensor on any device (one device-to-host copy)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def on_device(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor on `device`; a tensor
    already there passes through."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return to_device(np.asarray(x), device)


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
