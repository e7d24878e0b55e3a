"""Result materialization: batches -> host rows.

The counterpart of the JAX package's `exec/materialize.py`.  A batch
reaching this boundary is a host batch or holds tensors on the device
(the dense join probe's output; a pipeline's computed columns and its
selection mask beside its pass-through host columns; a pipeline's
host-function outputs are already host arrays); `compact_batch` brings
each column to the host, an unsigned one back in its numpy dtype, and
drops padding and masked-out rows.  The JAX package gathers
live rows on the device first and overlaps the copies with the next
batch through an asynchronous pull (`iter_with_mask_prefetch`); here
batches are pulled one at a time, each device column crosses in one
copy and the live rows are selected with numpy (that pipelining is
ROADMAP queue 1, "wire codec").
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.exec.batch import RecordBatch, to_host


def _live_rows(batch: RecordBatch) -> Optional[np.ndarray]:
    """Bool mask of the batch's live rows over its capacity, or None
    when every row below num_rows is live (no selection mask)."""
    if batch.mask is None:
        return None
    live = to_host(batch.mask)[: batch.capacity].astype(bool)
    return live & (np.arange(batch.capacity) < batch.num_rows)


def compact_batch(batch: RecordBatch):
    """Bring a batch to host and drop padding/filtered rows.

    Returns (columns, validity, dicts, num_live_rows); strings stay
    dictionary-coded."""
    live = _live_rows(batch)
    n = batch.num_rows

    def select(a, np_dtype=None):
        a = to_host(a, np_dtype)
        return a[live] if live is not None else a[:n]

    # a device column of an unsigned type comes back in its numpy dtype
    fields = batch.schema.fields
    if len(fields) != len(batch.data):
        fields = [None] * len(batch.data)
    cols = [select(c, None if f is None else f.data_type.np_dtype)
            for c, f in zip(batch.data, fields)]
    valids = [None if v is None else select(v) for v in batch.validity]
    count = int(live.sum()) if live is not None else n
    return cols, valids, list(batch.dicts), count


class ResultTable:
    """A fully-materialized query result (decoded, null-aware)."""

    def __init__(self, schema: Schema, columns: list[np.ndarray],
                 validity: list[Optional[np.ndarray]]):
        self.schema = schema
        self.columns = columns
        self.validity = validity

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def column_values(self, i: int) -> list:
        """Python values for column i, None where null."""
        col = self.columns[i]
        valid = self.validity[i]
        out = col.tolist()
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out

    def to_pylist(self) -> list[dict]:
        names = self.schema.names()
        cols = [self.column_values(i) for i in range(len(names))]
        return [dict(zip(names, row)) for row in zip(*cols)] if cols else []

    def to_rows(self) -> list[tuple]:
        cols = [self.column_values(i) for i in range(len(self.schema))]
        return list(zip(*cols)) if cols else []


def collect_columns(relation, batches=None):
    """Pull every batch of a Relation (or `batches`, an iterator over
    its output) and concatenate live rows on host.

    Returns (columns, validity, dicts, total_rows); strings stay
    dictionary-coded (dicts[i] holds the decoder).

    This is also the result cache's capture point: a root relation that
    `ExecutionContext.execute` tagged with `_result_cache_fill`
    (`cache/result.py`) hands that hook the materialized columns after
    a complete run; caching never changes what this returns.
    """
    t0 = time.perf_counter()
    schema = relation.schema
    ncols = len(schema)
    parts: list[list[np.ndarray]] = [[] for _ in range(ncols)]
    vparts: list[list[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
    dicts: list = [None] * ncols
    total = 0
    for batch in relation.batches() if batches is None else batches:
        cols, valids, bdicts, n = compact_batch(batch)
        total += n
        for i in range(ncols):
            parts[i].append(cols[i])
            vparts[i].append(valids[i])
            if bdicts[i] is not None:
                dicts[i] = bdicts[i]
    columns = []
    validity: list[Optional[np.ndarray]] = []
    for i in range(ncols):
        if parts[i]:
            columns.append(np.concatenate(parts[i]))
        else:
            columns.append(np.empty(0, dtype=schema.field(i).data_type.np_dtype))
        if all(v is None for v in vparts[i]):
            validity.append(None)
        else:
            validity.append(np.concatenate([
                np.ones(len(p), dtype=bool) if v is None else v
                for v, p in zip(vparts[i], parts[i])
            ]))
    fill = getattr(relation, "_result_cache_fill", None)
    if fill is not None:
        fill(columns, validity, dicts, total, time.perf_counter() - t0)
    return columns, validity, dicts, total


def collect(relation) -> ResultTable:
    """Materialize a Relation into a ResultTable (decodes strings)."""
    schema = relation.schema
    columns, validity, dicts, _ = collect_columns(relation)
    decoded = []
    for i in range(len(schema)):
        c = columns[i]
        if schema.field(i).data_type == DataType.UTF8:
            if dicts[i] is not None:
                c = dicts[i].decode(c)
            else:
                c = c.astype(object)
        decoded.append(c)
    return ResultTable(schema, decoded, validity)
