"""Carry a table from the JAX package into this port.

The JAX package holds no weights: its state is the data its tables
hold.  `memory_source` rebuilds a table from that data as plain numpy
and JSON — `Schema.to_json()`, and for each batch its padded columns,
validity masks, row mask, string dictionary values and `num_rows` —
into this port's `MemoryDataSource`, with the same codes, dictionaries
and padding.  `export_batch` reads those arrays off a batch of either
package (it touches only the attributes both share), so nothing of the
JAX package is imported here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.batch import RecordBatch, StringDictionary
from datafusion_tpu_torch.exec.datasource import MemoryDataSource


def export_batch(batch) -> dict:
    """A batch's host arrays: {"columns", "validity", "mask", "dicts",
    "num_rows"}; "dicts" holds each Utf8 column's dictionary values (a
    list of str) or None."""
    return {
        "columns": [np.asarray(c) for c in batch.data],
        "validity": [None if v is None else np.asarray(v) for v in batch.validity],
        "mask": None if batch.mask is None else np.asarray(batch.mask),
        "dicts": [None if d is None else list(d.values) for d in batch.dicts],
        "num_rows": int(batch.num_rows),
    }


def _merge_dictionary(d: StringDictionary, values: list, column: int) -> None:
    """Grow `d` to `values`.  Dictionaries are append-only, so a later
    batch's values must extend an earlier batch's: same codes, same
    strings."""
    n = min(len(d.values), len(values))
    if d.values[:n] != list(values[:n]):
        raise ExecutionError(
            f"column {column}: dictionary values disagree between batches"
        )
    for s in values[n:]:
        d.add(s)


def memory_source(schema_json: dict, batches: list[dict]) -> MemoryDataSource:
    """This port's MemoryDataSource from the JAX package's host arrays
    (see `export_batch` for each batch's keys).  Every Utf8 column gets
    one StringDictionary shared by all batches, as a scan builds it."""
    schema = Schema.from_json(schema_json)
    ncols = len(schema)
    shared: list[Optional[StringDictionary]] = [None] * ncols
    for b in batches:
        for i, values in enumerate(b["dicts"]):
            if values is None:
                continue
            if shared[i] is None:
                shared[i] = StringDictionary()
            _merge_dictionary(shared[i], values, i)
    out = []
    for b in batches:
        if len(b["columns"]) != ncols:
            raise ExecutionError(
                f"batch has {len(b['columns'])} columns, schema has {ncols}"
            )
        out.append(RecordBatch(
            schema,
            [np.ascontiguousarray(c) for c in b["columns"]],
            [None if v is None else np.ascontiguousarray(v, dtype=bool)
             for v in b["validity"]],
            [None if v is None else shared[i] for i, v in enumerate(b["dicts"])],
            num_rows=b["num_rows"],
            mask=None if b["mask"] is None else np.ascontiguousarray(b["mask"], dtype=bool),
        ))
    return MemoryDataSource(schema, out)
