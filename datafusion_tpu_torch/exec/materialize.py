"""Result materialization: batches -> host rows.

The counterpart of the JAX package's `exec/materialize.py`.  Every
batch that reaches this boundary in this slice is a host batch (an
aggregate's state crosses to the host in one copy in
`AggregateRelation.finalize`), so compaction drops padding and
masked-out rows with numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema


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


def collect_columns(relation):
    """Pull every batch of a Relation and concatenate live rows on host.

    Returns (columns, validity, dicts, total_rows); strings stay
    dictionary-coded (dicts[i] holds the decoder).
    """
    schema = relation.schema
    ncols = len(schema)
    parts: list[list[np.ndarray]] = [[] for _ in range(ncols)]
    vparts: list[list[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
    dicts: list = [None] * ncols
    total = 0
    for batch in relation.batches():
        live = np.zeros(batch.capacity, dtype=bool)
        live[: batch.num_rows] = True
        if batch.mask is not None:
            live &= np.asarray(batch.mask)
        total += int(live.sum())
        for i in range(ncols):
            parts[i].append(np.asarray(batch.data[i])[live])
            v = batch.validity[i]
            vparts[i].append(None if v is None else np.asarray(v)[live])
            if batch.dicts[i] is not None:
                dicts[i] = batch.dicts[i]
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
