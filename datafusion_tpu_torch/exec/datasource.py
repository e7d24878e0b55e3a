"""DataSource protocol and the in-memory source.

Mirrors the JAX package's `exec/datasource.py`.  A DataSource is
re-iterable (each `batches()` call restarts the scan) and
projection-aware.  Only the in-memory source is ported: the CSV,
NDJSON and Parquet sources read through pyarrow and wait for their
slice (ROADMAP queue 1, "Parquet and CSV readers").
"""

from __future__ import annotations

from typing import Iterator, Sequence

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.exec.batch import RecordBatch


class DataSource:
    """Base: schema + re-iterable batches."""

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[RecordBatch]:
        raise NotImplementedError

    def with_projection(self, projection: Sequence[int]) -> "DataSource":
        raise NotImplementedError


class MemoryDataSource(DataSource):
    """In-memory source over prebuilt RecordBatches.  Re-scans hand out
    the same batch objects, so device copies cached on them serve every
    later query."""

    def __init__(self, schema: Schema, record_batches: list[RecordBatch]):
        self._schema = schema
        self._batches = list(record_batches)

    @property
    def schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[RecordBatch]:
        return iter(self._batches)

    def with_projection(self, projection: Sequence[int]) -> "DataSource":
        out_schema = self._schema.select(list(projection))
        projected = [
            RecordBatch(
                out_schema,
                [b.data[i] for i in projection],
                [b.validity[i] for i in projection],
                [b.dicts[i] for i in projection],
                num_rows=b.num_rows,
                mask=b.mask,
            )
            for b in self._batches
        ]
        return MemoryDataSource(out_schema, projected)
