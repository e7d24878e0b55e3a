"""DataSource protocol, the in-memory source and the file sources.

Mirrors the JAX package's `exec/datasource.py`.  A DataSource is
re-iterable (each `batches()` call restarts the scan) and
projection-aware.  Sources: in memory, CSV (over the native C++
parser, datafusion_tpu_torch/native), NDJSON and Parquet
(io/readers.py; Parquet needs pyarrow, which the card's machine lacks:
there it raises IoError).
"""

from __future__ import annotations

import itertools
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.exec.batch import RecordBatch

# identities of in-memory sources: never reused in a process (an id()
# is, once its object is collected), so a fingerprint holding one
# cannot match another table's data
_SOURCE_IDS = itertools.count(1)


def host_bytes(batches) -> int:
    """Bytes of the numpy columns and validity of `batches`."""
    total = 0
    for b in batches:
        for arr in list(b.data) + list(b.validity):
            if isinstance(arr, np.ndarray):
                total += arr.nbytes
    return total


class DataSource:
    """Base: schema + re-iterable batches.

    - `parses`: whether `batches` parses its input as it reads, work the
      prefetch threads can run ahead of the consumer
      (`exec/prefetch.pipeline_enabled`);
    - `data_version`: bumped when the data changes (an
      `ingest.AppendableSource` bumps it per append; other sources keep
      0), and part of `data_identity`, so a result built before an
      append never serves after it;
    - `estimated_bytes()`: what the table would occupy pinned on the
      device (0 when unknown: admission never sheds for it);
    - `data_identity`: a hashable identity of the data itself, which a
      fingerprint of a result built from it holds (serve.py's pins,
      join/relation.py's pinned builds);
    - `to_meta()`: the source's wire description (the JAX package's
      `DataSourceMeta` JSON, reference `datasource.rs:70-85`), which a
      plan fragment ships to a worker (parallel/physical.py); a source
      with no file behind it raises PlanError."""

    parses = False
    data_version = 0

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[RecordBatch]:
        raise NotImplementedError

    def with_projection(self, projection: Sequence[int]) -> "DataSource":
        raise NotImplementedError

    def estimated_bytes(self) -> int:
        return 0

    def to_meta(self) -> dict:
        raise PlanError(f"{type(self).__name__} is not serializable")

    @property
    def data_identity(self) -> tuple:
        ident = self.__dict__.get("_identity")
        if ident is None:
            ident = self.__dict__["_identity"] = next(_SOURCE_IDS)
        return (type(self).__name__, ident, self.data_version)

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

    def estimated_bytes(self) -> int:
        return host_bytes(self._batches)

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


class FileDataSource(DataSource):
    """A file read through a reader that keeps its own dictionaries.
    `schema` is the projected schema; re-scans read the file again and
    keep the reader's dictionaries, so codes are stable."""

    parses = True

    @property
    def schema(self) -> Schema:
        return self._reader.out_schema

    def batches(self) -> Iterator[RecordBatch]:
        return self._reader.batches()

    def estimated_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    @property
    def data_identity(self) -> tuple:
        """The source's own identity (its reader's dictionaries code the
        strings), the file's path, size and modification time: a file
        rewritten in place is other data."""
        try:
            st = os.stat(self.path)
            stamp = (st.st_size, st.st_mtime_ns)
        except OSError:
            stamp = None
        return super().data_identity + (self.path, stamp)


class CsvDataSource(FileDataSource):
    """A CSV file (reference `datasource.rs:31-50`), read by the native
    parser."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        has_header: bool = True,
        batch_size: int = 131072,
        projection: Optional[Sequence[int]] = None,
    ):
        from datafusion_tpu_torch.native.csv import NativeCsvReader

        self.path = path
        self.table_schema = schema
        self.has_header = has_header
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self._reader = NativeCsvReader(path, schema, has_header, batch_size,
                                       self.projection)

    def with_projection(self, projection: Sequence[int]) -> "CsvDataSource":
        return CsvDataSource(self.path, self.table_schema, self.has_header,
                             self.batch_size, projection)

    def to_meta(self) -> dict:
        return {"CsvFile": {"filename": self.path, "schema": self.table_schema.to_json(),
                            "has_header": self.has_header, "projection": self.projection}}


class NdJsonDataSource(FileDataSource):
    """A newline-delimited JSON file (io/readers.NdJsonReader)."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        batch_size: int = 131072,
        projection: Optional[Sequence[int]] = None,
    ):
        from datafusion_tpu_torch.io.readers import NdJsonReader

        self.path = path
        self.table_schema = schema
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self._reader = NdJsonReader(path, schema, batch_size, self.projection)

    def with_projection(self, projection: Sequence[int]) -> "NdJsonDataSource":
        return NdJsonDataSource(self.path, self.table_schema, self.batch_size, projection)

    def to_meta(self) -> dict:
        return {"NdJsonFile": {"filename": self.path, "schema": self.table_schema.to_json(),
                               "projection": self.projection}}


class ParquetDataSource(FileDataSource):
    """A Parquet file (io/readers.ParquetReader); with no `schema` the
    file's metadata gives it."""

    def __init__(
        self,
        path: str,
        schema: Optional[Schema] = None,
        batch_size: int = 131072,
        projection: Optional[Sequence[int]] = None,
    ):
        from datafusion_tpu_torch.io.readers import ParquetReader, infer_parquet_schema

        self.path = path
        self.table_schema = schema if schema is not None else infer_parquet_schema(path)
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self._reader = ParquetReader(path, self.table_schema, batch_size, self.projection)

    def with_projection(self, projection: Sequence[int]) -> "ParquetDataSource":
        return ParquetDataSource(self.path, self.table_schema, self.batch_size, projection)

    def to_meta(self) -> dict:
        return {"ParquetFile": {"filename": self.path, "schema": self.table_schema.to_json(),
                                "projection": self.projection}}
