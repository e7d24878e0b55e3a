"""CSV, NDJSON and Parquet batch readers.

The counterpart of the JAX package's `io/readers.py`.  Each reader
yields `RecordBatch`es of up to `batch_size` rows for a schema-driven
typed parse, carrying validity masks and global string dictionaries;
`projection` restricts which columns are parsed at all.  Batches come
from `make_host_batch` and pin their dictionaries' versions where they
leave the reader (`batch.pin_dict_versions`).

CSV is read by the port's own parser (`native/csv.cpp` through
`native/csv.py`), which reads what the JAX package's default pyarrow
reader reads, in the same batches and dictionary order, parsing blocks
on the host's threads as pyarrow does.  Parquet is read by the port's own
native reader (`native/parquet.py`), so no pyarrow is needed here or on
the card's machine: pages UNCOMPRESSED or compressed with SNAPPY, GZIP,
ZSTD, LZ4_RAW or LZ4 (BROTLI and LZO raise IoError), and the Arrow
schema a writer stores in the footer, which names each field's type as
pyarrow's `schema_arrow` does (a timestamp's zone, a dictionary, a
duration).  NDJSON is plain Python.  Each CSV, Parquet and NDJSON
batch passes the `io.read` fault site (`testing/faults.py`) and counts
in `scan.rows`, as in the JAX package.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.errors import ExecutionError, IoError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    StringDictionary,
    make_host_batch,
    pin_dict_versions,
)
from datafusion_tpu_torch.native.csv import NativeCsvReader
from datafusion_tpu_torch.native.parquet import ParquetFile
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS

DEFAULT_BATCH_SIZE = 131072


def _project_schema(schema: Schema, projection: Optional[Sequence[int]]) -> Schema:
    return schema if projection is None else schema.select(list(projection))


def _batch(schema: Schema, columns, validity, dicts) -> RecordBatch:
    batch = make_host_batch(schema, columns, validity, list(dicts))
    pin_dict_versions(batch)  # before the next batch grows them
    return batch


class CsvReader(NativeCsvReader):
    """Schema-driven typed CSV reader: the counterpart of the JAX
    package's default reader, over the port's own parser.  Batches of
    exactly `batch_size` rows (the last holds the rest); `threads` parse
    blocks at once (default: the host's CPU count)."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        has_header: bool,
        batch_size: int = DEFAULT_BATCH_SIZE,
        projection: Optional[Sequence[int]] = None,
        threads: Optional[int] = None,
        block_size: Optional[int] = None,
    ):
        # the JAX package's CsvReader signature, with its default batch size
        super().__init__(path, schema, has_header, batch_size, projection, threads,
                         block_size)

    def _batches(self) -> Iterator[RecordBatch]:
        for batch in super()._batches():
            faults.check("io.read", path=self.path, format="csv")
            METRICS.add("scan.rows", batch.num_rows)
            yield batch


class NdJsonReader:
    """Newline-delimited JSON, one object a line; a missing key or a
    JSON null is NULL."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        batch_size: int = DEFAULT_BATCH_SIZE,
        projection: Optional[Sequence[int]] = None,
    ):
        self.path = path
        self.schema = schema
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self.out_schema = _project_schema(schema, projection)
        self.dicts: list[Optional[StringDictionary]] = [
            StringDictionary() if f.data_type == DataType.UTF8 else None
            for f in self.out_schema.fields
        ]

    def batches(self) -> Iterator[RecordBatch]:
        yield from METRICS.timed_iter("scan.parse", self._batches())

    def _batches(self) -> Iterator[RecordBatch]:
        try:
            f = open(self.path, "r", encoding="utf-8")
        except OSError as e:
            raise IoError(f"cannot open NDJSON {self.path!r}: {e}") from e
        with f:
            rows: list[dict] = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError as e:
                    raise IoError(f"bad NDJSON line in {self.path!r}: {e}") from e
                if len(rows) >= self.batch_size:
                    yield self._rows_to_batch(rows)
                    rows = []
            if rows:
                yield self._rows_to_batch(rows)

    def _rows_to_batch(self, rows: list[dict]) -> RecordBatch:
        faults.check("io.read", path=self.path, format="ndjson")
        METRICS.add("scan.rows", len(rows))
        columns: list[np.ndarray] = []
        validity: list[Optional[np.ndarray]] = []
        for i, field in enumerate(self.out_schema.fields):
            raw = [r.get(field.name) for r in rows]
            isnull = np.fromiter((v is None for v in raw), dtype=bool, count=len(raw))
            if field.data_type == DataType.UTF8:
                columns.append(self.dicts[i].encode(raw))
            else:
                filled = [0 if v is None else v for v in raw]
                columns.append(np.asarray(filled).astype(field.data_type.np_dtype))
            validity.append(None if not isnull.any() else ~isnull)
        return _batch(self.out_schema, columns, validity, self.dicts)


class ParquetReader:
    """A Parquet file through the native reader (`native/parquet.py`
    over `native/parquet.cpp`), on the card's machine as here: no
    pyarrow.  Batches of at most `batch_size` rows never span a row
    group; Utf8 columns keep one dictionary each across every scan of
    this reader, holding what the JAX package's pyarrow reader holds,
    in its order."""

    def __init__(
        self,
        path: str,
        schema: Optional[Schema] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
        projection: Optional[Sequence[int]] = None,
    ):
        self.path = path
        self.schema = schema if schema is not None else infer_parquet_schema(path)
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self.out_schema = _project_schema(self.schema, projection)
        self.dicts: list[Optional[StringDictionary]] = [
            StringDictionary() if f.data_type == DataType.UTF8 else None
            for f in self.out_schema.fields
        ]

    def batches(self) -> Iterator[RecordBatch]:
        yield from METRICS.timed_iter("scan.parse", self._batches())

    def _batches(self) -> Iterator[RecordBatch]:
        with ParquetFile(self.path) as pf:
            for n, columns, validity in pf.batches(self.out_schema, self.batch_size,
                                                   self.dicts):
                faults.check("io.read", path=self.path, format="parquet")
                METRICS.add("scan.rows", n)
                yield _batch(self.out_schema, columns, validity, self.dicts)


_PARQUET_TYPES = {
    "bool": DataType.BOOLEAN,
    "int8": DataType.INT8,
    "int16": DataType.INT16,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
    "uint8": DataType.UINT8,
    "uint16": DataType.UINT16,
    "uint32": DataType.UINT32,
    "uint64": DataType.UINT64,
    "float": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "string": DataType.UTF8,
    "large_string": DataType.UTF8,
}


def infer_parquet_schema(path: str) -> Schema:
    """Derive an engine Schema from Parquet file metadata: each field's
    type as pyarrow's `schema_arrow` names it, then the JAX package's
    mapping (`datafusion_tpu/io/readers.py:317-350`)."""
    with ParquetFile(path) as pf:
        fields = []
        for f in pf.fields:
            t = f.arrow_type
            if t.startswith("timestamp") or t.startswith("date"):
                dt = DataType.UTF8  # dates travel as ISO strings (order-preserving)
            elif t in _PARQUET_TYPES:
                dt = _PARQUET_TYPES[t]
            else:
                raise ExecutionError(f"unsupported parquet type {t!r} for column {f.name!r}")
            fields.append(Field(f.name, dt, f.nullable))
    return Schema(fields)
