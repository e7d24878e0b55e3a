"""NDJSON and Parquet batch readers.

The counterpart of the JAX package's `io/readers.py`.  Each reader
yields `RecordBatch`es of up to `batch_size` rows for a schema-driven
typed parse, carrying validity masks and global string dictionaries;
`projection` restricts which columns are parsed at all.  Batches come
from `make_host_batch` and pin their dictionaries' versions where they
leave the reader (`batch.pin_dict_versions`), as the CSV reader's do.

CSV is read by the native parser (`native/csv.py`); the JAX package's
pyarrow CSV reader is not ported.  Parquet needs pyarrow, imported only
inside the Parquet functions: where it is missing (the card's machine)
a Parquet table raises IoError naming it.  NDJSON is plain Python.
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
from datafusion_tpu_torch.io.io_thread import confined_iter, run_on_io_thread
from datafusion_tpu_torch.utils.metrics import METRICS

DEFAULT_BATCH_SIZE = 131072


def _project_schema(schema: Schema, projection: Optional[Sequence[int]]) -> Schema:
    return schema if projection is None else schema.select(list(projection))


def _pyarrow():
    """pyarrow and pyarrow.parquet, or IoError when pyarrow is missing."""
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as e:
        raise IoError(f"reading Parquet needs pyarrow, which is not installed: {e}") from e
    return pyarrow, pyarrow.parquet


def _arrow_to_columns(
    table_cols, out_schema: Schema, dicts: list[Optional[StringDictionary]]
):
    """Convert pyarrow chunked arrays to (numpy columns, validity)."""
    pa, _ = _pyarrow()
    columns: list[np.ndarray] = []
    validity: list[Optional[np.ndarray]] = []
    for i, (field, col) in enumerate(zip(out_schema.fields, table_cols)):
        if field.data_type == DataType.UTF8:
            d = dicts[i]
            # strictly per chunk: chunks may carry different local
            # dictionaries, or arrive dictionary-encoded from the file
            code_parts: list[np.ndarray] = []
            null_parts: list[np.ndarray] = []
            for chunk in col.chunks:
                if pa.types.is_dictionary(chunk.type):
                    enc = chunk
                else:
                    c = chunk
                    if not pa.types.is_string(c.type) and not pa.types.is_large_string(c.type):
                        # date and timestamp columns travel as ISO strings
                        c = c.cast(pa.string())
                    enc = c.dictionary_encode()
                idx = enc.indices
                local = idx.fill_null(0).to_numpy(zero_copy_only=False)
                merged = d.merge_codes(local.astype(np.int32), enc.dictionary.to_pylist())
                isnull = idx.is_null().to_numpy(zero_copy_only=False)
                merged[isnull] = 0
                code_parts.append(merged)
                null_parts.append(isnull)
            if not code_parts:
                codes, null_mask = np.empty(0, np.int32), np.empty(0, bool)
            elif len(code_parts) == 1:
                codes, null_mask = code_parts[0], null_parts[0]
            else:
                codes, null_mask = np.concatenate(code_parts), np.concatenate(null_parts)
            columns.append(codes)
        else:
            null_mask = col.is_null().to_numpy(zero_copy_only=False)
            fill = False if pa.types.is_boolean(col.type) else 0
            vals = col.fill_null(fill).to_numpy(zero_copy_only=False)
            columns.append(np.asarray(vals).astype(field.data_type.np_dtype, copy=False))
        validity.append(None if not null_mask.any() else ~null_mask)
    return columns, validity


def _batch(schema: Schema, columns, validity, dicts) -> RecordBatch:
    batch = make_host_batch(schema, columns, validity, list(dicts))
    pin_dict_versions(batch)  # before the next batch grows them
    return batch


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
    """A Parquet file through pyarrow, every call on the confinement
    threads (`io/io_thread.py`)."""

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
        yield from confined_iter(METRICS.timed_iter("scan.parse", self._batches()))

    def _batches(self) -> Iterator[RecordBatch]:
        pa, pq = _pyarrow()
        names = [f.name for f in self.out_schema.fields]
        # Utf8 columns read dictionary-encoded straight off the file
        dict_cols = [f.name for f in self.out_schema.fields if f.data_type == DataType.UTF8]
        try:
            pf = pq.ParquetFile(self.path, read_dictionary=dict_cols)
        except Exception as e:  # noqa: BLE001 — pyarrow raises several types for a bad file
            raise IoError(f"cannot open Parquet {self.path!r}: {e}") from e
        for arrow_batch in pf.iter_batches(batch_size=self.batch_size, columns=names):
            cols = [pa.chunked_array([arrow_batch.column(j)])
                    for j in range(arrow_batch.num_columns)]
            columns, validity = _arrow_to_columns(cols, self.out_schema, self.dicts)
            METRICS.add("scan.rows", arrow_batch.num_rows)
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
    """Derive an engine Schema from Parquet file metadata."""

    def _read_schema(p):
        _, pq = _pyarrow()
        try:
            return pq.ParquetFile(p).schema_arrow
        except Exception as e:  # noqa: BLE001 — pyarrow raises several types for a bad file
            raise IoError(f"cannot open Parquet {p!r}: {e}") from e

    fields = []
    for f in run_on_io_thread(_read_schema, path):
        t = str(f.type)
        if t.startswith("timestamp") or t.startswith("date"):
            dt = DataType.UTF8  # dates travel as ISO strings (order-preserving)
        elif t in _PARQUET_TYPES:
            dt = _PARQUET_TYPES[t]
        else:
            raise ExecutionError(f"unsupported parquet type {t!r} for column {f.name!r}")
        fields.append(Field(f.name, dt, f.nullable))
    return Schema(fields)
