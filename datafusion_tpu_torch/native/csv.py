"""Schema-driven CSV reader over the native C++ parser.

The counterpart of the JAX package's `native/csv.py`
(`NativeCsvReader`): the parse runs in C++ (`native/datafusion_native.cpp`),
which yields, per batch, typed column buffers, a validity byte per row
(empty fields are NULL) and, for each Utf8 column, codes into an
append-only string table of its own.  Those codes remap into the
reader's `StringDictionary`s in first-seen order, so a re-scan and the
JAX package's readers give the same codes.  A projection parses only
the columns it names (the parser's `active` mask).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import IoError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    StringDictionary,
    make_host_batch,
    pin_dict_versions,
)
from datafusion_tpu_torch.native import load_library
from datafusion_tpu_torch.utils.metrics import METRICS

# the parser's column type codes (datafusion_native.cpp ColType)
_TYPE_CODE = {
    "Boolean": 0, "Int8": 1, "Int16": 2, "Int32": 3, "Int64": 4,
    "UInt8": 5, "UInt16": 6, "UInt32": 7, "UInt64": 8,
    "Float32": 9, "Float64": 10, "Utf8": 11,
}


def _view(ptr: int, n: int, dtype: np.dtype) -> np.ndarray:
    """A copy of n values of `dtype` at address `ptr`."""
    nbytes = n * dtype.itemsize
    buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
    return np.frombuffer(buf, dtype=np.uint8, count=nbytes).view(dtype).copy()


class NativeCsvReader:
    """Typed batches of a CSV file: `out_schema` is the projected
    schema; Utf8 columns keep one dictionary each across every scan
    of this reader."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        has_header: bool,
        batch_size: int,
        projection: Optional[Sequence[int]] = None,
    ):
        self.lib = load_library()
        self.path = path
        self.schema = schema
        self.has_header = has_header
        self.batch_size = batch_size
        self.projection = list(projection) if projection is not None else None
        self._out_cols = (
            list(range(len(schema))) if self.projection is None else self.projection
        )
        self.out_schema = schema.select(self._out_cols)
        self.dicts: list[Optional[StringDictionary]] = [
            StringDictionary() if f.data_type == DataType.UTF8 else None
            for f in self.out_schema.fields
        ]

    def batches(self) -> Iterator[RecordBatch]:
        """The file's batches; producing them counts in the `scan.parse`
        timer (the "decode" phase)."""
        return METRICS.timed_iter("scan.parse", self._batches())

    def _batches(self) -> Iterator[RecordBatch]:
        lib = self.lib
        n_all = len(self.schema)
        types = (ctypes.c_int32 * n_all)(
            *[_TYPE_CODE[f.data_type.name] for f in self.schema.fields]
        )
        active = None
        if self.projection is not None:
            flags = [0] * n_all
            for i in self._out_cols:
                flags[i] = 1
            active = (ctypes.c_uint8 * n_all)(*flags)
        handle = lib.dtf_csv_open(
            self.path.encode(), n_all, types, int(self.has_header),
            self.batch_size, active,
        )
        try:
            err = lib.dtf_csv_error(handle)
            if err:
                raise IoError(f"native csv: {err.decode()}")
            # per Utf8 column: parser code -> dictionary code, grown as
            # the parser's append-only table grows
            luts = [np.empty(0, np.int32) for _ in self._out_cols]
            while True:
                n = lib.dtf_csv_next(handle)
                if n < 0:
                    err = lib.dtf_csv_error(handle)
                    raise IoError(
                        f"native csv {self.path!r}: "
                        f"{err.decode() if err else 'parse error'}"
                    )
                if n == 0:
                    return
                cols, valids = [], []
                for out_i, src_i in enumerate(self._out_cols):
                    dt = self.schema.field(src_i).data_type
                    arr = _view(lib.dtf_csv_col_data(handle, src_i), n, dt.np_dtype)
                    vptr = lib.dtf_csv_col_validity(handle, src_i)
                    valid = None
                    if vptr:
                        valid = _view(vptr, n, np.dtype(np.uint8)).astype(bool)
                        if valid.all():
                            valid = None
                    d = self.dicts[out_i]
                    if d is not None:
                        luts[out_i] = self._grow_lut(handle, src_i, d, luts[out_i])
                        arr = luts[out_i][arr] if len(luts[out_i]) else arr
                        if valid is not None:
                            arr[~valid] = 0
                    cols.append(arr)
                    valids.append(valid)
                batch = make_host_batch(self.out_schema, cols, valids, list(self.dicts))
                pin_dict_versions(batch)  # before the next batch grows them
                yield batch
        finally:
            lib.dtf_csv_close(handle)

    def _grow_lut(self, handle, src_i: int, d: StringDictionary,
                  lut: np.ndarray) -> np.ndarray:
        """Extend a column's code map with the parser's new strings."""
        size = self.lib.dtf_csv_dict_size(handle, src_i)
        if size == len(lut):
            return lut
        ln = ctypes.c_int32()
        new = []
        for j in range(len(lut), size):
            ptr = self.lib.dtf_csv_dict_value(handle, src_i, j, ctypes.byref(ln))
            new.append(d.add(ctypes.string_at(ptr, ln.value).decode("utf-8")))
        return np.concatenate([lut, np.asarray(new, np.int32)])
