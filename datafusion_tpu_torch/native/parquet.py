"""Parquet files through the native reader (`native/parquet.cpp`).

The C++ side reads the footer, the flat schema and the pages of the
projected column chunks (PLAIN and dictionary encodings, definition
levels, UNCOMPRESSED and SNAPPY); see its header comment for what it
reads and what raises.  This module binds it with ctypes on the
pattern of `native/csv.py`.  Each row group decodes straight into
numpy arrays this module allocates (one chunk per thread on the C
side), and batches are slices of them, so no value is copied twice; a
Utf8 column's local dictionary (its row group's dictionary page, then
first appearances in PLAIN pages) goes into the reader's global
`StringDictionary` through `merge_codes`, as the JAX package's pyarrow
reader merges each batch's dictionary
(`datafusion_tpu/io/readers.py:33-95`).

`ParquetFile.fields` describe the file's top-level fields with the
type string pyarrow's `schema_arrow` gives them (the Arrow schema a
writer may store under `ARROW:schema` is not read), so schema
inference and its errors match the JAX package's.  DATE, TIMESTAMP and
INT96 columns read as Utf8 become the ISO strings of pyarrow's cast to
string.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import ExecutionError, IoError
from datafusion_tpu_torch.exec.batch import StringDictionary
from datafusion_tpu_torch.native import load_library
from datafusion_tpu_torch.native.csv import _view

# parquet.thrift: physical types, and the LogicalType union's field ids
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
L_STRING, L_ENUM, L_DECIMAL, L_DATE, L_TIME, L_TIMESTAMP = 1, 4, 5, 6, 7, 8
L_INTEGER, L_UNKNOWN, L_JSON, L_BSON, L_UUID, L_FLOAT16 = 10, 11, 12, 13, 14, 15
_UNITS = {1: "ms", 2: "us", 3: "ns"}
# ConvertedType -> (logical kind, a, b) as parquet-cpp reads a legacy
# annotation (DECIMAL takes its scale and precision from the element)
_CONVERTED = {
    0: (L_STRING, 0, 0), 4: (L_ENUM, 0, 0), 6: (L_DATE, 0, 0),
    7: (L_TIME, 1, 1), 8: (L_TIME, 2, 1), 9: (L_TIMESTAMP, 1, 1), 10: (L_TIMESTAMP, 2, 1),
    11: (L_INTEGER, 8, 0), 12: (L_INTEGER, 16, 0), 13: (L_INTEGER, 32, 0),
    14: (L_INTEGER, 64, 0), 15: (L_INTEGER, 8, 1), 16: (L_INTEGER, 16, 1),
    17: (L_INTEGER, 32, 1), 18: (L_INTEGER, 64, 1), 19: (L_JSON, 0, 0), 20: (L_BSON, 0, 0),
}
# the C side's value layout per physical type
_PHYSICAL_DTYPE = {
    BOOLEAN: np.dtype(np.uint8), INT32: np.dtype(np.int32), INT64: np.dtype(np.int64),
    INT96: np.dtype(np.int64), FLOAT: np.dtype(np.float32), DOUBLE: np.dtype(np.float64),
    BYTE_ARRAY: np.dtype(np.int32),
}


def _configure(lib) -> None:
    """Declare the `dtf_pq_*` entry points (once per library)."""
    if getattr(lib, "_dtf_pq_configured", False):
        return
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sigs = {
        "dtf_pq_open": (vp, [ctypes.c_char_p]),
        "dtf_pq_error": (ctypes.c_char_p, [vp]),
        "dtf_pq_num_row_groups": (i32, [vp]),
        "dtf_pq_num_fields": (i32, [vp]),
        "dtf_pq_field_name": (vp, [vp, i32, ctypes.POINTER(i32)]),
        "dtf_pq_field_info": (None, [vp, i32, ctypes.POINTER(i32)]),
        "dtf_pq_select": (i32, [vp, i32, ctypes.POINTER(i32)]),
        "dtf_pq_row_group_rows": (i64, [vp, i32]),
        "dtf_pq_read_row_group": (i32, [vp, i32, ctypes.POINTER(vp), ctypes.POINTER(vp)]),
        "dtf_pq_dict_size": (i32, [vp, i32]),
        "dtf_pq_dict_blob": (vp, [vp, i32]),
        "dtf_pq_dict_offsets": (vp, [vp, i32]),
        "dtf_pq_close": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    lib._dtf_pq_configured = True


@dataclass(frozen=True)
class ParquetField:
    """One top-level field of a Parquet file's schema."""

    name: str
    nested: bool  # a group or a REPEATED field: not read
    physical: int
    repetition: int  # 0 REQUIRED, 1 OPTIONAL, 2 REPEATED
    converted: int
    logical: int
    lt_a: int
    lt_b: int
    type_length: int
    scale: int
    precision: int

    @property
    def nullable(self) -> bool:
        return self.repetition != 0

    def _logical(self):
        """(kind, a, b, from a legacy annotation)."""
        if self.logical >= 0:
            return self.logical, self.lt_a, self.lt_b, False
        if self.converted == 5:
            return L_DECIMAL, self.scale, self.precision, True
        kind, a, b = _CONVERTED.get(self.converted, (-1, 0, 0))
        return kind, a, b, True

    @property
    def arrow_type(self) -> str:
        """The type string pyarrow's `schema_arrow` gives this field."""
        if self.nested:
            return "list" if self.repetition == 2 else "struct"
        kind, a, b, legacy = self._logical()
        p = self.physical
        if kind == L_UNKNOWN:
            return "null"
        if kind == L_DECIMAL:
            return f"decimal128({b}, {a})"
        if p == BOOLEAN:
            return "bool"
        if kind in (L_TIME, L_TIMESTAMP) and a not in _UNITS:
            return f"a time unit {a} pyarrow does not read"
        if p in (INT32, INT64):
            if kind == L_INTEGER:
                return f"{'' if b else 'u'}int{a}"
            if kind == L_DATE and p == INT32:
                return "date32[day]"
            if kind == L_TIME:
                return f"time{32 if p == INT32 else 64}[{_UNITS[a]}]"
            if kind == L_TIMESTAMP and p == INT64:
                # a legacy TIMESTAMP_* annotation reads without a zone
                tz = ", tz=UTC" if b and not legacy else ""
                return f"timestamp[{_UNITS[a]}{tz}]"
            if kind < 0:
                return "int32" if p == INT32 else "int64"
        if p == INT96:
            return "timestamp[ns]"
        if p == FLOAT and kind < 0:
            return "float"
        if p == DOUBLE and kind < 0:
            return "double"
        if p == BYTE_ARRAY:
            return "string" if kind in (L_STRING, L_JSON) else "binary"
        if p == FIXED_LEN_BYTE_ARRAY:
            if kind == L_FLOAT16:
                return "halffloat"
            return f"fixed_size_binary[{16 if kind == L_UUID else self.type_length}]"
        return f"physical type {p} with logical type {kind}"

    def temporal(self) -> Optional[tuple[str, bool]]:
        """(numpy unit, UTC) of a DATE, TIMESTAMP or INT96 column, else
        None: these read as Utf8 become ISO strings."""
        t = self.arrow_type
        if t == "date32[day]":
            return "D", False
        if t.startswith("timestamp["):
            return t[10:12].rstrip(",]"), t.endswith("tz=UTC]")
        return None


class ParquetFile:
    """An open Parquet file (the footer read, no page yet) and its
    top-level fields.  Close it, or use it in a `with`."""

    def __init__(self, path: str):
        self.lib = load_library()
        _configure(self.lib)
        self.path = path
        self._h = self.lib.dtf_pq_open(path.encode())
        if not self._h:
            raise IoError(f"cannot open Parquet {path!r}: out of memory")
        err = self.lib.dtf_pq_error(self._h)
        if err:
            self.close()
            raise IoError(f"cannot open Parquet {path!r}: {err.decode(errors='replace')}")
        self.fields = [self._field(i) for i in range(self.lib.dtf_pq_num_fields(self._h))]

    def _field(self, i: int) -> ParquetField:
        ln = ctypes.c_int32()
        ptr = self.lib.dtf_pq_field_name(self._h, i, ctypes.byref(ln))
        info = (ctypes.c_int32 * 10)()
        self.lib.dtf_pq_field_info(self._h, i, info)
        name = ctypes.string_at(ptr, ln.value).decode("utf-8", errors="replace")
        nested, *rest = info
        return ParquetField(name, bool(nested), *rest)

    def close(self) -> None:
        if self._h:
            self.lib.dtf_pq_close(self._h)
            self._h = None

    def __enter__(self) -> "ParquetFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _error(self) -> str:
        err = self.lib.dtf_pq_error(self._h)
        return err.decode(errors="replace") if err else "read error"

    def batches(
        self, out_schema: Schema, batch_size: int, dicts: Sequence[Optional[StringDictionary]]
    ) -> Iterator[tuple[int, list[np.ndarray], list[Optional[np.ndarray]]]]:
        """(rows, columns, validity) per batch of the fields `out_schema`
        names, each column in its field's engine dtype (Utf8 as codes
        into `dicts`), NULLs as 0 (False), validity None where a batch
        holds no NULL."""
        by_name = {f.name: i for i, f in enumerate(self.fields)}
        picks, plans = [], []
        for field in out_schema.fields:
            if field.name not in by_name:
                raise IoError(f"Parquet {self.path!r} has no column {field.name!r}")
            src = self.fields[by_name[field.name]]
            if src.nested:
                raise ExecutionError(
                    f"unsupported parquet type {src.arrow_type!r} for column {src.name!r}")
            picks.append(by_name[field.name])
            plans.append(_plan(src, field.data_type))
        lib, h = self.lib, self._h
        k = len(picks)
        if lib.dtf_pq_select(h, k, (ctypes.c_int32 * k)(*picks)) != 0:
            raise IoError(f"cannot read Parquet {self.path!r}: {self._error()}")
        seen: list = [None] * k  # per Utf8 column: its last (dictionary, code map)
        for rg in range(lib.dtf_pq_num_row_groups(h)):
            rows = lib.dtf_pq_row_group_rows(h, rg)
            if rows <= 0:
                continue
            # the row group decodes straight into these arrays; batches
            # are slices of them
            try:
                raws = [np.empty(rows, _PHYSICAL_DTYPE[src.physical]) for src, _, _ in plans]
                valids = [np.empty(rows, np.uint8) if src.nullable else None
                          for src, _, _ in plans]
            except MemoryError as e:
                raise IoError(f"Parquet {self.path!r}: row group {rg} of {rows} rows does "
                              "not fit in memory") from e
            ptrs = (ctypes.c_void_p * k)(*[a.ctypes.data for a in raws])
            vptrs = (ctypes.c_void_p * k)(*[0 if v is None else v.ctypes.data
                                            for v in valids])
            if lib.dtf_pq_read_row_group(h, rg, ptrs, vptrs) != 0:
                raise IoError(f"cannot read Parquet {self.path!r}: {self._error()}")
            luts = [self._local_dictionary(j, src, dicts[j], seen) if kind == "codes" else None
                    for j, (src, _, kind) in enumerate(plans)]
            for lo in range(0, rows, batch_size):
                hi = min(rows, lo + batch_size)
                cols, out_valid = [], []
                for j, (src, dt, kind) in enumerate(plans):
                    valid = None if valids[j] is None else valids[j][lo:hi].view(bool)
                    if valid is not None and valid.all():
                        valid = None
                    raw = raws[j][lo:hi]
                    if kind == "codes":
                        arr = luts[j][raw] if len(luts[j]) else raw.copy()
                    elif kind == "temporal":
                        arr = _temporal_codes(raw, valid, src.temporal(), dicts[j])
                    elif kind == "bool":
                        arr = raw.view(bool)
                    else:
                        arr = raw.astype(dt.np_dtype, copy=False)
                    if valid is not None and kind in ("codes", "temporal"):
                        arr[~valid] = 0
                    cols.append(arr)
                    out_valid.append(valid)
                yield hi - lo, cols, out_valid

    def _local_dictionary(self, j: int, src: ParquetField, d: StringDictionary,
                          seen: list) -> np.ndarray:
        """Local code -> global code for column j's last row group read,
        its strings merged into `d` in local order (a dictionary equal to
        the previous row group's reuses its map: merging it again would
        add nothing)."""
        lib, h = self.lib, self._h
        size = lib.dtf_pq_dict_size(h, j)
        if size == 0:
            return np.empty(0, np.int32)
        offs = _view(lib.dtf_pq_dict_offsets(h, j), size + 1, np.dtype(np.int64))
        blob = ctypes.string_at(lib.dtf_pq_dict_blob(h, j), int(offs[-1]))
        key = (blob, offs.tobytes())
        if seen[j] is not None and seen[j][0] == key:
            return seen[j][1]
        values = [blob[offs[k]:offs[k + 1]] for k in range(size)]
        if src.arrow_type == "string":
            try:
                values = [v.decode("utf-8") for v in values]
            except UnicodeDecodeError as e:
                raise IoError(f"Parquet {self.path!r}: column {src.name!r} holds invalid "
                              f"UTF-8: {e}") from e
        lut = d.merge_codes(np.arange(size, dtype=np.int32), values)
        seen[j] = (key, lut)
        return lut


def _plan(src: ParquetField, dt: DataType) -> tuple[ParquetField, DataType, str]:
    """How a file field becomes a column of engine type `dt`."""
    if dt == DataType.UTF8:
        if src.physical == BYTE_ARRAY and src.arrow_type in ("string", "binary"):
            return src, dt, "codes"
        if src.temporal() is not None:
            return src, dt, "temporal"
    elif src.physical in _PHYSICAL_DTYPE and src.physical != BYTE_ARRAY:
        return src, dt, "bool" if dt == DataType.BOOLEAN and src.physical == BOOLEAN else "cast"
    raise ExecutionError(
        f"cannot read parquet column {src.name!r} of type {src.arrow_type!r} as {dt.name}")


def _temporal_codes(raw: np.ndarray, valid: Optional[np.ndarray], how, d: StringDictionary):
    """A DATE / TIMESTAMP batch as codes into `d`: its distinct valid
    values formatted as pyarrow's cast to string formats them, added in
    order of first appearance (pyarrow's per-batch dictionary_encode)."""
    unit, utc = how
    vals = raw if valid is None else raw[valid]
    codes = np.zeros(len(raw), np.int32)
    if len(vals) == 0:
        return codes
    uniq, first, inv = np.unique(vals, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    text = np.datetime_as_string(uniq[order].astype(f"M8[{unit}]"), unit=unit)
    strings = [s.replace("T", " ") + ("Z" if utc else "") for s in text.tolist()]
    merged = d.merge_codes(rank[inv.reshape(-1)], strings)
    if valid is None:
        return merged
    codes[valid] = merged
    return codes
