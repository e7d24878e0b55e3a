"""The Arrow schema a Parquet writer stores in the footer.

pyarrow (and parquet-cpp) store the table's Arrow schema under the
key-value metadata key `ARROW:schema`: base64 of an Arrow IPC message,
an optional `0xFFFFFFFF` continuation marker, an int32 length, then a
flatbuffer `Message` whose header is a `Schema` (Arrow's
`format/Message.fbs` and `format/Schema.fbs`).  This module decodes it
with a flatbuffer reader of its own: every offset, length and vtable
slot is checked against the buffer, and a malformed value raises
`IoError`, never an `IndexError` or a read past the end.

`decode_arrow_schema` gives the top-level fields: name, nullable, the
type as pyarrow's `str(type)` spells it, the dictionary encoding and the
children.  `apply_origin` is parquet-cpp's `ApplyOriginalMetadata` for a
flat field: given the type inferred from the Parquet annotations and the
stored field, the type `schema_arrow` reports.
"""

from __future__ import annotations

import base64
import binascii
import struct
from dataclasses import dataclass, field
from typing import Optional

from datafusion_tpu_torch.errors import IoError

# Schema.fbs: the Type union's members
_NULL, _INT, _FLOAT, _BINARY, _UTF8, _BOOL, _DECIMAL, _DATE, _TIME, _TIMESTAMP = range(1, 11)
_INTERVAL, _LIST, _STRUCT, _UNION, _FIXED_BINARY, _FIXED_LIST, _MAP, _DURATION = range(11, 19)
_LARGE_BINARY, _LARGE_UTF8, _LARGE_LIST, _RUN_END, _BINARY_VIEW, _UTF8_VIEW = range(19, 25)
_LIST_VIEW, _LARGE_LIST_VIEW = 25, 26
_UNITS = ("s", "ms", "us", "ns")
_SIMPLE = {_NULL: "null", _BINARY: "binary", _UTF8: "string", _BOOL: "bool",
           _LARGE_BINARY: "large_binary", _LARGE_UTF8: "large_string",
           _BINARY_VIEW: "binary_view", _UTF8_VIEW: "string_view"}
_NESTED = {_LIST: "list", _STRUCT: "struct", _UNION: "union", _FIXED_LIST: "fixed_size_list",
           _MAP: "map", _LARGE_LIST: "large_list", _RUN_END: "run_end_encoded",
           _LIST_VIEW: "list_view", _LARGE_LIST_VIEW: "large_list_view"}
_MAX_DEPTH = 64


class _Malformed(Exception):
    pass


@dataclass(frozen=True)
class ArrowField:
    """One field of a stored Arrow schema."""

    name: str
    nullable: bool
    type: str  # pyarrow's str() of the value type
    kind: int  # the Type union member
    tz: Optional[str] = None  # a Timestamp's zone
    index_type: Optional[str] = None  # set for a dictionary-encoded field
    ordered: bool = False
    children: tuple = field(default=())

    @property
    def dictionary(self) -> bool:
        return self.index_type is not None


class _Flatbuffer:
    """Bounds-checked reads of a flatbuffer's tables, strings and vectors."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def _read(self, fmt: str, pos: int):
        size = struct.calcsize(fmt)
        if pos < 0 or pos + size > len(self.buf):
            raise _Malformed(f"offset {pos} outside the {len(self.buf)}-byte message")
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def ref(self, pos: int) -> int:
        """The object a uoffset at `pos` points to."""
        return pos + self._read("<I", pos)

    def table(self, pos: int) -> tuple[int, int, int]:
        """(table position, vtable position, vtable slots)."""
        vt = pos - self._read("<i", pos)
        vlen = self._read("<H", vt)
        if vlen < 4 or vlen % 2:
            raise _Malformed("bad vtable")
        self._read(f"<{vlen}s", vt)  # the whole vtable lies inside the buffer
        return pos, vt, (vlen - 4) // 2

    def slot(self, table, i: int) -> Optional[int]:
        """The position of field i of `table`, None when absent."""
        pos, vt, n = table
        if i >= n:
            return None
        off = self._read("<H", vt + 4 + 2 * i)
        return pos + off if off else None

    def scalar(self, table, i: int, fmt: str, default):
        at = self.slot(table, i)
        return default if at is None else self._read(fmt, at)

    def subtable(self, table, i: int):
        at = self.slot(table, i)
        return None if at is None else self.table(self.ref(at))

    def string(self, table, i: int) -> Optional[str]:
        at = self.slot(table, i)
        if at is None:
            return None
        s = self.ref(at)
        n = self._read("<I", s)
        raw = self._read(f"<{n}s", s + 4)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise _Malformed(f"a name that is not UTF-8: {e}") from e

    def tables(self, table, i: int) -> list:
        """A vector of tables."""
        at = self.slot(table, i)
        if at is None:
            return []
        v = self.ref(at)
        n = self._read("<I", v)
        if n > (len(self.buf) - v) // 4:
            raise _Malformed("vector longer than the message")
        return [self.table(self.ref(v + 4 + 4 * k)) for k in range(n)]


def _int_name(fb: _Flatbuffer, t) -> str:
    bits = fb.scalar(t, 0, "<i", 0)
    signed = fb.scalar(t, 1, "<?", False)
    if bits not in (8, 16, 32, 64):
        raise _Malformed(f"integer of {bits} bits")
    return f"{'' if signed else 'u'}int{bits}"


def _unit(fb: _Flatbuffer, t, i: int, default: int) -> str:
    u = fb.scalar(t, i, "<h", default)
    if not 0 <= u < 4:
        raise _Malformed(f"time unit {u}")
    return _UNITS[u]


def _type(fb: _Flatbuffer, kind: int, t) -> tuple[str, Optional[str]]:
    """(pyarrow's name of a Type union member, a Timestamp's zone)."""
    if kind in _SIMPLE:
        return _SIMPLE[kind], None
    if kind in _NESTED:
        return _NESTED[kind], None
    if t is None:
        raise _Malformed(f"type {kind} without its table")
    if kind == _INT:
        return _int_name(fb, t), None
    if kind == _FLOAT:
        p = fb.scalar(t, 0, "<h", 0)
        if not 0 <= p < 3:
            raise _Malformed(f"float precision {p}")
        return ("halffloat", "float", "double")[p], None
    if kind == _DECIMAL:
        precision, scale = fb.scalar(t, 0, "<i", 0), fb.scalar(t, 1, "<i", 0)
        bits = fb.scalar(t, 2, "<i", 128)
        return f"decimal{bits}({precision}, {scale})", None
    if kind == _DATE:
        return ("date32[day]", "date64[ms]")[fb.scalar(t, 0, "<h", 1) != 0], None
    if kind == _TIME:
        return f"time{fb.scalar(t, 1, '<i', 32)}[{_unit(fb, t, 0, 1)}]", None
    if kind == _TIMESTAMP:
        unit, tz = _unit(fb, t, 0, 0), fb.string(t, 1)
        return (f"timestamp[{unit}, tz={tz}]" if tz else f"timestamp[{unit}]"), tz or None
    if kind == _DURATION:
        return f"duration[{_unit(fb, t, 0, 1)}]", None
    if kind == _INTERVAL:
        u = fb.scalar(t, 0, "<h", 0)
        names = ("month_interval", "day_time_interval", "month_day_nano_interval")
        if not 0 <= u < 3:
            raise _Malformed(f"interval unit {u}")
        return names[u], None
    if kind == _FIXED_BINARY:
        return f"fixed_size_binary[{fb.scalar(t, 0, '<i', 0)}]", None
    raise _Malformed(f"unknown type {kind}")


def _field(fb: _Flatbuffer, t, depth: int) -> ArrowField:
    if depth > _MAX_DEPTH:
        raise _Malformed("fields nested too deep")
    name = fb.string(t, 0) or ""
    nullable = bool(fb.scalar(t, 1, "<?", False))
    kind = fb.scalar(t, 2, "<B", 0)
    type_name, tz = _type(fb, kind, fb.subtable(t, 3))
    index_type, ordered = None, False
    d = fb.subtable(t, 4)
    if d is not None:
        it = fb.subtable(d, 1)
        index_type = "int32" if it is None else _int_name(fb, it)
        ordered = bool(fb.scalar(d, 2, "<?", False))
    children = tuple(_field(fb, c, depth + 1) for c in fb.tables(t, 5))
    return ArrowField(name, nullable, type_name, kind, tz, index_type, ordered, children)


def decode_arrow_schema(value: bytes) -> list[ArrowField]:
    """The top-level fields of a stored `ARROW:schema` value; IoError
    when it is not base64 of a schema message."""
    try:
        msg = base64.b64decode(value, validate=True)
    except (binascii.Error, ValueError) as e:
        raise IoError(f"bad ARROW:schema in the footer: not base64 ({e})") from e
    try:
        start = 8 if msg[:4] == b"\xff\xff\xff\xff" else 4
        if len(msg) < start:
            raise _Malformed("shorter than its length prefix")
        length = struct.unpack_from("<i", msg, start - 4)[0]
        if length <= 0 or start + length > len(msg):
            raise _Malformed(f"message length {length} for {len(msg) - start} bytes")
        fb = _Flatbuffer(msg[start:start + length])
        message = fb.table(fb.ref(0))
        if fb.scalar(message, 1, "<B", 0) != 1:
            raise _Malformed("the message holds no schema")
        schema = fb.subtable(message, 2)
        if schema is None:
            raise _Malformed("the message holds no schema")
        return [_field(fb, f, 0) for f in fb.tables(schema, 1)]
    except _Malformed as e:
        raise IoError(f"bad ARROW:schema in the footer: {e}") from e


def apply_origin(inferred: str, origin: ArrowField) -> str:
    """The type pyarrow's `schema_arrow` gives a flat field whose Parquet
    annotations map to `inferred`, given its stored Arrow field
    (parquet-cpp's ApplyOriginalMetadata): a stored zone replaces UTC
    (the unit stays the file's), a duration its int64, a dictionary
    wraps string and binary (its index type and order kept), and the
    large and view string and binary types come back; anything else
    keeps the inferred type."""
    out = inferred
    if origin.kind == _TIMESTAMP and inferred.startswith("timestamp["):
        if inferred.endswith(", tz=UTC]") and origin.tz:
            out = f"{inferred[:inferred.index(',')]}, tz={origin.tz}]"
    elif origin.kind == _DURATION and inferred == "int64":
        out = origin.type
    if origin.dictionary and inferred in ("string", "binary"):
        return (f"dictionary<values={inferred}, indices={origin.index_type}, "
                f"ordered={int(origin.ordered)}>")
    if (origin.kind in (_LARGE_BINARY, _BINARY_VIEW) and inferred == "binary") or (
            origin.kind in (_LARGE_UTF8, _UTF8_VIEW) and inferred == "string"):
        out = origin.type
    return out
