"""Arrow-style type system: DataType, Field, Schema, coercion rules.

Mirrors the reference's use of Arrow datatypes plus its two coercion
tables (`src/logicalplan.rs:443-551` get_supertype,
`src/logicalplan.rs:553-602` can_coerce_from), re-expressed as
width/signedness rules instead of ~100 hand-written match arms.

Device mapping: every DataType carries a numpy dtype used for host
buffers and, through `torch_dtype`, the torch dtype of its device
tensors.  Int64 and Float64 stay 64-bit on the card (Hopper runs f64
natively); unsigned types widen to a signed device dtype.  Utf8 has no tensor representation; string columns are
dictionary-encoded host-side and the device sees int32 codes (see
exec/batch.py).
"""

from __future__ import annotations

from typing import ClassVar, Iterable, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.errors import (
    InvalidColumnError,
    NotSupportedError,
    PlanError,
)


class DataType:
    """A logical column type.

    Primitive types are singletons (``DataType.INT32`` etc.); nested
    struct types are :class:`StructType` instances.  ``repr`` matches the
    reference's Rust ``Debug`` names (``Int32``, ``Utf8``, ...) because
    the planner golden tests assert on plan strings containing them.
    """

    # deliberately shared: the registry of primitive singletons
    _registry: "ClassVar[dict[str, DataType]]" = {}

    def __init__(self, name: str):
        self.name = name
        DataType._registry[name] = self

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return isinstance(other, DataType) and self.name == other.name

    def __hash__(self) -> int:
        return hash(self.name)

    # -- JSON wire format (matches Rust serde: "Utf8" / {"Struct": [...]}) --
    def to_json(self):
        return self.name

    @staticmethod
    def from_json(obj) -> "DataType":
        if isinstance(obj, str):
            try:
                return DataType._registry[obj]
            except KeyError:
                raise PlanError(f"Unknown DataType {obj!r}") from None
        if isinstance(obj, dict) and "Struct" in obj:
            return StructType([Field.from_json(f) for f in obj["Struct"]])
        raise PlanError(f"Cannot deserialize DataType from {obj!r}")

    # -- classification helpers --
    @property
    def is_integer(self) -> bool:
        return self.name in _INT_WIDTH

    @property
    def is_signed_integer(self) -> bool:
        return self.name in _SIGNED

    @property
    def is_unsigned_integer(self) -> bool:
        return self.name in _UNSIGNED

    @property
    def is_float(self) -> bool:
        return self.name in ("Float32", "Float64")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float

    @property
    def width(self) -> int:
        """Bit width for numeric types."""
        return _WIDTH[self.name]

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype used for host buffers and device arrays.

        Utf8 maps to int32: string columns travel as dictionary codes.
        """
        return _NP_DTYPE[self.name]

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype of this type's device tensors.  Int64 and
        Float64 stay 64-bit; Utf8 maps to int32 codes.  torch has no
        arithmetic, compare or reduction on uint16/32/64, so unsigned
        types widen (`_TORCH_DTYPE`): UInt8 stays uint8, UInt16 is
        int32, UInt32 is int64 (both value-preserving), and UInt64 is
        an int64 bit view whose order, MIN and MAX run on the
        sign-flipped image (exec/expression.py, exec/aggregate.py).
        Host buffers keep `np_dtype`; exec/batch.py converts both
        ways."""
        try:
            return _TORCH_DTYPE[self.name]
        except KeyError:
            raise NotSupportedError(f"{self.name} has no device dtype") from None


class StructType(DataType):
    """Nested struct type (reference `DataType::Struct`)."""

    def __init__(self, fields: Sequence["Field"]):
        # deliberately skip DataType.__init__: structs are not singletons
        self.name = "Struct"
        self.fields = list(fields)

    @property
    def np_dtype(self) -> np.dtype:
        # struct columns materialize as their Display strings
        return np.dtype(object)

    def to_json(self):
        return {"Struct": [f.to_json() for f in self.fields]}

    def __eq__(self, other) -> bool:
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(("Struct", tuple((f.name, f.data_type) for f in self.fields)))

    def __repr__(self) -> str:
        return f"Struct({self.fields!r})"


# Primitive singletons
BOOLEAN = DataType("Boolean")
INT8 = DataType("Int8")
INT16 = DataType("Int16")
INT32 = DataType("Int32")
INT64 = DataType("Int64")
UINT8 = DataType("UInt8")
UINT16 = DataType("UInt16")
UINT32 = DataType("UInt32")
UINT64 = DataType("UInt64")
FLOAT32 = DataType("Float32")
FLOAT64 = DataType("Float64")
UTF8 = DataType("Utf8")

# expose as DataType.X for readability at call sites
DataType.BOOLEAN = BOOLEAN
DataType.INT8 = INT8
DataType.INT16 = INT16
DataType.INT32 = INT32
DataType.INT64 = INT64
DataType.UINT8 = UINT8
DataType.UINT16 = UINT16
DataType.UINT32 = UINT32
DataType.UINT64 = UINT64
DataType.FLOAT32 = FLOAT32
DataType.FLOAT64 = FLOAT64
DataType.UTF8 = UTF8

_SIGNED = {"Int8": 8, "Int16": 16, "Int32": 32, "Int64": 64}
_UNSIGNED = {"UInt8": 8, "UInt16": 16, "UInt32": 32, "UInt64": 64}
_INT_WIDTH = {**_SIGNED, **_UNSIGNED}
_WIDTH = {**_INT_WIDTH, "Float32": 32, "Float64": 64, "Boolean": 1}

_NP_DTYPE = {
    "Boolean": np.dtype(np.bool_),
    "Int8": np.dtype(np.int8),
    "Int16": np.dtype(np.int16),
    "Int32": np.dtype(np.int32),
    "Int64": np.dtype(np.int64),
    "UInt8": np.dtype(np.uint8),
    "UInt16": np.dtype(np.uint16),
    "UInt32": np.dtype(np.uint32),
    "UInt64": np.dtype(np.uint64),
    "Float32": np.dtype(np.float32),
    "Float64": np.dtype(np.float64),
    # dictionary codes for strings
    "Utf8": np.dtype(np.int32),
}

_TORCH_DTYPE = {
    "Boolean": torch.bool,
    "Int8": torch.int8,
    "Int16": torch.int16,
    "Int32": torch.int32,
    "Int64": torch.int64,
    "UInt8": torch.uint8,
    "UInt16": torch.int32,
    "UInt32": torch.int64,
    "UInt64": torch.int64,
    "Float32": torch.float32,
    "Float64": torch.float64,
    "Utf8": torch.int32,
}

_BY_NP_KIND = {
    np.dtype(np.bool_): BOOLEAN,
    np.dtype(np.int8): INT8,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
    np.dtype(np.float32): FLOAT32,
    np.dtype(np.float64): FLOAT64,
}


def from_np_dtype(dtype: np.dtype) -> DataType:
    """Map a numpy dtype back to a DataType (strings not invertible)."""
    try:
        return _BY_NP_KIND[np.dtype(dtype)]
    except KeyError:
        raise PlanError(f"No DataType for numpy dtype {dtype!r}") from None


def get_supertype(l: DataType, r: DataType) -> DataType | None:
    """Common supertype two operands are promoted to before a binary op.

    Behavior-equivalent to the reference's explicit pair table
    (`src/logicalplan.rs:443-551`), whose rules compress to:

    - same type -> itself (numerics, Utf8, Boolean)
    - int + int, same signedness -> wider of the two
    - signed + unsigned -> the *signed* type, only when the unsigned
      width <= the signed width (e.g. UInt32+Int32 -> Int32;
      UInt32+Int16 -> None, exactly as the reference table omits it)
    - any int + float -> the float type; Float32+Float64 -> Float64
    - everything else -> None
    """
    if l == r and (l.is_numeric or l in (UTF8, BOOLEAN)):
        return l
    if l.is_integer and r.is_integer:
        if l.is_signed_integer == r.is_signed_integer:
            return l if l.width >= r.width else r
        signed, unsigned = (l, r) if l.is_signed_integer else (r, l)
        if unsigned.width <= signed.width:
            return signed
        return None
    if l.is_float and r.is_numeric or r.is_float and l.is_numeric:
        if l == FLOAT64 or r == FLOAT64:
            return FLOAT64
        if l == FLOAT32 or r == FLOAT32:
            return FLOAT32
    return None


def can_coerce_from(target: DataType, source: DataType) -> bool:
    """Whether `source` implicitly coerces to `target` (lossless widening).

    Behavior-equivalent to `src/logicalplan.rs:553-602`: signed ints
    accept only narrower-or-equal signed ints; unsigned likewise;
    Float32 accepts every int but not Float64; Float64 accepts every
    numeric; Utf8/Boolean/Struct targets accept nothing (even their own
    type — equal types never reach this check because cast_to
    short-circuits them).  Note the deliberate asymmetry with
    get_supertype: a supertype of Int32 can still fail coercion from
    UInt32 (the reference behaves the same way).
    """
    if target.is_signed_integer:
        return source.is_signed_integer and source.width <= target.width
    if target.is_unsigned_integer:
        return source.is_unsigned_integer and source.width <= target.width
    if target == FLOAT32:
        return source.is_integer or source == FLOAT32
    if target == FLOAT64:
        return source.is_numeric
    return False


class Field:
    """A named, typed, nullability-flagged column (Arrow Field)."""

    __slots__ = ("name", "data_type", "nullable")

    def __init__(self, name: str, data_type: DataType, nullable: bool = True):
        self.name = name
        self.data_type = data_type
        self.nullable = nullable

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.data_type!r}, nullable={self.nullable})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Field)
            and self.name == other.name
            and self.data_type == other.data_type
            and self.nullable == other.nullable
        )

    def __hash__(self) -> int:
        return hash((self.name, self.data_type, self.nullable))

    def to_json(self):
        return {
            "name": self.name,
            "data_type": self.data_type.to_json(),
            "nullable": self.nullable,
        }

    @staticmethod
    def from_json(obj) -> "Field":
        try:
            name, dt, nullable = obj["name"], obj["data_type"], obj["nullable"]
        except (TypeError, KeyError):
            raise PlanError(f"Malformed Field wire object: {obj!r}") from None
        return Field(name, DataType.from_json(dt), nullable)


class Schema:
    """An ordered collection of Fields (Arrow Schema).

    Column references in the plan IR are positional (`Expr::Column(i)`,
    reference `logicalplan.rs:135`), so index_of is the catalog's
    name->position seam.
    """

    __slots__ = ("fields", "_index")

    def __init__(self, fields: Iterable[Field]):
        self.fields = list(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __len__(self) -> int:
        return len(self.fields)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:
        return f"Schema({self.fields!r})"

    def field(self, i: int) -> Field:
        if not 0 <= i < len(self.fields):
            raise InvalidColumnError(
                f"column index {i} out of range for schema of {len(self.fields)} fields"
            )
        return self.fields[i]

    def index_of(self, name: str) -> int:
        try:
            return self._index[name]
        except KeyError:
            raise InvalidColumnError(f"no column named {name!r}") from None

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def select(self, indices: Sequence[int]) -> "Schema":
        return Schema([self.field(i) for i in indices])

    def to_json(self):
        return {"fields": [f.to_json() for f in self.fields]}

    @staticmethod
    def from_json(obj) -> "Schema":
        return Schema([Field.from_json(f) for f in obj["fields"]])
