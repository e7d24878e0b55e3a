"""Relational expression IR.

Mirrors the reference's `Expr` / `Operator` / `ScalarValue` /
`FunctionMeta` (`src/logicalplan.rs:25-305`) with the same repr format
(the planner golden tests assert on it: ``#0``, ``Int64(1)``,
``CAST(#3 AS Int64)``, ``#4 Eq Utf8("CO")``, ``MIN(#3)``, ``#0 ASC``)
and the same JSON wire format (serde externally-tagged enums), which is
the plan-shipping contract for distributed mode.

This IR is what the expression compiler (exec/expression.py) lowers to
torch functions per operator — the IR stays backend-neutral; nothing
here touches torch.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence

from datafusion_tpu_torch.datatypes import (
    DataType,
    Field,
    Schema,
    can_coerce_from,
    get_supertype,
)
from datafusion_tpu_torch.errors import PlanError


class Operator(enum.Enum):
    """Binary operators (reference `logicalplan.rs:67-81`)."""

    Eq = "="
    NotEq = "!="
    Lt = "<"
    LtEq = "<="
    Gt = ">"
    GtEq = ">="
    Plus = "+"
    Minus = "-"
    Multiply = "*"
    Divide = "/"
    Modulus = "%"
    And = "AND"
    Or = "OR"

    def __repr__(self) -> str:  # matches Rust Debug: the variant name
        return self.name

    @property
    def is_comparison(self) -> bool:
        return self in (
            Operator.Eq,
            Operator.NotEq,
            Operator.Lt,
            Operator.LtEq,
            Operator.Gt,
            Operator.GtEq,
        )

    @property
    def is_boolean(self) -> bool:
        return self in (Operator.And, Operator.Or)

    def to_json(self):
        return self.name

    @staticmethod
    def from_json(obj) -> "Operator":
        try:
            return Operator[obj]
        except KeyError:
            raise PlanError(f"Unknown Operator {obj!r}") from None


class ScalarValue:
    """A typed scalar constant (reference `logicalplan.rs:93-108`).

    Wire format matches serde: ``{"Int64": 1}``, ``"Null"``.
    Repr matches Rust Debug: ``Int64(1)``, ``Utf8("CO")``,
    ``Boolean(true)``, ``Float64(9.0)``.
    """

    __slots__ = ("data_type", "value")

    def __init__(self, data_type: Optional[DataType], value):
        # data_type None encodes ScalarValue::Null
        self.data_type = data_type
        self.value = value

    # -- constructors --
    @staticmethod
    def null() -> "ScalarValue":
        return ScalarValue(None, None)

    @staticmethod
    def boolean(v: bool) -> "ScalarValue":
        return ScalarValue(DataType.BOOLEAN, bool(v))

    @staticmethod
    def int64(v: int) -> "ScalarValue":
        return ScalarValue(DataType.INT64, int(v))

    @staticmethod
    def float64(v: float) -> "ScalarValue":
        return ScalarValue(DataType.FLOAT64, float(v))

    @staticmethod
    def utf8(v: str) -> "ScalarValue":
        return ScalarValue(DataType.UTF8, str(v))

    @staticmethod
    def of(data_type: DataType, value) -> "ScalarValue":
        return ScalarValue(data_type, value)

    def get_datatype(self) -> DataType:
        if self.data_type is None:
            raise PlanError("ScalarValue::Null has no datatype")
        return self.data_type

    @property
    def is_null(self) -> bool:
        return self.data_type is None

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ScalarValue)
            and self.data_type == other.data_type
            and self.value == other.value
        )

    def __hash__(self) -> int:
        return hash((self.data_type, self.value))

    def __repr__(self) -> str:
        if self.data_type is None:
            return "Null"
        v = self.value
        if self.data_type == DataType.BOOLEAN:
            return f"Boolean({'true' if v else 'false'})"
        if self.data_type == DataType.UTF8:
            escaped = str(v).replace("\\", "\\\\").replace('"', '\\"')
            return f'Utf8("{escaped}")'
        if self.data_type.is_float:
            # Rust Debug always shows a decimal point on floats
            s = repr(float(v))
            return f"{self.data_type.name}({s})"
        return f"{self.data_type.name}({v})"

    def to_json(self):
        if self.data_type is None:
            return "Null"
        return {self.data_type.name: self.value}

    @staticmethod
    def from_json(obj) -> "ScalarValue":
        if obj == "Null":
            return ScalarValue.null()
        if not isinstance(obj, dict) or len(obj) != 1:
            raise PlanError(f"Malformed ScalarValue wire object: {obj!r}")
        ((name, value),) = obj.items()
        return ScalarValue(DataType.from_json(name), value)


class Expr:
    """Base class for relational expressions (reference `Expr` enum,
    `logicalplan.rs:133-164`)."""

    __slots__ = ()

    # -- type inference (reference Expr::get_type, logicalplan.rs:167-195) --
    def get_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    # -- implicit-cast insertion (reference Expr::cast_to, :197-212) --
    def cast_to(self, cast_to_type: DataType, schema: Schema) -> "Expr":
        this_type = self.get_type(schema)
        if this_type == cast_to_type:
            return self
        if can_coerce_from(cast_to_type, this_type):
            return Cast(self, cast_to_type)
        raise PlanError(
            f"Cannot automatically convert {this_type!r} to {cast_to_type!r}"
        )

    # -- fluent constructors (reference :214-261; the DataFrame-API seed) --
    def _bin(self, op: Operator, other: "Expr") -> "BinaryExpr":
        return BinaryExpr(self, op, other)

    def eq(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Eq, other)

    def not_eq(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.NotEq, other)

    def gt(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Gt, other)

    def gt_eq(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.GtEq, other)

    def lt(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Lt, other)

    def lt_eq(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.LtEq, other)

    def and_(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.And, other)

    def or_(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Or, other)

    def __add__(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Plus, other)

    def __sub__(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Minus, other)

    def __mul__(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Multiply, other)

    def __truediv__(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Divide, other)

    def __mod__(self, other: "Expr") -> "BinaryExpr":
        return self._bin(Operator.Modulus, other)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNotNull":
        return IsNotNull(self)

    def sort(self, asc: bool = True) -> "SortExpr":
        return SortExpr(self, asc)

    # -- traversal --
    def children(self) -> Sequence["Expr"]:
        return ()

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()

    def collect_columns(self, accum: set[int]) -> None:
        """Accumulate referenced column indices (reference `collect_expr`,
        `sqlplanner.rs:414-439`); drives projection push-down."""
        for e in self.walk():
            if isinstance(e, Column):
                accum.add(e.index)

    # -- structural equality / hashing (IR is a value type) --
    def _key(self):
        raise NotImplementedError

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._key()))

    # -- JSON serde (externally tagged, like Rust serde) --
    def to_json(self):
        raise NotImplementedError

    @staticmethod
    def from_json(obj) -> "Expr":
        if not isinstance(obj, dict) or len(obj) != 1:
            raise PlanError(f"Malformed Expr wire object: {obj!r}")
        ((tag, body),) = obj.items()
        decoder = _EXPR_DECODERS.get(tag)
        if decoder is None:
            raise PlanError(f"Unknown Expr variant {tag!r}")
        return decoder(body)


class Column(Expr):
    """Positional column reference; repr ``#i``."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def get_type(self, schema: Schema) -> DataType:
        return schema.field(self.index).data_type

    def _key(self):
        return self.index

    def __repr__(self) -> str:
        return f"#{self.index}"

    def to_json(self):
        return {"Column": self.index}


class Literal(Expr):
    """Literal scalar; repr delegates to the ScalarValue."""

    __slots__ = ("value",)

    def __init__(self, value: ScalarValue):
        self.value = value

    def get_type(self, schema: Schema) -> DataType:
        return self.value.get_datatype()

    def _key(self):
        return self.value

    def __repr__(self) -> str:
        return repr(self.value)

    def to_json(self):
        return {"Literal": self.value.to_json()}


class BinaryExpr(Expr):
    """Binary expression; repr ``left Op right``."""

    __slots__ = ("left", "op", "right")

    def __init__(self, left: Expr, op: Operator, right: Expr):
        self.left = left
        self.op = op
        self.right = right

    def get_type(self, schema: Schema) -> DataType:
        if self.op.is_comparison or self.op.is_boolean:
            return DataType.BOOLEAN
        lt = self.left.get_type(schema)
        rt = self.right.get_type(schema)
        st = get_supertype(lt, rt)
        if st is None:
            # deliberate divergence: the reference falls back to Utf8 here
            # (logicalplan.rs:188 `unwrap_or(DataType::Utf8) //TODO ???`);
            # we fail loudly instead of mistyping the expression
            raise PlanError(
                f"No common supertype for {lt!r} {self.op.name} {rt!r}"
            )
        return st

    def children(self):
        return (self.left, self.right)

    def _key(self):
        return (self.left, self.op, self.right)

    def __repr__(self) -> str:
        return f"{self.left!r} {self.op!r} {self.right!r}"

    def to_json(self):
        return {
            "BinaryExpr": {
                "left": self.left.to_json(),
                "op": self.op.to_json(),
                "right": self.right.to_json(),
            }
        }


class IsNull(Expr):
    __slots__ = ("expr",)

    def __init__(self, expr: Expr):
        self.expr = expr

    def get_type(self, schema: Schema) -> DataType:
        return DataType.BOOLEAN

    def children(self):
        return (self.expr,)

    def _key(self):
        return self.expr

    def __repr__(self) -> str:
        return f"{self.expr!r} IS NULL"

    def to_json(self):
        return {"IsNull": self.expr.to_json()}


class IsNotNull(Expr):
    __slots__ = ("expr",)

    def __init__(self, expr: Expr):
        self.expr = expr

    def get_type(self, schema: Schema) -> DataType:
        return DataType.BOOLEAN

    def children(self):
        return (self.expr,)

    def _key(self):
        return self.expr

    def __repr__(self) -> str:
        return f"{self.expr!r} IS NOT NULL"

    def to_json(self):
        return {"IsNotNull": self.expr.to_json()}


class Cast(Expr):
    """Type cast; repr ``CAST(expr AS Type)``."""

    __slots__ = ("expr", "data_type")

    def __init__(self, expr: Expr, data_type: DataType):
        self.expr = expr
        self.data_type = data_type

    def get_type(self, schema: Schema) -> DataType:
        return self.data_type

    def children(self):
        return (self.expr,)

    def _key(self):
        return (self.expr, self.data_type)

    def __repr__(self) -> str:
        return f"CAST({self.expr!r} AS {self.data_type!r})"

    def to_json(self):
        return {
            "Cast": {
                "expr": self.expr.to_json(),
                "data_type": self.data_type.to_json(),
            }
        }


class SortExpr(Expr):
    """Sort key; repr ``expr ASC`` / ``expr DESC``."""

    __slots__ = ("expr", "asc")

    def __init__(self, expr: Expr, asc: bool):
        self.expr = expr
        self.asc = asc

    def get_type(self, schema: Schema) -> DataType:
        return self.expr.get_type(schema)

    def children(self):
        return (self.expr,)

    def _key(self):
        return (self.expr, self.asc)

    def __repr__(self) -> str:
        return f"{self.expr!r} {'ASC' if self.asc else 'DESC'}"

    def to_json(self):
        return {"Sort": {"expr": self.expr.to_json(), "asc": self.asc}}


class ScalarFunction(Expr):
    """Scalar function call; repr ``name(arg, ...)``."""

    __slots__ = ("name", "args", "return_type")

    def __init__(self, name: str, args: Sequence[Expr], return_type: DataType):
        self.name = name
        self.args = list(args)
        self.return_type = return_type

    def get_type(self, schema: Schema) -> DataType:
        return self.return_type

    def children(self):
        return tuple(self.args)

    def _key(self):
        return (self.name, tuple(self.args), self.return_type)

    def __repr__(self) -> str:
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"

    def to_json(self):
        return {
            "ScalarFunction": {
                "name": self.name,
                "args": [a.to_json() for a in self.args],
                "return_type": self.return_type.to_json(),
            }
        }


class AggregateFunction(Expr):
    """Aggregate function call; repr ``NAME(arg, ...)``.

    ``count_star`` marks COUNT(1)/COUNT(*): the planner rewrites those
    to COUNT(#0) for plan-shape parity with the reference
    (`sqlplanner.rs:311-329`, golden test `select_count_one`), but the
    executor must still count *rows*, not non-null values of column 0.
    The flag is repr-invisible and serialized only when set.
    """

    __slots__ = ("name", "args", "return_type", "count_star")

    def __init__(
        self,
        name: str,
        args: Sequence[Expr],
        return_type: DataType,
        count_star: bool = False,
    ):
        self.name = name
        self.args = list(args)
        self.return_type = return_type
        self.count_star = count_star

    def get_type(self, schema: Schema) -> DataType:
        return self.return_type

    def children(self):
        return tuple(self.args)

    def _key(self):
        return (self.name, tuple(self.args), self.return_type, self.count_star)

    def __repr__(self) -> str:
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"

    def to_json(self):
        body = {
            "name": self.name,
            "args": [a.to_json() for a in self.args],
            "return_type": self.return_type.to_json(),
        }
        if self.count_star:
            body["count_star"] = True
        return {"AggregateFunction": body}


_EXPR_DECODERS: dict[str, Callable] = {
    "Column": lambda b: Column(b),
    "Literal": lambda b: Literal(ScalarValue.from_json(b)),
    "BinaryExpr": lambda b: BinaryExpr(
        Expr.from_json(b["left"]), Operator.from_json(b["op"]), Expr.from_json(b["right"])
    ),
    "IsNull": lambda b: IsNull(Expr.from_json(b)),
    "IsNotNull": lambda b: IsNotNull(Expr.from_json(b)),
    "Cast": lambda b: Cast(Expr.from_json(b["expr"]), DataType.from_json(b["data_type"])),
    "Sort": lambda b: SortExpr(Expr.from_json(b["expr"]), b["asc"]),
    "ScalarFunction": lambda b: ScalarFunction(
        b["name"], [Expr.from_json(a) for a in b["args"]], DataType.from_json(b["return_type"])
    ),
    "AggregateFunction": lambda b: AggregateFunction(
        b["name"],
        [Expr.from_json(a) for a in b["args"]],
        DataType.from_json(b["return_type"]),
        b.get("count_star", False),
    ),
}


class FunctionType(enum.Enum):
    """Scalar vs aggregate (reference `logicalplan.rs:25-28`)."""

    Scalar = "Scalar"
    Aggregate = "Aggregate"


class FunctionMeta:
    """UDF registry entry (reference `logicalplan.rs:30-64`).

    For scalar UDFs the engine additionally carries an optional
    ``torch_fn``: the device lowering (a function of torch tensors).
    The reference's UDFs were host closures; here a UDF is a tensor
    function so it runs inside the operator on the device.
    """

    __slots__ = ("name", "args", "return_type", "function_type", "torch_fn", "host_fn")

    def __init__(
        self,
        name: str,
        args: Sequence[Field],
        return_type: DataType,
        function_type: FunctionType,
        torch_fn: Optional[Callable] = None,
        host_fn: Optional[Callable] = None,
    ):
        self.name = name
        self.args = list(args)
        self.return_type = return_type
        self.function_type = function_type
        self.torch_fn = torch_fn
        # host_fn: a numpy-columns-in / numpy-column-out implementation
        # for functions with no tensor form (string producers, struct
        # constructors — e.g. the console's ST_Point/ST_AsText geo UDFs);
        # evaluated post-kernel at the materialization boundary
        self.host_fn = host_fn


# -- output-field naming (reference expr_to_field, sqlplanner.rs:376-406) --
def expr_to_field(e: Expr, input_schema: Schema) -> Field:
    if isinstance(e, Column):
        return input_schema.field(e.index)
    if isinstance(e, Literal):
        return Field("lit", e.value.get_datatype(), True)
    if isinstance(e, (ScalarFunction, AggregateFunction)):
        return Field(e.name, e.return_type, True)
    if isinstance(e, Cast):
        return Field("cast", e.data_type, True)
    if isinstance(e, BinaryExpr):
        if e.op.is_comparison or e.op.is_boolean:
            return Field("binary_expr", DataType.BOOLEAN, True)
        lt = e.left.get_type(input_schema)
        rt = e.right.get_type(input_schema)
        st = get_supertype(lt, rt)
        if st is None:
            raise PlanError(f"No supertype for {lt!r} and {rt!r}")
        return Field("binary_expr", st, True)
    if isinstance(e, IsNull):
        # the reference's expr_to_field has no arm for these
        # (sqlplanner.rs:376-406); a NULL test is a Boolean output
        return Field("is_null", DataType.BOOLEAN, False)
    if isinstance(e, IsNotNull):
        return Field("is_not_null", DataType.BOOLEAN, False)
    if isinstance(e, SortExpr):
        return expr_to_field(e.expr, input_schema)
    raise PlanError(f"Cannot determine schema field for expression {e!r}")


def exprlist_to_fields(exprs: Sequence[Expr], input_schema: Schema) -> list[Field]:
    return [expr_to_field(e, input_schema) for e in exprs]
