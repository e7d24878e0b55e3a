"""Expr tree -> torch function compiler.

The counterpart of the JAX package's `exec/expression.py`.  An Expr
tree lowers to a closure `(Env) -> (value, validity|None)` over the
batch's column tensors; validity is a bool tensor, None meaning all
valid.  PyTorch runs eagerly, so each node is one or a few tensor ops
on the batch's device.

Types follow the planner, not torch's promotion rules.  torch keeps an
f32 column f32 against a 0-dim f64 tensor and turns an int64 tensor
times a Python float into f32, where JAX in x64 mode gives f64; so
every arithmetic and comparison node casts both operands to the type
the planner gives it (`get_supertype`) before the op, and every
literal is a tensor of its planner dtype.

Unsigned columns arrive in their device dtypes (`DataType.torch_dtype`:
uint8, then int32, int64 and an int64 bit view for UInt16, UInt32 and
UInt64), and every node gives what the JAX package's native unsigned
arithmetic gives: +, - and * wrap at the column's width, x / 0 is the
type's maximum and x % 0 is x, UInt64 compares and divides unsigned,
and UInt64 converts to a float correctly rounded (`_convert`).

String semantics (no tensor form for Utf8): columns carry int32
dictionary codes.  Equality against a string literal compares codes
(the literal's code is resolved per dictionary version on the host);
ordered comparisons gather from a host-computed bool lookup table
(`StringDictionary.compare_table`).  Both reach the device as *aux
inputs* beside the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema, get_supertype
from datafusion_tpu_torch.errors import ExecutionError, NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    bucket_capacity,
    dict_versions,
    to_device,
)
from datafusion_tpu_torch.exec.streams import publish, shared
from datafusion_tpu_torch.plan.expr import (
    AggregateFunction,
    BinaryExpr,
    Cast,
    Column,
    Expr,
    IsNotNull,
    IsNull,
    Literal,
    Operator,
    ScalarFunction,
)

# -- builtin scalar functions (UDFs merge into this via the context) --
BUILTIN_FUNCTIONS: dict[str, Callable] = {
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "floor": torch.floor,
    "ceil": torch.ceil,
}


@dataclass(frozen=True)
class AuxSpec:
    """A host-computed kernel input derived from a string dictionary.

    kind == "eq_code":   int32 scalar, the literal's dictionary code
                         (-1 if absent -> matches nothing)
    kind == "cmp_table": bool[table_capacity] lookup table for an
                         ordered comparison against the literal
    """

    kind: str
    column: int
    op: str
    literal: str


class Env:
    """Runtime environment a compiled node reads from (all tensors on
    `device`).

    `col_map` optionally translates schema column indices to positions
    in `cols`/`valids`, so callers ship only the columns a kernel reads.
    `params` holds the runtime literal values (0-dim tensors, see
    exec/kernels.parameterize_exprs).
    """

    __slots__ = ("_cols", "_valids", "aux", "_map", "params", "device")

    def __init__(self, cols, valids, aux, device, col_map=None, params=()):
        self._cols = cols
        self._valids = valids
        self.aux = aux
        self._map = col_map
        self.params = params
        self.device = device

    def col(self, i: int):
        return self._cols[i if self._map is None else self._map[i]]

    def valid(self, i: int):
        return self._valids[i if self._map is None else self._map[i]]

    def scalar(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)  # df-lint: ok(DF006) — a 0-dim literal of the expression, not a column


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _int_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncating integer division with XLA's answers where C has none
    (`lax.div`): x / 0 == -1 and MIN / -1 == MIN.  torch raises on a
    zero divisor on the CPU, so those lanes divide by 1 and are then
    overwritten."""
    zero = b == 0
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    safe = torch.where(zero | overflow, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    return torch.where(zero, torch.full_like(q, -1), q)


def _int_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Remainder with the dividend's sign (`lax.rem`): x % 0 == x and
    MIN % -1 == 0."""
    zero = b == 0
    safe = torch.where(zero | (b == -1), torch.ones_like(b), b)
    r = torch.fmod(a, safe)
    return torch.where(zero, a, r)


_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _u64_image(v: torch.Tensor) -> torch.Tensor:
    """The signed image of UInt64 bits: its int64 order is the
    unsigned order."""
    return torch.bitwise_xor(v, _I64_MIN)


def _u64_to_float(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """UInt64 bits as a float, correctly rounded.  Values at or above
    2^63 (negative as int64) halve first, keeping the lost bit as a
    sticky bit so the rounding is the same, convert, and double."""
    half = torch.bitwise_or(
        torch.bitwise_and(torch.bitwise_right_shift(v, 1), _I64_MAX),
        torch.bitwise_and(v, 1),
    )
    return torch.where(v < 0, half.to(dtype) * 2, v.to(dtype))


def _convert(v: torch.Tensor, src: DataType, dst: DataType) -> torch.Tensor:
    """A value of type `src` (in its device dtype) as type `dst`.
    Integer conversions wrap, as the JAX package's `astype` does; an
    unsigned target keeps only its width's bits."""
    tdt = dst.torch_dtype
    if src == dst:
        return v.to(tdt)
    if dst.is_float and src == DataType.UINT64:
        return _u64_to_float(v, tdt)
    if dst.is_unsigned_integer and dst.width in (16, 32):
        return torch.bitwise_and(v.to(torch.int64).to(tdt), (1 << dst.width) - 1)
    if dst.is_unsigned_integer and v.is_floating_point():
        v = v.to(torch.int64)
    return v.to(tdt)


def _uint_div(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Unsigned division, with XLA's x / 0 == the type's maximum.
    Below 64 bits the values are non-negative in their container, so
    truncating division is unsigned division.  For UInt64 (int64 bits):
    a divisor >= 2^63 gives a quotient of 1 where a >= b, else 0; a
    smaller one divides a halved a, doubles the quotient and adds the
    one the remainder may still hold."""
    zero = b == 0
    if width < 64:
        q = torch.div(a, torch.where(zero, torch.ones_like(b), b), rounding_mode="trunc")
        return torch.where(zero, torch.full_like(q, (1 << width) - 1), q)
    big = b < 0
    safe = torch.where(zero | big, torch.ones_like(b), b)
    half = torch.bitwise_and(torch.bitwise_right_shift(a, 1), _I64_MAX)
    q = torch.bitwise_left_shift(torch.div(half, safe, rounding_mode="trunc"), 1)
    r = a - q * safe  # in [0, 2 * safe): fits 64 unsigned bits
    q = q + (_u64_image(r) >= _u64_image(safe)).to(q.dtype)
    q = torch.where(big, (_u64_image(a) >= _u64_image(b)).to(q.dtype), q)
    return torch.where(zero, torch.full_like(q, -1), q)


def _uint_rem(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Unsigned remainder, x % 0 == x (`lax.rem`)."""
    return a - _uint_div(a, b, width) * b


def _uint_arith(op: Operator, width: int) -> Callable:
    """+, -, *, / or % at an unsigned width: uint8 and the UInt64 bit
    view wrap as the type does; UInt16 and UInt32 keep their width's
    bits of the wider container's result."""
    if op == Operator.Divide:
        return lambda a, b: _uint_div(a, b, width)
    if op == Operator.Modulus:
        return lambda a, b: _uint_rem(a, b, width)
    f = {Operator.Plus: torch.add, Operator.Minus: torch.sub,
         Operator.Multiply: torch.mul}[op]
    if width in (8, 64):
        return f
    mask = (1 << width) - 1
    return lambda a, b: torch.bitwise_and(f(a, b), mask)


def _literal_value(value, dt: DataType):
    """A literal as its device dtype holds it (UInt64 as int64 bits)."""
    if dt == DataType.UINT64 and value >= 1 << 63:
        return value - (1 << 64)
    return value


class ExprCompiler:
    """Compiles Expr trees to (Env) -> (value, validity|None) closures,
    collecting AuxSpecs for string comparisons along the way."""

    def __init__(
        self,
        schema: Schema,
        functions: Optional[dict[str, Callable]] = None,
        param_slots: Optional[dict] = None,
    ):
        self.schema = schema
        self.functions = dict(BUILTIN_FUNCTIONS)
        if functions:
            self.functions.update(functions)
        self.aux_specs: list[AuxSpec] = []
        # id(Literal node) -> runtime parameter slot (kernels.
        # parameterize_exprs): such literals read env.params, so one
        # core serves every literal value of the same query shape
        self.param_slots = param_slots or {}

    def _add_aux(self, spec: AuxSpec) -> int:
        self.aux_specs.append(spec)
        return len(self.aux_specs) - 1

    def compile(self, expr: Expr) -> Callable[[Env], tuple]:
        if isinstance(expr, Column):
            i = expr.index

            def col_fn(env: Env):
                return env.col(i), env.valid(i)

            return col_fn

        if isinstance(expr, Literal):
            if expr.value.is_null:

                def null_fn(env: Env):
                    # a null literal: value irrelevant, validity all-false
                    return env.scalar(0, torch.int32), env.scalar(False, torch.bool)

                return null_fn
            dt = expr.value.get_datatype()
            if dt == DataType.UTF8:
                raise NotSupportedError(
                    "bare string literals only appear inside comparisons"
                )
            slot = self.param_slots.get(id(expr))
            if slot is not None:

                def param_fn(env: Env, j=slot):
                    return env.params[j], None

                return param_fn
            value = _literal_value(expr.value.value, dt)
            tdt = dt.torch_dtype

            def lit_fn(env: Env):
                return env.scalar(value, tdt), None

            return lit_fn

        if isinstance(expr, Cast):
            return self._compile_cast(expr)

        if isinstance(expr, IsNull):
            inner = self.compile(expr.expr)

            def isnull_fn(env: Env):
                _, valid = inner(env)
                if valid is None:
                    return env.scalar(False, torch.bool), None
                return ~valid, None

            return isnull_fn

        if isinstance(expr, IsNotNull):
            inner = self.compile(expr.expr)

            def isnotnull_fn(env: Env):
                _, valid = inner(env)
                if valid is None:
                    return env.scalar(True, torch.bool), None
                return valid, None

            return isnotnull_fn

        if isinstance(expr, BinaryExpr):
            return self._compile_binary(expr)

        if isinstance(expr, ScalarFunction):
            fn = self.functions.get(expr.name.lower())
            if fn is None:
                raise ExecutionError(f"no implementation for function {expr.name!r}")
            arg_fns = [self.compile(a) for a in expr.args]
            # builtins take and return Float64: integer arguments widen
            # first (torch.sqrt of an int64 tensor would give f32)
            out_type = expr.return_type
            out_dtype = out_type.torch_dtype
            widen = out_type.is_float
            arg_types = [a.get_type(self.schema) for a in expr.args] if widen else []

            def func_fn(env: Env):
                vals, valid = [], None
                for i, af in enumerate(arg_fns):
                    v, vd = af(env)
                    vals.append(_convert(v, arg_types[i], out_type) if widen else v)
                    valid = _and_valid(valid, vd)
                return fn(*vals).to(out_dtype), valid

            return func_fn

        if isinstance(expr, AggregateFunction):
            raise ExecutionError(
                "aggregate functions are handled by the aggregate operator, "
                "not the scalar compiler"
            )

        raise NotSupportedError(f"cannot compile expression {expr!r}")

    def _compile_cast(self, expr: Cast) -> Callable:
        src_type = expr.expr.get_type(self.schema)
        dst_type = expr.data_type
        inner = self.compile(expr.expr)
        if src_type == dst_type:
            return inner
        if src_type == DataType.UTF8 or dst_type == DataType.UTF8:
            raise NotSupportedError(f"CAST {src_type!r} -> {dst_type!r} not supported")

        def cast_fn(env: Env):
            v, valid = inner(env)
            return _convert(v, src_type, dst_type), valid

        return cast_fn

    def _expr_is_utf8(self, e: Expr) -> bool:
        from datafusion_tpu_torch.errors import DataFusionError

        try:
            return e.get_type(self.schema) == DataType.UTF8
        except DataFusionError:
            # untypeable subtree: not a string, and the real diagnostic
            # belongs to whoever compiles it
            return False

    def _compile_binary(self, expr: BinaryExpr) -> Callable:
        op = expr.op
        # -- string comparisons ride dictionary codes / lookup tables --
        if self._expr_is_utf8(expr.left) or self._expr_is_utf8(expr.right):
            return self._compile_string_comparison(expr)

        lf = self.compile(expr.left)
        rf = self.compile(expr.right)

        if op.is_boolean:
            # SQL three-valued logic: FALSE AND NULL = FALSE,
            # TRUE OR NULL = TRUE — a null operand must not poison a
            # determined result
            is_and = op == Operator.And

            def bool_fn(env: Env):
                lv, lvalid = lf(env)
                rv, rvalid = rf(env)
                if lvalid is None and rvalid is None:
                    return (lv & rv) if is_and else (lv | rv), None
                lva = env.scalar(True, torch.bool) if lvalid is None else lvalid
                rva = env.scalar(True, torch.bool) if rvalid is None else rvalid
                lv_t = lv & lva  # known TRUE
                rv_t = rv & rva
                lv_f = ~lv & lva  # known FALSE
                rv_f = ~rv & rva
                if is_and:
                    value = lv_t & rv_t
                    valid = (lva & rva) | lv_f | rv_f
                else:
                    value = lv_t | rv_t
                    valid = (lva & rva) | lv_t | rv_t
                return value, valid

            return bool_fn

        lt = expr.left.get_type(self.schema)
        rt = expr.right.get_type(self.schema)
        st = get_supertype(lt, rt)
        if st is None:
            raise NotSupportedError(f"no common type for {lt!r} {op!r} {rt!r}")
        if op.is_comparison:
            top = {
                Operator.Eq: torch.eq,
                Operator.NotEq: torch.ne,
                Operator.Lt: torch.lt,
                Operator.LtEq: torch.le,
                Operator.Gt: torch.gt,
                Operator.GtEq: torch.ge,
            }[op]
            if st == DataType.UINT64:
                cmp = top

                def top(a, b):
                    return cmp(_u64_image(a), _u64_image(b))
        elif st.is_unsigned_integer:
            top = _uint_arith(op, st.width)
        elif st.is_integer:
            top = {
                Operator.Plus: torch.add,
                Operator.Minus: torch.sub,
                Operator.Multiply: torch.mul,
                Operator.Divide: _int_div,
                Operator.Modulus: _int_rem,
            }[op]
        else:
            top = {
                Operator.Plus: torch.add,
                Operator.Minus: torch.sub,
                Operator.Multiply: torch.mul,
                Operator.Divide: torch.div,
                Operator.Modulus: torch.fmod,
            }[op]

        def bin_fn(env: Env):
            lv, lvalid = lf(env)
            rv, rvalid = rf(env)
            return (top(_convert(lv, lt, st), _convert(rv, rt, st)),
                    _and_valid(lvalid, rvalid))

        return bin_fn

    def _compile_string_comparison(self, expr: BinaryExpr) -> Callable:
        op = expr.op
        # normalize to (column, literal); flip operator if literal is on the left
        flip = {
            Operator.Lt: Operator.Gt,
            Operator.LtEq: Operator.GtEq,
            Operator.Gt: Operator.Lt,
            Operator.GtEq: Operator.LtEq,
            Operator.Eq: Operator.Eq,
            Operator.NotEq: Operator.NotEq,
        }
        left, right = expr.left, expr.right
        if isinstance(left, Literal) and isinstance(right, Column):
            left, right = right, left
            op = flip.get(op)
            if op is None:
                raise NotSupportedError(f"operator {expr.op!r} on strings")
        if not (isinstance(left, Column) and isinstance(right, Literal)):
            raise NotSupportedError(
                "string comparisons support column-vs-literal only "
                f"(got {expr!r})"
            )
        if right.value.is_null:
            raise NotSupportedError("comparison with NULL is always null; use IS NULL")
        if right.value.get_datatype() != DataType.UTF8:
            raise NotSupportedError(f"comparing Utf8 with {right.value!r}")
        col = left.index
        lit = str(right.value.value)

        if op in (Operator.Eq, Operator.NotEq):
            aux_i = self._add_aux(AuxSpec("eq_code", col, "=", lit))
            negate = op == Operator.NotEq

            def eq_fn(env: Env):
                v = env.col(col) == env.aux[aux_i]
                if negate:
                    v = ~v
                return v, env.valid(col)

            return eq_fn

        if op in (Operator.Lt, Operator.LtEq, Operator.Gt, Operator.GtEq):
            op_str = {
                Operator.Lt: "<",
                Operator.LtEq: "<=",
                Operator.Gt: ">",
                Operator.GtEq: ">=",
            }[op]
            aux_i = self._add_aux(AuxSpec("cmp_table", col, op_str, lit))

            def cmp_fn(env: Env):
                table = env.aux[aux_i]
                codes = env.col(col).clamp(0, table.shape[0] - 1)
                return torch.index_select(table, 0, codes), env.valid(col)

            return cmp_fn

        raise NotSupportedError(f"operator {op!r} on strings")


def compute_aux_values(
    specs: list[AuxSpec], batch: RecordBatch, cache: dict, device: torch.device
) -> list:
    """Aux inputs for one batch from its dictionaries, as tensors on
    `device`.

    Cached by (spec index, dictionary version): tables are recomputed
    and shipped only when a dictionary has grown.  The version is the
    one pinned on the batch as it left its source, if any
    (`batch.dict_versions`).  Tables are padded to a bucketed capacity,
    as the JAX package pads them.
    """
    out = []
    for i, spec in enumerate(specs):
        d = batch.dicts[spec.column]
        if d is None:
            raise ExecutionError(
                f"column {spec.column} has no dictionary (not a Utf8 column?)"
            )
        version = dict_versions(batch)[spec.column]
        key = (i, version)
        hit = cache.get(key)
        if hit is not None:
            out.append(shared(hit))
            continue
        if spec.kind == "eq_code":
            val = torch.tensor(d.code_of(spec.literal, version), dtype=torch.int32,  # df-lint: ok(DF006) — a 0-dim dictionary code, cached per version
                               device=device)
        else:
            table = d.compare_table(spec.op, spec.literal, version)
            padded = np.zeros(bucket_capacity(max(len(table), 1)), dtype=bool)
            padded[: len(table)] = table
            val = to_device(padded, device)
        cache[key] = publish(val)
        out.append(val)
    return out
