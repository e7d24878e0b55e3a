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
from datafusion_tpu_torch.exec.batch import RecordBatch, bucket_capacity, to_device
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
        return torch.tensor(value, dtype=dtype, device=self.device)


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
            value = expr.value.value
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
            out_dtype = expr.return_type.torch_dtype
            widen = expr.return_type.is_float

            def func_fn(env: Env):
                vals, valid = [], None
                for af in arg_fns:
                    v, vd = af(env)
                    vals.append(v.to(out_dtype) if widen else v)
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
        tdt = dst_type.torch_dtype

        def cast_fn(env: Env):
            v, valid = inner(env)
            return v.to(tdt), valid

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
        tdt = st.torch_dtype
        if op.is_comparison:
            top = {
                Operator.Eq: torch.eq,
                Operator.NotEq: torch.ne,
                Operator.Lt: torch.lt,
                Operator.LtEq: torch.le,
                Operator.Gt: torch.gt,
                Operator.GtEq: torch.ge,
            }[op]
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
            return top(lv.to(tdt), rv.to(tdt)), _and_valid(lvalid, rvalid)

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
    and shipped only when a dictionary has grown.  Tables are padded to
    a bucketed capacity, as the JAX package pads them.
    """
    out = []
    for i, spec in enumerate(specs):
        d = batch.dicts[spec.column]
        if d is None:
            raise ExecutionError(
                f"column {spec.column} has no dictionary (not a Utf8 column?)"
            )
        key = (i, d.version)
        hit = cache.get(key)
        if hit is not None:
            out.append(hit)
            continue
        if spec.kind == "eq_code":
            val = torch.tensor(d.code_of(spec.literal), dtype=torch.int32,
                               device=device)
        else:
            table = d.compare_table(spec.op, spec.literal)
            padded = np.zeros(bucket_capacity(max(len(table), 1)), dtype=bool)
            padded[: len(table)] = table
            val = to_device(padded, device)
        cache[key] = val
        out.append(val)
    return out
