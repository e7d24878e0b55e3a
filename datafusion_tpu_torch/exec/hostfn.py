"""Host-side expression evaluation.

The counterpart of the JAX package's `exec/hostfn.py`.  In this slice
it evaluates the predicate a fused ORDER BY folds into its selection
mask (`exec/fused.rewrite_sort` admits only `host_evaluable`
predicates), with numpy on the host batch.  Scalar UDFs whose values a
tensor cannot hold (strings, structs) register a `FunctionMeta.host_fn`
in the JAX package; registering one in the port raises until the
pipeline operator that evaluates them lands (ROADMAP queue 1,
PipelineRelation).

Values flow as numpy arrays; struct values as tuples of numpy arrays;
Utf8 results as object arrays of python strings (dictionary-encoded at
the operator boundary).  Validity propagates like the device compiler's
(`None` = all valid; binary ops AND their inputs' validity).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from datafusion_tpu_torch.datatypes import DataType
from datafusion_tpu_torch.errors import ExecutionError, NotSupportedError
from datafusion_tpu_torch.exec.batch import RecordBatch, to_host
from datafusion_tpu_torch.plan.expr import (
    BinaryExpr,
    Cast,
    Column,
    Expr,
    FunctionMeta,
    IsNotNull,
    IsNull,
    Literal,
    Operator,
    ScalarFunction,
)


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


_CMP_OPS = (
    Operator.Eq, Operator.NotEq,
    Operator.Lt, Operator.LtEq, Operator.Gt, Operator.GtEq,
)

_CMP_SYMBOL = {
    Operator.Lt: "<", Operator.LtEq: "<=",
    Operator.Gt: ">", Operator.GtEq: ">=",
}


def _string_literal_cmp(expr: Expr, schema) -> Optional[tuple]:
    """(column, op, literal_str, flipped) when `expr` compares a Utf8
    column against a string literal — the shape eval_host_expr handles
    via the dictionary compare table (no decode)."""
    if not isinstance(expr, BinaryExpr) or expr.op not in _CMP_OPS:
        return None
    for col, lit, flipped in (
        (expr.left, expr.right, False),
        (expr.right, expr.left, True),
    ):
        if (
            isinstance(col, Column)
            and schema.field(col.index).data_type == DataType.UTF8
            and isinstance(lit, Literal)
            and not lit.value.is_null
            and isinstance(lit.value.value, str)
        ):
            return col, expr.op, lit.value.value, flipped
    return None


def host_evaluable(expr: Expr, metas: dict[str, FunctionMeta], schema) -> bool:
    """True when eval_host_expr can evaluate `expr` with numpy alone,
    cheaply: no ScalarFunction whose only implementation is a torch_fn
    (calling that from the host would bounce through the device)
    and no Utf8 column references in positions that would force a
    decode to python object arrays — fine for the rare host-fn string
    producers, too slow to opt into for bulk routing.  Utf8-vs-literal
    comparisons ARE allowed: they evaluate against the dictionary
    compare table, codes only (the TPC-H shipdate filter shape)."""
    if isinstance(expr, Column):
        return schema.field(expr.index).data_type != DataType.UTF8
    if isinstance(expr, Literal):
        # bare string literals stay on the device path so both paths
        # raise the planner's NotSupportedError identically (inside
        # comparisons they ride _string_literal_cmp, handled above)
        return expr.value.is_null or not isinstance(expr.value.value, str)
    if isinstance(expr, (Cast, IsNull, IsNotNull)):
        return host_evaluable(expr.expr, metas, schema)
    if isinstance(expr, BinaryExpr):
        if _string_literal_cmp(expr, schema) is not None:
            return True
        if expr.op not in _NUMPY_OPS and expr.op not in (
            Operator.Divide, Operator.Modulus,
        ):
            return False
        return host_evaluable(expr.left, metas, schema) and host_evaluable(
            expr.right, metas, schema
        )
    if isinstance(expr, ScalarFunction):
        fm = metas.get(expr.name.lower())
        if fm is None or fm.host_fn is None:
            return False
        return all(host_evaluable(a, metas, schema) for a in expr.args)
    return False


_NUMPY_OPS = {
    Operator.Plus: np.add,
    Operator.Minus: np.subtract,
    Operator.Multiply: np.multiply,
    Operator.Eq: np.equal,
    Operator.NotEq: np.not_equal,
    Operator.Lt: np.less,
    Operator.LtEq: np.less_equal,
    Operator.Gt: np.greater,
    Operator.GtEq: np.greater_equal,
    Operator.And: np.logical_and,
    Operator.Or: np.logical_or,
}


def host_pred_mask(
    expr: Expr, batch: RecordBatch, metas: dict[str, FunctionMeta]
) -> np.ndarray:
    """Evaluate a host-routed predicate to a capacity-length bool mask,
    with SQL semantics: a NULL predicate drops the row.  The one shared
    definition of this fold — the pipeline and aggregate host-predicate
    paths must never diverge on it."""
    pv, pvalid = eval_host_expr(expr, batch, metas)
    pm = np.broadcast_to(np.asarray(pv, dtype=bool), (batch.capacity,))
    if pvalid is not None:
        pm = pm & np.broadcast_to(
            np.asarray(pvalid, dtype=bool), (batch.capacity,)
        )
    return pm


def eval_host_expr(
    expr: Expr, batch: RecordBatch, metas: dict[str, FunctionMeta]
):
    """Evaluate `expr` against a host batch.

    Returns (value, validity): value is a numpy array (object array of
    str for Utf8 results), a tuple of arrays for struct results, or a
    scalar for literals; validity is a bool array or None.
    """
    if isinstance(expr, Column):
        i = expr.index
        col = to_host(batch.data[i])
        if batch.schema.field(i).data_type == DataType.UTF8:
            d = batch.dicts[i]
            if d is not None:
                col = d.decode(col)
        v = batch.validity[i]
        return col, (None if v is None else to_host(v))
    if isinstance(expr, Literal):
        if expr.value.is_null:
            return np.zeros((), np.int64), np.zeros(batch.capacity, bool)
        return expr.value.value, None
    if isinstance(expr, Cast):
        v, valid = eval_host_expr(expr.expr, batch, metas)
        return np.asarray(v).astype(expr.data_type.np_dtype), valid
    if isinstance(expr, IsNull):
        _, valid = eval_host_expr(expr.expr, batch, metas)
        if valid is None:
            return np.zeros(batch.capacity, bool), None
        return ~valid, None
    if isinstance(expr, IsNotNull):
        _, valid = eval_host_expr(expr.expr, batch, metas)
        if valid is None:
            return np.ones(batch.capacity, bool), None
        return valid, None
    if isinstance(expr, BinaryExpr):
        cmp = _string_literal_cmp(expr, batch.schema)
        if cmp is not None:
            col, op, lit, flipped = cmp
            d = batch.dicts[col.index]
            if d is not None:
                codes = to_host(batch.data[col.index])
                v = batch.validity[col.index]
                valid = None if v is None else to_host(v)
                if flipped:
                    op = {
                        Operator.Lt: Operator.Gt, Operator.Gt: Operator.Lt,
                        Operator.LtEq: Operator.GtEq,
                        Operator.GtEq: Operator.LtEq,
                    }.get(op, op)
                if op == Operator.Eq:
                    return codes == np.int32(d.code_of(lit)), valid
                if op == Operator.NotEq:
                    return codes != np.int32(d.code_of(lit)), valid
                # ordered: gather the per-code compare table (identical
                # to the device kernel's aux-table gather), cached on
                # the dictionary per (op, literal, version) — rebuilding
                # is a python loop over every dictionary value
                sym = _CMP_SYMBOL[op]
                hit = d.cmp_cache.get((sym, lit))
                if hit is None or hit[0] != d.version:
                    table = d.compare_table(sym, lit)
                    d.cmp_cache[(sym, lit)] = (d.version, table)
                else:
                    table = hit[1]
                if len(table) == 0:
                    return np.zeros(len(codes), bool), valid
                return table[codes], valid
            # no dictionary: fall through to the generic decode path
        lv, lvalid = eval_host_expr(expr.left, batch, metas)
        rv, rvalid = eval_host_expr(expr.right, batch, metas)
        if expr.op == Operator.Divide:
            out_int = expr.get_type(batch.schema).is_integer
            with np.errstate(divide="ignore", invalid="ignore"):
                if out_int:
                    # C-style truncated division, matching the device
                    # compiler (expression.py `_div`) — numpy's
                    # floor_divide floors, which differs on negatives
                    q = np.floor_divide(lv, rv)
                    r = lv - q * rv
                    val = q + ((r != 0) & ((lv < 0) != (rv < 0)))
                else:
                    val = np.true_divide(lv, rv)
            return val, _and_valid(lvalid, rvalid)
        if expr.op == Operator.Modulus:
            # C-style remainder (sign of dividend), as the device
            # compiler computes it — np.mod uses the divisor's sign
            with np.errstate(divide="ignore", invalid="ignore"):
                val = np.fmod(lv, rv)
            return val, _and_valid(lvalid, rvalid)
        if expr.op in (Operator.And, Operator.Or):
            # SQL three-valued logic, mirroring the device compiler
            # (expression.py bool_fn): FALSE AND NULL = FALSE,
            # TRUE OR NULL = TRUE — a null operand must not poison a
            # determined result
            if lvalid is None and rvalid is None:
                val = (lv & rv) if expr.op == Operator.And else (lv | rv)
                return val, None
            lva = np.ones((), bool) if lvalid is None else lvalid
            rva = np.ones((), bool) if rvalid is None else rvalid
            lv = np.asarray(lv, bool)
            rv = np.asarray(rv, bool)
            lv_t = lv & lva  # known TRUE
            rv_t = rv & rva
            lv_f = ~lv & lva  # known FALSE
            rv_f = ~rv & rva
            if expr.op == Operator.And:
                return lv_t & rv_t, (lva & rva) | lv_f | rv_f
            return lv_t | rv_t, (lva & rva) | lv_t | rv_t
        op = _NUMPY_OPS.get(expr.op)
        if op is None:
            raise NotSupportedError(f"host eval of operator {expr.op!r}")
        return op(lv, rv), _and_valid(lvalid, rvalid)
    if isinstance(expr, ScalarFunction):
        fm = metas.get(expr.name.lower())
        if fm is None or fm.host_fn is None:
            # host_evaluable admits only host_fn calls; a torch_fn runs
            # on the device inside its operator
            raise NotSupportedError(f"no host implementation of {expr.name!r}")
        args = [eval_host_expr(a, batch, metas) for a in expr.args]
        valid = None
        for _, av in args:
            valid = _and_valid(valid, av)
        return fm.host_fn(*[a[0] for a in args]), valid
    raise NotSupportedError(f"host eval of expression {expr!r}")
