"""Projection push-down optimizer.

The reference ships this pass (`src/sqlplanner.rs:441-520`) but leaves
it disabled (`context.rs:88`) because it rewrites `TableScan.projection`
without remapping upstream `Column` indices.  Here the pass is completed
— column references are remapped through the scan's new positional
layout — and enabled: the scan projection decides which columns are
parsed, dictionary-encoded, and copied to device memory, so it is
load-bearing for the H2D budget.
"""

from __future__ import annotations

from datafusion_tpu_torch.plan.expr import (
    AggregateFunction,
    BinaryExpr,
    Cast,
    Column,
    Expr,
    IsNotNull,
    IsNull,
    Literal,
    ScalarFunction,
    SortExpr,
)
from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    EmptyRelation,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Selection,
    Sort,
    TableScan,
)


def _remap(e: Expr, mapping: dict[int, int]) -> Expr:
    """Rewrite Column indices through `mapping` (old -> new position)."""
    if isinstance(e, Column):
        return Column(mapping[e.index])
    if isinstance(e, Literal):
        return e
    if isinstance(e, BinaryExpr):
        return BinaryExpr(_remap(e.left, mapping), e.op, _remap(e.right, mapping))
    if isinstance(e, IsNull):
        return IsNull(_remap(e.expr, mapping))
    if isinstance(e, IsNotNull):
        return IsNotNull(_remap(e.expr, mapping))
    if isinstance(e, Cast):
        return Cast(_remap(e.expr, mapping), e.data_type)
    if isinstance(e, SortExpr):
        return SortExpr(_remap(e.expr, mapping), e.asc)
    if isinstance(e, ScalarFunction):
        return ScalarFunction(e.name, [_remap(a, mapping) for a in e.args], e.return_type)
    if isinstance(e, AggregateFunction):
        return AggregateFunction(
            e.name, [_remap(a, mapping) for a in e.args], e.return_type,
            e.count_star,
        )
    raise TypeError(f"unknown Expr {e!r}")


_IDENTITY = None  # sentinel: child output positions unchanged


def push_down_projection(plan: LogicalPlan) -> LogicalPlan:
    """Rewrite the plan so every TableScan reads only referenced columns.

    The root requires all of its own output columns, so a plan whose
    root is a bare scan/filter keeps its full schema; trimming starts
    at the first Projection/Aggregate boundary below the root.
    """
    new_plan, _ = _push(plan, set(range(len(plan.schema))))
    return new_plan


def _push(plan: LogicalPlan, required: set[int]):
    """Returns (new_plan, mapping) where mapping translates column
    positions in the *old* output schema of `plan` to positions in the
    new one (None = identity)."""
    if isinstance(plan, TableScan):
        if plan.projection is not None:
            # already projected (e.g. plan arrived over the wire); leave it
            return plan, _IDENTITY
        indices = sorted(required)
        if len(indices) == len(plan.table_schema):
            return plan, _IDENTITY  # everything referenced; nothing to trim
        mapping = {old: new for new, old in enumerate(indices)}
        return (
            TableScan(plan.schema_name, plan.table_name, plan.table_schema, indices),
            mapping,
        )
    if isinstance(plan, Selection):
        child_req = set(required)
        plan.expr.collect_columns(child_req)
        new_input, mapping = _push(plan.input, child_req)
        if mapping is _IDENTITY:
            return Selection(plan.expr, new_input), _IDENTITY
        return Selection(_remap(plan.expr, mapping), new_input), mapping
    if isinstance(plan, Projection):
        child_req: set[int] = set()
        for e in plan.expr:
            e.collect_columns(child_req)
        new_input, mapping = _push(plan.input, child_req)
        if mapping is _IDENTITY:
            new_exprs = plan.expr
        else:
            new_exprs = [_remap(e, mapping) for e in plan.expr]
        # projection defines fresh output positions: identity for parent
        return Projection(new_exprs, new_input, plan.schema), _IDENTITY
    if isinstance(plan, Aggregate):
        child_req = set()
        for e in plan.group_expr + plan.aggr_expr:
            e.collect_columns(child_req)
        new_input, mapping = _push(plan.input, child_req)
        if mapping is _IDENTITY:
            ge, ae = plan.group_expr, plan.aggr_expr
        else:
            ge = [_remap(e, mapping) for e in plan.group_expr]
            ae = [_remap(e, mapping) for e in plan.aggr_expr]
        return Aggregate(new_input, ge, ae, plan.schema), _IDENTITY
    if isinstance(plan, Sort):
        child_req = set(required)
        for e in plan.expr:
            e.collect_columns(child_req)
        new_input, mapping = _push(plan.input, child_req)
        if mapping is _IDENTITY:
            return Sort(plan.expr, new_input, plan.schema), _IDENTITY
        new_exprs = [_remap(e, mapping) for e in plan.expr]
        return Sort(new_exprs, new_input, new_input.schema), mapping
    if isinstance(plan, Limit):
        new_input, mapping = _push(plan.input, required)
        if mapping is _IDENTITY:
            return Limit(plan.limit, new_input, plan.schema), _IDENTITY
        return Limit(plan.limit, new_input, new_input.schema), mapping
    if isinstance(plan, Join):
        # split the requirement across the two inputs (join output =
        # left fields then right fields) and always require the ON keys
        n_l = len(plan.left.schema)
        l_req = {i for i in required if i < n_l} | {l for l, _ in plan.on}
        r_req = {i - n_l for i in required if i >= n_l} | {
            r for _, r in plan.on
        }
        new_left, l_map = _push(plan.left, l_req)
        new_right, r_map = _push(plan.right, r_req)
        if l_map is _IDENTITY and r_map is _IDENTITY:
            return (
                Join(new_left, new_right, plan.on, plan.join_type,
                     plan.schema),
                _IDENTITY,
            )
        lm = l_map if l_map is not _IDENTITY else {
            i: i for i in range(n_l)
        }
        rm = r_map if r_map is not _IDENTITY else {
            i: i for i in range(len(plan.right.schema))
        }
        n_l_new = len(new_left.schema)
        mapping: dict[int, int] = {}
        for old, new in lm.items():
            mapping[old] = new
        for old, new in rm.items():
            mapping[n_l + old] = n_l_new + new
        fields = [None] * (n_l_new + len(new_right.schema))
        for old_pos, new_pos in mapping.items():
            fields[new_pos] = plan.schema.field(old_pos)
        on_new = [(lm[l], rm[r]) for l, r in plan.on]
        return (
            Join(new_left, new_right, on_new, plan.join_type,
                 Schema(fields)),
            mapping,
        )
    if isinstance(plan, EmptyRelation):
        return plan, _IDENTITY
    raise TypeError(f"unknown LogicalPlan {type(plan).__name__}")
