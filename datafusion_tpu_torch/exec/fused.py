"""Plan-chain collapse for the fused passes.

The counterpart of the plan rewrites in the JAX package's
`exec/fused.py`.  A Sort/Limit over a filter and column-projection chain
lowers to ONE `SortRelation` that filters, sorts and projects in a
single pass (`rewrite_sort`); projection expressions inline into the
consumer (`substitute_columns`) and stacked Selections AND together
(`flatten_chain`).  The aggregate chain collapse and the batch-group
fold are not ported yet (ROADMAP queue 1, "batch-group folding"),
and neither is the JAX package's ``DATAFUSION_TPU_FUSE=0`` switch: its
off position needs the per-operator `PipelineRelation`, so it comes
with that slice.
"""

from __future__ import annotations

from typing import Optional

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
    SortExpr,
)


# -- plan-chain collapse --------------------------------------------------


def substitute_columns(e: Expr, proj: list[Expr]) -> Expr:
    """`e` with every Column(i) replaced by proj[i] — the projection
    inlining that lets a consumer's kernel evaluate the whole
    filter->project chain itself."""
    if isinstance(e, Column):
        return proj[e.index]
    if isinstance(e, Literal):
        return e
    if isinstance(e, Cast):
        return Cast(substitute_columns(e.expr, proj), e.data_type)
    if isinstance(e, IsNull):
        return IsNull(substitute_columns(e.expr, proj))
    if isinstance(e, IsNotNull):
        return IsNotNull(substitute_columns(e.expr, proj))
    if isinstance(e, BinaryExpr):
        return BinaryExpr(
            substitute_columns(e.left, proj),
            e.op,
            substitute_columns(e.right, proj),
        )
    if isinstance(e, ScalarFunction):
        return ScalarFunction(
            e.name, [substitute_columns(a, proj) for a in e.args],
            e.return_type,
        )
    if isinstance(e, AggregateFunction):
        out = AggregateFunction(
            e.name, [substitute_columns(a, proj) for a in e.args],
            e.return_type,
        )
        out.count_star = getattr(e, "count_star", False)
        return out
    if isinstance(e, SortExpr):
        return SortExpr(substitute_columns(e.expr, proj), e.asc)
    raise _Unfusable(f"cannot inline through {type(e).__name__}")


class _Unfusable(Exception):
    """Raised when a chain cannot collapse — callers fall back to the
    unfused per-operator lowering (never an error surface)."""


def flatten_chain(node):
    """Walk a Projection/Selection chain top-down and collapse it to
    (base_plan, predicate, projections, n_nodes):

    - `projections`: the top schema's exprs in terms of base columns
      (None when the chain had no Projection — identity),
    - `predicate`: every Selection AND-ed together, rewritten into base
      columns,
    - `n_nodes`: how many chain nodes collapsed (0 = `node` itself is
      the base).

    Returns None when a node can't inline (unknown expr kinds).
    """
    from datafusion_tpu_torch.plan.logical import Projection, Selection

    pred: Optional[Expr] = None
    proj: Optional[list[Expr]] = None
    n = 0
    try:
        while True:
            if isinstance(node, Projection):
                if proj is None:
                    proj = list(node.expr)
                else:
                    proj = [substitute_columns(e, node.expr) for e in proj]
                if pred is not None:
                    pred = substitute_columns(pred, node.expr)
                node = node.input
            elif isinstance(node, Selection):
                pred = (
                    node.expr
                    if pred is None
                    else BinaryExpr(pred, Operator.And, node.expr)
                )
                node = node.input
            else:
                return node, pred, proj, n
            n += 1
    except _Unfusable:
        return None


def rewrite_sort(sort_plan, limit: Optional[int]):
    """Collapse Sort(over a Projection/Selection chain) — optionally
    under a Limit — into (base, sort_exprs, predicate, output_cols)
    for ONE SortRelation that filters, sorts, and projects in a single
    pass.  Requires column-pure projections (sort output is a gather
    from source batches, so computed projections would need their own
    kernel) and Column sort keys after inlining; the predicate must be
    host-evaluable (it folds into the selection mask without a device
    round trip).  Returns None when any condition fails OR when there
    is nothing to fuse (bare Sort(scan))."""
    from datafusion_tpu_torch.exec.hostfn import host_evaluable

    flat = flatten_chain(sort_plan.input)
    if flat is None:
        return None
    base, pred, proj, n = flat
    if pred is None and proj is None:
        return None  # nothing between Sort and the base
    if proj is not None and not all(isinstance(e, Column) for e in proj):
        return None
    try:
        keys = [
            SortExpr(
                substitute_columns(se.expr, proj) if proj is not None
                else se.expr,
                se.asc,
            )
            for se in sort_plan.expr
        ]
    except _Unfusable:
        return None
    if not all(isinstance(k.expr, Column) for k in keys):
        return None
    if pred is not None and not host_evaluable(pred, {}, base.schema):
        return None
    output_cols = None if proj is None else [e.index for e in proj]
    return base, keys, pred, output_cols
