"""Cost-driven logical rewrites: join build side and join order (the
JAX package's `cost/optimizer.py`).

The syntactic plan builds the hash table over the RIGHT input and joins
left-deep in FROM-clause order.  With learned row counts two rewrites
apply:

* **build-side swap** (``join.build_side``): an inner join whose LEFT
  input is under `_SWAP_FACTOR` of its right swaps inputs, so the
  smaller side builds (on the card: the build kernel over a dense key
  range, `csrc/hash_build.cu`) and the larger streams as the probe,
  with a restoring projection on top so the output schema is identical;
* **dimension reorder** (``join.order``): a left-deep chain of inner
  joins whose outer keys all come from the base (fact) input joins its
  cheaper dimension first.

Both pass through `analysis.verify.assert_schema_preserved`, so a
rewrite can change how a plan runs, never its schema; the caller
(`ExecutionContext._cost_rewrite`) discards a vetoed rewrite.  Row
order within an unordered join's result may differ from the static
plan's (the probe side's order), as SQL allows.
"""

from __future__ import annotations

from typing import Optional

from datafusion_tpu_torch import cost as _cost
from datafusion_tpu_torch.cost import advisor
from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.plan.expr import Column
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Selection,
    Sort,
    TableScan,
)

# a build side must be under this fraction of the probe side before a
# swap pays for its restoring projection
_SWAP_FACTOR = 0.5


def apply_cost_rewrites(ctx, plan: LogicalPlan) -> LogicalPlan:
    """Rewrite `plan` using the process cost store.  Identity when the
    subsystem is disabled or the store knows nothing relevant."""
    if not _cost.enabled():
        return plan
    store = _cost.store()
    new = _walk(ctx, store, plan)
    if new is not plan:
        from datafusion_tpu_torch.analysis.verify import assert_schema_preserved

        assert_schema_preserved(plan.schema, new.schema, "cost rewrite")
    return new


def estimated_rows(ctx, store, plan: LogicalPlan) -> Optional[int]:
    """Learned output row count of a subtree: the scanned table's
    observed rows, passed through row-preserving/reducing nodes as an
    upper bound.  None = never observed (the rewrite stands down)."""
    if isinstance(plan, TableScan):
        return advisor.table_rows(store, _cost.table_key(ctx, plan.table_name))
    if isinstance(plan, (Selection, Projection)):
        return estimated_rows(ctx, store, plan.input)
    return None


def _walk(ctx, store, plan: LogicalPlan) -> LogicalPlan:
    if isinstance(plan, Join):
        left = _walk(ctx, store, plan.left)
        right = _walk(ctx, store, plan.right)
        if left is not plan.left or right is not plan.right:
            plan = Join(left, right, plan.on, plan.join_type, plan.schema)
        plan = _maybe_reorder(ctx, store, plan)
        if isinstance(plan, Join):
            plan = _maybe_swap(ctx, store, plan)
        return plan
    if isinstance(plan, Selection):
        inp = _walk(ctx, store, plan.input)
        return plan if inp is plan.input else Selection(plan.expr, inp)
    if isinstance(plan, Projection):
        inp = _walk(ctx, store, plan.input)
        if inp is plan.input:
            return plan
        return Projection(plan.expr, inp, plan.schema)
    if isinstance(plan, Aggregate):
        inp = _walk(ctx, store, plan.input)
        if inp is plan.input:
            return plan
        return Aggregate(inp, plan.group_expr, plan.aggr_expr, plan.schema)
    if isinstance(plan, Sort):
        inp = _walk(ctx, store, plan.input)
        return plan if inp is plan.input else Sort(plan.expr, inp, plan.schema)
    if isinstance(plan, Limit):
        inp = _walk(ctx, store, plan.input)
        return plan if inp is plan.input else Limit(plan.limit, inp, plan.schema)
    return plan


def _restore(plan_schema: Schema, reordered: LogicalPlan,
             old_to_new: list[int]) -> Projection:
    """Bare-column projection restoring the pre-rewrite column order
    (`old_to_new[i]` = where old output column i now lives).  Bare
    references pass host arrays through untouched downstream, so the
    restoring node costs a gather of column POINTERS, not data."""
    return Projection(
        [Column(old_to_new[i]) for i in range(len(plan_schema))],
        reordered, plan_schema,
    )


def _maybe_swap(ctx, store, j: Join) -> LogicalPlan:
    """Build the smaller side: swap an inner join whose left input is
    measurably smaller than its right (the static engine always
    builds right)."""
    if j.join_type != "inner":
        # LEFT OUTER must keep the probe side = preserved side
        return j
    lr = estimated_rows(ctx, store, j.left)
    rr = estimated_rows(ctx, store, j.right)
    if lr is None or rr is None or lr >= rr * _SWAP_FACTOR:
        return j
    n_l, n_r = len(j.left.schema), len(j.right.schema)
    inner_schema = Schema(
        list(j.right.schema.fields) + list(j.left.schema.fields)
    )
    swapped = Join(
        j.right, j.left, [(r, l) for l, r in j.on], "inner", inner_schema
    )
    old_to_new = [n_r + i for i in range(n_l)] + list(range(n_r))
    store.note_decision(
        "join.build_side", "left", "right",
        f"left ~{lr} rows < right ~{rr} rows: build the smaller side",
    )
    return _restore(j.schema, swapped, old_to_new)


def _maybe_reorder(ctx, store, j: Join) -> LogicalPlan:
    """Reorder Join(Join(base, d1), d2) to join the cheaper-build
    dimension first.  Applies only to the star shape where both joins
    are inner and every key of the OUTER join references the base
    input (so d1 and d2 are independent dimensions of one fact table
    and commute)."""
    inner = j.left
    if (
        j.join_type != "inner"
        or not isinstance(inner, Join)
        or inner.join_type != "inner"
    ):
        return j
    n_base = len(inner.left.schema)
    if any(l >= n_base for l, _ in j.on):
        return j  # outer join keys reach into d1: not independent
    d1_rows = estimated_rows(ctx, store, inner.right)
    d2_rows = estimated_rows(ctx, store, j.right)
    if d1_rows is None or d2_rows is None or d2_rows >= d1_rows:
        return j
    n_d1, n_d2 = len(inner.right.schema), len(j.right.schema)
    base_f = list(inner.left.schema.fields)
    d1_f = list(inner.right.schema.fields)
    d2_f = list(j.right.schema.fields)
    first = Join(
        inner.left, j.right, j.on, "inner", Schema(base_f + d2_f)
    )
    second = Join(
        first, inner.right, inner.on, "inner",
        Schema(base_f + d2_f + d1_f),
    )
    # old layout: base, d1, d2 -> new layout: base, d2, d1
    old_to_new = (
        list(range(n_base))
        + [n_base + n_d2 + i for i in range(n_d1)]
        + [n_base + i for i in range(n_d2)]
    )
    store.note_decision(
        "join.order", "smallest dimension first", "FROM-clause order",
        f"dimension builds ~{d2_rows} rows < ~{d1_rows} rows",
    )
    return _restore(j.schema, second, old_to_new)
