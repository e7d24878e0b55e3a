"""Fused passes: plan-chain collapse and the batch-group fold.

The counterpart of the JAX package's `exec/fused.py`.  Two layers, both
behind ``DATAFUSION_TPU_FUSE`` (default on; ``=0`` turns both off):

- **Plan-chain collapse**: projection expressions inline into the
  consumer (`substitute_columns`) and stacked Selections AND together
  (`flatten_chain`), so
  - an Aggregate over a filter/project chain lowers to ONE
    `AggregateRelation` (`rewrite_aggregate`);
  - a Sort/Limit over a filter and column-projection chain lowers to
    ONE `SortRelation` that filters, sorts and projects in a single
    pass (`rewrite_sort`);
  - a deeper filter/project chain lowers to ONE `PipelineRelation`
    (exec/context.py).
  With ``DATAFUSION_TPU_FUSE=0`` the plan lowers node by node, to the
  same rows.

- **Batch-group fold**: the state-carrying operators (aggregate, TopK)
  and the pipeline collect a scan's per-batch inputs and run a whole
  *batch group* as one pass: a run of up to `fuse_group_max()` batches
  (`pipeline_group_max()` for the pipeline) whose entries share one
  `entry_signature` and one `shared_signature` (`iter_groups`).  On the
  H100 a group's entries are **concatenated along rows**, where the JAX
  package stacks them for a `lax.scan`, so rows need not match from
  batch to batch: the grouped reduce runs once per slot over the
  group's rows, the sort-merge aggregate and the TopK sort once per
  group.  The signature is an entry's structure (which validities and
  masks are None, and the dtypes) and the identity of the shared aux
  and string-rank tensors, so a dictionary that grows mid-scan starts a
  new group.  With ``DATAFUSION_TPU_FUSE=0`` every operator updates once
  per batch, as before the fold.

  The JAX package's `pad_group`, its group-size ladder and
  `stack_entries` are not ported: they exist to bound XLA recompiles
  (one program per ladder rung), eager torch compiles nothing per group
  size, and padding would only add identity rows to the concatenation.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

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


def fusion_enabled() -> bool:
    """The escape hatch: DATAFUSION_TPU_FUSE=0 lowers every plan node
    by itself and runs every operator once per batch."""
    return os.environ.get("DATAFUSION_TPU_FUSE", "1") != "0"


def fuse_group_max() -> int:
    """Max batches folded into one pass of the aggregate or the TopK
    (`DATAFUSION_TPU_FUSE_GROUP`, 256): bounds how many batches' device
    inputs a group holds at once."""
    return max(1, int(os.environ.get("DATAFUSION_TPU_FUSE_GROUP", "256")))


def pipeline_group_max() -> int:
    """Max batches per pipeline (filter/project) pass
    (`DATAFUSION_TPU_FUSE_PIPELINE`, default `fuse_batch_count()`).
    Smaller than the aggregate's group: the pipeline yields its
    outputs, so grouping trades first-batch latency for passes."""
    from datafusion_tpu_torch.exec.kernels import fuse_batch_count

    v = os.environ.get("DATAFUSION_TPU_FUSE_PIPELINE")
    return max(1, int(v)) if v else fuse_batch_count()


# -- batch-group collection ----------------------------------------------


def entry_signature(entry) -> tuple:
    """Hashable structure of a prepared per-batch entry: nested tuples
    and lists walked in order, a tensor by its dtype (not its length:
    a group concatenates rows), None as itself, a Python number by its
    type.  Entries with one signature concatenate leaf by leaf."""
    if isinstance(entry, (tuple, list)):
        return tuple(entry_signature(e) for e in entry)
    if entry is None:
        return None
    if isinstance(entry, torch.Tensor):
        return ("tensor", entry.dtype)
    return (type(entry).__name__,)


def shared_signature(shared) -> tuple:
    """Identity of a group's shared (not concatenated) inputs: the aux
    and string-rank tensors.  They are cached per dictionary version, so
    a batch whose dictionary grew gets fresh tensors and starts a new
    group."""
    if isinstance(shared, (tuple, list)):
        return tuple(shared_signature(s) for s in shared)
    return None if shared is None else id(shared)


def iter_groups(entries, shareds):
    """Split a chunk of (entry, shared) pairs into maximal consecutive
    runs with one signature; yields (indices, shared) per group."""
    start = 0
    cur = None
    for i, (e, s) in enumerate(zip(entries, shareds)):
        sig = (entry_signature(e), shared_signature(s))
        if cur is None:
            cur = sig
        elif sig != cur:
            yield list(range(start, i)), shareds[start]
            start, cur = i, sig
    if cur is not None:
        yield list(range(start, len(entries))), shareds[start]


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


def rewrite_aggregate(plan):
    """Collapse Aggregate(over a Projection/Selection chain) into the
    (base, group_expr, aggr_expr, predicate) of ONE AggregateRelation,
    or None when the shape doesn't admit it (non-Column group keys
    after inlining, Utf8 MIN/MAX over computed exprs).  Chains the
    default lowering already fuses (bare Aggregate(Selection(scan)))
    return None too."""
    from datafusion_tpu_torch.datatypes import DataType
    from datafusion_tpu_torch.errors import DataFusionError

    flat = flatten_chain(plan.input)
    if flat is None:
        return None
    base, pred, proj, n = flat
    if proj is None:
        return None  # no projection in the chain: the default lowering fuses it
    try:
        group_expr = [substitute_columns(g, proj) for g in plan.group_expr]
        aggr_expr = [substitute_columns(a, proj) for a in plan.aggr_expr]
    except _Unfusable:
        return None
    if not all(isinstance(g, Column) for g in group_expr):
        return None
    for a in aggr_expr:
        # Utf8 MIN/MAX needs a bare column (dictionary-code accumulator)
        if not isinstance(a, AggregateFunction) or not a.args:
            return None
        arg = a.args[0]
        try:
            utf8 = arg.get_type(base.schema) == DataType.UTF8
        except DataFusionError:  # a type error means "don't fuse"
            return None
        if utf8 and a.name.lower() in ("min", "max") and not isinstance(arg, Column):
            return None
    return base, group_expr, aggr_expr, pred


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
