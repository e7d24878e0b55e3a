"""ExecutionContext: the API hub (reference `src/execution/context.rs`).

The counterpart of the JAX package's `exec/context.py`.  `ctx.sql(text)`
parses, plans and optimizes (projection push-down), then maps the plan
onto operators:

    TableScan                        -> DataSourceRelation
    Aggregate(Selection(x))          -> AggregateRelation with the
                                        predicate evaluated inside it
    Aggregate(x)                     -> AggregateRelation
    Join(l, r)                       -> HashJoinRelation
    [Limit](Sort(Projection/Selection chain))
                                     -> one SortRelation that filters,
                                        sorts and projects
                                        (exec/fused.rewrite_sort)
    [Limit](Sort(x))                 -> SortRelation
    Limit(x)                         -> LimitRelation

Every other plan node (a Projection or Selection that does not fold
into a Sort or an Aggregate needs PipelineRelation), DDL, EXPLAIN,
result caching, cost rewriting and telemetry raise NotSupportedError
until their slice lands (ROADMAP queue 1).

Device selection: `device=None` means `cuda:0`, and the context raises
ExecutionError when no CUDA device is available — it never carries on
quietly on the CPU.  `device="cpu"` is how a caller (the tests) asks
for the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.errors import ExecutionError, NotSupportedError
from datafusion_tpu_torch.exec import fused
from datafusion_tpu_torch.exec.aggregate import AggregateRelation
from datafusion_tpu_torch.exec.datasource import DataSource
from datafusion_tpu_torch.exec.relation import DataSourceRelation, Relation
from datafusion_tpu_torch.exec.sort import LimitRelation, SortRelation
from datafusion_tpu_torch.join.relation import HashJoinRelation
from datafusion_tpu_torch.plan.expr import FunctionMeta, FunctionType
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    Join,
    Limit,
    LogicalPlan,
    Selection,
    Sort,
    TableScan,
)
from datafusion_tpu_torch.sql import ast
from datafusion_tpu_torch.sql.optimizer import push_down_projection
from datafusion_tpu_torch.sql.parser import parse_sql
from datafusion_tpu_torch.sql.planner import SqlToRel


class _ContextSchemaProvider:
    """Adapter exposing the context's catalog to the planner."""

    def __init__(self, ctx: "ExecutionContext"):
        self.ctx = ctx

    def get_table_meta(self, name: str) -> Optional[Schema]:
        ds = self.ctx.datasources.get(name)
        return ds.schema if ds is not None else None

    def get_function_meta(self, name: str) -> Optional[FunctionMeta]:
        return self.ctx.functions.get(name.lower())


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutionError(
                f"no CUDA device available for {dev}; pass device='cpu' "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ExecutionError(f"no {dev} device available")
    elif dev.type != "cpu":
        raise ExecutionError(f"unsupported device {dev}")
    return dev


class ExecutionContext:
    """Register datasources, run SQL, pull columnar results.

    `device`: None (`cuda:0`), a CUDA device, or "cpu".
    `result_cache`: only None or False; result caching is not ported.
    """

    def __init__(self, device=None, batch_size: int = 131072,
                 result_cache=None):
        if result_cache not in (None, False):
            raise NotSupportedError(
                "result caching is not ported yet (ROADMAP queue 1, "
                "item 11: serving, ingest, cost and cache planes)"
            )
        self.datasources: dict[str, DataSource] = {}
        self.functions: dict[str, FunctionMeta] = {}
        self.batch_size = batch_size
        self.device = _resolve_device(device)
        # builtin math functions are ordinary catalog entries
        from datafusion_tpu_torch.exec.expression import BUILTIN_FUNCTIONS

        for fname, fn in BUILTIN_FUNCTIONS.items():
            self.register_udf(fname, [DataType.FLOAT64], DataType.FLOAT64, fn)

    # -- catalog --
    def register_datasource(self, name: str, ds: DataSource) -> None:
        self.datasources[name] = ds

    def register_udf(
        self,
        name: str,
        arg_types: list[DataType],
        return_type: DataType,
        torch_fn: Optional[Callable] = None,
        host_fn: Optional[Callable] = None,
    ) -> None:
        """Register a scalar UDF.  `torch_fn` maps tensors to a tensor
        and runs on the batch's device.  Host functions (numpy in/out)
        evaluate at the materialization boundary of the pipeline
        operator, which is not ported yet."""
        if host_fn is not None:
            raise NotSupportedError(
                "host_fn UDFs need PipelineRelation (ROADMAP queue 1, "
                "PipelineRelation and the CSV scan)"
            )
        if torch_fn is None:
            raise ExecutionError(f"UDF {name!r} needs a torch_fn")
        self.functions[name.lower()] = FunctionMeta(
            name.lower(),
            [Field(f"arg{i}", t, True) for i, t in enumerate(arg_types)],
            return_type,
            FunctionType.Scalar,
            torch_fn,
        )

    def _torch_functions(self) -> dict[str, Callable]:
        return {name: fm.torch_fn for name, fm in self.functions.items() if fm.torch_fn}

    # -- entry points --
    def sql(self, sql_text: str) -> Relation:
        """Parse, plan, optimize, build the operator tree (lazy — no
        data is read until batches are pulled)."""
        stmt = parse_sql(sql_text)
        if not isinstance(stmt, ast.SqlSelect):
            raise NotSupportedError(
                f"{type(stmt).__name__} is not ported yet (ROADMAP queue 1)"
            )
        return self.execute(self._plan(stmt))

    def _plan(self, stmt: ast.SqlNode) -> LogicalPlan:
        plan = SqlToRel(_ContextSchemaProvider(self)).sql_to_rel(stmt)
        return push_down_projection(plan)

    def execute(self, plan: LogicalPlan) -> Relation:
        """Map a logical plan onto operators (reference `context.rs:103`)."""
        rel = self._execute_fused(plan)
        if rel is not None:
            return rel
        if isinstance(plan, TableScan):
            ds = self.datasources.get(plan.table_name)
            if ds is None:
                raise ExecutionError(f"No datasource registered as {plan.table_name!r}")
            if plan.projection is not None:
                ds = ds.with_projection(plan.projection)
            return DataSourceRelation(ds)
        if isinstance(plan, Aggregate):
            # Aggregate(Selection(x)): the predicate runs inside the
            # aggregate operator
            if isinstance(plan.input, Selection):
                child = self.execute(plan.input.input)
                pred = plan.input.expr
            else:
                child = self.execute(plan.input)
                pred = None
            return AggregateRelation(
                child, plan.group_expr, plan.aggr_expr, plan.schema,
                self.device, predicate=pred, functions=self._torch_functions(),
            )
        if isinstance(plan, Sort):
            return SortRelation(
                self.execute(plan.input), plan.expr, plan.schema, self.device
            )
        if isinstance(plan, Limit):
            if isinstance(plan.input, Sort):
                # the sort slices its permutation directly
                return SortRelation(
                    self.execute(plan.input.input), plan.input.expr,
                    plan.schema, self.device, limit=plan.limit,
                )
            return LimitRelation(self.execute(plan.input), plan.limit, plan.schema)
        if isinstance(plan, Join):
            return HashJoinRelation(
                self.execute(plan.left), self.execute(plan.right),
                plan.on, plan.join_type, plan.schema, self.device,
            )
        raise NotSupportedError(
            f"plan node {type(plan).__name__} is not ported yet (ROADMAP queue 1)"
        )

    def _execute_fused(self, plan: LogicalPlan) -> Optional[Relation]:
        """Collapse [Limit](Sort(...)) over a filter/column-projection
        chain into ONE SortRelation (exec/fused.rewrite_sort).  Returns
        None when the plan is not such a chain; the caller then lowers
        node by node."""
        limit = None
        sort = plan
        if isinstance(plan, Limit) and isinstance(plan.input, Sort):
            limit, sort = plan.limit, plan.input
        if not isinstance(sort, Sort):
            return None
        hit = fused.rewrite_sort(sort, limit)
        if hit is None:
            return None
        base, keys, pred, out_cols = hit
        return SortRelation(
            self.execute(base), keys, plan.schema, self.device, limit=limit,
            predicate=pred, output_cols=out_cols,
        )
