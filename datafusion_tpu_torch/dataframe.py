"""DataFrame API: programmatic plan building.

The counterpart of the JAX package's `dataframe.py`: a lazy, immutable
`DataFrame` over a `LogicalPlan`, executed by the same plan->operator
boundary as SQL (`ExecutionContext.execute`, the static verifier
included), so every device path is reachable without SQL text.

    df = ctx.table("sales")
    out = (df.filter(df.col("qty").gt(lit(100)))
             .aggregate([df.col("region")], [f.sum(df.col("price"))])
             .collect())
"""

from __future__ import annotations

from typing import Sequence, Union

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.plan.expr import (
    AggregateFunction,
    Column,
    Expr,
    Literal,
    ScalarFunction,
    ScalarValue,
    SortExpr,
    expr_to_field,
)
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    Limit,
    LogicalPlan,
    Projection,
    Selection,
    Sort,
)


def lit(value) -> Literal:
    """A literal expression from a python value."""
    if value is None:
        return Literal(ScalarValue.null())
    if isinstance(value, bool):
        return Literal(ScalarValue.boolean(value))
    if isinstance(value, int):
        return Literal(ScalarValue.int64(value))
    if isinstance(value, float):
        return Literal(ScalarValue.float64(value))
    if isinstance(value, str):
        return Literal(ScalarValue.utf8(value))
    raise PlanError(f"cannot make a literal from {type(value).__name__}")


def _as_expr(v) -> Expr:
    return v if isinstance(v, Expr) else lit(v)


class _AggBuilder:
    """Aggregate helpers; args stay raw here — `DataFrame.aggregate`
    resolves strings to columns and computes return types against the
    input schema (planner contract: return type = arg type; COUNT
    returns UInt64 — `sqlplanner.rs:296-329`)."""

    @staticmethod
    def _make(name, expr):
        return ("agg", name, expr)

    def sum(self, expr):
        return self._make("SUM", expr)

    def min(self, expr):
        return self._make("MIN", expr)

    def max(self, expr):
        return self._make("MAX", expr)

    def avg(self, expr):
        return self._make("AVG", expr)

    def count(self, expr=None):
        if expr is None:
            return ("agg_count_star", "COUNT", Column(0))
        return self._make("COUNT", expr)


f = _AggBuilder()


class DataFrame:
    """A lazy, immutable relational expression (executes on collect)."""

    def __init__(self, ctx, plan: LogicalPlan):
        self._ctx = ctx
        self._plan = plan

    # -- schema & column resolution --
    @property
    def schema(self) -> Schema:
        return self._plan.schema

    def col(self, name: str) -> Column:
        """Column reference by name (resolved by position, like the
        planner's identifier lookup, `sqlplanner.rs:214-223`)."""
        names = self.schema.names()
        if name not in names:
            raise PlanError(f"no column {name!r} in {names}")
        return Column(names.index(name))

    def __getitem__(self, name: str) -> Column:
        return self.col(name)

    # -- transformations (each returns a new DataFrame) --
    def select(self, *exprs: Union[Expr, str]) -> "DataFrame":
        resolved = [self.col(e) if isinstance(e, str) else _as_expr(e) for e in exprs]
        schema = Schema([expr_to_field(e, self.schema) for e in resolved])
        return DataFrame(self._ctx, Projection(resolved, self._plan, schema))

    def filter(self, predicate: Expr) -> "DataFrame":
        return DataFrame(self._ctx, Selection(predicate, self._plan))

    def aggregate(self, group_exprs: Sequence[Union[Expr, str]], aggr_specs) -> "DataFrame":
        group = [self.col(g) if isinstance(g, str) else g for g in group_exprs]
        aggr = []
        for spec in aggr_specs:
            if not (isinstance(spec, tuple) and spec[0] in ("agg", "agg_count_star")):
                raise PlanError(
                    "aggregate expressions must come from the f.* helpers "
                    f"(got {spec!r})"
                )
            kind, name, arg = spec
            # strings resolve as column names (same as select/group)
            arg = self.col(arg) if isinstance(arg, str) else _as_expr(arg)
            if name == "COUNT":
                aggr.append(
                    AggregateFunction(name, [arg], DataType.UINT64, kind == "agg_count_star")
                )
            else:
                aggr.append(AggregateFunction(name, [arg], arg.get_type(self.schema)))
        fields = [expr_to_field(g, self.schema) for g in group] + [
            expr_to_field(a, self.schema) for a in aggr
        ]
        return DataFrame(self._ctx, Aggregate(self._plan, group, aggr, Schema(fields)))

    def sort(self, *keys: Union[Expr, SortExpr, str]) -> "DataFrame":
        resolved = []
        for k in keys:
            if isinstance(k, str):
                k = self.col(k)
            if not isinstance(k, SortExpr):
                k = SortExpr(k, True)
            resolved.append(k)
        return DataFrame(self._ctx, Sort(resolved, self._plan, self.schema))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._ctx, Limit(n, self._plan, self.schema))

    def function(self, name: str, *args) -> ScalarFunction:
        """A registered-UDF call expression, typed from the catalog."""
        fm = self._ctx.functions.get(name.lower())
        if fm is None:
            raise PlanError(f"no function {name!r} registered")
        return ScalarFunction(fm.name, [_as_expr(a) for a in args], fm.return_type)

    # -- execution --
    def logical_plan(self) -> LogicalPlan:
        return self._plan

    def explain(self) -> str:
        return repr(self._plan)

    def collect(self):
        from datafusion_tpu_torch.exec.materialize import collect
        from datafusion_tpu_torch.sql.optimizer import push_down_projection

        # same optimize step as the SQL path: the scan projection
        # decides which columns are parsed and copied to the device
        return collect(self._ctx.execute(push_down_projection(self._plan)))

    def to_pylist(self) -> list[dict]:
        return self.collect().to_pylist()
