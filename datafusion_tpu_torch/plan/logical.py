"""Logical plan IR.

Mirrors the reference `LogicalPlan` enum (`src/logicalplan.rs:308-345`)
with the same pretty-print format (`logicalplan.rs:363-440`, asserted by
the planner golden tests) and the same externally-tagged JSON wire
format (`logicalplan.rs:307` serde; exact-format test at
`logicalplan.rs:609-648`) — the contract for shipping plan fragments to
remote workers in distributed mode.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.plan.expr import Expr, SortExpr


class LogicalPlan:
    """Base class for logical plan nodes."""

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> Sequence["LogicalPlan"]:
        return ()

    # -- pretty printing (reference fmt_with_indent, logicalplan.rs:363-440) --
    def _fmt(self, lines: list[str], indent: int) -> None:
        raise NotImplementedError

    def pretty(self) -> str:
        lines: list[str] = []
        self._fmt(lines, 0)
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.pretty()

    # -- JSON serde --
    def to_json(self):
        raise NotImplementedError

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), separators=(",", ":"), ensure_ascii=False)

    @staticmethod
    def from_json(obj) -> "LogicalPlan":
        if not isinstance(obj, dict) or len(obj) != 1:
            raise PlanError(f"Malformed LogicalPlan wire object: {obj!r}")
        ((tag, body),) = obj.items()
        decoder = _PLAN_DECODERS.get(tag)
        if decoder is None:
            raise PlanError(f"Unknown LogicalPlan variant {tag!r}")
        return decoder(body)

    @staticmethod
    def from_json_str(s: str) -> "LogicalPlan":
        return LogicalPlan.from_json(json.loads(s))


class EmptyRelation(LogicalPlan):
    """Zero-column, one-conceptual-row relation for table-less SELECTs."""

    def __init__(self, schema: Optional[Schema] = None):
        self._schema = schema if schema is not None else Schema([])

    @property
    def schema(self) -> Schema:
        return self._schema

    def _fmt(self, lines, indent):
        lines.append("  " * indent + "EmptyRelation")

    def to_json(self):
        return {"EmptyRelation": {"schema": self._schema.to_json()}}


class TableScan(LogicalPlan):
    """Scan of a registered datasource, with optional column projection
    (which decides which columns ever cross to device memory)."""

    def __init__(
        self,
        schema_name: str,
        table_name: str,
        schema: Schema,
        projection: Optional[list[int]] = None,
    ):
        self.schema_name = schema_name
        self.table_name = table_name
        self.table_schema = schema
        self.projection = projection

    @property
    def schema(self) -> Schema:
        if self.projection is None:
            return self.table_schema
        return self.table_schema.select(self.projection)

    def _fmt(self, lines, indent):
        if self.projection is None:
            proj = "None"
        else:
            proj = "Some([" + ", ".join(str(i) for i in self.projection) + "])"
        lines.append("  " * indent + f"TableScan: {self.table_name} projection={proj}")

    def to_json(self):
        return {
            "TableScan": {
                "schema_name": self.schema_name,
                "table_name": self.table_name,
                "schema": self.table_schema.to_json(),
                "projection": self.projection,
            }
        }


class Projection(LogicalPlan):
    def __init__(self, expr: Sequence[Expr], input: LogicalPlan, schema: Schema):
        self.expr = list(expr)
        self.input = input
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return (self.input,)

    def _fmt(self, lines, indent):
        lines.append(
            "  " * indent + "Projection: " + ", ".join(repr(e) for e in self.expr)
        )
        self.input._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Projection": {
                "expr": [e.to_json() for e in self.expr],
                "input": self.input.to_json(),
                "schema": self._schema.to_json(),
            }
        }


class Selection(LogicalPlan):
    """Row filter; schema passes through unchanged (reference has no
    schema field on this variant, `logicalplan.rs:318-323`)."""

    def __init__(self, expr: Expr, input: LogicalPlan):
        self.expr = expr
        self.input = input

    @property
    def schema(self) -> Schema:
        return self.input.schema

    def children(self):
        return (self.input,)

    def _fmt(self, lines, indent):
        lines.append("  " * indent + f"Selection: {self.expr!r}")
        self.input._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Selection": {
                "expr": self.expr.to_json(),
                "input": self.input.to_json(),
            }
        }


class Aggregate(LogicalPlan):
    """Grouped aggregation: output columns are group keys then aggregates."""

    def __init__(
        self,
        input: LogicalPlan,
        group_expr: Sequence[Expr],
        aggr_expr: Sequence[Expr],
        schema: Schema,
    ):
        self.input = input
        self.group_expr = list(group_expr)
        self.aggr_expr = list(aggr_expr)
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return (self.input,)

    def _fmt(self, lines, indent):
        group = "[" + ", ".join(repr(e) for e in self.group_expr) + "]"
        aggr = "[" + ", ".join(repr(e) for e in self.aggr_expr) + "]"
        lines.append("  " * indent + f"Aggregate: groupBy=[{group}], aggr=[{aggr}]")
        self.input._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Aggregate": {
                "input": self.input.to_json(),
                "group_expr": [e.to_json() for e in self.group_expr],
                "aggr_expr": [e.to_json() for e in self.aggr_expr],
                "schema": self._schema.to_json(),
            }
        }


class Sort(LogicalPlan):
    def __init__(self, expr: Sequence[SortExpr], input: LogicalPlan, schema: Schema):
        self.expr = list(expr)
        self.input = input
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return (self.input,)

    def _fmt(self, lines, indent):
        lines.append("  " * indent + "Sort: " + ", ".join(repr(e) for e in self.expr))
        self.input._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Sort": {
                "expr": [e.to_json() for e in self.expr],
                "input": self.input.to_json(),
                "schema": self._schema.to_json(),
            }
        }


class Limit(LogicalPlan):
    def __init__(self, limit: int, input: LogicalPlan, schema: Schema):
        self.limit = limit
        self.input = input
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return (self.input,)

    def _fmt(self, lines, indent):
        lines.append("  " * indent + f"Limit: {self.limit}")
        self.input._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Limit": {
                "limit": self.limit,
                "input": self.input.to_json(),
                "schema": self._schema.to_json(),
            }
        }


class Join(LogicalPlan):
    """Two-input equi-join (the variant the reference enum never grew).

    `on` is a list of (left_index, right_index) key pairs, each index
    positional within its OWN input's schema; `join_type` is "inner"
    or "left" (LEFT OUTER: unmatched probe rows survive with NULL
    build-side columns).  The output schema is left's fields followed
    by right's, with cross-input duplicate names qualified by the
    planner before the node is built.
    """

    JOIN_TYPES = ("inner", "left")

    def __init__(
        self,
        left: LogicalPlan,
        right: LogicalPlan,
        on: Sequence[tuple[int, int]],
        join_type: str,
        schema: Schema,
    ):
        if join_type not in self.JOIN_TYPES:
            raise PlanError(f"unknown join type {join_type!r}")
        self.left = left
        self.right = right
        self.on = [(int(l), int(r)) for l, r in on]
        self.join_type = join_type
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return (self.left, self.right)

    def _fmt(self, lines, indent):
        on = ", ".join(f"#{l}=#{r}" for l, r in self.on)
        lines.append("  " * indent + f"Join: type={self.join_type}, on=[{on}]")
        self.left._fmt(lines, indent + 1)
        self.right._fmt(lines, indent + 1)

    def to_json(self):
        return {
            "Join": {
                "left": self.left.to_json(),
                "right": self.right.to_json(),
                "on": [[l, r] for l, r in self.on],
                "join_type": self.join_type,
                "schema": self._schema.to_json(),
            }
        }


_PLAN_DECODERS = {
    "EmptyRelation": lambda b: EmptyRelation(Schema.from_json(b["schema"])),
    "TableScan": lambda b: TableScan(
        b["schema_name"], b["table_name"], Schema.from_json(b["schema"]), b["projection"]
    ),
    "Projection": lambda b: Projection(
        [Expr.from_json(e) for e in b["expr"]],
        LogicalPlan.from_json(b["input"]),
        Schema.from_json(b["schema"]),
    ),
    "Selection": lambda b: Selection(
        Expr.from_json(b["expr"]), LogicalPlan.from_json(b["input"])
    ),
    "Aggregate": lambda b: Aggregate(
        LogicalPlan.from_json(b["input"]),
        [Expr.from_json(e) for e in b["group_expr"]],
        [Expr.from_json(e) for e in b["aggr_expr"]],
        Schema.from_json(b["schema"]),
    ),
    "Sort": lambda b: Sort(
        [Expr.from_json(e) for e in b["expr"]],
        LogicalPlan.from_json(b["input"]),
        Schema.from_json(b["schema"]),
    ),
    "Limit": lambda b: Limit(
        b["limit"], LogicalPlan.from_json(b["input"]), Schema.from_json(b["schema"])
    ),
    "Join": lambda b: Join(
        LogicalPlan.from_json(b["left"]),
        LogicalPlan.from_json(b["right"]),
        [(p[0], p[1]) for p in b["on"]],
        b["join_type"],
        Schema.from_json(b["schema"]),
    ),
}


def scan_tables(plan: LogicalPlan) -> list[str]:
    """The names of the tables `plan` scans, each once, in plan order."""
    out: list[str] = []
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, TableScan):
            if node.table_name not in out:
                out.append(node.table_name)
        stack.extend(reversed(list(node.children())))
    return out
