"""Plan-IR verifier: schema/type checking before lowering.

The counterpart of the JAX package's `analysis/verify.py`, with its
names, checks and messages.  Without it a bad dtype or an unknown
column surfaces deep inside an operator, mid-scan.  This pass walks a
LogicalPlan bottom-up, infers every operator's output schema, and
checks:

- **column resolution**: every ``Column(i)`` resolves in its input
  schema (with the available column names in the diagnostic);
- **dtype propagation** through every expr variant — supertype rules
  for arithmetic, boolean operands for AND/OR, Utf8 comparison shapes
  (column-vs-literal only: comparing dictionary *codes* against a
  number would silently compute garbage), Cast representability, UDF
  signatures against the function registry;
- **operator contracts**: aggregate names/arity, Selection predicates
  must be Boolean, Sort keys must be orderable columns, declared node
  schemas must match what the expressions actually compute;
- **fusibility preconditions** from ``exec/fused.py`` that are also
  hard executor requirements: GROUP BY keys must be bare Columns, and
  Utf8 MIN/MAX arguments must be bare Columns.

Every finding is *source-anchored*: the diagnostic names the plan path
(``Aggregate.group_expr[0]``) and the offending expression, so the
error reads like a compiler error, not a runtime traceback.

``verify_enabled()`` gates the in-engine hook
(``DATAFUSION_TPU_VERIFY``, default on; ``=0`` restores the
pre-verifier behavior byte-identically).  ``EXPLAIN VERIFY <sql>``
renders the inferred schema per operator plus any diagnostics without
executing the query.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from datafusion_tpu_torch.datatypes import (
    DataType,
    Schema,
    can_coerce_from,
    get_supertype,
)
from datafusion_tpu_torch.errors import PlanVerificationError
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

_FALSY = ("0", "false", "off", "no")

# the aggregate functions the executor implements (exec/aggregate.py
# AggregateSpec); anything else raises NotSupportedError mid-execution
_KNOWN_AGGREGATES = ("sum", "count", "min", "max", "avg")

# sentinel for "the expression is a typed NULL" (a null literal has no
# datatype but is valid almost everywhere a value is)
_NULL = object()


def verify_enabled() -> bool:
    """The engine hook gate: DATAFUSION_TPU_VERIFY=0 restores the
    unverified paths byte-identically."""
    return os.environ.get("DATAFUSION_TPU_VERIFY", "1").lower() not in _FALSY


def assert_schema_preserved(before: Schema, after: Schema,
                            what: str = "rewrite") -> None:
    """The cost-optimizer contract: a cost-driven physical choice
    (build-side swap, dimension reorder, chunk resize) may change HOW
    a plan runs, never WHAT it returns — the rewritten plan's inferred
    schema must equal the original field-for-field (name, type,
    nullability).  Raises `PlanVerificationError` on any drift, which
    the planner treats as "discard the rewrite", so a buggy rewrite
    can degrade performance but never correctness."""
    if before == after:
        return
    want = ", ".join(f"{f.name}: {f.data_type!r}" for f in before.fields)
    got = ", ".join(f"{f.name}: {f.data_type!r}" for f in after.fields)
    raise PlanVerificationError(
        f"{what} changed the inferred schema: expected ({want}), "
        f"got ({got})",
        [Diagnostic("root", f"{what} must preserve the plan schema")],
    )


class Diagnostic:
    """One verification finding, anchored to a plan location."""

    __slots__ = ("path", "message", "expr")

    def __init__(self, path: str, message: str, expr: Optional[Expr] = None):
        self.path = path
        self.message = message
        self.expr = None if expr is None else repr(expr)

    def __repr__(self) -> str:
        anchor = f"at {self.path}"
        if self.expr is not None:
            anchor += f" (`{self.expr}`)"
        return f"{anchor}: {self.message}"


class VerifyReport:
    """The verifier's output: per-operator inferred schemas (rendered
    by EXPLAIN VERIFY) plus the diagnostics (empty = plan verified)."""

    def __init__(self):
        self.diagnostics: list[Diagnostic] = []
        # (depth, operator label, inferred schema) in pre-order
        self.operators: list[tuple[int, str, Schema]] = []

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def add(self, path: str, message: str, expr: Optional[Expr] = None) -> None:
        self.diagnostics.append(Diagnostic(path, message, expr))

    def raise_if_failed(self) -> None:
        if self.ok:
            return
        head = "; ".join(repr(d) for d in self.diagnostics[:3])
        more = len(self.diagnostics) - 3
        if more > 0:
            head += f" (+{more} more)"
        raise PlanVerificationError(
            f"plan verification failed: {head}", self.diagnostics
        )

    def render(self) -> str:
        lines = []
        for depth, label, schema in self.operators:
            cols = ", ".join(
                f"{f.name}: {f.data_type!r}" for f in schema.fields
            )
            lines.append("  " * depth + f"{label}  :: ({cols})")
        if self.ok:
            lines.append("plan verified: OK")
        else:
            lines.append(f"plan verification FAILED "
                         f"({len(self.diagnostics)} diagnostics):")
            lines.extend(f"  - {d!r}" for d in self.diagnostics)
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.render()


class ExplainVerifyResult:
    """Materialized `EXPLAIN VERIFY <stmt>`: the logical plan plus the
    verifier's report (the query does NOT execute)."""

    def __init__(self, plan: LogicalPlan, report: VerifyReport):
        self.plan = plan
        self.report = report

    @property
    def ok(self) -> bool:
        return self.report.ok

    def __repr__(self) -> str:
        return "EXPLAIN VERIFY\n" + self.report.render()


class _ExprChecker:
    """Type inference over one operator's input schema, accumulating
    diagnostics instead of raising.  Returns a DataType, the `_NULL`
    sentinel (typed null), or None when the subtree already produced a
    diagnostic (so one bad column doesn't cascade)."""

    def __init__(self, schema: Schema, functions, report: VerifyReport):
        self.schema = schema
        self.functions = functions  # name -> FunctionMeta, or None
        self.report = report

    def _columns_hint(self) -> str:
        names = ", ".join(
            f"#{i} {f.name!r}" for i, f in enumerate(self.schema.fields)
        )
        return names if names else "<no columns>"

    def infer(self, e: Expr, path: str):
        if isinstance(e, Column):
            if not 0 <= e.index < len(self.schema):
                self.report.add(
                    path,
                    f"unknown column #{e.index}: the input schema has "
                    f"{len(self.schema)} column(s) ({self._columns_hint()})",
                    e,
                )
                return None
            return self.schema.field(e.index).data_type
        if isinstance(e, Literal):
            if e.value.is_null:
                return _NULL
            return e.value.get_datatype()
        if isinstance(e, Cast):
            src = self.infer(e.expr, f"{path}.expr")
            if src in (None, _NULL):
                return e.data_type
            if src != e.data_type and (
                src == DataType.UTF8 or e.data_type == DataType.UTF8
            ):
                self.report.add(
                    path,
                    f"CAST {src!r} -> {e.data_type!r} is not supported "
                    "(strings have no tensor form)",
                    e,
                )
                return None
            return e.data_type
        if isinstance(e, (IsNull, IsNotNull)):
            self.infer(e.expr, f"{path}.expr")
            return DataType.BOOLEAN
        if isinstance(e, BinaryExpr):
            return self._infer_binary(e, path)
        if isinstance(e, ScalarFunction):
            return self._infer_function(e, path)
        if isinstance(e, AggregateFunction):
            self.report.add(
                path,
                f"aggregate function {e.name!r} outside an Aggregate "
                "operator (aggregates are handled by the aggregate "
                "operator, not the scalar compiler)",
                e,
            )
            return None
        if isinstance(e, SortExpr):
            self.report.add(
                path, "SortExpr is only valid as a Sort operator key", e
            )
            return None
        self.report.add(path, f"unknown expression variant {type(e).__name__}", e)
        return None

    # a bare Utf8 literal has no tensor form; it is only consumable as
    # the literal side of a comparison against a Utf8 column (the
    # kernel rides dictionary codes / compare tables)
    def infer_value(self, e: Expr, path: str):
        t = self.infer(e, path)
        if t == DataType.UTF8 and isinstance(e, Literal):
            self.report.add(
                path,
                "bare string literals only appear inside comparisons "
                "against a Utf8 column (no tensor form)",
                e,
            )
            return None
        return t

    def _infer_binary(self, e: BinaryExpr, path: str):
        op = e.op
        if op.is_boolean:
            for side, sub in ((e.left, "left"), (e.right, "right")):
                t = self.infer_value(side, f"{path}.{sub}")
                if t not in (None, _NULL, DataType.BOOLEAN):
                    self.report.add(
                        f"{path}.{sub}",
                        f"{op.name} operand computes {t!r}, expected Boolean",
                        side,
                    )
            return DataType.BOOLEAN
        lt = self.infer(e.left, f"{path}.left")
        rt = self.infer(e.right, f"{path}.right")
        if lt is None or rt is None:
            return DataType.BOOLEAN if op.is_comparison else None
        utf8 = DataType.UTF8
        if lt == utf8 or rt == utf8:
            return self._infer_string_binary(e, lt, rt, path)
        if op.is_comparison:
            if _NULL not in (lt, rt) and get_supertype(lt, rt) is None:
                self.report.add(
                    path,
                    f"cannot compare {lt!r} with {rt!r} "
                    "(no common supertype)",
                    e,
                )
            return DataType.BOOLEAN
        if lt is _NULL:
            return rt
        if rt is _NULL:
            return lt
        st = get_supertype(lt, rt)
        if st is None:
            self.report.add(
                path,
                f"no common supertype for {lt!r} {op.name} {rt!r}",
                e,
            )
            return None
        return st

    def _infer_string_binary(self, e: BinaryExpr, lt, rt, path: str):
        op = e.op
        if not op.is_comparison:
            self.report.add(
                path,
                f"operator {op.name} is not defined on Utf8 "
                "(strings have no tensor form)",
                e,
            )
            return None
        if lt != rt:
            # comparing a Utf8 column against a number would compare
            # dictionary CODES against the number — silent garbage;
            # this is the malformed-dtype class the verifier exists for
            self.report.add(
                path,
                f"cannot compare {lt!r} with {rt!r}: a Utf8 column "
                "compares only against a string literal",
                e,
            )
            return None
        # Utf8 vs Utf8: the kernel supports column-vs-literal only
        # (dictionary code / compare-table shapes, exec/expression.py)
        shapes = (
            (isinstance(e.left, Column) and isinstance(e.right, Literal)),
            (isinstance(e.left, Literal) and isinstance(e.right, Column)),
        )
        if not any(shapes):
            self.report.add(
                path,
                "string comparisons support column-vs-literal only",
                e,
            )
            return None
        return DataType.BOOLEAN

    def _infer_function(self, e: ScalarFunction, path: str):
        arg_types = [
            self.infer_value(a, f"{path}.args[{i}]")
            for i, a in enumerate(e.args)
        ]
        if self.functions is None:
            return e.return_type
        meta = self.functions.get(e.name.lower())
        if meta is None:
            self.report.add(
                path,
                f"unknown function {e.name!r} (not in the UDF registry)",
                e,
            )
            return e.return_type
        if len(e.args) != len(meta.args):
            self.report.add(
                path,
                f"{e.name} expects {len(meta.args)} argument(s), "
                f"got {len(e.args)}",
                e,
            )
            return meta.return_type
        for i, (t, f) in enumerate(zip(arg_types, meta.args)):
            if t in (None, _NULL):
                continue
            if t != f.data_type and not can_coerce_from(f.data_type, t):
                self.report.add(
                    f"{path}.args[{i}]",
                    f"{e.name} argument {i} computes {t!r}; the registered "
                    f"signature takes {f.data_type!r} (no implicit coercion)",
                    e.args[i],
                )
        if e.return_type != meta.return_type:
            self.report.add(
                path,
                f"{e.name} declares return type {e.return_type!r}; the "
                f"registry says {meta.return_type!r}",
                e,
            )
        return meta.return_type


def verify_plan(plan: LogicalPlan, functions=None) -> VerifyReport:
    """Verify `plan` bottom-up; returns the report (never raises).
    `functions` is the context's UDF registry (name -> FunctionMeta);
    None skips registry-backed signature checks (wire-received plans on
    nodes without the registry still get the structural checks)."""
    report = VerifyReport()
    _verify_node(plan, report, functions, depth=0)
    return report


def check_plan(plan: LogicalPlan, functions=None) -> VerifyReport:
    """`verify_plan` that raises `PlanVerificationError` on findings."""
    report = verify_plan(plan, functions)
    report.raise_if_failed()
    return report


def _node_label(plan: LogicalPlan) -> str:
    if isinstance(plan, TableScan):
        return f"TableScan: {plan.table_name}"
    if isinstance(plan, Aggregate):
        return (
            f"Aggregate: groupBy={len(plan.group_expr)}, "
            f"aggr={len(plan.aggr_expr)}"
        )
    if isinstance(plan, Limit):
        return f"Limit: {plan.limit}"
    if isinstance(plan, Join):
        on = ", ".join(f"#{l}=#{r}" for l, r in plan.on)
        return f"Join: type={plan.join_type}, on=[{on}]"
    return type(plan).__name__


def _check_arity(report: VerifyReport, path: str, declared: Schema,
                 expected: int, what: str) -> None:
    if len(declared) != expected:
        report.add(
            path,
            f"declared schema has {len(declared)} field(s) but the "
            f"operator computes {expected} ({what})",
        )


def _check_field_type(report: VerifyReport, path: str, declared: Schema,
                      i: int, inferred, expr: Optional[Expr]) -> None:
    if inferred in (None, _NULL) or i >= len(declared):
        return
    decl = declared.field(i).data_type
    if decl != inferred:
        report.add(
            path,
            f"declared field {i} ({declared.field(i).name!r}) is "
            f"{decl!r} but the expression computes {inferred!r}",
            expr,
        )


def _verify_node(plan: LogicalPlan, report: VerifyReport, functions,
                 depth: int) -> Schema:
    slot = len(report.operators)
    # reserve the pre-order slot now; fill the schema after inference
    report.operators.append((depth, _node_label(plan), Schema([])))

    if isinstance(plan, EmptyRelation):
        schema = plan.schema
    elif isinstance(plan, TableScan):
        schema = _verify_scan(plan, report)
    elif isinstance(plan, Projection):
        schema = _verify_projection(plan, report, functions, depth)
    elif isinstance(plan, Selection):
        schema = _verify_selection(plan, report, functions, depth)
    elif isinstance(plan, Aggregate):
        schema = _verify_aggregate(plan, report, functions, depth)
    elif isinstance(plan, Sort):
        schema = _verify_sort(plan, report, functions, depth)
    elif isinstance(plan, Limit):
        schema = _verify_limit(plan, report, functions, depth)
    elif isinstance(plan, Join):
        schema = _verify_join(plan, report, functions, depth)
    else:
        report.add(type(plan).__name__,
                   f"unknown plan variant {type(plan).__name__}")
        schema = Schema([])
    report.operators[slot] = (depth, _node_label(plan), schema)
    return schema


def _verify_scan(plan: TableScan, report: VerifyReport) -> Schema:
    if plan.projection is not None:
        n = len(plan.table_schema)
        bad = [i for i in plan.projection if not 0 <= i < n]
        if bad:
            report.add(
                "TableScan.projection",
                f"projection index(es) {bad} out of range for "
                f"{plan.table_name!r} ({n} columns)",
            )
            return plan.table_schema
    return plan.schema


def _verify_projection(plan: Projection, report: VerifyReport, functions,
                       depth: int) -> Schema:
    child = _verify_node(plan.input, report, functions, depth + 1)
    tc = _ExprChecker(child, functions, report)
    declared = plan.schema
    _check_arity(report, "Projection.schema", declared, len(plan.expr),
                 "one field per projection expression")
    for i, e in enumerate(plan.expr):
        t = tc.infer_value(e, f"Projection.expr[{i}]")
        _check_field_type(report, f"Projection.expr[{i}]", declared, i, t, e)
    return declared


def _verify_selection(plan: Selection, report: VerifyReport, functions,
                      depth: int) -> Schema:
    child = _verify_node(plan.input, report, functions, depth + 1)
    tc = _ExprChecker(child, functions, report)
    t = tc.infer(plan.expr, "Selection.expr")
    if t not in (None, _NULL, DataType.BOOLEAN):
        report.add(
            "Selection.expr",
            f"predicate computes {t!r}, expected Boolean",
            plan.expr,
        )
    return child


def _verify_aggregate(plan: Aggregate, report: VerifyReport, functions,
                      depth: int) -> Schema:
    child = _verify_node(plan.input, report, functions, depth + 1)
    tc = _ExprChecker(child, functions, report)
    declared = plan.schema
    _check_arity(report, "Aggregate.schema", declared,
                 len(plan.group_expr) + len(plan.aggr_expr),
                 "group keys then aggregates")
    for i, g in enumerate(plan.group_expr):
        path = f"Aggregate.group_expr[{i}]"
        t = tc.infer(g, path)
        if not isinstance(g, Column):
            # hard executor requirement AND fused-pass precondition
            # (exec/aggregate.py _AggregateCore; exec/fused.py
            # rewrite_aggregate) — a computed key would fail both
            report.add(
                path,
                "GROUP BY keys must be bare column references "
                "(fused aggregation accumulates per dense key id)",
                g,
            )
        elif isinstance(t, DataType) and t.np_dtype.kind == "O":
            report.add(path, "struct columns cannot be GROUP BY keys", g)
        _check_field_type(report, path, declared, i, t, g)
    for j, a in enumerate(plan.aggr_expr):
        path = f"Aggregate.aggr_expr[{j}]"
        pos = len(plan.group_expr) + j
        if not isinstance(a, AggregateFunction):
            report.add(
                path,
                f"non-aggregate expression in aggr_expr "
                f"({type(a).__name__})",
                a,
            )
            continue
        name = a.name.lower()
        if name not in _KNOWN_AGGREGATES:
            report.add(
                path,
                f"unknown aggregate {a.name!r} (supported: "
                f"{', '.join(n.upper() for n in _KNOWN_AGGREGATES)})",
                a,
            )
            continue
        if len(a.args) != 1:
            report.add(path, f"{a.name} takes exactly one argument", a)
            continue
        if name == "count":
            if a.return_type != DataType.UINT64:
                report.add(
                    path,
                    f"COUNT declares return type {a.return_type!r}, "
                    "but COUNT returns UInt64",
                    a,
                )
            if not getattr(a, "count_star", False):
                tc.infer(a.args[0], f"{path}.args[0]")
            # COUNT(*)'s COUNT(#0) rewrite is plan-shape parity only —
            # the executor counts rows, so #0 need not resolve
            _check_field_type(report, path, declared, pos,
                              DataType.UINT64, a)
            continue
        t = tc.infer(a.args[0], f"{path}.args[0]")
        if t == DataType.UTF8:
            if name in ("sum", "avg"):
                report.add(
                    path, f"{a.name} over Utf8 is not supported", a
                )
                continue
            if not isinstance(a.args[0], Column):
                # executor + fused-pass precondition: the accumulator
                # is the best dictionary code of a real column
                report.add(
                    path,
                    f"{a.name} over a computed Utf8 expression is not "
                    "supported (Utf8 MIN/MAX needs a bare column)",
                    a,
                )
                continue
        if isinstance(t, DataType) and a.return_type != t:
            report.add(
                path,
                f"{a.name} declares return type {a.return_type!r} but "
                f"its argument computes {t!r}",
                a,
            )
        _check_field_type(report, path, declared, pos, a.return_type, a)
    return declared


def _verify_sort(plan: Sort, report: VerifyReport, functions,
                 depth: int) -> Schema:
    child = _verify_node(plan.input, report, functions, depth + 1)
    tc = _ExprChecker(child, functions, report)
    for i, se in enumerate(plan.expr):
        path = f"Sort.expr[{i}]"
        if not isinstance(se, SortExpr):
            report.add(path, f"Sort keys must be SortExpr "
                             f"(got {type(se).__name__})", se)
            continue
        if not isinstance(se.expr, Column):
            # hard executor requirement (exec/sort.py): sort output is
            # a gather, keys must be materialized columns
            report.add(
                path,
                "ORDER BY keys must be bare column references "
                "(computed keys need their own projection)",
                se.expr,
            )
            continue
        t = tc.infer(se.expr, path)
        if isinstance(t, DataType) and t.np_dtype.kind == "O":
            report.add(path, "struct columns cannot be ORDER BY keys",
                       se.expr)
    _check_arity(report, "Sort.schema", plan.schema, len(child),
                 "sort passes rows through")
    return plan.schema


def _verify_limit(plan: Limit, report: VerifyReport, functions,
                  depth: int) -> Schema:
    child = _verify_node(plan.input, report, functions, depth + 1)
    if not isinstance(plan.limit, int) or isinstance(plan.limit, bool) \
            or plan.limit < 0:
        report.add("Limit.limit",
                   f"LIMIT must be a non-negative integer, "
                   f"got {plan.limit!r}")
    _check_arity(report, "Limit.schema", plan.schema, len(child),
                 "limit passes rows through")
    return plan.schema


def _verify_join(plan: Join, report: VerifyReport, functions,
                 depth: int) -> Schema:
    """Cross-relation checks: both inputs verify recursively (EXPLAIN
    VERIFY then renders both input schemas in pre-order), every ON key
    index resolves in its own side, key pairs are dtype-compatible
    (equal or supertype-promotable — the equi-probe compares raw
    values, so an incomparable pair is a plan bug, not a runtime one),
    and the declared output qualifies cross-input duplicate names."""
    left = _verify_node(plan.left, report, functions, depth + 1)
    right = _verify_node(plan.right, report, functions, depth + 1)
    if not plan.on:
        report.add("Join.on", "join has no ON key pairs (cross joins "
                              "are not supported)")
    for i, (li, ri) in enumerate(plan.on):
        path = f"Join.on[{i}]"
        ok = True
        if not 0 <= li < len(left):
            report.add(path, f"left key index {li} out of range for the "
                             f"left input ({len(left)} columns)")
            ok = False
        if not 0 <= ri < len(right):
            report.add(path, f"right key index {ri} out of range for the "
                             f"right input ({len(right)} columns)")
            ok = False
        if not ok:
            continue
        lt, rt = left.field(li).data_type, right.field(ri).data_type
        if lt != rt and get_supertype(lt, rt) is None:
            report.add(
                path,
                f"ON keys {left.field(li).name!r} ({lt!r}) and "
                f"{right.field(ri).name!r} ({rt!r}) have no common "
                f"supertype — the equi-join cannot compare them",
            )
    declared = plan.schema
    _check_arity(report, "Join.schema", declared, len(left) + len(right),
                 "left fields then right fields")
    combined = list(left.fields) + list(right.fields)
    for i, f in enumerate(combined):
        if i >= len(declared):
            break
        decl = declared.field(i)
        if decl.data_type != f.data_type:
            report.add(
                "Join.schema",
                f"declared field {i} ({decl.name!r}) is "
                f"{decl.data_type!r} but the input column is "
                f"{f.data_type!r}",
            )
    # cross-input duplicate names must be qualified in the output —
    # an ambiguous declared name would break downstream index_of
    seen: dict[str, int] = {}
    for i in range(len(declared)):
        name = declared.field(i).name
        if name in seen:
            report.add(
                "Join.schema",
                f"output columns {seen[name]} and {i} share the name "
                f"{name!r} — cross-input duplicates must be qualified "
                f"(e.g. 'table.{name}')",
            )
        seen[name] = i
    return declared


def verify_exprs(exprs: Sequence[Expr], schema: Schema,
                 functions=None) -> VerifyReport:
    """Standalone expression check against `schema` (used by tests and
    by callers holding expressions outside a plan)."""
    report = VerifyReport()
    tc = _ExprChecker(schema, functions, report)
    for i, e in enumerate(exprs):
        tc.infer_value(e, f"expr[{i}]")
    return report
