"""SQL AST -> LogicalPlan translation.

Mirrors the reference `SqlToRel` (`src/sqlplanner.rs:45-359`) including
its exact plan shapes (the 12 golden tests in tests/test_planner.py are
ported verbatim from `sqlplanner.rs:522-772`):

- WHERE is planned before projection (Selection sits under Projection).
- Projection exprs containing any aggregate switch the whole query to
  an Aggregate plan; group_expr comes only from GROUP BY; non-aggregate
  projection exprs are dropped on that path (reference behavior).
- Binary expressions get implicit supertype CASTs on both sides
  (`sqlplanner.rs:268-287`).
- COUNT(1)/COUNT(*) rewrites to COUNT(#0) returning UInt64
  (`sqlplanner.rs:311-329`).
- ORDER BY resolves against the *projection output* schema
  (`sqlplanner.rs:139-161`), LIMIT must be a literal number.

Completed beyond the reference (its TODO at `sqlplanner.rs:111-117`):
ORDER BY / LIMIT now also apply on the aggregate path, resolved against
the aggregate output schema.
"""

from __future__ import annotations

from typing import Optional, Protocol

from datafusion_tpu_torch.datatypes import DataType, Field, Schema, get_supertype
from datafusion_tpu_torch.errors import InvalidColumnError, NotSupportedError, PlanError
from datafusion_tpu_torch.plan.expr import (
    AggregateFunction,
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
    ScalarValue,
    SortExpr,
    exprlist_to_fields,
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
from datafusion_tpu_torch.sql import ast

_AGGREGATE_NAMES = {"min", "max", "sum", "avg", "count"}

_BINARY_OPS = {
    "=": Operator.Eq,
    "!=": Operator.NotEq,
    "<": Operator.Lt,
    "<=": Operator.LtEq,
    ">": Operator.Gt,
    ">=": Operator.GtEq,
    "+": Operator.Plus,
    "-": Operator.Minus,
    "*": Operator.Multiply,
    "/": Operator.Divide,
    "%": Operator.Modulus,
    "AND": Operator.And,
    "OR": Operator.Or,
}

_SQL_TYPE_TO_DATATYPE = {
    # reference convert_data_type (sqlplanner.rs:363-374); TinyInt is an
    # extension so the DDL can describe the all_types fixtures
    ast.SqlType.Boolean: DataType.BOOLEAN,
    ast.SqlType.TinyInt: DataType.INT8,
    ast.SqlType.SmallInt: DataType.INT16,
    ast.SqlType.Int: DataType.INT32,
    ast.SqlType.BigInt: DataType.INT64,
    ast.SqlType.Float: DataType.FLOAT64,
    ast.SqlType.Real: DataType.FLOAT64,
    ast.SqlType.Double: DataType.FLOAT64,
    ast.SqlType.Char: DataType.UTF8,
    ast.SqlType.Varchar: DataType.UTF8,
}


def convert_data_type(sql_type: ast.SqlType) -> DataType:
    return _SQL_TYPE_TO_DATATYPE[sql_type]


def _strip_cast(e: Expr) -> Expr:
    # supertype coercion wraps mismatched-width key columns in Casts;
    # the equi-key extractor wants the underlying column (the executor
    # compares under numpy promotion)
    while isinstance(e, Cast):
        e = e.expr
    return e


def _split_on_conjuncts(
    expr: Expr, n_left: int
) -> tuple[list[tuple[int, int]], list[Expr]]:
    """Decompose a resolved ON expression (combined-schema indices)
    into equi-key pairs and residual conjuncts.  Returns
    (pairs, residuals): pairs are (left_index, right_index) with the
    right index rebased to the right input's own schema; any conjunct
    that is not a cross-side column equality is a residual."""
    if isinstance(expr, BinaryExpr) and expr.op == Operator.And:
        p1, r1 = _split_on_conjuncts(expr.left, n_left)
        p2, r2 = _split_on_conjuncts(expr.right, n_left)
        return p1 + p2, r1 + r2
    if isinstance(expr, BinaryExpr) and expr.op == Operator.Eq:
        l = _strip_cast(expr.left)
        r = _strip_cast(expr.right)
        if isinstance(l, Column) and isinstance(r, Column):
            if l.index < n_left <= r.index:
                return [(l.index, r.index - n_left)], []
            if r.index < n_left <= l.index:
                return [(r.index, l.index - n_left)], []
    return [], [expr]


class SchemaProvider(Protocol):
    """Catalog seam (reference `sqlplanner.rs:28-31`)."""

    def get_table_meta(self, name: str) -> Optional[Schema]: ...

    def get_function_meta(self, name: str) -> Optional[FunctionMeta]: ...


class SqlToRel:
    """The query planner."""

    def __init__(self, schema_provider: SchemaProvider):
        self.schema_provider = schema_provider

    # -- relations --
    def sql_to_rel(self, node: ast.SqlNode) -> LogicalPlan:
        if isinstance(node, ast.SqlSelect):
            return self._plan_select(node)
        if isinstance(node, ast.SqlIdentifier):
            schema = self.schema_provider.get_table_meta(node.name)
            if schema is None:
                raise PlanError(f"no schema found for table {node.name}")
            return TableScan("default", node.name, schema, None)
        if isinstance(node, ast.SqlJoin):
            return self._plan_join(node)[0]
        raise NotSupportedError(f"sql_to_rel does not support this relation: {node!r}")

    def _plan_relation(self, node: ast.SqlNode) -> tuple[LogicalPlan, list[str]]:
        """Plan a FROM-clause relation, returning the plan plus one
        source-table qualifier per output column (what duplicate-name
        qualification renames by)."""
        if isinstance(node, ast.SqlIdentifier):
            plan = self.sql_to_rel(node)
            return plan, [node.name] * len(plan.schema)
        if isinstance(node, ast.SqlJoin):
            return self._plan_join(node)
        raise NotSupportedError(
            f"unsupported FROM-clause relation: {node!r}"
        )

    def _plan_join(self, node: ast.SqlJoin) -> tuple[LogicalPlan, list[str]]:
        """Plan `left [INNER|LEFT] JOIN right ON expr`.

        The output schema is left's fields then right's; a bare name
        present on BOTH sides is qualified as ``table.name`` on each
        (so either spelling stays resolvable downstream).  The ON
        expression resolves against that combined schema; its
        equality conjuncts between opposite sides become the Join's
        key pairs and every other conjunct survives as a Selection
        over the join (a residual filter, evaluated after the match).
        LEFT OUTER marks every right-side output column nullable —
        unmatched probe rows carry NULLs there.
        """
        left, lq = self._plan_relation(node.left)
        right, rq = self._plan_relation(node.right)
        ls, rs = left.schema, right.schema
        lset = {f.name for f in ls.fields}
        rset = {f.name for f in rs.fields}
        fields: list[Field] = []
        for f, q in zip(ls.fields, lq):
            name = f.name if f.name not in rset else f"{q}.{f.name}"
            fields.append(Field(name, f.data_type, f.nullable))
        right_null = node.join_type == "left"
        for f, q in zip(rs.fields, rq):
            name = f.name if f.name not in lset else f"{q}.{f.name}"
            fields.append(Field(name, f.data_type, f.nullable or right_null))
        combined = Schema(fields)
        on_expr = self.sql_to_rex(node.on, combined)
        pairs, residual = _split_on_conjuncts(on_expr, len(ls))
        if not pairs:
            raise PlanError(
                "JOIN requires at least one left.col = right.col "
                f"equality in ON, got {node.on!r}"
            )
        plan: LogicalPlan = Join(left, right, pairs, node.join_type, combined)
        for r in residual:
            plan = Selection(r, plan)
        return plan, lq + rq

    def _plan_select(self, sel: ast.SqlSelect) -> LogicalPlan:
        if sel.relation is not None:
            input_plan = self.sql_to_rel(sel.relation)
        else:
            input_plan = EmptyRelation(Schema([]))
        input_schema = input_plan.schema

        # WHERE first (reference sqlplanner.rs:68-74)
        if sel.selection is not None:
            selection_plan: Optional[LogicalPlan] = Selection(
                self.sql_to_rex(sel.selection, input_schema), input_plan
            )
        else:
            selection_plan = None

        # expand SELECT * (reference left this unimplemented,
        # sqlplanner.rs:225-229)
        proj_nodes: list[ast.SqlNode] = []
        for p in sel.projection:
            if isinstance(p, ast.SqlWildcard):
                if len(input_schema) == 0:
                    raise PlanError("SELECT * requires a FROM clause")
                proj_nodes.extend(
                    ast.SqlIdentifier(f.name) for f in input_schema.fields
                )
            else:
                proj_nodes.append(p)

        aliases: dict[int, str] = {}
        exprs: list[Expr] = []
        for i, p in enumerate(proj_nodes):
            if isinstance(p, ast.SqlAliased):
                aliases[i] = p.alias
                p = p.expr
            exprs.append(self.sql_to_rex(p, input_schema))

        aggr_expr = [e for e in exprs if isinstance(e, AggregateFunction)]

        if aggr_expr:
            aggregate_input = selection_plan if selection_plan is not None else input_plan
            group_expr = [self.sql_to_rex(g, input_schema) for g in sel.group_by]
            all_fields = list(group_expr) + list(aggr_expr)
            aggr_schema = Schema(exprlist_to_fields(all_fields, input_schema))
            plan: LogicalPlan = Aggregate(
                aggregate_input, group_expr, aggr_expr, aggr_schema
            )
            # Completing the reference's explicit TODO ("selection,
            # projection, everything else" on the aggregate path,
            # sqlplanner.rs:111-117): HAVING / ORDER BY / LIMIT over the
            # aggregate, with aggregate calls resolved to their output
            # columns.
            if sel.having is not None:
                plan = Selection(
                    self._post_aggregate_rex(
                        sel.having, input_schema, group_expr, aggr_expr
                    ),
                    plan,
                )
            if sel.order_by:
                sort_exprs = [
                    SortExpr(
                        self._post_aggregate_rex(
                            o.expr, input_schema, group_expr, aggr_expr
                        ),
                        o.asc,
                    )
                    for o in sel.order_by
                ]
                plan = Sort(sort_exprs, plan, plan.schema)
            plan = self._apply_limit(plan, sel.limit)
            return plan

        projection_input = selection_plan if selection_plan is not None else input_plan
        fields = exprlist_to_fields(exprs, input_schema)
        for i, alias in aliases.items():
            f = fields[i]
            fields[i] = Field(alias, f.data_type, f.nullable)
        plan = Projection(exprs, projection_input, Schema(fields))

        if sel.having is not None:
            raise NotSupportedError("HAVING is not implemented yet")

        if sel.order_by:
            # resolve each key against the SELECT output first (so
            # aliases work); a column that is only in the input is
            # carried as a *hidden* projection column, sorted on, and
            # stripped by a final projection.  (The reference resolves
            # only against the projection schema, sqlplanner.rs:139-151,
            # so `SELECT city ... ORDER BY lat` fails there.)
            out_schema = plan.schema
            sort_exprs: list[SortExpr] = []
            hidden: list[Expr] = []
            for o in sel.order_by:
                try:
                    e = self.sql_to_rex(o.expr, out_schema)
                except InvalidColumnError:
                    he = self.sql_to_rex(o.expr, input_schema)
                    e = Column(len(exprs) + len(hidden))
                    hidden.append(he)
                sort_exprs.append(SortExpr(e, o.asc))
            if hidden:
                ext_fields = fields + exprlist_to_fields(hidden, input_schema)
                ext_proj = Projection(
                    exprs + hidden, projection_input, Schema(ext_fields)
                )
                plan = Sort(sort_exprs, ext_proj, ext_proj.schema)
                # keep Limit adjacent to Sort: the executor's TopK path
                # matches Limit(Sort(...))
                plan = self._apply_limit(plan, sel.limit)
                return Projection(
                    [Column(i) for i in range(len(exprs))], plan, Schema(fields)
                )
            plan = Sort(sort_exprs, plan, out_schema)
        plan = self._apply_limit(plan, sel.limit)
        return plan

    def _post_aggregate_rex(
        self,
        node: ast.SqlNode,
        input_schema: Schema,
        group_expr: list[Expr],
        aggr_expr: list[Expr],
    ) -> Expr:
        """Translate a HAVING / post-aggregate ORDER BY expression:
        plan it against the *input* schema, then rewrite every subtree
        equal to a group key or aggregate into its output-column
        position.  Aggregates not present in the SELECT list are
        rejected (the output column does not exist to reference)."""
        e = self.sql_to_rex(node, input_schema)
        positions: dict = {}
        for i, g in enumerate(group_expr):
            positions.setdefault(g, i)
        for j, a in enumerate(aggr_expr):
            positions.setdefault(a, len(group_expr) + j)

        def rewrite(x: Expr) -> Expr:
            pos = positions.get(x)
            if pos is not None:
                return Column(pos)
            if isinstance(x, BinaryExpr):
                return BinaryExpr(rewrite(x.left), x.op, rewrite(x.right))
            if isinstance(x, Cast):
                return Cast(rewrite(x.expr), x.data_type)
            if isinstance(x, IsNull):
                return IsNull(rewrite(x.expr))
            if isinstance(x, IsNotNull):
                return IsNotNull(rewrite(x.expr))
            if isinstance(x, ScalarFunction):
                return ScalarFunction(
                    x.name, [rewrite(a) for a in x.args], x.return_type
                )
            if isinstance(x, AggregateFunction):
                raise PlanError(
                    f"aggregate {x!r} in HAVING/ORDER BY must also appear "
                    "in the SELECT list"
                )
            if isinstance(x, Column):
                raise PlanError(
                    f"column {x!r} in HAVING/ORDER BY is neither a GROUP BY "
                    "key nor an aggregate output"
                )
            return x

        return rewrite(e)

    def _apply_limit(self, plan: LogicalPlan, limit: Optional[ast.SqlNode]) -> LogicalPlan:
        if limit is None:
            return plan
        if not isinstance(limit, ast.SqlLongLiteral):
            raise PlanError("LIMIT parameter is not a number")
        return Limit(limit.value, plan, plan.schema)

    # -- expressions (reference sql_to_rex, sqlplanner.rs:202-359) --
    def sql_to_rex(self, node: ast.SqlNode, schema: Schema) -> Expr:
        if isinstance(node, ast.SqlLongLiteral):
            return Literal(ScalarValue.int64(node.value))
        if isinstance(node, ast.SqlDoubleLiteral):
            return Literal(ScalarValue.float64(node.value))
        if isinstance(node, ast.SqlStringLiteral):
            return Literal(ScalarValue.utf8(node.value))
        if isinstance(node, ast.SqlBooleanLiteral):
            return Literal(ScalarValue.boolean(node.value))
        if isinstance(node, ast.SqlNullLiteral):
            return Literal(ScalarValue.null())
        if isinstance(node, ast.SqlIdentifier):
            # name -> positional index (reference sqlplanner.rs:214-223)
            return Column(schema.index_of(node.name))
        if isinstance(node, ast.SqlCompoundIdentifier):
            # qualified `table.column`: duplicate-name columns were
            # renamed to the literal "table.column" by the join planner;
            # a unique bare name resolves by name alone (the qualifier
            # is then redundant and not re-checked)
            try:
                return Column(
                    schema.index_of(f"{node.qualifier}.{node.name}")
                )
            except InvalidColumnError:
                return Column(schema.index_of(node.name))
        if isinstance(node, ast.SqlNested):
            return self.sql_to_rex(node.expr, schema)
        if isinstance(node, ast.SqlCast):
            from datafusion_tpu_torch.plan.expr import Cast

            return Cast(self.sql_to_rex(node.expr, schema), convert_data_type(node.data_type))
        if isinstance(node, ast.SqlIsNull):
            return self.sql_to_rex(node.expr, schema).is_null()
        if isinstance(node, ast.SqlIsNotNull):
            return self.sql_to_rex(node.expr, schema).is_not_null()
        if isinstance(node, ast.SqlUnary):
            return self._plan_unary(node, schema)
        if isinstance(node, ast.SqlBinaryExpr):
            op = _BINARY_OPS.get(node.op)
            if op is None:
                raise NotSupportedError(f"Unsupported binary operator {node.op!r}")
            left = self.sql_to_rex(node.left, schema)
            right = self.sql_to_rex(node.right, schema)
            if op.is_boolean:
                # AND/OR take boolean sides; no numeric coercion
                return left._bin(op, right)
            # implicit supertype casts on both sides (sqlplanner.rs:268-287)
            lt = left.get_type(schema)
            rt = right.get_type(schema)
            # a non-negative integer literal adapts to an unsigned
            # operand's type (else COUNT(1) > 0 fails: no implicit
            # UInt64 <-> Int64 coercion exists in the lattice)
            left, lt = self._adapt_int_literal(left, lt, rt)
            right, rt = self._adapt_int_literal(right, rt, lt)
            st = get_supertype(lt, rt)
            if st is None:
                raise PlanError(f"No common supertype for {lt!r} and {rt!r}")
            return left.cast_to(st, schema)._bin(op, right.cast_to(st, schema))
        if isinstance(node, ast.SqlFunction):
            return self._plan_function(node, schema)
        if isinstance(node, ast.SqlAliased):
            # aliases outside a projection list have no meaning
            return self.sql_to_rex(node.expr, schema)
        raise NotSupportedError(f"Unsupported expression {node!r}")

    @staticmethod
    def _adapt_int_literal(e: Expr, et: DataType, other: DataType):
        if (
            isinstance(e, Literal)
            and not e.value.is_null
            and et.is_signed_integer
            and other.is_unsigned_integer
            and isinstance(e.value.value, int)
            and e.value.value >= 0
        ):
            return Literal(ScalarValue.of(other, e.value.value)), other
        return e, et

    def _plan_unary(self, node: ast.SqlUnary, schema: Schema) -> Expr:
        if node.op == "-":
            inner = self.sql_to_rex(node.expr, schema)
            if isinstance(inner, Literal) and not inner.value.is_null:
                dt = inner.value.get_datatype()
                if dt.is_numeric:
                    return Literal(ScalarValue.of(dt, -inner.value.value))
            # general negation: 0 - expr
            zero = Literal(ScalarValue.int64(0))
            return zero.cast_to(inner.get_type(schema), schema)._bin(
                Operator.Minus, inner
            )
        if node.op == "+":
            return self.sql_to_rex(node.expr, schema)
        raise NotSupportedError(
            f"Unary operator {node.op!r} is not supported (the reference IR "
            "has no NOT variant, logicalplan.rs:67-81)"
        )

    def _plan_function(self, node: ast.SqlFunction, schema: Schema) -> Expr:
        lname = node.name.lower()
        if lname in ("min", "max", "sum", "avg"):
            # return type = argument type (sqlplanner.rs:296-310)
            if len(node.args) != 1:
                raise PlanError(f"{node.name} takes exactly one argument")
            arg = self.sql_to_rex(node.args[0], schema)
            return AggregateFunction(node.name, [arg], arg.get_type(schema))
        if lname == "count":
            # COUNT(1)/COUNT(*) -> COUNT(#0), returns UInt64
            # (sqlplanner.rs:311-329)
            if len(node.args) != 1:
                raise PlanError("COUNT takes exactly one argument")
            a = node.args[0]
            if isinstance(a, (ast.SqlWildcard, ast.SqlLongLiteral, ast.SqlDoubleLiteral)):
                # plan-shape parity with the reference's COUNT(#0) rewrite,
                # but flagged so the executor counts rows, not col-0 non-nulls
                return AggregateFunction(node.name, [Column(0)], DataType.UINT64, True)
            arg = self.sql_to_rex(a, schema)
            return AggregateFunction(node.name, [arg], DataType.UINT64)
        # scalar UDF lookup with per-argument coercion (sqlplanner.rs:330-351)
        fm = self.schema_provider.get_function_meta(lname)
        if fm is None:
            raise PlanError(f"Invalid function {node.name!r}")
        if len(node.args) != len(fm.args):
            raise PlanError(
                f"{fm.name} expects {len(fm.args)} arguments, got {len(node.args)}"
            )
        safe_args = [
            self.sql_to_rex(a, schema).cast_to(f.data_type, schema)
            for a, f in zip(node.args, fm.args)
        ]
        return ScalarFunction(fm.name, safe_args, fm.return_type)
