"""SQL abstract syntax tree.

Own design covering the shapes the reference's planner consumes from
`sqlparser` 0.1.8 (`src/sqlplanner.rs:45-359`) plus the DDL node
(`src/dfparser.rs:39-55`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class SqlNode:
    """Base class for AST nodes."""


# -- expressions --
@dataclass
class SqlIdentifier(SqlNode):
    name: str


@dataclass
class SqlCompoundIdentifier(SqlNode):
    """Qualified column reference `table.column` (multi-relation FROM
    clauses need the qualifier to disambiguate duplicate names)."""

    qualifier: str
    name: str


@dataclass
class SqlWildcard(SqlNode):
    """`*` in a projection or COUNT(*)."""


@dataclass
class SqlLongLiteral(SqlNode):
    value: int


@dataclass
class SqlDoubleLiteral(SqlNode):
    value: float


@dataclass
class SqlStringLiteral(SqlNode):
    value: str


@dataclass
class SqlBooleanLiteral(SqlNode):
    value: bool


@dataclass
class SqlNullLiteral(SqlNode):
    pass


@dataclass
class SqlBinaryExpr(SqlNode):
    left: SqlNode
    op: str  # "=", "!=", "<", "<=", ">", ">=", "+", "-", "*", "/", "%", "AND", "OR"
    right: SqlNode


@dataclass
class SqlUnary(SqlNode):
    op: str  # "-", "+", "NOT"
    expr: SqlNode


@dataclass
class SqlCast(SqlNode):
    expr: SqlNode
    data_type: "SqlType"


@dataclass
class SqlIsNull(SqlNode):
    expr: SqlNode


@dataclass
class SqlIsNotNull(SqlNode):
    expr: SqlNode


@dataclass
class SqlFunction(SqlNode):
    name: str  # as written in the query (reference preserves case)
    args: list[SqlNode] = field(default_factory=list)


@dataclass
class SqlNested(SqlNode):
    """Parenthesized expression."""

    expr: SqlNode


@dataclass
class SqlAliased(SqlNode):
    """expr AS alias (alias names the output column)."""

    expr: SqlNode
    alias: str


@dataclass
class SqlOrderByExpr(SqlNode):
    expr: SqlNode
    asc: bool = True


@dataclass
class SqlJoin(SqlNode):
    """`left [INNER|LEFT [OUTER]] JOIN right ON <expr>` — a FROM-clause
    relation (left-deep chains nest in `left`).  `join_type` is
    "inner" or "left"."""

    left: SqlNode
    right: SqlNode
    join_type: str
    on: SqlNode


# -- statements --
@dataclass
class SqlSelect(SqlNode):
    projection: list[SqlNode] = field(default_factory=list)
    relation: Optional[SqlNode] = None  # SqlIdentifier table or SqlJoin tree
    selection: Optional[SqlNode] = None  # WHERE
    group_by: list[SqlNode] = field(default_factory=list)
    having: Optional[SqlNode] = None
    order_by: list[SqlOrderByExpr] = field(default_factory=list)
    limit: Optional[SqlNode] = None


class SqlType(enum.Enum):
    """SQL column types (DDL + CAST); mapping to DataType lives in the
    planner (reference convert_data_type, `sqlplanner.rs:363-374`)."""

    Boolean = "BOOLEAN"
    TinyInt = "TINYINT"
    SmallInt = "SMALLINT"
    Int = "INT"
    BigInt = "BIGINT"
    Float = "FLOAT"
    Real = "REAL"
    Double = "DOUBLE"
    Char = "CHAR"
    Varchar = "VARCHAR"


class FileType(enum.Enum):
    """Storage formats for CREATE EXTERNAL TABLE (reference
    `dfparser.rs:32-36`)."""

    CSV = "CSV"
    NdJson = "NDJSON"
    Parquet = "PARQUET"


@dataclass
class SqlColumnDef(SqlNode):
    name: str
    data_type: SqlType
    allow_null: bool = True


@dataclass
class SqlCreateExternalTable(SqlNode):
    """CREATE EXTERNAL TABLE name (cols) STORED AS fmt
    [WITH|WITHOUT HEADER ROW] LOCATION 'path'
    (reference `dfparser.rs:39-55,101-208`)."""

    name: str
    columns: list[SqlColumnDef]
    file_type: FileType
    header_row: bool
    location: str


@dataclass
class SqlCreateMaterializedView(SqlNode):
    """CREATE MATERIALIZED VIEW name AS <select> — engine extension
    (the ingest subsystem's registered continuous query; the reference
    has no view support at all).  `query` is the defining SELECT; the
    original SELECT text rides along so the view definition can be
    WAL-logged and re-planned verbatim on crash recovery."""

    name: str
    query: SqlSelect
    query_sql: str = ""


@dataclass
class SqlExplain(SqlNode):
    """EXPLAIN [ANALYZE|VERIFY] stmt — engine extension (the reference
    only println!s the plan on every execute, `context.rs:104`).  With
    `analyze` the statement EXECUTES and the plan is annotated with
    measured per-operator stats (obs/explain.py); with `verify` the
    plan is statically type-checked WITHOUT executing and the inferred
    schema per operator is rendered (analysis/verify.py)."""

    stmt: SqlNode
    analyze: bool = False
    verify: bool = False
