"""Recursive-descent SQL parser.

Covers the subset the reference accepts (ANSI via `sqlparser` 0.1.8 +
the CREATE EXTERNAL TABLE extension, `src/dfparser.rs:101-208`):

    SELECT expr [AS alias], ... [FROM table]
        [WHERE expr] [GROUP BY exprs] [HAVING expr]
        [ORDER BY expr [ASC|DESC], ...] [LIMIT n]
    CREATE EXTERNAL TABLE name (col TYPE [NOT NULL], ...)
        STORED AS CSV|NDJSON|PARQUET [WITH|WITHOUT HEADER ROW]
        LOCATION 'path'
    EXPLAIN [ANALYZE] <select>

Expression grammar with precedence climbing:
    OR < AND < NOT < comparison (= != <> < <= > >=) < + - < * / %
with postfix IS [NOT] NULL, CAST(expr AS TYPE), function calls,
unary +/-, parenthesized expressions.
"""

from __future__ import annotations

from typing import Optional

import re

from datafusion_tpu_torch.errors import ParserError
from datafusion_tpu_torch.sql import ast
from datafusion_tpu_torch.sql.tokenizer import EOF, NUMBER, OP, STRING, WORD, Token, tokenize

_EXPLAIN_ANALYZE = re.compile(r"\s*EXPLAIN\s+ANALYZE\b", re.IGNORECASE)
_EXPLAIN_VERIFY = re.compile(r"\s*EXPLAIN\s+VERIFY\b", re.IGNORECASE)
_CREATE_MVIEW = re.compile(
    r"\s*CREATE\s+MATERIALIZED\s+VIEW\s+([A-Za-z_][A-Za-z0-9_]*)\s+AS\b",
    re.IGNORECASE,
)

# precedence table (higher binds tighter)
_PREC_OR = 5
_PREC_AND = 10
_PREC_NOT = 15
_PREC_CMP = 20
_PREC_ADD = 30
_PREC_MUL = 40

_CMP_OPS = {"=", "!=", "<>", "<", "<=", ">", ">="}
_RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "BY",
    "ASC", "DESC", "AND", "OR", "NOT", "AS", "IS", "NULL",
    "JOIN", "ON", "INNER", "LEFT", "OUTER",
}

_TYPE_WORDS = {
    "BOOLEAN": ast.SqlType.Boolean,
    "BOOL": ast.SqlType.Boolean,
    "TINYINT": ast.SqlType.TinyInt,
    "SMALLINT": ast.SqlType.SmallInt,
    "INT": ast.SqlType.Int,
    "INTEGER": ast.SqlType.Int,
    "BIGINT": ast.SqlType.BigInt,
    "FLOAT": ast.SqlType.Float,
    "REAL": ast.SqlType.Real,
    "DOUBLE": ast.SqlType.Double,
    "CHAR": ast.SqlType.Char,
    "VARCHAR": ast.SqlType.Varchar,
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers --
    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != EOF:
            self.i += 1
        return t

    def peek_word(self) -> Optional[str]:
        t = self.peek()
        return t.value.upper() if t.kind == WORD else None

    def parse_keyword(self, kw: str) -> bool:
        if self.peek_word() == kw:
            self.next()
            return True
        return False

    def parse_keywords(self, *kws: str) -> bool:
        mark = self.i
        for kw in kws:
            if not self.parse_keyword(kw):
                self.i = mark
                return False
        return True

    def expect_keyword(self, kw: str) -> None:
        if not self.parse_keyword(kw):
            raise ParserError(f"Expected {kw}, found {self.peek()} in {self.sql!r}")

    def consume_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == OP and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.consume_op(op):
            raise ParserError(f"Expected {op!r}, found {self.peek()} in {self.sql!r}")

    def expect_identifier(self) -> str:
        t = self.peek()
        if t.kind == WORD and t.value.upper() not in _RESERVED_STOP:
            self.next()
            return t.value
        raise ParserError(f"Expected identifier, found {t} in {self.sql!r}")

    # -- statements --
    def parse_statement(self) -> ast.SqlNode:
        if self.parse_keywords("CREATE", "EXTERNAL", "TABLE"):
            return self._parse_create_external_table()
        if self.parse_keywords("CREATE", "MATERIALIZED", "VIEW"):
            return self._parse_create_materialized_view()
        if self.parse_keyword("EXPLAIN"):
            analyze = self.parse_keyword("ANALYZE")
            verify = False if analyze else self.parse_keyword("VERIFY")
            return ast.SqlExplain(
                self.parse_statement(), analyze=analyze, verify=verify
            )
        if self.parse_keyword("SELECT"):
            return self._parse_select()
        raise ParserError(f"Expected a statement, found {self.peek()} in {self.sql!r}")

    def _parse_select(self) -> ast.SqlSelect:
        sel = ast.SqlSelect()
        # projection list
        while True:
            if self.consume_op("*"):
                sel.projection.append(ast.SqlWildcard())
            else:
                e = self.parse_expr()
                if self.parse_keyword("AS"):
                    e = ast.SqlAliased(e, self.expect_identifier())
                sel.projection.append(e)
            if not self.consume_op(","):
                break
        if self.parse_keyword("FROM"):
            sel.relation = self._parse_relation()
        if self.parse_keyword("WHERE"):
            sel.selection = self.parse_expr()
        if self.parse_keywords("GROUP", "BY"):
            while True:
                sel.group_by.append(self.parse_expr())
                if not self.consume_op(","):
                    break
        if self.parse_keyword("HAVING"):
            sel.having = self.parse_expr()
        if self.parse_keywords("ORDER", "BY"):
            while True:
                e = self.parse_expr()
                asc = True
                if self.parse_keyword("DESC"):
                    asc = False
                else:
                    self.parse_keyword("ASC")
                sel.order_by.append(ast.SqlOrderByExpr(e, asc))
                if not self.consume_op(","):
                    break
        if self.parse_keyword("LIMIT"):
            sel.limit = self.parse_expr()
        self.consume_op(";")
        t = self.peek()
        if t.kind != EOF:
            raise ParserError(f"Unexpected trailing token {t} in {self.sql!r}")
        return sel

    def _parse_relation(self) -> ast.SqlNode:
        """FROM-clause relation: a table name, optionally followed by a
        left-deep `[INNER|LEFT [OUTER]] JOIN table ON expr` chain."""
        rel: ast.SqlNode = ast.SqlIdentifier(self.expect_identifier())
        while True:
            if self.parse_keyword("JOIN") or self.parse_keywords(
                "INNER", "JOIN"
            ):
                join_type = "inner"
            elif self.parse_keyword("LEFT"):
                self.parse_keyword("OUTER")
                self.expect_keyword("JOIN")
                join_type = "left"
            else:
                return rel
            right = ast.SqlIdentifier(self.expect_identifier())
            self.expect_keyword("ON")
            on = self.parse_expr()
            rel = ast.SqlJoin(rel, right, join_type, on)

    def _parse_create_materialized_view(self) -> ast.SqlCreateMaterializedView:
        name = self.expect_identifier()
        self.expect_keyword("AS")
        # the defining query's own text (everything after AS) rides on
        # the node so the view definition can be logged and re-planned
        # verbatim on recovery
        query_start = self.peek().pos if self.peek().kind != EOF else len(self.sql)
        self.expect_keyword("SELECT")
        query = self._parse_select()
        return ast.SqlCreateMaterializedView(
            name, query, self.sql[query_start:].strip().rstrip(";")
        )

    def _parse_create_external_table(self) -> ast.SqlCreateExternalTable:
        name = self.expect_identifier()
        columns: list[ast.SqlColumnDef] = []
        if self.consume_op("("):
            while True:
                col_name = self.expect_identifier()
                col_type = self._parse_data_type()
                if self.parse_keywords("NOT", "NULL"):
                    allow_null = False
                else:
                    self.parse_keyword("NULL")
                    allow_null = True
                columns.append(ast.SqlColumnDef(col_name, col_type, allow_null))
                if self.consume_op(","):
                    continue
                self.expect_op(")")
                break
        headers = True
        if self.parse_keywords("STORED", "AS", "CSV"):
            if self.parse_keywords("WITH", "HEADER", "ROW"):
                headers = True
            elif self.parse_keywords("WITHOUT", "HEADER", "ROW"):
                headers = False
            file_type = ast.FileType.CSV
        elif self.parse_keywords("STORED", "AS", "NDJSON"):
            file_type = ast.FileType.NdJson
        elif self.parse_keywords("STORED", "AS", "PARQUET"):
            file_type = ast.FileType.Parquet
        else:
            raise ParserError(
                f"Expected 'STORED AS' clause, found {self.peek()} in {self.sql!r}"
            )
        if not self.parse_keyword("LOCATION"):
            raise ParserError("Missing 'LOCATION' clause")
        t = self.next()
        if t.kind != STRING:
            raise ParserError(f"Expected string literal after LOCATION, found {t}")
        location = t.value
        self.consume_op(";")
        return ast.SqlCreateExternalTable(name, columns, file_type, headers, location)

    def _parse_data_type(self) -> ast.SqlType:
        w = self.peek_word()
        if w is None or w not in _TYPE_WORDS:
            raise ParserError(f"Expected a data type, found {self.peek()} in {self.sql!r}")
        self.next()
        sql_type = _TYPE_WORDS[w]
        # optional length parameter: CHAR(n) / VARCHAR(n) / FLOAT(p)
        if self.consume_op("("):
            t = self.next()
            if t.kind != NUMBER:
                raise ParserError(f"Expected length in type, found {t}")
            self.expect_op(")")
        return sql_type

    # -- expressions (precedence climbing) --
    def parse_expr(self, min_prec: int = 0) -> ast.SqlNode:
        expr = self.parse_prefix()
        while True:
            prec = self._next_precedence()
            if prec <= min_prec:
                return expr
            expr = self.parse_infix(expr, prec)

    def _next_precedence(self) -> int:
        t = self.peek()
        if t.kind == OP:
            if t.value in _CMP_OPS:
                return _PREC_CMP
            if t.value in ("+", "-"):
                return _PREC_ADD
            if t.value in ("*", "/", "%"):
                return _PREC_MUL
            return 0
        if t.kind == WORD:
            w = t.value.upper()
            if w == "OR":
                return _PREC_OR
            if w == "AND":
                return _PREC_AND
            if w == "IS":
                return _PREC_CMP
        return 0

    def parse_infix(self, left: ast.SqlNode, prec: int) -> ast.SqlNode:
        t = self.next()
        if t.kind == OP:
            op = "!=" if t.value == "<>" else t.value
            right = self.parse_expr(prec)
            return ast.SqlBinaryExpr(left, op, right)
        w = t.value.upper()
        if w in ("AND", "OR"):
            right = self.parse_expr(prec)
            return ast.SqlBinaryExpr(left, w, right)
        if w == "IS":
            if self.parse_keywords("NOT", "NULL"):
                return ast.SqlIsNotNull(left)
            if self.parse_keyword("NULL"):
                return ast.SqlIsNull(left)
            raise ParserError(f"Expected NULL or NOT NULL after IS in {self.sql!r}")
        raise ParserError(f"Unexpected infix token {t} in {self.sql!r}")

    def parse_prefix(self) -> ast.SqlNode:
        t = self.next()
        if t.kind == NUMBER:
            if "." in t.value or "e" in t.value or "E" in t.value:
                return ast.SqlDoubleLiteral(float(t.value))
            return ast.SqlLongLiteral(int(t.value))
        if t.kind == STRING:
            return ast.SqlStringLiteral(t.value)
        if t.kind == OP:
            if t.value == "(":
                inner = self.parse_expr()
                self.expect_op(")")
                return ast.SqlNested(inner)
            if t.value == "-":
                return ast.SqlUnary("-", self.parse_expr(_PREC_MUL))
            if t.value == "+":
                return ast.SqlUnary("+", self.parse_expr(_PREC_MUL))
            if t.value == "*":
                return ast.SqlWildcard()
            raise ParserError(f"Unexpected token {t} in {self.sql!r}")
        # words
        w = t.value.upper()
        if w == "TRUE":
            return ast.SqlBooleanLiteral(True)
        if w == "FALSE":
            return ast.SqlBooleanLiteral(False)
        if w == "NULL":
            return ast.SqlNullLiteral()
        if w == "NOT":
            return ast.SqlUnary("NOT", self.parse_expr(_PREC_NOT))
        if w == "CAST":
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_keyword("AS")
            dt = self._parse_data_type()
            self.expect_op(")")
            return ast.SqlCast(inner, dt)
        if t.kind == WORD:
            if w in _RESERVED_STOP:
                raise ParserError(f"Unexpected keyword {t.value!r} in {self.sql!r}")
            # function call?
            if self.consume_op("("):
                args: list[ast.SqlNode] = []
                if not self.consume_op(")"):
                    while True:
                        if self.consume_op("*"):
                            args.append(ast.SqlWildcard())
                        else:
                            args.append(self.parse_expr())
                        if self.consume_op(","):
                            continue
                        self.expect_op(")")
                        break
                return ast.SqlFunction(t.value, args)
            if self.consume_op("."):
                return ast.SqlCompoundIdentifier(
                    t.value, self.expect_identifier()
                )
            return ast.SqlIdentifier(t.value)
        raise ParserError(f"Unexpected token {t} in {self.sql!r}")


def parse_sql(sql: str) -> ast.SqlNode:
    """Parse one SQL statement (reference `DFParser::parse_sql`,
    `dfparser.rs:74`).

    This port parses in pure Python; the JAX package's C++ front-end
    (`native/sql_frontend.cpp`) implements the same grammar.
    """
    # EXPLAIN ANALYZE / EXPLAIN VERIFY are Python-side extensions (the
    # C++ front-end's grammar stops at plain EXPLAIN): strip the prefix
    # here and wrap, so both front-ends accept them identically
    m = _EXPLAIN_ANALYZE.match(sql)
    if m:
        return ast.SqlExplain(parse_sql(sql[m.end():]), analyze=True)
    m = _EXPLAIN_VERIFY.match(sql)
    if m:
        return ast.SqlExplain(parse_sql(sql[m.end():]), verify=True)
    # CREATE MATERIALIZED VIEW is a Python-side extension too (the
    # ingest subsystem's continuous queries): strip the prefix here and
    # parse the defining SELECT through whichever front-end is active,
    # keeping the verbatim query text for WAL logging and recovery
    # re-planning
    m = _CREATE_MVIEW.match(sql)
    if m:
        query_sql = sql[m.end():].strip().rstrip(";")
        query = parse_sql(query_sql)
        if not isinstance(query, ast.SqlSelect):
            raise ParserError(
                "CREATE MATERIALIZED VIEW requires AS SELECT ...")
        return ast.SqlCreateMaterializedView(m.group(1), query, query_sql)
    return Parser(sql).parse_statement()


def _split(text: str, flush: bool) -> tuple[list[str], str]:
    stmts: list[str] = []
    buf: list[str] = []
    i, n = 0, len(text)
    in_str = False
    tail_start = 0  # index just past the last statement terminator
    while i < n:
        c = text[i]
        if in_str:
            buf.append(c)
            if c == "'":
                if i + 1 < n and text[i + 1] == "'":
                    buf.append(text[i + 1])
                    i += 1
                else:
                    in_str = False
        elif c == "'":
            in_str = True
            buf.append(c)
        elif c == "-" and i + 1 < n and text[i + 1] == "-":
            while i < n and text[i] != "\n":
                i += 1
            continue
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            end = text.find("*/", i + 2)
            if end < 0:
                # unclosed block comment: keep the raw text (a REPL may
                # append the closing */; a flush surfaces the
                # tokenizer's "Unterminated block comment" error)
                buf.append(text[i:])
                i = n
                continue
            i = end + 2
            continue
        elif c == ";":
            s = "".join(buf).strip()
            if s:
                stmts.append(s)
            buf = []
            tail_start = i + 1
        else:
            buf.append(c)
        i += 1
    if flush:
        s = "".join(buf).strip()
        if s:
            stmts.append(s)
    return stmts, text[tail_start:]


def split_statements_partial(text: str) -> tuple[list[str], str]:
    """Split semicolon-terminated statements, respecting string
    literals (with ``''`` escapes) and ``--`` comments.  Returns the
    comment-stripped complete statements plus the *raw* unterminated
    tail, so a REPL can append more input to it (a tail ending inside
    a comment keeps the comment text: the next appended line's newline
    is what terminates it)."""
    return _split(text, flush=False)


def split_statements(text: str) -> list[str]:
    """Split a whole script into statements (console --script mode,
    reference `bin/console/main.rs:41-63`); an unterminated final
    statement is included."""
    return _split(text, flush=True)[0]
