"""Bindings for the native SQL front-end and plan IR
(`native/sql_frontend.cpp`), the counterpart of the JAX package's
`native/sqlfront.py`.

`native_parse_sql` returns the same `sql.ast` dataclass tree the Python
parser builds, so the planner is front-end-agnostic; numeric literal
texts ride through JSON as raw strings and are converted here (Python
ints are unbounded: the native side never narrows them).  The library
is the one `native/__init__.py` builds on first use, beside the CSV
parser; a failed build or load raises IoError.  `DATAFUSION_TPU_NATIVE=0`
makes every function here return None, so callers take the Python
parser (`sql/parser.parse_sql`).
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Optional

from datafusion_tpu_torch.errors import ParserError, PlanError
from datafusion_tpu_torch.native import load_library
from datafusion_tpu_torch.sql import ast


def _library():
    """The native library, or None when DATAFUSION_TPU_NATIVE=0."""
    if os.environ.get("DATAFUSION_TPU_NATIVE", "1") == "0":
        return None
    return load_library()


def frontend_available() -> bool:
    """Whether the C++ SQL front end is on: the library loads and
    DATAFUSION_TPU_NATIVE is not 0."""
    from datafusion_tpu_torch.errors import IoError

    try:
        lib = _library()
    except IoError:
        return False
    return lib is not None and hasattr(lib, "dtf_parse_sql")


def _call(lib, fn_name: str, arg: str) -> str:
    ptr = getattr(lib, fn_name)(arg.encode("utf-8"))
    if not ptr:
        raise MemoryError(f"{fn_name} returned NULL")
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.dtf_free(ptr)


def native_parse_sql(sql: str) -> Optional[ast.SqlNode]:
    """Parse via the C++ front-end; None with DATAFUSION_TPU_NATIVE=0 or
    when the text needs Python's unicode character classification (the
    C++ tokenizer is byte-oriented, so any non-ASCII statement takes the
    Python parser: identical grammar, exact unicode semantics)."""
    if not sql.isascii():
        return None
    lib = _library()
    if lib is None:
        return None
    out = json.loads(_call(lib, "dtf_parse_sql", sql))
    if "error" in out:
        raise ParserError(out["error"])
    return _stmt(out["ok"])


def _plan_call(fn_name: str, plan_json: str) -> Optional[str]:
    lib = _library()
    if lib is None:
        return None
    out = _call(lib, fn_name, plan_json)
    if out.startswith('{"error":'):
        raise PlanError(json.loads(out)["error"])
    return out


def native_plan_roundtrip(plan_json: str) -> Optional[str]:
    """Deserialize a plan into the C++ IR and re-serialize (the wire
    contract proof)."""
    return _plan_call("dtf_plan_roundtrip", plan_json)


def native_plan_repr(plan_json: str) -> Optional[str]:
    """Pretty-print a serialized plan via the C++ IR (the EXPLAIN
    format, `repr(plan)`)."""
    return _plan_call("dtf_plan_repr", plan_json)


# -- AST JSON -> sql.ast dataclasses --
def _stmt(obj) -> ast.SqlNode:
    ((tag, body),) = obj.items()
    if tag == "Select":
        sel = ast.SqlSelect()
        sel.projection = [_expr(e) for e in body["projection"]]
        if body["relation"] is not None:
            sel.relation = ast.SqlIdentifier(body["relation"])
        if body["selection"] is not None:
            sel.selection = _expr(body["selection"])
        sel.group_by = [_expr(e) for e in body["group_by"]]
        if body["having"] is not None:
            sel.having = _expr(body["having"])
        sel.order_by = [
            ast.SqlOrderByExpr(_expr(o["expr"]), o["asc"]) for o in body["order_by"]
        ]
        if body["limit"] is not None:
            sel.limit = _expr(body["limit"])
        return sel
    if tag == "CreateExternalTable":
        return ast.SqlCreateExternalTable(
            body["name"],
            [
                ast.SqlColumnDef(
                    c["name"], ast.SqlType(c["type"]), c["allow_null"]
                )
                for c in body["columns"]
            ],
            ast.FileType(body["file_type"]),
            body["header_row"],
            body["location"],
        )
    if tag == "Explain":
        return ast.SqlExplain(_stmt(body))
    raise ParserError(f"Unknown native AST statement {tag!r}")


def _expr(obj) -> ast.SqlNode:
    if obj == "Wildcard":
        return ast.SqlWildcard()
    if obj == "Null":
        return ast.SqlNullLiteral()
    ((tag, body),) = obj.items()
    if tag == "Identifier":
        return ast.SqlIdentifier(body)
    if tag == "Long":
        return ast.SqlLongLiteral(int(body))
    if tag == "Double":
        return ast.SqlDoubleLiteral(float(body))
    if tag == "String":
        return ast.SqlStringLiteral(body)
    if tag == "Bool":
        return ast.SqlBooleanLiteral(body)
    if tag == "Binary":
        return ast.SqlBinaryExpr(_expr(body["left"]), body["op"], _expr(body["right"]))
    if tag == "Unary":
        return ast.SqlUnary(body["op"], _expr(body["expr"]))
    if tag == "Cast":
        return ast.SqlCast(_expr(body["expr"]), ast.SqlType(body["type"]))
    if tag == "IsNull":
        return ast.SqlIsNull(_expr(body))
    if tag == "IsNotNull":
        return ast.SqlIsNotNull(_expr(body))
    if tag == "Function":
        return ast.SqlFunction(body["name"], [_expr(a) for a in body["args"]])
    if tag == "Nested":
        return ast.SqlNested(_expr(body))
    if tag == "Aliased":
        return ast.SqlAliased(_expr(body["expr"]), body["alias"])
    raise ParserError(f"Unknown native AST expression {tag!r}")
