"""PyTorch/CUDA port, slice 10: the native SQL front-end
(`datafusion_tpu_torch/native/sqlfront.py` over `native/sql_frontend.cpp`,
built into the port's native library) against the port's Python parser
and the JAX package.

The corpus is the JAX package's `tests/test_native_frontend.py`: both
port parsers give the JAX package's AST and reject what it rejects;
plans planned from either give the JAX package's plan JSON, which the
C++ IR round-trips byte for byte and pretty-prints as `repr(plan)`.
EXPLAIN's text equals the JAX package's on the golden-corpus queries.
`parse_sql` routes as the JAX package's: the C++ parser by default,
Python for JOIN, non-ASCII text and under DATAFUSION_TPU_NATIVE=0.
"""

from __future__ import annotations

import re

import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.sql.parser import Parser as JaxParser
from datafusion_tpu.sql.planner import SqlToRel as JaxSqlToRel

import datafusion_tpu_torch as tdf
import datafusion_tpu_torch.native.sqlfront as sqlfront
from datafusion_tpu_torch.errors import ParserError, PlanError
from datafusion_tpu_torch.native.sqlfront import (
    native_parse_sql,
    native_plan_repr,
    native_plan_roundtrip,
)
from datafusion_tpu_torch.sql.parser import Parser, parse_sql
from datafusion_tpu_torch.sql.planner import SqlToRel

from test_native_frontend import BAD_STATEMENTS, PLAN_QUERIES, STATEMENTS
from test_torch_port import _GOLDEN_SCHEMAS, GOLDEN_QUERIES


@pytest.mark.parametrize("sql", STATEMENTS)
def test_same_ast_in_both_parsers_and_the_jax_package(sql):
    native = native_parse_sql(sql)
    assert native == Parser(sql).parse_statement()
    assert repr(native) == repr(JaxParser(sql).parse_statement())


@pytest.mark.parametrize("sql", BAD_STATEMENTS)
def test_same_rejection(sql):
    with pytest.raises(ParserError):
        native_parse_sql(sql)
    with pytest.raises(ParserError):
        Parser(sql).parse_statement()
    with pytest.raises(jdf.ParserError):
        JaxParser(sql).parse_statement()


class _Catalog:
    def __init__(self, pkg):
        self.pkg = pkg

    def get_table_meta(self, name):
        p = self.pkg
        return p.Schema([
            p.Field("a", p.DataType.INT64, False),
            p.Field("b", p.DataType.FLOAT64, True),
            p.Field("c", p.DataType.UTF8, True),
            p.Field("d", p.DataType.UINT16, True),
        ])

    def get_function_meta(self, name):
        return None


@pytest.mark.parametrize("sql", PLAN_QUERIES)
def test_plan_json_roundtrip_and_repr(sql):
    want = JaxSqlToRel(_Catalog(jdf)).sql_to_rel(JaxParser(sql).parse_statement())
    for stmt in (native_parse_sql(sql), Parser(sql).parse_statement()):
        plan = SqlToRel(_Catalog(tdf)).sql_to_rel(stmt)
        js = plan.to_json_str()
        assert js == want.to_json_str()
        assert native_plan_roundtrip(js) == js
        assert native_plan_repr(js) == repr(plan) == repr(want)


def test_malformed_plan_rejected():
    with pytest.raises(PlanError):
        native_plan_roundtrip('{"NotAPlan":{}}')
    with pytest.raises(PlanError):
        native_plan_roundtrip('{"Selection":{"expr":{"Column":0}}}')


def _explain(pkg, sql):
    table = re.search(r"FROM (\w+)", sql).group(1)
    schema = pkg.Schema([pkg.Field(name, getattr(pkg.DataType, t), False)
                         for name, t in _GOLDEN_SCHEMAS[table]])
    if pkg is jdf:
        ctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.register_datasource(table, JaxMemorySource(schema, []))
    else:
        ctx = tdf.ExecutionContext(device="cpu")
        ctx.register_datasource(table, tdf.MemoryDataSource(schema, []))
    return ctx.sql("EXPLAIN " + sql)


@pytest.mark.parametrize("sql", GOLDEN_QUERIES)
def test_explain_text_equals_the_jax_package(sql):
    got, want = _explain(tdf, sql), _explain(jdf, sql)
    assert isinstance(got, tdf.ExplainResult)
    assert repr(got) == repr(want)
    assert native_plan_repr(got.plan.to_json_str()) == repr(got)


# ------------------------------------------------------------ routing


@pytest.fixture
def spy(monkeypatch):
    calls = []
    orig = sqlfront.native_parse_sql

    def wrapped(sql):
        calls.append(sql)
        return orig(sql)

    monkeypatch.setattr(sqlfront, "native_parse_sql", wrapped)
    return calls


def test_default_path_is_native(spy):
    parse_sql("SELECT 1")
    parse_sql("EXPLAIN VERIFY SELECT a FROM t")
    assert [s.strip() for s in spy] == ["SELECT 1", "SELECT a FROM t"]


def test_join_routes_to_python(spy):
    stmt = parse_sql("SELECT a FROM t JOIN u ON t.a = u.a")
    assert spy == [] and type(stmt.relation).__name__ == "SqlJoin"


def test_native_off_means_the_python_parser(spy, monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_NATIVE", "0")
    assert sqlfront.native_parse_sql("SELECT a FROM t") is None
    assert parse_sql("SELECT a FROM t WHERE b > 1") == Parser(
        "SELECT a FROM t WHERE b > 1").parse_statement()
    assert native_plan_repr("{}") is None


def test_non_ascii_routes_to_python():
    assert native_parse_sql("SELECT ünicøde FROM t") is None
    assert parse_sql("SELECT ünicøde FROM t").projection[0].name == "ünicøde"
    assert parse_sql("SELECT a\xa0FROM t").relation.name == "t"


def test_a_failed_build_raises_io_error(monkeypatch):
    import datafusion_tpu_torch.native as native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "no-compiler")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(tdf.IoError):
        parse_sql("SELECT 1")
