"""PyTorch/CUDA port, slice 10: the static plan verifier
(`datafusion_tpu_torch/analysis/verify.py`) against the JAX package's.

Every case of the JAX package's `tests/test_analysis.py`
`TestVerifierAccepts` / `TestVerifierRejects` runs here on the same
plan built in both packages: the same verdict, the same diagnostics
(plan path, message, expression) and the same rendered report.  Then
the engine wiring: a computed GROUP BY or ORDER BY key raises
`PlanVerificationError` with the JAX package's message in both, EXPLAIN
VERIFY renders the same text, and `DATAFUSION_TPU_VERIFY=0` skips it.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import pytest

import datafusion_tpu as jdf
import datafusion_tpu.analysis.verify as jverify
import datafusion_tpu.errors as jerrors
import datafusion_tpu.plan.expr as jexpr
import datafusion_tpu.plan.logical as jlogical
from datafusion_tpu.sql.parser import parse_sql as jax_parse_sql

import datafusion_tpu_torch as tdf
import datafusion_tpu_torch.analysis.verify as tverify
import datafusion_tpu_torch.errors as terrors
import datafusion_tpu_torch.plan.expr as texpr
import datafusion_tpu_torch.plan.logical as tlogical
from datafusion_tpu_torch.sql.parser import parse_sql as port_parse_sql

CSV = "city,lat,pop,flag\nSF,37.7,800000,true\nLA,34.0,4000000,false\nNY,40.7,8000000,true\n"


def _pkg(top, expr, logical, verify, errors, parse_sql):
    ns = types.SimpleNamespace(top=top, verify=verify, errors=errors, parse_sql=parse_sql)
    for mod in (expr, logical):
        for name in dir(mod):
            if not name.startswith("_"):
                setattr(ns, name, getattr(mod, name))
    for name in ("DataType", "Field", "Schema"):
        setattr(ns, name, getattr(top, name))
    return ns


JAX = _pkg(jdf, jexpr, jlogical, jverify, jerrors, jax_parse_sql)
PORT = _pkg(tdf, texpr, tlogical, tverify, terrors, port_parse_sql)


def schema(m):
    return m.Schema([
        m.Field("city", m.DataType.UTF8),
        m.Field("lat", m.DataType.FLOAT64),
        m.Field("pop", m.DataType.INT64),
        m.Field("flag", m.DataType.BOOLEAN),
    ])


def scan(m, projection=None):
    return m.TableScan("default", "t", schema(m), projection)


def lit_i(m, v):
    return m.Literal(m.ScalarValue.int64(v))


def lit_s(m, v):
    return m.Literal(m.ScalarValue.utf8(v))


def one(m, name, t):
    return m.Schema([m.Field(name, t)])


def ctx_of(m, tmp_path):
    p = tmp_path / "t.csv"
    p.write_text(CSV)
    if m is JAX:
        c = jdf.ExecutionContext(device="cpu", result_cache=False)
    else:
        c = tdf.ExecutionContext(device="cpu")
    c.register_csv("t", str(p), schema(m))
    return c


def findings(report):
    return [(d.path, d.message, d.expr) for d in report.diagnostics]


# ------------------------------------------------------------ accepts

ACCEPT_SQL = [
    "SELECT city, pop FROM t",
    "SELECT * FROM t WHERE lat > 35.0",
    "SELECT pop + 1, CAST(pop AS DOUBLE) FROM t",
    "SELECT city FROM t WHERE city = 'SF'",
    "SELECT city FROM t WHERE 'SF' = city",
    "SELECT city FROM t WHERE city >= 'LA' AND pop > 100",
    "SELECT city, MIN(lat), MAX(city), COUNT(pop) FROM t GROUP BY city",
    "SELECT SUM(pop), AVG(lat) FROM t",
    "SELECT COUNT(*) FROM t",
    "SELECT 1 + 2",
    "SELECT city FROM t WHERE lat IS NOT NULL ORDER BY pop DESC LIMIT 2",
    "SELECT sqrt(lat) FROM t",
    "SELECT city FROM t WHERE pop IS NULL",
]


@pytest.mark.parametrize("sql", ACCEPT_SQL)
def test_planner_output_verifies_in_both(tmp_path, sql):
    out = {}
    for m in (JAX, PORT):
        ctx = ctx_of(m, tmp_path)
        report = m.verify.verify_plan(ctx._plan(m.parse_sql(sql)), functions=ctx.functions)
        assert report.ok, report.render()
        out[m is PORT] = report.render()
    assert out[True] == out[False]


def _count_star_over_empty(m):
    agg = m.AggregateFunction("COUNT", [m.Column(0)], m.DataType.UINT64, True)
    return m.Aggregate(m.EmptyRelation(m.Schema([])), [], [agg],
                       m.Schema([m.Field("COUNT", m.DataType.UINT64, True)]))


def _every_variant(m):
    base = m.Selection(m.BinaryExpr(m.Column(1), m.Operator.Gt,
                                    m.Literal(m.ScalarValue.float64(0.0))), scan(m))
    proj = m.Projection(
        [m.Column(0), m.Column(2), m.IsNull(m.Column(1)), m.IsNotNull(m.Column(3))],
        base,
        m.Schema([m.Field("city", m.DataType.UTF8), m.Field("pop", m.DataType.INT64),
                  m.Field("is_null", m.DataType.BOOLEAN, False),
                  m.Field("is_not_null", m.DataType.BOOLEAN, False)]),
    )
    sort = m.Sort([m.SortExpr(m.Column(1), False)], proj, proj.schema)
    return m.Limit(2, sort, sort.schema)


@pytest.mark.parametrize("build", [_count_star_over_empty, _every_variant],
                         ids=["count_star_over_empty_relation", "every_plan_variant"])
def test_plan_verifies_in_both(build):
    reports = [m.verify.verify_plan(build(m)) for m in (JAX, PORT)]
    assert all(r.ok for r in reports), reports[1].render()
    assert reports[1].render() == reports[0].render()
    labels = [label for _, label, _ in reports[1].operators]
    assert labels == [label for _, label, _ in reports[0].operators]


# ------------------------------------------------------------ rejects


def _agg(m, name, args, t, group=(), fields=None):
    a = m.AggregateFunction(name, args, t)
    return m.Aggregate(scan(m), list(group), [a], fields or one(m, name, t))


REJECTS = {
    "unknown_column": (lambda m: m.Projection([m.Column(9)], scan(m),
                                              one(m, "x", m.DataType.INT64)),
                       "unknown column #9"),
    "scan_projection_out_of_range": (lambda m: scan(m, projection=[0, 12]), "out of range"),
    "non_boolean_predicate": (lambda m: m.Selection(m.Column(2), scan(m)), "expected Boolean"),
    "utf8_vs_number_comparison": (
        lambda m: m.Selection(m.BinaryExpr(m.Column(0), m.Operator.Eq, lit_i(m, 3)), scan(m)),
        "Utf8 column compares only against a string"),
    "utf8_column_vs_column_comparison": (
        lambda m: m.Selection(m.BinaryExpr(m.Column(0), m.Operator.Lt, m.Column(0)), scan(m)),
        "column-vs-literal only"),
    "bare_utf8_literal_projection": (
        lambda m: m.Projection([lit_s(m, "x")], scan(m), one(m, "lit", m.DataType.UTF8)),
        "bare string literals"),
    "utf8_arithmetic": (
        lambda m: m.Projection([m.BinaryExpr(m.Column(0), m.Operator.Plus, lit_s(m, "x"))],
                               scan(m), one(m, "y", m.DataType.UTF8)),
        "not defined on Utf8"),
    "no_common_supertype": (
        lambda m: m.Projection([m.BinaryExpr(m.Column(3), m.Operator.Plus, lit_i(m, 1))],
                               scan(m), one(m, "y", m.DataType.INT64)),
        "no common supertype"),
    "boolean_operand_not_boolean": (
        lambda m: m.Selection(m.BinaryExpr(m.Column(2), m.Operator.And, m.Column(3)), scan(m)),
        "expected Boolean"),
    "utf8_cast": (
        lambda m: m.Projection([m.Cast(m.Column(0), m.DataType.INT64)], scan(m),
                               one(m, "cast", m.DataType.INT64)),
        "CAST Utf8"),
    "unknown_aggregate": (lambda m: _agg(m, "median", [m.Column(1)], m.DataType.FLOAT64),
                          "unknown aggregate"),
    "aggregate_arity": (lambda m: _agg(m, "min", [m.Column(1), m.Column(2)],
                                       m.DataType.FLOAT64),
                        "exactly one argument"),
    "sum_over_utf8": (lambda m: _agg(m, "sum", [m.Column(0)], m.DataType.UTF8), "over Utf8"),
    "min_over_computed_utf8": (
        lambda m: _agg(m, "min", [m.Cast(m.Column(0), m.DataType.UTF8)], m.DataType.UTF8),
        "bare column"),
    "computed_group_key": (
        lambda m: _agg(m, "count", [m.Column(2)], m.DataType.UINT64,
                       group=[m.BinaryExpr(m.Column(2), m.Operator.Plus, lit_i(m, 1))],
                       fields=m.Schema([m.Field("k", m.DataType.INT64),
                                        m.Field("count", m.DataType.UINT64)])),
        "bare column references"),
    "count_return_type": (lambda m: _agg(m, "count", [m.Column(2)], m.DataType.INT64),
                          "COUNT returns UInt64"),
    "aggregate_return_type_mismatch": (lambda m: _agg(m, "min", [m.Column(1)],
                                                      m.DataType.INT64),
                                       "argument computes Float64"),
    "declared_schema_arity_mismatch": (
        lambda m: m.Projection([m.Column(1)], scan(m),
                               m.Schema([m.Field("a", m.DataType.FLOAT64),
                                         m.Field("b", m.DataType.INT64)])),
        "declared schema has 2 field(s)"),
    "declared_dtype_mismatch": (
        lambda m: m.Projection([m.Column(1)], scan(m), one(m, "lat", m.DataType.INT64)),
        "declared field 0"),
    "non_column_sort_key": (
        lambda m: m.Sort([m.SortExpr(m.BinaryExpr(m.Column(2), m.Operator.Plus,
                                                  lit_i(m, 1)), True)],
                         scan(m), schema(m)),
        "ORDER BY keys must be bare column"),
    "negative_limit": (lambda m: m.Limit(-1, scan(m), schema(m)), "non-negative"),
    "aggregate_in_scalar_context": (
        lambda m: m.Selection(
            m.BinaryExpr(m.AggregateFunction("min", [m.Column(1)], m.DataType.FLOAT64),
                         m.Operator.Gt, m.Literal(m.ScalarValue.float64(0.0))),
            scan(m)),
        "outside an Aggregate operator"),
}


def _rejects_alike(build, fragment, functions=None):
    reports = {}
    for m in (JAX, PORT):
        report = m.verify.verify_plan(build(m), functions=None if functions is None
                                      else functions[m is PORT])
        assert not report.ok
        text = "\n".join(repr(d) for d in report.diagnostics)
        assert fragment in text, text
        with pytest.raises(m.errors.PlanVerificationError):
            report.raise_if_failed()
        reports[m is PORT] = report
    assert findings(reports[True]) == findings(reports[False])
    assert reports[True].render() == reports[False].render()
    return reports[True]


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_rejects_as_the_jax_package(case):
    build, fragment = REJECTS[case]
    report = _rejects_alike(build, fragment)
    if case == "unknown_column":
        # source-anchored: names the plan path and the expression
        assert report.diagnostics[0].path == "Projection.expr[0]"
        assert report.diagnostics[0].expr == "#9"


def _fn(m, name, args, t):
    return m.Projection([m.ScalarFunction(name, args, t)], scan(m), one(m, name, t))


UDF_CASES = {
    "unknown_function": (lambda m: _fn(m, "nosuch", [m.Column(1)], m.DataType.FLOAT64),
                         "unknown function"),
    "arity": (lambda m: _fn(m, "twice", [m.Column(1), m.Column(1)], m.DataType.FLOAT64),
              "expects 1 argument"),
    "argument_dtype": (lambda m: _fn(m, "twice", [m.Column(0)], m.DataType.FLOAT64),
                       "no implicit coercion"),
    "return_type": (lambda m: _fn(m, "twice", [m.Column(1)], m.DataType.INT64),
                    "registry says"),
}


@pytest.mark.parametrize("case", sorted(UDF_CASES))
def test_udf_signature_checks_as_the_jax_package(tmp_path, case):
    jctx, tctx = ctx_of(JAX, tmp_path), ctx_of(PORT, tmp_path)
    jctx.register_udf("twice", [jdf.DataType.FLOAT64], jdf.DataType.FLOAT64,
                      jax_fn=lambda x: x * jnp.float64(2))
    tctx.register_udf("twice", [tdf.DataType.FLOAT64], tdf.DataType.FLOAT64,
                      torch_fn=lambda x: x * 2.0)
    build, fragment = UDF_CASES[case]
    _rejects_alike(build, fragment, functions={False: jctx.functions, True: tctx.functions})


# ------------------------------------------------------- engine wiring

REPAIRED = [
    "SELECT city, COUNT(1) FROM t GROUP BY pop % 3",
    "SELECT pop FROM t ORDER BY pop * 2",
    "SELECT city, pop FROM t ORDER BY pop + 1 LIMIT 2",
    "SELECT city FROM t WHERE city < city",
]


@pytest.mark.parametrize("sql", REPAIRED)
def test_rejected_before_lowering_with_the_jax_message(tmp_path, sql):
    """Computed GROUP BY and ORDER BY keys, which the port used to
    refuse with a bare NotSupportedError from the aggregate or the
    lowering, now fail in the verifier as in the JAX package."""
    msgs = {}
    for m in (JAX, PORT):
        with pytest.raises(m.errors.PlanVerificationError) as ei:
            ctx_of(m, tmp_path).sql(sql)
        assert isinstance(ei.value, m.errors.NotSupportedError)
        assert isinstance(ei.value, m.errors.PlanError)
        msgs[m is PORT] = (str(ei.value), [repr(d) for d in ei.value.diagnostics])
    assert msgs[True] == msgs[False]


def test_execute_rejects_a_bad_plan_before_any_operator(tmp_path):
    ctx = ctx_of(PORT, tmp_path)
    bad = PORT.Projection([PORT.Column(9)], scan(PORT), one(PORT, "x", PORT.DataType.INT64))
    with pytest.raises(terrors.PlanVerificationError) as ei:
        ctx.execute(bad)
    assert not isinstance(ei.value, terrors.TransientError)
    assert ei.value.diagnostics


def test_verify_off_is_passthrough(tmp_path, monkeypatch):
    ctx = ctx_of(PORT, tmp_path)
    sql = "SELECT city, MIN(lat), COUNT(pop) FROM t WHERE pop > 100 GROUP BY city"
    rows_on = sorted(ctx.sql_collect(sql).to_rows())
    monkeypatch.setenv("DATAFUSION_TPU_VERIFY", "0")
    assert sorted(ctx.sql_collect(sql).to_rows()) == rows_on
    bad = PORT.Projection([PORT.Column(9)], scan(PORT), one(PORT, "x", PORT.DataType.INT64))
    # unverified, the bad plan gets past lowering and fails in its
    # operator, mid-scan
    with pytest.raises(Exception) as ei:
        tdf.collect(ctx.execute(bad))
    assert not isinstance(ei.value, terrors.PlanVerificationError)


EXPLAIN_VERIFY = [
    "EXPLAIN VERIFY SELECT city, MIN(lat) FROM t GROUP BY city ORDER BY city LIMIT 1",
    "EXPLAIN VERIFY SELECT city FROM t WHERE city < city",
    "EXPLAIN VERIFY SELECT pop + 1, CAST(pop AS DOUBLE) FROM t WHERE lat > 35.0",
]


@pytest.mark.parametrize("sql", EXPLAIN_VERIFY)
def test_explain_verify_text_equals_the_jax_package(tmp_path, sql):
    jout = ctx_of(JAX, tmp_path).sql(sql)
    tout = ctx_of(PORT, tmp_path).sql(sql)
    assert isinstance(tout, tdf.ExplainVerifyResult)
    assert tout.ok == jout.ok
    assert repr(tout) == repr(jout)
    assert repr(tout).count("::") == len(tout.report.operators)


def test_assert_schema_preserved(tmp_path):
    s = schema(PORT)
    tverify.assert_schema_preserved(s, s)
    with pytest.raises(terrors.PlanVerificationError, match="changed the inferred schema"):
        tverify.assert_schema_preserved(s, s.select([0, 1]))


def test_verify_exprs_matches_the_jax_package():
    reports = [m.verify.verify_exprs([lit_s(m, "x"), m.Column(7)], schema(m))
               for m in (JAX, PORT)]
    assert findings(reports[1]) == findings(reports[0]) and not reports[1].ok
