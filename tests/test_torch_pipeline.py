"""PyTorch/CUDA port, slice 6: scan -> filter -> project
(`PipelineRelation`), against the JAX package.

The same SQL (or the same logical plan, as JSON) on the same
numpy-seeded tables runs through `datafusion_tpu` and
`datafusion_tpu_torch`, both with `device="cpu"`; each table is built
once in the JAX package and carried into the port by
`datafusion_tpu_torch.convert`.  Ints, strings, NULLs and row order
match exactly, floats within rtol 1e-9 (torch's CPU `sqrt` can differ
from XLA's in the last bit).

Cases: Selection, Projection, Projection(Selection) and deeper chains
(built as plans, since the SQL front end makes at most two nodes);
filter only; computed and pass-through Utf8 columns; a NULL predicate;
constant predicates; a table-less SELECT; `DATAFUSION_TPU_FUSE=0`
against `=1`; `host_fn` projections (a Utf8 producer and the geo struct
pair); a `host_fn` in WHERE, which both packages refuse; and the probe
queries of the slice over an int64, UInt32, f64 and Utf8 table.

The helpers here (`jax_table`, `run_both`, `assert_same`) serve the
other slice-6 test files too.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.exec.materialize import collect as jax_collect

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import convert
from datafusion_tpu_torch.exec.relation import PipelineRelation

T = jdf.DataType


def jax_table(fields, columns, validity=None, batch_rows=2048):
    """A JAX-package MemoryDataSource from (name, type, nullable)
    fields; Utf8 columns come as Python strings and are encoded batch
    by batch, so the shared dictionary grows as a scan grows it."""
    schema = jdf.Schema([jdf.Field(n, t, nl) for n, t, nl in fields])
    n = len(columns[0])
    dicts = [JaxDictionary() if f.data_type == T.UTF8 else None for f in schema.fields]
    batches = []
    for lo in range(0, max(n, 1), batch_rows):
        sl = slice(lo, lo + batch_rows)
        cols = [d.encode(list(c[sl])) if d is not None else np.asarray(c[sl])
                for c, d in zip(columns, dicts)]
        valids = [None if v is None else np.asarray(v[sl])
                  for v in (validity or [None] * len(columns))]
        batches.append(jax_make_host_batch(schema, cols, valids, dicts))
    return JaxMemorySource(schema, batches)


def carry(src):
    """The JAX-package source as a port MemoryDataSource (same codes,
    dictionaries and padding)."""
    return convert.memory_source(src.schema.to_json(),
                                 [convert.export_batch(b) for b in src.batches()])


def contexts(src, name="t", batch_size=131072):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch_size)
    jctx.register_datasource(name, src)
    tctx = tdf.ExecutionContext(device="cpu", batch_size=batch_size)
    tctx.register_datasource(name, carry(src))
    return jctx, tctx


def run_both(src, sql, name="t"):
    jctx, tctx = contexts(src, name)
    return jax_collect(jctx.sql(sql)), tdf.collect(tctx.sql(sql))


def _same(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        if math.isnan(w) or math.isnan(g):
            return math.isnan(w) and math.isnan(g)
        return math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return g == w and type(g) is type(w)


def assert_same(got, want, ordered=True):
    """Port rows == JAX rows: names and types of the schema, then rows
    (in order, or as multisets when `ordered` is False)."""
    assert [(f.name, repr(f.data_type)) for f in got.schema.fields] == [
        (f.name, repr(f.data_type)) for f in want.schema.fields]
    g_rows, w_rows = got.to_rows(), want.to_rows()
    if not ordered:
        g_rows, w_rows = sorted(g_rows, key=repr), sorted(w_rows, key=repr)
    assert len(g_rows) == len(w_rows)
    for g, w in zip(g_rows, w_rows):
        assert len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)), (g, w)
    return g_rows


def check(src, sql, ordered=False):
    want, got = run_both(src, sql)
    return assert_same(got, want, ordered)


def probe_table(n=5000, seed=5, batch_rows=2048):
    """The slice's probe table: int64 i, UInt32 u, f64 f (with NULLs),
    Utf8 tag."""
    rng = np.random.default_rng(seed)
    words = np.array(["oak", "ash", "elm", "fir", "yew", "birch"], dtype=object)
    cols = [rng.integers(-60, 60, n), rng.integers(0, 40, n).astype(np.uint32),
            rng.normal(size=n).round(3), words[rng.integers(0, 6, n)]]
    validity = [None, None, rng.random(n) > 0.1, None]
    return jax_table([("i", T.INT64, False), ("u", T.UINT32, False),
                      ("f", T.FLOAT64, True), ("tag", T.UTF8, False)],
                     cols, validity, batch_rows)


PROBE = [
    "SELECT i FROM t WHERE i > 3",
    "SELECT i, f + 1 FROM t",
    "SELECT tag, COUNT(1) FROM t WHERE u > 5 GROUP BY tag",
    "SELECT tag, MAX(u) FROM t GROUP BY tag",
    "SELECT i, f FROM t ORDER BY f DESC LIMIT 5",
    "SELECT i, f FROM t ORDER BY i LIMIT 100000",
]


@pytest.mark.parametrize("sql", PROBE)
def test_probe_queries_match_jax_package(sql):
    check(probe_table(), sql, ordered="ORDER BY" in sql)


SHAPES = [
    # filter + column projection, a computed projection, both
    "SELECT i, tag FROM t WHERE i > 3 AND i < 40",
    "SELECT i * 2, f / 3, i % 7, u * 2 - 1 FROM t",
    "SELECT tag, u + 1, f FROM t WHERE f > 0.5 OR i < -50",
    # Utf8 predicates (codes and compare tables) and pass-through Utf8
    "SELECT tag, f FROM t WHERE tag = 'elm'",
    "SELECT tag, i FROM t WHERE tag > 'birch' AND tag <> 'oak'",
    # NULLs: a NULL predicate drops the row; IS [NOT] NULL
    "SELECT i, f FROM t WHERE f > 0",
    "SELECT i FROM t WHERE f IS NULL",
    "SELECT i, f * 2 FROM t WHERE f IS NOT NULL AND i > 0",
    # constant predicates: the length still comes from a column
    "SELECT i FROM t WHERE 1 = 1",
    "SELECT i, tag FROM t WHERE 1 = 0",
    "SELECT i FROM t WHERE 2 > 1 AND i > 50",
    # every column, no projection arithmetic
    "SELECT * FROM t WHERE i > 40",
    # casts and builtins in projections
    "SELECT CAST(i AS DOUBLE) / 4, sqrt(u), abs(i) FROM t WHERE u < 10",
    # a sort and an aggregate over a computed projection (node by node)
    "SELECT i + 1, tag FROM t ORDER BY tag, i",
    "SELECT tag, SUM(i * 2), MIN(f + 1) FROM t WHERE u > 3 GROUP BY tag",
]


@pytest.mark.parametrize("sql", SHAPES)
def test_pipeline_shapes_match_jax_package(sql):
    check(probe_table(), sql, ordered="ORDER BY" in sql)


def test_table_less_select_matches():
    src = probe_table(10)
    for sql in ("SELECT 1 + 2", "SELECT 3.5 * 2, 7 / 2, 7 % 3"):
        check(src, sql)


def test_pipeline_relation_ships_only_the_columns_it_reads():
    _, tctx = contexts(probe_table(3000))
    rel = tctx.sql("SELECT tag, i, f + 1 FROM t WHERE u > 5")
    assert isinstance(rel, PipelineRelation)
    # the predicate reads u (1), the projection f (2); i and tag pass
    # through on the host
    assert rel.core.used_cols == [1, 2]
    assert rel.core.identity_proj == {0: 3, 1: 0}
    out = next(iter(rel.batches()))
    assert isinstance(out.data[0], np.ndarray) and isinstance(out.data[1], np.ndarray)
    filter_only = tctx.execute(_plan_from_jax(
        "t", probe_table(10).schema, lambda p: jdf.Selection(_gt(1, 5, T.UINT32), p)))
    assert isinstance(filter_only, PipelineRelation)
    assert filter_only.core.used_cols == [1] and filter_only.core.proj_fns is None


def test_column_selection_reuses_its_output_batches():
    """A pure column projection touches no device and hands out the same
    batch objects on a re-scan (device copies cached on them survive)."""
    _, tctx = contexts(probe_table(3000))
    rel = tctx.sql("SELECT tag, i FROM t")
    first, again = list(rel.batches()), list(rel.batches())
    assert len(first) == 2 and all(a is b for a, b in zip(first, again))
    assert not rel.core.needs_kernel


# -- deeper chains, as plans (the SQL front end makes at most two nodes) --


def _gt(col, value, dt):
    from datafusion_tpu.plan.expr import BinaryExpr, Column, Literal, Operator, ScalarValue

    return BinaryExpr(Column(col), Operator.Gt, Literal(ScalarValue.of(dt, value)))


def _plan_from_jax(table, schema, wrap):
    """`wrap(TableScan)` planned in the JAX package, as JSON."""
    from datafusion_tpu.plan.logical import TableScan

    return tdf.LogicalPlan.from_json_str(
        wrap(TableScan("default", table, schema, None)).to_json_str())


def _deep_chain(p):
    """Projection(Selection(Projection(Selection(p)))) over the probe
    table: i > -20, then (f * 2, i + 1, tag, u), then col0 > 0.1, then
    (col1 * 3, col2, col0 + col3)."""
    from datafusion_tpu.plan.expr import BinaryExpr, Column, Literal, Operator, ScalarValue

    sel1 = jdf.Selection(_gt(0, -20, T.INT64), p)
    e1 = [BinaryExpr(Column(2), Operator.Multiply, Literal(ScalarValue.of(T.FLOAT64, 2.0))),
          BinaryExpr(Column(0), Operator.Plus, Literal(ScalarValue.of(T.INT64, 1))),
          Column(3), Column(1)]
    s1 = jdf.Schema([jdf.Field("f2", T.FLOAT64, True), jdf.Field("i1", T.INT64, False),
                     jdf.Field("tag", T.UTF8, False), jdf.Field("u", T.UINT32, False)])
    proj1 = jdf.Projection(e1, sel1, s1)
    sel2 = jdf.Selection(_gt(0, 0.1, T.FLOAT64), proj1)
    e2 = [BinaryExpr(Column(1), Operator.Multiply, Literal(ScalarValue.of(T.INT64, 3))),
          Column(2),
          BinaryExpr(Column(0), Operator.Plus,
                     jdf.Cast(Column(3), T.FLOAT64))]
    s2 = jdf.Schema([jdf.Field("i3", T.INT64, False), jdf.Field("tag", T.UTF8, False),
                     jdf.Field("fu", T.FLOAT64, True)])
    return jdf.Projection(e2, sel2, s2)


def _agg_over_chain(p):
    from datafusion_tpu.plan.expr import AggregateFunction, Column

    chain = _deep_chain(p)
    aggs = [AggregateFunction("SUM", [Column(0)], T.INT64),
            AggregateFunction("MAX", [Column(2)], T.FLOAT64)]
    schema = jdf.Schema([jdf.Field("tag", T.UTF8, False), jdf.Field("s", T.INT64, True),
                         jdf.Field("m", T.FLOAT64, True)])
    return jdf.Aggregate(chain, [Column(1)], aggs, schema)


def _sort_over_chain(p):
    from datafusion_tpu.plan.expr import Column, SortExpr

    chain = jdf.Projection([Column(3), Column(0)], jdf.Selection(_gt(0, 10, T.INT64), p),
                           jdf.Schema([jdf.Field("tag", T.UTF8, False),
                                       jdf.Field("i", T.INT64, False)]))
    return jdf.Limit(9, jdf.Sort([SortExpr(Column(1), False)], chain, chain.schema),
                     chain.schema)


CHAINS = {"deep": _deep_chain, "aggregate_over_chain": _agg_over_chain,
          "topk_over_chain": _sort_over_chain,
          "filter_only": lambda p: jdf.Selection(_gt(0, 30, T.INT64), p)}


@pytest.mark.parametrize("fuse", ["1", "0"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_plan_chains_match_with_fusion_on_and_off(monkeypatch, chain, fuse):
    """The same rows with DATAFUSION_TPU_FUSE=0 (node by node) and =1
    (the chain collapsed), in both packages."""
    src = probe_table()
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    jctx, tctx = contexts(src)
    from datafusion_tpu.plan.logical import TableScan

    jplan = CHAINS[chain](TableScan("default", "t", src.schema, None))
    want = jax_collect(jctx.execute(jplan))
    got = tdf.collect(tctx.execute(tdf.LogicalPlan.from_json_str(jplan.to_json_str())))
    assert_same(got, want, ordered=chain == "topk_over_chain")


def test_fused_chain_is_one_operator(monkeypatch):
    from datafusion_tpu.plan.logical import TableScan

    src = probe_table(100)
    _, tctx = contexts(src)
    plan = tdf.LogicalPlan.from_json_str(
        _deep_chain(TableScan("default", "t", src.schema, None)).to_json_str())
    rel = tctx.execute(plan)
    assert isinstance(rel, PipelineRelation) and not isinstance(rel.child, PipelineRelation)
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", "0")
    rel = tctx.execute(plan)
    assert isinstance(rel, PipelineRelation) and isinstance(rel.child, PipelineRelation)


# -- host functions --

def _label(x):
    return np.asarray([f"v{int(v)}" for v in x], dtype=object)


def _twice(x):
    return np.asarray(x, np.float64) * 2


def _half(x):
    return np.asarray(x, np.float64) / 2


def _with_udfs(src):
    jctx, tctx = contexts(src)
    for ctx, pkg in ((jctx, jdf), (tctx, tdf)):
        D = pkg.DataType
        ctx.register_udf("label", [D.INT64], D.UTF8, host_fn=_label)
        ctx.register_udf("twice", [D.INT64], D.FLOAT64, host_fn=_twice)
        ctx.register_udf("half", [D.FLOAT64], D.FLOAT64, host_fn=_half)
    return jctx, tctx


@pytest.mark.parametrize("sql", [
    "SELECT i, label(i) FROM t WHERE i > 45",
    "SELECT tag, label(i), f, twice(i) FROM t WHERE f > 1.5",
    "SELECT label(i + 1), sqrt(u) FROM t WHERE u > 30",
    # a tensor function inside a host function runs on the host too
    "SELECT half(sqrt(u)), half(f) FROM t WHERE i < -40",
])
def test_host_fn_projection_matches(sql):
    jctx, tctx = _with_udfs(probe_table())
    assert_same(tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql)))


@pytest.mark.parametrize("sql", ["SELECT i FROM t WHERE twice(i) > 3",
                                 "SELECT i FROM t WHERE label(i) = 'v5'"])
def test_host_fn_in_where_raises_as_jax_package(sql):
    jctx, tctx = _with_udfs(probe_table(100))
    with pytest.raises(jdf.NotSupportedError):
        jax_collect(jctx.sql(sql))
    with pytest.raises(tdf.NotSupportedError):
        tdf.collect(tctx.sql(sql))


def test_registering_a_udf_needs_an_implementation():
    with pytest.raises(tdf.ExecutionError):
        tdf.ExecutionContext(device="cpu").register_udf(
            "nothing", [tdf.DataType.INT64], tdf.DataType.INT64)
