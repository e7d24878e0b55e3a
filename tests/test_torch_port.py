"""PyTorch/CUDA port, slice 1: the same SQL through both packages.

Each table is built once in the JAX package with `make_host_batch`,
carried into the port by `datafusion_tpu_torch.convert`, and queried
through `ExecutionContext(device="cpu")` on both sides.  Keys, counts
and ints match exactly; floats within rtol 1e-9, as
tests/test_kernels.py holds the engine (the two packages sum in other
orders).  Also here: plan parity on golden-corpus queries, the port's
isolation from jax, and the rule that it never falls back to the CPU
on its own.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.exec.materialize import collect as jax_collect

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import convert
from datafusion_tpu_torch.exec.cuda import hash_agg

REPO = Path(__file__).resolve().parents[1]

Q1 = (
    "SELECT l_returnflag, l_linestatus, "
    "SUM(l_quantity), SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(1) "
    "FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus"
)
CONFIG2 = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t GROUP BY k"


# ------------------------------------------------------------ helpers


def _jax_source(schema, columns, validity=None, batch_rows=2048):
    """A JAX-package MemoryDataSource; Utf8 columns come as Python
    strings and are dictionary-encoded batch by batch, so the shared
    dictionary grows across batches as a scan grows it."""
    n = len(columns[0])
    dicts = [
        JaxDictionary() if f.data_type == jdf.DataType.UTF8 else None
        for f in schema.fields
    ]
    batches = []
    for lo in range(0, n, batch_rows):
        sl = slice(lo, lo + batch_rows)
        cols = [
            d.encode(list(c[sl])) if d is not None else np.asarray(c[sl])
            for c, d in zip(columns, dicts)
        ]
        valids = [None if v is None else np.asarray(v[sl])
                  for v in (validity or [None] * len(columns))]
        batches.append(jax_make_host_batch(schema, cols, valids, dicts))
    return JaxMemorySource(schema, batches)


def _carry(jax_src):
    return convert.memory_source(
        jax_src.schema.to_json(),
        [convert.export_batch(b) for b in jax_src.batches()],
    )


def _run_both(name, jax_src, sql):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_datasource(name, jax_src)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_datasource(name, _carry(jax_src))
    return jax_collect(jctx.sql(sql)), tdf.collect(tctx.sql(sql))


def _sort_key(row):
    return tuple((v is None, 0 if v is None else v) for v in row)


def _assert_rows_match(got, want):
    assert [f.name for f in got.schema.fields] == [f.name for f in want.schema.fields]
    got_rows = sorted(got.to_rows(), key=_sort_key)
    want_rows = sorted(want.to_rows(), key=_sort_key)
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        assert len(g) == len(w)
        for gv, wv in zip(g, w):
            if isinstance(wv, float) and gv is not None:
                assert isinstance(gv, float)
                assert (math.isnan(gv) and math.isnan(wv)) or math.isclose(
                    gv, wv, rel_tol=1e-9, abs_tol=0.0
                ), (g, w)
            else:
                assert gv == wv and type(gv) is type(wv), (g, w)


def _lineitem(n, seed=42):
    """Q1's lineitem columns with the distributions of the repo's
    benchmark generator (benchmarks/data.py)."""
    rng = np.random.default_rng(seed)
    n_dates = 2526
    dates = np.array([
        str(np.datetime64("1992-01-02") + np.timedelta64(i, "D"))
        for i in range(n_dates)
    ])
    ship = rng.integers(0, n_dates, n)
    old = ship < (n_dates // 2)
    flag = np.where(old, rng.integers(0, 2, n) * 2, 1)
    status = (ship >= (n_dates * 5 // 8)).astype(np.int64)
    schema = jdf.Schema([
        jdf.Field("l_returnflag", jdf.DataType.UTF8, False),
        jdf.Field("l_linestatus", jdf.DataType.UTF8, False),
        jdf.Field("l_quantity", jdf.DataType.FLOAT64, False),
        jdf.Field("l_extendedprice", jdf.DataType.FLOAT64, False),
        jdf.Field("l_discount", jdf.DataType.FLOAT64, False),
        jdf.Field("l_tax", jdf.DataType.FLOAT64, False),
        jdf.Field("l_shipdate", jdf.DataType.UTF8, False),
    ])
    cols = [
        np.array(["A", "N", "R"])[flag],
        np.array(["F", "O"])[status],
        np.floor(rng.uniform(1, 51, n)),
        np.round(rng.uniform(900.0, 104950.0, n), 2),
        rng.integers(0, 11, n) / 100.0,
        rng.integers(0, 9, n) / 100.0,
        dates[ship],
    ]
    return schema, cols


def _groupby(n, groups, seed=3):
    """Config 2's table (benchmarks/data.py groupby_batches)."""
    rng = np.random.default_rng(seed)
    schema = jdf.Schema([
        jdf.Field("k", jdf.DataType.INT64, False),
        jdf.Field("v1", jdf.DataType.FLOAT64, False),
        jdf.Field("v2", jdf.DataType.FLOAT64, False),
        jdf.Field("v3", jdf.DataType.INT64, False),
    ])
    cols = [
        rng.integers(0, groups, n).astype(np.int64),
        rng.uniform(0.0, 1000.0, n),
        rng.uniform(-1.0, 1.0, n),
        rng.integers(-(10**9), 10**9, n).astype(np.int64),
    ]
    return schema, cols


# ------------------------------------------------------- slice parity


def test_q1_matches_jax_package():
    schema, cols = _lineitem(20_000)
    want, got = _run_both("lineitem", _jax_source(schema, cols, batch_rows=4096), Q1)
    assert got.num_rows == 4  # A/F, N/F, N/O, R/F: the generator's groups
    _assert_rows_match(got, want)


@pytest.mark.parametrize("groups", [16, 300])
def test_config2_groupby_matches_jax_package(groups):
    schema, cols = _groupby(6000, groups)
    want, got = _run_both("t", _jax_source(schema, cols), CONFIG2)
    assert got.num_rows == groups
    _assert_rows_match(got, want)


def test_config2_matches_jax_pallas_kernel(monkeypatch):
    # the JAX side's 300-group aggregate goes through its Pallas
    # hash-agg kernel in the interpreter
    monkeypatch.setenv("DATAFUSION_TPU_PALLAS", "interpret")
    schema, cols = _groupby(4000, 300, seed=17)
    want, got = _run_both("t", _jax_source(schema, cols), CONFIG2)
    _assert_rows_match(got, want)


def test_string_min_max_matches_jax_package():
    rng = np.random.default_rng(5)
    n = 5000
    pool = np.array([f"name_{i:03d}" for i in rng.permutation(200)])
    schema = jdf.Schema([
        jdf.Field("k", jdf.DataType.INT32, False),
        jdf.Field("s", jdf.DataType.UTF8, True),
    ])
    s = pool[rng.integers(0, 200, n)]
    valid = rng.random(n) > 0.1
    cols = [rng.integers(0, 40, n).astype(np.int32), s]
    # group 39 only ever sees NULL strings: its MIN/MAX are NULL
    valid[cols[0] == 39] = False
    sql = "SELECT k, MIN(s), MAX(s), COUNT(s) FROM t GROUP BY k"
    want, got = _run_both("t", _jax_source(schema, cols, [None, valid]), sql)
    _assert_rows_match(got, want)
    row = [r for r in got.to_rows() if r[0] == 39][0]
    assert row[1] is None and row[2] is None and row[3] == 0


def test_nulls_three_valued_logic_and_filters_match():
    # Float32 columns only feed MIN/MAX and the predicate: an f32 SUM
    # accumulates in f32, where the two packages' summation orders
    # differ far beyond rtol 1e-9
    rng = np.random.default_rng(9)
    n = 5000
    schema = jdf.Schema([
        jdf.Field("k", jdf.DataType.UTF8, True),
        jdf.Field("a", jdf.DataType.INT32, True),
        jdf.Field("b", jdf.DataType.FLOAT64, True),
        jdf.Field("c", jdf.DataType.BOOLEAN, True),
        jdf.Field("f", jdf.DataType.FLOAT32, True),
    ])
    cols = [
        np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
        rng.integers(-50, 50, n).astype(np.int32),
        rng.normal(size=n) + 3.0,
        rng.random(n) > 0.5,
        rng.normal(size=n).astype(np.float32),
    ]
    validity = [rng.random(n) > 0.05 for _ in range(5)]
    sql = (
        "SELECT k, SUM(a), AVG(b), MIN(f), MAX(f), MAX(a), COUNT(a), "
        "COUNT(1), SUM(a * 2.5), SUM(b + a) FROM t "
        "WHERE (a > 0 OR c) AND (f < 1.5 OR a IS NULL) AND k != 'z' "
        "GROUP BY k"
    )
    want, got = _run_both("t", _jax_source(schema, cols, validity), sql)
    _assert_rows_match(got, want)


def test_nullable_float_and_bool_keys_match():
    # NULL keys form their own group; -0.0 and 0.0 are one key
    rng = np.random.default_rng(23)
    n = 4000
    schema = jdf.Schema([
        jdf.Field("s", jdf.DataType.UTF8, True),
        jdf.Field("f", jdf.DataType.FLOAT64, True),
        jdf.Field("b", jdf.DataType.BOOLEAN, False),
        jdf.Field("v", jdf.DataType.INT64, False),
    ])
    f = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25]), n)
    cols = [
        np.array(["p", "q", "r"])[rng.integers(0, 3, n)],
        f,
        rng.random(n) > 0.5,
        rng.integers(-100, 100, n).astype(np.int64),
    ]
    validity = [rng.random(n) > 0.2, rng.random(n) > 0.2, None, None]
    sql = "SELECT s, f, b, SUM(v), MIN(v), COUNT(1) FROM t GROUP BY s, f, b"
    want, got = _run_both("t", _jax_source(schema, cols, validity), sql)
    _assert_rows_match(got, want)
    assert got.num_rows == 4 * 4 * 2  # (3 strings + NULL) x (3 floats + NULL) x 2


@pytest.mark.parametrize("sql", [
    "SELECT k, SUM(v1), MIN(v3) FROM t WHERE v1 > 5000 GROUP BY k",
    "SELECT SUM(v1), AVG(v2), MIN(v3), COUNT(1) FROM t WHERE v1 > 5000",
])
def test_nothing_passes_the_filter(sql):
    schema, cols = _groupby(2000, 8)
    want, got = _run_both("t", _jax_source(schema, cols), sql)
    _assert_rows_match(got, want)


def test_integer_division_and_remainder_match():
    # truncating division and dividend-signed remainder, with the XLA
    # answers where C has none: x / 0 == -1, x % 0 == x
    rng = np.random.default_rng(11)
    n = 3000
    schema = jdf.Schema([
        jdf.Field("k", jdf.DataType.INT64, False),
        jdf.Field("a", jdf.DataType.INT64, False),
        jdf.Field("b", jdf.DataType.INT64, False),
    ])
    cols = [
        rng.integers(0, 5, n).astype(np.int64),
        rng.integers(-1000, 1000, n).astype(np.int64),
        rng.integers(-4, 5, n).astype(np.int64),
    ]
    sql = ("SELECT k, SUM(a / b), SUM(a % b), MIN(a / b), MAX(a % b) "
           "FROM t WHERE b <= 0 GROUP BY k")
    want, got = _run_both("t", _jax_source(schema, cols), sql)
    _assert_rows_match(got, want)


def test_global_aggregate_and_literal_params_match():
    schema, cols = _groupby(3000, 10)
    for sql in (
        "SELECT SUM(v1), MIN(v3), COUNT(1) FROM t WHERE v2 > 0.25",
        "SELECT SUM(v1), MIN(v3), COUNT(1) FROM t WHERE v2 > 0.75",
        "SELECT k, SUM(v1 * 0.5), MAX(v3 + 7) FROM t WHERE v2 < 2 GROUP BY k",
    ):
        want, got = _run_both("t", _jax_source(schema, cols), sql)
        _assert_rows_match(got, want)


def test_uncast_plan_takes_the_planner_types():
    # a plan built without the planner's implicit casts (plan JSON, as a
    # distributed fragment arrives): f32 column x f64 literal is f64 and
    # int32 column + int64 literal is int64 in JAX's x64 promotion; a
    # 0-dim tensor would not widen a column in torch
    rng = np.random.default_rng(21)
    n = 3000
    schema = jdf.Schema([
        jdf.Field("k", jdf.DataType.INT64, False),
        jdf.Field("f", jdf.DataType.FLOAT32, False),
        jdf.Field("i", jdf.DataType.INT32, False),
    ])
    cols = [rng.integers(0, 4, n).astype(np.int64),
            rng.normal(size=n).astype(np.float32),
            rng.integers(2**30, 2**31 - 1, n).astype(np.int32)]
    jsrc = _jax_source(schema, cols)

    def agg(arg, rtype):
        return {"AggregateFunction": {"name": "SUM", "args": [arg],
                                      "return_type": rtype}}

    plan = {"Aggregate": {
        "input": {"TableScan": {"schema_name": "default", "table_name": "t",
                                "schema": schema.to_json(), "projection": None}},
        "group_expr": [{"Column": 0}],
        "aggr_expr": [
            agg({"BinaryExpr": {"left": {"Column": 1}, "op": "Multiply",
                                "right": {"Literal": {"Float64": 0.1}}}}, "Float64"),
            agg({"BinaryExpr": {"left": {"Column": 2}, "op": "Plus",
                                "right": {"Literal": {"Int64": 2**31}}}}, "Int64"),
        ],
        "schema": {"fields": [
            {"name": "k", "data_type": "Int64", "nullable": False},
            {"name": "SUM", "data_type": "Float64", "nullable": True},
            {"name": "SUM", "data_type": "Int64", "nullable": True},
        ]},
    }}
    text = json.dumps(plan)
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_datasource("t", jsrc)
    want = jax_collect(jctx.execute(jdf.LogicalPlan.from_json_str(text)))
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_datasource("t", _carry(jsrc))
    got = tdf.collect(tctx.execute(tdf.LogicalPlan.from_json_str(text)))
    _assert_rows_match(got, want)


def test_capacity_growth_fills_new_slots_with_identity():
    # keys arrive in ascending order, so every batch adds groups and
    # the state grows from 8 to 512 slots mid-scan; MIN/MAX over the
    # grown slots must start from their identities, not zeros
    rng = np.random.default_rng(13)
    n = 8192
    k = np.sort(rng.integers(0, 300, n)).astype(np.int64)
    schema, cols = _groupby(n, 300)
    cols[0] = k
    cols[3] = rng.integers(1, 10**6, n).astype(np.int64)  # MIN > 0 everywhere
    want, got = _run_both("t", _jax_source(schema, cols, batch_rows=1024), CONFIG2)
    _assert_rows_match(got, want)
    assert min(r[3] for r in got.to_rows()) > 0


def test_too_many_groups_raise_until_sort_merge_lands(monkeypatch):
    # the sort-merge route has landed: 300 groups above a threshold of
    # 64 no longer raise, and match the JAX package on the same data
    # (tests/test_torch_sortmerge.py holds the route in detail)
    monkeypatch.setenv("DATAFUSION_TPU_PALLAS_AGG_GROUPS", "64")
    schema, cols = _groupby(2000, 300)
    want, got = _run_both("t", _jax_source(schema, cols), CONFIG2)
    assert got.num_rows == want.num_rows > 64
    _assert_rows_match(got, want)


def test_convert_keeps_codes_dictionaries_and_padding():
    schema, cols = _lineitem(5000)
    jsrc = _jax_source(schema, cols, batch_rows=1500)
    tsrc = _carry(jsrc)
    jb, tb = list(jsrc.batches()), list(tsrc.batches())
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert a.num_rows == b.num_rows and a.capacity == b.capacity
        for i in range(len(schema)):
            np.testing.assert_array_equal(np.asarray(a.data[i]), b.data[i])
            if a.dicts[i] is not None:
                assert b.dicts[i].values[: len(a.dicts[i].values)] == a.dicts[i].values
    # one dictionary per Utf8 column, shared by every batch
    assert len({id(b.dicts[6]) for b in tb}) == 1


def test_unported_plan_nodes_raise_not_supported():
    schema, cols = _groupby(100, 4)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_datasource("t", _carry(_jax_source(schema, cols)))
    # filters, projections, sorts and the TopK are ported now
    # (tests/test_torch_pipeline.py, test_torch_sort.py,
    # test_torch_topk.py), and EXPLAIN (tests/test_torch_native_frontend.py);
    # a computed ORDER BY key fails the verifier (PlanVerificationError, a
    # NotSupportedError, as in the JAX package); EXPLAIN ANALYZE is ported
    # (tests/test_torch_explain.py)
    for sql in ("SELECT k, v1 FROM t ORDER BY v1 + 1 LIMIT 5",
                "SELECT k FROM t ORDER BY k * 2"):
        with pytest.raises(tdf.NotSupportedError):
            tctx.sql(sql)
    # CREATE MATERIALIZED VIEW and `result_cache=<store>` are ported
    # (tests/test_torch_ingest.py, test_torch_cache.py) and answer as the
    # JAX package does
    from datafusion_tpu.cache.store import CacheStore as JaxCacheStore

    from datafusion_tpu_torch.cache.result import CachedResultRelation
    from datafusion_tpu_torch.cache.store import CacheStore

    view_sql = "SELECT k, SUM(v1), COUNT(1) FROM t GROUP BY k"
    jctx = jdf.ExecutionContext(device="cpu", result_cache=JaxCacheStore(1 << 20))
    jctx.register_datasource("t", _jax_source(schema, cols))
    store = CacheStore(1 << 20, name="result")
    tctx = tdf.ExecutionContext(device="cpu", result_cache=store)
    tctx.register_datasource("t", _carry(_jax_source(schema, cols)))
    ddl = f"CREATE MATERIALIZED VIEW mv AS {view_sql}"
    assert repr(tctx.sql(ddl)) == repr(jctx.sql(ddl)) == \
        "Registered materialized view mv (incremental)"
    want = sorted(jax_collect(jctx.sql(view_sql)).to_rows())
    for ctx_rows in (tctx.ingest().read_view("mv").to_rows(),
                     tdf.collect(tctx.sql(view_sql)).to_rows()):
        got = sorted(ctx_rows)
        assert [r[0] for r in got] == [r[0] for r in want]
        assert [r[2] for r in got] == [r[2] for r in want]
        assert np.allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-9, atol=0)
    assert tctx.result_cache is store and store.entries == 1
    assert isinstance(tctx.sql(view_sql), CachedResultRelation)


# -------------------------------------------------------- plan parity

_GOLDEN_SCHEMAS = {
    "all_types": [
        ("c_bool", "BOOLEAN"), ("c_uint8", "UINT8"), ("c_uint16", "UINT16"),
        ("c_uint32", "UINT32"), ("c_uint64", "UINT64"), ("c_int8", "INT8"),
        ("c_int16", "INT16"), ("c_int32", "INT32"), ("c_int64", "INT64"),
        ("c_float32", "FLOAT32"), ("c_float64", "FLOAT64"), ("c_utf8", "UTF8"),
    ],
    "uk_cities": [("city", "UTF8"), ("lat", "FLOAT64"), ("lng", "FLOAT64")],
    "numerics": [("a", "INT64"), ("b", "INT64"), ("a_f", "FLOAT32"),
                 ("b_f", "FLOAT32")],
}

# queries of tests/test_golden_corpus.py
GOLDEN_QUERIES = [
    "SELECT c_int8 FROM all_types WHERE c_int8 >= 2 AND c_int8 <= 100",
    "SELECT c_int8 FROM all_types WHERE c_int8 != c_int16",
    "SELECT city, lat, lng, lat + lng FROM uk_cities WHERE lat > 51.0 AND lat < 53",
    "SELECT c_utf8, MIN(c_int8), MAX(c_float64), SUM(c_int32), COUNT(1) "
    "FROM all_types GROUP BY c_utf8",
    "SELECT a, b, a_f * b_f FROM numerics WHERE a > b",
    "SELECT c_float32, sqrt(c_float64) FROM all_types ORDER BY c_float32 DESC LIMIT 5",
    "SELECT CAST(c_int32 AS BIGINT) FROM all_types WHERE c_int32 < 0",
    "SELECT CAST(c_uint8 AS SMALLINT), c_bool FROM all_types WHERE c_utf8 IS NOT NULL",
]


def _plan_json(pkg, sql):
    schema = pkg.Schema([
        pkg.Field(name, getattr(pkg.DataType, t), False)
        for name, t in _GOLDEN_SCHEMAS[re.search(r"FROM (\w+)", sql).group(1)]
    ])
    if pkg is jdf:
        from datafusion_tpu.exec.context import _ContextSchemaProvider
        from datafusion_tpu.sql.optimizer import push_down_projection
        from datafusion_tpu.sql.parser import parse_sql
        from datafusion_tpu.sql.planner import SqlToRel

        ctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.register_datasource(re.search(r"FROM (\w+)", sql).group(1),
                                JaxMemorySource(schema, []))
    else:
        from datafusion_tpu_torch.exec.context import _ContextSchemaProvider
        from datafusion_tpu_torch.sql.optimizer import push_down_projection
        from datafusion_tpu_torch.sql.parser import parse_sql
        from datafusion_tpu_torch.sql.planner import SqlToRel

        ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.register_datasource(re.search(r"FROM (\w+)", sql).group(1),
                                tdf.MemoryDataSource(schema, []))
    plan = SqlToRel(_ContextSchemaProvider(ctx)).sql_to_rel(parse_sql(sql))
    return push_down_projection(plan).to_json_str()


@pytest.mark.parametrize("sql", GOLDEN_QUERIES)
def test_logical_plan_json_equals_jax_package(sql):
    assert _plan_json(tdf, sql) == _plan_json(jdf, sql)


# ---------------------------------------------------------- isolation


def _port_sources():
    return sorted((REPO / "datafusion_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


@pytest.mark.parametrize("module", ["serve.py", "utils/metrics.py", "utils/deadline.py",
                                    "utils/eventloop.py", "obs/device.py", "obs/recorder.py"])
def test_serving_modules_are_the_ports_own(module):
    """The serving slice's modules are the port's own copies: scanned by
    the import check below, and none names the JAX package."""
    path = REPO / "datafusion_tpu_torch" / module
    assert path in _port_sources()
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", text,
                         re.MULTILINE)


@pytest.mark.parametrize("module", ["cli.py", "dataframe.py", "analysis/verify.py",
                                    "io/readers.py", "io/io_thread.py", "native/sqlfront.py"])
def test_front_door_modules_are_the_ports_own(module):
    """The console slice's modules are the port's own copies: scanned by
    the import check below, and none names the JAX package."""
    path = REPO / "datafusion_tpu_torch" / module
    assert path in _port_sources()
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", text,
                         re.MULTILINE)


@pytest.mark.parametrize("module", ["ingest/__init__.py", "utils/wal.py", "parallel/wire.py",
                                    "testing/faults.py", "analysis/lockcheck.py",
                                    "cache/__init__.py", "cache/store.py",
                                    "cache/fingerprint.py", "cache/result.py"])
def test_freshness_modules_are_the_ports_own(module):
    """The freshness and durability slice's modules are the port's own
    copies: scanned by the import check below, and none names the JAX
    package."""
    path = REPO / "datafusion_tpu_torch" / module
    assert path in _port_sources()
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", text,
                         re.MULTILINE)


def test_no_source_imports_jax_or_the_jax_package():
    bad = re.compile(
        r"^\s*(import|from)\s+jax\b|\bdatafusion_tpu\.|"
        r"^\s*(import|from)\s+datafusion_tpu\b(?!_torch)",
        re.MULTILINE,
    )
    for path in _port_sources():
        hits = bad.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['datafusion_tpu'] = None\n"
        "import numpy as np\n"
        "import datafusion_tpu_torch as t\n"
        "s = t.Schema([t.Field('k', t.DataType.INT64, False),"
        " t.Field('v', t.DataType.FLOAT64, False)])\n"
        "b = t.make_host_batch(s, [np.arange(10) % 3, np.arange(10.0)])\n"
        "ctx = t.ExecutionContext(device='cpu')\n"
        "ctx.register_datasource('t', t.MemoryDataSource(s, [b]))\n"
        "rows = sorted(t.collect(ctx.sql('SELECT k, SUM(v) FROM t GROUP BY k')).to_rows())\n"
        "assert rows == [(0, 18.0), (1, 12.0), (2, 15.0)], rows\n"
        # every module of the port, the CSV scan, a pipeline and a TopK
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(t.__path__, t.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "cs = t.Schema([t.Field('city', t.DataType.UTF8, False),"
        " t.Field('lat', t.DataType.FLOAT64, False), t.Field('lng', t.DataType.FLOAT64, False)])\n"
        "ctx.register_csv('c', 'test/data/uk_cities.csv', cs, has_header=False)\n"
        "rows = t.collect(ctx.sql('SELECT city, lat + lng FROM c WHERE lat > 51.0 AND lat < 53'))\n"
        "assert rows.num_rows == 18, rows.num_rows\n"
        "top = t.collect(ctx.sql('SELECT k, v FROM t ORDER BY v DESC LIMIT 2')).to_rows()\n"
        "assert top == [(0, 9.0), (2, 8.0)], top\n"
        # the staged prefetch threads (exec/prefetch.py), forced on
        "import os\n"
        "os.environ['DATAFUSION_TPU_PREFETCH'] = '1'\n"
        "rows = sorted(t.collect(ctx.sql('SELECT k, SUM(v) FROM t GROUP BY k')).to_rows())\n"
        "assert rows == [(0, 18.0), (1, 12.0), (2, 15.0)], rows\n"
        "rows = t.collect(ctx.sql('SELECT city, lat + lng FROM c WHERE lat > 51.0 AND lat < 53'))\n"
        "assert rows.num_rows == 18, rows.num_rows\n"
        "assert 'datafusion_tpu_torch.exec.prefetch' in sys.modules\n"
        # the serving front door and its utilities: a served query
        "os.environ['DATAFUSION_TPU_PREFETCH'] = '0'\n"
        "srv = ctx.serve(workers=1, window_s=0.005)\n"
        "rows = sorted(srv.submit('SELECT k, SUM(v) FROM t GROUP BY k').result(timeout=60)"
        ".to_rows())\n"
        "srv.stop()\n"
        "assert rows == [(0, 18.0), (1, 12.0), (2, 15.0)], rows\n"
        "for name in ('serve', 'utils.metrics', 'utils.deadline', 'utils.eventloop',"
        " 'obs.device', 'obs.recorder'):\n"
        "    assert 'datafusion_tpu_torch.' + name in sys.modules, name\n"
        # the console slice: DDL, EXPLAIN VERIFY, NDJSON, the DataFrame and
        # the console, with the native SQL front-end
        "from datafusion_tpu_torch.cli import Console, make_context\n"
        "import io\n"
        "out = io.StringIO()\n"
        "con = Console(make_context('cpu'), out=out)\n"
        "con.execute(\"CREATE EXTERNAL TABLE j (a BIGINT, b VARCHAR, c DOUBLE) STORED AS NDJSON "
        "LOCATION 'test/data/example1.ndjson'\")\n"
        "con.execute('SELECT b, SUM(c) FROM j GROUP BY b')\n"
        "con.execute('EXPLAIN VERIFY SELECT a FROM j')\n"
        "assert 'this is a string\\t12.34' in out.getvalue(), out.getvalue()\n"
        "assert 'plan verified: OK' in out.getvalue(), out.getvalue()\n"
        "df = ctx.table('t')\n"
        "rows = sorted(df.aggregate(['k'], [t.f.sum(df.col('v'))]).collect().to_rows())\n"
        "assert rows == [(0, 18.0), (1, 12.0), (2, 15.0)], rows\n"
        "for name in ('cli', 'dataframe', 'analysis.verify', 'io.readers', 'io.io_thread',"
        " 'native.sqlfront'):\n"
        "    assert 'datafusion_tpu_torch.' + name in sys.modules, name\n"
        # the freshness slice: an append behind the log folds into a view,
        # the log recovers it, and a repeated query replays from the cache
        "import tempfile\n"
        "wal = tempfile.mkdtemp()\n"
        "ing = ctx.ingest(wal_dir=wal)\n"
        "ing.create_view('mv', 'SELECT k, SUM(v) FROM t GROUP BY k')\n"
        "ing.append('t', {'k': np.array([0, 3]), 'v': np.array([1.0, 2.0])})\n"
        "rows = sorted(ing.read_view('mv').to_rows())\n"
        "assert rows == [(0, 19.0), (1, 12.0), (2, 15.0), (3, 2.0)], rows\n"
        "ing.close()\n"
        "rctx = t.ExecutionContext(device='cpu')\n"
        "rctx.register_datasource('t', t.MemoryDataSource(s, [b]))\n"
        "ring = rctx.ingest(wal_dir=wal)\n"
        "assert ring.recover()['appends_replayed'] == 1\n"
        "assert sorted(ring.read_view('mv').to_rows()) == rows\n"
        "ring.close()\n"
        "from datafusion_tpu_torch.cache.result import CachedResultRelation\n"
        "t.collect(rctx.sql('SELECT k, v FROM t WHERE v > 8'))\n"
        "assert isinstance(rctx.sql('SELECT k, v FROM t WHERE v > 8'), CachedResultRelation)\n"
        "for name in ('ingest', 'utils.wal', 'parallel.wire', 'testing.faults',"
        " 'analysis.lockcheck', 'cache', 'cache.store', 'cache.fingerprint', 'cache.result'):\n"
        "    assert 'datafusion_tpu_torch.' + name in sys.modules, name\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "assert not any(m == 'datafusion_tpu' or m.startswith('datafusion_tpu.')"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -------------------------------------------------- no hidden fallback


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tdf.ExecutionError):
        tdf.ExecutionContext()
    with pytest.raises(tdf.ExecutionError):
        tdf.ExecutionContext(device="cuda")


def test_cpu_context_takes_plain_route_and_launches_nothing():
    schema, cols = _groupby(3000, 16)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_datasource("t", _carry(_jax_source(schema, cols)))
    before = hash_agg.LAUNCHES
    assert tdf.collect(tctx.sql(CONFIG2)).num_rows == 16
    assert hash_agg.LAUNCHES == before
