"""PyTorch/CUDA port, slice 2: hash joins, against the JAX package.

The same SQL on the same numpy-seeded tables runs through
`datafusion_tpu` and `datafusion_tpu_torch`, both with
`device="cpu"`: each table is built once in the JAX package and
carried into the port by `datafusion_tpu_torch.convert`.  Rows and
their order match exactly where the query has an ORDER BY (joins
without one are an Aggregate, compared as sorted rows); ints, strings
and NULLs exactly, f64 within rtol 1e-9, the engine tolerance of
tests/test_kernels.py (the two packages sum in other orders).

The cases follow tests/test_join.py: INNER and LEFT, on the dense
device path and on the host path (DATAFUSION_TPU_JOIN_DENSE_SLOTS=0
sends both packages to the host index), duplicate build keys, Utf8
keys (the dense path must refuse dictionary codes), multi-key joins,
NULL keys, empty sides, a dtype matrix, join + filter + aggregate,
the port's wider dense window (a unique key over 2^20 slots joins dense
in the port and on the JAX package's host index; a duplicate takes the
host path by the build kernel's flag; a range over 2^26 slots takes it
before any build), and TPC-H Q5 and Q12 at SF 0.01 over
`benchmarks/data.tpch_join_csvs`.
Projections over a join are not ported yet (PipelineRelation), so a
join's rows are selected through a fused ORDER BY.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import CsvDataSource
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.obs.device import LEDGER

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import convert
from datafusion_tpu_torch.join.relation import HashJoinRelation

I32, I64 = jdf.DataType.INT32, jdf.DataType.INT64
F64, U8 = jdf.DataType.FLOAT64, jdf.DataType.UTF8


# ------------------------------------------------------------ helpers


def _jax_source(schema, columns, validity=None, batch_rows=256):
    """A JAX-package MemoryDataSource; Utf8 columns come as Python
    strings and are dictionary-encoded batch by batch."""
    n = len(columns[0])
    dicts = [JaxDictionary() if f.data_type == U8 else None for f in schema.fields]
    batches = []
    for lo in range(0, max(n, 1), batch_rows):
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


def _joins(rel):
    """Every HashJoinRelation in a port operator tree."""
    out = []
    stack = [rel]
    while stack:
        r = stack.pop()
        if isinstance(r, HashJoinRelation):
            out.append(r)
            stack.extend([r.left, r.right])
        elif getattr(r, "child", None) is not None:
            stack.append(r.child)
    return out


def _run_both(sources: dict, sql: str):
    """(JAX result, port result, port HashJoinRelations) of `sql`.

    The JAX package pins join builds process-wide under a fingerprint
    that, for in-memory tables, holds the table name and the context's
    catalog version but nothing of the data: another test's table of
    the same name would be probed.  The ledger is cleared first."""
    LEDGER.clear()
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    tctx = tdf.ExecutionContext(device="cpu")
    for name, src in sources.items():
        jctx.register_datasource(name, src)
        tctx.register_datasource(name, _carry(src))
    rel = tctx.sql(sql)
    got = tdf.collect(rel)
    return jax_collect(jctx.sql(sql)), got, _joins(rel)


def _sort_key(row):
    return tuple((v is None, 0 if v is None else v) for v in row)


def _assert_same(got, want, ordered=True):
    assert [f.name for f in got.schema.fields] == [f.name for f in want.schema.fields]
    g_rows, w_rows = got.to_rows(), want.to_rows()
    if not ordered:
        g_rows, w_rows = sorted(g_rows, key=_sort_key), sorted(w_rows, key=_sort_key)
    assert len(g_rows) == len(w_rows)
    for g, w in zip(g_rows, w_rows):
        for gv, wv in zip(g, w):
            if isinstance(wv, float) and gv is not None:
                assert (math.isnan(gv) and math.isnan(wv)) or math.isclose(
                    gv, wv, rel_tol=1e-9, abs_tol=0.0), (g, w)
            else:
                assert gv == wv and type(gv) is type(wv), (g, w)


@pytest.fixture
def star():
    """fact (600 rows, duplicate and dangling keys 50..59) and dim (50
    rows, unique int key, Utf8 name, repeating grp), as in
    tests/test_join.py."""
    rng = np.random.default_rng(7)
    fact = _jax_source(
        jdf.Schema([jdf.Field("k", I64, False), jdf.Field("seq", I64, False),
                    jdf.Field("x", F64, False)]),
        [rng.integers(0, 60, 600), np.arange(600), np.round(rng.uniform(0, 10, 600), 3)],
    )
    dim = _jax_source(
        jdf.Schema([jdf.Field("k", I64, False), jdf.Field("name", U8, False),
                    jdf.Field("grp", I64, False)]),
        [np.arange(50), np.array([f"name{i}" for i in range(50)], dtype=object),
         np.arange(50) % 7],
        batch_rows=32,
    )
    return {"fact": fact, "dim": dim}


@pytest.fixture(params=["dense", "host"])
def route(request, monkeypatch):
    """Both packages on the dense path, or both on the host index."""
    if request.param == "host":
        monkeypatch.setenv("DATAFUSION_TPU_JOIN_DENSE_SLOTS", "0")
    return request.param


# ------------------------------------------------------------ parity


class TestJoinParity:
    def test_inner(self, star, route):
        want, got, joins = _run_both(
            star, "SELECT seq, name FROM fact JOIN dim ON fact.k = dim.k ORDER BY seq")
        _assert_same(got, want)
        assert got.num_rows == 491
        assert [j._artifact.dense for j in joins] == [route == "dense"]

    def test_left_outer(self, star, route):
        want, got, joins = _run_both(
            star, "SELECT seq, name FROM fact LEFT JOIN dim ON fact.k = dim.k "
                  "ORDER BY seq")
        _assert_same(got, want)
        assert got.num_rows == 600
        assert any(r[1] is None for r in got.to_rows())  # dangling keys NULL-extend
        assert [j._artifact.dense for j in joins] == [route == "dense"]

    def test_join_filter_aggregate(self, star, route):
        want, got, _ = _run_both(
            star, "SELECT grp, COUNT(seq), SUM(x) FROM fact JOIN dim "
                  "ON fact.k = dim.k WHERE x > 5 GROUP BY grp")
        _assert_same(got, want, ordered=False)
        assert got.num_rows == 7

    def test_join_aggregate_sorted(self, star, route):
        want, got, _ = _run_both(
            star, "SELECT name, MIN(x), MAX(seq), AVG(x) FROM fact LEFT JOIN dim "
                  "ON fact.k = dim.k GROUP BY name ORDER BY name DESC")
        _assert_same(got, want)

    def test_payload_columns_of_both_sides(self, star, route):
        want, got, _ = _run_both(
            star, "SELECT x, grp, seq, name FROM fact JOIN dim ON fact.k = dim.k "
                  "WHERE x < 3 ORDER BY grp, x DESC, seq")
        _assert_same(got, want)

    def test_duplicate_build_keys_host_path(self, star):
        # grp repeats in dim: non-unique build keys take the host index
        want, got, joins = _run_both(
            star, "SELECT seq, name FROM fact JOIN dim ON fact.k = dim.grp "
                  "ORDER BY seq")
        _assert_same(got, want)
        assert [j._artifact.dense for j in joins] == [False]

    def test_utf8_key_is_joined_by_content(self, star):
        # each table's dictionary assigns its own codes: the dense path
        # must refuse them and the host index compare content
        labels = _jax_source(
            jdf.Schema([jdf.Field("name", U8, False), jdf.Field("score", I64, False)]),
            [np.array([f"name{i}" for i in range(58, -2, -2)], dtype=object),
             np.arange(58, -2, -2) * 11],
        )
        want, got, joins = _run_both(
            dict(star, labels=labels),
            "SELECT grp, score FROM dim JOIN labels ON dim.name = labels.name "
            "ORDER BY score")
        _assert_same(got, want)
        assert got.num_rows == 25
        assert [j._artifact.dense for j in joins] == [False]

    def test_multi_key(self, star):
        want, got, joins = _run_both(
            star, "SELECT seq, name FROM fact "
                  "JOIN dim ON fact.k = dim.k AND fact.k = dim.grp ORDER BY seq")
        _assert_same(got, want)
        assert got.num_rows > 0
        assert [j._artifact.dense for j in joins] == [False]

    def test_chained_joins(self, star, route):
        # a join over a join, probed by a key the first join gathered
        # from its build (device tensors on the dense path)
        grps = _jax_source(
            jdf.Schema([jdf.Field("g", I64, False), jdf.Field("label", U8, False)]),
            [np.arange(1, 7), np.array([f"g{i}" for i in range(1, 7)], dtype=object)],
        )
        want, got, joins = _run_both(
            dict(star, grps=grps),
            "SELECT seq, name, label FROM fact JOIN dim ON fact.k = dim.k "
            "LEFT JOIN grps ON dim.grp = grps.g WHERE x > 2 ORDER BY seq")
        _assert_same(got, want)
        assert any(r[2] is None for r in got.to_rows())
        assert [j._artifact.dense for j in joins] == [route == "dense"] * 2


class TestJoinEdges:
    @staticmethod
    def _mini(left, right, left_null=False, right_null=False, dtype=I64):
        def src(rows, null, names):
            keys = [r[0] for r in rows]
            valid = np.array([k is not None for k in keys], bool)
            kcol = np.array([0 if k is None else k for k in keys],
                            dtype=dtype.np_dtype)
            other = np.array([r[1] for r in rows], dtype=np.int64)
            return _jax_source(
                jdf.Schema([jdf.Field(names[0], dtype, null),
                            jdf.Field(names[1], I64, False)]),
                [kcol, other], [valid if null else None, None], batch_rows=64,
            )

        return {"l": src(left, left_null, ("k", "v")),
                "r": src(right, right_null, ("k", "w"))}

    def test_null_keys_match_nothing(self, route):
        srcs = self._mini([(1, 10), (None, 11), (2, 12), (None, 13)],
                          [(1, 100), (None, 101), (2, 102)],
                          left_null=True, right_null=True)
        want, got, _ = _run_both(srcs, "SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.to_rows() == [(10, 100), (12, 102)]  # NULL != NULL
        want, got, _ = _run_both(
            srcs, "SELECT v, w FROM l LEFT JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.to_rows() == [(10, 100), (11, None), (12, 102), (13, None)]

    def test_empty_build_side(self, route):
        srcs = self._mini([(1, 10), (2, 20)], [])
        want, got, _ = _run_both(srcs, "SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.num_rows == 0
        want, got, _ = _run_both(
            srcs, "SELECT v, w FROM l LEFT JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.to_rows() == [(10, None), (20, None)]

    def test_empty_probe_side(self, route):
        srcs = self._mini([], [(1, 100)])
        for sql in ("SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v",
                    "SELECT v, w FROM l LEFT JOIN r ON l.k = r.k ORDER BY v"):
            want, got, _ = _run_both(srcs, sql)
            _assert_same(got, want)
            assert got.num_rows == 0

    @pytest.mark.parametrize("dtype,vals", [
        (I32, [3, 1, 4, 1, 5]),
        (I64, [-(1 << 40), 0, 1 << 40, 0, 7]),
        (F64, [1.5, -0.0, 2.25, 0.0, 1.5]),
    ])
    def test_dtype_matrix(self, dtype, vals):
        left = [(v, i) for i, v in enumerate(vals)]
        right = [(v, i * 100) for i, v in enumerate(sorted(set(vals)))]
        srcs = self._mini(left, right, dtype=dtype)
        want, got, _ = _run_both(srcs, "SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        # -0.0 joins 0.0: equal SQL values must meet
        assert got.num_rows == len(vals)

    def test_far_out_of_range_probe_keys(self):
        # probe keys far outside the build's range must not wrap into a
        # slot when the slot offset is cast to int32
        srcs = self._mini([(5, 1), ((1 << 32) + 6, 2), (-(1 << 33) + 5, 3), (6, 4)],
                          [(5, 50), (6, 60), (7, 70)])
        want, got, joins = _run_both(
            srcs, "SELECT v, w FROM l LEFT JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.to_rows() == [(1, 50), (2, None), (3, None), (4, 60)]
        assert [j._artifact.dense for j in joins] == [True]


class TestDenseWindow:
    """The port's dense window (2^26 slots by default) and its route by
    the build kernel's duplicate flag, against the JAX package, whose
    window is 2^20 slots and whose uniqueness comes from its host
    index."""

    @staticmethod
    def _tables(build_keys, seed=0):
        rng = np.random.default_rng(seed)
        build_keys = np.asarray(build_keys, np.int64)
        m = len(build_keys)
        probe = np.concatenate([rng.choice(build_keys, 3000),
                                rng.integers(-5, build_keys.max() + 5, 1000)])
        return {
            "l": _jax_source(jdf.Schema([jdf.Field("k", I64, False),
                                         jdf.Field("v", I64, False)]),
                             [probe, np.arange(len(probe))], batch_rows=1024),
            "r": _jax_source(jdf.Schema([jdf.Field("k", I64, False),
                                         jdf.Field("w", I64, False)]),
                             [build_keys, np.arange(m) * 10], batch_rows=1024),
        }

    @staticmethod
    def _spy(monkeypatch):
        from datafusion_tpu_torch.exec.cuda import hash_build

        flags = []
        real = hash_build.build_slot_table

        def spy(pos, live, num_slots):
            row, count, dup = real(pos, live, num_slots)
            flags.append((num_slots, dup))
            return row, count, dup

        monkeypatch.setattr(hash_build, "build_slot_table", spy)
        return flags

    @pytest.mark.parametrize("join", ["JOIN", "LEFT JOIN"])
    def test_unique_key_over_2_20_slots_joins_dense(self, monkeypatch, join):
        keys = np.random.default_rng(3).choice(1_500_001, 5000, replace=False)
        keys[:2] = [0, 1_500_000]  # 1,500,001 slots, over the JAX 2^20
        flags = self._spy(monkeypatch)
        want, got, joins = _run_both(
            self._tables(keys), f"SELECT v, w FROM l {join} r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.num_rows >= 3000
        assert [j._artifact.dense for j in joins] == [True]
        assert joins[0]._artifact.index is None  # no host index was built
        assert flags == [(1_500_001, False)]

    def test_duplicate_key_in_window_takes_host_path_by_kernel_flag(self, monkeypatch):
        keys = np.arange(0, 20_000, 4)
        keys[100] = keys[2000]  # one duplicate among 5,000 unique keys
        flags = self._spy(monkeypatch)
        want, got, joins = _run_both(
            self._tables(keys), "SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v, w")
        _assert_same(got, want)
        assert [j._artifact.dense for j in joins] == [False]
        assert joins[0]._artifact.index is not None
        assert flags == [(19_997, True)]

    def test_key_range_over_2_26_takes_host_path(self, monkeypatch):
        keys = np.array([0, 17, 1 << 20, 1 << 26], np.int64)  # 2^26 + 1 slots
        flags = self._spy(monkeypatch)
        want, got, joins = _run_both(
            self._tables(keys), "SELECT v, w FROM l JOIN r ON l.k = r.k ORDER BY v")
        _assert_same(got, want)
        assert got.num_rows >= 3000
        assert [j._artifact.dense for j in joins] == [False]
        assert flags == []  # decided before any build


# ------------------------------------------------------------ TPC-H

Q5 = ("SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
      "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
      "JOIN customer ON orders.o_custkey = customer.c_custkey "
      "JOIN nation ON customer.c_nationkey = nation.n_nationkey "
      "GROUP BY n_name")
Q12 = ("SELECT l_shipmode, COUNT(1) FROM lineitem "
       "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
       "WHERE l_quantity > 25 GROUP BY l_shipmode ORDER BY l_shipmode")


@pytest.fixture(scope="module")
def tpch():
    """The TPC-H-lite star schema at SF 0.01 (benchmarks/data.py),
    read by the JAX package's CSV source in batches of 8192 rows."""
    from benchmarks.data import tpch_join_csvs

    out = {}
    for name, (path, schema) in tpch_join_csvs(0.01).items():
        batches = list(CsvDataSource(path, schema, True, 8192).batches())
        out[name] = JaxMemorySource(schema, batches)
    return out


# default: every build is dense at SF 0.01; 5000 slots: the orders
# build (15,000 slots) takes the host index while customer (1,500) and
# nation (25) stay dense, the routes Q5 takes at SF-1
@pytest.mark.parametrize("slots,dense", [(None, [True, True, True]),
                                         ("5000", [True, True, False])])
def test_tpch_q5(tpch, monkeypatch, slots, dense):
    if slots is not None:
        monkeypatch.setenv("DATAFUSION_TPU_JOIN_DENSE_SLOTS", slots)
    want, got, joins = _run_both(tpch, Q5)
    _assert_same(got, want, ordered=False)
    assert got.num_rows == 25
    assert [j._artifact.dense for j in joins] == dense


@pytest.mark.parametrize("slots", [None, "5000"])
def test_tpch_q12_order_by(tpch, monkeypatch, slots):
    if slots is not None:
        monkeypatch.setenv("DATAFUSION_TPU_JOIN_DENSE_SLOTS", slots)
    want, got, joins = _run_both(tpch, Q12)
    _assert_same(got, want)
    assert [r[0] for r in got.to_rows()] == list(range(7))
    assert [j._artifact.dense for j in joins] == [slots is None]
