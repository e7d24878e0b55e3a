"""PyTorch/CUDA port, slice 7: GROUP BY above `agg_max_groups()` through
the sort-merge route, against the JAX package.

The same SQL on the same numpy-seeded tables runs through
`datafusion_tpu` and `datafusion_tpu_torch`, both with `device="cpu"`;
each table is built once in the JAX package and carried into the port.
On the CPU the JAX package takes its own sort-merge route above 64
groups.  The port's route is forced at small sizes with
DATAFUSION_TPU_PALLAS_AGG_GROUPS ("0": every capacity, "64": as the
JAX package on the CPU), and every engine case checks that the route
ran and sorted through `sort_kernel.argsort_i64` (the plain version on
a CPU tensor; the radix kernel on a CUDA one).

Ints, counts, MIN/MAX, strings, NULLs and the set of output groups
match exactly; float sums within rtol 1e-9 (the port's scan combines
in another tree than XLA's), the engine tolerance of
tests/test_kernels.py.  `_seg_scan` is held against
`jax.lax.associative_scan` (through the JAX core's own `_seg_scan`):
ints and MIN/MAX exactly, f64 sums of positive values within rtol
1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from datafusion_tpu.exec.aggregate import _AggregateCore as JaxCore

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import aggregate as port_aggregate
from datafusion_tpu_torch.exec.aggregate import _AggregateCore
from datafusion_tpu_torch.exec.cuda import sort_kernel

from test_torch_join import _run_both as run_joins
from test_torch_join import tpch  # noqa: F401  (the SF 0.01 star schema fixture)
from test_torch_pipeline import (
    T, assert_same, carry, contexts, jax_collect, jax_table, run_both,
)

CONFIG2 = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t GROUP BY k"
ROUTE_ENV = "DATAFUSION_TPU_PALLAS_AGG_GROUPS"


# ------------------------------------------------------------ helpers


class Routes:
    """Counts of each update route, and the state's length and the sort
    keys of each sort-merge update."""

    def __init__(self):
        self.kernel = 0
        self.sortmerge = []
        self.sort_keys = []


@pytest.fixture
def routes(monkeypatch):
    seen = Routes()
    kernel_update = _AggregateCore._kernel_update
    sortmerge_update = _AggregateCore._sortmerge_update
    argsort = sort_kernel.argsort_i64

    def on_kernel(self, *a, **kw):
        seen.kernel += 1
        return kernel_update(self, *a, **kw)

    def on_sortmerge(self, env, capacity, mask, ids, counts, *a):
        seen.sortmerge.append(counts.shape[0])
        return sortmerge_update(self, env, capacity, mask, ids, counts, *a)

    def on_argsort(keys):
        seen.sort_keys.append(keys.clone())
        return argsort(keys)

    monkeypatch.setattr(_AggregateCore, "_kernel_update", on_kernel)
    monkeypatch.setattr(_AggregateCore, "_sortmerge_update", on_sortmerge)
    monkeypatch.setattr(sort_kernel, "argsort_i64", on_argsort)
    return seen


def assert_sortmerge_ran(routes, kernel_too=False):
    """The sort-merge route ran, one argsort per update, on the keys
    arange(G) and then the batch group's ids, a dead row keyed as G."""
    assert routes.sortmerge
    assert len(routes.sort_keys) == len(routes.sortmerge)
    assert (routes.kernel > 0) == kernel_too
    for g, keys in zip(routes.sortmerge, routes.sort_keys):
        assert keys.dtype == torch.int64
        assert torch.equal(keys[:g], torch.arange(g))
        if keys.numel() > g:
            assert 0 <= int(keys[g:].min()) and int(keys[g:].max()) <= g


def groupby_table(n, groups, seed=3, batch_rows=8192):
    """Config 2's table (benchmarks/data.py groupby_batches)."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, groups, n).astype(np.int64), rng.uniform(0.0, 1000.0, n),
            rng.uniform(-1.0, 1.0, n), rng.integers(-(10**9), 10**9, n).astype(np.int64)]
    return jax_table([("k", T.INT64, False), ("v1", T.FLOAT64, False),
                      ("v2", T.FLOAT64, False), ("v3", T.INT64, False)],
                     cols, batch_rows=batch_rows)


# ------------------------------------------------------------ _seg_scan


def _scan_inputs(shape, dtype, op, n=777, seed=0):
    rng = np.random.default_rng(seed)
    if shape == "one row":
        n = 1
    if dtype == "float64":
        lo = 0.0 if op == "add" else -1e3  # positive sums: rtol bounds the order
        vals = rng.uniform(lo, 1e3, n)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    start = {
        "random": rng.random(n) < 0.15,
        "one row": np.ones(n, bool),
        "one segment": np.eye(1, n, dtype=bool)[0],
        "every row a head": np.ones(n, bool),
        "no head": np.zeros(n, bool),
    }[shape]
    return vals.astype(dtype), start


SCAN_SHAPES = ["random", "one row", "one segment", "every row a head", "no head"]
JAX_OPS = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}
jax_seg_scan = jax.jit(JaxCore._seg_scan, static_argnums=2)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["int64", "float64", "int32"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_seg_scan_matches_associative_scan(op, dtype, shape):
    vals, start = _scan_inputs(shape, dtype, op)
    want = np.asarray(jax_seg_scan(jnp.asarray(vals), jnp.asarray(start), JAX_OPS[op]))
    got = _AggregateCore._seg_scan(torch.from_numpy(vals), torch.from_numpy(start), op)
    assert got.dtype == torch.from_numpy(vals).dtype
    if dtype == "float64" and op == "add":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def _longest_segment(start):
    heads = np.flatnonzero(np.concatenate([[True], start[1:]]))
    return int(np.diff(np.append(heads, len(start))).max())


@pytest.mark.parametrize("dtype", ["int64", "float64", "int32"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_seg_scan_stops_at_the_longest_segment_with_the_same_bits(op, dtype):
    vals, start = _scan_inputs("random", dtype, op, n=5000, seed=1)
    start[0] = True
    v, s = torch.from_numpy(vals), torch.from_numpy(start)
    full = _AggregateCore._seg_scan(v, s, op)
    short = _AggregateCore._seg_scan(v, s, op, span=_longest_segment(start))
    assert _longest_segment(start) < 100  # the doubling stops after a few steps
    assert torch.equal(full.view(torch.int64) if dtype == "float64" else full,
                       short.view(torch.int64) if dtype == "float64" else short)


def test_seg_scan_of_columns_equals_each_column_alone():
    rng = np.random.default_rng(2)
    start = torch.from_numpy(rng.random(3000) < 0.1)
    cols = torch.from_numpy(rng.uniform(0, 1e3, (3000, 3)))
    both = _AggregateCore._seg_scan(cols, start, "add")
    for j in range(3):
        alone = _AggregateCore._seg_scan(cols[:, j].contiguous(), start, "add")
        assert torch.equal(both[:, j].contiguous().view(torch.int64), alone.view(torch.int64))


# ------------------------------------------------------------ engine parity


@pytest.mark.parametrize("threshold", ["0", "64"])
def test_config2_select_list_at_20000_groups(routes, monkeypatch, threshold):
    monkeypatch.setenv(ROUTE_ENV, threshold)
    want, got = run_both(groupby_table(60_000, 20_000, batch_rows=16384), CONFIG2)
    assert got.num_rows == want.num_rows > 18_000
    assert_same(got, want, ordered=False)
    assert_sortmerge_ran(routes)


@pytest.mark.parametrize("threshold", ["0", "64"])
def test_null_arguments_and_null_keys(routes, monkeypatch, threshold):
    monkeypatch.setenv(ROUTE_ENV, threshold)
    rng = np.random.default_rng(4)
    n = 6000
    cols = [rng.integers(0, 700, n), rng.uniform(-50, 50, n).round(2),
            rng.integers(-1000, 1000, n)]
    validity = [rng.random(n) > 0.05, rng.random(n) > 0.3, rng.random(n) > 0.5]
    # a group whose every argument is NULL: SUM, MIN, MAX NULL, COUNT 0
    validity[1][cols[0] == 5] = False
    validity[2][cols[0] == 5] = False
    src = jax_table([("k", T.INT64, True), ("v", T.FLOAT64, True), ("i", T.INT64, True)],
                    cols, validity, batch_rows=1024)
    sql = ("SELECT k, SUM(v), AVG(v), MIN(v), MAX(i), SUM(i), COUNT(v), COUNT(i), "
           "COUNT(1) FROM t GROUP BY k")
    want, got = run_both(src, sql)
    rows = assert_same(got, want, ordered=False)
    assert any(r[0] is None for r in rows)
    assert any(r[0] == 5 and r[1] is None and r[6] == 0 for r in rows)
    assert_sortmerge_ran(routes)


def test_string_min_max_over_a_dictionary_that_grows(routes, monkeypatch):
    # later batches bring new strings that sort before and after the
    # earlier ones, so a group's best code must be re-ranked each batch
    monkeypatch.setenv(ROUTE_ENV, "64")
    rng = np.random.default_rng(8)
    n = 8000
    k = rng.integers(0, 900, n)
    words = np.array([f"w{i:05d}" for i in rng.permutation(4000)], dtype=object)
    # batch b draws from the first 500 * (b + 1) words of the pool
    s = np.array([words[rng.integers(0, 500 * (i // 1024 + 1))] for i in range(n)],
                 dtype=object)
    valid = rng.random(n) > 0.1
    src = jax_table([("k", T.INT64, False), ("s", T.UTF8, True), ("tag", T.UTF8, False)],
                    [k, s, np.array([f"t{x % 300}" for x in k], dtype=object)],
                    [None, valid, None], batch_rows=1024)
    want, got = run_both(src, "SELECT k, MIN(s), MAX(s), COUNT(s) FROM t GROUP BY k")
    assert_same(got, want, ordered=False)
    # a Utf8 group key as well
    want, got = run_both(src, "SELECT tag, MIN(s), MAX(s), COUNT(1) FROM t GROUP BY tag")
    assert_same(got, want, ordered=False)
    assert_sortmerge_ran(routes)


def test_uint64_min_max_across_2_63_and_sums_that_wrap(routes, monkeypatch):
    monkeypatch.setenv(ROUTE_ENV, "64")
    rng = np.random.default_rng(9)
    n = 6000
    k = rng.integers(0, 400, n)
    d = (np.uint64(1 << 63) + rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
         .astype(np.uint64))
    big = rng.integers(np.iinfo(np.int64).max - (1 << 20), np.iinfo(np.int64).max, n)
    src = jax_table([("k", T.INT64, False), ("d", T.UINT64, False), ("i", T.INT64, False),
                     ("u", T.UINT32, False)],
                    [k, d, big, rng.integers(0, 1 << 32, n).astype(np.uint32)],
                    batch_rows=2048)
    sql = ("SELECT k, MIN(d), MAX(d), SUM(d), SUM(i), MIN(i), MIN(u), MAX(u), SUM(u) "
           "FROM t GROUP BY k")
    want, got = run_both(src, sql)
    rows = assert_same(got, want, ordered=False)
    assert any(r[1] < (1 << 63) < r[2] for r in rows)  # straddles 2^63
    assert any(r[4] < 0 for r in rows)  # the int64 sum wrapped
    assert_sortmerge_ran(routes)


def test_where_that_filters_whole_groups_out(routes, monkeypatch):
    monkeypatch.setenv(ROUTE_ENV, "64")
    src = groupby_table(20_000, 3000, seed=5, batch_rows=4096)
    sql = ("SELECT k, SUM(v1), MIN(v3), COUNT(1) FROM t "
           "WHERE k >= 1000 AND v2 < 0.5 GROUP BY k")
    want, got = run_both(src, sql)
    rows = assert_same(got, want, ordered=False)
    assert min(r[0] for r in rows) >= 1000 and len(rows) > 1500
    assert_sortmerge_ran(routes)


def _ascending_keys_table():
    rng = np.random.default_rng(13)
    n = 16_384
    cols = [np.sort(rng.integers(0, 2000, n)), rng.uniform(0.0, 1000.0, n),
            rng.uniform(-1.0, 1.0, n), rng.integers(1, 10**6, n)]
    return jax_table([("k", T.INT64, False), ("v1", T.FLOAT64, False),
                      ("v2", T.FLOAT64, False), ("v3", T.INT64, False)], cols,
                     batch_rows=1024)


def test_capacity_crossing_the_threshold_mid_scan(routes, monkeypatch):
    # ascending keys, two batches a fold: the first chunks hold under
    # 256 groups (the grouped reduce), later ones more (sort-merge on
    # the same state)
    monkeypatch.setenv(ROUTE_ENV, "256")
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "2")
    want, got = run_both(_ascending_keys_table(), CONFIG2)
    rows = assert_same(got, want, ordered=False)
    assert min(r[3] for r in rows) > 0  # MIN over grown slots starts at the identity
    assert_sortmerge_ran(routes, kernel_too=True)
    assert len(routes.sortmerge) == 7  # chunks 2 to 8 (1024-row batches)


def test_default_fold_sizes_the_whole_scan_at_once(routes, monkeypatch):
    # the same scan in one chunk: its capacity (2048) is picked once the
    # chunk is encoded, so the whole scan folds into one sort-merge
    monkeypatch.setenv(ROUTE_ENV, "256")
    want, got = run_both(_ascending_keys_table(), CONFIG2)
    assert_same(got, want, ordered=False)
    assert_sortmerge_ran(routes)
    assert routes.sortmerge == [2048] and routes.sort_keys[0].numel() == 2048 + 16_384


@pytest.mark.parametrize("sql", [CONFIG2, "SELECT SUM(v1), MIN(v3), COUNT(1) FROM t"])
def test_empty_table(routes, monkeypatch, sql):
    monkeypatch.setenv(ROUTE_ENV, "0")
    src = jax_table([("k", T.INT64, False), ("v1", T.FLOAT64, False),
                     ("v2", T.FLOAT64, False), ("v3", T.INT64, False)],
                    [np.zeros(0, np.int64), np.zeros(0), np.zeros(0), np.zeros(0, np.int64)])
    want, got = run_both(src, sql)
    assert_same(got, want, ordered=False)
    assert routes.kernel == 0


def test_global_aggregate_through_sort_merge(routes, monkeypatch):
    monkeypatch.setenv(ROUTE_ENV, "0")
    want, got = run_both(groupby_table(10_000, 50, batch_rows=2048),
                         "SELECT SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t")
    assert_same(got, want)
    assert_sortmerge_ran(routes)


def test_f64_sums_are_bit_identical_over_two_runs(routes, monkeypatch):
    monkeypatch.setenv(ROUTE_ENV, "64")
    jctx, tctx = contexts(groupby_table(30_000, 5000, seed=11, batch_rows=4096))
    first = tdf.collect(tctx.sql(CONFIG2))
    second = tdf.collect(tctx.sql(CONFIG2))
    for i in (1, 2):
        assert np.array_equal(np.asarray(first.columns[i]).view(np.int64),
                              np.asarray(second.columns[i]).view(np.int64))
    assert_same(first, jax_collect(jctx.sql(CONFIG2)), ordered=False)
    assert_sortmerge_ran(routes)


def test_sort_merge_matches_the_grouped_reduce_route(monkeypatch):
    # the port's two routes over one table: ints exactly, floats rtol 1e-9
    src = groupby_table(40_000, 6000, seed=21, batch_rows=8192)
    sql = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), MIN(v1), COUNT(1) FROM t GROUP BY k"
    out = {}
    for threshold in ("0", "8192"):
        monkeypatch.setenv(ROUTE_ENV, threshold)
        ctx = tdf.ExecutionContext(device="cpu")
        ctx.register_datasource("t", carry(src))
        out[threshold] = tdf.collect(ctx.sql(sql))
    assert_same(out["0"], out["8192"], ordered=False)


# ------------------------------------------------------------ TPC-H Q3 and Q10

Q3 = ("SELECT o_orderkey, o_shippriority, "
      "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
      "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
      "JOIN customer ON orders.o_custkey = customer.c_custkey "
      "WHERE c_mktsegment = 1 "
      "GROUP BY o_orderkey, o_shippriority")
Q10 = ("SELECT c_custkey, n_name, "
       "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
       "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
       "JOIN customer ON orders.o_custkey = customer.c_custkey "
       "JOIN nation ON customer.c_nationkey = nation.n_nationkey "
       "WHERE o_orderdate <= '1995-06-30' "
       "GROUP BY c_custkey, n_name")


# SF 0.01.  Q3's WHERE runs in the aggregate, after the joins, so it
# encodes every order that has lines (14,717 groups).  At the default
# threshold and fold its scan is one chunk, sized once it is encoded:
# sort-merge only; a fold of one batch crosses 8192 groups after the
# first batch and switches route.  Q10's 1,501 groups stay on the
# grouped reduce there.
@pytest.mark.parametrize("sql,threshold,fuse_group,kernel,sortmerge,min_groups", [
    (Q3, "64", None, False, True, 2000), (Q3, None, None, False, True, 2000),
    (Q3, None, "1", True, True, 2000),
    (Q10, "64", None, False, True, 1000), (Q10, None, None, True, False, 1000),
], ids=["q3-64", "q3-default", "q3-default-fold1", "q10-64", "q10-default"])
def test_tpch_q3_q10(tpch, routes, monkeypatch, sql, threshold,  # noqa: F811
                     fuse_group, kernel, sortmerge, min_groups):
    # the shapes of benchmarks/suite.py config_joins over the TPC-H-lite
    # star schema of benchmarks/data.py
    if threshold is not None:
        monkeypatch.setenv(ROUTE_ENV, threshold)
    if fuse_group is not None:
        monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", fuse_group)
    want, got, _ = run_joins(tpch, sql)
    assert got.num_rows > min_groups
    assert_same(got, want, ordered=False)
    assert (routes.kernel > 0) == kernel and bool(routes.sortmerge) == sortmerge
    if sortmerge:
        assert_sortmerge_ran(routes, kernel_too=kernel)
        if fuse_group is None:
            assert len(routes.sortmerge) == 1  # the whole scan, one sort


def test_high_cardinality_group_by_no_longer_raises(monkeypatch):
    monkeypatch.setenv(ROUTE_ENV, "64")
    ctx = tdf.ExecutionContext(device="cpu")
    ctx.register_datasource("t", carry(groupby_table(3000, 2000)))
    rel = ctx.sql(CONFIG2)
    assert isinstance(rel, port_aggregate.AggregateRelation)
    assert tdf.collect(rel).num_rows > 1000
