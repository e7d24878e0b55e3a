"""PyTorch/CUDA port, slice 2: full ORDER BY and LIMIT, against the
JAX package.

The same SQL on the same numpy-seeded tables runs through
`datafusion_tpu` and `datafusion_tpu_torch`, both with
`device="cpu"`; each table is built once in the JAX package and carried
into the port by `datafusion_tpu_torch.convert`.  Rows and their order
match exactly: every table carries a unique `tag` column, so a tie
broken differently, or a -0.0 placed on the other side of a +0.0, shows
as a different tag.  f64 values are compared exactly too (a sort only
moves them); a NaN equals a NaN.

The cases follow tests/test_sort.py and
tests/test_kernels.py::TestSortSemantics: int, f64, Utf8 and NULL keys,
NaN of both signs, +-0.0 and +-inf, DESC, multi-key, stability under
heavy ties, a fused predicate, a bare LIMIT, a LIMIT above TOPK_MAX, a
multi-run host merge (DATAFUSION_TPU_SORT_RUN_ROWS set small), empty
results, a sort over an aggregate, and a computed ORDER BY key under
a TopK, which the port refuses with NotSupportedError (the TopK itself
is held against the JAX package in tests/test_torch_topk.py).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.exec.materialize import collect as jax_collect

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import convert
from datafusion_tpu_torch.exec.sort import TOPK_MAX, f64_sort_image

T = jdf.DataType
NEG_NAN = struct.unpack("<d", struct.pack("<Q", 0xFFF8000000000000))[0]


def _jax_source(schema, columns, validity=None, batch_rows=2048):
    """A JAX-package MemoryDataSource; Utf8 columns come as Python
    strings and are dictionary-encoded batch by batch, so the shared
    dictionary grows across batches as a scan grows it."""
    n = len(columns[0])
    dicts = [JaxDictionary() if f.data_type == T.UTF8 else None for f in schema.fields]
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


def _table(fields, columns, validity=None, batch_rows=2048):
    schema = jdf.Schema([jdf.Field(n, t, nl) for n, t, nl in fields])
    return _jax_source(schema, columns, validity, batch_rows)


def _run_both(src, sql):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_datasource("t", src)
    tctx = tdf.ExecutionContext(device="cpu")
    tctx.register_datasource("t", convert.memory_source(
        src.schema.to_json(), [convert.export_batch(b) for b in src.batches()]))
    return jax_collect(jctx.sql(sql)), tdf.collect(tctx.sql(sql))


def _same_value(g, w):
    if isinstance(w, float) and isinstance(g, float):
        return (math.isnan(g) and math.isnan(w)) or g == w
    return g == w and type(g) is type(w)


def _check(src, sql):
    """Port rows == JAX rows, in order; returns the port's rows."""
    want, got = _run_both(src, sql)
    assert [f.name for f in got.schema.fields] == [f.name for f in want.schema.fields]
    g_rows, w_rows = got.to_rows(), want.to_rows()
    assert len(g_rows) == len(w_rows)
    for g, w in zip(g_rows, w_rows):
        assert all(_same_value(gv, wv) for gv, wv in zip(g, w)), (g, w)
    return g_rows


def _mixed(n=5000, seed=47, batch_rows=2048, nulls=False):
    """Utf8, f64 (with ties), int64 and a unique tag; optional NULLs in
    each key."""
    rng = np.random.default_rng(seed)
    words = np.array(["ash", "birch", "cedar", "oak", "elm", "fir"], dtype=object)
    cols = [words[rng.integers(0, 6, n)], rng.normal(size=n).round(1),
            rng.integers(-40, 40, n), np.arange(n)]
    validity = None
    if nulls:
        validity = [rng.random(n) > 0.1, rng.random(n) > 0.1, rng.random(n) > 0.1, None]
    return _table([("s", T.UTF8, nulls), ("f", T.FLOAT64, nulls),
                   ("i", T.INT64, nulls), ("tag", T.INT64, False)],
                  cols, validity, batch_rows)


class TestSortParity:
    @pytest.mark.parametrize("order", ["i", "i DESC", "f", "f DESC", "s", "s DESC",
                                       "s, f DESC, i", "i DESC, s, f",
                                       "f, s DESC, i DESC"])
    def test_keys_and_directions(self, order):
        rows = _check(_mixed(), f"SELECT s, f, i, tag FROM t ORDER BY {order}")
        assert len(rows) == 5000

    @pytest.mark.parametrize("order", ["i", "f DESC", "s", "s DESC, i", "f, i DESC"])
    def test_null_keys_sort_last(self, order):
        rows = _check(_mixed(nulls=True), f"SELECT s, f, i, tag FROM t ORDER BY {order}")
        first = order.split(",")[0].split()[0]
        col = "sfi".index(first)
        nulls = [r[col] is None for r in rows]
        assert any(nulls) and nulls == sorted(nulls)  # every NULL after every value

    def test_multi_key_matches_python_sort(self):
        rows = _check(_mixed(6000), "SELECT s, f, i, tag FROM t ORDER BY s, f DESC, i")
        want = sorted(rows, key=lambda r: (r[0], -r[1], r[2], r[3]))
        assert rows == want

    def test_stability_under_heavy_ties(self):
        n = 30_000
        rng = np.random.default_rng(43)
        src = _table([("a", T.INT64, False), ("tag", T.INT64, False)],
                     [rng.integers(0, 8, n), np.arange(n)], batch_rows=4096)
        rows = _check(src, "SELECT a, tag FROM t ORDER BY a")
        last = {}
        for key, tag in rows:
            assert last.get(key, -1) < tag, f"unstable at key {key}"
            last[key] = tag

    @pytest.mark.parametrize("direction", ["", " DESC"])
    def test_nan_signed_zero_and_inf(self, direction):
        vals = np.array([1.5, np.nan, -0.0, 0.0, -np.inf, np.inf, -1.5, NEG_NAN,
                         0.0, -0.0, np.nan, NEG_NAN, 2.5, -np.inf])
        assert np.signbit(vals[7]) and np.isnan(vals[7])
        src = _table([("a", T.FLOAT64, False), ("tag", T.INT64, False)],
                     [vals, np.arange(len(vals))])
        rows = _check(src, f"SELECT a, tag FROM t ORDER BY a{direction}")
        order = [t for _, t in rows]
        # as lax.sort orders them on the CPU: -0.0 ties +0.0 (row order
        # kept), and NaN of either sign sorts last, in row order
        assert order[-4:] == [1, 7, 10, 11]
        zeros = [t for v, t in rows if v == 0.0]
        assert zeros == [2, 3, 8, 9]
        if direction:
            assert order[:2] == [5, 12]
        else:
            assert order[:3] == [4, 13, 6]

    def test_float32_bool_int32_keys(self):
        rng = np.random.default_rng(5)
        n = 3000
        src = _table([("f", T.FLOAT32, False), ("b", T.BOOLEAN, False),
                      ("i", T.INT32, False), ("tag", T.INT64, False)],
                     [rng.normal(size=n).astype(np.float32).round(1),
                      rng.random(n) > 0.5, rng.integers(-5, 5, n).astype(np.int32),
                      np.arange(n)])
        _check(src, "SELECT f, b, i, tag FROM t ORDER BY b DESC, f, i DESC")

    def test_int64_extremes(self):
        i64 = np.iinfo(np.int64)
        vals = np.array([0, i64.max, i64.min, -1, i64.max, i64.min + 1, 1, i64.min])
        src = _table([("a", T.INT64, False), ("tag", T.INT64, False)],
                     [vals, np.arange(len(vals))])
        for order in ("a", "a DESC"):
            rows = _check(src, f"SELECT a, tag FROM t ORDER BY {order}")
            keys = [r[0] for r in rows]
            assert keys == sorted(keys, reverse=order.endswith("DESC"))

    def test_fused_predicate(self):
        rows = _check(_mixed(), "SELECT tag, f FROM t WHERE f > 0.5 AND i < 10 "
                                "ORDER BY f DESC, tag")
        assert rows and all(r[1] > 0.5 for r in rows)

    def test_fused_utf8_predicate(self):
        rows = _check(_mixed(nulls=True),
                      "SELECT s, tag FROM t WHERE s >= 'cedar' ORDER BY s, tag DESC")
        assert rows and all(r[0] >= "cedar" for r in rows)

    def test_sort_over_aggregate(self):
        _check(_mixed(), "SELECT s, SUM(i), COUNT(1) FROM t GROUP BY s ORDER BY s DESC")

    def test_bare_limit(self):
        rows = _check(_mixed(), "SELECT s, COUNT(1), MAX(tag) FROM t GROUP BY s LIMIT 4")
        assert len(rows) == 4

    def test_limit_above_topk_max(self):
        n = TOPK_MAX + 4000
        rng = np.random.default_rng(9)
        src = _table([("a", T.INT64, False), ("tag", T.INT64, False)],
                     [rng.integers(0, 1000, n), np.arange(n)], batch_rows=16384)
        rows = _check(src, f"SELECT a, tag FROM t ORDER BY a DESC LIMIT {TOPK_MAX + 1}")
        assert len(rows) == TOPK_MAX + 1

    @pytest.mark.parametrize("nulls", [False, True])
    def test_multi_run_host_merge(self, monkeypatch, nulls):
        # one run per 1024-row batch: the runs merge on the host, and
        # the Utf8 ranks are recomputed under the final dictionary
        monkeypatch.setenv("DATAFUSION_TPU_SORT_RUN_ROWS", "1")
        src = _mixed(6000, seed=3, batch_rows=1024, nulls=nulls)
        _check(src, "SELECT s, f, i, tag FROM t ORDER BY s DESC, i, f")
        _check(src, "SELECT tag, s, f FROM t WHERE i > 0 ORDER BY f, s")

    def test_empty_results(self):
        rows = _check(_mixed(), "SELECT s, tag FROM t WHERE f > 1000 ORDER BY s")
        assert rows == []
        empty = _table([("a", T.INT64, False), ("tag", T.INT64, False)],
                       [np.zeros(0, np.int64), np.zeros(0, np.int64)])
        assert _check(empty, "SELECT a, tag FROM t ORDER BY a") == []

    def test_topk_raises_not_supported(self):
        """Checks that a computed ORDER BY key under a TopK (LIMIT 1 and
        LIMIT TOPK_MAX) raises NotSupportedError, as the full sort does;
        the JAX package refuses it in its plan verifier.  The TopK
        itself is held against the JAX package in
        tests/test_torch_topk.py."""
        tctx = tdf.ExecutionContext(device="cpu")
        src = _mixed(100)
        tctx.register_datasource("t", convert.memory_source(
            src.schema.to_json(), [convert.export_batch(b) for b in src.batches()]))
        for k in (1, TOPK_MAX):
            with pytest.raises(tdf.NotSupportedError, match="column references"):
                tctx.sql(f"SELECT s, tag FROM t ORDER BY tag + 1 LIMIT {k}")


def test_f64_sort_image_orders_as_lax_sort():
    """The image's order over special values, against the JAX
    package's own lax.sort on the CPU, which ties subnormals with the
    zeros."""
    import jax.numpy as jnp
    from jax import lax

    vals = np.array([np.nan, NEG_NAN, -0.0, 0.0, np.inf, -np.inf, 1e-308, -1e-308,
                     5e-324, -5e-324, 1.0, -1.0, np.finfo(np.float64).max,
                     np.finfo(np.float64).min, 0.0, -0.0, NEG_NAN, np.nan,
                     np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny,
                     2.225073858507201e-308])
    img = f64_sort_image(vals)
    ours = np.argsort(img, kind="stable")
    theirs = np.asarray(lax.sort((jnp.asarray(vals), jnp.arange(len(vals))),
                                 num_keys=1, is_stable=True)[1])
    assert ours.tolist() == theirs.tolist()
