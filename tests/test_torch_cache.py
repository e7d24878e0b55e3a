"""PyTorch/CUDA port: the result cache (`datafusion_tpu_torch/cache`,
the seam in `exec/context.py`), against the JAX package's.

The cases of the JAX package's `tests/test_cache.py`: `TestCacheStore`
(byte-accounted LRU, oversized values, TTL, tag invalidation,
replacement, stats and gauges), `TestFingerprint` (determinism and
sensitivity, catalog versions, canonical JSON), `TestResultCache` (a repeat served without
re-execution, EXPLAIN ANALYZE showing the hit and filling the cache,
invalidation by re-registration, TTL, oversized results, distinct
entries, Utf8 and NULLs, empty results, UDF registration, off means
off, an externally rewritten file, concurrent queries) and
`TestStatsHistory`, run on the port with `device="cpu"`.  Each query's
rows, cached or not, equal the JAX package's on the same seeded table,
and both packages fingerprint the same plan to the same digest.

Held elsewhere: `TestWorkerFragmentCache` (the worker fragment cache)
and `TestFingerprint::test_fragment_fingerprint_ignores_query_id` (its
fingerprint) in `tests/test_torch_fragment_cache.py`, against the JAX
package's; `TestTraceFlusher` (the background span flusher) in
`tests/test_torch_obs.py::test_flusher_appends_finished_spans_as_json_lines`.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu import cache as jax_cache
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource
from datafusion_tpu.exec.materialize import collect as jax_collect

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import cache
from datafusion_tpu_torch.cache.result import CachedResultRelation
from datafusion_tpu_torch.cache.store import CacheStore
from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.exec.batch import StringDictionary, make_host_batch
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.exec.materialize import collect
from datafusion_tpu_torch.sql.parser import parse_sql

SCHEMA = Schema([Field("k", DataType.UTF8, False), Field("v", DataType.FLOAT64, False)])
SQL = "SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k"


def _batch(keys, vals, schema=SCHEMA, dict_cls=StringDictionary, make=make_host_batch):
    d = dict_cls()
    codes = np.array([d.add(s) for s in keys], dtype=np.int32)
    return make(schema, [codes, np.asarray(vals, dtype=np.float64)], [None, None], [d, None])


def _mem_source(keys=("a", "b", "a", "c"), vals=(1.0, 2.0, 3.0, 4.0)):
    return MemoryDataSource(SCHEMA, [_batch(keys, vals)])


class CountingSource(MemoryDataSource):
    """A MemoryDataSource that counts its scans (shared through
    projection push-down)."""

    def __init__(self, schema, batches, counter=None):
        super().__init__(schema, batches)
        self.counter = counter if counter is not None else {"scans": 0}

    @property
    def scans(self):
        return self.counter["scans"]

    def batches(self):
        self.counter["scans"] += 1
        return super().batches()

    def with_projection(self, projection):
        base = super().with_projection(projection)
        return CountingSource(base._schema, base._batches, self.counter)


def _counting_ctx(**kw):
    src = CountingSource(SCHEMA, list(_mem_source()._batches))
    ctx = ExecutionContext(device="cpu", **kw)
    ctx.register_datasource("t", src)
    return ctx, src


def _rows(ctx, sql=SQL):
    return sorted(collect(ctx.sql(sql)).to_rows())


def _jax_rows(sql=SQL, keys=("a", "b", "a", "c"), vals=(1.0, 2.0, 3.0, 4.0)):
    jschema = jdf.Schema([jdf.Field("k", jdf.DataType.UTF8, False),
                          jdf.Field("v", jdf.DataType.FLOAT64, False)])
    from datafusion_tpu.exec.batch import StringDictionary as JDict
    from datafusion_tpu.exec.batch import make_host_batch as jmake

    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_datasource("t", JaxMemorySource(
        jschema, [_batch(keys, vals, jschema, JDict, jmake)]))
    return sorted(jax_collect(jctx.sql(sql)).to_rows())


# -- store ------------------------------------------------------------


class TestCacheStore:
    def test_lru_eviction_by_bytes(self):
        st = CacheStore(max_bytes=100, name="t1")
        assert st.put("a", 1, 40) and st.put("b", 2, 40)
        assert st.get("a") == 1
        assert st.put("c", 3, 40)  # evicts b (LRU)
        assert st.get("b") is None
        assert st.get("a") == 1 and st.get("c") == 3
        assert st.evictions == 1
        assert st.bytes_used == 80

    def test_oversized_value_rejected_not_stored(self):
        st = CacheStore(max_bytes=100, name="t2")
        st.put("small", 1, 10)
        assert not st.put("huge", 2, 1000)
        assert st.get("huge") is None
        assert st.get("small") == 1
        assert st.rejected == 1

    def test_ttl_expiry(self):
        st = CacheStore(max_bytes=100, ttl_s=0.05, name="t3")
        st.put("a", 1, 10)
        assert st.get("a") == 1
        time.sleep(0.08)
        assert st.get("a") is None
        assert st.entries == 0 and st.bytes_used == 0

    def test_tag_invalidation(self):
        st = CacheStore(max_bytes=1000, name="t4")
        st.put("q1", 1, 10, tags=("lineitem",))
        st.put("q2", 2, 10, tags=("lineitem", "orders"))
        st.put("q3", 3, 10, tags=("orders",))
        assert st.invalidate_tag("lineitem") == 2
        assert st.get("q1") is None and st.get("q2") is None
        assert st.get("q3") == 3
        assert st.bytes_used == 10

    def test_replace_updates_bytes(self):
        st = CacheStore(max_bytes=100, name="t5")
        st.put("a", 1, 60)
        st.put("a", 2, 30)
        assert st.bytes_used == 30 and st.entries == 1
        assert st.get("a") == 2

    def test_stats_and_gauges(self):
        st = CacheStore(max_bytes=100, name="t6")
        st.put("a", 1, 10)
        st.get("a")
        st.get("missing")
        s = st.stats()
        assert (s["hits"], s["misses"], s["entries"]) == (1, 1, 1)
        g = st.gauges()
        assert g["cache.t6.bytes"] == 10 and g["cache.t6.entries"] == 1


# -- fingerprints -----------------------------------------------------


class TestFingerprint:
    def _plan(self, ctx, sql):
        return ctx._plan(parse_sql(sql))

    def test_plan_fingerprint_deterministic_and_sensitive(self):
        ctx = ExecutionContext(device="cpu")
        ctx.register_datasource("t", _mem_source())
        p1, p2 = self._plan(ctx, SQL), self._plan(ctx, SQL)
        assert ctx.query_fingerprint(p1) == ctx.query_fingerprint(p2)
        p3 = self._plan(ctx, SQL + " LIMIT 1")
        assert ctx.query_fingerprint(p1) != ctx.query_fingerprint(p3)
        a = self._plan(ctx, "SELECT v FROM t WHERE v > 1.0")
        b = self._plan(ctx, "SELECT v FROM t WHERE v > 2.0")
        assert ctx.query_fingerprint(a) != ctx.query_fingerprint(b)

    def test_catalog_version_changes_fingerprint(self):
        ctx = ExecutionContext(device="cpu")
        ctx.register_datasource("t", _mem_source())
        plan = self._plan(ctx, SQL)
        fp1 = ctx.query_fingerprint(plan)
        ctx.register_datasource("t", _mem_source())  # same data, new version
        assert ctx.query_fingerprint(plan) != fp1
        assert ctx.catalog_version("t") == 2

    def test_canonical_json_key_order_independent(self):
        assert cache.canonical_json({"b": 1, "a": [2, 3]}) == \
            cache.canonical_json({"a": [2, 3], "b": 1})

    def test_same_plan_same_digest_as_the_jax_package(self):
        ctx = ExecutionContext(device="cpu")
        ctx.register_datasource("t", _mem_source())
        jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        jctx.register_datasource("t", JaxMemorySource(jdf.Schema([
            jdf.Field("k", jdf.DataType.UTF8, False),
            jdf.Field("v", jdf.DataType.FLOAT64, False)]), []))
        from datafusion_tpu.sql.parser import parse_sql as jparse

        for sql in (SQL, "SELECT v FROM t WHERE v > 1.5 ORDER BY v LIMIT 2"):
            plan, jplan = ctx._plan(parse_sql(sql)), jctx._plan(jparse(sql))
            versions, extra = {"t": [3]}, {"device": "cpu"}
            assert cache.plan_fingerprint(plan, versions, extra) == \
                jax_cache.plan_fingerprint(jplan, versions, extra)


# -- the result cache -------------------------------------------------


class TestResultCache:
    def test_repeat_query_served_without_reexecution(self):
        ctx, src = _counting_ctx()
        want = _rows(ctx)
        assert want == _jax_rows()
        scans = src.scans
        assert scans >= 1
        rel = ctx.sql(SQL)
        assert isinstance(rel, CachedResultRelation)
        assert sorted(collect(rel).to_rows()) == want
        assert src.scans == scans
        assert ctx.result_cache.hits == 1

    def test_explain_analyze_shows_cache_hit(self):
        ctx, _src = _counting_ctx()
        _rows(ctx)
        report = ctx.sql("EXPLAIN ANALYZE " + SQL).report()
        assert "CachedResult" in report and "cache.hit=True" in report

    def test_explain_analyze_populates_cache(self):
        ctx, src = _counting_ctx()
        res = ctx.sql("EXPLAIN ANALYZE " + SQL)
        scans = src.scans
        rel = ctx.sql(SQL)
        assert isinstance(rel, CachedResultRelation)
        assert sorted(collect(rel).to_rows()) == sorted(res.result.to_rows())
        assert src.scans == scans

    def test_reregistration_invalidates(self):
        ctx, _src = _counting_ctx()
        want1 = _rows(ctx)
        src2 = CountingSource(SCHEMA, list(_mem_source(keys=("x", "x"),
                                                       vals=(10.0, 20.0))._batches))
        ctx.register_datasource("t", src2)
        rel = ctx.sql(SQL)
        assert not isinstance(rel, CachedResultRelation)
        got = sorted(collect(rel).to_rows())
        assert got == [("x", 30.0, 2)] and got != want1
        assert got == _jax_rows(keys=("x", "x"), vals=(10.0, 20.0))
        assert src2.scans >= 1

    def test_ttl_expiry_re_executes(self):
        with cache.configured(ttl_s=0.05):
            ctx, src = _counting_ctx()
            _rows(ctx)
            scans = src.scans
            time.sleep(0.08)
            rel = ctx.sql(SQL)
            assert not isinstance(rel, CachedResultRelation)
            collect(rel)
            assert src.scans > scans

    def test_oversized_result_not_cached(self):
        with cache.configured(max_bytes=64):
            ctx, src = _counting_ctx()
            _rows(ctx)
            scans = src.scans
            rel = ctx.sql(SQL)
            assert not isinstance(rel, CachedResultRelation)
            collect(rel)
            assert src.scans > scans
            assert ctx.result_cache.entries == 0

    def test_distinct_queries_distinct_entries(self):
        ctx, _src = _counting_ctx()
        _rows(ctx)
        _rows(ctx, "SELECT v FROM t WHERE v > 1.5")
        assert ctx.result_cache.entries == 2
        assert isinstance(ctx.sql(SQL), CachedResultRelation)
        assert isinstance(ctx.sql("SELECT v FROM t WHERE v > 1.5"), CachedResultRelation)
        assert _rows(ctx, "SELECT v FROM t WHERE v > 1.5") == \
            _jax_rows("SELECT v FROM t WHERE v > 1.5")

    def test_utf8_and_validity_roundtrip(self):
        schema = Schema([Field("s", DataType.UTF8, True), Field("x", DataType.FLOAT64, True)])
        d = StringDictionary()
        codes = np.array([d.add(s) for s in ["aa", "bb", "aa"]], np.int32)
        batch = make_host_batch(schema, [codes, np.array([1.0, 2.0, 3.0])],
                                [np.array([True, False, True]), np.array([False, True, True])],
                                [d, None])
        ctx = ExecutionContext(device="cpu")
        ctx.register_datasource("u", MemoryDataSource(schema, [batch]))
        sql = "SELECT s, x FROM u"
        want = collect(ctx.sql(sql)).to_rows()
        rel = ctx.sql(sql)
        assert isinstance(rel, CachedResultRelation)
        assert collect(rel).to_rows() == want
        assert [r[0] for r in want] == ["aa", None, "aa"]
        assert [r[1] for r in want] == [None, 2.0, 3.0]

    def test_empty_result_cached(self):
        ctx, _src = _counting_ctx()
        sql = "SELECT v FROM t WHERE v > 100.0"
        assert _rows(ctx, sql) == []
        rel = ctx.sql(sql)
        assert isinstance(rel, CachedResultRelation)
        assert sorted(collect(rel).to_rows()) == []

    def test_udf_registration_invalidates_by_fingerprint(self):
        ctx, _src = _counting_ctx()
        _rows(ctx)
        ctx.register_udf("twice", [DataType.FLOAT64], DataType.FLOAT64, lambda x: x * 2)
        assert not isinstance(ctx.sql(SQL), CachedResultRelation)

    def test_off_means_off(self):
        with cache.configured(enabled=False):
            ctx, src = _counting_ctx()
            assert ctx.result_cache is None
            _rows(ctx)
            scans = src.scans
            rel = ctx.sql(SQL)
            assert not isinstance(rel, CachedResultRelation)
            assert not hasattr(rel, "_result_cache_fill")
            collect(rel)
            assert src.scans > scans

    def test_explicit_false_overrides_env_default(self):
        ctx = ExecutionContext(device="cpu", result_cache=False)
        assert ctx.result_cache is None

    def test_explicit_store_is_used(self):
        store = CacheStore(1 << 20, name="mine")
        ctx, src = _counting_ctx(result_cache=store)
        assert ctx.result_cache is store
        _rows(ctx)
        assert store.entries == 1
        assert isinstance(ctx.sql(SQL), CachedResultRelation)

    def test_externally_rewritten_file_not_served_stale(self, tmp_path):
        path = tmp_path / "t.csv"
        path.write_text("k,v\na,1.0\nb,2.0\n")
        ctx = ExecutionContext(device="cpu")
        ctx.register_csv("t", str(path), SCHEMA)
        sql = "SELECT k, v FROM t"
        assert sorted(r[0] for r in _rows(ctx, sql)) == ["a", "b"]
        path.write_text("k,v\nz,9.0\n")
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        rel = ctx.sql(sql)
        assert not isinstance(rel, CachedResultRelation)
        assert [r[0] for r in collect(rel).to_rows()] == ["z"]

    def test_concurrent_queries_one_context(self):
        ctx, _src = _counting_ctx()
        sqls = [SQL, "SELECT v FROM t WHERE v > 1.5", "SELECT k FROM t"]
        wants = [_rows(ctx, s) for s in sqls]
        results: dict[int, list] = {}

        def run(i):
            results[i] = [_rows(ctx, sqls[i]) for _ in range(5)]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sqls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, want in enumerate(wants):
            assert all(got == want for got in results[i])

    def test_cached_replay_is_chunked_by_batch_size(self):
        ctx = ExecutionContext(device="cpu", batch_size=2)
        ctx.register_datasource("t", _mem_source())
        sql = "SELECT k, v FROM t"
        want = collect(ctx.sql(sql)).to_rows()
        rel = ctx.sql(sql)
        assert isinstance(rel, CachedResultRelation)
        assert [b.num_rows for b in rel.batches()] == [2, 2]
        assert collect(ctx.sql(sql)).to_rows() == want


    def test_pin_promotion_keeps_cached_results(self):
        """A server's promotion of a table to a pinned resident is a slot
        swap, not a re-registration: the catalog version and the data
        identity stay, so the result cached before it still answers."""
        ctx, src = _counting_ctx()
        want = _rows(ctx)
        cat = ctx.catalog_version("t")
        scans = src.scans
        with ctx.serve(workers=1, window_s=0.001) as srv:
            t = srv.submit(SQL)
            assert sorted(t.result(timeout=60).to_rows()) == want
            assert isinstance(t._rel, CachedResultRelation)
        # one scan: the pin materializing the table, not the query
        assert ctx.catalog_version("t") == cat and src.scans == scans + 1


# -- stats history ----------------------------------------------------


class TestStatsHistory:
    def test_warm_and_cold_runs_recorded(self):
        ctx, _src = _counting_ctx()
        _rows(ctx)
        fp = ctx.last_fingerprint
        _rows(ctx)
        hist = ctx.stats_history(fp)
        assert [h["cache_hit"] for h in hist] == [False, True]
        assert all(h["rows"] == 3 for h in hist)
        assert all(h["wall_s"] >= 0 for h in hist)
        assert fp in ctx.stats_history()

    def test_instrumented_run_records_operators(self):
        ctx, _src = _counting_ctx()
        ctx.sql("EXPLAIN ANALYZE " + SQL)
        hist = ctx.stats_history(ctx.last_fingerprint)
        assert hist and "operators" in hist[0]
        assert any("Aggregate" in o["op"] for o in hist[0]["operators"])

    def test_history_bounded(self):
        ctx, _src = _counting_ctx()
        ctx._history_cap = 4
        for _ in range(8):
            _rows(ctx)
        assert len(ctx.stats_history(ctx.last_fingerprint)) == 4


@pytest.mark.parametrize("cmd", ["\\cache"])
def test_console_cache_text_matches_the_jax_package(cmd):
    import io

    from datafusion_tpu import cli as jcli

    from datafusion_tpu_torch import cli as tcli

    outs = []
    for mod, ctx in ((jcli, jdf.ExecutionContext(device="cpu")),
                     (tcli, ExecutionContext(device="cpu"))):
        buf = io.StringIO()
        console = mod.Console(ctx, out=buf)
        console.execute(cmd)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[1].startswith("Result cache: 0 entries")
    with cache.configured(enabled=False):
        buf = io.StringIO()
        tcli.Console(tdf.ExecutionContext(device="cpu"), out=buf).execute(cmd)
        assert buf.getvalue() == "Result cache is off (DATAFUSION_TPU_CACHE=0).\n"
