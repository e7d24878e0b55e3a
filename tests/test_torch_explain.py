"""PyTorch/CUDA port, slice 11: EXPLAIN ANALYZE against the JAX package.

The same numpy-seeded tables (batches of 1024 rows) run through
`EXPLAIN ANALYZE` in `datafusion_tpu` (JAX on the CPU, with
`DATAFUSION_TPU_COST=0` and `DATAFUSION_TPU_PROFILE_EXPLAIN=0`) and in
`datafusion_tpu_torch` (`device="cpu"`, the profiler off too), for six
query shapes: Q1, config 2, a filter/project, `ORDER BY ... LIMIT`, a
full sort and an INNER join.  Held exactly: the rows (floats at rtol
1e-9), the operator tree (depth, `op_label`, `<- fused pass [...]`
markers), each operator's rows and batches out, the query's
`fused.groups`, `fused.group_batches` and `kernel_cache` hit/miss
deltas, `device.launches` where the port's pass seams are the JAX
package's `device_call` sites, the span names and their nesting, and the
report text with its times, trace id, byte counts and process id
masked.  Each side's operator H2D bytes are held to its own `h2d.bytes`
counter delta (the JAX package's wire codec makes the two differ).

Differences the tests state rather than bend:

- `compile=`: the JAX package compiles an XLA program per query shape
  and reports it; the port compiles nothing on the CPU (its kernels
  build with nvcc on first use on the card), so the masked reports drop
  the field.
- `kernel_cache` for a sort (`topk`, `full_sort`): the JAX package
  compiles a sort core through its core cache and counts one miss; the
  port's sort has no compiled core (its key plans are a plain list built
  per operator), so it counts none.
- A full sort's run: the port sorts it in one device pass
  (`device.launches.sort`, `launches=1`); the JAX package's run sort is
  no `device_call` site (host-routed on the CPU), so it counts 0.
- The join: the JAX package's `HashJoinRelation.batches` instruments
  the join itself and its consumer instruments it again, so it reports
  the join's rows and batches twice, two `op.HashJoin` spans, and no
  stats for the two scans below it, and its build launch counts to the
  consumer.  The port instruments the join once (its consumer), both
  scans (the join pulls them through `iter_stats`), and runs the build
  with the join ambient.

Threads: the prefetch threads stay off on the CPU (no CSV scan on a
card), so every copy here attributes to an operator.
"""

from __future__ import annotations

import io
import re

import numpy as np
import pytest

import datafusion_tpu as jdf
import datafusion_tpu.exec.kernels as jkernels
from datafusion_tpu.obs.device import LEDGER as JAX_LEDGER
from datafusion_tpu.obs.explain import ExplainAnalyzeResult as JaxResult
from datafusion_tpu.obs.stats import collect_tree as jax_collect_tree
from datafusion_tpu.utils.metrics import METRICS as JAX_METRICS

import datafusion_tpu_torch as tdf
import datafusion_tpu_torch.exec.kernels as tkernels
from datafusion_tpu_torch.obs.explain import ExplainAnalyzeResult
from datafusion_tpu_torch.obs.stats import collect_tree
from datafusion_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import T, assert_same, carry, jax_table
from test_torch_port import CONFIG2, Q1, _groupby, _jax_source, _lineitem

BATCH = 1024
WATCHED = ("device.launches", "fused.groups", "fused.group_batches",
           "kernel_cache.hits", "kernel_cache.misses")


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_COST", "0")
    monkeypatch.setenv("DATAFUSION_TPU_PROFILE_EXPLAIN", "0")
    # both packages' core caches start empty, so each query's hit/miss
    # deltas are its own; the JAX package pins join builds by table name
    jkernels._REGISTRY.clear()
    tkernels._REGISTRY.clear()
    JAX_LEDGER.clear()


def _tables():
    """name -> JAX-package source; every table's rows are a multiple of
    the batch size (one capacity), but for `ragged`."""
    li_schema, li_cols = _lineitem(6 * BATCH)
    g_schema, g_cols = _groupby(6 * BATCH, 300)
    rng = np.random.default_rng(17)
    n = 4 * BATCH
    fact = jax_table([("fk", T.INT64, False), ("v", T.FLOAT64, False)],
                     [rng.integers(0, 100, n), rng.random(n)], batch_rows=BATCH)
    dim = jax_table([("id", T.INT64, False), ("name", T.UTF8, False)],
                    [np.arange(100), np.array([f"n{i % 7}" for i in range(100)], dtype=object)],
                    batch_rows=BATCH)
    r_schema, r_cols = _groupby(5 * BATCH + 300, 16, seed=4)
    return {
        "lineitem": _jax_source(li_schema, li_cols, batch_rows=BATCH),
        "t": _jax_source(g_schema, g_cols, batch_rows=BATCH),
        "f": fact,
        "d": dim,
        "ragged": _jax_source(r_schema, r_cols, batch_rows=BATCH),
    }


@pytest.fixture()
def tables():
    # fresh batches per test: both packages cache device copies and
    # group ids on a batch, and a second run would copy nothing
    return _tables()


def _contexts(tables):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=BATCH)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=BATCH)
    for name, src in tables.items():
        jctx.register_datasource(name, src)
        tctx.register_datasource(name, carry(src))
    return jctx, tctx


FILTER_PROJECT = ("SELECT l_returnflag, l_quantity, l_extendedprice * (1 - l_discount) "
                  "FROM lineitem WHERE l_shipdate <= '1998-09-02' AND l_discount > 0.05")
TOPK = "SELECT k, v1 FROM t ORDER BY v1 DESC LIMIT 10"
FULL_SORT = "SELECT k, v3 FROM t WHERE v1 > 500 ORDER BY k, v3 DESC"
JOIN = "SELECT d.name, SUM(f.v), COUNT(1) FROM f JOIN d ON f.fk = d.id GROUP BY d.name"

SORTS = ("topk", "full_sort")

QUERIES = {
    "q1": (Q1, False),
    "config2": (CONFIG2, False),
    "filter_project": (FILTER_PROJECT, False),
    "topk": (TOPK, True),
    "full_sort": (FULL_SORT, True),
}


def _jax_sort_core(lines: list[str]) -> list[str]:
    """The port's report lines as the JAX package words them for a sort:
    one more core-cache miss, its sort core (module docstring)."""
    return [re.sub(r"kernel_cache hit/miss=(\d+)/(\d+)",
                   lambda m: f"kernel_cache hit/miss={m[1]}/{int(m[2]) + 1}", ln)
            for ln in lines]


# The JAX package's EXPLAIN ANALYZE session is the process-ambient trace
# while it runs, so it adopts every thread's spans: a cluster client that
# an earlier test file of the same worker process left running adds
# `cluster.*` spans to it.  No query here opens one (the port has no
# cluster plane), so they are dropped before the reports are compared.
_FOREIGN_SPAN = re.compile(r"^\s+cluster\.")


def _drop_foreign_spans(res):
    res.spans = [s for s in res.spans if not s["name"].startswith("cluster.")]
    return res


def _drop_foreign_lines(lines: list[str]) -> list[str]:
    """A printed report without `cluster.*` span lines, its span count
    lowered to match."""
    kept = [ln for ln in lines if not _FOREIGN_SPAN.match(ln)]
    n = len(lines) - len(kept)
    return [re.sub(r"^Spans \((\d+) total", lambda m: f"Spans ({int(m[1]) - n} total", ln)
            for ln in kept] if n else kept


def _analyze(ctx, sql, metrics):
    before = dict(metrics.snapshot()["counts"])
    res = _drop_foreign_spans(ctx.sql(f"EXPLAIN ANALYZE {sql}"))
    after = metrics.snapshot()["counts"]
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
    return res, delta


def _tree(res, walk):
    return [(depth, rel.op_label(), getattr(rel, "_fused_chain", None),
             rel.stats.rows_out, rel.stats.batches_out)
            for depth, rel in walk(res.root)]


_MASKS = [
    (re.compile(r"\(trace [0-9a-f]+, wall [^,]+,"), "(trace *, wall *,"),
    (re.compile(r"^Phases: .*$"), "Phases: *"),
    (re.compile(r"^HBM: peak \S+ \(live \S+, \d+ buffer"), "HBM: peak * (live *, * buffer"),
    (re.compile(r", compile=[^,\]]+"), ""),
    (re.compile(r"\b(time|device|h2d|d2h)=[^,\]]+"), r"\1=*"),
    (re.compile(r"  [0-9.]+m?s  \[(\w+):\d+\]$"), r"  *  [\1:*]"),
]


def mask(text: str) -> list[str]:
    """The report with every time, trace id, byte count and process id
    masked, and `compile=` dropped (see the module docstring)."""
    out = []
    for line in text.splitlines():
        for pat, rep in _MASKS:
            line = pat.sub(rep, line)
        out.append(line)
    return out


def _span_tree(res) -> list[tuple[int, str, tuple]]:
    """(depth, name, attribute keys) of the spans in rendering order."""
    by_id = {s["span_id"]: s for s in res.spans}
    out = []
    for s in sorted(res.spans, key=lambda s: s["start_ns"]):
        depth, p = 0, s.get("parent_id")
        while p in by_id:
            depth, p = depth + 1, by_id[p].get("parent_id")
        out.append((depth, s["name"], tuple(sorted(s.get("attrs") or {}))))
    return sorted(out)


def _op_h2d(res, walk) -> int:
    return sum(rel.stats.h2d_bytes for _, rel in walk(res.root))


@pytest.mark.parametrize("name", list(QUERIES))
def test_explain_analyze_matches_jax_package(tables, name):
    sql, ordered = QUERIES[name]
    jctx, tctx = _contexts(tables)
    want, jdelta = _analyze(jctx, sql, JAX_METRICS)
    got, tdelta = _analyze(tctx, sql, METRICS)
    assert isinstance(want, JaxResult) and isinstance(got, ExplainAnalyzeResult)
    assert_same(got.result, want.result, ordered=ordered)
    assert got.result.num_rows > 0
    assert _tree(got, collect_tree) == _tree(want, jax_collect_tree)
    jl, tl = mask(want.report()), mask(got.report())
    if name == "full_sort":
        # the port's run sort is a device pass; the JAX package's is no
        # device_call site (module docstring)
        assert jdelta.get("device.launches", 0) == 0
        assert tdelta["device.launches"] == tdelta["device.launches.sort"] == 1
        tl = [ln.replace(", launches=1]", "]").replace("launches_per_pass=1,",
                                                        "launches_per_pass=0,")
              for ln in tl]
        jdelta["device.launches"] = tdelta["device.launches"]
    if name in SORTS:
        # the JAX package's sort core is one core-cache miss the port
        # has no counterpart for (module docstring)
        assert (jdelta.get("kernel_cache.hits", 0), jdelta.get("kernel_cache.misses", 0)) == (0, 1)
        assert (tdelta.get("kernel_cache.hits", 0), tdelta.get("kernel_cache.misses", 0)) == (0, 0)
        tl = _jax_sort_core(tl)
        jdelta["kernel_cache.misses"] = 0
    assert tl == jl
    for k in WATCHED:
        assert tdelta.get(k, 0) == jdelta.get(k, 0), k
    assert got.counters == {k: tdelta.get(k, 0) for k in WATCHED}
    assert _span_tree(got) == _span_tree(want)
    # each side's operator H2D bytes are its own counter's delta
    assert _op_h2d(got, collect_tree) == tdelta["h2d.bytes"] > 0
    assert _op_h2d(want, jax_collect_tree) > 0


def test_repeated_query_hits_the_core_cache(tables):
    jctx, tctx = _contexts(tables)
    for ctx, metrics in ((jctx, JAX_METRICS), (tctx, METRICS)):
        _analyze(ctx, CONFIG2, metrics)
        res, delta = _analyze(ctx, CONFIG2, metrics)
        assert (delta.get("kernel_cache.hits", 0), delta.get("kernel_cache.misses", 0)) == (1, 0)
        assert "kernel_cache hit/miss=1/0" in res.report()


def test_ragged_last_batch_folds_into_the_same_pass(tables):
    """5 batches of 1024 rows and one of 300 (another capacity): the
    port concatenates it into the group, the JAX package pads it into
    its stacked group; one pass of 6 batches in both."""
    sql = "SELECT k, SUM(v1), COUNT(1) FROM ragged GROUP BY k"
    jctx, tctx = _contexts(tables)
    want, jdelta = _analyze(jctx, sql, JAX_METRICS)
    got, tdelta = _analyze(tctx, sql, METRICS)
    assert_same(got.result, want.result, ordered=False)
    for delta in (tdelta, jdelta):
        assert (delta["device.launches"], delta["fused.group_batches"]) == (1, 6)
    assert _tree(got, collect_tree) == _tree(want, jax_collect_tree)
    assert mask(got.report()) == mask(want.report())


def test_join_tree_rows_and_the_stated_differences(tables):
    jctx, tctx = _contexts(tables)
    want, jdelta = _analyze(jctx, JOIN, JAX_METRICS)
    got, tdelta = _analyze(tctx, JOIN, METRICS)
    assert_same(got.result, want.result, ordered=False)
    port = _tree(got, collect_tree)
    jax = _tree(want, jax_collect_tree)
    assert [t[:3] for t in port] == [t[:3] for t in jax]
    assert [t[1] for t in port] == ["Aggregate[keys=1, slots=2]", "HashJoin[inner, on=#0=#0]",
                                    "Scan[Memory]", "Scan[Memory]"]
    # the port: the join once, both scans counted
    assert port[1][3:] == (4 * BATCH, 4)
    assert port[2][3:] == (4 * BATCH, 4) and port[3][3:] == (100, 1)
    # the JAX package: the join counted twice, the scans not at all
    assert jax[1][3:] == (2 * 4 * BATCH, 8)
    assert jax[2][3:] == jax[3][3:] == (0, 0)
    assert port[0][3:] == jax[0][3:]
    # one dense build and one probe a batch in both packages, plus the
    # aggregate's pass
    assert tdelta["device.launches.join.build"] == jdelta["device.launches.join.build"] == 1
    assert tdelta["device.launches.join.probe"] == jdelta["device.launches.join.probe"] == 4
    for k in WATCHED:
        assert tdelta.get(k, 0) == jdelta.get(k, 0), k
    names = [n for _, n, _ in _span_tree(got)]
    assert sorted(names) == ["op.Aggregate", "op.DataSource", "op.DataSource",
                             "op.HashJoin", "query"]
    assert sorted(n for _, n, _ in _span_tree(want)) == [
        "op.Aggregate", "op.HashJoin", "op.HashJoin", "query"]


def test_explain_without_analyze_still_only_plans(tables):
    jctx, tctx = _contexts(tables)
    before = METRICS.snapshot()["counts"].get("device.launches", 0)
    for sql in (Q1, JOIN, TOPK):
        want = jctx.sql(f"EXPLAIN {sql}")
        got = tctx.sql(f"EXPLAIN {sql}")
        assert type(got).__name__ == type(want).__name__ == "ExplainResult"
        assert repr(got) == repr(want)
    assert METRICS.snapshot()["counts"].get("device.launches", 0) == before


def _console_lines(ctx, console_cls, command):
    out = io.StringIO()
    console = console_cls(ctx, out=out)
    assert console.handle_command(command)
    return [ln for ln in _drop_foreign_lines(mask(out.getvalue())) if "seconds" not in ln]


@pytest.mark.parametrize("name", ["q1", "topk"])
def test_console_backslash_explain_matches_jax_console(tables, name):
    from datafusion_tpu.cli import Console as JaxConsole

    from datafusion_tpu_torch.cli import Console

    sql, _ = QUERIES[name]
    jctx, tctx = _contexts(tables)
    want = _console_lines(jctx, JaxConsole, f"\\explain {sql};")
    jkernels._REGISTRY.clear()
    tkernels._REGISTRY.clear()
    got = _console_lines(tctx, Console, f"\\explain {sql};")
    if name in SORTS:
        got = _jax_sort_core(got)
    assert got == want
    assert got[0] == "Executing query ..." and got[1].startswith("EXPLAIN ANALYZE  (trace *")
    assert _console_lines(tctx, Console, "\\explain") == ["Usage: \\explain <sql statement>"]


def test_console_hbm_prints_the_ledger(tables):
    from datafusion_tpu_torch.cli import Console

    _, tctx = _contexts(tables)
    tctx.sql_collect(Q1)
    out = io.StringIO()
    assert Console(tctx, out=out).handle_command("\\hbm")
    assert out.getvalue().startswith("Device ledger: ")


def test_root_stats_and_wall(tables):
    _, tctx = _contexts(tables)
    plain = tdf.collect(tctx.sql(FILTER_PROJECT))
    res = tctx.sql(f"EXPLAIN ANALYZE {FILTER_PROJECT}")
    assert sorted(res.result.to_rows()) == sorted(plain.to_rows())
    assert res.root.stats.rows_out == plain.num_rows
    assert res.root.stats.batches_out == 6
    assert 0 < res.root.stats.time_s <= res.wall_s
    assert set(res.phases) == {"decode", "h2d", "compile", "execute", "d2h", "other"}
    assert res.phases["execute"] > 0 and res.phases["compile"] == 0
    assert repr(res) == res.report()
    with pytest.raises(tdf.NotSupportedError, match="13.2"):
        res.otlp()


def test_sql_collect_returns_the_result_object(tables):
    _, tctx = _contexts(tables)
    res = tctx.sql_collect(f"EXPLAIN ANALYZE {TOPK}")
    assert isinstance(res, ExplainAnalyzeResult)
    assert res.result.num_rows == 10


def test_uninstrumented_run_records_no_operator_stats(tables):
    _, tctx = _contexts(tables)
    rel = tctx.sql(Q1)
    tdf.collect(rel)
    assert rel._op_stats is None and rel.child._op_stats is None


def test_prefetch_threads_copies_count_to_no_operator(tables, monkeypatch):
    """With the staged prefetch forced on, the staging thread copies the
    batches' columns and group ids: those bytes count in `h2d.bytes` but
    to no operator (contextvars do not cross threads), and the scan's
    span, begun on the pull thread, is an orphan at the root of the span
    tree, as in the JAX package; nothing fakes a parent."""
    monkeypatch.setenv("DATAFUSION_TPU_PREFETCH", "1")
    _, tctx = _contexts(tables)
    res, delta = _analyze(tctx, CONFIG2, METRICS)
    assert res.result.num_rows == 300
    assert _op_h2d(res, collect_tree) < delta["h2d.bytes"]
    depth = {n: d for d, n, _ in _span_tree(res)}
    assert depth == {"query": 0, "op.Aggregate": 1, "op.DataSource": 0}
    report = res.report()
    assert report.splitlines()[-1].startswith("  op.DataSource")  # an orphan, at the root
