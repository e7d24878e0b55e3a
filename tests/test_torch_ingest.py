"""PyTorch/CUDA port: streaming appends and incrementally maintained
materialized views (`datafusion_tpu_torch/ingest`), against the JAX
package's `ingest/`.

The cases of the JAX package's `tests/test_ingest.py` on the port
(`device="cpu"`, the kernels' plain versions): `TestAppendPath` (an
append is visible and bumps the versions, the fingerprint changes per
append, a cached result is invalidated, a schema mismatch is refused
before the log, a log fault acknowledges nothing), `TestRecovery` (a
crash replays every acknowledged append, a torn tail keeps them, a
failed log write burns its revision) and `TestIncrementalViews` (the
view at every cut, the fallback shapes, CREATE MATERIALIZED VIEW through
SQL, a subscription waking on an advance).  Then what the port adds:
the view against the JAX package's view at every cut, one device pass
and one grouped reduce per slot per delta, a log written by either
package recovered by the other, capacity growth past
`agg_max_groups()` mid-stream with stable string ids, NULL-bearing
deltas, f32 slots within the Higham-Mary bound of
tests/test_torch_f32_sum.py, and repeated runs giving the same bits.

Tolerances are the exactness contract of `ingest/__init__.py`: keys,
counts, ints, MIN, MAX and NULLs exactly; f64 SUM and AVG within rtol
1e-9 against the JAX package and against the port's rescan under the
batch-group fold; bit for bit against the port's rescan under
`DATAFUSION_TPU_FUSE=0`.

Held elsewhere: `TestIncrementalViews::test_freshness_slo_reads_live_lags`
(the freshness SLO) in
`tests/test_torch_telemetry.py::test_freshness_objective_reads_live_lags`;
`freshness_lags`, the seam it reads, is checked here.
`TestMegabatchLanes` belongs to the serving megabatch lanes, which
tests/test_torch_serve.py holds against the JAX package.
"""

from __future__ import annotations

import math
import os
import re
import sys
import threading
import time

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import ingest as ingest_mod
from datafusion_tpu_torch.errors import IngestError, IngestUnavailableError
from datafusion_tpu_torch.exec.batch import StringDictionary, make_host_batch
from datafusion_tpu_torch.exec.cuda import hash_agg, sort_kernel
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.sql.parser import parse_sql
from datafusion_tpu_torch.utils.metrics import METRICS

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import port_f32_sum as f32  # noqa: E402

T = tdf.DataType
FIELDS = [("g", "UTF8", False), ("v", "INT64", False), ("w", "FLOAT64", False)]
VIEW_SQL = "SELECT g, SUM(v), COUNT(1), AVG(w), MIN(w), MAX(w) FROM t GROUP BY g"


def _schema(pkg, fields):
    return pkg.Schema([pkg.Field(n, getattr(pkg.DataType, t), nl) for n, t, nl in fields])


def _base_columns(rows=256, seed=0):
    rng = np.random.default_rng(seed)
    return [[f"g{j}" for j in rng.integers(0, 5, rows)],
            rng.integers(0, 1000, rows).astype(np.int64),
            np.round(rng.uniform(0, 100, rows), 3)]


def _source(pkg, fields, columns, validity=None, batch_rows=128):
    """The same table in either package: `pkg` is `jdf` or `tdf`; Utf8
    columns encode batch by batch into one dictionary per column."""
    jax = pkg is jdf
    schema = _schema(pkg, fields)
    dict_cls = JaxDictionary if jax else StringDictionary
    make = jax_make_host_batch if jax else make_host_batch
    dicts = [dict_cls() if t == "UTF8" else None for _, t, _ in fields]
    n = len(columns[0])
    batches = []
    for lo in range(0, n, batch_rows):
        sl = slice(lo, lo + batch_rows)
        cols = [d.encode(list(c[sl])) if d is not None else np.asarray(c[sl])
                for c, d in zip(columns, dicts)]
        valids = [None if v is None else np.asarray(v[sl])
                  for v in (validity or [None] * len(columns))]
        batches.append(make(schema, cols, valids, dicts))
    return (JaxMemorySource if jax else MemoryDataSource)(schema, batches)


def _ctx(pkg=tdf, result_cache=False, fields=FIELDS, columns=None, validity=None):
    ctx = pkg.ExecutionContext(device="cpu", result_cache=None if result_cache else False)
    ctx.register_datasource("t", _source(pkg, fields, columns or _base_columns(), validity))
    return ctx


def _delta(i: int, rows: int):
    rng = np.random.default_rng(100 + i)
    return {
        "g": [f"g{j}" for j in rng.integers(0, 7, rows)],
        "v": [int(x) for x in rng.integers(0, 1000, rows)],
        "w": [round(float(x), 3) for x in rng.uniform(0, 100, rows)],
    }


def _same(g, w, exact: bool) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        if math.isnan(w) or math.isnan(g):
            return math.isnan(w) and math.isnan(g)
        return g == w if exact else math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return g == w


def assert_rows(got, want, exact=False, label=""):
    """Rows as multisets (ordered by their keys): ints, strings and
    NULLs exactly; floats bit for bit when `exact`, else within rtol
    1e-9."""
    g, w = sorted(got, key=repr), sorted(want, key=repr)
    assert len(g) == len(w), (label, g, w)
    for a, b in zip(g, w):
        assert len(a) == len(b) and all(_same(x, y, exact) for x, y in zip(a, b)), (label, a, b)


# -- the append path (tests/test_ingest.py::TestAppendPath) -----------


class TestAppendPath:
    def test_append_visible_and_versions_bump(self):
        ctx = _ctx()
        ing = ctx.ingest()
        before_rows = len(ctx.sql_collect("SELECT g FROM t").to_rows())
        cat0 = ctx.catalog_version("t")
        ack = ing.append("t", {"g": ["zz"], "v": [1], "w": [0.5]})
        assert ack["rows"] == 1 and ack["rev"] == 1
        assert ctx.catalog_version("t") > cat0
        rows = ctx.sql_collect("SELECT g FROM t").to_rows()
        assert len(rows) == before_rows + 1
        assert ("zz",) in rows

    def test_fingerprint_changes_per_append(self):
        ctx = _ctx()
        ing = ctx.ingest()
        ing.append("t", _delta(0, 3))
        plan = ctx._plan(parse_sql("SELECT g, SUM(v) FROM t GROUP BY g"))
        fp0 = ctx.query_fingerprint(plan)
        assert ctx.query_fingerprint(plan) == fp0
        ing.append("t", _delta(1, 3))
        assert ctx.query_fingerprint(plan) != fp0

    def test_cached_result_invalidated_by_append(self):
        ctx = _ctx(result_cache=True)
        ing = ctx.ingest()
        sql = "SELECT SUM(v) FROM t"
        (first,) = ctx.sql_collect(sql).to_rows()
        (warm,) = ctx.sql_collect(sql).to_rows()
        assert warm == first and ctx.result_cache.hits == 1
        ing.append("t", {"g": ["x"], "v": [10_000_000], "w": [1.0]})
        (after,) = ctx.sql_collect(sql).to_rows()
        assert after[0] == first[0] + 10_000_000

    def test_schema_mismatch_rejected_before_log(self, tmp_path):
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=str(tmp_path))
        with pytest.raises(IngestError):
            ing.append("t", {"g": ["a"], "v": [1]})
        with pytest.raises(IngestError):
            ing.append("t", {"g": ["a"], "v": [1], "w": [1.0], "bogus": [1]})
        with pytest.raises(IngestError):
            ing.append("t", {"g": ["a", "b"], "v": [1], "w": [1.0]})
        with pytest.raises(IngestError):
            ing.append("t", {"g": ["a"], "v": ["not a number"], "w": [1.0]})
        assert ing.status()["rev"] == 0
        assert ing.status()["wal"]["appends"] == 0

    def test_wal_unavailable_acks_nothing(self, tmp_path, monkeypatch):
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=str(tmp_path))
        ing.append("t", _delta(0, 2))
        rows0 = len(ctx.sql_collect("SELECT g FROM t").to_rows())

        def broken(entries):
            raise OSError("disk full")

        monkeypatch.setattr(ing._wal, "append", broken)
        with pytest.raises(IngestUnavailableError):
            ing.append("t", _delta(1, 2))
        assert len(ctx.sql_collect("SELECT g FROM t").to_rows()) == rows0
        monkeypatch.undo()
        ack = ing.append("t", _delta(1, 2))
        assert ack["rev"] == 3

    @pytest.mark.parametrize("site", ["wal.write", "wal.fsync"])
    def test_disk_fault_site_acks_nothing(self, tmp_path, site):
        from datafusion_tpu_torch.testing import faults

        ctx = _ctx()
        ing = ctx.ingest(wal_dir=str(tmp_path))
        view = ing.create_view("mv", VIEW_SQL)
        before = ing.read_view("mv").to_rows()
        with faults.scoped({"rules": [{"site": site, "op": "raise", "exc": "OSError"}]}):
            with pytest.raises(IngestUnavailableError):
                ing.append("t", _delta(0, 5))
        assert ing.read_view("mv").to_rows() == before
        assert view.revision == 1 and view.lag() == 0.0
        assert ing.append("t", _delta(0, 5))["rev"] == 3


# -- recovery (tests/test_ingest.py::TestRecovery) --------------------


class TestRecovery:
    def test_crash_recovery_replays_acked_appends(self, tmp_path):
        wal = str(tmp_path)
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=wal)
        ing.create_view("mv", VIEW_SQL)
        for i in range(3):
            ing.append("t", _delta(i, 5 + i))
        want_rows = ctx.sql_collect(VIEW_SQL).to_rows()
        want_rev = ing.view("mv").revision
        ing.close()
        del ctx, ing

        ctx2 = _ctx()
        ing2 = ctx2.ingest(wal_dir=wal)
        rec = ing2.recover()
        assert rec["appends_replayed"] == 3
        assert rec["views_recovered"] == 1
        assert rec["torn_tails"] == 0
        assert_rows(ing2.read_view("mv").to_rows(), want_rows)
        assert_rows(ctx2.sql_collect(VIEW_SQL).to_rows(), want_rows)
        assert ing2.view("mv").revision == want_rev

    def test_torn_tail_keeps_every_acked_append(self, tmp_path):
        wal = str(tmp_path)
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=wal)
        for i in range(2):
            ing.append("t", _delta(i, 4))
        want = sorted(ctx.sql_collect("SELECT g, v FROM t").to_rows())
        ing.close()
        del ctx, ing
        segs = sorted(p for p in os.listdir(wal) if p.endswith(".seg"))
        with open(os.path.join(wal, segs[-1]), "ab") as f:
            f.write(b"\x00" * 11)

        ctx2 = _ctx()
        ing2 = ctx2.ingest(wal_dir=wal)
        rec = ing2.recover()
        assert rec["appends_replayed"] == 2
        assert rec["torn_tails"] == 1
        assert sorted(ctx2.sql_collect("SELECT g, v FROM t").to_rows()) == want
        assert ing2.append("t", _delta(9, 1))["rev"] == 3

    def test_failed_log_write_burns_its_revision(self, tmp_path, monkeypatch):
        wal = str(tmp_path)
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=wal)
        real_append = ing._wal.append

        def durable_then_error(entries):
            real_append(entries)
            raise OSError("fsync failed")

        monkeypatch.setattr(ing._wal, "append", durable_then_error)
        with pytest.raises(IngestUnavailableError):
            ing.append("t", {"g": ["nacked"], "v": [-1], "w": [0.0]})
        monkeypatch.undo()
        ack = ing.append("t", {"g": ["acked"], "v": [5], "w": [0.0]})
        assert ack["rev"] == 2
        ing.close()
        del ctx, ing

        ctx2 = _ctx()
        ing2 = ctx2.ingest(wal_dir=wal)
        ing2.recover()
        rows = ctx2.sql_collect("SELECT g FROM t").to_rows()
        assert ("acked",) in rows
        assert ("nacked",) in rows

    def test_snapshot_compaction_recovers_the_same_view(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DATAFUSION_TPU_WAL_SNAPSHOT_BYTES", "1")
        wal = str(tmp_path)
        ctx = _ctx()
        ing = ctx.ingest(wal_dir=wal)
        ing.create_view("mv", VIEW_SQL)
        for i in range(3):
            ing.append("t", _delta(i, 6))
        assert any(n.endswith(".snap") for n in os.listdir(wal))
        want, want_rev = ing.read_view("mv").to_rows(), ing.view("mv").revision
        ing.close()
        ctx2 = _ctx()
        ing2 = ctx2.ingest(wal_dir=wal)
        ing2.recover()
        assert_rows(ing2.read_view("mv").to_rows(), want)
        assert ing2.view("mv").revision == want_rev


# -- the view (tests/test_ingest.py::TestIncrementalViews) ------------


def _cuts():
    """(label, columns) of the JAX test's cuts: an empty delta, one row
    of a new group, wide deltas, a final delta."""
    yield "empty delta", {"g": [], "v": [], "w": []}
    yield "single row, new group", {"g": ["q"], "v": [7], "w": [3.25]}
    for i in range(4):
        yield f"wide delta {i}", _delta(i, 50)
    yield "final delta", _delta(99, 200)


class TestIncrementalViews:
    @pytest.mark.parametrize("fuse", ["1", "0"])
    def test_exact_parity_at_every_cut(self, monkeypatch, fuse):
        """At every cut: the port's view against its own rescan (bit for
        bit under FUSE=0, rtol 1e-9 under the fold) and against the JAX
        package's view (rtol 1e-9 on f64, the rest exactly)."""
        monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
        ctx, jctx = _ctx(), _ctx(jdf)
        ing, jing = ctx.ingest(), jctx.ingest()
        view = ing.create_view("mv", VIEW_SQL)
        jing.create_view("mv", VIEW_SQL)
        assert view.incremental, view.fallback_reason

        def check(cut):
            got = ing.read_view("mv").to_rows()
            assert_rows(got, ctx.sql_collect(VIEW_SQL).to_rows(), exact=fuse == "0",
                        label=f"rescan at {cut}")
            assert_rows(got, jing.read_view("mv").to_rows(), label=f"JAX view at {cut}")

        check("creation fold")
        for cut, cols in _cuts():
            launches0 = view.maintain_launches
            ing.append("t", cols)
            jing.append("t", cols)
            check(cut)
            assert view.maintain_launches == launches0 + (1 if cols["g"] else 0)
        assert view.full_recomputes == 0

    def test_one_pass_and_one_grouped_reduce_per_slot_per_delta(self, monkeypatch):
        """A delta is one device pass tagged view.maintain, and in it one
        grouped reduce for the row count and one per slot not aliased to
        it: SUM(v), SUM(w), MIN(w), MAX(w) (the COUNTs of v and w alias
        the row count)."""
        calls = []
        real = hash_agg.grouped_reduce

        def counting(ids, vals, live, g, kind):
            calls.append((int(ids.shape[0]), g, kind))
            return real(ids, vals, live, g, kind)

        monkeypatch.setattr(hash_agg, "grouped_reduce", counting)
        ctx = _ctx()
        ing = ctx.ingest()
        ing.create_view("mv", VIEW_SQL)
        passes = METRICS.snapshot()["counts"].get("device.launches.view.maintain", 0)
        calls.clear()
        ing.append("t", _delta(0, 50))
        got = METRICS.snapshot()["counts"].get("device.launches.view.maintain", 0) - passes
        assert got == 1
        assert sorted(k for _, _, k in calls) == ["max", "min", "sum", "sum", "sum"]
        assert {n for n, _, _ in calls} == {1024}  # the delta's capacity, not the table's

    def test_fallback_shapes_counted_and_exact(self):
        ctx = _ctx()
        ing = ctx.ingest()
        top = ing.create_view("top", "SELECT g, v FROM t ORDER BY v LIMIT 3")
        assert not top.incremental and top.fallback_reason == "plan_shape"
        smin = ing.create_view("smin", "SELECT MIN(g) FROM t")
        assert not smin.incremental and smin.fallback_reason == "string_minmax"
        ing.append("t", {"g": ["AA"], "v": [-5], "w": [0.0]})
        assert ing.read_view("top").to_rows() == \
            ctx.sql_collect("SELECT g, v FROM t ORDER BY v LIMIT 3").to_rows()
        assert ing.read_view("smin").to_rows() == \
            ctx.sql_collect("SELECT MIN(g) FROM t").to_rows() == [("AA",)]
        assert top.full_recomputes >= 1
        assert METRICS.counts.get("view.fallback.plan_shape", 0) >= 1
        assert METRICS.counts.get("view.fallback.string_minmax", 0) >= 1

    def test_create_view_via_sql(self):
        ctx = _ctx()
        out = ctx.sql_collect(f"CREATE MATERIALIZED VIEW mv AS {VIEW_SQL}")
        assert repr(out) == "Registered materialized view mv (incremental)"
        jctx = _ctx(jdf)
        assert repr(jctx.sql_collect(f"CREATE MATERIALIZED VIEW mv AS {VIEW_SQL}")) == repr(out)
        ing = ctx.ingest()
        assert "mv" in ing.views()
        ing.append("t", _delta(0, 10))
        assert_rows(ing.read_view("mv").to_rows(), ctx.sql_collect(VIEW_SQL).to_rows())

    def test_subscription_wakes_on_advance(self):
        ctx = _ctx()
        ing = ctx.ingest()
        ing.create_view("mv", VIEW_SQL)
        rev0 = ing.view("mv").revision
        assert ing.wait_for("mv", rev0, timeout=0.05) is None

        def feeder():
            time.sleep(0.05)
            ing.append("t", _delta(3, 2))

        th = threading.Thread(target=feeder)
        th.start()
        try:
            got = ing.wait_for("mv", rev0, timeout=10)
        finally:
            th.join()
        assert got == rev0 + 1

    def test_freshness_lags_seam(self, monkeypatch):
        ctx = _ctx()
        view = ctx.ingest().create_view("mv_lag", VIEW_SQL)
        assert ingest_mod.freshness_lags()["mv_lag"] == 0.0
        monkeypatch.setattr(view, "_pending_since", time.monotonic() - 2)
        assert ingest_mod.max_freshness_lag() >= 2.0


# -- what the port adds -----------------------------------------------


@pytest.mark.parametrize("writer,reader", [(jdf, tdf), (tdf, jdf)],
                         ids=["jax_writes_port_recovers", "port_writes_jax_recovers"])
def test_either_package_recovers_the_others_log(tmp_path, writer, reader):
    """A log written by one package's IngestContext (a view and deltas
    with new groups, one empty) recovers in the other to the same table
    and the same view."""
    wal = str(tmp_path)
    ctx = _ctx(writer)
    ing = ctx.ingest(wal_dir=wal)
    ing.create_view("mv", VIEW_SQL)
    for i, (_, cols) in enumerate(_cuts()):
        ing.append("t", cols)
    want_table = sorted(ctx.sql_collect("SELECT g, v, w FROM t").to_rows())
    want_view = ing.read_view("mv").to_rows()
    want_rev = ing.view("mv").revision
    ing.close()

    ctx2 = _ctx(reader)
    ing2 = ctx2.ingest(wal_dir=wal)
    rec = ing2.recover()
    assert rec["appends_replayed"] == 7 and rec["views_recovered"] == 1
    assert sorted(ctx2.sql_collect("SELECT g, v, w FROM t").to_rows()) == want_table
    assert_rows(ing2.read_view("mv").to_rows(), want_view)
    assert ing2.view("mv").revision == want_rev


def test_same_log_bytes_as_the_jax_package(tmp_path):
    """The same appends give the same segment bytes in both packages."""
    logs = []
    for pkg in (jdf, tdf):
        wal = str(tmp_path / pkg.__name__)
        ing = _ctx(pkg).ingest(wal_dir=wal)
        ing.create_view("mv", VIEW_SQL)
        for _, cols in _cuts():
            ing.append("t", cols)
        ing.close()
        logs.append([open(os.path.join(wal, n), "rb").read()
                     for n in sorted(os.listdir(wal)) if n.endswith(".seg")])
    assert logs[0] == logs[1]


NULL_FIELDS = [("g", "UTF8", True), ("v", "INT64", True), ("w", "FLOAT64", True)]
NULL_SQL = "SELECT g, SUM(v), COUNT(v), COUNT(1), AVG(w), MIN(v), MAX(w) FROM t GROUP BY g"


def test_null_bearing_deltas_against_the_jax_package():
    cols = _base_columns(200, seed=4)
    rng = np.random.default_rng(5)
    validity = [rng.random(200) > 0.1, rng.random(200) > 0.2, rng.random(200) > 0.2]
    cols[0] = [s if ok else None for s, ok in zip(cols[0], validity[0])]
    ctx = _ctx(fields=NULL_FIELDS, columns=cols, validity=validity)
    jctx = _ctx(jdf, fields=NULL_FIELDS, columns=cols, validity=validity)
    ing, jing = ctx.ingest(), jctx.ingest()
    assert ing.create_view("mv", NULL_SQL).incremental
    jing.create_view("mv", NULL_SQL)
    deltas = [{"g": [None, "g1", "new"], "v": [None, 4, 5], "w": [1.5, None, 2.5]},
              {"g": ["g2", None], "v": [7, None], "w": [None, None]}]
    for d in deltas:
        ing.append("t", d)
        jing.append("t", d)
        got = ing.read_view("mv").to_rows()
        assert_rows(got, jing.read_view("mv").to_rows())
        assert_rows(got, ctx.sql_collect(NULL_SQL).to_rows())
        assert any(r[0] is None for r in got)


def test_capacity_growth_past_agg_max_groups_mid_stream(monkeypatch):
    """With the grouped reduce's limit at 16 groups, deltas that bring
    the view to 61 groups grow its state and move it to the sort-merge
    route; the rows match the JAX package's view and the port's rescan,
    and the ids and codes of the earlier keys stay where they were."""
    monkeypatch.setenv("DATAFUSION_TPU_PALLAS_AGG_GROUPS", "16")
    sorts = []
    real_sort = sort_kernel.argsort_i64

    def counting_sort(keys):
        sorts.append(int(keys.shape[0]))
        return real_sort(keys)

    monkeypatch.setattr(sort_kernel, "argsort_i64", counting_sort)
    ctx, jctx = _ctx(), _ctx(jdf)
    ing, jing = ctx.ingest(), jctx.ingest()
    view = ing.create_view("mv", VIEW_SQL)
    jing.create_view("mv", VIEW_SQL)
    src = ing._tables["t"]
    codes0 = list(src._dicts[0].values)
    keys0, _ = view._agg.encoder.key_column(0)
    assert view._state[0].shape[0] == 8 and not sorts
    for i in range(4):
        rng = np.random.default_rng(40 + i)
        n = 30
        cols = {"g": [f"n{j}" for j in rng.integers(0, 56, n)],
                "v": [int(x) for x in rng.integers(0, 10, n)],
                "w": [float(x) for x in rng.uniform(0, 1, n).round(4)]}
        ing.append("t", cols)
        jing.append("t", cols)
        got = ing.read_view("mv").to_rows()
        assert_rows(got, jing.read_view("mv").to_rows(), label=f"delta {i}")
        assert_rows(got, ctx.sql_collect(VIEW_SQL).to_rows(), label=f"rescan {i}")
    assert view._state[0].shape[0] > 16
    assert sorts, "the fold never took the sort-merge route"
    assert src._dicts[0].values[:len(codes0)] == codes0
    keys1, _ = view._agg.encoder.key_column(0)
    assert np.array_equal(keys1[:len(keys0)], keys0)


def test_f32_slots_within_the_higham_mary_bound():
    """An f32 SUM and AVG folded over deltas keep the bound of
    tests/test_torch_f32_sum.py against an f64 oracle over every row."""
    keys, vals, valid = f32.table(24_000, 8, seed=13)
    fields = [("k", "INT64", False), ("x", "FLOAT32", True)]
    base = 8192
    ctx = _ctx(fields=fields, columns=[keys[:base], vals[:base]],
               validity=[None, valid[:base]])
    ing = ctx.ingest()
    view = ing.create_view("mv", f32.SQL)
    assert view.incremental
    for lo in range(base, len(keys), 4000):
        sl = slice(lo, lo + 4000)
        ing.append("t", {"k": keys[sl], "x": [float(x) if ok else None
                                              for x, ok in zip(vals[sl], valid[sl])]})
    got = f32.ratios(ing.read_view("mv").to_rows(), f32.oracle(keys, vals, valid))
    assert got["sum_ratio"] <= 1.0 and got["avg_ratio"] <= 1.0, got


def test_repeated_runs_give_the_same_bits():
    def run():
        ctx = _ctx()
        ing = ctx.ingest()
        ing.create_view("mv", VIEW_SQL)
        for _, cols in _cuts():
            ing.append("t", cols)
        return ing.read_view("mv").to_rows()

    assert_rows(run(), run(), exact=True)


def test_console_ingest_and_append_text_matches_the_jax_package():
    import io

    from datafusion_tpu import cli as jcli

    from datafusion_tpu_torch import cli as tcli

    outs = []
    for pkg, mod in ((jdf, jcli), (tdf, tcli)):
        ctx = _ctx(pkg)
        buf = io.StringIO()
        console = mod.Console(ctx, out=buf)
        for cmd in ("\\ingest", f"CREATE MATERIALIZED VIEW mv AS {VIEW_SQL}",
                    '\\append t {"g": ["a", "b"], "v": [1, 2], "w": [0.5, 1.5]}',
                    '\\append t {"g": ["a"]}', "\\append t", '\\append t {bad',
                    "\\ingest"):
            console.execute(cmd)
        outs.append([re.sub(r"lag [0-9.]+ ms", "lag - ms", ln)
                     for ln in buf.getvalue().splitlines() if "seconds" not in ln])
    assert outs[0] == outs[1]
    assert "  view mv ON t: rev 2, incremental, lag - ms, 2 maintain launch(es)" in outs[1]
    assert "Appended 2 row(s) to t (rev 2; views advanced: mv@r2)" in outs[1]
