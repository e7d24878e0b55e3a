"""PyTorch/CUDA port: feedback-driven planning (`datafusion_tpu_torch.cost`).

The cases of the JAX package's `tests/test_cost.py`, on the port with
`device="cpu"`, each held against the JAX package where both packages
decide the same thing:

- the same `CostStore` snapshot after the same observations, and the
  store's persistence (restart, throttle, corrupt and foreign files,
  the entry budget);
- a store file written by either package loads in the other; a JAX
  store keeps its table statistics in the port and leaves the port's
  grouped-reduce window at 8192 (its Pallas route history is not read);
- the same table keys for a file and an appendable table's append
  serial, and the same version bumps; an in-memory table keys by its
  source's data identity (the JAX package: by catalog version, which
  contexts of one process share);
- the adaptive loop on the same tables (made from a numpy seed): the
  same observations, the same `agg.capacity` and `join.build_side`
  decisions, the same rewritten plan (wire JSON) and the same sorted
  rows (ints, strings and counts exactly, f64 within rtol 1e-9), the
  same replans and rows under a poisoned store;
- `DATAFUSION_TPU_COST=0`: zero decisions and the same rows;
- the advisor: the same estimates and serving windows, and the JAX
  package's `pallas_agg_window` rule over the port's two routes, which
  then routes a 12,000-group aggregate;
- EXPLAIN ANALYZE's cost view and the console's `\\cost`.

Every test owns both packages' process stores (a fixture resets them).
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu import cost as jcost
from datafusion_tpu.cost import advisor as jadvisor
from datafusion_tpu.cost.optimizer import apply_cost_rewrites as japply
from datafusion_tpu.cost.store import CostStore as JaxCostStore
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.obs.device import LEDGER as JAX_LEDGER

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import cost as tcost
from datafusion_tpu_torch.cost import advisor as tadvisor
from datafusion_tpu_torch.cost.optimizer import apply_cost_rewrites as tapply
from datafusion_tpu_torch.cost.store import _MAX_ENTRIES, CostStore
from datafusion_tpu_torch.exec.cuda import agg_max_groups
from datafusion_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import assert_same, carry, jax_table

T = jdf.DataType
_ENV = ("DATAFUSION_TPU_COST", "DATAFUSION_TPU_COST_DIR",
        "DATAFUSION_TPU_PALLAS_AGG_GROUPS")


@pytest.fixture(autouse=True)
def _fresh_stores():
    """Each test owns both process stores and the cost knobs (and the JAX
    package's ledger, which pins an in-memory join build by table name
    process-wide)."""
    saved = {k: os.environ.pop(k, None) for k in _ENV}
    JAX_LEDGER.clear()
    jcost.reset_store()
    tcost.reset_store()
    yield
    jcost.reset_store()
    tcost.reset_store()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _strip_ts(obj):
    """A snapshot without its wall-clock stamps."""
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k not in ("ts", "path")}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def _kv_table(seed: int, groups: int = 4, rows: int = 200, batch_rows: int = 2048):
    rng = np.random.default_rng(seed)
    keys = np.array([f"g{i}" for i in range(groups)], dtype=object)
    return jax_table([("k", T.UTF8, False), ("v", T.FLOAT64, False)],
                     [keys[rng.integers(0, groups, rows)],
                      rng.uniform(0, 100, rows).round(3)], batch_rows=batch_rows)


def _contexts(tables: dict):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    for name, src in tables.items():
        jctx.register_datasource(name, src)
        tctx.register_datasource(name, carry(src))
    return jctx, tctx


SQL = "SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k"


def _both(jctx, tctx, sql=SQL):
    """Run `sql` on both contexts; the port's rows must be the JAX
    package's (sorted)."""
    want = jax_collect(jctx.sql(sql))
    got = tdf.collect(tctx.sql(sql))
    return assert_same(got, want, ordered=False)


def _decisions(store, name):
    return [d for d in store.decisions if d["decision"] == name]


# -- store mechanics --------------------------------------------------------

OBSERVATIONS = [
    [("t", "scan", {"rows": 100}), ("t", "scan", {"rows": 10})],
    [("t1", "scan", {"rows": 5, "nbytes": 40}), ("t1", "agg:g=k", {"groups": 2}),
     ("t2", "scan", {"rows": 9}), ("t1", "agg:g=k", {"groups": 7})],
    [("__serve__", "arrivals", {"interval_s": 0.004}),
     ("__serve__", "arrivals", {"interval_s": 0.0005})],
]


@pytest.mark.parametrize("obs", OBSERVATIONS)
def test_same_snapshot_after_the_same_observations(obs):
    js, ts = JaxCostStore(), CostStore()
    for tkey, shape, fields in obs:
        js.observe(tkey, shape, **fields)
        ts.observe(tkey, shape, **fields)
    for st in (js, ts):
        st.note_decision("agg.capacity", 8, "grow-on-demand from 8", "why", table="t")
        st.note_replan("aggregate.capacity", 4000, 4, "pre-size aborted")
    assert _strip_ts(ts.snapshot()) == _strip_ts(js.snapshot())
    assert ts.value("t", "scan", "rows_max") == js.value("t", "scan", "rows_max")


def test_value_defaults_and_decision_serials():
    st = CostStore()
    assert st.value("t", "scan", "rows") is None
    assert st.value("t", "scan", "rows", 7) == 7
    st.observe("t", "scan", rows=3)
    assert st.value("t", "scan", "rows_last", 7) == 3
    a = st.note_decision("x", 1, 2, "because")
    b = st.note_decision("y", 3, 4, "because", table="t")
    assert b["seq"] == a["seq"] + 1 and b["table"] == "t"


# -- persistence ----------------------------------------------------------------


def test_store_survives_restart_and_flush_throttles(tmp_path):
    os.environ["DATAFUSION_TPU_COST_DIR"] = str(tmp_path)
    tcost.reset_store()
    st = tcost.store()
    st.observe("t@s1", "scan", rows=123)
    assert st.flush(force=True)
    st.observe("t@s1", "scan", rows=2)
    assert not st.flush()  # inside the save interval
    tcost.reset_store()
    st2 = tcost.store()
    assert st2 is not st and st2.value("t@s1", "scan", "rows_last") == 123


def test_corrupt_and_foreign_files_degrade_to_empty(tmp_path):
    path = tmp_path / "cost_store.json"
    path.write_text('{"version": 1, "entries": {"t\\tscan"')
    before = METRICS.counts.get("cost.store.corrupt", 0)
    assert len(CostStore(str(path))) == 0
    assert METRICS.counts.get("cost.store.corrupt", 0) == before + 1
    path.write_text(json.dumps({"version": 999, "entries": {"t\tscan": {"n": 1}}}))
    assert len(CostStore(str(path))) == 0
    # planning over the empty store still answers
    os.environ["DATAFUSION_TPU_COST_DIR"] = str(tmp_path)
    tcost.reset_store()
    jcost.reset_store()
    _both(*_contexts({"t": _kv_table(1)}))


def test_flush_prunes_to_the_entry_budget(tmp_path):
    path = str(tmp_path / "cost_store.json")
    st = CostStore(path)
    for i in range(_MAX_ENTRIES + 10):
        st.observe(f"t{i}", "scan", rows=i)
    assert st.flush(force=True)
    with open(path, encoding="utf-8") as f:
        assert len(json.load(f)["entries"]) == _MAX_ENTRIES


def _trained_pair(seed=2):
    jctx, tctx = _contexts({"t": _kv_table(seed, groups=6)})
    _both(jctx, tctx)
    return jctx, tctx


def _csv_pair(tmp_path, seed=2, rows=300):
    """The same CSV table registered in both packages (file-backed: the
    two packages key it alike)."""
    rng = np.random.default_rng(seed)
    p = tmp_path / "t.csv"
    keys = rng.integers(0, 6, rows)
    vals = rng.uniform(0, 100, rows).round(3)
    p.write_text("k,v\n" + "".join(f"g{k},{v}\n" for k, v in zip(keys, vals)))
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_csv("t", str(p), jdf.Schema([jdf.Field("k", T.UTF8, False),
                                               jdf.Field("v", T.FLOAT64, False)]))
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_csv("t", str(p), tdf.Schema([tdf.Field("k", tdf.DataType.UTF8, False),
                                               tdf.Field("v", tdf.DataType.FLOAT64, False)]))
    return jctx, tctx


def test_a_store_written_by_either_package_loads_in_the_other(tmp_path):
    """The file format is the JAX package's: each package loads the
    other's `cost_store.json` with its table statistics (a CSV table:
    both key it by the file).  The JAX package's Pallas route history
    (faster than sort-merge at the ceiling, which widens its own window)
    loads too, and the port's grouped-reduce window stays at 8192: it
    reads only its own routes."""
    jctx, tctx = _csv_pair(tmp_path)
    _both(jctx, tctx)
    tkey = tctx.cost_table_key("t")
    assert tkey == jctx.cost_table_key("t")
    js = jcost.store()
    for _ in range(4):
        jadvisor.observe_agg_route(js, "pallas", 8192, 0.1, 1 << 20)
        jadvisor.observe_agg_route(js, "sortmerge", 8192, 1.0, 1 << 20)
    assert jadvisor.pallas_agg_window(js) == 16384
    jpath = tmp_path / "jax"
    js._path = str(jpath / "cost_store.json")
    assert js.flush(force=True)
    os.environ["DATAFUSION_TPU_COST_DIR"] = str(jpath)
    tcost.reset_store()
    ts = tcost.store()
    assert ts.lookup(tkey, "agg:g=k") == js.lookup(tkey, "agg:g=k")
    assert ts.lookup(tkey, "scan") == js.lookup(tkey, "scan")
    assert tadvisor.agg_window(ts) == agg_max_groups() == 8192
    # the loaded statistics presize the port's next run of the query
    _both(jctx, tctx)
    assert _decisions(ts, "agg.capacity")[-1]["reason"] == "observed ~6 groups for agg:g=k"
    # ... and the port's own file loads in the JAX package
    tpath = tmp_path / "port"
    ts._path = str(tpath / "cost_store.json")
    ts._dirty = True
    assert ts.flush(force=True)
    os.environ["DATAFUSION_TPU_COST_DIR"] = str(tpath)
    jcost.reset_store()
    assert _strip_ts(jcost.store().snapshot()["tables"]) == _strip_ts(ts.snapshot()["tables"])


# -- table keys -------------------------------------------------------------


def test_table_keys_equal_the_jax_package_and_retire_on_version_bumps(tmp_path, monkeypatch):
    p = tmp_path / "t.csv"
    p.write_text("k,v\na,1\nb,2\n")
    schema_j = jdf.Schema([jdf.Field("k", T.UTF8, False), jdf.Field("v", T.FLOAT64, False)])
    schema_t = tdf.Schema([tdf.Field("k", tdf.DataType.UTF8, False),
                           tdf.Field("v", tdf.DataType.FLOAT64, False)])

    def keys():
        jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        jctx.register_csv("t", str(p), schema_j)
        tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
        tctx.register_csv("t", str(p), schema_t)
        return jctx.cost_table_key("t"), tctx.cost_table_key("t")

    jk, tk = keys()
    assert tk == jk and "@s" in tk
    assert keys()[1] == tk  # the same file after a restart
    p.write_text("k,v\na,1\nb,2\nc,3\nd,4\n")
    assert keys()[1] != tk  # a rewritten file
    # in memory: the source's data identity (the JAX package: the
    # catalog version, which contexts share); a new source, a new key
    jctx, tctx = _contexts({"t": _kv_table(3)})
    assert jctx.cost_table_key("t") == "t@c1"
    key = tctx.cost_table_key("t")
    assert key.startswith("t@m")
    other = tdf.ExecutionContext(device="cpu", result_cache=False)
    other.register_datasource("t", carry(_kv_table(4)))
    assert other.cost_table_key("t") != key  # another context, other data
    other.register_datasource("t", tctx.datasources["t"])
    assert other.cost_table_key("t") == key  # the same data
    tctx.register_datasource("t", carry(_kv_table(4)))
    assert tctx.cost_table_key("t") != key
    # another process numbers its sources anew: its nonce keeps it off
    # this process's persisted statistics
    monkeypatch.setattr(tcost, "_PROCESS_NONCE", "another process")
    assert other.cost_table_key("t") != key


def test_an_append_bumps_the_key_as_in_the_jax_package():
    from datafusion_tpu.ingest import AppendableSource as JaxAppendable

    from datafusion_tpu_torch.ingest import AppendableSource

    src = _kv_table(5)
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jsrc = JaxAppendable.wrap(src, "t")
    jctx.register_datasource("t", jsrc)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tsrc = AppendableSource.wrap(carry(src), "t")
    tctx.register_datasource("t", tsrc)
    key0 = tctx.cost_table_key("t")
    assert key0.split("@")[:2] == jctx.cost_table_key("t").split("@")[:2] == ["t", "d0"]
    jsrc.append_batch(jsrc.build_batch({"k": ["z"], "v": [9.0]}))
    tsrc.append_batch(tsrc.build_batch({"k": ["z"], "v": [9.0]}))
    assert tctx.cost_table_key("t").split("@")[:2] == ["t", "d1"]
    assert jctx.cost_table_key("t").split("@")[:2] == ["t", "d1"]
    assert tctx.cost_table_key("t") != key0


# -- the adaptive loop ------------------------------------------------------------


def test_scan_and_groups_observed_as_in_the_jax_package():
    jctx, tctx = _trained_pair(6)
    tkey, jkey = tctx.cost_table_key("t"), jctx.cost_table_key("t")
    js, ts = jcost.store(), tcost.store()
    for shape, field in (("scan", "rows_last"), ("agg:g=k", "groups_last")):
        assert ts.value(tkey, shape, field) == js.value(jkey, shape, field)
    assert ts.value(tkey, "scan", "rows_last") == 200
    assert ts.value(tkey, "agg:g=k", "groups_last") == 6


def test_trained_store_presizes_the_aggregate():
    jctx, tctx = _trained_pair(7)
    _both(jctx, tctx)
    want = _decisions(jcost.store(), "agg.capacity")
    got = _decisions(tcost.store(), "agg.capacity")
    assert len(got) == len(want) == 1
    keep = ("decision", "chosen", "default", "reason", "table", "seq")
    assert {k: got[0][k] for k in keep} == {k: want[0][k] for k in keep}


def _star(seed=8, n_small=5, n_big=500):
    rng = np.random.default_rng(seed)
    small = jax_table([("id", T.INT64, False), ("name", T.UTF8, False)],
                      [np.arange(n_small), np.array([f"n{i}" for i in range(n_small)],
                                                    dtype=object)])
    big = jax_table([("fk", T.INT64, False), ("x", T.FLOAT64, False)],
                    [rng.integers(0, n_small, n_big), rng.uniform(0, 10, n_big).round(2)])
    return {"small": small, "big": big}


JOIN_SQL = "SELECT name, SUM(x), COUNT(1) FROM small JOIN big ON id = fk GROUP BY name"


def test_join_build_side_swap_rewrites_the_same_plan():
    jctx, tctx = _contexts(_star())
    cold = _both(jctx, tctx, JOIN_SQL)  # observes both scans and the build
    # the rewrite of the static plan, from both packages' trained stores
    from datafusion_tpu.exec.context import _ContextSchemaProvider as JProvider
    from datafusion_tpu.sql.optimizer import push_down_projection as jpush
    from datafusion_tpu.sql.parser import parse_sql as jparse
    from datafusion_tpu.sql.planner import SqlToRel as JSqlToRel

    from datafusion_tpu_torch.exec.context import _ContextSchemaProvider as TProvider
    from datafusion_tpu_torch.sql.optimizer import push_down_projection as tpush
    from datafusion_tpu_torch.sql.parser import parse_sql as tparse
    from datafusion_tpu_torch.sql.planner import SqlToRel as TSqlToRel

    jplan = jpush(JSqlToRel(JProvider(jctx)).sql_to_rel(jparse(JOIN_SQL)))
    tplan = tpush(TSqlToRel(TProvider(tctx)).sql_to_rel(tparse(JOIN_SQL)))
    assert tplan.to_json() == jplan.to_json()
    jnew, tnew = japply(jctx, jplan), tapply(tctx, tplan)
    assert tnew is not tplan and tnew.to_json() == jnew.to_json()
    trained = _both(jctx, tctx, JOIN_SQL)  # builds over `small` now
    assert sorted(trained, key=repr) == sorted(cold, key=repr)
    got = _decisions(tcost.store(), "join.build_side")
    want = _decisions(jcost.store(), "join.build_side")
    assert got and [(d["chosen"], d["default"], d["reason"]) for d in got] == [
        (d["chosen"], d["default"], d["reason"]) for d in want]
    assert got[-1]["chosen"] == "left"


def test_misestimate_replans_with_the_exact_answer():
    jctx, tctx = _trained_pair(9)
    want = _both(jctx, tctx)
    tkey = tctx.cost_table_key("t")
    # poison both stores: thousands of groups for this shape
    jcost.store().observe(jctx.cost_table_key("t"), "agg:g=k", groups=4000)
    tcost.store().observe(tkey, "agg:g=k", groups=4000)
    before = METRICS.counts.get("plan.replans", 0)
    assert _both(jctx, tctx) == want
    assert METRICS.counts.get("plan.replans", 0) == before + 1
    keep = ("what", "estimate", "actual", "action")
    got, jrp = list(tcost.store().replans), list(jcost.store().replans)
    assert [{k: r[k] for k in keep} for r in got] == [{k: r[k] for k in keep} for r in jrp]
    assert got[-1]["estimate"] == 4000 and got[-1]["actual"] == 6
    assert tcost.store().value(tkey, "agg:g=k", "groups_last") == 6


def test_replan_ratio_bounds_the_replan(monkeypatch):
    monkeypatch.setattr(tcost, "replan_ratio", lambda: 1e6)
    jctx, tctx = _trained_pair(10)
    want = _both(jctx, tctx)
    tcost.store().observe(tctx.cost_table_key("t"), "agg:g=k", groups=4000)
    before = METRICS.counts.get("plan.replans", 0)
    assert sorted(tdf.collect(tctx.sql(SQL)).to_rows(), key=repr) == want
    assert METRICS.counts.get("plan.replans", 0) == before


def test_cost_off_makes_no_decision_and_the_same_rows():
    """DATAFUSION_TPU_COST=0: static planning (no decision, the static
    plan of a join that a trained store would swap), the same rows;
    observation still flows."""
    jctx, tctx = _contexts(_star(11))
    cold = _both(jctx, tctx, JOIN_SQL)
    os.environ["DATAFUSION_TPU_COST"] = "0"
    assert _both(jctx, tctx, JOIN_SQL) == cold
    assert _both(jctx, tctx, JOIN_SQL) == cold
    assert not list(tcost.store().decisions)
    assert tcost.store().value(tctx.cost_table_key("big"), "scan", "rows_last") == 500


def test_explain_analyze_renders_decisions_and_replans():
    jctx, tctx = _trained_pair(12)
    res = tctx.sql("EXPLAIN ANALYZE " + SQL)
    rep = res.report()
    assert "Cost decisions (1):" in rep and "agg.capacity" in rep and "default" in rep
    tcost.store().observe(tctx.cost_table_key("t"), "agg:g=k", groups=4000)
    res = tctx.sql("EXPLAIN ANALYZE " + SQL)
    assert "Replans (1):" in res.report() and res.cost["replans"]


def test_console_cost_command():
    from datafusion_tpu_torch.cli import Console

    jctx, tctx = _trained_pair(13)
    tdf.collect(tctx.sql(SQL))
    out = io.StringIO()
    assert Console(tctx, out=out).handle_command("\\cost")
    text = out.getvalue()
    assert "Cost store:" in text and "agg:g=k" in text and "decision agg.capacity" in text
    json.dumps(tcost.store().snapshot())


# -- the advisor --------------------------------------------------------------


def test_advisor_estimates_equal_the_jax_package():
    jctx, tctx = _trained_pair(14)
    tkey, jkey = tctx.cost_table_key("t"), jctx.cost_table_key("t")
    js, ts = jcost.store(), tcost.store()
    assert tadvisor.agg_shape(["b", "a"]) == jadvisor.agg_shape(["b", "a"]) == "agg:g=a,b"
    assert tadvisor.agg_group_estimate(ts, tkey, ["k"]) == \
        jadvisor.agg_group_estimate(js, jkey, ["k"]) == 6
    assert tadvisor.table_rows(ts, tkey) == jadvisor.table_rows(js, jkey) == 200
    assert tadvisor.agg_group_estimate(ts, "nope", ["k"]) is None


@pytest.mark.parametrize("interval_s", [1.0, 0.004, 0.0001, 0.0])
def test_serve_window_equals_the_jax_package(interval_s):
    js, ts = JaxCostStore(), CostStore()
    if interval_s:
        js.observe(jcost.SERVE_KEY, "arrivals", interval_s=interval_s)
        ts.observe(tcost.SERVE_KEY, "arrivals", interval_s=interval_s)
    assert tadvisor.serve_window_s(ts, 0.002) == jadvisor.serve_window_s(js, 0.002)


# (grouped-reduce s, sort-merge s, capacity, samples) per route
WINDOW_CASES = [
    (1.0, 0.1, 1024, 4),   # the grouped reduce is slower: window 0
    (0.1, 1.0, 8192, 4),   # faster at the ceiling: window doubles
    (0.1, 1.0, 4096, 4),   # faster, never at the ceiling: static
    (0.1, 1.0, 8192, 2),   # too few samples: static
    (1.0, 0.9, 8192, 4),   # within 1.5x: static
]


@pytest.mark.parametrize("red_s,srt_s,cap,samples", WINDOW_CASES)
def test_window_rule_is_the_jax_package_rule_over_the_port_routes(red_s, srt_s, cap,
                                                                   samples):
    js, ts = JaxCostStore(), CostStore()
    rows = 1 << 20
    for _ in range(samples):
        jadvisor.observe_agg_route(js, "pallas", cap, red_s, rows)
        jadvisor.observe_agg_route(js, "sortmerge", cap, srt_s, rows)
        tadvisor.observe_agg_route(ts, "grouped_reduce", cap, red_s, rows)
        tadvisor.observe_agg_route(ts, "sortmerge", cap, srt_s, rows)
    assert tadvisor.agg_window(ts) == jadvisor.pallas_agg_window(js)
    keep = ("chosen", "default", "reason")
    norm = [{k: d[k] for k in keep} for d in js.decisions]
    for d in norm:
        d["reason"] = d["reason"].replace("pallas", "grouped reduce")
    assert [{k: d[k] for k in keep} for d in ts.decisions] == norm
    # the port's history lives under its own key, not the Pallas one
    assert ts.lookup(tcost.PALLAS_KEY, "agg:sortmerge") is None


def test_small_passes_are_not_route_evidence():
    ts = CostStore()
    tadvisor.observe_agg_route(ts, "grouped_reduce", 8, 0.01, 1000)
    tadvisor.observe_sort_route(ts, "radix", 1000, 0.01)
    assert len(ts) == 0
    tadvisor.observe_sort_route(ts, "radix", 1 << 17, 0.01)
    assert ts.lookup(tcost.CUDA_KEY, "sort:radix")["n"] == 1


@pytest.mark.parametrize("widen", [True, False])
def test_the_learned_window_routes_a_12000_group_aggregate(widen):
    """The window decides the route of a capacity of 16,384: the
    grouped reduce when the store widened it, sort-merge otherwise;
    the rows equal the JAX package's either way."""
    ts = tcost.store()
    rows = 1 << 20
    for _ in range(3):
        tadvisor.observe_agg_route(ts, "grouped_reduce", 8192, 0.1 if widen else 1.0, rows)
        tadvisor.observe_agg_route(ts, "sortmerge", 131072, 1.0 if widen else 0.9, rows)
    window = tadvisor.agg_window()
    assert window == (16384 if widen else 8192)
    rng = np.random.default_rng(15)
    n, groups = 30_000, 12_000
    src = jax_table([("k", T.INT64, False), ("v", T.FLOAT64, False)],
                    [np.arange(n) % groups, rng.uniform(0, 1, n).round(4)], batch_rows=8192)
    jctx, tctx = _contexts({"g": src})
    sql = "SELECT k, SUM(v), MIN(v), COUNT(1) FROM g GROUP BY k"
    rel = tctx.sql(sql)
    got = tdf.collect(rel)
    assert_same(got, jax_collect(jctx.sql(sql)), ordered=False)
    assert rel._cost_route == ("grouped_reduce" if widen else "sortmerge", 16384)
    if widen:
        assert _decisions(ts, "agg.window")[-1]["chosen"] == 16384
