"""PyTorch/CUDA port, slice 16: fleet observability against the JAX
package (`datafusion_tpu_torch/obs/{recorder,aggregate,otlp,slo}.py`,
the per-query funnel, the device ledger's leak sweep and flight events,
the pin's measured bytes, the serving streams, the worker's `telemetry`
and `flight_dump` requests, the coordinator's fleet view and the
console's `top` and `debug-bundle` modes).

- The flight recorder, mirrored from `tests/test_telemetry.py`: ring
  wraparound, concurrent emit, the disabled no-op, dump and throttle,
  the crash hook chaining to the previous hook.
- Pure functions, exactly equal to the JAX package's on the same inputs
  from a numpy seed: OTLP documents and their round trip, histogram
  quantiles, merges and the overflow lower bound, fleet merges and
  gauges, SLO rows and `max_burn_rate` under one fixed clock, the
  environment's SLO declarations.
- The funnel on `ExecutionContext(device="cpu")`: a query's flight
  events and histogram sample, a failed query's artifact set, a slow
  query's capture, EXPLAIN ANALYZE and a plain traced query exporting
  OTLP once each, the tail explainer fed for a plain query and not for
  a served one, ``obs.telemetry_errors`` at 0.
- The ledger: a transient buffer held past the grace reports one leak at
  the second sweep; cache entries and pins never; the switch publishes
  no gauge; `device.h2d` events carry `h2d.bytes`.  The pin's accounted
  bytes after a served query are its cached tensors' storage bytes.
- Worker processes (`--device cpu --http-port -1`): `telemetry` and
  `flight_dump`, the port's coordinator over two port workers and over a
  JAX worker, the JAX package's coordinator over port workers, and the
  console's modes over them.

The JAX package's `TestClusterTelemetryPiggyback` is held with the
cluster, in `tests/test_torch_cluster.py`.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from datafusion_tpu.obs import aggregate as jagg
from datafusion_tpu.obs import otlp as jotlp
from datafusion_tpu.obs import slo as jslo

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.obs import aggregate, attribution, otlp, recorder, slo
from datafusion_tpu_torch.obs import device as pdevice
from datafusion_tpu_torch.utils.metrics import METRICS

REPO = Path(__file__).resolve().parents[1]


def _schema():
    T = tdf.DataType
    return tdf.Schema([tdf.Field("region", T.UTF8, False), tdf.Field("v", T.INT64, False)])


def _write_csv(path, rows=200, seed=3):
    rng = np.random.default_rng(seed)
    regions = ["north", "south", "east", "west"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("region,v\n")
        for _ in range(rows):
            f.write(f"{regions[rng.integers(0, 4)]},{int(rng.integers(-100, 100))}\n")
    return str(path)


def _count(name):
    return METRICS.snapshot()["counts"].get(name, 0)


@pytest.fixture()
def flight(tmp_path):
    """The recorder scoped to one test: a fresh ring, a temporary dump
    directory, no throttle; every knob restored afterwards."""
    saved = (recorder._ENABLED, recorder._CAP, recorder._SLOW_S, recorder._DIR,
             recorder._DUMP_INTERVAL_S)
    recorder.configure(enabled=True, directory=str(tmp_path), dump_interval_s=0.0)
    recorder.clear()
    yield recorder
    recorder.configure(enabled=saved[0], capacity=saved[1], slow_s=saved[2],
                       directory=saved[3], dump_interval_s=saved[4])
    recorder.clear()


@pytest.fixture()
def ctx(tmp_path):
    c = tdf.ExecutionContext(device="cpu")  # the result cache on, as by default
    c.register_csv("t", _write_csv(tmp_path / "t.csv"), _schema())
    return c


def _dumps(directory, reason=None):
    docs = [json.loads(open(p, encoding="utf-8").read())
            for p in glob.glob(os.path.join(str(directory), "flight-*.json"))]
    return [d for d in docs if reason is None or d["reason"] == reason]


# ---------------------------------------------------------- recorder


def test_emit_snapshot_and_trace_correlation(flight):
    from datafusion_tpu_torch.obs import trace

    recorder.record("a", x=1)
    with trace.session() as tc:
        recorder.record("b", y="z")
    trace.drain(tc.trace_id)
    ev = recorder.events()
    assert [e["kind"] for e in ev] == ["a", "b"]
    assert ev[0]["attrs"] == {"x": 1} and "trace_id" not in ev[0]
    assert ev[1]["trace_id"] == tc.trace_id
    assert [e["kind"] for e in recorder.events(trace_id=tc.trace_id)] == ["b"]
    assert [e["kind"] for e in recorder.events("a")] == ["a"]


def test_ring_wraparound(flight):
    recorder.configure(capacity=16)
    for i in range(40):
        recorder.record("e", i=i)
    ev = recorder.events()
    assert [e["attrs"]["i"] for e in ev] == list(range(24, 40))
    assert recorder.emitted() == 40  # the total survives the wrap


def test_concurrent_emit(flight):
    recorder.configure(capacity=1024)
    n_threads, per = 8, 2000
    errors = []

    def emit(t):
        try:
            for i in range(per):
                recorder.record("c", t=t, i=i)
        except Exception as e:  # noqa: BLE001 — collected and asserted empty
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=emit, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert recorder.emitted() == n_threads * per  # no emission lost
    ev = recorder.events()
    assert len(ev) == 1024 and all(e["kind"] == "c" for e in ev)


def test_disabled_is_noop(flight):
    recorder.configure(enabled=False)
    before = recorder.emitted()
    recorder.record("x")
    assert recorder.emitted() == before
    assert recorder.auto_capture("nope") is None


def test_dump_and_throttle(flight):
    recorder.record("a")
    doc = json.loads(open(recorder.dump("manual"), encoding="utf-8").read())
    assert doc["reason"] == "manual" and doc["events"][0]["kind"] == "a"
    assert doc["node"].split(":")[0] in ("main", "worker")
    recorder.configure(dump_interval_s=1000.0)
    throttled = _count("flight.dumps_throttled")
    assert recorder.auto_capture("one") is not None
    assert recorder.auto_capture("two") is None
    assert _count("flight.dumps_throttled") == throttled + 1


def test_crash_hook_dumps_and_chains(flight):
    calls = []
    prev, recorder._hook_installed = sys.excepthook, False
    sys.excepthook = lambda *a: calls.append(a)
    try:
        recorder.install_crash_hook()
        recorder.record("before-crash")
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        assert len(calls) == 1  # chained to the previous hook
        assert any("boom" in d.get("error", "") for d in _dumps(recorder.dump_dir(), "crash"))
    finally:
        sys.excepthook = prev
        recorder._hook_installed = False
        recorder._prev_excepthook = None


# -------------------------------------------------------------- OTLP


def _span_dicts(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        start = int(rng.integers(1, 10**12))
        attrs = {"n": int(rng.integers(-5, 5)), "f": float(rng.random()),
                 "ok": bool(rng.integers(0, 2)), "s": f"x{i}"}
        out.append({"name": f"op.{i}", "trace_id": f"{rng.integers(0, 2**60):x}",
                    "span_id": f"{rng.integers(0, 2**60):x}",
                    "parent_id": None if i == 0 else f"{rng.integers(0, 2**60):x}",
                    "start_ns": start, "end_ns": start + int(rng.integers(1, 10**6)),
                    "attrs": attrs if i % 3 else {}, "tid": int(rng.integers(0, 2**40)),
                    "proc": ["main:1", "worker:2", "worker:3"][i % 3]})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otlp_document_equals_the_jax_package(seed):
    spans = _span_dicts(seed)
    doc = otlp.spans_to_otlp(spans)
    assert json.dumps(doc) == json.dumps(jotlp.spans_to_otlp(spans))
    assert otlp.otlp_to_spans(doc) == jotlp.otlp_to_spans(doc)


def test_otlp_round_trip():
    spans = _span_dicts(5)
    back = {s["name"]: s for s in otlp.otlp_to_spans(otlp.spans_to_otlp(spans))}
    for sp in spans:
        got = back[sp["name"]]
        assert got["attrs"] == sp["attrs"] and got["proc"] == sp["proc"]
        assert got["start_ns"] == sp["start_ns"] and got["end_ns"] == sp["end_ns"]
        assert got["tid"] == sp["tid"]
        assert got["span_id"].endswith(sp["span_id"])


def test_otlp_export_file_env(tmp_path, monkeypatch):
    path = str(tmp_path / "otlp.jsonl")
    monkeypatch.setenv("DATAFUSION_TPU_OTLP_FILE", path)
    monkeypatch.delenv("DATAFUSION_TPU_OTLP_ENDPOINT", raising=False)
    spans = _span_dicts(1)
    assert otlp.export_spans(spans) == path
    assert otlp.export_spans(spans) == path  # appends
    lines = open(path, encoding="utf-8").read().strip().splitlines()
    assert len(lines) == 2 and len(otlp.otlp_to_spans(json.loads(lines[0]))) == len(spans)


def test_otlp_post_to_a_local_socket(monkeypatch):
    import gzip
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    bodies, encodings = [], []

    class _H(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            encodings.append(self.headers.get("Content-Encoding"))
            if encodings[-1] == "gzip":
                raw = gzip.decompress(raw)
            bodies.append(json.loads(raw))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    spans = _span_dicts(2)
    try:
        endpoint = f"http://127.0.0.1:{srv.server_address[1]}/v1/traces"
        assert otlp.post_otlp(endpoint, spans) == 200 and encodings[-1] == "gzip"
        assert otlp.post_otlp(endpoint, spans, compress=False) == 200
        assert encodings[-1] is None
        assert bodies[-1] == jotlp.spans_to_otlp(spans)
        # the environment's route batches: two queries, one POST at flush
        monkeypatch.delenv("DATAFUSION_TPU_OTLP_FILE", raising=False)
        monkeypatch.setenv("DATAFUSION_TPU_OTLP_ENDPOINT", endpoint)
        otlp.flush()
        assert "batched" in otlp.export_spans(spans)
        assert otlp.export_spans(spans) is not None
        assert otlp.pending() == 2 * len(spans)
        n_posts = len(bodies)
        assert otlp.flush() == 200 and otlp.pending() == 0
        assert len(bodies) == n_posts + 1
        assert len(otlp.otlp_to_spans(bodies[-1])) == 2 * len(spans)
        # the endpoint unset between enqueue and flush: counted loss
        assert otlp.export_spans(spans) is not None
        monkeypatch.delenv("DATAFUSION_TPU_OTLP_ENDPOINT")
        errs = _count("obs.otlp_errors")
        assert otlp.flush() is None and otlp.pending() == 0
        assert _count("obs.otlp_errors") == errs + 1
    finally:
        srv.shutdown()


# -------------------------------------------------- histograms, fleet


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_histogram_quantiles_and_merge_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    samples = np.exp(rng.uniform(np.log(1e-7), np.log(300.0), 500)).tolist()
    ph, jh = aggregate.LatencyHistogram(), jagg.LatencyHistogram()
    for s in samples:
        ph.observe(s)
        jh.observe(s)
    assert ph.snapshot() == jh.snapshot()
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ph.quantile(q) == jh.quantile(q)
    other_p, other_j = aggregate.LatencyHistogram(), jagg.LatencyHistogram()
    other_p.merge(ph.snapshot())
    other_j.merge(jh.snapshot())
    assert other_p.snapshot() == other_j.snapshot()
    hists_p = {"query.latency": ph}
    hists_j = {"query.latency": jh}
    assert aggregate.histogram_gauges(hists_p, "fleet.") == jagg.histogram_gauges(hists_j, "fleet.")


def test_overflow_quantile_is_a_lower_bound():
    h = aggregate.LatencyHistogram()
    for _ in range(98):
        h.observe(0.001)
    for _ in range(2):
        h.observe(200.0)
    assert h.quantile(0.99) >= aggregate.bucket_upper_bound_s(26)
    assert h.quantile(0.99) > h.sum_s / h.count
    h2 = aggregate.LatencyHistogram()
    for _ in range(10):
        h2.observe(500.0)
    assert h2.quantile(0.99) == jagg.LatencyHistogram().merge(h2.snapshot()).quantile(0.99)
    assert h2.quantile(0.99) == pytest.approx(500.0)


def _node_snapshots(seed, n=3):
    rng = np.random.default_rng(seed)
    now = time.time()
    snaps = {}
    for k in range(n):
        h = aggregate.LatencyHistogram()
        for s in rng.exponential(0.01 * (k + 1), 80):
            h.observe(float(s))
        b = aggregate.LatencyHistogram(base=1.0, nbuckets=48)
        for s in rng.integers(1, 10**9, 10):
            b.observe(float(s))
        snaps[f"w{k}:{k + 1}"] = {
            "ts": now, "histograms": {"fragment.latency": h.snapshot(),
                                      "scan.t.bytes": b.snapshot()},
            "counts": {"cache.fragment.hits": int(rng.integers(0, 50)),
                       "cache.fragment.misses": int(rng.integers(1, 50)),
                       "device.launches": int(rng.integers(1, 99)), "fused.groups": 7,
                       "queries_admitted": 3},
            "gauges": {"device.hbm.live_bytes": int(rng.integers(0, 10**9)),
                       "host.rss_bytes": int(rng.integers(1, 10**9)),
                       "tenant.A.device_seconds": float(rng.random())},
        }
    return snaps


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_merge_and_gauges_equal_the_jax_package(seed):
    p = aggregate.FleetAggregator(include_local=False)
    j = jagg.FleetAggregator(include_local=False)
    for addr, snap in _node_snapshots(seed).items():
        p.ingest(addr, json.loads(json.dumps(snap)))
        j.ingest(addr, json.loads(json.dumps(snap)))
    fp, fj = p.fleet(), j.fleet()
    assert fp["nodes"] == fj["nodes"] == 3
    assert fp["counts"] == fj["counts"] and fp["derived"] == fj["derived"]
    assert fp["tenants"] == fj["tenants"] and fp["hbm"] == fj["hbm"]
    for name in fj["histograms"]:
        assert fp["histograms"][name].snapshot() == fj["histograms"][name].snapshot()
    assert p.gauges() == j.gauges()
    top = p.top_text()
    assert top == j.top_text()
    assert "fleet: 3 node(s)" in top and all(a in top for a in ("w0:1", "w1:2", "w2:3"))


def test_stale_snapshots_drop_out():
    agg = aggregate.FleetAggregator(stale_s=0.01, include_local=False)
    agg.ingest("old:1", {"ts": time.time() - 10, "histograms": {}, "counts": {},
                         "gauges": {}})
    assert agg.fleet()["nodes"] == 0


def test_malformed_snapshot_ignored():
    agg = aggregate.FleetAggregator(include_local=False)
    agg.ingest("bad:1", None)
    agg.ingest("bad:2", {"no": "histograms"})
    assert agg.fleet()["nodes"] == 0


def test_node_snapshot_shape_and_host_gauges():
    snap = aggregate.node_snapshot()
    assert {"ts", "histograms", "counts", "gauges"} == set(snap)
    if os.path.exists("/proc/self/status"):
        assert snap["gauges"]["host.rss_bytes"] > 0
        assert snap["gauges"]["host.open_fds"] > 0


# --------------------------------------------------------------- SLO


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


def test_env_declaration_equals_the_jax_package():
    env = {"DATAFUSION_TPU_SLO_WARM_Q1_P99": "0.5", "DATAFUSION_TPU_SLO_INGEST_P50": "2.0",
           "DATAFUSION_TPU_SLO_ERROR_RATE": "0.01", "DATAFUSION_TPU_SLO_WINDOW_S": "60",
           "DATAFUSION_TPU_SLO_BOGUS": "zzz", "DATAFUSION_TPU_SLO_ZERO_P99": "0",
           "DATAFUSION_TPU_SLO_NEG_ERROR_RATE": "-1",
           "DATAFUSION_TPU_SLO_PRESSURE_HBM_FRAC": "0.8",
           "DATAFUSION_TPU_SLO_Q1_VIEW_FRESHNESS_S": "5"}
    got = [(o.name, o.kind, o.threshold) for o in slo.objectives_from_env(env)]
    assert got == [(o.name, o.kind, o.threshold) for o in jslo.objectives_from_env(env)]
    assert {n for n, _, _ in got} == {"warm_q1", "ingest", "error_rate", "pressure", "q1_view"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_rows_equal_the_jax_package(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    monkeypatch.setattr(slo, "time", clock)
    monkeypatch.setattr(jslo, "time", clock)
    wds = []
    for mod in (slo, jslo):
        wd = mod.SloWatchdog(window_s=60.0, min_samples=10, capture_on_breach=False)
        wd.add(mod.Objective("lat", "p99", 0.05)).add(mod.Objective("p50", "p50", 0.01))
        wd.add(mod.Objective("err", "error_rate", 0.02)).add(
            mod.Objective("short", "p95", 0.02, window_s=10.0))
        wds.append(wd)
    for i in range(300):
        clock.t = 1000.0 + i * 0.25
        lat, err = float(rng.exponential(0.01)), bool(rng.random() < 0.03)
        for wd in wds:
            wd.observe(lat, error=err)
    rows_p, rows_j = wds[0].evaluate(), wds[1].evaluate()
    assert rows_p == rows_j
    assert slo.max_burn_rate(rows_p) == jslo.max_burn_rate(rows_j)
    assert wds[0].snapshot() == wds[1].snapshot()


def test_error_rate_and_latency_burn():
    wd = slo.SloWatchdog(min_samples=10, capture_on_breach=False)
    wd.add(slo.Objective("err", "error_rate", 0.01))
    for i in range(100):
        wd.observe(0.001, error=(i % 10 == 0))
    row = wd.evaluate()[0]
    assert row["burn_rate"] == pytest.approx(10.0) and row["breached"]
    assert METRICS.gauges["slo.err.breached"] == 1
    wd = slo.SloWatchdog(min_samples=10, capture_on_breach=False)
    wd.add(slo.Objective("lat", "p99", 0.1))
    for _ in range(100):
        wd.observe(0.01)
    assert not wd.evaluate()[0]["breached"]
    for _ in range(5):
        wd.observe(0.5)
    assert wd.evaluate()[0]["breached"]


def test_min_samples_quorum():
    wd = slo.SloWatchdog(min_samples=50, capture_on_breach=False)
    wd.add(slo.Objective("q", "p99", 0.001))
    for _ in range(10):
        wd.observe(1.0)
    assert not wd.evaluate()[0]["breached"]


def test_breach_writes_a_flight_dump(flight):
    wd = slo.SloWatchdog(min_samples=5, capture_on_breach=True)
    wd.add(slo.Objective("cap", "error_rate", 0.01))
    for _ in range(10):
        wd.observe(0.001, error=True)
    assert wd.evaluate()[0]["breached"]
    docs = _dumps(recorder.dump_dir(), "slo_breach")
    assert any(d["slo"]["name"] == "cap" and "tail" in d for d in docs)


def test_hbm_objective_reads_the_ledger(monkeypatch):
    wd = slo.SloWatchdog(capture_on_breach=False)
    wd.add(slo.Objective("pressure", "hbm_frac", 0.5))
    monkeypatch.delenv("DATAFUSION_TPU_HBM_BYTES", raising=False)
    import torch

    if not torch.cuda.is_available():  # no capacity known: dormant
        assert wd.evaluate()[0]["samples"] == 0
    monkeypatch.setenv("DATAFUSION_TPU_HBM_BYTES", "1000")
    monkeypatch.setattr(pdevice.LEDGER, "live_bytes", lambda: 900)
    row = wd.evaluate()[0]
    assert row["value"] == pytest.approx(0.9) and row["breached"]


def test_freshness_objective_reads_live_lags(monkeypatch):
    from datafusion_tpu_torch import ingest

    wd = slo.SloWatchdog(capture_on_breach=False)
    wd.add(slo.Objective("v1", "freshness_s", 1.0))
    monkeypatch.setattr(ingest, "freshness_lags", lambda: {})
    assert wd.evaluate()[0]["samples"] == 0  # no live view: dormant
    monkeypatch.setattr(ingest, "freshness_lags", lambda: {"v1": 3.0, "v2": 0.5})
    row = wd.evaluate()[0]
    assert row["value"] == 3.0 and row["burn_rate"] == 3.0 and row["breached"]


# ------------------------------------------------------------ funnel


def test_query_events_and_histogram(ctx, flight):
    h = aggregate.HISTOGRAMS.get("query.latency")
    before = h.count if h else 0
    errors = _count("obs.telemetry_errors")
    ctx.sql_collect("SELECT region, SUM(v) FROM t GROUP BY region")
    kinds = [e["kind"] for e in recorder.events()]
    for expected in ("query.plan", "query.admit", "query.verify", "device.launch",
                     "query.done"):
        assert expected in kinds, kinds
    done = recorder.events("query.done")[-1]["attrs"]
    assert done["rows"] == 4 and set(done["phases"]) == set(pdevice.PHASE_ORDER)
    assert aggregate.HISTOGRAMS["query.latency"].count == before + 1
    assert aggregate.HISTOGRAMS["scan.t.latency"].count >= 1
    assert _count("obs.telemetry_errors") == errors


def test_cached_repeat_records_hit_event(ctx, flight):
    sql = "SELECT region, SUM(v) FROM t GROUP BY region"
    ctx.sql_collect(sql)
    recorder.clear()
    ctx.sql_collect(sql)
    hit = recorder.events("cache.hit")
    assert hit and hit[-1]["attrs"]["level"] == "result"
    assert recorder.events("query.done")  # a replay is still a query


def test_slow_query_auto_capture(ctx, flight, tmp_path):
    recorder.configure(slow_s=0.0)  # every query is slow
    ctx.sql_collect("SELECT region, SUM(v) FROM t GROUP BY region")
    doc = next(iter(_dumps(tmp_path, "slow_query")))
    assert doc["query"]["label"] == "Aggregate" and doc["query"]["wall_s"] >= 0
    assert any(e["kind"] == "query.done" for e in doc["events"])
    assert "tail" in doc


def test_failed_query_auto_capture(ctx, flight, tmp_path):
    ctx.register_csv("gone", str(tmp_path / "missing.csv"), _schema())
    with pytest.raises(Exception, match="missing.csv"):
        ctx.sql_collect("SELECT region FROM gone")
    assert recorder.events("query.error")
    doc = next(iter(_dumps(tmp_path, "query_failure")))
    assert "missing.csv" in doc["query"]["error"]


def test_explain_analyze_capture_includes_otlp(ctx, flight, tmp_path):
    recorder.configure(slow_s=0.0)
    res = ctx.sql_collect("EXPLAIN ANALYZE SELECT region, SUM(v) FROM t GROUP BY region")
    assert res.spans
    doc = next(iter(_dumps(tmp_path, "slow_query")))
    assert doc["query"]["trace_id"] == res.trace_id
    got = otlp.otlp_to_spans(doc["otlp"])
    assert any(s["name"].startswith("op.") for s in got)
    assert any("rows=" in line for line in doc["explain"])


def test_explain_analyze_exports_otlp_once(ctx, flight, tmp_path, monkeypatch):
    out = tmp_path / "q.otlp.jsonl"
    monkeypatch.setenv("DATAFUSION_TPU_OTLP_FILE", str(out))
    res = ctx.sql_collect("EXPLAIN ANALYZE SELECT region, SUM(v) FROM t GROUP BY region")
    lines = out.read_text(encoding="utf-8").strip().splitlines()
    assert len(lines) == 1
    spans = otlp.otlp_to_spans(json.loads(lines[0]))
    assert any(s["name"] == "query" for s in spans)  # the root included
    assert json.loads(lines[0]) == res.otlp()


def test_plain_traced_query_exports_otlp_once(ctx, flight, tmp_path, monkeypatch):
    from datafusion_tpu_torch.obs import trace as obs_trace

    out = tmp_path / "plain.otlp.jsonl"
    monkeypatch.setenv("DATAFUSION_TPU_OTLP_FILE", str(out))
    with obs_trace.session():
        ctx.sql_collect("SELECT region FROM t")
    assert len(out.read_text(encoding="utf-8").strip().splitlines()) == 1


def _mem_ctx(rows=4096, batch=1024, seed=5):
    T = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("v", T.FLOAT64, False)])
    rng = np.random.default_rng(seed)
    batches = [tdf.make_host_batch(schema, [rng.integers(0, 8, batch), rng.random(batch)])
               for _ in range(rows // batch)]
    c = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch)
    c.register_datasource("m", tdf.MemoryDataSource(schema, batches))
    return c, batches


def test_tail_explainer_fed_for_a_plain_query_not_a_served_one():
    c, _ = _mem_ctx()
    attribution.EXPLAINER.clear()
    c.sql_collect("SELECT k, SUM(v) FROM m GROUP BY k")
    assert attribution.EXPLAINER.explain()["kinds"] == {"phases": 1}
    attribution.EXPLAINER.clear()
    with c.serve(workers=1, window_s=0.001) as srv:
        srv.submit("SELECT k, SUM(v) FROM m WHERE v > 0.5 GROUP BY k",
                   client_id="A").result(timeout=120)
    assert attribution.EXPLAINER.explain()["kinds"] == {"served": 1}
    assert aggregate.HISTOGRAMS["serve.latency"].count >= 1


# ------------------------------------------------------------ ledger


def test_transient_buffer_reports_one_leak_after_two_sweeps(flight):
    import torch

    pdevice.LEDGER.sweep(grace_s=1e9)  # mark what is already there
    before = _count("device.ledger.leaks")
    held = pdevice.LEDGER.adopt(torch.zeros(1024), "fold")
    cached = pdevice.LEDGER.adopt(torch.zeros(1024), "batch")
    pdevice.LEDGER.pin("table:leakcheck", 4096, artifact=object())
    try:
        assert pdevice.LEDGER.sweep(grace_s=0.0) == 0  # first sweep: candidates
        assert pdevice.LEDGER.sweep(grace_s=0.0) >= 1  # second: reported
        assert pdevice.LEDGER.sweep(grace_s=0.0) == 0  # each once
        leaks = [e for e in recorder.events("device.leak")
                 if e["attrs"]["bytes"] == held.untyped_storage().nbytes()]
        assert leaks and all(e["attrs"]["owner"] == "fold" for e in leaks)
        assert not any(e["attrs"]["owner"] == "batch" for e in recorder.events("device.leak"))
        assert _count("device.ledger.leaks") > before
    finally:
        pdevice.LEDGER.unpin("table:leakcheck")
    del held, cached


def test_warm_queries_leave_no_leak(flight):
    c, _ = _mem_ctx()
    before = _count("device.ledger.leaks")
    for _ in range(3):
        c.sql_collect("SELECT k, SUM(v) FROM m GROUP BY k")
        pdevice.LEDGER.sweep(grace_s=0.0)
    assert _count("device.ledger.leaks") == before


def test_ledger_switch_publishes_no_gauges(monkeypatch):
    import torch

    monkeypatch.setattr(pdevice, "_ENABLED", False)
    METRICS.gauges.pop("device.hbm.live_bytes", None)
    METRICS.gauges.pop("device.hbm.peak_bytes", None)
    t = pdevice.LEDGER.adopt(torch.zeros(16), "batch")
    snap = aggregate.node_snapshot()
    assert not any(k.startswith("device.hbm.") for k in snap["gauges"])
    assert pdevice.phase_snapshot() == {}
    del t


def test_h2d_flight_events_carry_h2d_bytes(flight):
    c, _ = _mem_ctx(seed=9)
    b0 = _count("h2d.bytes")
    c.sql_collect("SELECT k, SUM(v) FROM m GROUP BY k")
    moved = _count("h2d.bytes") - b0
    events = recorder.events("device.h2d")
    assert moved > 0 and sum(e["attrs"]["bytes"] for e in events) == moved
    assert all("ms" in e["attrs"] for e in events)


# ---------------------------------------------------------- pin bytes


def test_pin_bytes_are_the_cached_tensors_bytes():
    from datafusion_tpu_torch.exec.datasource import host_bytes
    from datafusion_tpu_torch.serve import _cached_tensors

    c, batches = _mem_ctx(rows=8192, seed=11)
    with c.serve(workers=2, window_s=0.001) as srv:
        srv.submit("SELECT k, SUM(v) FROM m WHERE v > 0.25 GROUP BY k").result(timeout=120)
        got = pdevice.LEDGER.pins_snapshot()["table:m"]["bytes"]
        tensors = _cached_tensors(list(c.datasources["m"]._resident))
        storages = {(t.device, t.untyped_storage().data_ptr()): t.untyped_storage().nbytes()
                    for t in tensors}
        assert tensors and got == sum(storages.values())
        assert got != host_bytes(batches)
        owners = pdevice.LEDGER.owners()
        assert "pin.m" in owners


def test_pin_is_measured_only_after_a_query_that_copied(monkeypatch):
    """The pin's bytes are measured after the served query that copied
    its batches, and a warm query over it, or a query over another
    table, measures nothing (the skip reads the query's own copies)."""
    from datafusion_tpu_torch.serve import Server

    measured = []
    real = Server._measure_pins

    def spy(self, t):
        measured.append(t.sql)
        return real(self, t)

    monkeypatch.setattr(Server, "_measure_pins", spy)
    c, _ = _mem_ctx(rows=4096, seed=12)
    c2, _ = _mem_ctx(rows=4096, seed=13)
    c.register_datasource("o", c2.datasources["m"])
    q_m = "SELECT k, SUM(v) FROM m GROUP BY k"
    with c.serve(workers=2, window_s=0.001) as srv:
        srv.submit(q_m).result(timeout=120)
        assert measured == [q_m]
        bytes_m = pdevice.LEDGER.pins_snapshot()["table:m"]["bytes"]
        srv.submit(q_m).result(timeout=120)  # warm: no copy
        srv.submit("SELECT k, SUM(v) FROM o GROUP BY k").result(timeout=120)
        assert measured == [q_m, "SELECT k, SUM(v) FROM o GROUP BY k"]
        assert pdevice.LEDGER.pins_snapshot()["table:m"]["bytes"] == bytes_m


@pytest.mark.parametrize("lane", ["pipe", "topk", "agg"])
def test_megabatch_members_on_both_workers_keep_their_bits(lane, monkeypatch):
    """A megabatch's members of the pipeline and TopK lanes are handed
    to the other worker while the pass's worker finishes its first
    (held back here, so the hand-off happens), an aggregate lane's all
    finish on the pass's worker; each answer is its solo answer bit for
    bit."""
    from test_torch_serve import LINEITEM_Q1, _bits, _lineitem, _sorted_bits

    from datafusion_tpu_torch.serve import Server

    _, src, dates = _lineitem(seed=21)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("lineitem", src)
    if lane == "pipe":
        sqls = [f"SELECT l_returnflag, l_quantity, l_extendedprice * (1 - l_discount) "
                f"FROM lineitem WHERE l_discount > {d / 100}" for d in range(8)]
    elif lane == "topk":
        sqls = [f"SELECT l_returnflag, l_extendedprice FROM lineitem "
                f"ORDER BY l_extendedprice DESC LIMIT {k}" for k in (5, 50, 500, 3, 70, 9)]
    else:
        sqls = [LINEITEM_Q1.format(dates[40 * i + 7]) for i in range(8)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    passes, finished = [], {}
    real_run, real_mat = Server._run_megabatch, Server._materialize

    def run(self, tickets):
        passes.append((threading.get_ident(), [id(t) for t in tickets]))
        return real_run(self, tickets)

    def mat(self, t):
        tid = threading.get_ident()
        finished[id(t)] = tid
        if lane != "agg" and any(p == tid for p, _ in passes):
            time.sleep(0.05)  # the other worker takes the handed-off members
        return real_mat(self, t)

    monkeypatch.setattr(Server, "_run_megabatch", run)
    monkeypatch.setattr(Server, "_materialize", mat)
    with ctx.serve(workers=2, window_s=0.2, megabatch_max=16) as srv:
        got = [t.result(timeout=120) for t in [srv.submit(s) for s in sqls]]
    assert passes and sum(len(ids) for _, ids in passes) == len(sqls)
    for tid, ids in passes:
        where = {finished[i] for i in ids}
        assert where == {tid} if lane == "agg" else len(where) == 2
    same = _sorted_bits if lane == "agg" else _bits
    for g, w in zip(got, solo):
        assert same(g) == same(w)


def test_serving_streams_are_a_noop_on_the_cpu():
    import torch

    from datafusion_tpu_torch.exec import streams

    with streams.serving_scope(torch.device("cpu")) as s:
        assert s is None
    assert streams.current() is None
    with streams.stream_scope(None) as s:
        assert s is None and streams.current() is None
    t = torch.zeros(4)
    assert streams.publish(t) is t and not hasattr(t, "_df_ready")
    assert streams.shared((t, None)) == (t, None)


# ----------------------------------------------------------- workers


def _spawn(module, *extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--bind", "127.0.0.1:0", "--device", "cpu", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    assert "listening on" in line, line
    host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
    debug = None
    if "--http-port" in extra:
        dline = proc.stdout.readline()
        assert "worker debug:" in dline, dline
        debug = re.search(r"http://([\d.]+):(\d+)", dline).groups()
    return proc, (host, int(port)), debug


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    paths = [_write_csv(d / f"p{i}.csv", seed=i) for i in range(3)]
    procs = []
    try:
        workers = []
        for _ in range(2):
            proc, addr, debug = _spawn("datafusion_tpu_torch.worker", "--http-port", "-1")
            procs.append(proc)
            workers.append((addr, debug))
        proc, jax_addr, _ = _spawn("datafusion_tpu.worker")
        procs.append(proc)
        yield paths, workers, jax_addr, d
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)


def _pctx(addrs, paths):
    from datafusion_tpu_torch.exec.datasource import CsvDataSource
    from datafusion_tpu_torch.parallel import DistributedContext, PartitionedDataSource

    c = DistributedContext(addrs, device="cpu", result_cache=False)
    c.register_datasource("t", PartitionedDataSource(
        [CsvDataSource(p, _schema(), True, 131072) for p in paths]))
    return c


def test_workers_answer_telemetry_and_flight_dump(fleet, flight):
    from datafusion_tpu_torch.parallel.coordinator import WorkerHandle

    paths, workers, _, _ = fleet
    addrs = [a for a, _ in workers]
    c = _pctx(addrs, paths)
    try:
        c.sql_collect("SELECT region, SUM(v) FROM t GROUP BY region")
        for addr in addrs:
            h = WorkerHandle(*addr)
            snap = h.telemetry()
            assert {"ts", "histograms", "counts", "gauges"} == set(snap)
            dump = h.flight_dump()
            assert dump["node"].startswith("worker:")
            assert dump["events_emitted"] >= len(dump["events"])
        kinds = {e["kind"] for a in addrs for e in WorkerHandle(*a).flight_dump()["events"]}
        assert "fragment.serve" in kinds
        frag = sum(WorkerHandle(*a).telemetry()["histograms"]["fragment.latency"]["count"]
                   for a in addrs if "fragment.latency" in
                   WorkerHandle(*a).telemetry()["histograms"])
        assert frag >= 3  # three partitions served
    finally:
        c.close()


def test_port_coordinator_aggregates_both_workers(fleet, flight):
    paths, workers, _, _ = fleet
    addrs = [a for a, _ in workers]
    c = _pctx(addrs, paths)
    try:
        c.sql_collect("SELECT region, SUM(v) FROM t GROUP BY region")
        assert c.fleet_refresh() == 2
        f = c.telemetry.fleet()
        assert f["nodes"] == 3  # two workers and the local node
        assert f["histograms"]["fragment.latency"].count >= 3
        gauges = c.fleet_gauges()
        assert "fleet.fragment.latency.p99_s" in gauges and "fleet.query.latency.p99_s" in gauges
        assert 'name="fleet.fragment.latency.p99_s"' in c.metrics_text()
        top = c.top_text()
        for host, port in addrs:
            assert f"node {host}:{port}:" in top
        assert re.search(r"fragments: n=\d+ p50=\S+ p99=\S+", top)
    finally:
        c.close()


def test_slow_distributed_query_captures_every_workers_ring(fleet, flight, tmp_path):
    paths, workers, _, _ = fleet
    addrs = [a for a, _ in workers]
    recorder.configure(slow_s=0.0, directory=str(tmp_path))
    c = _pctx(addrs, paths)
    try:
        # a query no earlier test ran: the workers execute, not replay
        c.sql_collect("EXPLAIN ANALYZE SELECT region, MAX(v) FROM t GROUP BY region")
    finally:
        c.close()
    doc = next(iter(_dumps(tmp_path, "slow_query")))
    assert set(doc["nodes"]) == {f"{h}:{p}" for h, p in addrs}
    kinds = {e["kind"] for nd in doc["nodes"].values() for e in nd["events"]}
    assert "fragment.serve" in kinds
    procs = {s["proc"] for s in otlp.otlp_to_spans(doc["otlp"])}
    assert any(p.startswith("worker") for p in procs) and any(p.startswith("main") for p in procs)


def test_jax_coordinator_aggregates_port_workers(fleet):
    from datafusion_tpu.parallel.coordinator import DistributedContext as JaxDistributedContext

    _, workers, _, _ = fleet
    addrs = [a for a, _ in workers]
    jc = JaxDistributedContext(addrs)
    try:
        assert jc.fleet_refresh() == 2
        top = jc.top_text()
        assert all(f"{h}:{p}" in top for h, p in addrs)
        assert jc.telemetry.fleet()["nodes"] == 3
    finally:
        jc.close()


def test_port_coordinator_aggregates_a_jax_worker(fleet):
    paths, _, jax_addr, _ = fleet
    c = _pctx([jax_addr], paths)
    try:
        c.sql_collect("SELECT region, SUM(v) FROM t GROUP BY region")
        assert c.fleet_refresh() == 1
        f = c.telemetry.fleet()
        assert f["histograms"]["fragment.latency"].count >= 3
        assert f"{jax_addr[0]}:{jax_addr[1]}" in c.top_text()
        from datafusion_tpu_torch.parallel.coordinator import WorkerHandle

        assert WorkerHandle(*jax_addr).flight_dump()["events"]
    finally:
        c.close()


def _cli(*argv, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["HOME"] = str(tmp_path)
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)


def test_console_top_over_the_workers(fleet, tmp_path):
    _, workers, _, _ = fleet
    spec = ",".join(f"{h}:{p}" for (h, p), _ in workers)
    run = _cli("datafusion_tpu_torch.cli", "--device", "cpu", "top", "--workers", spec,
               "--tenants", "--qos", tmp_path=tmp_path)
    assert run.returncode == 0, run.stderr
    assert "fleet: 3 node(s)" in run.stdout and "QoS:" in run.stdout
    assert all(f"node {a}" in run.stdout for a in spec.split(","))
    jrun = _cli("datafusion_tpu.cli", "top", "--workers", spec, tmp_path=tmp_path)
    assert jrun.returncode == 0, jrun.stderr
    # both consoles render the same rows for the same fleet
    assert [ln.split(":")[0] for ln in run.stdout.splitlines() if ln.startswith("  node ")] == \
        [ln.split(":")[0] for ln in jrun.stdout.splitlines() if ln.startswith("  node ")]


@pytest.mark.parametrize("fmt", ["json", "tar"])
def test_console_debug_bundle_over_the_workers(fleet, tmp_path, fmt):
    import tarfile

    _, workers, _, _ = fleet
    spec = ",".join(f"{h}:{p}" for _, (h, p) in workers)
    out = tmp_path / "bundles"
    run = _cli("datafusion_tpu_torch.cli", "debug-bundle", "--workers", spec, "--out",
               str(out), "--format", fmt, "--seconds", "0.05", tmp_path=tmp_path)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "(2/2 ok)" in run.stdout
    names = sorted(os.listdir(out))
    assert names == sorted(f"bundle-{m.replace(':', '-')}.{fmt}" for m in spec.split(","))
    for name in names:
        if fmt == "tar":
            with tarfile.open(out / name) as tf:
                doc = json.load(tf.extractfile("bundle.json"))
        else:
            doc = json.loads((out / name).read_text())
        assert doc["type"] == "debug_bundle" and doc["node"].startswith("worker:")
        assert doc["config"]["backend"] == "cpu"


# ------------------------------------------------------------- misc


@pytest.mark.parametrize("module", ["obs/recorder.py", "obs/aggregate.py", "obs/otlp.py",
                                    "obs/slo.py", "obs/httpd.py", "exec/streams.py"])
def test_fleet_modules_are_the_ports_own(module):
    text = (REPO / "datafusion_tpu_torch" / module).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", text,
                         re.MULTILINE)


def test_qos_debug_snapshot_matches_the_jax_package():
    from datafusion_tpu import qos as jqos

    from datafusion_tpu_torch import qos

    pol_p = qos.FairSharePolicy({"A": 3, "B": 1})
    pol_j = jqos.FairSharePolicy({"A": 3, "B": 1})
    p, j = qos.debug_snapshot(pol_p), jqos.debug_snapshot(pol_j)
    assert set(p) == set(j) and set(p["scale"]) == set(j["scale"])
    assert p["scale"]["hint"] == qos.scale_hint(p["scale"]["max_burn_rate"],
                                                p["scale"]["queue_wait_share"])
