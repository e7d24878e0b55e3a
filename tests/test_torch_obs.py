"""PyTorch/CUDA port, slice 11: spans, operator stats, the metrics
registry and the exporters (`datafusion_tpu_torch/obs/{trace,stats,
export}.py`, `utils/metrics.py`, `utils/retry.py`).

- Behaviour, mirrored from the JAX package's `tests/test_obs.py` and run
  against the port: nesting and attributes, the disabled mode's shared
  no-op (no allocation, no operator stats), session restore,
  overlapping sessions, the buffer cap, the wire round trip, adopt's
  thread scope, ingest.
- Pure functions, exact: the same span dicts through both packages'
  `chrome_trace` give the same JSON, the same counts, timings and gauges
  through `prometheus_text` the same text (`_metric_name` and
  `_label_value` included).
- The seams with tracing off: `iter_stats` hands back the child's
  iterator, `op_timer` the shared no-op, and a pass counts
  `device.launches` and its tag once each.
- The span flusher, and EXPLAIN ANALYZE, the exporters and the console
  in a process where jax cannot be imported.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from datafusion_tpu.obs import export as jax_export
from datafusion_tpu.utils.metrics import Metrics as JaxMetrics

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.obs import export, stats, trace
from datafusion_tpu_torch.utils.metrics import METRICS, Metrics
from datafusion_tpu_torch.utils.retry import device_call


@pytest.fixture()
def ctx():
    from datafusion_tpu_torch.datatypes import DataType, Field, Schema
    from datafusion_tpu_torch.exec.batch import make_host_batch
    from datafusion_tpu_torch.exec.datasource import MemoryDataSource

    rng = np.random.default_rng(7)
    schema = Schema([Field("region", DataType.UTF8, False), Field("v", DataType.INT64, False)])
    from datafusion_tpu_torch.exec.batch import StringDictionary

    d = StringDictionary()
    regions = np.array(["north", "south", "east", "west"], dtype=object)
    batches = [make_host_batch(schema, [d.encode(list(regions[rng.integers(0, 4, 300)])),
                                        rng.integers(-1000, 1000, 300)], None, [d, None])
               for _ in range(3)]
    c = tdf.ExecutionContext(device="cpu", result_cache=False)
    c.register_datasource("t", MemoryDataSource(schema, batches))
    return c


# ------------------------------------------------- spans (mirrored)


def test_nesting_and_attrs():
    with trace.session() as tc:
        with trace.span("outer", kind="test") as outer:
            with trace.span("inner", shard=3) as inner:
                assert trace.current_span() is inner
            assert trace.current_span() is outer
    recorded = trace.drain(tc.trace_id)
    by_name = {s["name"]: s for s in recorded}
    assert set(by_name) == {"outer", "inner"}
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["outer"]["attrs"] == {"kind": "test"}
    assert by_name["inner"]["attrs"] == {"shard": 3}
    assert by_name["inner"]["trace_id"] == tc.trace_id
    assert all(s["end_ns"] >= s["start_ns"] for s in recorded)


def test_disabled_mode_is_allocation_free():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as sp:
        assert sp is None
    assert trace.begin_span("x") is None
    trace.finish_span(None)


def test_disabled_mode_records_no_operator_stats(ctx):
    rel = ctx.sql("SELECT region, v FROM t WHERE v > 0")
    tdf.collect(rel)
    assert rel._op_stats is None
    assert rel.child._op_stats is None


def test_session_restores_disabled_state():
    assert not trace.enabled()
    with trace.session():
        assert trace.enabled()
    assert not trace.enabled()


def test_overlapping_sessions_keep_collection_on():
    started, release = threading.Event(), threading.Event()
    results = {}

    def holder():
        with trace.session() as tc:
            started.set()
            release.wait(timeout=10)
            results["enabled_inside"] = trace.enabled()
            results["trace_id"] = tc.trace_id

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert started.wait(timeout=10)
        with trace.session():
            pass
        assert trace.enabled(), "sibling session lost collection"
    finally:
        release.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert results["enabled_inside"] is True
    assert not trace.enabled()
    trace.drain()


def test_buffer_cap_drops_not_grows():
    old_max = trace._MAX_SPANS
    trace._MAX_SPANS = 2
    dropped0 = METRICS.snapshot()["counts"].get("obs.spans_dropped", 0)
    try:
        with trace.session() as tc:
            for i in range(5):
                with trace.span(f"s{i}"):
                    pass
        assert len(trace.drain(tc.trace_id)) <= 2
        assert METRICS.snapshot()["counts"]["obs.spans_dropped"] - dropped0 == 3
    finally:
        trace._MAX_SPANS = old_max
        trace.drain()


def test_wire_roundtrip():
    tc = trace.TraceContext("abc123", "span9")
    back = trace.TraceContext.from_wire(tc.to_wire())
    assert back.trace_id == "abc123" and back.span_id == "span9"
    for bad in (None, {}, {"nope": 1}):
        assert trace.TraceContext.from_wire(bad) is None
    assert trace.wire_context() is None
    with trace.session() as tc:
        with trace.span("dispatch") as sp:
            assert trace.wire_context() == {"trace_id": tc.trace_id,
                                            "parent_span_id": sp.span_id}
    trace.drain(tc.trace_id)


def test_adopt_parents_and_force_enables():
    assert not trace.enabled()
    wire = {"trace_id": "feedc0de00000001", "parent_span_id": "p" * 16}
    with trace.adopt(wire):
        assert trace.enabled()
        with trace.span("worker.fragment", shard=0):
            pass
    assert not trace.enabled()
    got = trace.drain("feedc0de00000001")
    assert len(got) == 1
    assert got[0]["parent_id"] == "p" * 16 and got[0]["trace_id"] == "feedc0de00000001"


def test_adopt_invalid_is_noop():
    with trace.adopt(None) as tc:
        assert tc is None
        assert not trace.enabled()


def test_adopt_is_thread_scoped():
    seen = {}
    with trace.adopt({"trace_id": "aaaa000011112222"}):
        assert trace.enabled()

        def probe():
            seen["enabled"] = trace.enabled()
            with trace.span("should_not_record"):
                pass

        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=10)
    assert seen["enabled"] is False
    assert trace.drain("aaaa000011112222") == []
    assert all(s["name"] != "should_not_record" for s in trace.drain())


def test_ingest_rejects_garbage_keeps_good():
    good = {"name": "w", "trace_id": "t1", "span_id": "s1", "parent_id": None,
            "start_ns": 1, "end_ns": 2}
    assert trace.ingest([good, "garbage", {"name": "incomplete"}]) == 1
    assert [s["name"] for s in trace.drain("t1")] == ["w"]


# ------------------------------------------- the seams, tracing off


def test_seams_are_pass_through_when_disabled(ctx):
    assert not trace.enabled()
    rel = ctx.sql("SELECT region, v FROM t WHERE v > 0")
    it = iter([])
    assert stats.iter_stats(rel, it) is it
    assert stats.op_timer(rel) is trace._NOOP
    assert rel._op_stats is None


def test_pass_seam_counts_one_launch_and_its_tag():
    before = METRICS.snapshot()
    assert device_call(lambda a, b: a + b, 2, 3, _tag="probe.tag") == 5
    after = METRICS.snapshot()
    counts = {k: after["counts"].get(k, 0) - before["counts"].get(k, 0)
              for k in ("device.launches", "device.launches.probe.tag")}
    assert counts == {"device.launches": 1, "device.launches.probe.tag": 1}
    assert after["timings_s"]["device.dispatch"] >= before["timings_s"].get("device.dispatch", 0)


def test_pass_seam_attributes_to_the_ambient_operator():
    class Op:
        def __init__(self):
            self.stats = stats.OperatorStats()

    op = Op()
    with trace.session() as tc:
        with stats.op_timer(op):
            device_call(lambda: None, _tag="x")
            device_call(lambda: None, _tag="x")
    trace.drain(tc.trace_id)
    assert op.stats.attrs == {"launches": 2}
    assert op.stats.execute_s > 0


def test_live_rows_reads_a_torch_mask():
    import torch

    from datafusion_tpu_torch.exec.batch import RecordBatch

    mask = torch.tensor([True, False, True, True, True, True])
    b = RecordBatch(tdf.Schema([]), [], num_rows=4, mask=mask)
    assert stats.live_rows(b) == 3
    b.mask = mask.numpy()
    assert stats.live_rows(b) == 3
    b.mask = None
    assert stats.live_rows(b) == 4


def test_metrics_gauge_observe_declare():
    m = Metrics()
    m.declare("a.b")
    m.add("c")
    m.observe("stage", 0.25)
    m.gauge("g", 7)
    snap = m.snapshot()
    assert snap == {"timings_s": {"stage": 0.25}, "counts": {"a.b": 0, "c": 1},
                    "gauges": {"g": 7}}
    m.reset()
    assert m.snapshot() == {"timings_s": {}, "counts": {"a.b": 0}, "gauges": {}}


def test_kernel_cache_counts_hits_and_misses():
    from datafusion_tpu_torch.exec.kernels import cached_kernel

    before = METRICS.snapshot()["counts"]
    key = ("test_torch_obs", object())
    assert cached_kernel(key, lambda: 1) == 1
    assert cached_kernel(key, lambda: 2) == 1
    after = METRICS.snapshot()["counts"]
    assert after["kernel_cache.misses"] - before.get("kernel_cache.misses", 0) == 1
    assert after["kernel_cache.hits"] - before.get("kernel_cache.hits", 0) == 1


# ------------------------------------------------ exporters vs JAX


def _span_dicts(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        start = int(rng.integers(1_000_000, 9_000_000_000))
        d = {"name": f"op.{['Aggregate', 'Scan', 'Sort'][i % 3]}", "trace_id": f"t{i % 2}",
             "span_id": f"s{i}", "parent_id": None if i < 2 else f"s{int(rng.integers(0, i))}",
             "start_ns": start, "end_ns": start + int(rng.integers(0, 5_000_000)),
             "attrs": {"rows": int(rng.integers(0, 100)), "kind": "x"} if i % 2 else {},
             "tid": int(rng.integers(1, 2**40)), "proc": ["main:1", "worker:2"][i % 2]}
        out.append(d)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_equals_the_jax_package(seed, tmp_path):
    spans = _span_dicts(seed)
    got, want = export.chrome_trace(spans), jax_export.chrome_trace(spans)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    a = export.write_chrome_trace(str(tmp_path / "a.json"), spans)
    b = jax_export.write_chrome_trace(str(tmp_path / "b.json"), spans)
    assert open(a).read() == open(b).read()


NAMES = ["device.launches", "kernel_cache.hits", "h2d.bytes", "9lives", "a-b c",
         'quote"back\\slash', "new\nline", "device.launches.agg.group"]


def test_prometheus_text_equals_the_jax_package():
    ours, theirs = Metrics(), JaxMetrics()
    for i, name in enumerate(NAMES):
        for m in (ours, theirs):
            m.add(name, i + 1)
            m.observe(f"t.{name}", 0.125 * i)
            m.gauge(f"g.{name}", i * 3)
    extra = {"buffered": 4, "x.y": 1.5}
    assert export.prometheus_text(ours) == jax_export.prometheus_text(theirs)
    assert export.prometheus_text(ours, extra) == jax_export.prometheus_text(theirs, extra)
    for name in NAMES:
        assert export._metric_name(name) == jax_export._metric_name(name)
        assert export._label_value(name) == jax_export._label_value(name)


def test_metrics_text_after_a_query(ctx):
    ctx.sql_collect("SELECT region, COUNT(1) FROM t GROUP BY region")
    text = ctx.metrics_text()
    assert 'datafusion_tpu_events_total{name="device.launches"}' in text
    assert 'datafusion_tpu_events_total{name="kernel_cache.misses"}' in text
    assert 'datafusion_tpu_timing_seconds_total{stage="device.dispatch"}' in text
    assert "# TYPE datafusion_tpu_gauge gauge" in text  # the ledger's gauges


def test_explain_analyze_chrome_trace(ctx, tmp_path):
    res = ctx.sql_collect("EXPLAIN ANALYZE SELECT v FROM t WHERE v > 0")
    ct = res.chrome_trace()
    json.dumps(ct)
    xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["args"]["trace_id"] == res.trace_id for e in xs)
    assert {e["name"] for e in xs} == {"query", "op.Pipeline", "op.DataSource"}
    path = res.write_chrome_trace(str(tmp_path / "trace.json"))
    assert json.load(open(path))["traceEvents"]


def test_observability_runs_with_jax_blocked(tmp_path):
    """EXPLAIN ANALYZE, the profiler, the exporters and the console's
    `\\explain` and `\\hbm` in a process where jax and the JAX package
    cannot be imported; no module of the port names either."""
    import os
    import re
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, io\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['datafusion_tpu'] = None\n"
        "import numpy as np\n"
        "import datafusion_tpu_torch as t\n"
        "s = t.Schema([t.Field('k', t.DataType.INT64, False),"
        " t.Field('v', t.DataType.FLOAT64, False)])\n"
        "b = t.make_host_batch(s, [np.arange(10) % 3, np.arange(10.0)])\n"
        "ctx = t.ExecutionContext(device='cpu')\n"
        "ctx.register_datasource('t', t.MemoryDataSource(s, [b]))\n"
        "res = ctx.sql('EXPLAIN ANALYZE SELECT k, SUM(v) FROM t GROUP BY k')\n"
        "assert isinstance(res, t.ExplainAnalyzeResult)\n"
        "assert sorted(res.result.to_rows()) == [(0, 18.0), (1, 12.0), (2, 15.0)]\n"
        "assert 'Aggregate[keys=1, slots=2]' in res.report()\n"
        "assert 'device.launches' in ctx.metrics_text()\n"
        f"res.write_chrome_trace({str(tmp_path / 'trace.json')!r})\n"
        "from datafusion_tpu_torch.cli import Console\n"
        "out = io.StringIO()\n"
        "con = Console(ctx, out=out)\n"
        "con.handle_command('\\\\explain SELECT v FROM t WHERE k > 0')\n"
        "con.handle_command('\\\\hbm')\n"
        "assert 'Pipeline[filter+project]' in out.getvalue() and 'Device ledger' in out.getvalue()\n"
        "from datafusion_tpu_torch.obs import profiler\n"
        "assert profiler.capture_seconds(0.05, hz=200).samples >= 0\n"
        "from datafusion_tpu_torch.utils.profiling import trace\n"
        f"with trace({str(tmp_path / 'prof')!r}):\n"
        "    t.collect(ctx.sql('SELECT k FROM t'))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "trace.json").exists() and (tmp_path / "prof" / "trace.json").exists()
    banned = re.compile(r"^\s*(import|from) (jax|datafusion_tpu)(\.|\s|$)")
    for sub in ("obs", "utils"):
        folder = os.path.join(repo, "datafusion_tpu_torch", sub)
        for name in os.listdir(folder):
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    assert not any(banned.match(line) for line in f), name


def test_flusher_appends_finished_spans_as_json_lines(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    assert trace.start_flusher(path, interval_s=0.05)
    try:
        with trace.session() as tc:
            for name in ("a", "b"):
                with trace.span(name):
                    pass
    finally:
        trace.stop_flusher()
    with open(path) as f:
        got = [json.loads(line) for line in f if line.strip()]
    assert [s["name"] for s in got if s["trace_id"] == tc.trace_id] == ["a", "b"]
    assert trace.start_flusher(None, interval_s=0) is False  # no file: no thread
