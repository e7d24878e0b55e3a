"""PyTorch/CUDA port: tail attribution and per-client metering
(`datafusion_tpu_torch.obs.attribution`).

The cases of the JAX package's `tests/test_attribution.py` that need no
cluster, HTTP route or SLO watchdog, on the port, each held against the
JAX package where both compute the same thing:

- the same `Meter` numbers under solo, nested and shared scopes (launch
  walls, H2D bytes, hedge duplicates, the cardinality cap), and the
  scopes' accumulators, nesting and thread locality;
- the same pin byte-second accrual over each package's device ledger,
  and an evicted pin (the port's ledger calls `forget_pin`) stops
  accruing;
- the same `TailExplainer.explain` on the same paths (numpy-seeded), and
  the same `critical_path_from_spans` and `hedge_loser_span_ids` on the
  same span dicts (hedge losers, winners, failover retries);
- the same gauge and text surfaces (`tenant_gauges`,
  `clients_from_gauges`, `tenants_text_from_gauges`), and
  `ExecutionContext.metrics_text` carrying the tenant gauges;
- the metering seams of the port: `device_call`'s launch wall, a pass
  on the card charged its device time when its scope closes, the copy
  seam's bytes, the join build pin's client;
- served on `ExecutionContext(device="cpu")`: per-client metering with
  conservation (the clients' device seconds are the round's launch
  wall), served paths with their segments in the explainer, client ids
  on flight events, the idempotent shed and the stop drain.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from datafusion_tpu.obs import attribution as jatt
from datafusion_tpu.obs.device import LEDGER as JAX_LEDGER

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.errors import QueryShedError
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.obs import attribution as tatt
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.utils.metrics import METRICS

T = tdf.DataType
WAIT = 60


@pytest.fixture(autouse=True)
def _clean_attribution():
    jatt.reset_for_tests()
    tatt.reset_for_tests()
    yield
    jatt.reset_for_tests()
    tatt.reset_for_tests()


def _both(scenario):
    """Run `scenario(attribution module)` on both packages; return both."""
    return scenario(jatt), scenario(tatt)


# -- the meter ----------------------------------------------------------------


def _meter_scenario(att):
    with att.client_scope("alice") as acc:
        att.note_launch(0.25)
        att.charge_h2d(1000)
        with att.shared_scope((("a", 0.5), ("b", 0.25), ("c", 0.25))) as shared:
            att.note_launch(1.0)
            att.charge_h2d(4000)
        assert att.current_client() == "alice"
        att.note_launch(0.125)
    att.note_launch(9.0)  # no scope: nobody pays
    att.charge_h2d(1 << 20)
    att.charge_hedge_loss(("solo", "alice", [0.0]), 0.7)
    att.charge_hedge_loss(None, 1.0)
    att.METER.charge("b", "queries", 2)
    return att.METER.snapshot(), att.METER.totals(), acc[0], shared[0], att.current_scope()


def test_meter_numbers_equal_the_jax_package():
    want, got = _both(_meter_scenario)
    assert got == want
    snap = got[0]
    assert snap["alice"]["device_seconds"] == pytest.approx(0.375)
    assert snap["a"]["device_seconds"] == pytest.approx(0.5)
    assert sum(s["h2d_bytes"] for s in snap.values()) == pytest.approx(5000.0)
    assert snap["alice"]["hedge_duplicate_seconds"] == pytest.approx(0.7)
    assert got[2] == pytest.approx(0.375) and got[3] == pytest.approx(1.0)
    assert got[4] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_scope_splits_conserve_as_in_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, 5)
    members = tuple((f"c{i}", float(x / w.sum())) for i, x in enumerate(w))
    walls = rng.uniform(1e-4, 1e-2, 20).tolist()

    def scenario(att):
        with att.shared_scope(members) as acc:
            for x in walls:
                att.note_launch(x)
        return att.METER.snapshot(), acc[0]

    want, got = _both(scenario)
    assert got == want
    assert sum(c["device_seconds"] for c in got[0].values()) == pytest.approx(sum(walls))


def test_scope_is_per_thread():
    seen = {}

    def other():
        seen["client"] = tatt.current_client()

    with tatt.client_scope("main-only"):
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert seen["client"] is None


def test_client_cardinality_is_bounded(monkeypatch):
    monkeypatch.setattr(jatt, "_MAX_CLIENTS", 4)
    monkeypatch.setattr(tatt, "_MAX_CLIENTS", 4)

    def scenario(att):
        for i in range(10):
            att.METER.charge(f"user-{i}", "device_seconds", 1.0)
        return att.METER.snapshot(), att.METER.totals()

    want, got = _both(scenario)
    assert got == want
    assert got[0][tatt._OVERFLOW]["device_seconds"] == pytest.approx(6.0)


# -- pin accrual ----------------------------------------------------------------


def test_pin_byte_seconds_accrue_as_in_the_jax_package():
    def scenario(att, ledger):
        fp = "table:attr_test_pin"
        ledger.pin(fp, nbytes=1000, owner="pin.attr_test")
        try:
            t0 = time.monotonic()
            att.register_pin_client(fp, "carol")
            att._PIN_ACCRUED_AT[fp] = t0
            att.accrue_pins(now=t0 + 10.0)
            first = att.METER.snapshot()
            att.note_pin_use(fp, "dan")
            att.note_pin_use(fp, "dan")
            att.note_pin_use(fp, "erin")
            att.accrue_pins(now=t0 + 13.0)
            return first, att.METER.snapshot()
        finally:
            ledger.unpin(fp)

    want = scenario(jatt, JAX_LEDGER)
    got = scenario(tatt, LEDGER)
    assert got == want
    assert got[0]["carol"]["pin_byte_seconds"] == pytest.approx(10_000.0)
    assert got[1]["dan"]["pin_byte_seconds"] == pytest.approx(2_000.0)


def test_evicted_pin_stops_accruing():
    """The port's ledger forgets a pin wherever it drops one (an unpin,
    a pressure eviction), so its byte-seconds stop at once."""
    for evict in (lambda fp: LEDGER.unpin(fp), lambda fp: LEDGER.evict_pins(1 << 40)):
        fp = "table:attr_test_evict"
        LEDGER.pin(fp, nbytes=500, owner="pin.attr_test")
        t0 = time.monotonic()
        tatt.register_pin_client(fp, "dave")
        tatt._PIN_ACCRUED_AT[fp] = t0
        evict(fp)
        assert fp not in tatt._PIN_CLIENTS
        tatt.accrue_pins(now=t0 + 100.0)
        assert "dave" not in tatt.METER.snapshot()


# -- the tail explainer -----------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_tail_explainer_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    segs = ["queue_wait", "admission", "megabatch_window", "shared_launch_share",
            "demux_pull", "merge", "other"]
    paths = []
    for _ in range(200):
        vals = rng.exponential(0.01, len(segs)) * (rng.random(len(segs)) < 0.8)
        seg = {s: float(v) for s, v in zip(segs, vals) if v > 0}
        paths.append((float(sum(seg.values())), seg))
    jex, tex = jatt.TailExplainer(), tatt.TailExplainer()
    for wall, seg in paths:
        jex.observe(wall, seg)
        tex.observe(wall, seg)
    assert tex.explain() == jex.explain()
    assert len(tex) == len(jex) == 200


def test_explainer_feeds_and_fallback():
    def scenario(att):
        att.observe_phases(2.0, {"decode": 1.5, "h2d": 0.5})
        with att.client_scope("a"):
            att.observe_phases(2.0, {"decode": 1.5})  # served: skipped
        att.observe_phases(3.0, None)
        att.observe_path("erin", 1.0, {"queue_wait": 1.0})
        rep = att.EXPLAINER.explain()
        rep.pop("window_s")
        return rep, att.METER.snapshot(), att.queue_wait_share()

    want, got = _both(scenario)
    assert got == want
    assert got[0]["kinds"] == {"phases": 2, "served": 1}
    assert got[1]["erin"]["queries"] == 1.0


# -- span-tree critical paths -------------------------------------------------------


def _span(name, start_ms, end_ms, span_id, parent_id=None, trace_id="t1", **attrs):
    return {"name": name, "trace_id": trace_id, "span_id": span_id, "parent_id": parent_id,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6), "attrs": attrs}


SPAN_CASES = {
    "union_and_other": [
        _span("query", 0, 100, "root"),
        _span("coord.dispatch", 10, 50, "d1", "root", shard=0),
        _span("coord.dispatch", 30, 70, "d2", "root", shard=1),
        _span("merge", 70, 90, "m1", "root"),
    ],
    "lost_hedge": [
        _span("query", 0, 100, "root"),
        _span("coord.dispatch", 10, 40, "rec", "root", shard=0, hedged=True),
        _span("coord.dispatch", 15, 95, "lose", "root", shard=0, hedged=True,
              hedge_attempt=True),
        _span("worker.fragment", 16, 94, "wf", "lose", shard=0),
        _span("merge", 40, 50, "m", "root"),
    ],
    "won_hedge": [
        _span("query", 0, 100, "root"),
        _span("coord.dispatch", 10, 40, "rec", "root", shard=0, hedged=True,
              hedge_won=True, winner="w2:1"),
        _span("coord.dispatch", 20, 40, "att", "root", shard=0, hedged=True,
              hedge_attempt=True),
        _span("worker.fragment", 21, 39, "wf", "att", shard=0),
    ],
    "failover": [
        _span("query", 0, 3500, "root"),
        _span("coord.dispatch", 1000, 1500, "a0", "root", shard=0, attempt=0,
              failed_over=True),
        _span("coord.dispatch", 1500, 3000, "a1", "root", shard=0, attempt=1),
        _span("worker.fragment", 1600, 2900, "wf", "a1", shard=0),
    ],
    "distinct_shards": [
        _span("query", 0, 50, "root"),
        _span("coord.dispatch", 0, 30, "d1", "root", shard=0),
        _span("coord.dispatch", 0, 40, "d2", "root", shard=1),
    ],
    "empty": [],
    "unended": [{"name": "x", "span_id": "a", "start_ns": 5, "end_ns": 0}],
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_critical_path_equals_the_jax_package(case):
    spans = SPAN_CASES[case]
    assert tatt.critical_path_from_spans(spans) == jatt.critical_path_from_spans(spans)
    live = [s for s in spans if s.get("end_ns")]
    assert tatt.hedge_loser_span_ids(live) == jatt.hedge_loser_span_ids(live)


def test_lost_hedge_is_excluded_and_reported_as_duplicate():
    cp = tatt.critical_path_from_spans(SPAN_CASES["lost_hedge"])
    assert cp["segments"]["coord.dispatch"] == pytest.approx(0.030)
    assert cp["excluded_spans"] == 2 and cp["hedge_loser_s"] == pytest.approx(0.080)
    assert sum(cp["segments"].values()) == pytest.approx(cp["wall_s"])


# -- surfaces -----------------------------------------------------------------------


def test_gauges_and_texts_equal_the_jax_package():
    def scenario(att):
        att.METER.charge("kate", "device_seconds", 0.25)
        att.METER.charge("kate", "queries", 1)
        att.METER.charge("dotted.id", "h2d_bytes", 2e6)
        gauges = att.tenant_gauges()
        fleet = {"fleet.tenant.ana.device_seconds": 1.5, "fleet.tenant.ana.queries": 3.0,
                 "tenant.dotted.id.h2d_bytes": 2e6, "fleet.nodes": 2}
        return (gauges, att.clients_from_gauges(fleet), att.tenants_text_from_gauges(fleet),
                att.tenants_text().splitlines()[:4])

    want, got = _both(scenario)
    assert got == want
    assert got[0]["tenant.kate.device_seconds"] == 0.25
    assert "conservation:" in tatt.tenants_text()


def test_metrics_text_carries_tenant_gauges():
    tatt.METER.charge("gina", "device_seconds", 1.25)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    assert 'name="tenant.gina.device_seconds"} 1.25' in ctx.metrics_text()


# -- the port's metering seams --------------------------------------------------------


def test_device_call_and_copy_seams_charge_the_scope():
    from datafusion_tpu_torch.exec.batch import to_device
    from datafusion_tpu_torch.utils.retry import device_call

    import torch

    dispatch0 = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0)
    with tatt.client_scope("solo") as acc:
        device_call(lambda: time.sleep(0.002), _tag="test")
        to_device(np.zeros(1000, np.float64), torch.device("cpu"))
    with tatt.shared_scope((("x", 0.75), ("y", 0.25))):
        device_call(lambda: time.sleep(0.002), _tag="test")
    snap = tatt.METER.snapshot()
    assert snap["solo"]["device_seconds"] == pytest.approx(acc[0]) and acc[0] > 0
    assert snap["solo"]["h2d_bytes"] == 8000.0
    assert snap["x"]["device_seconds"] == pytest.approx(3 * snap["y"]["device_seconds"])
    dispatch = METRICS.snapshot()["timings_s"]["device.dispatch"] - dispatch0
    metered = sum(c["device_seconds"] for c in snap.values())
    assert metered == pytest.approx(dispatch, rel=1e-9)


class _EventStub:
    """A CUDA event's timing surface: `elapsed_time` in ms, as the card's."""

    def __init__(self, at_ms: float):
        self.at_ms, self.waited = at_ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end) -> float:
        return end.at_ms - self.at_ms


def test_a_pass_on_the_card_is_charged_its_device_time_when_its_scope_closes():
    """A pass on the card queues its work and returns: `note_launch`
    keeps its event pairs (one a segment of the gated pass), and the
    scope's exit waits for the last one
    and charges each pair's device time to the meter, the scope's
    accumulator and the `device.dispatch` timer, split by weight when
    shared; a failing wait charges nothing and does not raise."""
    dispatch0 = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0)
    pairs = [(_EventStub(0.0), _EventStub(3.0)), (_EventStub(5.0), _EventStub(6.5))]
    with tatt.client_scope("heavy") as acc:
        tatt.note_launch(0.0, pairs[:1])
        tatt.note_launch(0.0, pairs[1:])
        assert "heavy" not in tatt.METER.snapshot() and acc[0] == 0.0
    assert acc[0] == pytest.approx(4.5e-3) and pairs[-1][1].waited
    assert tatt.METER.snapshot()["heavy"]["device_seconds"] == pytest.approx(4.5e-3)
    with tatt.shared_scope((("x", 0.75), ("y", 0.25))):
        tatt.note_launch(0.0, [(_EventStub(1.0), _EventStub(9.0))])
    snap = tatt.METER.snapshot()
    assert snap["x"]["device_seconds"] == pytest.approx(6e-3)
    assert snap["y"]["device_seconds"] == pytest.approx(2e-3)
    dispatch = METRICS.snapshot()["timings_s"]["device.dispatch"] - dispatch0
    assert dispatch == pytest.approx(12.5e-3)

    class _Broken(_EventStub):
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    errors0 = METRICS.counts.get("obs.telemetry_errors", 0)
    with tatt.client_scope("failed") as acc:
        tatt.note_launch(0.0, [(_EventStub(0.0), _Broken(1.0))])
    assert acc[0] == 0.0 and "failed" not in tatt.METER.snapshot()
    assert METRICS.counts.get("obs.telemetry_errors", 0) == errors0 + 1


def _table(seed: int, rows: int = 2048, batches: int = 2):
    rng = np.random.default_rng(seed)
    schema = tdf.Schema([tdf.Field("k", T.UTF8, False), tdf.Field("v", T.FLOAT64, False),
                         tdf.Field("p", T.FLOAT64, False)])
    d = tdf.StringDictionary()
    out = []
    for _ in range(batches):
        codes = d.encode([f"g{j}" for j in rng.integers(0, 8, rows)])
        out.append(tdf.make_host_batch(
            schema, [codes, np.round(rng.uniform(0, 100, rows), 2),
                     np.round(rng.uniform(0, 1, rows), 3)], dicts=[d, None, None]))
    return MemoryDataSource(schema, out)


def _q(lit: float) -> str:
    return f"SELECT k, SUM(v), COUNT(1) FROM t WHERE p < {lit} GROUP BY k"


def _ctx(seed: int) -> tdf.ExecutionContext:
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", _table(seed))
    return ctx


def test_per_client_metering_and_conservation():
    """Every launch of a served round runs under a client's scope (solo)
    or its megabatch's members (shared), so the clients' device seconds
    sum to the round's launch wall; the first client to pin the table
    pays its residency."""
    ctx = _ctx(21)
    disp0 = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0)
    srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=8)
    try:
        tickets = [srv.submit(_q(0.3 + 0.02 * i), client_id=f"client{i % 2}")
                   for i in range(8)]
        for t in tickets:
            t.result(timeout=WAIT)
    finally:
        srv.stop()
    snap = tatt.METER.snapshot()
    assert snap["client0"]["queries"] == 4 and snap["client1"]["queries"] == 4
    launch_wall = METRICS.snapshot()["timings_s"]["device.dispatch"] - disp0
    dev_sum = sum(c["device_seconds"] for c in snap.values())
    assert launch_wall > 0 and dev_sum == pytest.approx(launch_wall, rel=1e-6)
    assert srv.admitted + srv.shed == srv.submitted


def test_pinned_table_pays_its_holder_until_evicted():
    ctx = _ctx(22)
    with ctx.serve(workers=1, window_s=0.001) as srv:
        srv.submit(_q(0.4), client_id="holder").result(timeout=WAIT)
        assert tatt._PIN_CLIENTS.get("table:t") == "holder"
        t0 = time.monotonic()
        tatt._PIN_ACCRUED_AT["table:t"] = t0
        tatt.accrue_pins(now=t0 + 5.0)
        assert tatt.METER.snapshot()["holder"]["pin_byte_seconds"] > 0
    assert "table:t" not in tatt._PIN_CLIENTS  # stop() unpinned it


def test_join_build_pin_attributes_to_the_building_client():
    rng = np.random.default_rng(23)
    dim_s = tdf.Schema([tdf.Field("id", T.INT64, False), tdf.Field("w", T.FLOAT64, False)])
    fact_s = tdf.Schema([tdf.Field("fk", T.INT64, False), tdf.Field("x", T.FLOAT64, False)])
    dim = MemoryDataSource(dim_s, [tdf.make_host_batch(
        dim_s, [np.arange(50), rng.uniform(0, 1, 50)], None, None)])
    fact = MemoryDataSource(fact_s, [tdf.make_host_batch(
        fact_s, [rng.integers(0, 50, 4000), rng.uniform(0, 1, 4000)], None, None)])
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("dim", dim)
    ctx.register_datasource("fact", fact)
    sql = "SELECT SUM(x * w) FROM fact JOIN dim ON fk = id"
    with ctx.serve(workers=1, window_s=0.001) as srv:
        srv.submit(sql, client_id="owner").result(timeout=WAIT)
        builds = [fp for fp in tatt._PIN_CLIENTS if fp.startswith("join:")]
        assert len(builds) == 1 and tatt._PIN_CLIENTS[builds[0]] == "owner"
        srv.submit(sql, client_id="prober").result(timeout=WAIT)
        assert tatt._PIN_USERS[builds[0]].get("prober") == 1.0
    assert not [fp for fp in tatt._PIN_CLIENTS if fp.startswith("join:")]


def test_served_paths_feed_explainer_with_segments():
    ctx = _ctx(24)
    with ctx.serve(workers=1, window_s=0.01) as srv:
        for i in range(3):
            srv.submit(_q(0.4 + 0.01 * i), client_id="nina").result(timeout=WAIT)
    rep = tatt.EXPLAINER.explain()
    assert rep["kinds"].get("served", 0) == 3
    seen = {r["segment"] for r in rep["segments"]}
    assert {"queue_wait", "admission", "megabatch_window", "merge", "other"} <= seen
    assert tatt.METER.snapshot()["nina"]["queries"] == 3


def test_flight_events_and_sheds_carry_the_client():
    ctx = _ctx(25)
    srv = ctx.serve(workers=1, window_s=0.005, queue_depth=1)
    shed, tickets = 0, []
    try:
        for i in range(8):
            try:
                tickets.append(srv.submit(_q(0.3 + 0.01 * i), client_id="oscar"))
            except QueryShedError:
                shed += 1
        for t in tickets:
            t.result(timeout=WAIT)
    finally:
        srv.stop()
    kinds: dict = {}
    for ev in recorder.events():
        if ev["kind"].startswith("serve."):
            kinds.setdefault(ev["kind"], []).append((ev.get("attrs") or {}).get("client"))
    assert "oscar" in kinds.get("serve.admit", [])
    assert "oscar" in kinds.get("serve.done", [])
    if shed:
        assert "oscar" in kinds.get("serve.shed", [])
    assert tatt.METER.snapshot()["oscar"]["shed"] == shed
    assert srv.admitted + srv.shed == srv.submitted


def test_shed_ticket_idempotent_and_stop_drain():
    ctx = _ctx(26)
    srv = ctx.serve(workers=1, window_s=30.0, megabatch_max=64)
    try:
        t = srv.submit(_q(0.4), client_id="pete")
        t2 = srv.submit(_q(0.41), client_id="quinn")
        time.sleep(0.05)
        assert srv._pending == 2
        srv._shed_ticket(t, "deadline")
        srv._shed_ticket(t, "shutdown")  # a duplicate: no effect
        assert srv._pending == 1 and srv.shed == 1
    finally:
        srv.stop()
    with pytest.raises(QueryShedError) as ei:
        t2.result(timeout=5.0)
    assert ei.value.reason == "shutdown"
    assert srv._pending == 0 and srv.shed == 2
    assert srv.admitted + srv.shed == srv.submitted
    snap = tatt.METER.snapshot()
    assert snap["pete"]["shed"] == 1 and snap["quinn"]["shed"] == 1
