"""PyTorch/CUDA port: the serving front door (`datafusion_tpu_torch.serve`).

The cases of the JAX package's `tests/test_serve.py`, on the port with
`device="cpu"` and the same small tables:

- megabatched answers equal serialized ones, exactly;
- client threads over a hot and a cold table get exactly one correct
  result each;
- a warm pinned table copies nothing to the device
  (`device.h2d.transfers`, `h2d.bytes`);
- eviction under a small `DATAFUSION_TPU_HBM_BYTES`, and `hbm` sheds
  once nothing fits;
- queue and deadline sheds; the megabatch counters (fewer query-axis
  reductions than queries); `stop` sheds a queued ticket promptly; a
  plan error counts on neither side; without a server nothing serving
  engages.

`admitted + shed == submitted` is asserted on every server.  Then the
port's served rows against the JAX package's served rows for the same
SQL on the same table (the aggregate, TopK and pipeline lanes; ints and
strings exactly, floats within rtol 1e-9), and each lane's megabatched
answers against the port's own solo answers, bit for bit.  Every wait
has a timeout.
"""

from __future__ import annotations

import gc
import os
import threading
import time

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.batch import StringDictionary as JaxDictionary
from datafusion_tpu.exec.batch import make_host_batch as jax_make_host_batch
from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemorySource

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import convert
from datafusion_tpu_torch.errors import DataFusionError, NotSupportedError, QueryShedError
from datafusion_tpu_torch.exec.cuda import hash_agg
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.serve import PinnedSource
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.wal import atomic_write_json, read_json

from test_torch_pipeline import assert_same

T = tdf.DataType
WAIT = 60


def _table(seed: int, rows: int = 4096, batches: int = 4, groups: int = 16):
    rng = np.random.default_rng(seed)
    schema = tdf.Schema([
        tdf.Field("k", T.UTF8, False),
        tdf.Field("v", T.FLOAT64, False),
        tdf.Field("p", T.FLOAT64, False),
    ])
    d = tdf.StringDictionary()
    out = []
    for _ in range(batches):
        codes = d.encode([f"g{j}" for j in rng.integers(0, groups, rows)])
        v = np.round(rng.uniform(0, 100, rows), 2)
        p = np.round(rng.uniform(0, 1, rows), 3)
        out.append(tdf.make_host_batch(schema, [codes, v, p], dicts=[d, None, None]))
    return schema, MemoryDataSource(schema, out)


def _ctx(tables: dict) -> tdf.ExecutionContext:
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    for name, (_, ds) in tables.items():
        ctx.register_datasource(name, ds)
    return ctx


def _q(table: str, lit: float) -> str:
    return f"SELECT k, SUM(v), COUNT(1) FROM {table} WHERE p < {lit} GROUP BY k"


def _count(name: str) -> int:
    return METRICS.snapshot()["counts"].get(name, 0)


@pytest.fixture(autouse=True)
def _no_hbm_cap():
    """Each test owns the capacity knob; start clean, restore after."""
    prior = os.environ.pop("DATAFUSION_TPU_HBM_BYTES", None)
    yield
    if prior is None:
        os.environ.pop("DATAFUSION_TPU_HBM_BYTES", None)
    else:
        os.environ["DATAFUSION_TPU_HBM_BYTES"] = prior


# ------------------------------------------- the JAX package's cases


def test_megabatched_answers_match_serialized():
    ctx = _ctx({"t": _table(1)})
    lits = [0.2 + 0.05 * i for i in range(6)]
    want = {lit: sorted(tdf.collect(ctx.sql(_q("t", lit))).to_rows()) for lit in lits}
    before = _count("serve.megabatch_launches")
    srv = ctx.serve(workers=2, window_s=0.02, megabatch_max=16)
    try:
        tickets = [(lit, srv.submit(_q("t", lit))) for lit in lits]
        for lit, t in tickets:
            assert sorted(t.result(timeout=WAIT).to_rows()) == want[lit]
    finally:
        srv.stop()
    assert _count("serve.megabatch_launches") > before
    assert srv.admitted + srv.shed == srv.submitted


def test_unpinned_megabatch_matches_serialized_bit_for_bit():
    """With pinning off (`pin=False`) the table streams: a megabatch
    scans the leader's batches with one encoder for every member."""
    ctx = _ctx({"t": _table(15)})
    lits = [0.1 + 0.1 * i for i in range(5)]
    want = [tdf.collect(ctx.sql(_q("t", lit))) for lit in lits]
    mega0 = _count("serve.megabatch_queries")
    srv = ctx.serve(workers=1, window_s=0.2, megabatch_max=16, pin=False)
    try:
        got = _serve_all(srv, [_q("t", lit) for lit in lits])
    finally:
        srv.stop()
    assert _count("serve.megabatch_queries") - mega0 == len(lits)
    assert type(ctx.datasources["t"]) is MemoryDataSource
    for g, w in zip(got, want):
        assert _sorted_bits(g) == _sorted_bits(w)
    assert srv.admitted + srv.shed == srv.submitted


def test_concurrent_clients_mixed_tables_exactly_once():
    ctx = _ctx({"hot": _table(2), "cold": _table(3)})
    srv = ctx.serve(workers=2, window_s=0.005)
    results: dict = {}
    errors: list = []

    def client(i: int):
        table = "hot" if i % 3 else "cold"
        try:
            t = srv.submit(_q(table, 0.25 + 0.01 * i))
            results[i] = sorted(t.result(timeout=WAIT).to_rows())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
    finally:
        srv.stop()
    assert not errors, errors
    assert len(results) == 12
    for i, rows in results.items():
        table = "hot" if i % 3 else "cold"
        assert rows == sorted(tdf.collect(ctx.sql(_q(table, 0.25 + 0.01 * i))).to_rows()), i
    assert srv.admitted + srv.shed == srv.submitted
    assert srv.admitted == 12


def test_warm_pinned_table_skips_h2d_entirely():
    ctx = _ctx({"t": _table(4)})
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        srv.submit(_q("t", 0.4)).result(timeout=WAIT)  # cold: pins
        srv.submit(_q("t", 0.45)).result(timeout=WAIT)  # warm ids
        before = _count("device.h2d.transfers")
        bytes_before = _count("h2d.bytes")
        encode_before = METRICS.snapshot()["timings_s"].get("agg.host_encode", 0.0)
        for i in range(4):
            srv.submit(_q("t", 0.5 + 0.01 * i)).result(timeout=WAIT)
        assert _count("device.h2d.transfers") == before
        assert _count("h2d.bytes") == bytes_before
        # the ids replay: no host encode either
        assert METRICS.snapshot()["timings_s"].get("agg.host_encode", 0.0) == encode_before
        assert "table:t" in LEDGER.pins_snapshot()
    finally:
        srv.stop()
    # stopped: the pin is released and the context has its source back
    assert "table:t" not in LEDGER.pins_snapshot()
    assert type(ctx.datasources["t"]) is MemoryDataSource
    assert srv.admitted + srv.shed == srv.submitted


def test_eviction_under_small_hbm_cap():
    ctx = _ctx({"a": _table(5), "b": _table(6)})
    # drop pins left by earlier tests: the eviction below must have
    # exactly one candidate (a)
    for fp in list(LEDGER.pins_snapshot()):
        LEDGER.unpin(fp)
    gc.collect()
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        # no cap yet: the capacity is unknown on the CPU, nothing sheds
        srv.submit(_q("a", 0.4)).result(timeout=WAIT)
        assert "table:a" in LEDGER.pins_snapshot()
        # b fits only once a is evicted (the ledger is process-wide, so
        # the cap is set relative to its live bytes)
        est_b = PinnedSource(ctx.datasources["b"], "b").estimated_bytes()
        os.environ["DATAFUSION_TPU_HBM_BYTES"] = str(LEDGER.live_bytes() + est_b // 2)
        ev_before = _count("device.pin_evictions")
        rows = sorted(srv.submit(_q("b", 0.4)).result(timeout=WAIT).to_rows())
        pins = LEDGER.pins_snapshot()
        assert "table:b" in pins and "table:a" not in pins
        assert _count("device.pin_evictions") > ev_before
        assert not ctx.datasources["a"].resident
        # and every admitted answer stays exact
        assert rows == sorted(tdf.collect(ctx.sql(_q("b", 0.4))).to_rows())
        # a cap nothing fits under: admission sheds "hbm"
        os.environ["DATAFUSION_TPU_HBM_BYTES"] = "1000"
        ctx.register_datasource("c", _table(7)[1])
        with pytest.raises(QueryShedError) as ei:
            srv.submit(_q("c", 0.4))
        assert ei.value.reason == "hbm"
    finally:
        srv.stop()
    assert srv.admitted + srv.shed == srv.submitted


def test_queue_depth_shed():
    ctx = _ctx({"t": _table(8)})
    srv = ctx.serve(workers=1, window_s=0.005, queue_depth=2)
    shed = 0
    try:
        tickets = []
        for i in range(12):
            try:
                tickets.append(srv.submit(_q("t", 0.3 + 0.01 * i)))
            except QueryShedError as e:
                assert e.reason == "queue"
                shed += 1
        for t in tickets:
            t.result(timeout=WAIT)
    finally:
        srv.stop()
    assert shed >= 1
    assert srv.admitted + srv.shed == srv.submitted
    assert _count("queries_shed") >= shed


def test_deadline_shed():
    ctx = _ctx({"t": _table(9)})
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        srv.submit(_q("t", 0.4)).result(timeout=WAIT)  # seeds the service time
        with pytest.raises(QueryShedError) as ei:
            srv.submit(_q("t", 0.41), deadline_s=0.0)
        assert ei.value.reason == "deadline"
    finally:
        srv.stop()
    assert srv.admitted + srv.shed == srv.submitted


def test_megabatch_counters_and_launch_amortization(monkeypatch):
    ctx = _ctx({"t": _table(10)})
    calls = []
    real = hash_agg.grouped_reduce_multi

    def counted(*args, **kwargs):
        calls.append(args[2].shape[0])  # the call's query count
        return real(*args, **kwargs)

    monkeypatch.setattr(hash_agg, "grouped_reduce_multi", counted)
    srv = ctx.serve(workers=1, window_s=0.05, megabatch_max=16)
    try:
        srv.submit(_q("t", 0.3)).result(timeout=WAIT)  # pins
        mega0 = _count("serve.megabatch_launches")
        queries0 = _count("serve.megabatch_queries")
        n = 8
        tickets = [srv.submit(_q("t", 0.4 + 0.01 * i)) for i in range(n)]
        for t in tickets:
            t.result(timeout=WAIT)
        assert _count("serve.megabatch_launches") > mega0
        assert _count("serve.megabatch_queries") - queries0 == n
        # the row count and the SUM: one query-axis reduction each for
        # all n queries of the batch group, fewer than n in all
        assert 0 < len(calls) < n and sum(calls) == len(calls) * n
    finally:
        srv.stop()
    assert srv.admitted + srv.shed == srv.submitted


def test_stop_sheds_queued_tickets_promptly():
    ctx = _ctx({"t": _table(12)})
    # a long window keeps the ticket parked in the dispatcher
    srv = ctx.serve(workers=1, window_s=30.0, megabatch_max=64)
    t = srv.submit(_q("t", 0.4))
    time.sleep(0.05)
    srv.stop()
    with pytest.raises(QueryShedError) as ei:
        t.result(timeout=5.0)
    assert ei.value.reason == "shutdown"
    assert srv.admitted + srv.shed == srv.submitted


def test_plan_error_keeps_conservation():
    ctx = _ctx({"t": _table(13)})
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        with pytest.raises(DataFusionError):
            srv.submit("SELECT k FROM no_such_table GROUP BY k")
        assert (srv.submitted, srv.admitted, srv.shed) == (0, 0, 0)
        srv.submit(_q("t", 0.4)).result(timeout=WAIT)
        assert srv.admitted + srv.shed == srv.submitted == 1
    finally:
        srv.stop()


def test_default_off_path_untouched():
    ctx = _ctx({"t": _table(11)})
    pins0 = dict(LEDGER.pins_snapshot())
    q0, s0 = _count("queries_queued"), _count("queries_shed")
    assert tdf.collect(ctx.sql(_q("t", 0.4))).to_rows()
    assert LEDGER.pins_snapshot() == pins0
    assert (_count("queries_queued"), _count("queries_shed")) == (q0, s0)
    assert type(ctx.datasources["t"]) is MemoryDataSource



def test_stop_gives_back_sources_and_batch_caches():
    """`stop` swaps the registered source back and unpins the table; the
    in-memory batches, which the pin shared with the source, hold again
    exactly what they cached before the pin."""
    schema_ds = _table(16)[1]
    ctx = _ctx({"t": (None, schema_ds)})
    solo = sorted(tdf.collect(ctx.sql(_q("t", 0.4))).to_rows())
    batches = list(schema_ds.batches())
    before = [{k: id(v) for k, v in b.cache.items()} for b in batches]
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        for lit in (0.4, 0.5):
            srv.submit(_q("t", lit)).result(timeout=WAIT)
        assert isinstance(ctx.datasources["t"], PinnedSource)
        assert [{k: id(v) for k, v in b.cache.items()} for b in batches] != before
    finally:
        srv.stop()
    assert ctx.datasources["t"] is schema_ds
    assert "table:t" not in LEDGER.pins_snapshot()
    assert [{k: id(v) for k, v in b.cache.items()} for b in batches] == before
    assert sorted(tdf.collect(ctx.sql(_q("t", 0.4))).to_rows()) == solo
    assert srv.admitted + srv.shed == srv.submitted

# ------------------------------------------------- what is not ported


def test_unported_serving_options_raise(tmp_path):
    """`shares=` and `client_id=` still wait for their planes (items 11.1
    and 11.5); `pin_manifest=` and `ingest()` are ported: a manifest
    round trip with re-pinning at `start()`, and `Server.append`
    followed by a served query that sees the delta."""
    ctx = _ctx({"t": _table(14)})
    with pytest.raises(NotSupportedError, match="item 11.1"):
        ctx.serve(shares={"a": 1.0})
    manifest = str(tmp_path / "pins.json")
    srv = ctx.serve(workers=1, pin_manifest=manifest)
    try:
        with pytest.raises(NotSupportedError, match="item 11.5"):
            srv.submit(_q("t", 0.4), client_id="tenant-1")
        with pytest.raises(NotSupportedError, match="item 11.5"):
            srv.append("t", {"k": ["g0"], "v": [1.0], "p": [0.0]}, client_id="tenant-1")
        assert srv.submitted == 0
        before = sorted(srv.submit(_q("t", 0.4)).result(timeout=WAIT).to_rows())
        assert read_json(manifest) == {"pins": [{"table": "t", "fingerprint": "table:t"}]}
        assert srv.ingest() is ctx.ingest()
        ack = srv.append("t", {"k": ["zz"], "v": [5.0], "p": [0.1]})
        assert ack["rows"] == 1 and ack["rev"] == 1
        after = sorted(srv.submit(_q("t", 0.4)).result(timeout=WAIT).to_rows())
        assert after == sorted(before + [("zz", 5.0, 1)])
    finally:
        srv.stop()
    # the manifest keeps what was resident while serving; a new server
    # re-pins it at start(), before its first query
    assert read_json(manifest)["pins"][0]["table"] == "t"
    srv2 = ctx.serve(workers=1, pin_manifest=manifest)
    try:
        assert srv2.pins_rehydrated == 1
        assert "table:t" in LEDGER.pins_snapshot()
        assert sorted(srv2.submit(_q("t", 0.4)).result(timeout=WAIT).to_rows()) == after
    finally:
        srv2.stop()


def test_pin_manifest_from_the_wal_dir_and_a_missing_table(tmp_path, monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WAL_DIR", str(tmp_path))
    monkeypatch.delenv("DATAFUSION_TPU_SERVE_PIN_MANIFEST", raising=False)
    path = str(tmp_path / "pin_manifest.json")
    atomic_write_json(path, {"pins": [{"table": "gone"}, {"table": "t"}]})
    ctx = _ctx({"t": _table(15)})
    skipped = _count("serve.pin_rehydrate_skipped")
    with ctx.serve(workers=1) as srv:
        assert srv.pins_rehydrated == 1
        assert _count("serve.pin_rehydrate_skipped") == skipped + 1
        assert "table:t" in LEDGER.pins_snapshot()
    monkeypatch.delenv("DATAFUSION_TPU_WAL_DIR")
    with ctx.serve(workers=1) as srv:  # no manifest configured: none read
        assert srv.pins_rehydrated == 0


def test_append_to_a_pinned_table_copies_only_the_delta():
    """After `Server.append`, the next served query copies the delta's
    used columns and its group ids, not the table; the table's shared
    encoder encodes the delta alone; the ledger's pin grows by the
    delta; the answer is the rescan's."""
    schema, src = _table(16)
    ctx = _ctx({"t": (schema, src)})
    rng = np.random.default_rng(7)
    n = 300
    delta = {"k": [f"g{j}" for j in rng.integers(0, 20, n)],
             "v": np.round(rng.uniform(0, 100, n), 2), "p": np.round(rng.uniform(0, 1, n), 3)}
    srv = ctx.serve(workers=1, window_s=0.005)
    try:
        srv.submit(_q("t", 0.4)).result(timeout=WAIT)
        srv.submit(_q("t", 0.45)).result(timeout=WAIT)  # warm: nothing crosses
        pin0 = LEDGER.pins_snapshot()["table:t"]["bytes"]
        srv.append("t", delta)
        pinned = ctx.datasources["t"]
        assert isinstance(pinned, PinnedSource) and pinned.resident
        assert pinned._resident is pinned.inner.live_batches
        batch = pinned._resident[-1]
        assert batch.num_rows == n
        grown = LEDGER.pins_snapshot()["table:t"]["bytes"] - pin0
        assert grown == sum(a.nbytes for a in batch.data)
        h2d0 = _count("h2d.bytes")
        ticket = srv.submit(_q("t", 0.5))
        got = ticket.result(timeout=WAIT)
        # the columns the aggregate reads and the group ids (int32), at
        # the delta's capacity
        used = ticket._rel.core.used_cols
        want = sum(batch.data[c].nbytes for c in used) + 4 * batch.capacity
        assert batch.capacity == 1024 and used
        assert _count("h2d.bytes") - h2d0 == want
        h2d1 = _count("h2d.bytes")
        warm = srv.submit(_q("t", 0.55)).result(timeout=WAIT)
        assert _count("h2d.bytes") == h2d1  # warm again: nothing crosses
    finally:
        srv.stop()
    assert sorted(got.to_rows()) == sorted(tdf.collect(ctx.sql(_q("t", 0.5))).to_rows())
    assert sorted(warm.to_rows()) == sorted(tdf.collect(ctx.sql(_q("t", 0.55))).to_rows())
    assert srv.admitted + srv.shed == srv.submitted


def test_create_materialized_view_through_submit():
    ctx = _ctx({"t": _table(17)})
    with ctx.serve(workers=1) as srv:
        out = srv.submit("CREATE MATERIALIZED VIEW mv AS SELECT k, SUM(v), COUNT(1) "
                         "FROM t GROUP BY k").result(timeout=WAIT)
        assert repr(out) == "Registered materialized view mv (incremental)"
        assert srv.submitted == 0
        srv.append("t", {"k": ["g1"], "v": [2.5], "p": [0.5]})
        assert sorted(ctx.ingest().read_view("mv").to_rows()) == sorted(
            tdf.collect(ctx.sql("SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k")).to_rows())


def test_served_join_sees_an_append_to_its_build_side():
    """The pinned join build is keyed on the build table's data identity,
    which an append changes: the next served join builds again and
    returns the appended row, never a stale build."""
    from datafusion_tpu_torch.join.relation import HashJoinRelation

    rng = np.random.default_rng(3)
    ls = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("v", T.INT64, False)])
    rs = tdf.Schema([tdf.Field("rk", T.INT64, False), tdf.Field("w", T.FLOAT64, False)])
    keys = np.arange(0, 400, 2, dtype=np.int64)
    probe = rng.integers(0, 400, 3000).astype(np.int64)
    ctx = _ctx({"l": (ls, MemoryDataSource(ls, [tdf.make_host_batch(
                    ls, [probe, np.arange(3000, dtype=np.int64)])])),
                "r": (rs, MemoryDataSource(rs, [tdf.make_host_batch(
                    rs, [keys, keys.astype(np.float64) / 2])]))})
    sql = "SELECT l.k, l.v, r.w FROM l JOIN r ON l.k = r.rk"

    def join_of(rel):
        while not isinstance(rel, HashJoinRelation):
            rel = rel.child
        return rel

    with ctx.serve(workers=1, window_s=0.001) as srv:
        t1 = srv.submit(sql)
        rows1 = t1.result(timeout=WAIT).to_rows()
        key1 = join_of(t1._rel).build_key
        assert key1 in LEDGER.pins_snapshot()
        new_key = int(probe[probe % 2 == 1][0])  # a probed key the build lacks
        assert all(r[0] != new_key for r in rows1)
        srv.append("r", {"rk": [new_key], "w": [-1.0]})
        t2 = srv.submit(sql)
        rows2 = t2.result(timeout=WAIT).to_rows()
        assert join_of(t2._rel).build_key != key1
        hits = int((probe == new_key).sum())
        assert sorted(rows2) == sorted(rows1 + [(new_key, int(v), -1.0)
                                                for v in np.nonzero(probe == new_key)[0]])
        assert sum(1 for r in rows2 if r[0] == new_key) == hits


# ------------------------------------------- each lane: solo, bit for bit


def _bits(table):
    return [(np.asarray(c).tobytes(), None if v is None else np.asarray(v).tobytes())
            for c, v in zip(table.columns, table.validity)]


def _sorted_bits(table):
    order = np.argsort(np.asarray(table.columns[0]).astype(str), kind="stable")
    return [(np.asarray(c)[order].tobytes(),
             None if v is None else np.asarray(v)[order].tobytes())
            for c, v in zip(table.columns, table.validity)]


LINEITEM_Q1 = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity), SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "AVG(l_quantity), AVG(l_discount), MIN(l_extendedprice), MAX(l_tax), COUNT(1) "
    "FROM lineitem WHERE l_shipdate <= '{}' GROUP BY l_returnflag, l_linestatus"
)


def _lineitem(n=20_000, batch_rows=4096, seed=42):
    rng = np.random.default_rng(seed)
    dates = [str(np.datetime64("1992-01-02") + np.timedelta64(i, "D")) for i in range(400)]
    J = jdf.DataType
    fields = [("l_returnflag", J.UTF8), ("l_linestatus", J.UTF8),
              ("l_quantity", J.FLOAT64), ("l_extendedprice", J.FLOAT64),
              ("l_discount", J.FLOAT64), ("l_tax", J.FLOAT64), ("l_shipdate", J.UTF8)]
    jschema = jdf.Schema([jdf.Field(n_, t, False) for n_, t in fields])
    cols = [np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
            np.array(["F", "O"])[rng.integers(0, 2, n)],
            np.floor(rng.uniform(1, 51, n)), np.round(rng.uniform(900, 104950, n), 2),
            rng.integers(0, 11, n) / 100.0, rng.integers(0, 9, n) / 100.0,
            np.array(dates)[rng.integers(0, len(dates), n)]]
    dicts = [JaxDictionary() if t == J.UTF8 else None for _, t in fields]
    batches = []
    for lo in range(0, n, batch_rows):
        sl = slice(lo, lo + batch_rows)
        batches.append(jax_make_host_batch(
            jschema, [d.encode(list(c[sl])) if d is not None else c[sl]
                      for c, d in zip(cols, dicts)], None, dicts))
    src = JaxMemorySource(jschema, batches)
    return src, convert.memory_source(jschema.to_json(),
                                      [convert.export_batch(b) for b in batches]), dates


def _serve_all(srv, sqls):
    tickets = [srv.submit(s) for s in sqls]
    return [t.result(timeout=WAIT) for t in tickets]


def test_aggregate_lane_distinct_string_literals_megabatch_bit_for_bit(monkeypatch):
    """Q1-shaped queries that differ only in the l_shipdate cutoff: their
    cores differ in a string literal, share one megabatch, and each
    answer is its solo answer bit for bit."""
    _, src, dates = _lineitem()
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("lineitem", src)
    sqls = [LINEITEM_Q1.format(dates[40 * i + 7]) for i in range(8)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    calls = []
    real = hash_agg.grouped_reduce_multi
    monkeypatch.setattr(hash_agg, "grouped_reduce_multi",
                        lambda *a, **k: calls.append(a[2].shape[0]) or real(*a, **k))
    mega0 = _count("serve.megabatch_queries")
    srv = ctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    try:
        got = _serve_all(srv, sqls)
    finally:
        srv.stop()
    assert _count("serve.megabatch_queries") - mega0 == len(sqls)
    assert calls and all(q == len(sqls) for q in calls)
    for g, w in zip(got, solo):
        assert _sorted_bits(g) == _sorted_bits(w)
    assert srv.admitted + srv.shed == srv.submitted


def test_topk_lane_megabatches_limits_exactly():
    _, src, _ = _lineitem(seed=3)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("lineitem", src)
    sqls = [f"SELECT l_returnflag, l_extendedprice, l_quantity FROM lineitem "
            f"ORDER BY l_extendedprice DESC LIMIT {k}" for k in (10, 100, 1000, 7)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    mega0 = _count("serve.megabatch_queries")
    srv = ctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    try:
        got = _serve_all(srv, sqls)
    finally:
        srv.stop()
    assert _count("serve.megabatch_queries") - mega0 == len(sqls)
    for g, w in zip(got, solo):
        assert _bits(g) == _bits(w)


def test_pipeline_lane_megabatches_bit_for_bit():
    _, src, _ = _lineitem(seed=4)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("lineitem", src)
    sqls = [f"SELECT l_returnflag, l_quantity, l_extendedprice * (1 - l_discount) "
            f"FROM lineitem WHERE l_shipdate <= '1992-12-01' AND l_discount > {d / 100}"
            for d in range(8)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    mega0 = _count("serve.megabatch_queries")
    srv = ctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    try:
        got = _serve_all(srv, sqls)
    finally:
        srv.stop()
    assert _count("serve.megabatch_queries") - mega0 == len(sqls)
    for g, w in zip(got, solo):
        assert _bits(g) == _bits(w)


def test_served_csv_table_parses_once_and_megabatches_bit_for_bit(tmp_path, monkeypatch):
    """A CSV table whose dictionary grows mid-scan, served with the
    prefetch threads forced on: the pin parses the file once, its
    batches keep the dictionary versions the reader pinned on them, and
    aggregates whose string predicates differ (string MIN/MAX among the
    slots) megabatch, each answer its solo answer bit for bit over the
    same resident batches."""
    from datafusion_tpu_torch.exec.datasource import CsvDataSource

    from test_torch_fold import _csv_contexts, _growing_csv

    monkeypatch.setenv("DATAFUSION_TPU_PREFETCH", "1")
    _growing_csv(tmp_path / "grow.csv")
    _, ctx = _csv_contexts(tmp_path / "grow.csv")
    parses = []
    real = CsvDataSource.batches
    monkeypatch.setattr(CsvDataSource, "batches",
                        lambda self: parses.append(1) or real(self))
    sqls = [f"SELECT k, SUM(v), MIN(s), MAX(s), COUNT(1) FROM t WHERE s > 'w{i:02d}' "
            "GROUP BY k" for i in range(0, 20, 3)]
    mega0 = _count("serve.megabatch_queries")
    srv = ctx.serve(workers=2, window_s=0.2, megabatch_max=16)
    try:
        got = _serve_all(srv, sqls)
        again = _serve_all(srv, sqls)
        assert len(parses) == 1 and ctx.datasources["t"].resident
        # solo runs over the resident batches
        want = [tdf.collect(ctx.sql(sql)) for sql in sqls]
    finally:
        srv.stop()
    assert _count("serve.megabatch_queries") - mega0 == 2 * len(sqls)
    for g, a, w, sql in zip(got, again, want, sqls):
        assert _sorted_bits(g) == _sorted_bits(w) == _sorted_bits(a), sql
    assert srv.admitted + srv.shed == srv.submitted


# ----------------------------------------- served rows: port against JAX


@pytest.mark.parametrize("lane", ["aggregate", "topk", "pipeline"])
def test_served_rows_match_jax_packages_served_rows(lane):
    jsrc, tsrc, dates = _lineitem(seed=5)
    if lane == "aggregate":
        sqls = [LINEITEM_Q1.format(dates[60 * i + 30]) for i in range(4)]
    elif lane == "topk":
        sqls = [f"SELECT l_linestatus, l_extendedprice FROM lineitem "
                f"ORDER BY l_extendedprice DESC LIMIT {k}" for k in (5, 50, 500)]
    else:
        sqls = [f"SELECT l_returnflag, l_extendedprice * (1 - l_discount) FROM lineitem "
                f"WHERE l_quantity > {q}" for q in (10, 25, 40)]
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    jctx.register_datasource("lineitem", jsrc)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    tctx.register_datasource("lineitem", tsrc)
    jsrv = jctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    tsrv = tctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    try:
        want = _serve_all(jsrv, sqls)
        got = _serve_all(tsrv, sqls)
    finally:
        jsrv.stop()
        tsrv.stop()
    for g, w in zip(got, want):
        assert_same(g, w, ordered=lane == "topk")
    assert tsrv.admitted + tsrv.shed == tsrv.submitted == len(sqls)
