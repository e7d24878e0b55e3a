"""PyTorch/CUDA port: the cluster control plane (`datafusion_tpu_torch/cluster/`)
against the JAX package's (`datafusion_tpu/cluster/`).

Across the two packages:

- the state machine: one scripted sequence of leases, puts, expiry,
  invalidations, view advances, result publications, watches and a
  standby's promotion under one fake clock gives the same replies,
  revisions, events, epochs, deadlines and `snapshot_state` in both,
  lease ids normalised;
- the write-ahead log: a `ClusterNode` log written by either package is
  recovered by both with the same revisions, term, epoch, KV, result tier
  and re-armed lease deadlines;
- the wire, both ways: each package's `ClusterClient` against the other's
  `ClusterStateService` (leases, membership, watches, binary and delta
  result publication whose arrays come back bit for bit), and a JAX
  worker's agent registering with the port's service;
- the fleet: two port workers on the CPU found through a
  `LocalClusterClient` run TPC-H Q1 at SF 0.01 (4 CSV partitions) with the
  JAX package's rows (f64 rtol 1e-9, ints exact), a second coordinator's
  shared-tier hit has the same bits and dispatches nothing, and pin-aware
  placement routes to the worker whose lease advertises the table;
- pin placement and advertisement, and the heartbeat's telemetry
  piggyback (the JAX package's `tests/test_qos.py::TestPinPlacement`,
  `TestPinAdvertisement` and `tests/test_telemetry.py::
  TestClusterTelemetryPiggyback`), each decision held against the JAX
  package's.

Then the behaviours of the JAX package's `tests/test_cluster.py`, its 14
classes case for case on the port (`TestClusterState` to
`TestWatchChurnChaos`), with the port's contexts on the CPU.  Fake clocks
(`now=`) where the JAX cases use them; no case sleeps past a TTL of a
second.
"""

from __future__ import annotations

import functools
import os
import shutil
import threading
import time

import numpy as np
import pytest

from datafusion_tpu import cluster as jcluster
from datafusion_tpu.cluster import agent as jagent
from datafusion_tpu.cluster import client as jclient
from datafusion_tpu.cluster import service as jservice
from datafusion_tpu.cache.result import CachedResult as JaxCachedResult
from datafusion_tpu.exec.context import ExecutionContext as JaxContext
from datafusion_tpu.exec.datasource import CsvDataSource as JaxCsv
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.parallel.coordinator import DistributedContext as JaxDistributedContext
from datafusion_tpu.parallel.partition import PartitionedDataSource as JaxPDS
from datafusion_tpu.parallel.worker import serve as jax_serve

from datafusion_tpu_torch import cluster as tcluster
from datafusion_tpu_torch.cache.result import CachedResult, CachedResultRelation
from datafusion_tpu_torch.cache.store import CacheStore
from datafusion_tpu_torch.cluster import (
    ClusterNode,
    ClusterState,
    LocalClusterClient,
    connect,
)
from datafusion_tpu_torch.cluster import service as tservice
from datafusion_tpu_torch.cluster.agent import WorkerClusterAgent
from datafusion_tpu_torch.cluster.membership import MembershipView
from datafusion_tpu_torch.cluster.shared_cache import (
    SharedResultTier,
    decode_result,
    encode_result,
)
from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.exec.datasource import CsvDataSource
from datafusion_tpu_torch.exec.materialize import collect
from datafusion_tpu_torch.parallel.coordinator import (
    DistributedContext as _DistributedContext,
    HeartbeatMonitor,
)
from datafusion_tpu_torch.parallel.partition import PartitionedDataSource
from datafusion_tpu_torch.parallel.worker import serve
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS

# the port's contexts mean cuda:0 by default: these run on the CPU
DistributedContext = functools.partial(_DistributedContext, device="cpu")


# -- the state machine under one fake clock -------------------------------


def _normalise(obj, names: dict):
    """`obj` with every lease id replaced by its order of first grant."""
    if isinstance(obj, str):
        return names.get(obj, obj)
    if isinstance(obj, dict):
        return {_normalise(k, names): _normalise(v, names) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_normalise(v, names) for v in obj)
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def _raw_result(seed=0, rows=5):
    rng = np.random.default_rng(seed)
    return {"columns": [rng.normal(size=rows), np.arange(rows, dtype=np.int64)],
            "validity": [None, rng.random(rows) > 0.3],
            "dict_values": [None, None], "num_rows": rows, "nbytes": 16 * rows}


def _script(st):
    """One request sequence against a `ClusterState`; returns every
    reply, with the lease-id order it granted."""
    out, leases = [], []

    def grant(ttl, now):
        r = st.lease_grant(ttl, now=now)
        leases.append(r["lease"])
        out.append(("grant", r))
        return r["lease"]

    a = grant(5.0, 0.0)
    out.append(("put", st.put("workers/a:1", {"addr": "a:1"}, lease=a, now=0.0)))
    b = grant(2.0, 0.5)
    out.append(("put", st.put("workers/b:2", {"addr": "b:2"}, lease=b, now=0.5)))
    out.append(("put", st.put("config/x", {"n": [1, 2]}, now=0.6)))
    out.append(("membership", st.membership(now=0.7)))
    out.append(("invalidate", st.invalidate("t", now=1.0)))
    out.append(("view", st.view_advance("v", 3, now=1.0)))
    out.append(("result_put", st.result_put("fp1", {"snapshot": _raw_result(1)}, 80,
                                            ("t",))))
    out.append(("result_put", st.result_put("fp2", {"snapshot": _raw_result(2)}, 80,
                                            ("u",))))
    out.append(("refresh", st.lease_refresh(a, since=0, now=1.5,
                                            telemetry={"counts": {"x": 1}})))
    out.append(("telemetry", st.telemetry(now=1.6)))
    out.append(("events", st.events_since(0, now=2.0)))
    out.append(("watch_answer", st.watch_answer(3, now=2.0)))
    out.append(("deadlines", st.lease_deadlines(now=2.0)))
    # b lapses at 2.5: its worker leaves and the epoch moves
    out.append(("membership", st.membership(now=3.0)))
    out.append(("refresh_gone", st.lease_refresh(b, since=5, now=3.0)))
    out.append(("deadlines", st.lease_deadlines(now=3.0)))
    out.append(("invalidate", st.invalidate("t", now=3.1)))
    out.append(("result_get", st.result_get("fp1")))
    out.append(("result_get", st.result_get("fp2")))
    out.append(("delete", st.delete("config/x", now=3.2)))
    out.append(("get", st.get("config/x", now=3.2)))
    out.append(("range", st.range("workers/", now=3.3)))
    c = grant(1.0, 3.4)
    out.append(("put", st.put("workers/c:3", {"addr": "c:3"}, lease=c, now=3.4)))
    out.append(("revoke", st.lease_revoke(a, now=3.5)))
    out.append(("membership", st.membership(now=3.6)))
    out.append(("snapshot", st.snapshot_state()))
    out.append(("gauges", st.gauges()))
    return out, leases


def test_state_machine_parity_under_one_fake_clock():
    got, port_leases = _script(ClusterState())
    want, jax_leases = _script(jservice.ClusterState())
    port_names = {lid: f"L{i}" for i, lid in enumerate(port_leases)}
    jax_names = {lid: f"L{i}" for i, lid in enumerate(jax_leases)}
    assert len(got) == len(want)
    for (gk, g), (wk, w) in zip(got, want):
        assert gk == wk
        assert _normalise(g, port_names) == _normalise(w, jax_names), gk


def _promoted(mod, snap, deadlines, now):
    """A standby of `mod` that applied `snap` (normalised lease ids) and
    the shipped deadlines, promoted at `now`: its leases and membership
    after promotion and one second later."""
    st = mod.ClusterState()
    st.apply_snapshot(snap, now=now)
    st.note_lease_deadlines(deadlines)
    st.promote(snap["term"] + 1, now=now)
    return (st.lease_deadlines(now=now), st.membership(now=now),
            st.membership(now=now + 1.0), st.term, st.snapshot_state()["events"][-3:])


def test_promotion_rearms_the_same_deadlines_in_both_packages():
    """A standby applying the same primary snapshot and shipped deadlines
    re-arms each lease to the same remaining time, caps a shipped
    deadline at the TTL, falls back to the full TTL for an unshipped
    lease, and expires the lapsed one at the same instant."""
    src = jservice.ClusterState()
    leases = [src.lease_grant(ttl, now=0.0)["lease"] for ttl in (4.0, 4.0, 0.5, 2.0)]
    for i, lid in enumerate(leases):
        src.put(f"workers/w{i}:1", {"addr": f"w{i}:1"}, lease=lid, now=0.0)
    snap = src.snapshot_state()
    shipped = {leases[0]: 3.0, leases[1]: 99.0, leases[2]: 0.0}  # leases[3] unshipped
    got = _promoted(tservice, snap, shipped, 10.0)
    want = _promoted(jservice, snap, shipped, 10.0)
    assert got == want
    deadlines = got[0]
    assert deadlines[leases[0]] == 3.0 and deadlines[leases[1]] == 4.0
    assert deadlines[leases[3]] == 2.0 and leases[2] not in deadlines


# -- the write-ahead log, written by one package, recovered by both -------


def _write_node_log(mod_service, mod_client, d):
    node = mod_service.ClusterNode(addr="a:1", wal_dir=d)
    client = mod_client.LocalClusterClient(node)
    g = client.lease_grant(30.0)
    client.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
    g2 = client.lease_grant(20.0)
    client.put("workers/w:8", {"addr": "w:8"}, lease=g2["lease"])
    client.put("config/x", {"nested": [1, 2]})
    client.invalidate("t")
    client.view_advance("mv", 4)
    node.state.result_put("fp", {"snapshot": _raw_result(7, 9)}, 144, ("t",))
    node._wal_sync()
    return node


def _recovered(mod_service, d):
    node = mod_service.ClusterNode(addr="a:1", wal_dir=d)
    st = node.state
    res = st.result_get("fp")
    return {
        "revisions": node.recovered_revisions, "rev": st._rev, "term": node.term,
        "epoch": st.membership()["epoch"],
        "kv": {k: v for k, v in st.range("").items()},
        "result": _normalise(res, {}),
        "cutoff": node.wal.deadline_cutoff_rev,
        "deadlines": st.lease_deadlines(),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_recovers_the_others_node_log(tmp_path, writer):
    mods = {"jax": (jservice, jclient), "port": (tservice, tcluster.client)}
    d = str(tmp_path / "log")
    node = _write_node_log(*mods[writer], d)
    node.stop()
    if node.wal is not None:
        node.wal.close()
    both = {}
    for name, (svc, _) in mods.items():
        copy = str(tmp_path / f"recover_{name}")
        shutil.copytree(d, copy)
        both[name] = _recovered(svc, copy)
    got, want = both["port"], both["jax"]
    dg, dw = got.pop("deadlines"), want.pop("deadlines")
    assert got == want
    assert got["revisions"] > 0 and got["kv"]["config/x"] == {"nested": [1, 2]}
    # persisted remaining TTLs, re-armed, never a fresh TTL
    assert dg.keys() == dw.keys() and len(dg) == 2
    for lid in dg:
        assert dg[lid] == pytest.approx(dw[lid], abs=0.5)
        assert dg[lid] <= 30.0


# -- the wire, both ways ---------------------------------------------------


def _start_service(mod_service, **kw):
    server = mod_service.serve("127.0.0.1:0", **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"{host}:{port}"


def _stop_service(server):
    server.shutdown()
    server.server_close()
    server.cluster_node.stop()


def _result_entry(cls, seed):
    raw = _raw_result(seed, rows=4096)  # past the inline threshold: RAW segments
    return cls(raw["columns"], raw["validity"], raw["dict_values"], raw["num_rows"],
               raw["nbytes"])


@pytest.mark.parametrize("client_pkg,service_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["jax_client_port_service", "port_client_jax_service"])
def test_each_client_talks_to_the_other_service(client_pkg, service_pkg):
    svc = {"jax": jservice, "port": tservice}[service_pkg]
    client_cls = {"jax": jclient.ClusterClient, "port": tcluster.ClusterClient}[client_pkg]
    entry_cls = {"jax": JaxCachedResult, "port": CachedResult}[client_pkg]
    server, addr = _start_service(svc)
    c = client_cls(addr)
    try:
        g = c.lease_grant(30.0)
        c.put("workers/w:1", {"addr": "w:1"}, lease=g["lease"])
        m = c.membership()
        assert m["epoch"] == 1 and set(m["workers"]) == {"w:1"}
        ref = c.lease_refresh(g["lease"], since=0, telemetry={"counts": {"q": 2}})
        assert ref["found"] and ref["epoch"] == 1
        assert c.telemetry()["workers"] == {"w:1": {"counts": {"q": 2}}}
        c.invalidate("t")
        ev = c.events_since(0)
        assert [e["kind"] for e in ev["events"]][-2:] == ["join", "invalidate"]
        w = c.watch(since=ev["rev"] - 1, timeout_s=1.0)
        assert w["events"] and w["events"][-1]["kind"] == "invalidate"
        # binary publish, then a delta publish of one changed column
        entry = _result_entry(entry_cls, 3)
        assert c.result_publish("fp", entry, entry.nbytes, ("t",))
        got, tables = c.result_fetch("fp")
        assert tables == ("t",)
        for a, b in zip(got.columns, entry.columns):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        entry2 = entry_cls([entry.columns[0] + 1.0, entry.columns[1]], entry.validity,
                           entry.dict_values, entry.num_rows, entry.nbytes)
        digests = {"jax": jservice, "port": tservice}[client_pkg]
        shared = __import__(digests.__name__.rsplit(".", 1)[0] + ".shared_cache",
                            fromlist=["column_digests", "result_raw"])
        prev = shared.column_digests(shared.result_raw(entry))
        now = shared.column_digests(shared.result_raw(entry2))
        # a delta against no previous digests ships every column and
        # stores the digests a later delta is checked against
        assert c.result_publish_delta("fp", entry, entry.nbytes, ("t",), prev, []) \
            is not None
        sent = c.result_publish_delta("fp", entry2, entry2.nbytes, ("t",), now, prev)
        # the changed f64 column alone crosses (plus validity and framing)
        assert sent is not None and 4096 * 8 <= sent < 4096 * 8 + 4096 * 2
        got2, _ = c.result_fetch("fp")
        assert np.asarray(got2.columns[0]).tobytes() == entry2.columns[0].tobytes()
        assert np.asarray(got2.validity[1]).tobytes() == entry.validity[1].tobytes()
        assert c.status()["epoch"] == 1
        c.lease_revoke(g["lease"])
        assert c.membership()["epoch"] == 2
    finally:
        c.close()
        _stop_service(server)


def test_a_jax_workers_agent_registers_with_the_port_service():
    server, addr = _start_service(tservice)
    worker = jax_serve("127.0.0.1:0", device="cpu", cluster=addr, lease_ttl_s=5.0)
    threading.Thread(target=worker.serve_forever, daemon=True).start()
    try:
        host, port = worker.server_address[:2]
        view = MembershipView(tcluster.ClusterClient(addr))
        assert view.poll() and view.live_addresses() == {f"{host}:{port}"}
        agent = worker.worker_state.cluster_agent
        agent.poll_once()
        assert agent.epoch == 1 and agent.term == server.cluster_node.term
        assert f"{host}:{port}" in server.cluster_state.telemetry()
    finally:
        worker.worker_state.cluster_agent.close()
        worker.shutdown()
        worker.server_close()
        _stop_service(server)
    assert server.cluster_state.membership()["workers"] == {}


# -- the fleet: Q1 through membership --------------------------------------


Q1 = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity), SUM(l_extendedprice), "
      "SUM(l_extendedprice * (1 - l_discount)), "
      "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
      "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(1) "
      "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
      "GROUP BY l_returnflag, l_linestatus")
Q1_FIELDS = (("l_returnflag", "UTF8"), ("l_linestatus", "UTF8"), ("l_quantity", "FLOAT64"),
             ("l_extendedprice", "FLOAT64"), ("l_discount", "FLOAT64"),
             ("l_tax", "FLOAT64"), ("l_shipdate", "UTF8"))


def _q1_schema(field_cls, schema_cls, dtype_cls):
    return schema_cls([field_cls(n, getattr(dtype_cls, t), False) for n, t in Q1_FIELDS])


@pytest.fixture(scope="module")
def q1_parts(tmp_path_factory):
    """TPC-H lineitem's Q1 columns at SF 0.01 (60,000 rows), seeded, cut
    into 4 CSV partitions."""
    rng = np.random.default_rng(17)
    n = 60_000
    d = tmp_path_factory.mktemp("q1")
    days = np.datetime64("1992-01-02") + rng.integers(0, 2526, n)
    cols = [rng.choice(list("ANR"), n), rng.choice(list("FO"), n),
            np.floor(rng.uniform(1, 51, n)), np.round(rng.uniform(900, 104950, n), 2),
            rng.integers(0, 11, n) / 100.0, rng.integers(0, 9, n) / 100.0,
            days.astype(str)]
    paths = []
    for p in range(4):
        lo, hi = p * n // 4, (p + 1) * n // 4
        path = d / f"lineitem_part{p}.csv"
        with open(path, "w") as f:
            f.write(",".join(name for name, _ in Q1_FIELDS) + "\n")
            for i in range(lo, hi):
                f.write(",".join(str(c[i]) for c in cols) + "\n")
        paths.append(str(path))
    return paths


def _port_q1_source(paths):
    schema = _q1_schema(Field, Schema, DataType)
    return PartitionedDataSource([CsvDataSource(p, schema, True, 8192) for p in paths])


def _jax_q1_rows(paths):
    from datafusion_tpu.datatypes import DataType as JT
    from datafusion_tpu.datatypes import Field as JF
    from datafusion_tpu.datatypes import Schema as JS

    schema = _q1_schema(JF, JS, JT)
    ctx = JaxContext(device="cpu", result_cache=False)
    ctx.register_datasource("lineitem", JaxPDS([JaxCsv(p, schema, True, 8192)
                                                for p in paths]))
    return sorted(jax_collect(ctx.sql(Q1)).to_rows())


def _assert_q1_rows(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[-1] == w[-1]
        np.testing.assert_allclose(np.asarray(g[2:-1], float), np.asarray(w[2:-1], float),
                                   rtol=1e-9, atol=0)


class _PortFleet:
    """Two in-process port workers on the CPU, registered on one
    `ClusterState` through a `LocalClusterClient`."""

    def __init__(self, ttl_s=5.0):
        self.state = ClusterState()
        self.client = LocalClusterClient(self.state)
        self.servers = []
        for _ in range(2):
            s = serve("127.0.0.1:0", device="cpu", cluster=self.client, lease_ttl_s=ttl_s)
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)

    def queries(self):
        return [s.worker_state.queries for s in self.servers]

    def close(self):
        for s in self.servers:
            s.worker_state.cluster_agent.close()
            s.shutdown()
            s.server_close()


@pytest.fixture()
def fleet():
    f = _PortFleet()
    try:
        yield f
    finally:
        f.close()


def test_q1_through_membership_matches_jax_and_a_second_coordinator_hits(fleet, q1_parts):
    """Q1 through workers a coordinator found through the membership view
    equals the JAX package's rows; a second coordinator, in a fresh
    context, gets the same bits from the shared tier and dispatches no
    fragment."""
    from datafusion_tpu_torch import cache as qcache

    want = _jax_q1_rows(q1_parts)
    with qcache.configured(enabled=True):
        ca = DistributedContext(cluster=fleet.client)
        cb = DistributedContext(cluster=fleet.client)
        try:
            assert len(ca.workers) == 2 and all(w.discovered for w in ca.workers)
            ca.register_datasource("lineitem", _port_q1_source(q1_parts))
            cb.register_datasource("lineitem", _port_q1_source(q1_parts))
            first = collect(ca.sql(Q1))
            _assert_q1_rows(sorted(first.to_rows()), want)
            assert sum(fleet.queries()) == 4  # one fragment a partition
            assert ca._shared_tier.flush(timeout_s=10.0)
            rel = cb.sql(Q1)
            assert isinstance(rel, CachedResultRelation) and rel.entry.shared
            second = collect(rel)
            assert sum(fleet.queries()) == 4
            for a, b in zip(first.columns, second.columns):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        finally:
            ca.close()
            cb.close()


def test_pin_aware_placement_routes_to_the_advertiser(fleet, q1_parts, monkeypatch):
    """Under QoS a worker that served a table's fragments advertises the
    table in its lease on its next heartbeat, and the coordinator places
    the table's fragments there first."""
    monkeypatch.setenv("DATAFUSION_TPU_QOS", "1")
    holder, other = fleet.servers
    ctx = DistributedContext(cluster=fleet.client, result_cache=False)
    try:
        assert ctx._placement is not None
        hh, hp = holder.server_address[:2]
        holder_handle = next(w for w in ctx.workers if (w.host, w.port) == (hh, hp))
        # only the holder runs the first query: the other is down for it
        for w in ctx.workers:
            w.alive = w is holder_handle
        ctx.register_datasource("lineitem", _port_q1_source(q1_parts))
        collect(ctx.sql(Q1))
        for w in ctx.workers:
            w.alive = True
        holder.worker_state.cluster_agent.poll_once()
        other.worker_state.cluster_agent.poll_once()
        ctx.membership.poll()
        assert "table:lineitem" in ctx.membership.workers[f"{hh}:{hp}"]["pins"]
        def served(s):  # fragments executed or replayed from its cache
            return s.worker_state.queries + s.worker_state.cache_hits

        before = [served(s) for s in fleet.servers]
        routed0 = METRICS.counts.get("coord.pin_routed", 0)
        collect(ctx.sql(Q1))
        assert served(holder) - before[0] == 4
        assert served(other) == before[1]
        assert METRICS.counts.get("coord.pin_routed", 0) == routed0 + 4
    finally:
        ctx.close()


def test_worker_lease_carries_the_cluster_block_and_json_clean_telemetry(fleet):
    import json

    st = fleet.servers[0].worker_state
    st.cluster_agent.poll_once()
    status = st.status()
    assert status["cluster"]["registered"] and status["cluster"]["epoch"] == 2
    snap = fleet.state.telemetry()
    assert len(snap) == 2
    json.dumps(snap, allow_nan=False)  # plain JSON: no tensor, no numpy scalar
    gauges = st.telemetry_snapshot()["gauges"]
    assert gauges["cluster.epoch"] == 2 and gauges["cluster.lease_ttl_s"] == 5.0


# -- pin placement, advertisement, the telemetry piggyback ----------------


class _FakeWorker:
    def __init__(self, host, port):
        self.host, self.port = host, port


class _Frag:
    def __init__(self, names):
        self._names = names

    def table_names(self):
        return self._names


def _placements(workers_info, names, live):
    """`_pin_placement` of both packages over a stub view: the chosen
    worker's address in each."""
    import types

    out = []
    for cls in (_DistributedContext, JaxDistributedContext):
        coord = types.SimpleNamespace(membership=types.SimpleNamespace(workers=workers_info))
        w = cls._pin_placement(coord, _Frag(names), live)
        out.append(None if w is None else f"{w.host}:{w.port}")
    return out


W1, W2 = _FakeWorker("h1", 1), _FakeWorker("h2", 2)


@pytest.mark.parametrize("info,names,want", [
    ({"h1:1": {"pins": ["table:other"]},
      "h2:2": {"pins": ["table:t"], "hbm_headroom_bytes": 1 << 20}}, ["t"], "h2:2"),
    ({"h1:1": {"pins": ["table:t"], "hbm_headroom_bytes": 0},
      "h2:2": {"pins": [], "hbm_headroom_bytes": 1 << 20}}, ["t"], "h2:2"),
    ({"h1:1": {"pins": ["table:t"], "hbm_headroom_bytes": 0},
      "h2:2": {"pins": [], "hbm_headroom_bytes": 0}}, ["t"], "h1:1"),
    ({"h1:1": {"pins": []}}, ["t"], None),
    ({}, ["t"], None),
    ({"h1:1": {"pins": ["table:t"]}}, [], None),
    ({"h1:1": {"pins": ["table:t"]}}, ["t"], "h1:1"),
], ids=["routes_to_holder", "saturated_replicates_to_spare", "all_saturated_holder",
        "no_holder", "no_info", "no_tables", "unknown_headroom"])
def test_pin_placement_matches_jax(info, names, want):
    got, jax_got = _placements(info, names, [W1, W2])
    assert got == jax_got == want


class _WS:
    batch_size = 4
    fragment_cache = None

    def __init__(self):
        self.pins = ["table:hot"]

    def pinned_fingerprints(self):
        return list(self.pins)


def _own_advertisement_state(monkeypatch, qos):
    """The process-global state the advertisement reads, set here: QoS
    on or off, the device capacity unknown (no DATAFUSION_TPU_HBM_BYTES,
    so no headroom and no saturated flag on the CPU) and no pins in
    either package's ledger.  Left to other tests in the process, a
    capacity and the pins they leave can flip the saturated flag of one
    package between two polls and re-put its record."""
    import datafusion_tpu.obs.device as jdevice
    import datafusion_tpu_torch.obs.device as tdevice

    if qos:
        monkeypatch.setenv("DATAFUSION_TPU_QOS", "1")
    else:
        monkeypatch.delenv("DATAFUSION_TPU_QOS", raising=False)
    monkeypatch.delenv("DATAFUSION_TPU_HBM_BYTES", raising=False)
    for ledger in (jdevice.LEDGER, tdevice.LEDGER):
        monkeypatch.setattr(ledger, "_pins", {}, raising=False)


def _advertised(mod_cluster, mod_agent, monkeypatch, qos):
    _own_advertisement_state(monkeypatch, qos)
    client = mod_cluster.LocalClusterClient(mod_cluster.ClusterState())
    ws = _WS()
    agent = mod_agent.WorkerClusterAgent(client, "w:1", ws, ttl_s=30.0)
    agent.poll_once()
    first = dict(client.membership()["workers"]["w:1"])
    rev = client.membership()["rev"]
    agent.poll_once()
    unchanged = client.membership()["rev"] == rev
    ws.pins = ["table:hot", "table:warm"]
    agent.poll_once()
    second = dict(client.membership()["workers"]["w:1"])
    for d in (first, second):
        d.pop("pid")
        d.pop("hbm_headroom_bytes", None)  # each package's own device ledger
    return first, unchanged, second, client.state.gauges().get("cluster.pins_advertised")


@pytest.mark.parametrize("qos", [False, True], ids=["qos_off", "qos_on"])
def test_pin_advertisement_matches_jax(monkeypatch, qos):
    from datafusion_tpu_torch.cluster import agent as tagent

    got = _advertised(tcluster, tagent, monkeypatch, qos)
    want = _advertised(jcluster, jagent, monkeypatch, qos)
    assert got == want
    if qos:
        assert got[0]["pins"] == ["table:hot"] and got[1]
        assert got[2]["pins"] == ["table:hot", "table:warm"]
    else:
        assert "pins" not in got[0]


def test_pin_advertisement_ignores_a_leaked_capacity_and_pins(monkeypatch):
    """A capacity in the environment and a 1 MiB pin in both ledgers, as
    an earlier test in the process could leave them, and the JAX
    ledger's live bytes crossing that capacity from one read to the next
    (its entries go as the collector frees arrays): the advertisement
    still matches the JAX package's, record for record."""
    import itertools

    import datafusion_tpu.obs.device as jdevice
    import datafusion_tpu_torch.obs.device as tdevice
    from datafusion_tpu_torch.cluster import agent as tagent

    monkeypatch.setenv("DATAFUSION_TPU_HBM_BYTES", str(2 << 20))
    for ledger in (jdevice.LEDGER, tdevice.LEDGER):
        # a copy of the pins the teardown throws away, with the leak in it
        monkeypatch.setattr(ledger, "_pins", dict(getattr(ledger, "_pins", None) or {}),
                            raising=False)
        ledger.pin("table:leaked", nbytes=1 << 20)
    drift = itertools.cycle([1 << 20, 3 << 20])
    monkeypatch.setattr(jdevice.LEDGER, "live_bytes", lambda: next(drift))
    assert tdevice.LEDGER.headroom() == 1 << 20  # as left
    got = _advertised(tcluster, tagent, monkeypatch, True)
    want = _advertised(jcluster, jagent, monkeypatch, True)
    assert got == want
    assert got[0]["pins"] == ["table:hot"] and got[1]
    assert got[2]["pins"] == ["table:hot", "table:warm"]


def test_heartbeat_telemetry_piggyback_and_expiry():
    state = ClusterState()
    c = LocalClusterClient(state)
    lease = c.lease_grant(30.0)["lease"]
    c.put("workers/10.0.0.1:99", {"addr": "10.0.0.1:99"}, lease=lease)
    snap = {"ts": 1.0, "histograms": {}, "counts": {"x": 1}, "gauges": {}}
    c.lease_refresh(lease, telemetry=snap)
    assert c.telemetry()["workers"] == {"10.0.0.1:99": snap}
    c.lease_revoke(lease)
    assert c.telemetry()["workers"] == {}
    lease = state.lease_grant(10.0, now=0.0)["lease"]
    state.put("workers/a:1", {"addr": "a:1"}, lease=lease, now=1.0)
    state.lease_refresh(lease, now=2.0, telemetry={"histograms": {}, "counts": {}})
    assert "a:1" in state.telemetry(now=3.0)
    assert state.telemetry(now=100.0) == {}


def _ingest_into_cluster(ctx, state_cls, client_cls, pkg):
    """Appends into an in-memory table with a Q1-style view over it, the
    ingest context's cluster client on a fresh state: the state's view
    keys and client-visible events."""
    import importlib

    dt = importlib.import_module(f"{pkg}.datatypes")
    batch = importlib.import_module(f"{pkg}.exec.batch")
    source = importlib.import_module(f"{pkg}.exec.datasource")
    s = dt.Schema([dt.Field("k", dt.DataType.INT64, False),
                   dt.Field("v", dt.DataType.FLOAT64, False)])
    b = batch.make_host_batch(s, [np.arange(10) % 3, np.arange(10.0)])
    ctx.register_datasource("t", source.MemoryDataSource(s, [b]))
    state = state_cls()
    ing = ctx.ingest()
    ing.cluster = client_cls(state)
    ing.create_view("mv", "SELECT k, SUM(v) FROM t GROUP BY k")
    for i in range(3):
        ing.append("t", {"k": np.array([i, 5]), "v": np.array([1.0, 2.0])})
    views = state.range("views/")
    kinds = [(e["kind"], e.get("table"), e.get("name"), e.get("revision"))
             for e in state.events_since(0)["events"]]
    return views, kinds, sorted(ing.read_view("mv").to_rows())


def test_ingest_appends_broadcast_to_the_cluster_as_in_jax():
    """An ingest context with a cluster client drops the table's shared
    results and advances its views' `views/<name>` keys on every append,
    with the JAX package's keys and events."""
    got = _ingest_into_cluster(ExecutionContext(device="cpu", result_cache=False),
                               ClusterState, LocalClusterClient, "datafusion_tpu_torch")
    want = _ingest_into_cluster(JaxContext(device="cpu", result_cache=False),
                                jservice.ClusterState, jclient.LocalClusterClient,
                                "datafusion_tpu")
    assert got[:2] == want[:2]
    assert got[0] == {"views/mv": 4}  # the view's creation is revision 1
    assert [k for k, *_ in got[1]] == ["invalidate", "view"] * 3
    assert [r[0] for r in got[2]] == [r[0] for r in want[2]]
    np.testing.assert_allclose([r[1] for r in got[2]], [r[1] for r in want[2]], rtol=1e-9)


def test_cli_cluster_modes_read_the_membership(fleet, tmp_path):
    """`top --cluster` and `debug-bundle --cluster` against a TCP service
    holding a worker with a debug port: the fleet view lists it and its
    bundle is pulled."""
    import io

    from datafusion_tpu_torch import cli

    server, addr = _start_service(tservice)
    w = serve("127.0.0.1:0", device="cpu", cluster=addr, lease_ttl_s=5.0, http_port=-1)
    threading.Thread(target=w.serve_forever, daemon=True).start()
    try:
        out = io.StringIO()
        assert cli.run_top(None, 0.0, out=out, device="cpu", cluster=addr) == 0
        host, port = w.server_address[:2]
        assert f"{host}:{port}" in out.getvalue()
        out = io.StringIO()
        rc = cli.run_debug_bundle(None, str(tmp_path), 0.05, out=out, cluster=addr)
        assert rc == 0, out.getvalue()
        assert "(1/1 ok)" in out.getvalue()
    finally:
        w.worker_state.cluster_agent.close()
        w.shutdown()
        w.server_close()
        _stop_service(server)


# -- the JAX package's tests/test_cluster.py, on the port --------------------------------------------------------


class TestClusterState:
    def test_lease_bound_key_dies_with_lease(self):
        st = ClusterState()
        g = st.lease_grant(10.0, now=0.0)
        st.put("workers/a:1", {"addr": "a:1"}, lease=g["lease"], now=0.0)
        assert st.get("workers/a:1", now=5.0) is not None
        # past the TTL: lazy expiry sweeps the lease and its keys
        assert st.get("workers/a:1", now=10.5) is None
        assert st.membership(now=10.5)["workers"] == {}

    def test_refresh_extends_and_piggybacks_events(self):
        st = ClusterState()
        g = st.lease_grant(10.0, now=0.0)
        st.put("workers/a:1", {}, lease=g["lease"], now=0.0)
        out = st.lease_refresh(g["lease"], since=g["rev"], now=9.0)
        assert out["found"] and out["epoch"] == 1
        # the join event for our own key rides the refresh
        assert [e["kind"] for e in out["events"]] == ["join"]
        # refresh at t=9 extends to t=19
        assert st.get("workers/a:1", now=18.0) is not None
        assert st.get("workers/a:1", now=19.5) is None

    def test_epoch_bumps_on_join_and_leave_only(self):
        st = ClusterState()
        assert st.membership(now=0.0)["epoch"] == 0
        g = st.lease_grant(5.0, now=0.0)
        st.put("workers/a:1", {}, lease=g["lease"], now=0.0)
        assert st.membership(now=0.0)["epoch"] == 1
        # non-member keys and value updates don't move the epoch
        st.put("config/x", 1, now=0.0)
        st.put("workers/a:1", {"v": 2}, lease=g["lease"], now=0.0)
        assert st.membership(now=0.0)["epoch"] == 1
        st.lease_revoke(g["lease"], now=1.0)
        assert st.membership(now=1.0)["epoch"] == 2

    def test_expiry_emits_leave_event_with_reason(self):
        st = ClusterState()
        g = st.lease_grant(1.0, now=0.0)
        st.put("workers/a:1", {}, lease=g["lease"], now=0.0)
        out = st.events_since(0, now=2.0)
        kinds = [(e["kind"], e.get("reason")) for e in out["events"]]
        assert ("join", None) in kinds
        assert ("leave", "lease_expired") in kinds

    def test_event_log_truncation_flagged(self):
        st = ClusterState()
        for i in range(1100):
            st.invalidate(f"t{i}", now=0.0)
        out = st.events_since(1, now=0.0)
        assert out.get("truncated") is True
        assert len(out["events"]) <= 1024

    def test_invalidate_drops_tagged_results(self):
        st = ClusterState()
        st.result_put("fp1", {"snapshot": 1}, 10, tables=("t",))
        st.result_put("fp2", {"snapshot": 2}, 10, tables=("u",))
        out = st.invalidate("t", now=0.0)
        assert out["dropped"] == 1
        assert st.result_get("fp1") is None
        assert st.result_get("fp2") is not None

    def test_unknown_lease_put_rejected(self):
        st = ClusterState()
        with pytest.raises(KeyError):
            st.put("workers/a:1", {}, lease="nope", now=0.0)


# -- clients (in-process and TCP run the same handler) --------------------


class TestClients:
    def test_local_client_roundtrip(self):
        c = LocalClusterClient(ClusterState())
        assert c.ping()
        g = c.lease_grant(30.0)
        c.put("workers/x:1", {"addr": "x:1"}, lease=g["lease"])
        view = c.membership()
        assert view["epoch"] == 1 and "x:1" in view["workers"]
        assert c.get("workers/x:1")["addr"] == "x:1"
        assert c.range("workers/") == {"workers/x:1": {"addr": "x:1"}}
        assert c.lease_revoke(g["lease"])
        assert c.membership()["workers"] == {}

    def test_tcp_service_parity(self):
        from datafusion_tpu_torch.cluster.service import serve as serve_cluster

        server = serve_cluster("127.0.0.1:0")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = server.server_address[:2]
            c = connect(f"{host}:{port}")
            assert c.ping()
            g = c.lease_grant(30.0)
            c.put("workers/y:2", {"addr": "y:2"}, lease=g["lease"])
            assert c.membership()["workers"].keys() == {"y:2"}
            # the shared tier over TCP: value survives the wire
            assert c.result_put("fp", {"snapshot": {"n": 1}}, 8, ("t",))
            out = c.result_get("fp")
            assert out["found"] and out["value"]["snapshot"] == {"n": 1}
            assert c.invalidate("t")["dropped"] == 1
            status = c.status()
            assert status["epoch"] == 1
            assert 'name="cluster.epoch"' in status["prometheus"]
        finally:
            server.shutdown()
            server.server_close()

    def test_connect_shapes(self):
        st = ClusterState()
        local = connect(st)
        assert isinstance(local, LocalClusterClient)
        assert connect(local) is local
        with pytest.raises(TypeError):
            connect(42)

    def test_request_fault_site_is_a_partition(self):
        c = LocalClusterClient(ClusterState())
        with faults.scoped({"rules": [
            {"site": "cluster.request", "op": "raise",
             "exc": "ConnectionRefusedError", "count": 1},
        ]}):
            assert not c.ping()  # partition reports unhealthy, no raise
        assert c.ping()


# -- membership view ------------------------------------------------------


class TestMembershipView:
    def _cluster_with_worker(self):
        st = ClusterState()
        c = LocalClusterClient(st)
        g = c.lease_grant(30.0)
        c.put("workers/w:1", {"addr": "w:1"}, lease=g["lease"])
        return st, c, g

    def test_refresh_tracks_epoch_and_workers(self):
        _, c, g = self._cluster_with_worker()
        view = MembershipView(c)
        assert view.epoch == -1
        view.refresh()
        assert view.epoch == 1 and view.live_addresses() == {"w:1"}
        c.lease_revoke(g["lease"])
        view.refresh()
        assert view.epoch == 2 and view.live_addresses() == set()

    def test_poll_keeps_stale_view_through_partition(self):
        _, c, _ = self._cluster_with_worker()
        view = MembershipView(c)
        view.refresh()
        with faults.scoped({"rules": [
            {"site": "cluster.watch", "op": "raise",
             "exc": "ConnectionResetError", "count": 1},
        ]}):
            assert not view.poll()
        # stale view preserved, error counted, gauges stay coherent
        assert view.live_addresses() == {"w:1"}
        assert view.refresh_errors == 1
        g = view.gauges()
        assert g["cluster.workers_live"] == 1
        assert g["cluster.watch_errors"] == 1
        assert g["cluster.watch_lag_s"] >= 0
        assert view.poll()

    def test_view_matches_workers_by_resolved_address(self):
        """A handle configured as 'localhost' must match a worker that
        registered its bound '127.0.0.1' — a spelling mismatch would
        flap a live worker down every cycle."""
        from datafusion_tpu_torch.parallel.coordinator import WorkerHandle

        st = ClusterState()
        c = LocalClusterClient(st)
        g = c.lease_grant(30.0)
        c.put("workers/127.0.0.1:9000", {}, lease=g["lease"])
        w = WorkerHandle("localhost", 9000)
        mon = HeartbeatMonitor([w], membership=MembershipView(c))
        mon.poll_once()
        assert w.alive

    def test_heartbeat_monitor_consumes_view(self):
        from datafusion_tpu_torch.parallel.coordinator import WorkerHandle

        _, c, g = self._cluster_with_worker()
        view = MembershipView(c)
        w = WorkerHandle("w", 1)
        mon = HeartbeatMonitor([w], membership=view)
        mon.poll_once()
        assert w.alive
        c.lease_revoke(g["lease"])
        mon.poll_once()
        assert not w.alive  # no probe ran; the shared view decided
        # rejoin: a fresh lease re-admits without probation counting
        g2 = c.lease_grant(30.0)
        c.put("workers/w:1", {"addr": "w:1"}, lease=g2["lease"])
        mon.poll_once()
        assert w.alive


# -- shared result tier ---------------------------------------------------


def _snapshot(num_rows=3):
    return CachedResult(
        [np.arange(num_rows, dtype=np.int64),
         np.asarray([0, 1, 0][:num_rows], np.int32)],
        [None, np.asarray([True, False, True][:num_rows])],
        [None, ("x", "y")],
        num_rows,
        64,
    )


class TestSharedResultTier:
    def test_snapshot_wire_roundtrip(self):
        entry = _snapshot()
        back = decode_result(encode_result(entry))
        assert back.shared is True and back.num_rows == 3
        np.testing.assert_array_equal(back.columns[0], entry.columns[0])
        np.testing.assert_array_equal(back.validity[1], entry.validity[1])
        assert back.dict_values == [None, ("x", "y")]

    def test_read_through_installs_locally_without_echo(self):
        c = LocalClusterClient(ClusterState())
        tier = SharedResultTier(c)
        c.result_put(
            "fp", {"snapshot": encode_result(_snapshot()), "tables": ["t"]},
            64, ("t",),
        )
        store = CacheStore(1 << 20, name="rt")
        store.shared = tier
        published = METRICS.counts.get("coord.shared_cache_published", 0)
        got = store.get("fp")
        assert got is not None and got.shared
        assert store.entries == 1 and store.shared_hits == 1
        # the install must not re-publish (shared snapshots skip store())
        tier.flush()
        assert METRICS.counts.get(
            "coord.shared_cache_published", 0) == published
        # second get: purely local
        assert store.get("fp") is not None and store.shared_hits == 1
        tier.close()

    def test_write_behind_publishes(self):
        st = ClusterState()
        tier = SharedResultTier(LocalClusterClient(st))
        store = CacheStore(1 << 20, name="wb")
        store.shared = tier
        store.put("fp", _snapshot(), 64, tags=("t",))
        assert tier.flush(timeout_s=10.0)
        assert st.result_get("fp") is not None
        # a second store with a fresh local cache reads it back
        other = CacheStore(1 << 20, name="wb2")
        other.shared = SharedResultTier(LocalClusterClient(st))
        assert other.get("fp").shared
        tier.close()

    def test_partitioned_service_degrades_to_miss(self):
        tier = SharedResultTier(LocalClusterClient(ClusterState()))
        store = CacheStore(1 << 20, name="pt")
        store.shared = tier
        with faults.scoped({"rules": [
            {"site": "cluster.request", "op": "raise",
             "exc": "ConnectionResetError", "count": 1},
        ]}):
            assert store.get("fp") is None  # error -> miss, not raise
        tier.close()

    def test_non_snapshot_values_not_published(self):
        st = ClusterState()
        tier = SharedResultTier(LocalClusterClient(st))
        store = CacheStore(1 << 20, name="ns")
        store.shared = tier
        store.put("raw", {"not": "a snapshot"}, 8)
        tier.flush()
        assert st.result_get("raw") is None
        tier.close()


# -- chunked replay (satellite) -------------------------------------------


class TestChunkedReplay:
    def test_replay_respects_batch_size(self):
        entry = CachedResult(
            [np.arange(10, dtype=np.int64)], [None], [None], 10, 80
        )
        schema = Schema([Field("v", DataType.INT64, False)])
        rel = CachedResultRelation(schema, entry, "fp", batch_size=4)
        batches = list(rel.batches())
        assert [b.num_rows for b in batches] == [4, 4, 2]
        out = np.concatenate(
            [np.asarray(b.data[0])[: b.num_rows] for b in batches]
        )
        np.testing.assert_array_equal(out, np.arange(10))
        assert rel.stats.attrs.get("cache.batches") == 3

    def test_cached_repeat_streams_chunks_and_matches(self, tmp_path):
        schema = Schema([Field("v", DataType.INT64, False)])
        path = str(tmp_path / "v.csv")
        with open(path, "w") as f:
            f.write("v\n" + "\n".join(str(i) for i in range(1000)) + "\n")
        from datafusion_tpu_torch import cache as qcache

        with qcache.configured(enabled=True):
            ctx = ExecutionContext(device="cpu", batch_size=256)
            ctx.register_csv("t", path, schema)
            cold = sorted(collect(ctx.sql("SELECT v FROM t WHERE v < 999")).to_rows())
            rel = ctx.sql("SELECT v FROM t WHERE v < 999")
            assert isinstance(rel, CachedResultRelation)
            batches = list(rel.batches())
            assert len(batches) == 4  # 999 rows in 256-row chunks
            assert all(b.num_rows <= 256 for b in batches)
            rel2 = ctx.sql("SELECT v FROM t WHERE v < 999")
            assert sorted(collect(rel2).to_rows()) == cold


# -- integration: workers + coordinators over one control plane ----------


DSCHEMA = Schema(
    [Field("region", DataType.UTF8, False), Field("v", DataType.INT64, False)]
)
DSQL = "SELECT region, COUNT(1), SUM(v) FROM t GROUP BY region"


def _write_parts(tmp_path, n=2, rows=400):
    rng = np.random.default_rng(11)
    paths = []
    for p in range(n):
        path = tmp_path / f"part{p}.csv"
        with open(path, "w") as f:
            f.write("region,v\n")
            for _ in range(rows):
                f.write(f"r{rng.integers(0, 4)},{rng.integers(-50, 50)}\n")
        paths.append(str(path))
    return paths


def _register(ctx, paths):
    ctx.register_datasource(
        "t",
        PartitionedDataSource(
            [CsvDataSource(p, DSCHEMA, True, 131072) for p in paths]
        ),
    )
    return ctx


class _Cluster:
    """Two in-process workers registered on one shared ClusterState."""

    def __init__(self, ttl_s=1.0):
        self.state = ClusterState()
        self.client = LocalClusterClient(self.state)
        self.servers = []
        for _ in range(2):
            server = serve("127.0.0.1:0", device="cpu",
                           cluster=self.client, lease_ttl_s=ttl_s)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            self.servers.append(server)

    def agent(self, i):
        return self.servers[i].worker_state.cluster_agent

    def kill(self, i):
        """Abrupt worker death: no lease revocation — the TTL must
        notice (SIGKILL semantics, in-process)."""
        self.agent(i).stop()
        self.servers[i].shutdown()
        self.servers[i].server_close()

    def close(self):
        for server in self.servers:
            agent = server.worker_state.cluster_agent
            if agent is not None:
                agent.close()
            try:
                server.shutdown()
                server.server_close()
            except OSError:
                pass


@pytest.fixture()
def cluster():
    c = _Cluster()
    try:
        yield c
    finally:
        c.close()


class TestClusterIntegration:
    def test_worker_discovery_from_membership(self, cluster, tmp_path):
        paths = _write_parts(tmp_path)
        want = sorted(
            collect(_register(ExecutionContext(device="cpu"), paths).sql(DSQL))
            .to_rows()
        )
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            assert len(ctx.workers) == 2  # no explicit worker list
            _register(ctx, paths)
            assert sorted(collect(ctx.sql(DSQL)).to_rows()) == want

    def test_two_coordinators_converge_after_kill(self, cluster, tmp_path):
        """The acceptance bar: a worker dies abruptly; both coordinators
        observe the SAME bumped epoch within one lease TTL, and their
        heartbeat monitors flip the dead worker without probing."""
        paths = _write_parts(tmp_path)
        ca = DistributedContext(cluster=cluster.client, result_cache=False)
        cb = DistributedContext(cluster=cluster.client, result_cache=False)
        try:
            e0 = ca.cluster_epoch()
            assert e0 == cb.cluster_epoch() == 2  # two joins
            killed_addr = cluster.agent(0).addr
            cluster.kill(0)
            deadline = time.monotonic() + 5.0  # TTL 1s + CI slack
            while time.monotonic() < deadline:
                ca.cluster_epoch()
                if killed_addr not in ca.membership.live_addresses():
                    break
                time.sleep(0.05)
            # both coordinators observe the same bumped epoch from the
            # same shared view (>= tolerates unrelated churn of the
            # survivor's lease under a stalled CI machine)
            assert ca.cluster_epoch() >= e0 + 1
            assert cb.cluster_epoch() == ca.cluster_epoch()
            assert killed_addr not in cb.membership.live_addresses()
            mon_a = HeartbeatMonitor(ca.workers, membership=ca.membership)
            mon_a.poll_once()
            assert sum(w.alive for w in ca.workers) == 1
            # queries keep working on the survivor
            want = sorted(
                collect(
                    _register(ExecutionContext(device="cpu"), paths).sql(DSQL)
                ).to_rows()
            )
            _register(ca, paths)
            assert sorted(collect(ca.sql(DSQL)).to_rows()) == want
        finally:
            ca.close()
            cb.close()

    def test_shared_tier_warm_hit_across_coordinators(self, cluster, tmp_path):
        """A query warm in coordinator A's result cache is a shared-tier
        hit in coordinator B: no fragment dispatch, `cache.shared=True`
        in the replay relation, `coord.shared_cache_hits` counted."""
        from datafusion_tpu_torch import cache as qcache

        paths = _write_parts(tmp_path)
        with qcache.configured(enabled=True):
            ca = DistributedContext(cluster=cluster.client)
            cb = DistributedContext(cluster=cluster.client)
            try:
                _register(ca, paths)
                _register(cb, paths)
                want = sorted(collect(ca.sql(DSQL)).to_rows())
                assert ca._shared_tier.flush(timeout_s=10.0)
                base = METRICS.counts.get("coord.shared_cache_hits", 0)
                rel = cb.sql(DSQL)
                assert isinstance(rel, CachedResultRelation)
                assert rel.entry.shared
                assert "cache.shared" in rel.stats.attrs
                assert sorted(collect(rel).to_rows()) == want
                assert METRICS.counts["coord.shared_cache_hits"] == base + 1
                # B's stats history records the warm run as a hit
                runs = cb.stats_history(cb.last_fingerprint)
                assert runs and runs[-1]["cache_hit"] is True
            finally:
                ca.close()
                cb.close()

    def test_invalidation_broadcast_beats_ttl(self, cluster, tmp_path):
        """A worker's stale fragment-cache entry dies on the lease
        refresh FOLLOWING the broadcast — the fragment cache TTL (5
        minutes by default) never has to pass."""
        paths = _write_parts(tmp_path)
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            _register(ctx, paths)
            collect(ctx.sql(DSQL))
            caches = [s.worker_state.fragment_cache for s in cluster.servers]
            assert sum(c.entries for c in caches) >= 2  # one per partition
            dropped_shared = ctx.broadcast_invalidate("t")
            assert dropped_shared == 0  # result cache off in this test
            for i in range(2):
                cluster.agent(i).poll_once()  # the next heartbeat
            assert all(c.entries == 0 for c in caches)
            assert METRICS.counts.get(
                "worker.cluster_invalidations_applied", 0) >= 2

    def test_reregistration_broadcasts(self, cluster, tmp_path):
        paths = _write_parts(tmp_path)
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            _register(ctx, paths)
            collect(ctx.sql(DSQL))
            caches = [s.worker_state.fragment_cache for s in cluster.servers]
            assert sum(c.entries for c in caches) >= 2
            _register(ctx, paths)  # re-register the same name
            for i in range(2):
                cluster.agent(i).poll_once()
            assert all(c.entries == 0 for c in caches)

    def test_lease_expiry_chaos_reregisters(self, cluster):
        """Chaos: injected heartbeat failures outlast the TTL; the lease
        expires (leave event, epoch bump), and the recovering agent
        re-registers with a cleared fragment cache (it may have missed
        invalidations while deregistered)."""
        agent = cluster.agent(0)
        agent.stop()  # drive the heartbeat by hand
        cache = cluster.servers[0].worker_state.fragment_cache
        cache.put("stale", b"x", 1)
        view = MembershipView(cluster.client).refresh()
        e0 = view.epoch
        with faults.scoped({"rules": [
            {"site": "cluster.lease.refresh", "op": "raise",
             "exc": "ConnectionResetError", "count": 3,
             "where": {"addr": agent.addr}},
        ]}):
            for _ in range(3):
                with pytest.raises(ConnectionError):
                    agent.poll_once()
        # hold the OTHER worker's lease alive while this one lapses
        time.sleep(1.1)
        cluster.agent(1).poll_once()
        view = MembershipView(cluster.client).refresh()
        assert view.epoch > e0  # the leave was observed fleet-wide
        assert agent.addr not in view.live_addresses()
        agent.poll_once()  # recovery: re-register
        assert agent.reregistrations == 1
        assert cache.entries == 0  # suspect cache cleared on resync
        view.refresh()
        assert agent.addr in view.live_addresses()

    def test_off_means_off(self, tmp_path, monkeypatch):
        """No cluster configured: no client, no membership, no shared
        tier, no new threads — the existing paths byte-identical."""
        monkeypatch.delenv("DATAFUSION_TPU_CLUSTER", raising=False)
        ctx = DistributedContext([("127.0.0.1", 1)], result_cache=False)
        assert ctx.cluster is None and ctx.membership is None
        assert ctx._shared_tier is None
        with pytest.raises(ExecutionError):
            ctx.cluster_epoch()
        assert ctx.sync_workers() == []
        assert ctx.broadcast_invalidate("t") == 0
        server = serve("127.0.0.1:0", device="cpu")
        try:
            assert server.worker_state.cluster_agent is None
        finally:
            server.server_close()

    def test_worker_status_and_gauges_carry_cluster_block(self, cluster):
        state = cluster.servers[0].worker_state
        snap = state.status()["cluster"]
        assert snap["registered"] and snap["lease_age_s"] is not None
        gauges = state._gauges()
        assert gauges["cluster.lease_ttl_s"] == 1.0
        assert gauges["cluster.lease_age_s"] >= 0

    def test_coordinator_metrics_text_has_cluster_gauges(self, cluster):
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            text = ctx.metrics_text()
            assert 'name="cluster.epoch"' in text
            assert 'name="cluster.watch_lag_s"' in text
            # the fleet telemetry gauges ride the same scrape
            assert 'name="fleet.nodes"' in text

    def test_sync_workers_discovers_late_joiner(self, cluster):
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            assert len(ctx.workers) == 2
            server = serve("127.0.0.1:0", device="cpu",
                           cluster=cluster.client, lease_ttl_s=1.0)
            try:
                added = ctx.sync_workers()
                assert len(added) == 1 and len(ctx.workers) == 3
                assert ctx.sync_workers() == []  # idempotent
            finally:
                server.worker_state.cluster_agent.close()
                server.server_close()


# -- replication / failover (control-plane HA) ----------------------------


def _pair(election_timeout_s=1.0):
    """Primary + standby nodes over separate states, in-process."""
    a = ClusterNode(addr="a:1")
    b = ClusterNode(addr="b:2", standby_of=a,
                    election_timeout_s=election_timeout_s)
    return a, b, LocalClusterClient([a, b])


class TestReplication:
    def test_standby_tails_primary_log(self):
        a, b, client = _pair()
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
        client.put("config/x", 42)
        client.invalidate("t")
        applied = b.replicate_once()
        assert applied >= 4  # grant + join + put + invalidate
        assert b.state._rev == a.state._rev
        assert b.state.get("config/x") == 42
        assert b.state.membership()["workers"].keys() == {"w:9"}
        assert b.state.membership()["epoch"] == a.state.membership()["epoch"]
        assert b.replication_lag_revisions == 0

    def test_result_tier_replicates_with_values(self):
        a, b, client = _pair()
        entry = _snapshot()
        client.result_publish("fp", entry, 64, ("t",))
        b.replicate_once()
        stored = b.state.result_get("fp")
        assert stored is not None
        np.testing.assert_array_equal(
            stored["snapshot"]["columns"][0], entry.columns[0]
        )

    def test_snapshot_catchup_after_truncation(self):
        a, b, client = _pair()
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
        for i in range(1200):  # blow past the 1024-event window
            client.invalidate(f"t{i}")
        assert b.replicate_once() == -1  # full snapshot, not a tail
        assert b.snapshots_applied == 1
        assert b.state._rev == a.state._rev
        assert b.state.membership()["workers"].keys() == {"w:9"}
        # incremental shipping resumes after the snapshot
        client.put("config/x", 1)
        assert b.replicate_once() >= 1
        assert b.state.get("config/x") == 1

    def test_standby_rejects_reads_and_writes(self):
        a, b, _ = _pair()
        out = b.handle_request({"type": "kv_put", "key": "k", "value": 1})
        assert out.get("code") == "not_primary"
        assert out.get("primary") == "a:1"  # the redirect hint
        out = b.handle_request({"type": "membership"})
        assert out.get("code") == "not_primary"
        # ping and status still answer (health checks, operators)
        assert b.handle_request({"type": "ping"})["type"] == "pong"
        assert b.handle_request({"type": "status"})["role"] == "standby"

    def test_promotion_on_primary_silence_rearms_leases(self):
        a, b, client = _pair(election_timeout_s=1.0)
        g = client.lease_grant(2.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        a.partitioned = True
        now = time.monotonic()
        with pytest.raises(ConnectionError):
            b.replicate_once()
        assert not b.maybe_promote(now=now)  # silence too short
        assert b.maybe_promote(now=now + 1.5)
        assert b.role == "primary" and b.term == 2
        # the replicated lease survived the takeover with a fresh TTL
        resp = LocalClusterClient(b).lease_refresh(g["lease"])
        assert resp["found"] and resp["term"] == 2

    def test_election_fault_site_aborts_promotion(self):
        a, b, _ = _pair(election_timeout_s=0.5)
        a.partitioned = True
        now = time.monotonic() + 10.0
        with faults.scoped({"rules": [
            {"site": "cluster.election", "op": "raise",
             "exc": "ExecutionError", "count": 1},
        ]}):
            with pytest.raises(ExecutionError):
                b.maybe_promote(now=now)
            assert b.role == "standby"  # the aborted round changed nothing
        assert b.maybe_promote(now=now)

    def test_replicate_fault_site_is_transient(self):
        a, b, _ = _pair()
        a.state.put("config/x", 1)
        with faults.scoped({"rules": [
            {"site": "cluster.replicate", "op": "raise",
             "exc": "ConnectionResetError", "count": 1},
        ]}):
            with pytest.raises(ConnectionError):
                b.replicate_once()
        b.replicate_once()  # the next round catches up
        assert b.state.get("config/x") == 1

    def test_stale_term_write_rejected_and_old_primary_demoted(self):
        """The split-brain fence: standby promotes past a partitioned
        primary; the revived old primary is demoted on its first term
        exchange, and a write stamped with its stale term is refused."""
        from datafusion_tpu_torch.errors import StaleTermError

        a, b, client = _pair(election_timeout_s=0.5)
        client.put("config/x", 1)
        b.replicate_once()
        a.partitioned = True
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        a.partitioned = False  # the old primary revives, still term 1
        old_term = a.term
        assert a.role == "primary" and old_term < b.term
        # a write carrying the deposed term is fenced
        out = b.handle_request({"type": "kv_put", "key": "boom",
                                "value": 1, "term": old_term})
        assert out.get("code") == "stale_term"
        with pytest.raises(StaleTermError):
            LocalClusterClient(b).request(
                {"type": "kv_put", "key": "boom", "value": 1,
                 "term": old_term}
            )
        assert b.state.get("boom") is None
        assert METRICS.counts.get("cluster.stale_term_writes_rejected", 0) >= 1
        # the term exchange demotes the old primary...
        b.handle_request({"type": "replicate_pull", "since": a.state._rev,
                          "term": a.term, "addr": "a:1"})  # b keeps primacy
        a.handle_request({"type": "peer_status", "term": b.term,
                          "role": "primary", "addr": "b:2"})
        assert a.role == "standby" and a.term == b.term
        # ...and it resyncs FROM the new primary via a full snapshot
        a.retarget(b)  # in-process: dial the node, not "b:2"
        assert a.replicate_once() == -1
        assert a.state._rev == b.state._rev

    def test_standby_refuses_replication_pulls(self):
        """A deposed/never-primary node must not feed the log: the
        puller gets the redirect hint instead of silently tailing a
        non-primary (which would also defer its election forever)."""
        a, b, _ = _pair()
        out = a.handle_request({"type": "replicate_pull", "since": 0,
                                "term": b.term, "addr": "b:2"})
        assert out["type"] == "replicate"  # primary serves pulls
        out = b.handle_request({"type": "replicate_pull", "since": 0,
                                "term": 1, "addr": "c:3"})
        assert out.get("code") == "not_primary"
        assert out.get("primary") == "a:1"  # chase this instead

    def test_configured_workers_never_auto_retired(self):
        """Explicitly configured handles are the operator's call: an
        epoch change must not remove them even when the membership
        view has never seen them (only flip them via the monitor)."""
        st = ClusterState()
        c = LocalClusterClient(st)
        g1, g2 = c.lease_grant(30.0), c.lease_grant(30.0)
        c.put("workers/10.0.0.8:1", {}, lease=g1["lease"])
        c.put("workers/10.0.0.9:1", {}, lease=g2["lease"])
        ctx = DistributedContext([("203.0.113.7", 4)], cluster=c,
                                 result_cache=False)
        try:
            assert len(ctx.workers) == 1 and not ctx.workers[0].discovered
            ctx.sync_workers()  # folds the registered workers in
            addrs = {f"{w.host}:{w.port}" for w in ctx.workers}
            assert addrs == {"203.0.113.7:4", "10.0.0.8:1", "10.0.0.9:1"}
            c.lease_revoke(g2["lease"])  # one registered worker leaves
            ctx.sync_workers()
            addrs = {f"{w.host}:{w.port}" for w in ctx.workers}
            # discovered leaver retired; configured handle untouched
            # even though the (non-empty) view has never seen it
            assert addrs == {"203.0.113.7:4", "10.0.0.8:1"}
        finally:
            ctx.close()

    def test_rev_regression_after_failover_clears_worker_cache(self):
        """A failover can land on a standby whose log was BEHIND the
        revision a worker had already consumed; events the new primary
        issues inside that gap are filtered out of every future tail
        (`since` is too high) — unobservable, like a truncation — so
        the worker must treat its fragment cache as suspect."""

        class _FakeWorkerState:
            batch_size = 4
            fragment_cache = CacheStore(1 << 20, name="rvreg")

        a, b, client = _pair(election_timeout_s=0.5)
        ws = _FakeWorkerState()
        agent = WorkerClusterAgent(client, "w:1", ws, ttl_s=30.0)
        agent.poll_once()  # register on the primary
        b.replicate_once()  # standby mirrors the registration...
        for i in range(5):  # ...but NOT these: the unreplicated tail
            client.invalidate(f"gap{i}")
        agent.poll_once()  # the worker consumed the tail (last_rev high)
        ws.fragment_cache.put("stale", b"x", 1, tags=("events",))
        a.partitioned = True
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        # an invalidation on the new primary lands INSIDE the gap the
        # worker's cursor already skipped past
        client.invalidate("events")
        assert b.state._rev < agent.last_rev
        agent.poll_once()
        assert ws.fragment_cache.entries == 0  # suspect cache cleared
        assert METRICS.counts.get("worker.cluster_rev_regressions", 0) >= 1

    def test_client_failover_and_redirect(self):
        a, b, client = _pair(election_timeout_s=0.5)
        b.replicate_once()
        a.partitioned = True
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        base = METRICS.counts.get("cluster.client_failovers", 0)
        # endpoint sweep: a (dead) -> b (promoted) without the caller
        # seeing anything but the answer
        rev = client.put("config/y", 7)
        assert rev > 0 and b.state.get("config/y") == 7
        assert METRICS.counts.get("cluster.client_failovers", 0) > base
        # subsequent requests start at the promoted endpoint (sticky)
        assert client.nodes[client._active % 2] is b

    def test_redirect_hint_follows_primary(self):
        a, b, client = _pair()
        b.replicate_once()
        # ask the standby FIRST: the not_primary redirect must land on a
        client._active = 1
        assert client.put("config/z", 3) > 0
        assert a.state.get("config/z") == 3
        assert METRICS.counts.get("cluster.client_redirects", 0) >= 1

    def test_watch_unparks_on_event(self):
        a, _, client = _pair()
        rev0 = a.state._rev
        got = {}

        def park():
            got.update(client.watch(rev0, timeout_s=5.0))

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        client.invalidate("t")
        t.join(timeout=5.0)
        assert time.monotonic() - t0 < 2.0  # pushed, not polled
        assert got.get("fired") is True
        assert [e["kind"] for e in got["events"]] == ["invalidate"]
        assert "workers" in got  # membership piggybacks on the answer

    def test_watch_timeout_returns_fresh_membership(self):
        a, _, client = _pair()
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        rev0 = a.state._rev
        out = client.watch(rev0, timeout_s=0.05)
        assert out.get("fired") is False
        assert out["events"] == [] and "w:9" in out["workers"]

    def test_membership_view_watch_and_subscribe(self):
        a, _, client = _pair()
        view = MembershipView(client)
        view.refresh()
        seen = []
        view.subscribe(lambda v: seen.append(v.epoch))
        g = client.lease_grant(30.0)

        def join_later():
            time.sleep(0.1)
            client.put("workers/w:9", {}, lease=g["lease"])

        t = threading.Thread(target=join_later)
        t.start()
        assert view.watch(timeout_s=5.0)
        t.join()
        if not seen:  # the watch can race the put; one more park settles it
            assert view.watch(timeout_s=5.0)
        assert seen and view.live_addresses() == {"w:9"}
        assert view.term >= 1

    def test_replicated_state_serves_clients_after_promotion(self):
        """The acceptance path in miniature: writes land on the primary,
        the standby promotes, and every consumer-visible read (KV,
        membership, events, shared tier) answers identically."""
        a, b, client = _pair(election_timeout_s=0.5)
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
        client.result_publish("fp", _snapshot(), 64, ("t",))
        b.replicate_once()
        a.partitioned = True
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        assert client.membership()["workers"].keys() == {"w:9"}
        fetched = client.result_fetch("fp")
        assert fetched is not None and fetched[0].shared
        tail = client.events_since(0)
        assert any(e["kind"] == "join" for e in tail["events"])


class TestWatchResume:
    """Watch resumption tokens: every answer carries {term, rev}; a
    watcher replaying it gets `resumed: True` iff the answering node
    can PROVE no client-visible events were missed."""

    def test_answer_carries_token_and_client_replays_it(self):
        state = ClusterState()
        client = LocalClusterClient(state)
        out = client.watch(0, timeout_s=0)
        tok = out["resume"]
        assert tok["rev"] == state._rev and tok["term"] == state.term
        assert "resumed" not in out  # first watch: nothing to prove
        client.invalidate("t")
        out2 = client.watch(tok["rev"], timeout_s=0)
        assert out2["resumed"] is True  # proof: log covers the token
        assert out2["fired"] and out2["events"]
        assert client.last_watch_resume == out2["resume"]

    def test_resume_proves_continuity_across_promotion(self):
        a, b, client = _pair()
        client.invalidate("warm")
        out = client.watch(0, timeout_s=0)
        assert out["resume"]["term"] == 1
        b.replicate_once()  # promoted log holds every acked revision
        a.partitioned = True
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        out2 = client.watch(out["resume"]["rev"], timeout_s=0)
        # the failover sweep landed on b, which proves continuity
        assert out2["resumed"] is True
        assert out2["term"] == 2 and out2["resume"]["term"] == 2

    def test_resume_fails_on_lagging_promoted_log(self):
        a, b, client = _pair()
        b.replicate_once()
        client.invalidate("acked-but-unreplicated")
        out = client.watch(0, timeout_s=0)
        a.partitioned = True  # b never saw the last events
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        out2 = client.watch(out["resume"]["rev"], timeout_s=0)
        assert out2["resumed"] is False  # proof fails: must resync
        assert METRICS.counts.get("cluster.client_watch_resyncs", 0) >= 1

    def test_resume_fails_past_truncated_window(self):
        state = ClusterState()
        client = LocalClusterClient(state)
        client.invalidate("t0")
        out = client.watch(0, timeout_s=0)
        for i in range(1200):  # blow past the 1024-event window
            client.invalidate(f"t{i}")
        out2 = client.watch(out["resume"]["rev"], timeout_s=0)
        assert out2["resumed"] is False
        assert out2.get("truncated")


class TestBinaryPublish:
    def test_tcp_publish_uses_raw_segments_not_base64(self):
        """Satellite: shared-tier snapshots cross the wire as binary RAW
        segments; `coord.shared_cache_publish_bytes` proves the cost is
        ~the raw bytes, not raw * 4/3."""
        from datafusion_tpu_torch.cluster.service import serve as serve_cluster

        server = serve_cluster("127.0.0.1:0")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = server.server_address[:2]
            client = connect(f"{host}:{port}")
            cols = [np.arange(100_000, dtype=np.int64)]
            raw_bytes = cols[0].nbytes
            entry = CachedResult(cols, [None], [None], 100_000, raw_bytes)
            tier = SharedResultTier(client)
            store = CacheStore(1 << 24, name="bin")
            store.shared = tier
            base = METRICS.counts.get("coord.shared_cache_publish_bytes", 0)
            store.put("fp-big", entry, raw_bytes, tags=("t",))
            assert tier.flush(timeout_s=20.0)
            sent = METRICS.counts["coord.shared_cache_publish_bytes"] - base
            assert 0 < sent < raw_bytes * 1.05  # base64 would be ~1.33x
            # and the fetch roundtrips through the binary frames
            other = CacheStore(1 << 24, name="bin2")
            other.shared = SharedResultTier(client)
            got = other.get("fp-big")
            assert got is not None and got.shared
            np.testing.assert_array_equal(got.columns[0], cols[0])
            tier.close()
        finally:
            server.shutdown()
            server.server_close()


class TestFailoverChaos:
    """Satellite: kill the primary mid-workload under seeded faults and
    prove the fleet never notices — standby promotes within one lease
    TTL, no lease is lost, the warm shared tier survives, and the
    revived old primary is fenced."""

    def test_primary_kill_mid_workload(self, tmp_path):
        from datafusion_tpu_torch import cache as qcache

        paths = _write_parts(tmp_path)
        a = ClusterNode(addr="a:1")
        b = ClusterNode(addr="b:2", standby_of=a, election_timeout_s=0.5)
        client = LocalClusterClient([a, b])
        servers = []
        with qcache.configured(enabled=True):
            for _ in range(2):
                server = serve("127.0.0.1:0", device="cpu",
                               cluster=client, lease_ttl_s=1.0)
                threading.Thread(target=server.serve_forever,
                                 daemon=True).start()
                servers.append(server)
            ctx = DistributedContext(cluster=client)
            try:
                _register(ctx, paths)
                want = sorted(collect(ctx.sql(DSQL)).to_rows())
                assert ctx._shared_tier.flush(timeout_s=10.0)
                b.replicate_once()
                leases = [s.worker_state.cluster_agent.lease
                          for s in servers]
                # seeded chaos riding along: the standby's first
                # replication pull after the kill fails transiently
                with faults.scoped({"seed": 11, "rules": [
                    {"site": "cluster.replicate", "op": "raise",
                     "exc": "ConnectionResetError", "count": 1},
                ]}):
                    a.partitioned = True  # SIGKILL, in-process
                    with pytest.raises(ConnectionError):
                        b.replicate_once()
                    assert b.maybe_promote(now=time.monotonic() + 1.0)
                assert b.term == 2
                # every worker heartbeat lands on the new primary with
                # its ORIGINAL lease — nothing was lost in the handoff
                for server, lease in zip(servers, leases):
                    agent = server.worker_state.cluster_agent
                    agent.poll_once()
                    assert agent.lease == lease
                    assert agent.reregistrations == 0
                    assert agent.term == 2
                # membership rode over: same worker set, same epoch
                assert ctx.cluster_epoch() == 2
                assert len(ctx.membership.live_addresses()) == 2
                # a second coordinator's warm shared-tier hit still
                # lands — the replicated result tier survived the kill
                cb = DistributedContext(cluster=client)
                try:
                    _register(cb, paths)
                    rel = cb.sql(DSQL)
                    assert isinstance(rel, CachedResultRelation)
                    assert rel.entry.shared
                    assert sorted(collect(rel).to_rows()) == want
                finally:
                    cb.close()
                # queries keep completing post-failover (zero failed):
                # a FRESH fingerprint forces a real fragment dispatch
                cold = ctx.sql(
                    "SELECT region, COUNT(1) FROM t GROUP BY region"
                )
                assert not isinstance(cold, CachedResultRelation)
                assert len(collect(cold).to_rows()) == len(want)
                # the revived old primary is fenced, not obeyed
                a.partitioned = False
                out = b.handle_request({"type": "kv_put", "key": "boom",
                                        "value": 1, "term": 1})
                assert out.get("code") == "stale_term"
                a.handle_request({"type": "peer_status", "term": b.term,
                                  "role": "primary", "addr": "b:2"})
                assert a.role == "standby"
            finally:
                ctx.close()
                for server in servers:
                    agent = server.worker_state.cluster_agent
                    if agent is not None:
                        agent.close()
                    server.shutdown()
                    server.server_close()

    def test_auto_worker_sync_on_epoch_change(self, cluster):
        """Satellite: the epoch-change callback folds joiners in and
        retires leavers without any sync_workers() call."""
        with DistributedContext(cluster=cluster.client,
                                result_cache=False) as ctx:
            assert len(ctx.workers) == 2
            late = serve("127.0.0.1:0", device="cpu",
                         cluster=cluster.client, lease_ttl_s=1.0)
            threading.Thread(target=late.serve_forever, daemon=True).start()
            try:
                # any view consumer observes the epoch move; the
                # subscription folds the joiner — no sync_workers()
                deadline = time.monotonic() + 5.0
                while len(ctx.workers) < 3:
                    ctx.cluster_epoch()
                    if time.monotonic() > deadline:
                        raise AssertionError(f"never folded: {ctx.workers}")
                    time.sleep(0.05)
                assert len(ctx.workers) == 3
            finally:
                late.worker_state.cluster_agent.close()
                late.shutdown()
                late.server_close()
            # the leaver is retired from the rotation automatically too
            deadline = time.monotonic() + 5.0
            while len(ctx.workers) > 2:
                ctx.cluster_epoch()
                if time.monotonic() > deadline:
                    raise AssertionError(f"never retired: {ctx.workers}")
                time.sleep(0.05)
            assert len(ctx.workers) == 2


# -- replica sets: quorum-acked writes, ranked elections, deadlines -------


def _replica_set(quorum=2, election_timeout_s=0.5):
    """3-node in-process replica set: a primary + two ranked standbys,
    quorum pushes armed, every node peering with the others."""
    a = ClusterNode(addr="a:1", write_quorum=quorum)
    b = ClusterNode(addr="b:2", standby_of=a, write_quorum=quorum,
                    rank=0, election_timeout_s=election_timeout_s)
    c = ClusterNode(addr="c:3", standby_of=a, write_quorum=quorum,
                    rank=1, election_timeout_s=election_timeout_s)
    a.peers = [b, c]
    b.peers = [a, c]
    c.peers = [a, b]
    return a, b, c, LocalClusterClient([a, b, c])


class TestReplicaSetQuorum:
    def test_acked_write_is_on_quorum_before_the_client_sees_it(self):
        a, b, c, client = _replica_set()
        rev = client.put("config/x", 42)
        # the ack implies BOTH standbys already hold the event (the
        # primary pushes to all, quorum gates the ack)
        assert b.state.get("config/x") == 42
        assert c.state.get("config/x") == 42
        assert b.state._rev >= rev and c.state._rev >= rev
        assert METRICS.counts.get("cluster.quorum_writes_acked", 0) >= 1

    def test_quorum_survives_one_dead_replica(self):
        a, b, c, client = _replica_set()
        c.partitioned = True
        rev = client.put("config/x", 1)  # 2/2 acks: a + b
        assert rev > 0 and b.state.get("config/x") == 1
        assert c.state.get("config/x") is None  # catches up via pull
        c.partitioned = False
        assert c.replicate_once() != 0  # events, or a first-pull snapshot
        assert c.state.get("config/x") == 1
        assert c.state._rev == a.state._rev

    def test_quorum_loss_refuses_the_ack_transiently(self):
        from datafusion_tpu_torch.errors import ClusterQuorumError

        a, b, c, _ = _replica_set()
        b.partitioned = True
        c.partitioned = True
        out = a.handle_request({"type": "kv_put", "key": "k", "value": 1})
        assert out.get("code") == "quorum_unavailable"
        assert out.get("acks") == 1 and out.get("quorum") == 2
        with pytest.raises(ClusterQuorumError):
            LocalClusterClient(a).put("k2", 2)
        assert METRICS.counts.get("cluster.quorum_write_failures", 0) >= 2
        # replicas return: the next write acks AND ships the backlog
        b.partitioned = False
        c.partitioned = False
        assert LocalClusterClient(a).put("k3", 3) > 0
        assert b.state.get("k") == 1  # the un-acked write replicated too
        assert b.state.get("k3") == 3

    def test_sustained_writes_batch_quorum_push_rounds(self):
        """An invalidation/write storm piggybacks pending event tails
        onto the in-flight push round: total push rounds stay BELOW
        the event count (naively it would be events x replicas), and
        every acked write still lands on both replicas."""
        a, b, c, client = _replica_set()
        base_rounds = METRICS.counts.get("cluster.replicate_push_rounds", 0)
        base_piggy = METRICS.counts.get(
            "cluster.replicate_push_piggybacked", 0)
        n = 8
        barrier = threading.Barrier(n)
        errors: list = []

        def put(i):
            try:
                barrier.wait(timeout=10)
                client.put(f"storm/{i}", i)
            except Exception as e:  # noqa: BLE001 — surfaced via the assert below
                errors.append(e)

        # delay the first push round per link: the other 7 writers
        # apply their events while it holds the link lock, so the
        # delayed round's payload (built after the sleep) carries the
        # whole storm and they all piggyback
        with faults.scoped({"rules": [
            {"site": "cluster.replicate", "op": "delay",
             "seconds": 0.25, "count": 2},
        ]}):
            threads = [threading.Thread(target=put, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        assert not errors, errors
        rounds = METRICS.counts.get(
            "cluster.replicate_push_rounds", 0) - base_rounds
        piggy = METRICS.counts.get(
            "cluster.replicate_push_piggybacked", 0) - base_piggy
        assert piggy >= 1
        assert rounds < n  # push-round count < event count
        for i in range(n):
            assert b.state.get(f"storm/{i}") == i
            assert c.state.get(f"storm/{i}") == i

    def test_lease_refresh_heartbeats_skip_the_quorum_round_trip(self):
        a, b, c, client = _replica_set()
        g = client.lease_grant(30.0)  # mutation: needs quorum (and got it)
        b.partitioned = True
        c.partitioned = True
        # refreshes append no events, so a partitioned replica set must
        # not fail (or slow) the worker heartbeat path
        resp = client.lease_refresh(g["lease"])
        assert resp["found"] is True

    def test_ranked_succession_with_election_quorum(self):
        a, b, c, client = _replica_set()
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
        a.partitioned = True
        now = time.monotonic()
        # rank 1 defers inside its stagger window while rank 0 claims
        assert not c.maybe_promote(now=now + 0.6)
        assert b.maybe_promote(now=now + 0.6)
        assert b.role == "primary" and b.term == 2
        # rank 1 then observes the new term and follows instead of racing
        assert not c.maybe_promote(now=now + 10.0)
        assert c.role == "standby" and c.term == 2
        assert c._primary_hint() == "b:2"
        # the new primary serves the replicated membership
        assert client.membership()["workers"].keys() == {"w:9"}

    def test_election_defers_without_quorum_reachability(self):
        a, b, c, _ = _replica_set()
        a.partitioned = True
        c.partitioned = True  # b can reach 1 < (3 - 2 + 1) = 2 nodes
        assert not b.maybe_promote(now=time.monotonic() + 10.0)
        assert b.role == "standby"
        assert b.elections_deferred >= 1
        # reachability restored: the same candidate now wins
        c.partitioned = False
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        assert b.role == "primary"

    def test_promoted_log_contains_every_acked_revision(self):
        """The acceptance property: writes acked while one standby was
        partitioned (quorum met via the OTHER standby) survive a
        primary kill even when the LAGGING standby is the ranked
        successor — its election catches up from the best responder
        before promoting."""
        a, b, c, client = _replica_set()
        client.put("config/base", 0)
        b.partitioned = True  # b lags; acks come from a + c
        acked = {}
        for i in range(5):
            key = f"config/k{i}"
            acked[key] = i
            assert client.put(key, i) > 0
        b.partitioned = False
        assert b.state.get("config/k0") is None  # genuinely behind
        a.partitioned = True  # SIGKILL the primary
        assert b.maybe_promote(now=time.monotonic() + 10.0)
        # zero acked-write loss: the promoted node replayed c's log
        for key, val in acked.items():
            assert b.state.get(key) == val, key
        # adopted c's whole log, +1 for b's own "promoted" event
        assert b.state._rev == c.state._rev + 1
        assert METRICS.counts.get("cluster.election_catchups", 0) >= 1

    def test_push_and_pull_race_stays_idempotent(self):
        a, b, c, client = _replica_set()
        for i in range(4):
            client.put(f"config/r{i}", i)  # pushed synchronously
        # the pull loop replays the same tail: zero double-applies
        assert b.replicate_once() == 0
        revs = [e["rev"] for e in b.state._events]
        assert len(revs) == len(set(revs))  # no duplicated log entries
        assert b.state._rev == a.state._rev

    def test_lagging_replica_resyncs_by_snapshot_push(self):
        a, b, c, client = _replica_set()
        client.put("config/seed", 1)
        b.partitioned = True
        for i in range(1100):  # blow past the retained log window
            client.invalidate(f"t{i}")
        b.partitioned = False
        snaps_before = b.snapshots_applied
        # clear the dead-replica push cooldown (quorum rounds skip a
        # recently-failed link while the OTHER replica covers quorum;
        # this test wants the push-path resync specifically, without
        # sleeping out the real cooldown window)
        for link in a._links.values():
            link.last_error_at = None
        assert client.put("config/after", 2) > 0
        assert b.snapshots_applied == snaps_before + 1
        assert b.state.get("config/after") == 2
        assert b.state._rev == a.state._rev

    def test_quorum_path_replicate_fault_site(self):
        """cluster.replicate now also guards the primary's push path:
        an injected push failure costs the ack (transient), not state."""
        from datafusion_tpu_torch.errors import ClusterQuorumError

        a, b, c, _ = _replica_set()
        client = LocalClusterClient(a)
        with faults.scoped({"rules": [
            {"site": "cluster.replicate", "op": "raise",
             "exc": "ConnectionResetError", "count": 2},
        ]}):
            # one request = one quorum round = 2 push-site hits; the
            # service answers quorum_unavailable for exactly that round
            out = a.handle_request({"type": "kv_put", "key": "k",
                                    "value": 1})
            assert out.get("code") == "quorum_unavailable"
        # the CLIENT retries quorum failures in place: exhaust its whole
        # budget (3 attempts x 2 pushes) and the typed error surfaces
        with faults.scoped({"rules": [
            {"site": "cluster.replicate", "op": "raise",
             "exc": "ConnectionResetError", "count": 6},
        ]}):
            with pytest.raises(ClusterQuorumError):
                client.request({"type": "kv_put", "key": "kx", "value": 1})
        assert METRICS.counts.get("cluster.client_quorum_retries", 0) >= 2
        assert client.put("k2", 2) > 0  # faults drained: acks flow again


class TestLeaseDeadlineShipping:
    def test_pull_ships_remaining_deadlines(self):
        a, b, client = _pair()
        g = client.lease_grant(30.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        shipped = b.state._shipped_deadlines
        assert g["lease"] in shipped
        assert 0.0 < shipped[g["lease"]] <= 30.0

    def test_promote_rearms_to_shipped_deadline_not_full_ttl(self):
        a, b, client = _pair()
        g = client.lease_grant(10.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        # the primary's clock says 2.5s remain (a holder that had been
        # silent for 7.5s of its 10s TTL — half-dead, not fresh)
        b.state.note_lease_deadlines({g["lease"]: 2.5})
        b.state.promote(2, now=1000.0)
        lease = b.state._leases[g["lease"]]
        assert lease.expires == pytest.approx(1002.5)
        # still alive inside the shipped budget...
        assert b.state.lease_refresh(g["lease"], now=1002.0)["found"]

    def test_promote_expires_past_deadline_holder_promptly(self):
        a, b, client = _pair()
        g = client.lease_grant(10.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        b.state.note_lease_deadlines({g["lease"]: 0.0})  # already dead
        b.state.promote(2, now=1000.0)
        # the next sweep collects it — no full-TTL masking of a corpse
        assert not b.state.lease_refresh(g["lease"], now=1000.1)["found"]
        assert b.state.membership(now=1000.1)["workers"] == {}

    def test_promote_caps_shipped_deadline_at_ttl(self):
        a, b, client = _pair()
        g = client.lease_grant(5.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        b.state.note_lease_deadlines({g["lease"]: 99.0})  # bogus upstream
        b.state.promote(2, now=1000.0)
        assert b.state._leases[g["lease"]].expires <= 1005.0

    def test_unshipped_lease_falls_back_to_full_ttl(self):
        a, b, client = _pair()
        g = client.lease_grant(5.0)
        client.put("workers/w:9", {}, lease=g["lease"])
        b.replicate_once()
        b.state.note_lease_deadlines({})  # legacy upstream: nothing shipped
        b.state.promote(2, now=1000.0)
        assert b.state._leases[g["lease"]].expires == pytest.approx(1005.0)


class TestDeltaPublish:
    def _tcp_tier(self):
        from datafusion_tpu_torch.cluster.service import serve as serve_cluster

        server = serve_cluster("127.0.0.1:0")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address[:2]
        return server, connect(f"{host}:{port}")

    def _entry(self, seed=0):
        rng = np.random.default_rng(7)
        cols = [np.arange(200_000, dtype=np.int64),
                rng.integers(0, 100, 200_000).astype(np.int64) + seed]
        nbytes = sum(c.nbytes for c in cols)
        return CachedResult(cols, [None, None], [None, None],
                           200_000, nbytes), nbytes

    def test_warm_republish_ships_only_changed_segments(self):
        server, client = self._tcp_tier()
        tier = SharedResultTier(client)
        try:
            entry, nbytes = self._entry(seed=0)
            sent_full = tier._publish_one("fp-delta", entry, nbytes, ("t",))
            assert sent_full > nbytes  # full snapshot crossed the wire
            # identical republish: digests only, no column bytes
            sent_same = tier._publish_one("fp-delta", entry, nbytes, ("t",))
            assert sent_same < nbytes * 0.01
            # one of two columns changes: ~half the bytes ship
            entry2, _ = self._entry(seed=1)
            sent_half = tier._publish_one("fp-delta", entry2, nbytes, ("t",))
            assert nbytes * 0.4 < sent_half < nbytes * 0.7
            assert METRICS.counts.get(
                "coord.shared_cache_delta_published", 0) >= 2
            # the assembled entry round-trips exactly
            fetched = client.result_fetch("fp-delta")
            assert fetched is not None
            np.testing.assert_array_equal(
                fetched[0].columns[1], entry2.columns[1]
            )
            np.testing.assert_array_equal(
                fetched[0].columns[0], entry2.columns[0]
            )
        finally:
            server.shutdown()
            server.server_close()

    def test_delta_falls_back_to_full_when_service_lost_the_base(self):
        server, client = self._tcp_tier()
        tier = SharedResultTier(client)
        try:
            entry, nbytes = self._entry()
            tier._publish_one("fp-fb", entry, nbytes, ("t",))
            client.invalidate("t")  # service dropped the entry
            assert client.result_fetch("fp-fb") is None
            misses = METRICS.counts.get("cluster.result_delta_misses", 0)
            sent = tier._publish_one("fp-fb", entry, nbytes, ("t",))
            assert sent > nbytes  # need_full -> full snapshot shipped
            assert METRICS.counts.get(
                "cluster.result_delta_misses", 0) == misses + 1
            assert client.result_fetch("fp-fb") is not None
        finally:
            server.shutdown()
            server.server_close()

    def test_in_process_delta_replicates_to_standby(self):
        a, b, _ = _pair()
        client = LocalClusterClient([a, b])
        tier = SharedResultTier(client)
        entry, nbytes = self._entry()
        tier._publish_one("fp-repl", entry, nbytes, ("t",))
        entry2, _ = self._entry(seed=3)
        tier._publish_one("fp-repl", entry2, nbytes, ("t",))
        b.replicate_once()
        stored = b.state.result_get("fp-repl")
        assert stored is not None
        np.testing.assert_array_equal(
            stored["snapshot"]["columns"][1], entry2.columns[1]
        )


class TestWatchChurnChaos:
    def test_watch_parked_across_promotion_under_seeded_faults(self, tmp_path):
        """Satellite: a watch parked across a SIGKILL election wakes on
        the promoted node with the correct term/epoch and neither
        duplicates nor skips events — with chaos riding the election
        and replication paths."""
        import signal as _signal  # noqa: F401 — documents the smoke's TCP twin

        servers = []
        addrs = []
        try:
            # 3-replica TCP set in-process: a primary + 2 ranked standbys
            from datafusion_tpu_torch.cluster.service import serve as serve_cluster

            pri = serve_cluster("127.0.0.1:0", write_quorum=2)
            threading.Thread(target=pri.serve_forever, daemon=True).start()
            servers.append(pri)
            pri_addr = "%s:%d" % pri.server_address[:2]
            addrs.append(pri_addr)
            for rank in (0, 1):
                stb = serve_cluster(
                    "127.0.0.1:0", standby_of=pri_addr, write_quorum=2,
                    rank=rank, election_timeout_s=0.5,
                )
                threading.Thread(target=stb.serve_forever,
                                 daemon=True).start()
                servers.append(stb)
                addrs.append("%s:%d" % stb.server_address[:2])
            for srv in servers:
                srv.cluster_node.peers = list(addrs)
            writer = connect(",".join(addrs))
            watcher = connect(",".join(addrs))

            # acked pre-kill state + one consumed event
            g = writer.lease_grant(30.0)
            writer.put("workers/w:9", {"addr": "w:9"}, lease=g["lease"])
            writer.invalidate("seen")
            since = writer.membership()["rev"]

            got: dict = {}

            def park():
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    try:
                        out = watcher.watch(since, timeout_s=3.0)
                    except (ConnectionError, OSError, ExecutionError):
                        time.sleep(0.05)
                        continue
                    if out.get("events"):
                        got.update(out)
                        return

            t = threading.Thread(target=park)
            t.start()
            time.sleep(0.3)  # let the watch park on the primary

            with faults.scoped({"seed": 23, "rules": [
                {"site": "cluster.election", "op": "raise",
                 "exc": "ExecutionError", "count": 1},
                {"site": "cluster.replicate", "op": "raise",
                 "exc": "ConnectionResetError", "count": 1},
            ]}):
                # SIGKILL the primary (in-process twin: hard server stop;
                # the OS-process + real-signal version runs in
                # scripts/scale_smoke.py)
                pri.shutdown()
                pri.server_close()
                # the acked invalidation lands on the PROMOTED node;
                # the writer sweeps endpoints until the election settles
                deadline = time.monotonic() + 15.0
                while True:
                    try:
                        writer.invalidate("churn")
                        break
                    except (ConnectionError, OSError, ExecutionError):
                        if time.monotonic() > deadline:
                            raise
                        time.sleep(0.1)
            t.join(timeout=15.0)
            assert not t.is_alive(), "watch never woke after the election"
            kinds = [(e["kind"], e.get("table")) for e in got["events"]]
            # exactly the post-cursor event: no duplicate of "seen", no
            # skipped "churn"
            assert kinds == [("invalidate", "churn")], kinds
            assert got["term"] >= 2  # answered by the promoted node
            assert "w:9" in got["workers"]  # membership survived intact
        finally:
            for srv in servers:
                try:
                    srv.shutdown()
                    srv.server_close()
                except OSError:
                    pass

    def test_dead_replica_cooldown_skips_push_while_quorum_holds(self):
        """One dead replica must not tax every write: after a failed
        push the link cools down and quorum rounds skip it (the other
        replica covers quorum); it is dialed again once needed or once
        the cooldown lapses."""
        a, b, c, client = _replica_set()
        client.put("config/x", 1)  # links warm, all healthy
        b.partitioned = True
        assert client.put("config/y", 2) > 0  # quorum via a + c
        blink = next(l for l in a._links.values() if l.target is b)
        assert blink.last_error_at is not None  # cooling
        b.partitioned = False
        assert client.put("config/z", 3) > 0
        # quorum was met by c, so the cooling link was skipped — b is
        # still behind and relies on its pull loop
        assert b.state.get("config/z") is None
        assert b.replicate_once() != 0
        assert b.state.get("config/z") == 3
        # but if the OTHER replica dies, the cooling link IS dialed
        # (quorum beats the cooldown)
        c.partitioned = True
        assert client.put("config/w", 4) > 0  # acks: a + b (re-probed)
        assert b.state.get("config/w") == 4
        assert blink.last_error_at is None  # healthy again
