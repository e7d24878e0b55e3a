"""Worker node: executes shipped plan fragments on its device (the JAX
package's `parallel/worker.py`).

A worker receives a `PlanFragment` (JSON wire format), scans its
partition, runs the aggregate through the port's kernels on its device
(the grouped reduce up to `agg_max_groups()` groups, the radix sort's
sort-merge route above) and returns the *partial aggregate state*: the
accumulator arrays plus the group-key table, as key tuples and the
dictionaries their string codes refer to, never worker-local ids, so
either package's coordinator merges either package's worker.
Projection/Selection fragments return materialized rows instead.

Requests:  {"type": "ping"}
           {"type": "status"}
           {"type": "telemetry"}
           {"type": "flight_dump", "trace_id": ...}
           {"type": "execute_fragment", "fragment": <PlanFragment str>}
           {"type": "execute_plan", "fragment": <PlanFragment str>}
           {"type": "shuffle_map", "fragment": ..., "keys": [...],
            "num_parts": P, "side": "L"|"R"}
           {"type": "shuffle_join", "partition": p, "on": [[l,r]...],
            "join_type": ..., "left_blocks": [...], "right_blocks": [...]}
           {"type": "append", "table": ..., "columns": {...}, "client": ...}
             (a worker with an attached `ingest_ctx` only)
           {"type": "shutdown"}
Responses: {"type": "pong", ...} / {"type": "status", ...} /
           {"type": "telemetry", "snapshot": ...} /
           {"type": "flight_dump", "events": [...], ...} /
           {"type": "partial_state", ...} / {"type": "rows", ...} /
           {"type": "shuffle_blocks", ...} / {"type": "append_ack", ...} /
           {"type": "bye"} /
           {"type": "error", "message": ...}

The `status` reply carries the worker's own counters: its queries and
errors, its fragment cache, its metrics, its telemetry snapshot, and
the launches of each kernel in this process (`exec/cuda.launch_counts`),
which are the only evidence that a kernel ran inside a worker.  The
``telemetry`` reply is the node snapshot alone (obs/aggregate.py: the
latency histograms, ``fragment.latency`` among them, counters and
gauges; the JAX package's wire form, so either package's coordinator
aggregates either package's worker), ``flight_dump`` the flight ring
(filtered to one query's trace id when given).  `--http-port` (or
``DATAFUSION_TPU_DEBUG_PORT``; 0 is off, negative an ephemeral port)
serves the debug HTTP plane (obs/httpd.py) on the worker's host, with
`status` as its ``/status``.  The fault site ``worker.fragment``
(testing/faults.py) guards each executed (not cached) fragment.

`--cluster` (or ``DATAFUSION_TPU_CLUSTER``) registers the worker in the
cluster control plane (`cluster/agent.py`): a TTL lease on
``workers/<addr>``, kept alive by a heartbeat that carries the worker's
telemetry snapshot and applies the broadcast fragment-cache
invalidations; under QoS the lease also advertises the worker's pinned
tables and the device ledger's measured headroom
(``hbm_headroom_bytes``), which the coordinator's pin-aware placement
reads.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch import cache as qcache
from datafusion_tpu_torch.cache import fragment_fingerprint
from datafusion_tpu_torch.datatypes import DataType
from datafusion_tpu_torch.errors import DataFusionError, ExecutionError
from datafusion_tpu_torch.exec.aggregate import AggregateRelation, _host_acc
from datafusion_tpu_torch.exec.context import ExecutionContext, _resolve_device
from datafusion_tpu_torch.exec.materialize import collect_columns
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs.aggregate import observe_latency
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.parallel.physical import PlanFragment
from datafusion_tpu_torch.parallel.wire import BinWriter, enc_array
from datafusion_tpu_torch.plan.logical import TableScan
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.deadline import Deadline, deadline_scope
from datafusion_tpu_torch.utils.eventloop import LoopServer


def _find_scan(plan) -> TableScan:
    node = plan
    while node is not None:
        if isinstance(node, TableScan):
            return node
        kids = node.children()
        node = kids[0] if kids else None
    raise ExecutionError("fragment plan has no TableScan leaf")


def _copy_raw(x):
    """Deep copy of a raw response payload for the fragment cache: array
    slices would otherwise pin the larger buffers they view into."""
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    if isinstance(x, list):
        return [_copy_raw(y) for y in x]
    if isinstance(x, tuple):
        return tuple(_copy_raw(y) for y in x)
    if isinstance(x, dict):
        return {k: _copy_raw(v) for k, v in x.items()}
    return x


def _raw_nbytes(x) -> int:
    """Byte accounting for a raw payload (arrays and strings)."""
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_raw_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_raw_nbytes(y) for y in x.values())
    if isinstance(x, str):
        return len(x) + 16
    return 0


def _wire_columns(columns, bw):
    """Row columns on the wire: Utf8 as {codes, values}, the codes and
    every other column as (binary-segment) arrays."""
    return [
        {"codes": enc_array(c["codes"], bw), "values": c["values"]}
        if isinstance(c, dict) else enc_array(np.asarray(c), bw)
        for c in columns
    ]


def _wire_validity(validity, bw):
    return [None if v is None else enc_array(np.asarray(v), bw) for v in validity]


def _encode_response(raw: dict, frag: PlanFragment,
                     bw: Optional[BinWriter], cache_hit: bool) -> dict:
    """Raw payload (numpy arrays) -> wire response.  A cached payload
    re-encodes for every request that hits it, and answers with the
    CURRENT request's `fragment_id` (the merge side dedups on it)."""
    if raw["type"] == "partial_state":
        out = {
            "type": "partial_state",
            "fragment_id": frag.fragment_id,
            "num_groups": raw["num_groups"],
            "counts": enc_array(raw["counts"], bw),
            "slots": [enc_array(s, bw) for s in raw["slots"]],
            "key_rows": enc_array(raw["key_rows"], bw),
            "key_dicts": raw["key_dicts"],
            "slot_dicts": raw["slot_dicts"],
        }
    else:
        out = {
            "type": "rows",
            "fragment_id": frag.fragment_id,
            "num_rows": raw["num_rows"],
            "columns": _wire_columns(raw["columns"], bw),
            "validity": _wire_validity(raw["validity"], bw),
        }
    if cache_hit:
        out["cache_hit"] = True
    return out


class WorkerState:
    """One worker's execution state: its device, its fragment cache
    (fingerprint -> raw response payload; None when
    `DATAFUSION_TPU_CACHE=0`) and its counters.  `device=None` means
    `cuda:0` and raises without CUDA, as `ExecutionContext()` does."""

    def __init__(self, device=None, batch_size: int = 131072):
        self.device = _resolve_device(device)
        self.batch_size = batch_size
        self.queries = 0
        self.errors = 0
        self.started = time.time()
        self.fragment_cache = qcache.make_store("fragment")
        self.cache_hits = 0
        # the cluster agent (cluster/agent.py), in cluster mode only
        self.cluster_agent = None
        # the debug HTTP plane's port, advertised in the cluster lease
        self.debug_port: Optional[int] = None
        # the streaming-ingest seam (ingest/): a process embedding this
        # worker beside a long-lived ExecutionContext attaches that
        # context's IngestContext here, and the wire takes an `append`
        # request.  None on a plain fragment worker: its per-fragment
        # contexts have no tables to append to
        self.ingest_ctx = None

    def append(self, table: str, columns: dict,
               client: Optional[str] = None) -> dict:
        """Wire append: logged, then applied, on the attached ingest
        context.  IngestUnavailableError (a TransientError) crosses the
        wire as an error reply, so the coordinator retries, and the
        log's revision dedup absorbs the replay."""
        if self.ingest_ctx is None:
            from datafusion_tpu_torch.errors import IngestUnavailableError

            raise IngestUnavailableError("ingest not enabled on this worker")
        ack = self.ingest_ctx.append(table, columns, client=client or None)
        return {"type": "append_ack", **ack}

    @property
    def pins_rehydrated(self) -> int:
        """Pins a serving front door in this process re-materialized
        from its pin manifest (serve.py), advertised in the lease."""
        from datafusion_tpu_torch.utils.metrics import METRICS

        return int(METRICS.counts.get("serve.pins_rehydrated", 0))

    def pinned_fingerprints(self) -> list[str]:
        """The resident-table fingerprints this worker advertises in its
        cluster lease under QoS: the device ledger's ``table:<name>``
        pins plus the fragment cache's table tags as ``table:<name>``
        (a worker that served a table's fragments holds them warm).
        Sorted, so the lease value is stable (the agent re-puts only on
        a change)."""
        from datafusion_tpu_torch.obs.device import LEDGER

        fps = {fp for fp in LEDGER.pins_snapshot() if fp.startswith("table:")}
        if self.fragment_cache is not None:
            fps.update(f"table:{t}" for t in self.fragment_cache.tags())
        return sorted(fps)

    def _gauges(self) -> dict:
        from datafusion_tpu_torch.utils import breaker as breaker_mod

        gauges = {"obs.span_buffer_depth": obs_trace.buffered()}
        if self.fragment_cache is not None:
            gauges.update(self.fragment_cache.gauges())
        if self.cluster_agent is not None:
            gauges.update(self.cluster_agent.gauges())
        gauges.update(breaker_mod.gauges())
        return gauges

    def status(self) -> dict:
        """Operator introspection over the fragment protocol: uptime,
        query and error counts, the device, the fragment cache, every
        kernel's launches in this process (`kernels`), the telemetry
        snapshot, the metrics registry and its Prometheus rendering."""
        import torch

        from datafusion_tpu_torch.exec import cuda as cuda_mod
        from datafusion_tpu_torch.exec.cuda import hash_agg
        from datafusion_tpu_torch.obs.export import prometheus_text
        from datafusion_tpu_torch.utils.metrics import METRICS

        snap = METRICS.snapshot()
        return {
            "type": "status",
            "uptime_s": round(time.time() - self.started, 1),
            "queries": self.queries,
            "errors": self.errors,
            "device": str(self.device),
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else [],
            "pid": os.getpid(),
            "batch_size": self.batch_size,
            "kernels": {**cuda_mod.launch_counts(),
                        "hash_agg.multi": hash_agg.MULTI_LAUNCHES},
            "cache": {
                "fragment": (None if self.fragment_cache is None
                             else self.fragment_cache.stats()),
                "hits_served": self.cache_hits,
            },
            "debug_port": self.debug_port,
            "cluster": (None if self.cluster_agent is None
                        else self.cluster_agent.snapshot()),
            "telemetry": self.telemetry_snapshot(),
            "metrics": {
                "timings_s": {k: round(v, 3) for k, v in snap["timings_s"].items()},
                "counts": snap["counts"],
            },
            "prometheus": prometheus_text(METRICS, extra_gauges=self._gauges()),
        }

    def telemetry_snapshot(self) -> dict:
        """This worker's node snapshot for fleet aggregation, with its
        fragment-cache, breaker and cluster gauges folded in (the cluster
        heartbeat carries it: plain JSON values only)."""
        from datafusion_tpu_torch.obs.aggregate import node_snapshot

        snap = node_snapshot()
        snap["gauges"].update(self._gauges())
        return snap

    def _relation(self, frag: PlanFragment):
        plan = frag.logical_plan()
        scan = _find_scan(plan)
        ds = frag.build_datasource(self.batch_size)
        # result_cache=False: the partial-state path reads the raw
        # operator tree, and fragments cache one layer up
        ctx = ExecutionContext(device=self.device, batch_size=self.batch_size,
                               result_cache=False)
        # a fragment is not a fleet query: it records as fragment
        # latency (`_serve_fragment`), not in the query funnel
        ctx._telemetry = False
        ctx.register_datasource(scan.table_name, ds)
        return ctx.execute(plan), plan

    def _serve_fragment(self, frag: PlanFragment, compute) -> tuple[dict, bool]:
        """The fragment-cache seam: (raw response payload, was_hit).  The
        fault site ``worker.fragment`` guards execution only: a cached
        serve scans nothing."""
        cache = self.fragment_cache
        key = None
        if cache is not None:
            key = fragment_fingerprint(frag)
            hit = cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                recorder.record("cache.hit", level="fragment", shard=frag.shard)
                with obs_trace.span("worker.fragment", cache_hit=True, **frag.span_attrs()):
                    pass
                return hit, True
        faults.check("worker.fragment", shard=frag.shard, fragment_id=frag.fragment_id)
        t0 = time.perf_counter()
        try:
            with obs_trace.span("worker.fragment", **frag.span_attrs()):
                raw = compute(frag)
        except Exception as e:
            recorder.record("fragment.error", shard=frag.shard,
                            error=f"{type(e).__name__}: {e}")
            recorder.auto_capture("fragment_failure", lambda: {
                "fragment": frag.span_attrs(),
                "error": f"{type(e).__name__}: {e}",
            })
            raise
        dt = time.perf_counter() - t0
        observe_latency("fragment.latency", dt)
        recorder.record("fragment.serve", shard=frag.shard, wall_s=round(dt, 6))
        if cache is not None:
            stored = _copy_raw(raw)
            cache.put(key, stored, _raw_nbytes(stored), tags=frag.table_names())
        return raw, False

    def execute_fragment(self, fragment_str: str, bw: Optional[BinWriter] = None) -> dict:
        """Partial-aggregate path: accumulator state and key table."""
        frag = PlanFragment.from_json_str(fragment_str)
        raw, hit = self._serve_fragment(frag, self._execute_fragment)
        return _encode_response(raw, frag, bw, hit)

    def _execute_fragment(self, frag: PlanFragment) -> dict:
        rel, _plan = self._relation(frag)
        if not isinstance(rel, AggregateRelation):
            raise ExecutionError(
                "execute_fragment needs an Aggregate fragment; "
                f"got {type(rel).__name__} (use execute_plan)"
            )
        counts, accs = rel._pull_state(rel.accumulate())
        self.queries += 1
        n_groups = rel.encoder.num_groups if rel.key_cols else 1
        counts = np.asarray(counts)[:n_groups]
        # the slots in their numpy dtypes, as the JAX package ships them
        slots = [_host_acc(sl, a)[:n_groups] for sl, a in zip(rel.slots, accs)]
        # worker-local group ids mean nothing to the coordinator: ship
        # the key tuples and the dictionaries their codes refer to
        key_dicts = {}
        for k, idx in enumerate(rel.key_cols):
            d = rel._key_dicts.get(idx)
            key_dicts[str(k)] = None if d is None else list(d.values)
        slot_dicts = {}
        for slot_idx, sl in enumerate(rel.slots):
            if sl.is_string:
                d = rel._str_dicts.get(slot_idx)
                slot_dicts[str(slot_idx)] = [] if d is None else list(d.values)
        return {
            "type": "partial_state",
            "num_groups": n_groups,
            "counts": counts,
            "slots": slots,
            "key_rows": (rel.encoder._arr[:n_groups] if rel.key_cols
                         else np.empty((0, 0), np.int64)),
            "key_dicts": key_dicts,
            "slot_dicts": slot_dicts,
        }

    def execute_plan(self, fragment_str: str, bw: Optional[BinWriter] = None) -> dict:
        """Row path (Projection/Selection fragments): scan, filter and
        project on the device, materialize and ship the rows."""
        frag = PlanFragment.from_json_str(fragment_str)
        raw, hit = self._serve_fragment(frag, self._execute_plan)
        return _encode_response(raw, frag, bw, hit)

    def _execute_plan(self, frag: PlanFragment) -> dict:
        rel, plan = self._relation(frag)
        columns, validity, dicts, total = collect_columns(rel)
        self.queries += 1
        out_cols = []
        for i, f in enumerate(plan.schema.fields):
            c = columns[i]
            if f.data_type == DataType.UTF8:
                # codes plus a COMPACT value table of only the values
                # the rows reference
                from datafusion_tpu_torch.parallel.shuffle import compact_utf8

                d = dicts[i]
                out_cols.append(compact_utf8(c, [] if d is None else d.values))
            else:
                out_cols.append(c)
        return {"type": "rows", "num_rows": total, "columns": out_cols,
                "validity": list(validity)}

    def shuffle_map(self, fragment_str: str, keys: list, num_parts: int,
                    side: str, bw: Optional[BinWriter] = None) -> dict:
        """Map side of the shuffle: run the side's row fragment (through
        the fragment cache) and split its rows into `num_parts`
        hash-partitioned blocks."""
        from datafusion_tpu_torch.parallel import shuffle

        frag = PlanFragment.from_json_str(fragment_str)
        raw, hit = self._serve_fragment(frag, self._execute_plan)
        key_idx = [int(k) for k in keys]
        with obs_trace.span("worker.shuffle_map", side=side, **frag.span_attrs()):
            blocks = shuffle.split_blocks(
                raw, key_idx, int(num_parts),
                (fragment_fingerprint(frag), side, int(num_parts), key_idx),
            )
        out = {
            "type": "shuffle_blocks",
            "fragment_id": frag.fragment_id,
            "side": side,
            "num_rows": raw["num_rows"],
            "blocks": [shuffle.encode_block(b, bw) for b in blocks],
        }
        if hit:
            out["cache_hit"] = True
        return out

    def shuffle_join(self, msg: dict, bw: Optional[BinWriter] = None) -> dict:
        """Reduce side: merge both sides' blocks of one partition
        (duplicate fingerprints drop) and join them with the host
        `HashIndex`; answers in the `rows` shape."""
        from datafusion_tpu_torch.parallel import shuffle

        partition = int(msg["partition"])
        faults.check("worker.shuffle_join", partition=partition)
        with obs_trace.span("worker.shuffle_join", partition=partition):
            raw = shuffle.reduce_join(
                [shuffle.decode_block(o) for o in msg["left_blocks"]],
                [shuffle.decode_block(o) for o in msg["right_blocks"]],
                [(int(l), int(r)) for l, r in msg["on"]],
                msg.get("join_type", "inner"),
            )
        self.queries += 1
        return {
            "type": "rows",
            "fragment_id": f"{msg.get('query_id', '')}/p{partition}",
            "num_rows": raw["num_rows"],
            "columns": _wire_columns(raw["columns"], bw),
            "validity": _wire_validity(raw["validity"], bw),
        }


def _serve_worker_request(state: WorkerState, msg: dict):
    """One decoded request -> ``(response, BinWriter)``, on the event
    loop's bounded executor.  Raises `InjectedConnectionAbort` to sever
    the connection (the peer sees a mid-request EOF, as from a killed
    process)."""
    bw = BinWriter()
    adoption = obs_trace.adopt(msg.get("trace"))
    try:
        kind = msg.get("type")
        # the coordinator ships the REMAINING budget in seconds
        budget = msg.get("deadline_s")
        deadline = None if budget is None else Deadline.after(float(budget))
        if kind == "ping":
            out = {"type": "pong", "queries": state.queries}
        elif kind == "status":
            out = state.status()
        elif kind == "telemetry":
            # the fleet view's pull: the node snapshot alone
            out = {"type": "telemetry", "snapshot": state.telemetry_snapshot()}
        elif kind == "flight_dump":
            # the ring, filtered to one query when the coordinator
            # assembles that query's artifact set across its workers
            out = {
                "type": "flight_dump",
                "node": f"worker:{os.getpid()}",
                "events": recorder.events(trace_id=msg.get("trace_id") or None),
                "events_emitted": recorder.emitted(),
            }
        elif kind == "execute_fragment":
            with adoption, deadline_scope(deadline):
                out = state.execute_fragment(msg["fragment"], bw)
        elif kind == "execute_plan":
            with adoption, deadline_scope(deadline):
                out = state.execute_plan(msg["fragment"], bw)
        elif kind == "shuffle_map":
            with adoption, deadline_scope(deadline):
                out = state.shuffle_map(msg["fragment"], msg["keys"],
                                        int(msg["num_parts"]), msg.get("side", ""), bw)
        elif kind == "shuffle_join":
            with adoption, deadline_scope(deadline):
                out = state.shuffle_join(msg, bw)
        elif kind == "append":
            with adoption, deadline_scope(deadline):
                out = state.append(msg["table"], msg["columns"], msg.get("client"))
        else:
            out = {"type": "error", "message": f"unknown request {kind!r}"}
    except faults.InjectedConnectionAbort:
        raise
    except DataFusionError as e:
        out = {"type": "error", "message": str(e)}
        bw = BinWriter()  # a failed build may have left partial segments
        state.errors += 1
    except Exception as e:  # noqa: BLE001 — a worker must not die on a bad query
        out = {"type": "error", "message": f"{type(e).__name__}: {e}"}
        bw = BinWriter()
        state.errors += 1
    if adoption.trace_id is not None and isinstance(out, dict):
        out["spans"] = obs_trace.drain(adoption.trace_id)
    return out, bw


class WorkerServer(LoopServer):
    """The worker on the selector event loop: one thread accepts, reads
    and writes; fragments execute on the bounded pool."""

    worker_state: WorkerState
    http_server = None

    def server_close(self) -> None:
        if self.http_server is not None:
            self.http_server.close()
            self.http_server = None
        super().server_close()


def serve_http_status(state: WorkerState, host: str, port: int):
    """The worker's debug HTTP plane (obs/httpd.py): `GET /status` (and
    `/healthz`) answers the fragment protocol's `status`, `GET /metrics`
    the Prometheus text with the worker's gauges, and every `/debug/*`
    route rides the same port."""
    from datafusion_tpu_torch.obs.httpd import DebugServer

    return DebugServer(port, host, label=f"worker:{os.getpid()}",
                       gauges_fn=state._gauges, status_fn=state.status)


def serve(bind: str = "127.0.0.1:0", device=None, batch_size: int = 131072,
          http_port: Optional[int] = None, cluster=None,
          lease_ttl_s: Optional[float] = None,
          advertise: Optional[str] = None) -> WorkerServer:
    """Bind a worker and return its server (call `serve_forever`).
    `http_port` (non-zero; negative binds an ephemeral port) also serves
    the debug HTTP plane on this host, loopback unless
    ``DATAFUSION_TPU_DEBUG_BIND`` says otherwise; a bind failure leaves
    the worker without it (``obs.debug_server_errors``).  `cluster` (a
    service address or comma-separated HA endpoint list, a
    `ClusterState`/`ClusterNode`, or a client) registers the worker in
    the cluster control plane under a TTL lease (`lease_ttl_s`, default
    ``DATAFUSION_TPU_CLUSTER_TTL_S``) kept alive by a heartbeat thread
    (`cluster/agent.py`); `advertise` is the host[:port] coordinators
    dial, needed behind a wildcard bind."""
    from datafusion_tpu_torch.utils.eventloop import ServerLoop, WireConnection

    host, _, port = bind.partition(":")
    state = WorkerState(device=device, batch_size=batch_size)
    loop = ServerLoop(pool_size=None, name="df-torch-worker")

    def on_message(conn, msg):
        if msg.get("type") == "shutdown":
            conn.reply(msg, {"type": "bye"})
            loop.call_later(0.05, loop.stop)  # after the bye flushes
            return
        conn.defer_reply(msg, lambda: _serve_worker_request(state, msg))

    lsock = loop.listen(host, int(port or 0),
                        lambda lp, sock, a: WireConnection(lp, sock, a, on_message))
    server = WorkerServer(loop, lsock)
    server.worker_state = state
    if http_port:
        from datafusion_tpu_torch.obs.httpd import debug_bind_host
        from datafusion_tpu_torch.utils.metrics import METRICS

        try:
            server.http_server = serve_http_status(state, debug_bind_host(host),
                                                   max(int(http_port), 0))
        except OSError:
            METRICS.add("obs.debug_server_errors")
        else:
            state.debug_port = server.http_server.port
    if cluster:
        from datafusion_tpu_torch import cluster as _cluster_mod
        from datafusion_tpu_torch.cluster.agent import WorkerClusterAgent

        bound_host, bound_port = server.server_address[:2]
        if advertise:
            adv_host, _, adv_port = advertise.partition(":")
            addr = f"{adv_host or bound_host}:{adv_port or bound_port}"
        else:
            adv_host = bound_host
            if adv_host in ("0.0.0.0", "::", ""):
                # a wildcard bind is not a dialable address
                import socket

                try:
                    adv_host = socket.gethostbyname(socket.gethostname())
                except OSError:
                    adv_host = socket.gethostname()
            addr = f"{adv_host}:{bound_port}"
        state.cluster_agent = WorkerClusterAgent(
            _cluster_mod.connect(cluster), addr, state, ttl_s=lease_ttl_s).start()
    return server


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="datafusion-tpu-torch-worker",
        description="datafusion_tpu_torch worker node (executes plan fragments)",
    )
    ap.add_argument("--bind", default="127.0.0.1:8462",
                    help="host:port to listen on (default 127.0.0.1:8462; port 0 = ephemeral)")
    ap.add_argument("--device", default=None,
                    help="execution device: cuda[:N] | cpu (default: cuda:0; "
                         "exits with an error without CUDA)")
    ap.add_argument("--batch-size", type=int, default=131072)
    ap.add_argument("--http-port", type=int,
                    default=int(os.environ.get("DATAFUSION_TPU_DEBUG_PORT", "0") or 0),
                    help="debug HTTP plane port (/status, /metrics, /debug/*; "
                         "obs/httpd.py): 0 is off (the default; env "
                         "DATAFUSION_TPU_DEBUG_PORT), negative an ephemeral port")
    ap.add_argument("--cluster", default=None,
                    help="cluster state service address host:port, or a "
                         "comma-separated HA endpoint list (default: env "
                         "DATAFUSION_TPU_CLUSTER; empty = cluster mode off)")
    ap.add_argument("--advertise", default=None,
                    help="host[:port] coordinators dial for this worker "
                         "(behind a wildcard bind; default: the bound address)")
    ap.add_argument("--coordinator", default=None,
                    help="torch.distributed rendezvous address host:port "
                         "(with --num-processes and --process-id; omit on one host)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="torch.distributed world size")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this worker's torch.distributed rank")
    args = ap.parse_args(argv)
    faults.set_role("worker")
    obs_trace.set_process_role("worker")
    try:
        if args.coordinator is not None or args.num_processes is not None:
            from datafusion_tpu_torch.parallel.mesh import initialize_distributed

            initialize_distributed(args.coordinator, args.num_processes, args.process_id)
            import torch.distributed as dist

            print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()} "
                  f"({dist.get_backend()})", flush=True)
        cluster = args.cluster
        if cluster is None:
            from datafusion_tpu_torch.cluster import cluster_address

            cluster = cluster_address()
        server = serve(args.bind, device=args.device, batch_size=args.batch_size,
                       http_port=args.http_port, cluster=cluster,
                       advertise=args.advertise)
    except DataFusionError as e:
        print(f"worker: {e}", file=sys.stderr, flush=True)
        return 1
    host, port = server.server_address[:2]
    print(f"worker listening on {host}:{port}", flush=True)
    if server.http_server is not None:
        print(f"worker debug: {server.http_server.url}/debug", flush=True)
    if cluster:
        print(f"worker cluster: registered with {cluster}", flush=True)
    print(f"worker info: device={server.worker_state.device} "
          f"batch_size={args.batch_size}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        agent = server.worker_state.cluster_agent
        if agent is not None:
            agent.close()  # revoke the lease: the epoch moves now
        server.server_close()
    return 0
