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
           {"type": "execute_fragment", "fragment": <PlanFragment str>}
           {"type": "execute_plan", "fragment": <PlanFragment str>}
           {"type": "shuffle_map", "fragment": ..., "keys": [...],
            "num_parts": P, "side": "L"|"R"}
           {"type": "shuffle_join", "partition": p, "on": [[l,r]...],
            "join_type": ..., "left_blocks": [...], "right_blocks": [...]}
           {"type": "shutdown"}
Responses: {"type": "pong", ...} / {"type": "status", ...} /
           {"type": "partial_state", ...} / {"type": "rows", ...} /
           {"type": "shuffle_blocks", ...} / {"type": "bye"} /
           {"type": "error", "message": ...}

The `status` reply carries the worker's own counters: its queries and
errors, its fragment cache, its metrics, and the launches of each
kernel in this process (`exec/cuda.launch_counts`), which are the only
evidence that a kernel ran inside a worker.  The fault site
``worker.fragment`` (testing/faults.py) guards each executed (not
cached) fragment.

Waits for ROADMAP item 13.2, and raises naming it: the cluster agent
(`--cluster`), the debug HTTP plane (`--http-port`) and the
``telemetry`` and ``flight_dump`` requests.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch import cache as qcache
from datafusion_tpu_torch.cache import fragment_fingerprint
from datafusion_tpu_torch.datatypes import DataType
from datafusion_tpu_torch.errors import DataFusionError, ExecutionError, NotSupportedError
from datafusion_tpu_torch.exec.aggregate import AggregateRelation, _host_acc
from datafusion_tpu_torch.exec.context import ExecutionContext, _resolve_device
from datafusion_tpu_torch.exec.materialize import collect_columns
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.parallel.physical import PlanFragment
from datafusion_tpu_torch.parallel.wire import BinWriter, enc_array
from datafusion_tpu_torch.plan.logical import TableScan
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.deadline import Deadline, deadline_scope
from datafusion_tpu_torch.utils.eventloop import LoopServer

_LATER = "ROADMAP item 13.2 (the control plane and fleet observability)"


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

    def _gauges(self) -> dict:
        from datafusion_tpu_torch.utils import breaker as breaker_mod

        gauges = {}
        if self.fragment_cache is not None:
            gauges.update(self.fragment_cache.gauges())
        gauges.update(breaker_mod.gauges())
        return gauges

    def status(self) -> dict:
        """Operator introspection over the fragment protocol: uptime,
        query and error counts, the device, the fragment cache, every
        kernel's launches in this process (`kernels`), the metrics
        registry and its Prometheus rendering."""
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
            "metrics": {
                "timings_s": {k: round(v, 3) for k, v in snap["timings_s"].items()},
                "counts": snap["counts"],
            },
            "prometheus": prometheus_text(METRICS, extra_gauges=self._gauges()),
        }

    def _relation(self, frag: PlanFragment):
        plan = frag.logical_plan()
        scan = _find_scan(plan)
        ds = frag.build_datasource(self.batch_size)
        # result_cache=False: the partial-state path reads the raw
        # operator tree, and fragments cache one layer up
        ctx = ExecutionContext(device=self.device, batch_size=self.batch_size,
                               result_cache=False)
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
            raise
        recorder.record("fragment.serve", shard=frag.shard,
                        wall_s=round(time.perf_counter() - t0, 6))
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
        elif kind in ("telemetry", "flight_dump"):
            raise NotSupportedError(f"the {kind!r} request waits for {_LATER}")
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


def serve(bind: str = "127.0.0.1:0", device=None, batch_size: int = 131072,
          http_port: Optional[int] = None, cluster=None) -> WorkerServer:
    """Bind a worker and return its server (call `serve_forever`).
    `http_port` and `cluster` wait for ROADMAP item 13.2 and raise."""
    from datafusion_tpu_torch.utils.eventloop import ServerLoop, WireConnection

    if http_port:
        raise NotSupportedError(f"the worker's debug HTTP plane waits for {_LATER}")
    if cluster:
        raise NotSupportedError(f"cluster membership waits for {_LATER}")
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
    ap.add_argument("--http-port", type=int, default=0,
                    help=f"debug HTTP plane port: waits for {_LATER}")
    ap.add_argument("--cluster", default=None,
                    help=f"cluster state service address: waits for {_LATER}")
    ap.add_argument("--coordinator", default=None,
                    help="torch.distributed rendezvous address host:port "
                         "(with --num-processes and --process-id; omit on one host)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="torch.distributed world size")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this worker's torch.distributed rank")
    args = ap.parse_args(argv)
    faults.set_role("worker")
    try:
        if args.coordinator is not None or args.num_processes is not None:
            from datafusion_tpu_torch.parallel.mesh import initialize_distributed

            initialize_distributed(args.coordinator, args.num_processes, args.process_id)
            import torch.distributed as dist

            print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()} "
                  f"({dist.get_backend()})", flush=True)
        server = serve(args.bind, device=args.device, batch_size=args.batch_size,
                       http_port=args.http_port, cluster=args.cluster)
    except DataFusionError as e:
        print(f"worker: {e}", file=sys.stderr, flush=True)
        return 1
    host, port = server.server_address[:2]
    print(f"worker listening on {host}:{port}", flush=True)
    print(f"worker info: device={server.worker_state.device} "
          f"batch_size={args.batch_size}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0
