"""The serving front door: one engine, many clients.

The counterpart of the JAX package's `serve.py` (its core: admission,
pinned tables and the megabatch lanes).  A `Server` over one
`ExecutionContext` admits many clients' queries, runs them on a few
worker threads and folds compatible concurrent queries into one scan:

- **Admission.**  `submit` parses and plans on the caller's thread,
  then either queues the query (`queries_queued`) or sheds it
  (`queries_shed`, `QueryShedError`) for one of three reasons: the
  queue is at depth (`queue`), the deadline cannot be met, given the
  service time observed so far (`deadline`), or the tables it would pin
  do not fit the device memory's headroom even after eviction (`hbm`);
  `stop` sheds what is still queued (`shutdown`).  Every admitted query
  reaches `ExecutionContext.execute`, so `admitted + shed == submitted`
  holds on every server.
- **Pinned tables.**  The first query over a table promotes its source
  to a `PinnedSource`: the scan is materialized once into a batch list
  that every later query scans, so the device copies the first query
  made (cached on the batches) serve every later one, and the list is
  pinned in the device ledger (`obs/device.LEDGER`, `table:<name>`),
  which evicts it under memory pressure by priority, then least recent
  use; eviction returns the batches' caches to what they held before
  the pin.  A pinned table also holds one group-key encoder (and one lock)
  per set of GROUP BY columns and one cache of aux tables per core, so
  a warm aggregate query replays the ids and tables earlier queries
  encoded and copied: no host encode and no upload.  The joins of a
  served plan pin their builds in the same ledger (join/relation.py).
  `stop` gives the context its registered sources back and unpins every
  table and build the server pinned.
- **Megabatching.**  Queries flushed from one batching window with a
  compatible shape (`_mega_signature`, then `_mega_key` on the lowered
  relations) scan their table once, in one of three lanes:
  - aggregate (`exec/aggregate.run_aggregate_megabatch`): up to
    `megabatch_max` queries whose cores differ at most in their
    literals; one launch of the grouped reduce's query axis per slot per
    batch group for all of them;
  - TopK (`exec/sort.run_topk_megabatch`): `ORDER BY ... LIMIT k`
    queries that differ only in k; one radix-sort merge per batch group;
  - pipeline (`exec/relation.run_pipeline_megabatch`): filter/project
    queries of one core; one pass per batch group.
  Each query's answer is its solo answer, bit for bit.  The query axis
  is not padded: eager torch compiles nothing per query count.

Worker threads run their launches on the context's device
(`torch.cuda.device`), never on a thread's default device, and each on
a CUDA stream of its own (`exec/streams.serving_scope`), so the event
pair that meters a served pass (`utils/retry._pass`) never times another
worker's kernels or copies.  Device values one worker caches and another reads (a
pinned table's copies, ids and aux tables, a pinned join build) carry
an event of their producing stream, which each reader's stream waits
for on the device (`exec/streams.publish`, `shared`); so do a
megabatch's outputs, which its members may finish on another worker.

The pin's accounted bytes start as the host estimate of its batches
(`ensure`) and, after a served query over it that copied to the
device, become the measured bytes of the device tensors cached on them
(`_measure_pins`), so eviction and the `hbm` shed read what the pin
would free.

Env knobs, each prefixed `DATAFUSION_TPU_SERVE_`: `QUEUE` (queue depth,
64), `WORKERS` (executor threads, 2), `WINDOW_MS` (batching window, 2),
`MEGABATCH` (queries a megabatch folds at most, 16; below 2 none; a
window closes when it holds that many, after `WINDOW_MS` without an
arrival, or twice `WINDOW_MS` after it opened),
`PIN` (1 pins tables, 0 streams them), `DEADLINE_S` (default budget;
unset: none).

- **Streaming appends.**  `ingest()` is the context's ingest plane
  (ingest/) with the serving hook installed; `append(table, columns)`
  logs and applies one delta (`IngestContext.append`).  A pinned table
  takes the appendable in under its pin (`PinnedSource.splice_appendable`):
  its resident list is the appendable's live list, so an append grows
  the pinned copy in place, the next served query copies only the
  delta's used columns and its group ids (the table's shared encoder
  encodes only the delta), and `_on_append_applied` grows the ledger's
  pin accounting by the delta.  The append bumps `data_version`, which
  is part of `data_identity`, so a join build pinned over the table is
  re-keyed, never reused stale.  `submit` also takes CREATE MATERIALIZED
  VIEW, run at once on the caller's thread.
- **Pin manifest.**  With `pin_manifest=PATH` (or
  `DATAFUSION_TPU_SERVE_PIN_MANIFEST`, or `pin_manifest.json` in
  `DATAFUSION_TPU_WAL_DIR`) every residency change rewrites the resident
  set through `utils/wal.atomic_write_json` (tmp, fsync, rename), and
  `start()` re-pins the tables it names before the dispatcher runs
  (`pins_rehydrated`); `stop()` leaves the manifest as it stood while
  serving.  A query the result cache answers (exec/context.py) replays
  on its worker like any solo query.

- **Tenancy.**  `submit(sql, client_id=...)` and `append(...,
  client_id=...)` name the client a query or a delta runs for (unset:
  ``"default"``).  Every cost apportions back to it (obs/attribution.py):
  a solo query's launches and copies run under `client_scope`, a
  megabatch's under `shared_scope` over its members, weighted by the
  rows of the tables each one scans (`_member_weights`, the cost store's
  ``scan`` records; an even split until they are known), pinned tables
  and join builds accrue byte-seconds to the clients that scan them,
  and every fulfilled ticket's end-to-end wall decomposes into the
  serving chain (`_segments`) for the tail explainer (`observe_path`).
  Sheds charge ``tenant.<id>.shed``.
- **Weighted fair queueing** (qos.py): with `shares={"A": 3, "B": 1}`
  (or ``DATAFUSION_TPU_QOS=1`` and ``DATAFUSION_TPU_QOS_SHARES``) a
  flushed window drains in the policy's order (`FairSharePolicy.order`:
  virtual time over the metered service, so a share-3 tenant runs 3
  queries per share-1 query under contention), and a full queue sheds
  the tenant furthest over its share (`shed_victim`): its newest, least
  urgent queued ticket, or the arrival itself, with the reason
  ``quota`` and the meters ``tenant.<id>.shed_<reason>``.  With neither,
  admission is FIFO and no per-reason meter is kept.
- **Cost.**  Each arrival's spacing is observed in the cost store
  (``__serve__`` / ``arrivals``), and a server whose window was left at
  its default (no `window_s`, no ``DATAFUSION_TPU_SERVE_WINDOW_MS``)
  waits `_effective_window_s()` instead: the store's window for the
  observed spacing (cost/advisor.serve_window_s, a ``serve.window_ms``
  decision).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from functools import partial
from typing import Optional

import numpy as np
import torch

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import NotSupportedError, QueryShedError
from datafusion_tpu_torch.exec.datasource import DataSource, host_bytes
from datafusion_tpu_torch.exec.streams import publish, serving_scope, shared
from datafusion_tpu_torch.obs import recorder, slo
from datafusion_tpu_torch.obs.aggregate import observe_latency
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.utils.deadline import Deadline, deadline_scope
from datafusion_tpu_torch.utils.metrics import METRICS

def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if not v else int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if not v else float(v)


class Ticket:
    """One submitted query's handle: `result()` blocks until the server
    fulfills or fails it.  The outcome is written once."""

    __slots__ = ("sql", "plan", "deadline", "signature", "submitted_mono",
                 "_evt", "_table", "_error", "_rel", "client_id", "entry_mono",
                 "admitted_mono", "enqueued_mono", "flushed_mono", "exec_start_mono",
                 "launch_share_s", "demux_share_s", "copied")

    def __init__(self, sql: str, plan, deadline: Optional[Deadline], signature,
                 client_id: str = "default", entry_mono: Optional[float] = None):
        self.sql = sql
        self.plan = plan
        self.deadline = deadline
        self.signature = signature
        self.client_id = client_id
        self.submitted_mono = time.monotonic()
        # the serving chain's stamps (`Server._segments`): submit entry,
        # queue-slot reservation, window entry, window flush, execution
        self.entry_mono = self.submitted_mono if entry_mono is None else entry_mono
        self.admitted_mono: Optional[float] = None
        self.enqueued_mono: Optional[float] = None
        self.flushed_mono: Optional[float] = None
        self.exec_start_mono: Optional[float] = None
        # this query's apportioned share of the launch walls it rode and
        # of its megabatch's state pull
        self.launch_share_s = 0.0
        self.demux_share_s = 0.0
        # whether its megabatch's pass copied to the device
        self.copied = False
        self._evt = threading.Event()
        self._table = None
        self._error: Optional[BaseException] = None
        self._rel = None

    @property
    def done(self) -> bool:
        return self._evt.is_set()

    def _fulfill(self, table) -> None:
        if not self._evt.is_set():
            self._table = table
            self._evt.set()

    def _fail(self, exc: BaseException) -> None:
        if not self._evt.is_set():
            self._error = exc
            self._evt.set()

    def result(self, timeout: Optional[float] = None):
        """The `ResultTable` (blocking), or raises the query's error
        (`QueryShedError` included)."""
        if not self._evt.wait(timeout):
            raise TimeoutError(f"query not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._table


class PinnedSource(DataSource):
    """A registered source promoted to a pinnable resident.

    Cold, it streams the inner source.  `ensure()` materializes the scan
    once into a batch list and pins it in the ledger under
    `table:<name>`; from then on every query scans the same batch
    objects, so the device copies cached on them serve every query.
    Eviction (`_drop`) releases the list and returns the batches' caches
    to what they held before the pin; the next query goes cold again.  Schema and data identity delegate to
    the inner source.  A CSV table is parsed once, on the thread that
    pins it; its batches keep the dictionary versions the reader pinned
    on them (`batch.pin_dict_versions`)."""

    def __init__(self, inner: DataSource, name: str):
        self.inner = inner
        self.name = name
        self.fingerprint = f"table:{name}"
        self._resident: Optional[list] = None
        # residency-change hook (the server's pin-manifest save), called
        # outside the lock after `ensure` and `_drop`
        self.on_change = None
        # each resident batch's cache as the pin found it (`_drop`)
        self._caches_before: Optional[list] = None
        self._lock = lockcheck.make_lock("serve.pin_source")
        # cross-query execution state (`shared_state_for`)
        self._encoders: dict = {}
        self._cores: dict = {}
        # one measurement of the pin's device bytes at a time
        # (`Server._measure_pins`)
        self.measure_lock = lockcheck.make_lock("serve.pin_measure")

    @property
    def schema(self):
        return self.inner.schema

    @property
    def parses(self) -> bool:
        return self._resident is None and self.inner.parses

    @property
    def data_identity(self) -> tuple:
        return self.inner.data_identity

    @property
    def data_version(self) -> int:
        # an appendable inner versions per delta; fingerprints read the
        # registered source
        return self.inner.data_version

    def with_projection(self, projection) -> DataSource:
        return _PinnedProjection(self, list(projection))

    def splice_appendable(self, cls):
        """Take an appendable source (`cls` is ingest.AppendableSource)
        in UNDER this pin: it materializes from the current batches (the
        same objects when resident, so their device copies survive), and
        a resident pin's list becomes the appendable's live list, so
        every later append grows the pinned copy in place.  Idempotent;
        `IngestContext._wrap_source` calls it on first attach."""
        with self._lock:
            if isinstance(self.inner, cls):
                return self.inner
        # materializing may parse a file: outside the lock, as `ensure`
        src = cls.wrap(self, name=self.name)
        with self._lock:
            if isinstance(self.inner, cls):
                return self.inner
            self.inner = src
            if self._resident is not None:
                self._resident = src.live_batches
        return src

    def estimated_bytes(self) -> int:
        """The resident list's bytes once materialized, else the inner
        source's estimate (0 when unknown: admission never sheds)."""
        res = self._resident
        if res is not None:
            return host_bytes(res)
        return self.inner.estimated_bytes()

    @property
    def resident(self) -> bool:
        return self._resident is not None

    def ensure(self) -> bool:
        """Materialize and pin (idempotent).  The scan runs outside the
        lock (a CSV parse takes seconds); of two racing scans the first
        to store its list wins and the other is dropped, so every query
        sees one list and one set of dictionary versions."""
        with self._lock:
            if self._resident is not None:
                LEDGER.pinned(self.fingerprint)  # a use: recency, priority
                return True
        # an appendable inner pins its LIVE list, which appends grow
        live = getattr(self.inner, "live_batches", None)
        batches = live if live is not None else list(self.inner.batches())
        with self._lock:
            if self._resident is None:
                self._caches_before = [dict(b.cache) for b in batches]
                self._resident = batches
            batches = self._resident
        nbytes = host_bytes(batches)
        LEDGER.pin(self.fingerprint, nbytes=nbytes, owner=f"pin.{self.name}",
                   on_evict=self._drop, artifact=self)
        METRICS.add("serve.tables_pinned")
        recorder.record("serve.pin", table=self.name, bytes=nbytes, batches=len(batches))
        cb = self.on_change
        if cb is not None:
            cb()
        return True

    def _drop(self) -> None:
        """The ledger's eviction hook: release the resident batches and
        the shared state keyed to them, and return each batch's cache
        to what it held before the pin.  An in-memory inner source holds
        the same batch objects, so what the served queries cached on
        them (device copies, ids, tables) would otherwise outlive the
        pin; what was there before stays for the inner source's
        queries."""
        with self._lock:
            res, self._resident = self._resident, None
            before, self._caches_before = self._caches_before, None
            self._encoders.clear()
            self._cores.clear()
        if res is not None:
            # batches appended since the pin held nothing before it
            for i, b in enumerate(list(res)):
                b.cache.clear()
                if i < len(before):
                    b.cache.update(before[i])
        METRICS.add("serve.tables_evicted")
        recorder.record("serve.evict", table=self.name)
        cb = self.on_change
        if cb is not None:
            cb()

    def batches(self):
        res = self._resident
        if res is not None:
            # a snapshot: the resident list may be an appendable's live
            # list, and an append must not extend a scan that started
            return iter(list(res))
        return self.inner.batches()

    def release(self) -> None:
        """Unpin this table (its server stops): the ledger's entry if it
        is still this source's, and the resident list in any case."""
        if not LEDGER.unpin(self.fingerprint, reason="stop", artifact=self) and self.resident:
            self._drop()

    def shared_state_for(self, key_sig, core) -> dict:
        """The cross-query state of relations over this table: one
        append-only group-key encoder and its lock per set of GROUP BY
        columns `key_sig` (ids depend on the key columns alone, so they
        replay for every query grouping by them), and one cache of aux
        and string-rank tables per core (a core's aux specs embed its
        string literals).  Strong references keep each core's id
        stable."""
        from datafusion_tpu_torch.exec.aggregate import GroupKeyEncoder

        with self._lock:
            enc = self._encoders.get(key_sig)
            if enc is None:
                enc = self._encoders[key_sig] = (GroupKeyEncoder(len(key_sig)),
                                                 lockcheck.make_lock("serve.shared_ids"))
            caches = self._cores.get(id(core))
            if caches is None or caches[0] is not core:
                caches = self._cores[id(core)] = (core, {}, {})
        return {"encoder": enc[0], "lock": enc[1], "aux": caches[1], "str_aux": caches[2]}


class _PinnedProjection(DataSource):
    """A column projection over a `PinnedSource` that keeps batch
    identity: each projected batch is a `subset_view` cached on its
    parent batch, so device copies made against a projection survive
    re-scans and serve other queries."""

    def __init__(self, parent: PinnedSource, cols: list):
        self.parent = parent
        self.cols = cols
        self._schema = parent.schema.select(cols)

    @property
    def schema(self):
        return self._schema

    @property
    def parses(self) -> bool:
        return self.parent.parses

    def with_projection(self, projection):
        return _PinnedProjection(self.parent, [self.cols[i] for i in projection])

    def batches(self):
        from datafusion_tpu_torch.exec.batch import subset_view

        for b in self.parent.batches():
            yield subset_view(b, self.cols)


def _cached_tensors(batches) -> list:
    """Every tensor cached on `batches` and on the view batches cached
    on them (`subset_view`): device copies, group ids, tables."""
    from datafusion_tpu_torch.exec.batch import RecordBatch

    out: list = []
    stack = [v for b in batches for v in b.cache.values()]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, RecordBatch):
            stack.extend(v.cache.values())
    return out


# what a megabatch lane leaves on each member relation (`_run_megabatch`)
_INJECTED = ("_injected_state", "_injected_topk", "_injected_batches")


def _injected_tensors(rels) -> list:
    """The tensors a megabatch lane left on `rels`: in the lanes'
    output batches, row ids and states."""
    from datafusion_tpu_torch.exec.batch import RecordBatch

    out: list = []
    stack = [r.__dict__.get(k) for r in rels for k in _INJECTED]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, RecordBatch):
            stack.extend(v.data)
            stack.extend(v.validity)
            stack.append(v.mask)
    return out


def _pin_of(rel) -> Optional[PinnedSource]:
    """The resident PinnedSource a relation scans directly, if any."""
    ds = getattr(getattr(rel, "child", None), "datasource", None)
    if isinstance(ds, _PinnedProjection):
        ds = ds.parent
    if isinstance(ds, PinnedSource) and ds.resident:
        return ds
    return None


def _key_signature(rel) -> tuple:
    """An aggregate's GROUP BY columns as columns of the table itself
    (a projected scan renumbers them)."""
    ds = rel.child.datasource
    cols = ds.cols if isinstance(ds, _PinnedProjection) else None
    return tuple(c if cols is None else cols[c] for c in rel.key_cols)


def _blank_literals(obj):
    """A plan's wire JSON with every literal's value and every LIMIT
    taken out: plans that agree under it differ only in those."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "Literal" and isinstance(v, dict):
                out[k] = sorted(v)
            elif k == "limit":
                out[k] = None
            else:
                out[k] = _blank_literals(v)
        return out
    if isinstance(obj, list):
        return [_blank_literals(v) for v in obj]
    return obj


class Server:
    """The serving front door over one `ExecutionContext`.

    `start()` runs the dispatcher loop on a daemon thread; `submit(sql)`
    returns a `Ticket`; `stop()` sheds what is queued and stops the
    loop and its workers.  Also a context manager."""

    def __init__(self, ctx, workers: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 window_s: Optional[float] = None,
                 megabatch_max: Optional[int] = None,
                 pin: Optional[bool] = None,
                 default_deadline_s: Optional[float] = None,
                 pin_manifest: Optional[str] = None,
                 shares: Optional[dict] = None):
        from datafusion_tpu_torch import qos
        from datafusion_tpu_torch.utils.eventloop import ServerLoop

        self.ctx = ctx
        # weighted fair queueing and the quota shed (qos.py): a policy
        # when `shares` is given or DATAFUSION_TPU_QOS=1, else None, and
        # a None policy is FIFO admission
        self._qos = qos.policy_from_config(shares)
        # the durable pin manifest (module docstring); unset: off
        if pin_manifest is None:
            pin_manifest = os.environ.get("DATAFUSION_TPU_SERVE_PIN_MANIFEST")
            if not pin_manifest:
                wal_dir = os.environ.get("DATAFUSION_TPU_WAL_DIR")
                if wal_dir:
                    pin_manifest = os.path.join(wal_dir, "pin_manifest.json")
        self._pin_manifest_path = pin_manifest or None
        self.pins_rehydrated = 0
        self._workers = workers or _env_int("DATAFUSION_TPU_SERVE_WORKERS", 2)
        self._queue_depth = queue_depth or _env_int("DATAFUSION_TPU_SERVE_QUEUE", 64)
        self._window_s = (window_s if window_s is not None
                          else _env_float("DATAFUSION_TPU_SERVE_WINDOW_MS", 2.0) / 1e3)
        # a configured window (kwarg or env) stays fixed; the default
        # adapts to the observed arrival spacing (cost/advisor)
        self._window_adaptive = (window_s is None
                                 and "DATAFUSION_TPU_SERVE_WINDOW_MS" not in os.environ)
        self._last_arrival_mono: Optional[float] = None  # loop thread only
        self._window_noted_s: Optional[float] = None  # loop thread only
        self._megabatch_max = (megabatch_max if megabatch_max is not None
                               else _env_int("DATAFUSION_TPU_SERVE_MEGABATCH", 16))
        if pin is None:
            pin = os.environ.get("DATAFUSION_TPU_SERVE_PIN", "1") != "0"
        self._pin_enabled = bool(pin)
        if default_deadline_s is None:
            default_deadline_s = _env_float("DATAFUSION_TPU_SERVE_DEADLINE_S", 0.0) or None
        self._default_deadline_s = default_deadline_s
        self._loop = ServerLoop(pool_size=self._workers, name="df-torch-serve")
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._window: list[Ticket] = []  # loop thread only
        self._window_timer = None  # loop thread only
        self._window_closes = 0.0  # loop thread only: the latest flush
        self._lock = lockcheck.make_lock("serve.server")
        self._pending = 0  # queued, not yet executing
        # queued tickets by identity: `stop` sheds what is left once the
        # loop thread is gone, and the pop is the exactly-once guard
        # between a shed and an admission
        self._queued_tickets: dict = {}
        # what `stop` gives back: the (table, PinnedSource) swaps made
        # and the join builds' pin fingerprints
        self._swapped: list = []
        self._build_pins: set = set()
        self._service_ewma_s: Optional[float] = None
        self._latencies: deque = deque(maxlen=4096)
        self.submitted = 0
        self.admitted = 0
        self.shed = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Server":
        if self._thread is None:
            # the manifest's tables are pinned before the dispatcher
            # runs: a restarted server serves warm from its first query
            self._rehydrate_pins()
            self._thread = threading.Thread(target=self._loop.run, name="df-torch-serve",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop, shed every ticket still queued (`shutdown`),
        wait for the workers to finish what they run, then give the
        context its registered sources back and unpin every table and
        join build this server pinned."""
        if self._closed:
            return
        self._closed = True
        self._loop.stop()
        if self._thread is not None:
            self._loop.wait_stopped()
            self._thread = None
        with self._lock:
            stranded = list(self._queued_tickets.values())
        for t in stranded:
            self._shed_ticket(t, "shutdown")
        self._loop.close(wait=True)
        for table, pinned in self._swapped:
            if self.ctx.datasources.get(table) is pinned:
                self.ctx.datasources[table] = pinned.inner
            # the manifest keeps the set that was resident while serving
            pinned.on_change = None
            pinned.release()
        for fp in self._build_pins:
            LEDGER.unpin(fp, reason="stop")
        self._swapped, self._build_pins = [], set()

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _device_scope(self):
        """Launches on the context's device, on this thread's own
        stream there (exec/streams.py)."""
        return serving_scope(self.ctx.device)

    # -- admission (caller thread) -------------------------------------
    def submit(self, sql: str, deadline_s: Optional[float] = None,
               client_id: Optional[str] = None) -> Ticket:
        """Admit one SELECT.  Returns a `Ticket`; raises `QueryShedError`
        when admission refuses it.  `CREATE EXTERNAL TABLE` and `CREATE
        MATERIALIZED VIEW` run inline and return a fulfilled ticket;
        `EXPLAIN` raises NotSupportedError (run it on the context).  The
        plan passes the static verifier here, on the caller's thread.  A
        statement that does not plan or verify raises its error and
        counts on neither side of `admitted + shed == submitted`."""
        from datafusion_tpu_torch.obs.attribution import client_scope
        from datafusion_tpu_torch.sql import ast
        from datafusion_tpu_torch.sql.parser import parse_sql

        entry_mono = time.monotonic()
        client = str(client_id) if client_id else "default"
        with METRICS.timer("parse"):
            stmt = parse_sql(sql)
        if isinstance(stmt, ast.SqlCreateExternalTable):
            # DDL is control-plane work: it runs inline and the ticket
            # is fulfilled at once (not counted in `submitted`: only
            # queries enter `admitted + shed == submitted`)
            out = self.ctx._execute_ddl(stmt)
            t = Ticket(sql, None, None, None, client_id=client)
            t._fulfill(out)
            return t
        if isinstance(stmt, ast.SqlCreateMaterializedView):
            # DDL-shaped: the initial fold runs here, charged to the
            # registering client, and the ticket is fulfilled at once
            # (it counts on neither side of `admitted + shed == submitted`)
            from datafusion_tpu_torch.exec.context import DdlResult

            with client_scope(client):
                view = self.ingest().create_view(stmt.name, stmt.query_sql)
            t = Ticket(sql, None, None, None, client_id=client)
            t._fulfill(DdlResult(
                f"Registered materialized view {stmt.name} "
                f"({'incremental' if view.incremental else 'recompute'})"))
            return t
        if isinstance(stmt, ast.SqlExplain):
            raise NotSupportedError(
                "EXPLAIN is an interactive statement; run it on the "
                "context, not the serving front door"
            )
        plan = self.ctx._plan(stmt)
        self.ctx._verify(plan)  # on the caller's thread, before admission
        with self._lock:
            self.submitted += 1
        if self._closed:
            raise self._shed_submit(sql, "shutdown", client)
        # 1. deadline feasibility against the observed service time
        deadline = None
        budget = deadline_s if deadline_s is not None else self._default_deadline_s
        if budget is not None:
            ewma = self._service_ewma_s
            if budget <= 0 or (ewma is not None and budget < 0.5 * ewma):
                raise self._shed_submit(sql, "deadline", client)
            deadline = Deadline.after(budget)
        # 2. device memory headroom
        if self._check_hbm(plan) is not None:
            raise self._shed_submit(sql, "hbm", client)
        ticket = Ticket(sql, plan, deadline, self._mega_signature(plan),
                        client_id=client, entry_mono=entry_mono)
        # 3. queue depth, checked and reserved under one lock
        at_depth, closed = self._reserve(ticket)
        if at_depth and self._qos is not None:
            # the queue is full: the tenant furthest over its share pays,
            # with a queued ticket of its own (its slot goes to this
            # arrival) or, when that is the submitter, with this arrival
            with self._lock:
                queued = list(self._queued_tickets.values())
            victim, incoming_is_victim = self._qos.shed_victim(queued, client)
            if incoming_is_victim or victim is None:
                raise self._shed_submit(sql, "quota", client)
            at_depth, closed = self._swap(victim, ticket)
        if at_depth:
            raise self._shed_submit(sql, "queue", client)
        if closed:
            self._shed_ticket(ticket, "shutdown")
            raise ticket._error if ticket._error is not None else QueryShedError(
                f"query shed at admission (shutdown): {sql[:80]!r}", reason="shutdown")
        ticket.admitted_mono = time.monotonic()
        METRICS.add("queries_queued")
        self._loop.call_soon(partial(self._enqueue, ticket))
        return ticket

    def _reserve(self, ticket: Ticket) -> tuple[bool, bool]:
        """Reserve a queue slot for `ticket` under one lock acquisition.
        Returns (at depth: not reserved, closed)."""
        with self._lock:
            return self._reserve_locked(ticket), self._closed

    def _reserve_locked(self, ticket: Ticket) -> bool:
        at_depth = self._pending >= self._queue_depth
        if not at_depth:
            self._pending += 1
            self._queued_tickets[id(ticket)] = ticket
        return at_depth

    def _swap(self, victim: Ticket, ticket: Ticket) -> tuple[bool, bool]:
        """Shed the queued `victim` (``quota``) and reserve its slot for
        `ticket` under one lock acquisition, so no racing submitter takes
        the freed slot (the JAX package re-reserves after the shed, and
        its arrival may then shed ``queue``).  A victim a worker admitted
        meanwhile is not shed; the arrival takes a slot if one is free.
        Returns (at depth: not reserved, closed)."""
        with self._lock:
            freed = self._queued_tickets.pop(id(victim), None) is not None
            if freed:
                self.shed += 1
                self._pending -= 1
            at_depth = self._reserve_locked(ticket)
            closed = self._closed
        if freed:
            self._shed_done(victim, "quota")
        return at_depth, closed

    # -- streaming ingestion (caller thread) ---------------------------
    def ingest(self):
        """The context's ingest plane with this server's hook installed:
        an applied append refreshes the pinned table's ledger accounting
        and the pin manifest."""
        ing = self.ctx.ingest()
        if self._on_append_applied not in ing.on_applied:
            ing.on_applied.append(self._on_append_applied)
        return ing

    def append(self, table: str, columns: dict, client_id: Optional[str] = None) -> dict:
        """One streaming append through the front door, logged before it
        is applied (`IngestContext.append`: a log fault raises
        `IngestUnavailableError` and acknowledges nothing).  The copies
        and the view-maintenance passes it triggers are charged to
        `client_id` (unset: ``"default"``), as a query's are."""
        from datafusion_tpu_torch.obs.attribution import client_scope

        with client_scope(str(client_id) if client_id else "default"):
            return self.ingest().append(table, columns)

    def _on_append_applied(self, table: str, batch) -> None:
        """The resident list already grew in place (it is the
        appendable's live list after `splice_appendable`): grow the
        ledger's pin bytes by the delta's host bytes (the served query
        that copies it measures them, `_measure_pins`) and refresh the
        manifest."""
        ds = self.ctx.datasources.get(table)
        if isinstance(ds, _PinnedProjection):
            ds = ds.parent
        if not isinstance(ds, PinnedSource):
            return
        res = ds._resident
        if res is None:
            return
        LEDGER.add_pin_bytes(ds.fingerprint, host_bytes([batch]))
        METRICS.add("serve.pin_appends")
        cb = ds.on_change
        if cb is not None:
            cb()

    def _charge_shed(self, client: str, reason: str) -> None:
        """A shed's meters: ``tenant.<id>.shed``, and under QoS the
        per-reason ``tenant.<id>.shed_<reason>``."""
        from datafusion_tpu_torch.obs.attribution import METER

        METER.charge(client, "shed", 1.0)
        if self._qos is not None:
            METER.charge(client, f"shed_{reason}", 1.0)

    def _shed_submit(self, sql: str, reason: str,
                     client: str = "default") -> QueryShedError:
        with self._lock:
            self.shed += 1
        METRICS.add("queries_shed")
        self._charge_shed(client, reason)
        recorder.record("serve.shed", reason=reason, client=client)
        return QueryShedError(f"query shed at admission ({reason}): {sql[:80]!r}",
                              reason=reason)

    def _shed_ticket(self, t: Ticket, reason: str) -> None:
        """Shed a queued ticket, once: the registration pop guards
        against a racing admission or a second shed."""
        with self._lock:
            if self._queued_tickets.pop(id(t), None) is None:
                return
            self.shed += 1
            self._pending -= 1
        self._shed_done(t, reason)

    def _shed_done(self, t: Ticket, reason: str) -> None:
        """A queued ticket's shed, once its registration is popped: the
        counters, the meters, the flight event and the client's error."""
        METRICS.add("queries_shed")
        self._charge_shed(t.client_id, reason)
        recorder.record("serve.shed", reason=reason, queued=True, client=t.client_id)
        t._fail(QueryShedError(f"query shed after queueing ({reason}): {t.sql[:80]!r}",
                               reason=reason))

    def _check_hbm(self, plan) -> Optional[str]:
        """"hbm" when the tables the plan would pin do not fit the
        headroom even after evicting other pins (the plan's own resident
        tables are spared); None to admit.  Dormant while the capacity
        is unknown."""
        if not self._pin_enabled:
            return None
        headroom = LEDGER.headroom()
        if headroom is None:
            return None
        from datafusion_tpu_torch.plan.logical import scan_tables

        need = 0
        protected: list[str] = []
        for tbl in scan_tables(plan):
            ds = self.ctx.datasources.get(tbl)
            if ds is None:
                continue
            pin = ds.parent if isinstance(ds, _PinnedProjection) else ds
            if isinstance(pin, PinnedSource) and pin.resident:
                protected.append(pin.fingerprint)
                continue
            need += pin.estimated_bytes()
        if need == 0 or need <= headroom:
            return None
        freed = LEDGER.evict_pins(need - headroom, exclude=protected)
        headroom = LEDGER.headroom()
        if headroom is not None and need > headroom:
            recorder.record("serve.hbm_pressure", need=need, headroom=headroom, freed=freed)
            return "hbm"
        return None

    # -- dispatch (loop thread) ----------------------------------------
    def _enqueue(self, t: Ticket) -> None:
        """Add a ticket to the batching window.  The window flushes when
        it holds `megabatch_max` tickets, when no ticket has arrived for
        `window_s`, or `2 * window_s` after it opened, whichever comes
        first.  Clients that resubmit as their answers come back arrive
        spread over the interpreter's thread switches; waiting for a gap
        in arrivals keeps them in one window.  The window is
        `_effective_window_s()`, and each arrival's spacing feeds the
        cost store it is learned from."""
        now = t.enqueued_mono = time.monotonic()
        prev, self._last_arrival_mono = self._last_arrival_mono, now
        if prev is not None:
            from datafusion_tpu_torch import cost as _cost

            _cost.store().observe(_cost.SERVE_KEY, "arrivals",
                                  interval_s=min(now - prev, 60.0))
        self._window.append(t)
        if self._window_timer is not None:
            self._window_timer.cancel()
        if len(self._window) >= max(self._megabatch_max, 1):
            self._flush_window()
            return
        window_s = self._effective_window_s()
        if len(self._window) == 1:
            self._window_closes = now + 2 * window_s
        self._window_timer = self._loop.call_later(
            min(window_s, self._window_closes - now), self._flush_window)

    def _effective_window_s(self) -> float:
        """The batching window armed: the configured one, or, when it
        was left at its default and cost planning is on, the cost
        store's window for the observed arrival spacing
        (cost/advisor.serve_window_s), noted as a ``serve.window_ms``
        decision when it changes."""
        from datafusion_tpu_torch import cost as _cost

        if not self._window_adaptive or not _cost.enabled():
            return self._window_s
        from datafusion_tpu_torch.cost import advisor

        store = _cost.store()
        chosen = advisor.serve_window_s(store, self._window_s)
        if chosen != self._window_s and chosen != self._window_noted_s:
            self._window_noted_s = chosen
            iv = store.value(_cost.SERVE_KEY, "arrivals", "interval_s") or 0
            store.note_decision("serve.window_ms", round(chosen * 1e3, 3),
                                round(self._window_s * 1e3, 3),
                                f"observed arrival spacing {iv * 1e3:.2f} ms")
        return chosen

    def _flush_window(self) -> None:
        self._window_timer = None
        if not self._window:
            return
        batch, self._window = self._window, []
        if self._qos is not None and len(batch) > 1:
            # weighted fair drain (qos.py): each tenant's backlog
            # advances in proportion to its share; FIFO without QoS
            batch = self._qos.order(batch, unit_cost_s=self._service_ewma_s)
        groups: dict = {}
        singles: list[list[Ticket]] = []
        now = time.monotonic()
        for t in batch:
            t.flushed_mono = now
            if t.signature is None:
                singles.append([t])
            else:
                groups.setdefault(t.signature, []).append(t)
        METRICS.add("serve.windows")
        for group in singles + list(groups.values()):
            self._loop.defer(partial(self._run_group, group), self._group_done)

    @staticmethod
    def _group_done(result, exc) -> None:
        if exc is not None:
            METRICS.add("serve.dispatch_errors")

    def _mega_signature(self, plan):
        """The plan-level shape class: the lane and the plan with its
        literals and LIMIT taken out.  Tickets of one class in a window
        run as one group, where `_mega_key` decides which of them share
        a scan; None runs the ticket alone."""
        if self._megabatch_max < 2:
            return None
        from datafusion_tpu_torch.plan.logical import (
            Aggregate,
            Limit,
            Projection,
            Selection,
            Sort,
            scan_tables,
        )

        if isinstance(plan, Aggregate):
            lane = "agg"
        elif isinstance(plan, Limit) and isinstance(plan.input, Sort):
            lane = "topk"
        elif isinstance(plan, (Projection, Selection)):
            lane = "pipe"
        else:
            return None
        tables = scan_tables(plan)
        if len(tables) != 1:
            return None
        try:
            body = json.dumps(_blank_literals(plan.to_json()), sort_keys=True)
        except NotImplementedError:
            return None
        return lane, tables[0], body

    # -- execution (executor threads) ----------------------------------
    def _run_group(self, group: list[Ticket]) -> None:
        from datafusion_tpu_torch.obs.attribution import client_scope
        from datafusion_tpu_torch.plan.logical import scan_tables

        ready: list[Ticket] = []
        exec_start = time.monotonic()
        for t in group:
            t.exec_start_mono = exec_start
            if t.deadline is not None and t.deadline.expired:
                self._shed_ticket(t, "deadline")
                continue
            ready.append(t)
        if not ready:
            return
        executed: list[Ticket] = []
        with self._device_scope():
            for t in ready:
                with self._lock:
                    admitted = self._queued_tickets.pop(id(t), None) is not None
                    if admitted:
                        self._pending -= 1
                        self.admitted += 1
                if not admitted:
                    continue  # a shutdown shed won the race
                recorder.record("serve.admit", plan=type(t.plan).__name__,
                                client=t.client_id)
                try:
                    with client_scope(t.client_id):
                        if self._pin_enabled:
                            for tbl in scan_tables(t.plan):
                                self._ensure_resident(tbl, client_id=t.client_id)
                        with deadline_scope(t.deadline):
                            t._rel = self.ctx.execute(t.plan, build_pins=self._build_pins,
                                                      verified=True)
                    executed.append(t)
                except BaseException as e:  # noqa: BLE001 — delivered to the client
                    t._fail(e)
            by_key: dict = {}
            rest: list[Ticket] = []
            together: list[list[Ticket]] = []
            for t in executed:
                key = self._mega_key(t)
                if key is None:
                    rest.append(t)
                else:
                    by_key.setdefault(key, []).append(t)
            for key, ts in by_key.items():
                while ts:
                    sub, ts = ts[: self._megabatch_max], ts[self._megabatch_max:]
                    if len(sub) >= 2 and self._megabatch(sub) and key[0] == "agg":
                        together.append(sub)
                    else:
                        rest.extend(t for t in sub if not t.done)
        # an aggregate megabatch's members finalize here, from states
        # pulled in one copy, and are fulfilled together: their clients
        # come back at once, and their next queries meet in one window.
        # Every other ticket materializes on its own worker, so a client
        # unblocks as soon as its own result is ready (a megabatch's
        # device outputs carry their stream's event: `_run_megabatch`)
        for sub in together:
            self._finish_together(sub)
        for t in rest[1:]:
            self._loop.defer(partial(self._finish, t), self._group_done)
        if rest:
            self._finish(rest[0])

    def _megabatch(self, tickets: list[Ticket]) -> bool:
        """Run one megabatch; returns whether it ran.  A
        `NotSupportedError` from a lane (a shape it cannot fold, found
        mid-scan) demotes the group to solo runs, counted in
        `serve.megabatch_fallbacks`; any other error fails every ticket
        of the group (a kernel that does not build or launch is never
        hidden behind solo runs)."""
        try:
            self._run_megabatch(tickets)
            METRICS.add("serve.megabatches")
            return True
        except NotSupportedError:
            METRICS.add("serve.megabatch_fallbacks")
            for t in tickets:
                for name in _INJECTED:
                    t._rel.__dict__.pop(name, None)
        except BaseException as e:  # noqa: BLE001 — delivered to every client
            for t in tickets:
                t._fail(e)
        return False

    def _mega_key(self, t: Ticket):
        """The grouping key of an executed relation, stricter than the
        plan signature: relations of one key share one scan."""
        from datafusion_tpu_torch.exec import fused
        from datafusion_tpu_torch.exec.aggregate import AggregateRelation
        from datafusion_tpu_torch.exec.relation import DataSourceRelation, PipelineRelation
        from datafusion_tpu_torch.exec.sort import TOPK_MAX, SortRelation

        rel = t._rel
        if t.signature is None or self._megabatch_max < 2 or not fused.fusion_enabled():
            return None
        if not isinstance(getattr(rel, "child", None), DataSourceRelation):
            return None
        ident = self.ctx.datasources[t.signature[1]].data_identity
        if type(rel) is AggregateRelation:
            return ("agg", ident, t.signature, rel.core.mega_key, rel.device)
        if type(rel) is SortRelation:
            if rel.predicate is not None or rel.limit is None or not (
                    0 < rel.limit <= TOPK_MAX):
                return None
            plans = tuple((kp.index, kp.kind, kp.asc) for kp in rel._key_plans)
            return ("topk", ident, t.signature, plans, tuple(rel._out_cols), rel.device)
        if type(rel) is PipelineRelation:
            if not rel.core.needs_kernel or rel.core.host_proj:
                return None
            return ("pipe", ident, t.signature, id(rel.core), rel.device)
        return None

    def _adopt_shared(self, rel) -> None:
        """Give a relation over a resident table the table's
        cross-query state (`PinnedSource.shared_state_for`)."""
        from datafusion_tpu_torch.exec.aggregate import AggregateRelation
        from datafusion_tpu_torch.exec.relation import PipelineRelation

        pin = _pin_of(rel)
        if pin is None:
            return
        if type(rel) is AggregateRelation:
            rel.adopt_shared(pin.shared_state_for(_key_signature(rel), rel.core))
        elif type(rel) is PipelineRelation:
            rel._aux_cache = pin.shared_state_for((), rel.core)["aux"]

    def _member_weights(self, tickets: list[Ticket]) -> list[float]:
        """Each megabatch member's share of the pass's costs: the rows
        of the tables its plan scans (the cost store's ``scan`` records),
        so a member that also reads another table carries its rows;
        members of the shared scan alone split evenly, and while any
        count is unknown the split is even (never a zero weight)."""
        from datafusion_tpu_torch import cost as _cost
        from datafusion_tpu_torch.cost import advisor
        from datafusion_tpu_torch.plan.logical import scan_tables

        store = _cost.store()
        counts = []
        for t in tickets:
            known = [advisor.table_rows(store, self.ctx.cost_table_key(n))
                     for n in scan_tables(t.plan)]
            rows = sum(k for k in known if k)
            counts.append(rows if rows and all(known) else None)
        if any(c is None for c in counts):
            return [1.0 / len(tickets)] * len(tickets)
        total = float(sum(counts))
        return [c / total for c in counts]

    def _run_megabatch(self, tickets: list[Ticket]) -> None:
        """One lane's pass over the shared scan, under a `shared_scope`
        of the members weighted by `_member_weights`: every launch wall
        and copy of the pass splits across their clients, and each
        ticket keeps its share of the walls (and of the aggregate lane's
        one state pull) for its critical path.  The members' device
        outputs are published on this worker's stream: a member another
        worker finishes waits for them there (`_materialize`)."""
        from datafusion_tpu_torch.exec.aggregate import (
            AggregateRelation,
            run_aggregate_megabatch,
        )
        from datafusion_tpu_torch.exec.relation import run_pipeline_megabatch
        from datafusion_tpu_torch.exec.sort import SortRelation, run_topk_megabatch
        from datafusion_tpu_torch.obs.attribution import shared_scope

        rels = [t._rel for t in tickets]
        weights = self._member_weights(tickets)
        pull_s = 0.0
        with METRICS.timer("execute.serve_megabatch"), \
                shared_scope(tuple((t.client_id, w) for t, w in zip(tickets, weights))) as acc:
            if type(rels[0]) is SortRelation:
                run_topk_megabatch(rels)
            elif type(rels[0]) is AggregateRelation:
                for r in rels:
                    self._adopt_shared(r)
                leader = rels[0]
                for r in rels[1:]:
                    # one encoder for the group, pinned table or not
                    r.encoder, r._ids_lock = leader.encoder, leader._ids_lock
                pull_s = run_aggregate_megabatch(rels)
            else:
                for r in rels:
                    self._adopt_shared(r)
                run_pipeline_megabatch(rels)
        publish(_injected_tensors(rels))
        for t, w in zip(tickets, weights):
            t.launch_share_s += acc[0] * w
            t.demux_share_s += pull_s * w
        # the shared scan's copies: its pin is measured once, after
        # the first member
        tickets[0].copied = acc[1] > 0

    def _materialize(self, t: Ticket):
        """One ticket's result table (a megabatched relation finalizes
        the state it was given) under its client's scope, with the
        seconds it took and the launch wall inside them, or None once
        its error is delivered."""
        from datafusion_tpu_torch.exec.materialize import collect
        from datafusion_tpu_torch.obs.attribution import client_scope

        try:
            rel = t._rel
            injected = _injected_tensors([rel])
            if not any(k in rel.__dict__ for k in _INJECTED):
                self._adopt_shared(rel)
            t0 = time.monotonic()
            with self._device_scope(), deadline_scope(t.deadline), \
                    client_scope(t.client_id) as acc:
                shared(injected)  # made on the pass's worker's stream
                table = collect(rel)
            if acc[1] or t.copied:
                self._measure_pins(t)
            return table, time.monotonic() - t0, acc[0]
        except BaseException as e:  # noqa: BLE001 — delivered to the client
            METRICS.add("serve.query_errors")
            # the error counts against error-rate SLOs with the wall the
            # client saw (the funnel leaves served queries to this seam)
            slo.WATCHDOG.observe(time.monotonic() - t.entry_mono, error=True)
            t._fail(e)
            return None

    def _fulfill(self, t: Ticket, done) -> None:
        """Fulfill a materialized ticket and observe its critical path
        (obs/attribution.observe_path)."""
        from datafusion_tpu_torch.obs.attribution import observe_path

        table, fin_wall, fin_launch_s = done
        t._fulfill(table)
        now = time.monotonic()
        wall = now - t.submitted_mono
        t.launch_share_s += fin_launch_s
        # the client-visible wall, queue wait included, feeds the serving
        # histogram and the SLO watchdog (the funnel's inner wall does
        # not, for a served query)
        observe_latency("serve.latency", now - t.entry_mono)
        slo.WATCHDOG.observe(now - t.entry_mono)
        observe_path(t.client_id, now - t.entry_mono,
                     self._segments(t, now - t.entry_mono, fin_wall, fin_launch_s))
        with self._lock:
            self._latencies.append(wall)
            ewma = self._service_ewma_s
            self._service_ewma_s = wall if ewma is None else 0.8 * ewma + 0.2 * wall
        recorder.record("serve.done", ms=round(wall * 1e3, 3), client=t.client_id)

    @staticmethod
    def _segments(t: Ticket, wall: float, fin_wall: float, fin_launch_s: float) -> dict:
        """One ticket's serving chain in seconds, from its stamps and
        apportioned shares: ``admission`` (submit entry to the queue
        slot: parse, plan, verify, the feasibility checks),
        ``megabatch_window`` (parked in the batching window),
        ``queue_wait`` (the hand-off to the loop and the wait for a
        worker), ``shared_launch_share`` (its share of every launch wall
        it rode), ``demux_pull`` (its share of its megabatch's state
        pull), ``merge`` (materialization less its own launch wall) and
        ``other`` (the rest, never negative)."""
        entry = t.entry_mono
        admitted = t.admitted_mono or entry
        enqueued = t.enqueued_mono or admitted
        flushed = t.flushed_mono or enqueued
        started = t.exec_start_mono or flushed
        seg = {
            "admission": max(admitted - entry, 0.0),
            "megabatch_window": max(flushed - enqueued, 0.0),
            "queue_wait": max(enqueued - admitted, 0.0) + max(started - flushed, 0.0),
            "shared_launch_share": t.launch_share_s,
            "demux_pull": t.demux_share_s,
            "merge": max(fin_wall - fin_launch_s, 0.0),
        }
        seg["other"] = max(wall - sum(seg.values()), 0.0)
        return seg

    def _finish(self, t: Ticket) -> None:
        """Materialize one ticket and fulfill it."""
        if t.done:
            return
        done = self._materialize(t)
        if done is not None:
            self._fulfill(t, done)

    def _finish_together(self, tickets: list[Ticket]) -> None:
        """Materialize every ticket, then fulfill them all."""
        done = [(t, self._materialize(t)) for t in tickets if not t.done]
        for t, d in done:
            if d is not None:
                self._fulfill(t, d)

    # -- pinning -------------------------------------------------------
    def _ensure_resident(self, table: str, client_id: str = "default") -> bool:
        """Pin `table` if it is not resident and still fits, meter the
        pin (obs/attribution.py): the client that materializes it is its
        fallback payer, and every query that scans it counts a use.
        Returns whether this call pinned it."""
        from datafusion_tpu_torch.obs.attribution import note_pin_use, register_pin_client

        with self._lock:  # one PinnedSource per table, whichever worker comes first
            ds = self.ctx.datasources.get(table)
            if ds is None:
                return False
            if isinstance(ds, _PinnedProjection):
                ds = ds.parent
            if not isinstance(ds, PinnedSource):
                # a slot swap, not a re-registration: the data is the same
                # (`stop` swaps the source back)
                pinned = PinnedSource(ds, table)
                self.ctx.datasources[table] = pinned
                self._swapped.append((table, pinned))
                ds = pinned
            ds.on_change = self._save_pin_manifest
        newly_resident = not ds.resident
        if newly_resident:
            # admission may be stale by dispatch time: pin only what
            # still fits, else this query streams cold
            headroom = LEDGER.headroom()
            if headroom is not None and ds.estimated_bytes() > headroom:
                METRICS.add("serve.pin_denied")
                return False
        ds.ensure()
        if newly_resident:
            register_pin_client(ds.fingerprint, client_id)
        note_pin_use(ds.fingerprint, client_id)
        return newly_resident

    def _measure_pins(self, t: Ticket) -> None:
        """After a served query that copied to the device, attribute the
        device tensors cached on each resident pin it scans (and on
        their projection views) to the pin's owner tag, and set the
        pin's accounted bytes to their storages' bytes, each storage
        counted once: the pin was registered with a host estimate before
        anything was copied, and eviction should free what it reads.  A
        warm query copies nothing and measures nothing."""
        from datafusion_tpu_torch.plan.logical import scan_tables

        for tbl in scan_tables(t.plan):
            pin = self.ctx.datasources.get(tbl)
            if isinstance(pin, _PinnedProjection):
                pin = pin.parent
            if not isinstance(pin, PinnedSource):
                continue
            with pin.measure_lock:
                res = pin._resident
                tensors = _cached_tensors(list(res)) if res is not None else []
                if not tensors:
                    continue
                LEDGER.retag(tensors, f"pin.{pin.name}")
                seen = set()
                measured = 0
                for x in tensors:
                    st = x.untyped_storage()
                    key = (x.device, st.data_ptr())
                    if key not in seen:
                        seen.add(key)
                        measured += st.nbytes()
                LEDGER.set_pin_bytes(pin.fingerprint, measured)

    # -- pin manifest --------------------------------------------------
    def _pin_entries(self) -> list:
        out = []
        for table, ds in sorted(self.ctx.datasources.items()):
            if isinstance(ds, _PinnedProjection):
                ds = ds.parent
            if isinstance(ds, PinnedSource) and ds.resident:
                entry = {"table": table, "fingerprint": ds.fingerprint}
                path = getattr(ds.inner, "path", None)
                if path:
                    entry["path"] = str(path)
                out.append(entry)
        return out

    def _save_pin_manifest(self) -> None:
        """Persist the resident set (tmp, fsync, rename: a crash
        mid-write leaves the old manifest whole).  Called on every
        residency change, never under a lock."""
        path = self._pin_manifest_path
        if path is None:
            return
        from datafusion_tpu_torch.utils.wal import atomic_write_json

        try:
            atomic_write_json(path, {"pins": self._pin_entries()})
        except OSError:
            METRICS.add("serve.pin_manifest_errors")

    def _rehydrate_pins(self) -> None:
        """Re-pin the manifest's tables at `start()`: each one the
        context registers goes through `_ensure_resident`.  A table the
        context no longer has, or whose materialization fails, is
        skipped: rejoining cold is degraded, not broken."""
        path = self._pin_manifest_path
        if path is None or not self._pin_enabled:
            return
        from datafusion_tpu_torch.utils.wal import read_json

        doc = read_json(path)
        for entry in (doc or {}).get("pins") or []:
            table = str(entry.get("table") or "")
            if not table or table not in self.ctx.datasources:
                METRICS.add("serve.pin_rehydrate_skipped")
                continue
            try:
                with self._device_scope():
                    self._ensure_resident(table, client_id="rehydrate")
            except Exception:  # noqa: BLE001 — a cold table must not block the start
                METRICS.add("serve.pin_rehydrate_errors")
                continue
            self.pins_rehydrated += 1
            METRICS.add("serve.pins_rehydrated")
            recorder.record("serve.pin_rehydrated", table=table)

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        counts = METRICS.snapshot()["counts"]
        with self._lock:
            out = {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "shed": self.shed,
                "pending": self._pending,
                "service_ewma_s": self._service_ewma_s,
            }
            lat = list(self._latencies)
        out.update({
            "queries_admitted": counts.get("queries_admitted", 0),
            "queries_queued": counts.get("queries_queued", 0),
            "queries_shed": counts.get("queries_shed", 0),
            "megabatch_launches": counts.get("serve.megabatch_launches", 0),
            "megabatch_queries": counts.get("serve.megabatch_queries", 0),
            "tables_pinned": counts.get("serve.tables_pinned", 0),
            "pins": LEDGER.pins_snapshot(),
            "pinned_bytes": LEDGER.pinned_bytes(),
        })
        if self._qos is not None:
            out["qos"] = self._qos.snapshot()
        if lat:
            out["p50_s"] = float(np.quantile(lat, 0.5))
            out["p99_s"] = float(np.quantile(lat, 0.99))
            out["queries"] = len(lat)
        return out
