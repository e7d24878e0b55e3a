"""Streaming ingestion and incrementally maintained materialized views.

The counterpart of the JAX package's `ingest/`:

- **Append path.**  `IngestContext.append(table, columns)` turns a
  registered table into an :class:`AppendableSource` (host-resident,
  append-only) and grows it by one delta batch.  Every acknowledged
  append is in the ingest log first (`utils/wal.py` segments, fsync
  before the ack under the default `DATAFUSION_TPU_WAL_SYNC=always`):
  a disk fault raises :class:`IngestUnavailableError` and applies
  nothing, and its revision is burned.  Each append re-registers the
  table, so its catalog version bumps, and its `data_version` bumps,
  so every dependent result-cache fingerprint and every join build pin
  keyed on the table's `data_identity` stops matching.  The log's
  records are the JAX package's bytes: either package recovers a log
  the other wrote.

- **Incremental views.**  `CREATE MATERIALIZED VIEW name AS SELECT ...`
  registers a continuous query.  When the lowered tree holds an
  `AggregateRelation` directly over the table's scan with no string
  MIN/MAX slot (the JAX package's `_build_view` rule), the view owns
  that relation's device accumulator state: each delta is encoded
  against the table's canonical dictionaries, its group ids extend the
  view's encoder, and the state advances in ONE device pass
  (`_AggregateCore.fused_group`: one grouped-reduce launch per slot not
  aliased to the row count, `csrc/hash_agg.cu`; past
  `agg_max_groups()` the state grows and the pass takes the sort-merge
  route, `csrc/sort_kernel.cu`).  `read()` injects the state into the
  unchanged finalize path.  Other shapes recompute in full per delta,
  counted as ``view.fallback.<reason>`` (`plan_shape`, `scan_shape`,
  `string_minmax`).

- **Subscriptions and freshness.**  `wait_for` parks on a view
  revision; `freshness_lags` and `max_freshness_lag` are the seam the
  freshness SLO reads (obs/slo.py), and `debug_snapshot` is the
  ``/debug/ingest`` document.  With a cluster client attached
  (`IngestContext.cluster`), each applied append also drops the table's
  shared-tier results fleet-wide (``invalidate``) and advances each
  affected view's ``views/<name>`` key (``view_advance``), whose watch
  events reach remote watchers.

Exactness contract of a view, against a rescan of the defining query:

- group keys, COUNTs, integer SUMs, MIN, MAX and NULLs are exact, against
  the JAX package's view and against the port's own rescan;
- f64 SUM and AVG agree within rtol 1e-9: the batch-group fold
  (exec/fused.py) reduces a rescan's batches in concatenated groups,
  while the view adds one partial per delta, so the two associate a
  float sum differently;
- under `DATAFUSION_TPU_FUSE=0`, where every batch is its own partial in
  both, the view is bit for bit the port's rescan;
- repeated runs give the same bits; f32 slots keep the Higham-Mary
  bound (tests/test_torch_f32_sum.py).

Locking: one internal mutex serializes appends, folds and reads, and is
held across the log write (revision order and log order must agree, or
the log's revision dedup could drop an acknowledged append);
`lockcheck.note_blocking` announces that boundary.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import DataFusionError, IngestError, IngestUnavailableError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    StringDictionary,
    make_host_batch,
    param_tensors,
    subset_view,
)
from datafusion_tpu_torch.exec.datasource import DataSource, host_bytes
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.parallel.wire import BinWriter, dec_array, enc_array
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call

__all__ = [
    "AppendableSource",
    "IngestContext",
    "MaterializedView",
    "freshness_lags",
    "max_freshness_lag",
]

# live views, for the freshness seam: weak, so a dropped IngestContext
# takes its views with it
_LIVE_VIEWS: "weakref.WeakValueDictionary[str, MaterializedView]" = (
    weakref.WeakValueDictionary()
)


# live ingest contexts (for /debug/ingest): weak for the same reason
_LIVE_CONTEXTS: "weakref.WeakSet[IngestContext]" = weakref.WeakSet()


def debug_snapshot() -> dict:
    """The ``/debug/ingest`` document: every live IngestContext's status
    and the process's freshness lags (read-only)."""
    return {
        "contexts": [c.status() for c in list(_LIVE_CONTEXTS)],
        "freshness_lags_s": freshness_lags(),
    }


def freshness_lags() -> dict:
    """Per-view freshness lag in seconds (0.0 = fully caught up)."""
    return {name: view.lag() for name, view in list(_LIVE_VIEWS.items())}


def max_freshness_lag() -> Optional[float]:
    """Worst freshness lag across live views; None when no views exist
    (an SLO stays dormant rather than reading a vacuous 0)."""
    lags = freshness_lags()
    if not lags:
        return None
    return max(lags.values())


def _base_version(source) -> list:
    """The file identity of a base scan, as the JAX package's
    `cache.fingerprint.source_version` gives it for a file meta:
    ``[[path, mtime_ns, size]]`` (``"missing"`` when it cannot be
    stat'ed), ``[]`` for an in-memory table.  A serving wrapper or a
    projection delegates to the source under it."""
    seen = set()
    while source is not None and id(source) not in seen:
        seen.add(id(source))
        path = getattr(source, "path", None)
        if path:
            try:
                st = os.stat(path)
                return [[path, st.st_mtime_ns, st.st_size]]
            except OSError:
                return [[path, "missing", 0]]
        source = getattr(source, "inner", None) or getattr(source, "parent", None)
    return []


# -- appendable source ------------------------------------------------


class AppendableSource(DataSource):
    """Host-resident append-only table: a materialized base plus delta
    batches, all encoding Utf8 columns against ONE canonical
    per-column :class:`StringDictionary`.

    Group-key codes and predicate compare tables are dictionary-relative,
    so every batch of a table shares its column dictionaries or a view's
    state would diverge from a rescan.  Wrapping a source materializes it
    once; appends extend the canonical dictionaries in place, so codes
    already given never change.

    `data_version` bumps per append; it is part of `data_identity` (join
    build pins) and of `ExecutionContext.query_fingerprint` (the result
    cache).  `live_batches` is the list appends grow: a pinned serving
    wrapper adopts it as its resident list (serve.py)."""

    def __init__(self, schema: Schema, batches: Sequence[RecordBatch],
                 name: Optional[str] = None):
        self._schema = schema
        self._batches: list[RecordBatch] = list(batches)
        self.name = name
        self.base_batches = len(self._batches)
        self.base_version: list = []  # file identity of the base scan
        self.data_version = 0
        self.total_rows = sum(b.num_rows for b in self._batches)
        # canonical per-column dictionaries: the batches of one scan
        # share per-column dictionary objects, so the newest batch's is
        # the whole table's
        self._dicts: list[Optional[StringDictionary]] = []
        for i, f in enumerate(schema.fields):
            if f.data_type != DataType.UTF8:
                self._dicts.append(None)
                continue
            d = None
            for b in reversed(self._batches):
                if b.dicts[i] is not None:
                    d = b.dicts[i]
                    break
            self._dicts.append(d if d is not None else StringDictionary())

    @classmethod
    def wrap(cls, source: DataSource, name: Optional[str] = None) -> "AppendableSource":
        """An appendable twin of `source`, materialized once (an
        appendable passes through).  The base's file identity is kept so
        that recovery can tell a base file rewritten under the delta log
        (`ingest.base_drift`)."""
        if isinstance(source, cls):
            return source
        out = cls(source.schema, list(source.batches()), name=name)
        out.base_version = _base_version(source)
        return out

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def live_batches(self) -> list:
        return self._batches

    def batches(self) -> Iterator[RecordBatch]:
        # a snapshot: an append must not extend a scan that has started
        return iter(list(self._batches))

    def with_projection(self, projection: Sequence[int]) -> DataSource:
        return _AppendableProjection(self, tuple(projection))

    def estimated_bytes(self) -> int:
        return host_bytes(self._batches)

    def meta(self) -> dict:
        """In-memory identity block (status, the console's `\\ingest`)."""
        return {"Appendable": {
            "name": self.name or "", "data_version": self.data_version,
            "rows": self.total_rows, "base_batches": self.base_batches,
        }}

    # -- building delta batches --

    def build_batch(self, columns: dict) -> RecordBatch:
        """Validate and assemble one delta batch from per-column values
        (``{name: list|ndarray}``; None entries are NULLs).  Utf8 columns
        encode against, and extend, the canonical dictionaries.  Raises
        :class:`IngestError` on a schema mismatch; nothing is applied
        until :meth:`append_batch`."""
        fields = self._schema.fields
        names = {f.name for f in fields}
        unknown = [c for c in columns if c not in names]
        if unknown:
            raise IngestError(
                f"append to {self.name or '?'}: unknown column(s) {sorted(unknown)}")
        missing = [f.name for f in fields if f.name not in columns]
        if missing:
            raise IngestError(f"append to {self.name or '?'}: missing column(s) {missing}")
        lengths = {len(columns[f.name]) for f in fields}
        if len(lengths) > 1:
            raise IngestError(
                f"append to {self.name or '?'}: ragged columns (lengths {sorted(lengths)})")
        data: list[np.ndarray] = []
        validity: list[Optional[np.ndarray]] = []
        for i, f in enumerate(fields):
            vals = columns[f.name]
            if f.data_type == DataType.UTF8:
                seq = list(vals)
                codes = self._dicts[i].encode(seq) if seq else np.zeros(0, np.int32)
                isnull = np.fromiter((s is None for s in seq), dtype=bool, count=len(seq))
                data.append(codes)
                validity.append(~isnull if isnull.any() else None)
                continue
            arr, val = _numeric_column(vals, f, self.name)
            data.append(arr)
            validity.append(val)
        # a zero-row delta still forms a real empty batch, so the log
        # record, the catalog bump and the view revisions all advance
        return make_host_batch(self._schema, data, validity, dicts=list(self._dicts))

    def append_batch(self, batch: RecordBatch) -> None:
        """Apply one built delta batch (after the log accepted it): the
        table grows, `data_version` bumps."""
        self._batches.append(batch)
        self.data_version += 1
        self.total_rows += batch.num_rows

    def delta_batches(self) -> list[RecordBatch]:
        """The appended (non-base) batches, oldest first."""
        return list(self._batches[self.base_batches:])


class _AppendableProjection(DataSource):
    """A column subset of an :class:`AppendableSource` that stays live:
    each scan re-reads the parent's batch list, and each projected batch
    is the `subset_view` cached on its parent batch, the same object a
    pinned serving projection yields, so device copies and group ids
    serve every query and the view's fold."""

    def __init__(self, parent: AppendableSource, projection: tuple):
        self._parent = parent
        self._projection = projection
        self._schema = parent.schema.select(list(projection))

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def data_version(self) -> int:
        return self._parent.data_version

    @property
    def data_identity(self) -> tuple:
        return self._parent.data_identity

    def batches(self) -> Iterator[RecordBatch]:
        for b in list(self._parent._batches):
            yield subset_view(b, self._projection)

    def with_projection(self, projection: Sequence[int]) -> DataSource:
        return _AppendableProjection(self._parent,
                                     tuple(self._projection[i] for i in projection))


def _numeric_column(vals, field, table) -> tuple:
    """(array, validity) of one non-Utf8 append column; None entries
    become NULLs (validity carries them, the padding value is 0)."""
    dtype = field.data_type.np_dtype
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        return np.ascontiguousarray(vals).astype(dtype, copy=False), None
    seq = list(vals)
    isnull = np.fromiter((v is None for v in seq), dtype=bool, count=len(seq))
    filled = [0 if v is None else v for v in seq] if isnull.any() else seq
    try:
        arr = np.asarray(filled).astype(dtype)
    except (TypeError, ValueError) as e:
        raise IngestError(
            f"append to {table or '?'}: column {field.name!r} "
            f"not coercible to {field.data_type}: {e}") from None
    return arr, (~isnull if isnull.any() else None)


# -- log blocks (WAL records and snapshots) ---------------------------


def _block_from_batch(schema: Schema, batch: RecordBatch, bw: Optional[BinWriter]) -> list:
    """Column blocks of one delta batch: numeric columns as raw CRC'd
    wire segments (`enc_array` and a BinWriter), Utf8 columns as string
    lists (codes are dictionary-relative, so only the strings replay)."""
    n = batch.num_rows
    cols = []
    for i, f in enumerate(schema.fields):
        doc: dict = {"name": f.name}
        v = batch.validity[i]
        if f.data_type == DataType.UTF8:
            codes = np.asarray(batch.data[i][:n])
            strings = list(batch.dicts[i].decode(codes)) if n else []
            if v is not None:
                vn = np.asarray(v[:n])
                strings = [None if not vn[j] else strings[j] for j in range(n)]
            doc["s"] = strings
        else:
            doc["a"] = enc_array(np.ascontiguousarray(np.asarray(batch.data[i][:n])), bw)
            if v is not None:
                doc["v"] = enc_array(np.asarray(v[:n]).astype(np.uint8), bw)
        cols.append(doc)
    return cols


def _columns_from_block(schema: Schema, cols: list) -> dict:
    """Invert `_block_from_batch` into the `append()` columns mapping."""
    out: dict = {}
    by_name = {c.get("name"): c for c in cols}
    for f in schema.fields:
        doc = by_name.get(f.name)
        if doc is None:
            raise IngestError(f"ingest-log block missing column {f.name!r}")
        if "s" in doc:
            out[f.name] = doc["s"]
            continue
        # a copy: a recovered record's segments are views into the read
        # buffer, which is not writable
        arr = dec_array(doc["a"]).copy()
        if doc.get("v") is not None:
            val = dec_array(doc["v"]).astype(bool)
            lst = arr.tolist()
            out[f.name] = [lst[j] if val[j] else None for j in range(len(lst))]
        else:
            out[f.name] = arr
    return out


# -- materialized views -----------------------------------------------


class MaterializedView:
    """One registered continuous query over an appendable table.

    Incremental (`incremental=True`): the view owns its
    `AggregateRelation`'s accumulator state; `fold(deltas)` runs each
    delta through the relation's own batch preparation (group ids, aux
    tables, device copies of the used columns) and advances the state in
    one device pass per batch group, tagged ``view.maintain`` (one
    delta: one pass).  `read()` injects the state and collects the
    operator tree through the unchanged finalize path.  Otherwise
    `fallback_reason` says why, and each delta recomputes the query in
    full (counted in `full_recomputes`)."""

    def __init__(self, name: str, sql: str, ctx, table: str, root, agg,
                 proj: Optional[tuple], fallback_reason: Optional[str] = None):
        self.name = name
        self.sql = sql
        self.ctx = ctx
        self.table = table
        self.revision = 0
        self._root = root  # operator tree for injected reads
        self._agg = agg  # the AggregateRelation whose state the view owns
        self._proj = proj  # scan projection (columns of the table)
        self.incremental = agg is not None and fallback_reason is None
        self.fallback_reason = fallback_reason
        self._state = None
        self._result = None  # fallback views: the last full recompute
        self._pending_since: Optional[float] = None
        self.maintain_launches = 0  # device passes of the fold
        self.full_recomputes = 0

    # -- freshness --

    def lag(self) -> float:
        """Seconds of acknowledged ingest this view has not folded yet
        (0.0 when caught up)."""
        since = self._pending_since
        return 0.0 if since is None else max(0.0, time.monotonic() - since)

    def mark_pending(self) -> None:
        if self._pending_since is None:
            self._pending_since = time.monotonic()

    # -- maintenance --

    def fold(self, source: AppendableSource, deltas: Sequence[RecordBatch]) -> None:
        """Advance the view over `deltas` (appended batches, oldest
        first).  An empty delta advances the revision without a pass.
        Called under the ingest lock."""
        try:
            if not self.incremental:
                self._recompute_full()
            else:
                live = [b for b in deltas if b.num_rows > 0]
                if live:
                    self._fold_incremental(live)
        finally:
            self.revision += 1
            self._pending_since = None
            METRICS.gauge(f"view.{self.name}.revision", self.revision)
            METRICS.gauge(f"view.{self.name}.lag_s", 0.0)

    def _fold_incremental(self, deltas: Sequence[RecordBatch]) -> None:
        """The batches exactly as the view's scan would yield them (the
        cached `subset_view` of its projection), through the relation's
        `_batch_groups` (ids encoded by the view's encoder, capacity
        picked once every id is known), each group folded into the
        state in one `fused_group` pass.  A capacity past the state's
        grows it by identity padding (`_grow_state`); past
        `agg_max_groups()` the pass takes the sort-merge route."""
        agg = self._agg
        core = agg.core
        device = agg.device
        batches = [b if self._proj is None else subset_view(b, self._proj) for b in deltas]
        params = param_tensors(agg._param_values, device)
        state = self._state
        passes = 0
        with METRICS.timer("view.maintain"):
            for capacity, entries, (aux, str_aux) in agg._batch_groups(iter(batches),
                                                                       agg._tables):
                if state is None:
                    state = core._init_state(capacity, device)
                elif capacity > state[0].shape[0]:
                    state = core._grow_state(state, capacity)
                state = device_call(core.fused_group, entries, state, aux, str_aux, params,
                                    _tag="view.maintain", _device=device)
                passes += 1
        self._state = state
        self.maintain_launches += passes
        METRICS.add("view.maintain_launches", passes)
        recorder.record("view.maintain", view=self.name, batches=len(batches),
                        launches=passes)

    def _recompute_full(self) -> None:
        """Fallback maintenance: collect the defining query in full."""
        from datafusion_tpu_torch.exec.materialize import collect

        with METRICS.timer("view.recompute"):
            self._result = collect(self.ctx.execute(self._plan()))
        self.full_recomputes += 1
        METRICS.add("view.full_recomputes")
        recorder.record("view.recompute", view=self.name, reason=self.fallback_reason or "")

    def _plan(self):
        from datafusion_tpu_torch.sql.parser import parse_sql

        return self.ctx._plan(parse_sql(self.sql))

    # -- reads --

    def read(self):
        """The view's contents as a ResultTable.  Incremental: the state
        injected into the operator tree and collected (the state's
        tensors are never written in place, so reads repeat).  Fallback:
        the last full recompute."""
        from datafusion_tpu_torch.exec.materialize import collect

        if not self.incremental:
            if self._result is None:
                self._recompute_full()
            return self._result
        if self._state is not None:
            self._agg._injected_state = self._state
        try:
            return collect(self._root)
        finally:
            # a collect that never reached accumulate() must not leave
            # the injection armed for a later read
            self._agg.__dict__.pop("_injected_state", None)

    def status(self) -> dict:
        return {
            "name": self.name, "table": self.table, "sql": self.sql,
            "incremental": self.incremental,
            "fallback_reason": self.fallback_reason,
            "revision": self.revision, "lag_s": round(self.lag(), 6),
            "maintain_launches": self.maintain_launches,
            "full_recomputes": self.full_recomputes,
            "groups": self._agg.encoder.num_groups if self._agg is not None else None,
        }


# -- the ingest context ----------------------------------------------


class IngestContext:
    """Per-ExecutionContext streaming state: appendable tables,
    materialized views, the durable ingest log and subscriber wakeups.

    With `wal_dir`, every append and view definition is a log record
    written before the ack; `recover()`, called after the base tables are
    registered, replays the acknowledged appends and re-plans the views.
    Without a log the plane runs in memory (the same answers, no
    durability)."""

    def __init__(self, ctx, wal_dir: Optional[str] = None):
        self.ctx = ctx
        # ONE mutex serializes append -> log -> apply -> notify and view
        # reads; held across the log write (module docstring).  Plain, as
        # in the JAX package: the blocking sites announce themselves
        # before they take it (`ingest.*` in analysis/lockcheck)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tables: dict[str, AppendableSource] = {}
        self._views: dict[str, MaterializedView] = {}
        # post-apply hooks: (table, batch) -> None, called OUTSIDE the
        # lock (the serving layer refreshes its pin accounting here)
        self.on_applied: list[Callable] = []
        # a cluster client (cluster/) whose `invalidate(table)` and
        # `view_advance(name, rev)` each applied append calls
        self.cluster = None
        self._wal = None
        self._rev = 0
        self.recovery: dict = {}
        if wal_dir:
            from datafusion_tpu_torch.utils.wal import WriteAheadLog

            self._wal = WriteAheadLog(wal_dir)
        METRICS.declare("ingest.appends", "ingest.rows", "ingest.bytes",
                        "view.maintain_launches", "view.full_recomputes")
        _LIVE_CONTEXTS.add(self)

    # -- tables --

    def attach(self, table: str) -> AppendableSource:
        """Make `table` appendable (idempotent): the registered source is
        wrapped into an :class:`AppendableSource` (materializing it) and
        re-registered, bumping the catalog version once."""
        lockcheck.note_blocking("ingest.attach")
        with self._lock:
            return self._attach_locked(table)

    def _attach_locked(self, table: str) -> AppendableSource:
        src = self._tables.get(table)
        if src is not None:
            return src
        ds = self.ctx.datasources.get(table)
        if ds is None:
            raise IngestError(f"no datasource registered as {table!r}")
        src = self._wrap_source(table, ds)
        self._tables[table] = src
        return src

    def _wrap_source(self, table: str, ds) -> AppendableSource:
        """Wrap and re-register.  A serving wrapper (serve.PinnedSource)
        takes the appendable in UNDER it (`splice_appendable`): the
        wrapper stays registered, its pin and the device copies it holds
        survive, and appends grow the pinned resident list in place."""
        splice = getattr(ds, "splice_appendable", None)
        if splice is not None:
            src = splice(AppendableSource)
            self.ctx.register_datasource(table, ds)
            return src
        src = AppendableSource.wrap(ds, name=table)
        self.ctx.register_datasource(table, src)
        return src

    # -- the append path --

    def append(self, table: str, columns: dict, client: Optional[str] = None) -> dict:
        """Append one delta of rows to `table`: logged, then applied.

        Returns ``{"table", "rows", "rev", "views": {name: revision}}``.
        A log fault raises :class:`IngestUnavailableError` with NOTHING
        applied and the revision burned (retry when the log recovers).
        A schema mismatch raises :class:`IngestError` before the log is
        touched."""
        t0 = time.perf_counter()
        lockcheck.note_blocking("ingest.append")
        with self._lock:
            src = self._attach_locked(table)
            batch = src.build_batch(columns)
            affected = [v for v in self._views.values() if v.table == table]
            for v in affected:
                v.mark_pending()
            rev = self._rev + 1
            if self._wal is not None:
                bw = BinWriter()
                rec = {
                    "kind": "append", "rev": rev, "table": table,
                    "client": client or "", "rows": batch.num_rows,
                    "cols": _block_from_batch(src.schema, batch, bw),
                }
                try:
                    self._wal.append([(rec, bw)])
                except OSError as e:
                    METRICS.add("ingest.wal_write_failures")
                    for v in affected:
                        v._pending_since = None
                    # burn the revision: after a failed write or fsync
                    # the record may be on disk all the same, and a
                    # reused revision could let recovery's dedup drop a
                    # later acknowledged append in favor of it
                    self._rev = rev
                    raise IngestUnavailableError(
                        f"append to {table!r} could not be logged durably ({e}); "
                        f"not acknowledged — retry when the log recovers") from e
            self._rev = rev
            views = self._apply_locked(src, table, batch, affected)
            self._cond.notify_all()
        self._post_apply(table, batch, views)
        if self._wal is not None and self._wal.should_snapshot():
            self.maybe_snapshot()
        METRICS.add("ingest.appends")
        METRICS.add("ingest.rows", batch.num_rows)
        METRICS.add("ingest.bytes", sum(np.asarray(a).dtype.itemsize * batch.num_rows
                                        for a in batch.data))
        METRICS.observe("ingest.append.latency", time.perf_counter() - t0)
        recorder.record("ingest.append", table=table, rows=batch.num_rows, rev=rev,
                        client=client or "")
        return {"table": table, "rows": batch.num_rows, "rev": rev, "views": views}

    def _apply_locked(self, src: AppendableSource, table: str, batch: RecordBatch,
                      affected) -> dict:
        src.append_batch(batch)
        # catalog bump: dependent cached results stop matching and are
        # dropped.  A serving wrapper fronting the appendable is what
        # re-registers (the bare source would tear the pin out of the
        # catalog slot)
        registered = self.ctx.datasources.get(table)
        if registered is not None and getattr(registered, "inner", None) is src:
            self.ctx.register_datasource(table, registered)
        else:
            self.ctx.register_datasource(table, src)
        views = {}
        for v in affected:
            v.fold(src, [batch])
            views[v.name] = v.revision
        return views

    def _post_apply(self, table: str, batch: RecordBatch, views: dict) -> None:
        """Outside-lock fan-out to the serving hooks and the cluster
        (stale shared results dropped, view advances for remote
        watchers); best effort, since the append is already durable and
        applied."""
        for hook in list(self.on_applied):
            try:
                hook(table, batch)
            except Exception:  # noqa: BLE001 — a hook must not unwind an applied append
                METRICS.add("ingest.hook_failures")
        cl = self.cluster
        if cl is None:
            return
        try:
            cl.invalidate(table)
            for name, rev in views.items():
                cl.view_advance(name, rev)
        except (DataFusionError, OSError):
            METRICS.add("ingest.cluster_notify_failures")

    # -- views --

    def create_view(self, name: str, query_sql: str) -> MaterializedView:
        """Register `name` as a continuous query (the executable side of
        ``CREATE MATERIALIZED VIEW``): logged, built from the table's
        current contents, maintained per delta."""
        lockcheck.note_blocking("ingest.create_view")
        with self._lock:
            if name in self._views:
                raise IngestError(f"materialized view {name!r} exists")
            view = self._build_view(name, query_sql)
            rev = self._rev + 1
            if self._wal is not None:
                rec = {"kind": "view", "rev": rev, "name": name, "sql": query_sql}
                try:
                    self._wal.append([(rec, None)])
                except OSError as e:
                    METRICS.add("ingest.wal_write_failures")
                    raise IngestUnavailableError(
                        f"view {name!r} could not be logged durably ({e}); "
                        f"not registered — retry when the log recovers") from e
            self._rev = rev
            self._register_view_locked(view)
        recorder.record("view.create", view=name, table=view.table,
                        incremental=view.incremental, reason=view.fallback_reason or "")
        return view

    def _register_view_locked(self, view: MaterializedView) -> None:
        src = self._tables.get(view.table)
        if src is None:
            src = self._attach_locked(view.table)
        # the initial build folds the table's current batches the way
        # the deltas will be folded
        view.fold(src, list(src._batches) if view.incremental else [])
        self._views[view.name] = view
        _LIVE_VIEWS[view.name] = view
        self._cond.notify_all()

    def _build_view(self, name: str, query_sql: str) -> MaterializedView:
        """Plan and verify the defining SELECT and decide eligibility:
        the lowered tree must hold an AggregateRelation directly over
        the table's scan, with no string MIN/MAX slot.  Every refusal is
        a counted reason; the fallback still answers exactly and
        freshly, at a rescan's cost."""
        from datafusion_tpu_torch.exec.aggregate import AggregateRelation
        from datafusion_tpu_torch.exec.relation import DataSourceRelation
        from datafusion_tpu_torch.plan.logical import scan_tables
        from datafusion_tpu_torch.sql.parser import parse_sql

        plan = self.ctx._plan(parse_sql(query_sql))
        tables = scan_tables(plan)
        if len(tables) != 1:
            raise IngestError(
                f"materialized view {name!r}: exactly one base table required (got {tables})")
        table = tables[0]
        src = self._attach_locked(table)
        self.ctx._verify(plan)

        def fallback(reason: str) -> MaterializedView:
            METRICS.add(f"view.fallback.{reason}")
            recorder.record("view.fallback", view=name, reason=reason)
            return MaterializedView(name, query_sql, self.ctx, table, None, None, None,
                                    fallback_reason=reason)

        # lowered outside the result-cache seam: a replayed result has
        # no aggregate to own
        root = self.ctx._lower_with(plan, None)
        agg = None
        node = root
        while node is not None:
            if isinstance(node, AggregateRelation):
                agg = node
                break
            node = getattr(node, "child", None)
        if agg is None:
            return fallback("plan_shape")
        scan = agg.child
        if not isinstance(scan, DataSourceRelation):
            return fallback("scan_shape")
        ds = scan.datasource
        if ds is src or getattr(ds, "inner", None) is src:
            proj = None  # the table, or its serving wrapper
        elif isinstance(ds, _AppendableProjection) and ds._parent is src:
            proj = ds._projection
        elif getattr(getattr(ds, "parent", None), "inner", None) is src:
            proj = tuple(ds.cols)  # a pinned serving projection
        else:
            return fallback("scan_shape")
        if any(sl.is_string for sl in agg.core.slots):
            return fallback("string_minmax")
        return MaterializedView(name, query_sql, self.ctx, table, root, agg, proj)

    def view(self, name: str) -> MaterializedView:
        v = self._views.get(name)
        if v is None:
            raise IngestError(f"no materialized view {name!r}")
        return v

    def views(self) -> dict:
        return dict(self._views)

    def read_view(self, name: str):
        """The view's current ResultTable (serialized against folds)."""
        lockcheck.note_blocking("ingest.read")
        with self._lock:
            return self.view(name).read()

    # -- subscriptions --

    def wait_for(self, name: str, after_revision: int,
                 timeout: Optional[float] = None) -> Optional[int]:
        """Park until `name` advances past `after_revision`; the new
        revision, or None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        lockcheck.note_blocking("ingest.wait")
        with self._cond:
            while True:
                v = self.view(name)
                if v.revision > after_revision:
                    return v.revision
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if self.view(name).revision > after_revision:
                        return self.view(name).revision
                    return None

    # -- durability --

    def recover(self) -> dict:
        """Replay the ingest log (once, after the base tables are
        registered): the snapshot's deltas, then every acknowledged
        append in log order, then the views, re-planned and re-folded.
        Appends for unregistered tables are dropped with a count."""
        if self._wal is None:
            return {}
        snap, events, _deadlines = self._wal.recover()
        applied = dropped = 0
        # recovered view revisions continue the pre-crash sequence: each
        # view resumes at its snapshot revision (1, the creation fold,
        # for a view from the log) plus the appends replayed for its
        # table after that point
        counts: dict = {}  # table -> appends applied from the events
        view_docs: list = []  # (name, sql, base revision, counts then)
        with self._lock:
            if snap:
                for table, doc in (snap.get("tables") or {}).items():
                    base = doc.get("base")
                    if base and self.ctx.datasources.get(table) is not None:
                        src = self._attach_locked(table)
                        if src.base_version and src.base_version != base:
                            # the base changed under the delta log: replay
                            # goes on (the deltas are exact over the new
                            # base), but never silently
                            METRICS.add("ingest.base_drift")
                            recorder.record("ingest.base_drift", table=table)
                    for block in doc.get("blocks", ()):
                        if self._replay_append_locked(table, block):
                            applied += 1
                        else:
                            dropped += 1
                for doc in snap.get("views") or ():
                    view_docs.append((doc.get("name"), doc.get("sql"),
                                      int(doc.get("revision") or 1), {}))
            for ev in events:
                kind = ev.get("kind")
                if kind == "append":
                    table = ev.get("table", "")
                    if self._replay_append_locked(table, ev.get("cols") or []):
                        applied += 1
                        counts[table] = counts.get(table, 0) + 1
                    else:
                        dropped += 1
                elif kind == "view":
                    view_docs.append((ev.get("name"), ev.get("sql"), 1, dict(counts)))
            self._rev = max(self._rev, self._wal.last_rev)
            for name, sql, base_rev, at in view_docs:
                if not name or not sql or name in self._views:
                    continue
                try:
                    view = self._build_view(name, sql)
                    self._register_view_locked(view)
                except DataFusionError:
                    METRICS.add("ingest.recovery_view_failures")
                    continue
                view.revision = base_rev + (counts.get(view.table, 0) - at.get(view.table, 0))
                METRICS.gauge(f"view.{name}.revision", view.revision)
        if dropped:
            METRICS.add("ingest.recovery_dropped", dropped)
        self.recovery = {
            **self._wal.recovery,
            "appends_replayed": applied,
            "appends_dropped": dropped,
            "views_recovered": len(self._views),
        }
        recorder.record("ingest.recovered", **{
            k: v for k, v in self.recovery.items() if isinstance(v, (int, float, str))})
        return self.recovery

    def _replay_append_locked(self, table: str, cols: list) -> bool:
        if self.ctx.datasources.get(table) is None:
            return False
        src = self._attach_locked(table)
        try:
            batch = src.build_batch(_columns_from_block(src.schema, cols))
        except IngestError:
            return False
        affected = [v for v in self._views.values() if v.table == table]
        self._apply_locked(src, table, batch, affected)
        return True

    def maybe_snapshot(self) -> None:
        """Compact the ingest log: one snapshot carrying every table's
        delta blocks and the view definitions, after which the segments
        it covers are reaped.  Best effort: a failed snapshot leaves the
        log intact."""
        if self._wal is None:
            return
        lockcheck.note_blocking("ingest.snapshot")
        with self._lock:
            bw = BinWriter()
            tables = {}
            for name, src in self._tables.items():
                blocks = [_block_from_batch(src.schema, b, bw) for b in src.delta_batches()]
                if blocks:
                    tables[name] = {"blocks": blocks, "base": src.base_version}
            snap = {
                "rev": self._rev,
                "tables": tables,
                "views": [{"name": v.name, "sql": v.sql, "revision": v.revision}
                          for v in self._views.values()],
            }
        try:
            self._wal.write_snapshot(snap, bw)
        except OSError:
            METRICS.add("ingest.snapshot_failures")

    # -- introspection --

    def status(self) -> dict:
        with self._lock:
            return {
                "rev": self._rev,
                "wal": self._wal.manifest() if self._wal is not None else None,
                "recovery": dict(self.recovery),
                "tables": {n: s.meta()["Appendable"] for n, s in self._tables.items()},
                "views": {n: v.status() for n, v in self._views.items()},
            }

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
