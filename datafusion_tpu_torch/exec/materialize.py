"""Result materialization: batches -> host rows.

The counterpart of the JAX package's `exec/materialize.py`.  A batch
reaching this boundary is a host batch or holds tensors on the device
(the dense join probe's output; a pipeline's computed columns and its
selection mask beside its pass-through host columns; a pipeline's
host-function outputs are already host arrays).  `compact_batch`
brings one to the host: the selection mask crosses first, bit-packed
on the device (`_fetch_mask`); when the live rows at most half fill the
batch (`_COMPACT_FACTOR`) the device columns are gathered to them on
the device (`_gather_compact`); then every device column crosses in
ONE copy (`batch.device_pull`), unsigned columns come back in their
numpy dtype, and padding and masked-out rows are dropped.

The JAX package also overlaps each batch's copy with the next batch
(`iter_with_mask_prefetch`, `compact_dispatch`, `collect_columns` one
batch behind).  Not ported: the copies here block, and one stream runs
every pass, so a copy queued behind the next batch's pass would wait
for it and overlap nothing.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    bucket_capacity,
    device_pull,
    has_link,
    host_array,
)
from datafusion_tpu_torch.utils.metrics import METRICS

# device-side compaction pays off when it at least halves the D2H bytes
_COMPACT_FACTOR = 2


def _on_device(a) -> bool:
    return isinstance(a, torch.Tensor)


def _gather_compact(arrays, idx: torch.Tensor) -> list:
    """The live rows of each device array gathered to the front, in
    order (`idx`: their positions, an int64 tensor on the device)."""
    return [a.index_select(0, idx) for a in arrays]


_WEIGHTS: dict = {}


def _fetch_mask(batch) -> np.ndarray:
    """Host bool mask for a batch (blocking), cached on the batch.
    Across a link (`batch.has_link`) a device mask packs to bits on the
    device first: 8x fewer bytes."""
    hit = batch.cache.get("host_mask")
    if hit is not None:
        return hit
    m = batch.mask
    if not _on_device(m):
        return np.asarray(m, bool)
    packed = m.shape[0] % 8 == 0 and has_link(m.device)
    if packed:
        w = _WEIGHTS.get(m.device)
        if w is None:
            w = _WEIGHTS[m.device] = torch.tensor(  # df-lint: ok(DF006) — 8 bit weights, once a device
                [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=m.device)
        m = (m.reshape(-1, 8).to(torch.uint8) * w).sum(dim=1, dtype=torch.uint8)
    host = device_pull((m,))[0]
    host = np.unpackbits(host).astype(bool) if packed else host.astype(bool)
    batch.cache["host_mask"] = host
    return host


def compact_batch(batch: RecordBatch):
    """Bring a batch to host and drop padding/filtered rows.

    Returns (columns, validity, dicts, num_live_rows); strings stay
    dictionary-coded."""
    n = batch.num_rows
    live: Optional[np.ndarray] = None
    if batch.mask is not None:
        live = _fetch_mask(batch)[: batch.capacity]
        live = live & (np.arange(batch.capacity) < n)
    # arrays already on the device; host arrays (pass-through columns,
    # host-function outputs) never travel just to be compacted
    dev_pos: list = []
    dev_arrays: list = []
    for i, c in enumerate(batch.data):
        if _on_device(c):
            dev_pos.append(("col", i))
            dev_arrays.append(c)
    for i, v in enumerate(batch.validity):
        if v is not None and _on_device(v):
            dev_pos.append(("val", i))
            dev_arrays.append(v)
    compacted = False
    count = int(live.sum()) if live is not None else n
    if live is not None and dev_arrays:
        cap_out = bucket_capacity(max(count, 1))
        if cap_out * _COMPACT_FACTOR <= batch.capacity:
            idx = torch.from_numpy(np.nonzero(live)[0]).to(dev_arrays[0].device)  # df-lint: ok(DF006) — the compaction's row index, counted by the d2h.compact timer
            with METRICS.timer("d2h.compact"):
                dev_arrays = _gather_compact(dev_arrays, idx)
            METRICS.add("d2h.compacted_batches")
            compacted = True
    elif live is None:
        # no selection: only the rows below num_rows cross
        dev_arrays = [a[:n] for a in dev_arrays]
    pulled = dict(zip(dev_pos, device_pull(dev_arrays)))
    fields = batch.schema.fields
    if len(fields) != len(batch.data):
        fields = [None] * len(batch.data)

    def select(kind, i, a):
        hit = pulled.get((kind, i))
        if hit is not None:
            if kind == "col" and fields[i] is not None:
                # an unsigned column comes back in its numpy dtype
                hit = host_array(hit, fields[i].data_type.np_dtype)
            if compacted:
                return hit  # already gathered to the live rows
            a = hit
        else:
            a = np.asarray(a)
        if live is not None:
            return a[live]
        return a[:n]

    cols = []
    valids = []
    for i in range(batch.num_columns):
        cols.append(select("col", i, batch.data[i]))
        v = batch.validity[i]
        valids.append(None if v is None else select("val", i, v))
    return cols, valids, list(batch.dicts), count


class ResultTable:
    """A fully-materialized query result (decoded, null-aware)."""

    def __init__(self, schema: Schema, columns: list[np.ndarray],
                 validity: list[Optional[np.ndarray]]):
        self.schema = schema
        self.columns = columns
        self.validity = validity

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def column_values(self, i: int) -> list:
        """Python values for column i, None where null."""
        col = self.columns[i]
        valid = self.validity[i]
        out = col.tolist()  # df-lint: ok(DF001) — a host column (numpy), not a tensor
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out

    def to_pylist(self) -> list[dict]:
        names = self.schema.names()
        cols = [self.column_values(i) for i in range(len(names))]
        return [dict(zip(names, row)) for row in zip(*cols)] if cols else []

    def to_rows(self) -> list[tuple]:
        cols = [self.column_values(i) for i in range(len(self.schema))]
        return list(zip(*cols)) if cols else []

    def to_csv(self, path: str, header: bool = True) -> None:
        """Write the table to a CSV file (the `PhysicalPlan` write sink,
        reference `physicalplan.rs:25-29`): the JAX package's bytes,
        NULL as an empty field."""
        import csv as _csv

        with open(path, "w", newline="", encoding="utf-8") as fh:
            w = _csv.writer(fh)
            if header:
                w.writerow(self.schema.names())
            for row in self.to_rows():
                w.writerow(["" if v is None else v for v in row])

    def pretty(self, max_rows: int = 50) -> str:
        """The first `max_rows` rows as a boxed text table (the JAX
        package's text), with a row-count line when more exist."""
        names = self.schema.names()
        rows = self.to_rows()
        cells = [[("NULL" if v is None else str(v)) for v in row]
                 for row in rows[:max_rows]]
        widths = [len(n) for n in names]
        for row in cells:
            for j, c in enumerate(row):
                widths[j] = max(widths[j], len(c))
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        lines = [sep,
                 "|" + "|".join(f" {n:<{w}} " for n, w in zip(names, widths)) + "|",
                 sep]
        for row in cells:
            lines.append("|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|")
        lines.append(sep)
        if len(rows) > max_rows:
            lines.append(f"... ({self.num_rows} rows total)")
        return "\n".join(lines)


def collect_columns(relation, batches=None):
    """Pull every batch of a Relation (or `batches`, an iterator over
    its output) and concatenate live rows on host.

    Returns (columns, validity, dicts, total_rows); strings stay
    dictionary-coded (dicts[i] holds the decoder).

    This is also the result cache's capture point: a root relation that
    `ExecutionContext.execute` tagged with `_result_cache_fill`
    (`cache/result.py`) hands that hook the materialized columns after
    a complete run; caching never changes what this returns.  And the
    per-query telemetry funnel's: a root relation the context tagged
    (`_telemetry_query`) reports its outcome, success or failure, to
    `obs/aggregate.query_completed` (`_query_telemetry`).
    """
    t0 = time.perf_counter()
    schema = relation.schema
    ncols = len(schema)
    parts: list[list[np.ndarray]] = [[] for _ in range(ncols)]
    vparts: list[list[Optional[np.ndarray]]] = [[] for _ in range(ncols)]
    dicts: list = [None] * ncols
    total = 0
    query_label = getattr(relation, "_telemetry_query", None)

    try:
        for batch in relation.batches() if batches is None else batches:
            cols, valids, bdicts, n = compact_batch(batch)
            total += n
            for i in range(ncols):
                parts[i].append(cols[i])
                vparts[i].append(valids[i])
                if bdicts[i] is not None:
                    dicts[i] = bdicts[i]
    except Exception as e:
        # a failed root query: the funnel observes the error (the error
        # budget, the flight event, the artifact set), then it propagates
        if query_label is not None:
            _query_telemetry(relation, query_label, time.perf_counter() - t0, total,
                             error=f"{type(e).__name__}: {e}")
        raise
    columns = []
    validity: list[Optional[np.ndarray]] = []
    for i in range(ncols):
        if parts[i]:
            columns.append(np.concatenate(parts[i]))
        else:
            columns.append(np.empty(0, dtype=schema.field(i).data_type.np_dtype))
        if all(v is None for v in vparts[i]):
            validity.append(None)
        else:
            validity.append(np.concatenate([
                np.ones(len(p), dtype=bool) if v is None else v
                for v, p in zip(vparts[i], parts[i])
            ]))
    fill = getattr(relation, "_result_cache_fill", None)
    if fill is not None:
        fill(columns, validity, dicts, total, time.perf_counter() - t0)
    if query_label is not None:
        _query_telemetry(relation, query_label, time.perf_counter() - t0, total)
    return columns, validity, dicts, total


def _query_telemetry(relation, label: str, wall_s: float, rows: int,
                     error: Optional[str] = None) -> None:
    """One root query's outcome to the telemetry funnel, with its
    phases from the stage timers the context snapshotted when it tagged
    the query.  The funnel never raises."""
    from datafusion_tpu_torch.obs import trace as obs_trace
    from datafusion_tpu_torch.obs.aggregate import query_completed

    phases = None
    before = getattr(relation, "_phase_before", None)
    if before:  # empty: the ledger is off, no breakdown
        from datafusion_tpu_torch.obs.device import phase_breakdown, phase_ms

        phases = phase_ms(phase_breakdown(before, wall_s)) or None
    tc = obs_trace.current_trace()
    query_completed(
        wall_s, rows=rows,
        # EXPLAIN ANALYZE's root tap forwards the real tree
        root=getattr(relation, "_telemetry_root", relation),
        label=label, error=error,
        trace_id=None if tc is None else tc.trace_id,
        # EXPLAIN ANALYZE exports its complete span set itself
        export_otlp=not getattr(relation, "_telemetry_skip_otlp", False),
        phases=phases,
    )


def collect(relation) -> ResultTable:
    """Materialize a Relation into a ResultTable (decodes strings)."""
    schema = relation.schema
    columns, validity, dicts, _ = collect_columns(relation)
    decoded = []
    for i in range(len(schema)):
        c = columns[i]
        if schema.field(i).data_type == DataType.UTF8:
            if dicts[i] is not None:
                c = dicts[i].decode(c)
            else:
                c = c.astype(object)
        decoded.append(c)
    return ResultTable(schema, decoded, validity)
