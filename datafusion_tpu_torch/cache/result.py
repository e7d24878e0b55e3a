"""Result cache: capture + replay (the JAX package's `cache/result.py`).

The capture point is the materialization boundary, not the operator
tree: `ExecutionContext.execute` tags the root relation of a cache-miss
query with a `_result_cache_fill` callable, and `collect_columns`
(`exec/materialize.py`) invokes it with the fully-materialized host
columns after a complete, exception-free run.  This keeps the executed
relation *identical* to the uncached engine — same operator types, same
batch identities, same device behavior — so nothing downstream can tell
caching is on until a repeat of the same fingerprint returns a
`CachedResultRelation` instead of an operator tree.

Stored values are host-only snapshots: numpy column copies, validity
copies, and a frozen copy of each string dictionary's value table
(dictionaries are append-only, so codes taken at snapshot time stay
valid, but the snapshot must not pin the live dictionary object).
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from datafusion_tpu_torch.utils.metrics import METRICS


class CachedResult:
    """One query's materialized result, as stored in the cache."""

    __slots__ = ("columns", "validity", "dict_values", "num_rows", "nbytes")

    def __init__(self, columns, validity, dict_values, num_rows: int,
                 nbytes: int):
        self.columns = columns
        self.validity = validity
        self.dict_values = dict_values
        self.num_rows = num_rows
        self.nbytes = nbytes


def _snapshot_nbytes(columns, validity, dicts) -> int:
    """Byte size of a would-be snapshot, computed BEFORE any copying so
    over-budget results cost nothing but this sum."""
    n = 0
    for c in columns:
        n += c.nbytes
    for v in validity:
        if v is not None:
            n += v.nbytes
    for d in dicts:
        if d is not None:
            # string payload + per-entry object overhead estimate
            n += sum(len(s) for s in d.values) + 16 * len(d.values)
    return n


def attach_result_capture(rel, store, key: str, tags, on_complete=None) -> None:
    """Tag `rel` so its next complete materialization snapshots into
    `store` under `key` (tagged with the scanned table names)."""

    def fill(columns, validity, dicts, total, wall_s):
        summary = {"rows": total, "cache_hit": False, "wall_s": wall_s}
        try:
            if not columns:
                METRICS.add("cache.result.uncacheable")
                return
            nbytes = _snapshot_nbytes(columns, validity, dicts)
            if nbytes > store.max_bytes:
                store.rejected += 1
                METRICS.add("cache.result.rejected")
                return
            entry = CachedResult(
                [np.array(c, copy=True) for c in columns],
                [None if v is None else np.array(v, copy=True)
                 for v in validity],
                [None if d is None else tuple(d.values) for d in dicts],
                total,
                nbytes,
            )
            store.put(key, entry, nbytes, tags=tags)
        finally:
            if on_complete is not None:
                on_complete(summary)

    rel._result_cache_fill = fill


from datafusion_tpu_torch.exec.relation import Relation


class CachedResultRelation(Relation):
    """Relation replaying a cached result as bucketed host batches.

    Shows up in EXPLAIN ANALYZE as `CachedResult[...]` with
    `cache.hit=True` / `cache.bytes=...` operator attributes; pulling its
    batches touches no datasource or device.

    Replay is chunked: rows stream out in `batch_size`-row batches
    instead of one concatenated batch, so a large cached result's peak
    working set during replay is one bucket's padding plus the consumer
    side, and consumers that stream (the CLI printing rows) start
    producing output before the whole result is re-assembled.  Slices
    view the cached columns — chunking copies nothing.
    """

    def __init__(self, schema, entry: CachedResult, fingerprint: str,
                 on_complete=None, batch_size: Optional[int] = None):
        self._schema = schema
        self.entry = entry
        self.fingerprint = fingerprint
        self._on_complete = on_complete
        self._batch_size = batch_size
        self._op_stats = None

    @property
    def schema(self):
        return self._schema

    @property
    def stats(self):
        st = self._op_stats
        if st is None:
            from datafusion_tpu_torch.obs.stats import OperatorStats

            st = self._op_stats = OperatorStats()
            st.attrs.update({
                "cache.hit": True,
                "cache.bytes": self.entry.nbytes,
            })
        return st

    def op_name(self) -> str:
        return "CachedResult"

    def op_label(self) -> str:
        return (
            f"CachedResult[rows={self.entry.num_rows}, "
            f"bytes={self.entry.nbytes}, fp={self.fingerprint[:12]}]"
        )

    def op_children(self) -> list:
        return []

    def batches(self) -> Iterator:
        from datafusion_tpu_torch.exec.batch import StringDictionary, make_host_batch

        t0 = time.perf_counter()
        entry = self.entry
        METRICS.add("cache.result.rows_served", entry.num_rows)
        self.stats  # materialize the cache.hit attrs for EXPLAIN ANALYZE
        if entry.num_rows and entry.columns:
            dicts: list[Optional[StringDictionary]] = []
            for vals in entry.dict_values:
                if vals is None:
                    dicts.append(None)
                    continue
                d = StringDictionary()
                d.values = list(vals)
                d.index = {s: i for i, s in enumerate(vals)}
                dicts.append(d)
            step = self._batch_size or entry.num_rows
            n_batches = 0
            for off in range(0, entry.num_rows, step):
                yield make_host_batch(
                    self._schema,
                    [c[off:off + step] for c in entry.columns],
                    [None if v is None else v[off:off + step]
                     for v in entry.validity],
                    dicts,
                )
                n_batches += 1
            if self._op_stats is not None and n_batches > 1:
                self._op_stats.attrs["cache.batches"] = n_batches
        if self._on_complete is not None:
            self._on_complete({
                "rows": entry.num_rows,
                "cache_hit": True,
                "wall_s": time.perf_counter() - t0,
            })
