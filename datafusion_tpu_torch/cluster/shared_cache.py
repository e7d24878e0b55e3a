"""Shared result-cache tier: fingerprint -> snapshot, across coordinators.

The result cache is per context; this tier makes it a fleet
resource.  `SharedResultTier` plugs into `CacheStore`'s pluggable
``shared`` seam (`cache/store.py`):

- **read-through**: a local miss consults ``cache/result/<fp>`` on the
  cluster service; a hit decodes the wire snapshot, installs it in the
  local store (so repeats stay local), and serves it — coordinator B
  gets coordinator A's warm result without touching workers or devices.
- **write-behind**: a local fill enqueues the snapshot for a background
  publisher thread; the query path never blocks on the service (a slow
  or partitioned service costs a dropped publication, counted, not
  latency).

Snapshots cross the wire as RAW binary segments with per-segment CRC32s
(the same binary frames the fragment protocol ships columns in) instead
of inline base64 JSON — publishing a large result costs its bytes, not
its bytes plus a third, and the ``coord.shared_cache_publish_bytes``
counter records exactly what went out.  Three snapshot forms exist and
the converters below move between them: the *raw* form (numpy arrays —
what the service stores and the in-process client passes by reference),
the *wire* form (segment refs / inline base64 — what crosses TCP), and
the `CachedResult` the cache subsystem consumes.  Entries carry the
scanned table names as tags so `invalidate(table)` on the service drops
dependents, and the whole tier rides replication: a standby mirrors
``result_put`` events (values attached to the log-shipping response),
so a coordinator's warm hit still lands after a primary failover.

Fingerprint compatibility across coordinators is inherited from
`exec/context.query_fingerprint`: the digest folds in the plan wire JSON,
catalog versions, backing-file (path, size, mtime), device, batch size, and UDF
registry version — two coordinators that registered the same tables
over the same files the same way mint the same fingerprint, and any
divergence (different file version, different batch size) misses
instead of serving wrong bytes.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.cache.result import CachedResult
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.utils.metrics import METRICS


def _as_array(o) -> np.ndarray:
    """An array in any snapshot form -> numpy (raw passthrough, wire
    segment/base64 decoded)."""
    if isinstance(o, np.ndarray):
        return o
    from datafusion_tpu_torch.parallel.wire import dec_array

    return dec_array(o)


def result_raw(entry: CachedResult) -> dict:
    """`CachedResult` -> the raw snapshot form (numpy by reference —
    nothing copied; treat the arrays as immutable)."""
    return {
        "columns": list(entry.columns),
        "validity": list(entry.validity),
        "dict_values": [
            None if d is None else list(d) for d in entry.dict_values
        ],
        "num_rows": entry.num_rows,
        "nbytes": entry.nbytes,
    }


def raw_to_wire(raw: dict, bw=None) -> dict:
    """Raw snapshot -> wire form: arrays become RAW binary segments via
    `bw` (inline base64 when `bw` is None or under the inline
    threshold)."""
    from datafusion_tpu_torch.parallel.wire import enc_array

    return {
        "columns": [enc_array(_as_array(c), bw) for c in raw["columns"]],
        "validity": [
            None if v is None else enc_array(_as_array(v), bw)
            for v in raw["validity"]
        ],
        "dict_values": [
            None if d is None else list(d) for d in raw["dict_values"]
        ],
        "num_rows": int(raw["num_rows"]),
        "nbytes": int(raw["nbytes"]),
    }


def wire_to_raw(obj: dict) -> dict:
    """Any snapshot form -> raw numpy (the canonical service-side
    storage form; numpy passes through untouched)."""
    return {
        "columns": [_as_array(c) for c in obj["columns"]],
        "validity": [
            None if v is None else _as_array(v) for v in obj["validity"]
        ],
        "dict_values": [
            None if d is None else list(d) for d in obj["dict_values"]
        ],
        "num_rows": int(obj["num_rows"]),
        "nbytes": int(obj["nbytes"]),
    }


def column_digests(raw: dict) -> list[str]:
    """Per-column content digests of a raw snapshot (dtype + shape +
    bytes, 16 hex chars).  The delta-publish protocol's identity: a
    column whose digest matches the service's stored copy is not
    re-shipped on republish."""
    import hashlib

    digs = []
    for c in raw["columns"]:
        a = np.ascontiguousarray(_as_array(c))
        h = hashlib.sha256()
        h.update(a.dtype.str.encode("ascii"))
        h.update(str(a.shape).encode("ascii"))
        h.update(memoryview(a).cast("B"))
        digs.append(h.hexdigest()[:16])
    return digs


def encode_result(entry: CachedResult, bw=None) -> dict:
    """Wire-encode a `CachedResult` snapshot (binary segments when a
    `BinWriter` is given, inline base64 otherwise)."""
    return raw_to_wire(result_raw(entry), bw)


def decode_result(obj: dict) -> CachedResult:
    """Rebuild a `CachedResult` from any snapshot form; the result is
    marked ``shared`` so EXPLAIN ANALYZE shows where it came from."""
    raw = wire_to_raw(obj)
    return CachedResult(
        raw["columns"],
        raw["validity"],
        [None if d is None else tuple(d) for d in raw["dict_values"]],
        raw["num_rows"],
        raw["nbytes"],
        shared=True,
    )


class SharedResultTier:
    """The `CacheStore.shared` plug-in backed by a cluster client.

    Protocol (what `CacheStore` calls):
      load(key)  -> (value, nbytes, tags) or None
      store(key, value, nbytes, tags) -> None  (must not block)
    """

    _PUBLISHED_KEYS_MAX = 512

    def __init__(self, client, queue_depth: int = 64):
        from datafusion_tpu_torch.utils import breaker as breaker_mod

        self.client = client
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = lockcheck.make_lock("cluster.shared_tier")
        # per-target circuit breaker (None when breakers are off): an
        # open circuit means DEGRADED LOCAL-ONLY caching — loads skip
        # the round trip, publications drop fast — instead of every
        # query's miss path paying a dead service's timeout.  Recovery
        # is the breaker's half-open probe: the first load/publish
        # after the cool-down tests the service and re-closes
        self._breaker = breaker_mod.breaker_for("shared_cache")
        # key -> column digests of this publisher's last publication;
        # armed, a republish ships a DELTA (changed columns only, with
        # a full-snapshot fallback when the service disagrees).
        # Publisher-thread-only, bounded.
        self._published: dict[str, list[str]] = {}

    # -- read-through --
    def load(self, key: str):
        b = self._breaker
        if b is not None and not b.allow():
            # open circuit: serve local-only rather than queue on a
            # dead/sick service (the cache ABOVE this tier still works)
            METRICS.add("coord.shared_cache_fast_fails")
            return None
        try:
            with obs_trace.span("cluster.shared_cache", op="get"):
                fetched = self.client.result_fetch(key)
        except (ConnectionError, OSError, ExecutionError):
            if b is not None:
                b.record(False)
            METRICS.add("coord.shared_cache_errors")
            return None
        except (KeyError, TypeError, ValueError):
            if b is not None:
                # the service ANSWERED (malformed entry): transport is
                # healthy — and the reserved half-open probe slot must
                # be released either way
                b.record(True)
            METRICS.add("coord.shared_cache_decode_errors")
            return None
        if b is not None:
            b.record(True)
        if fetched is None:
            METRICS.add("coord.shared_cache_misses")
            return None
        entry, tables = fetched
        METRICS.add("coord.shared_cache_hits")
        return entry, entry.nbytes, tables

    # -- write-behind --
    def store(self, key: str, value, nbytes: int, tags: tuple) -> None:
        if not isinstance(value, CachedResult):
            return  # the tier only understands result snapshots
        if value.shared:
            return  # read-through install: already published, no echo
        self._ensure_thread()
        try:
            self._q.put_nowait((key, value, int(nbytes), tuple(tags)))
        except queue.Full:
            # write-behind means best-effort: a backlogged publisher
            # drops the publication, never stalls the query path
            METRICS.add("coord.shared_cache_publish_dropped")

    def _ensure_thread(self) -> None:
        if self._thread is not None:
            return
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._publish_loop,
                    name="df-torch-shared-cache", daemon=True,
                )
                self._thread.start()

    def _publish_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            key, value, nbytes, tags = item
            b = self._breaker
            if b is not None and not b.allow():
                # open circuit: silent local-only caching — drop the
                # publication fast instead of burning the publisher
                # thread on a dead service's timeout per entry
                METRICS.add("coord.shared_cache_publish_skipped")
                self._q.task_done()
                continue
            try:
                sent = self._publish_one(key, value, nbytes, tags)
                if b is not None:
                    b.record(True)
                METRICS.add("coord.shared_cache_published")
                if sent:
                    # actual wire cost of the publication (binary
                    # segments, not base64) — the A/B evidence for the
                    # RAW-segment path
                    METRICS.add("coord.shared_cache_publish_bytes", int(sent))
            except (ConnectionError, OSError, ExecutionError):
                if b is not None:
                    b.record(False)
                METRICS.add("coord.shared_cache_errors")
            except Exception:  # noqa: BLE001 — the publisher must outlive bad entries
                if b is not None:
                    # a bad ENTRY, not a bad service: release the
                    # reserved probe slot as transport-healthy
                    b.record(True)
                METRICS.add("coord.shared_cache_errors")
            finally:
                self._q.task_done()

    def _publish_one(self, key: str, value, nbytes: int, tags: tuple) -> int:
        """One publication: delta when this publisher has published
        `key` before (only changed columns cross the wire; the service
        answers ``need_full`` on any digest disagreement and we fall
        back), full snapshot otherwise.  Returns the bytes sent."""
        digests = column_digests(result_raw(value))
        prev = self._published.get(key)
        sent: Optional[int] = None
        with obs_trace.span("cluster.shared_cache", op="put",
                            delta=prev is not None):
            if prev is not None:
                sent = self.client.result_publish_delta(
                    key, value, nbytes, tags, digests, prev
                )
                if sent is not None:
                    METRICS.add("coord.shared_cache_delta_published")
            if sent is None:
                sent = self.client.result_publish(
                    key, value, nbytes, tables=tags, digests=digests
                )
        if key not in self._published \
                and len(self._published) >= self._PUBLISHED_KEYS_MAX:
            # evict only when a NEW key would grow the map — a warm
            # republish (the delta path's whole reason) must not bump
            # another hot key back to full-snapshot publishing
            self._published.pop(next(iter(self._published)))
        self._published[key] = digests
        return int(sent or 0)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the publish queue drains (tests, smoke scripts —
        write-behind made deterministic).  Returns False on timeout."""
        import time

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._q.unfinished_tasks == 0

    def close(self) -> None:
        if self._thread is not None:
            self.flush(timeout_s=2.0)
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
