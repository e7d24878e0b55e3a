"""Byte-accounted LRU+TTL cache store (the JAX package's `cache/store.py`).

One `CacheStore` backs each cache in the subsystem (the coordinator's
result cache, a worker's fragment cache).  Entries are keyed by a
fingerprint string (`cache/fingerprint.py`), carry an explicit byte
size (values are opaque — numpy columns, raw response dicts — so the
caller accounts them), and belong to *tags* (table names) so catalog
changes can invalidate exactly the dependent entries.

Accounting flows into the engine-wide `Metrics` registry (the single
counter backend, `utils/metrics.py`): `cache.<name>.hits` / `.misses` /
`.evictions` / `.invalidations` / `.inserts` / `.rejected` counters;
point-in-time gauges (`bytes`, `entries`) come from `gauges()` and ride
`prometheus_text(extra_gauges=...)` at scrape time.

Concurrency: one lock around the OrderedDict; get/put are O(1) plus
eviction.  Values are returned by reference — callers treat cached
values as immutable (the worker re-encodes cached arrays per request,
it never mutates them).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Iterable, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.utils.metrics import METRICS


class _Entry:
    __slots__ = ("value", "nbytes", "expires", "tags")

    def __init__(self, value: Any, nbytes: int, expires: Optional[float],
                 tags: tuple):
        self.value = value
        self.nbytes = nbytes
        self.expires = expires
        self.tags = tags


class CacheStore:
    """Thread-safe LRU with a byte budget and optional per-entry TTL."""

    def __init__(self, max_bytes: int, ttl_s: Optional[float] = None,
                 name: str = "cache"):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s if ttl_s else None  # 0/None = entries never age out
        self.name = name
        # pluggable shared tier (cluster/shared_cache.py): an object with
        # `load(key) -> (value, nbytes, tags) | None` (read-through on a
        # local miss) and `store(key, value, nbytes, tags)` (write-behind
        # after a local fill; must not block).  None = single-tier store,
        # and the only overhead is one attribute test on the miss path.
        self.shared = None
        self.shared_hits = 0
        self._lock = lockcheck.make_lock(f"cache.store:{name}")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._tags: dict[str, set[str]] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rejected = 0

    # -- internals (lock held) --
    def _count(self, what: str, n: int = 1) -> None:
        METRICS.add(f"cache.{self.name}.{what}", n)

    def _drop(self, key: str, entry: _Entry) -> None:
        self._bytes -= entry.nbytes
        for t in entry.tags:
            keys = self._tags.get(t)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._tags[t]

    def _evict_lru(self) -> None:
        key, entry = self._entries.popitem(last=False)
        self._drop(key, entry)
        self.evictions += 1
        self._count("evictions")

    # -- API --
    def get(self, key: str) -> Optional[Any]:
        """Value for `key`, or None (missing / expired).  A hit moves
        the entry to MRU.  On a local miss a configured shared tier is
        consulted (read-through): a tier hit installs locally — without
        re-publishing — and serves; `misses` still counts the local
        miss, `shared_hits` counts the rescue."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.expires is not None \
                    and now >= entry.expires:
                del self._entries[key]
                self._drop(key, entry)
                entry = None
                self.evictions += 1
                self._count("expired")
            if entry is None:
                self.misses += 1
                self._count("misses")
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                self._count("hits")
                return entry.value
        if self.shared is not None:  # outside the lock: a network call
            loaded = self.shared.load(key)
            if loaded is not None:
                value, nbytes, tags = loaded
                self.put(key, value, nbytes, tags=tags, propagate=False)
                self.shared_hits += 1
                self._count("shared_hits")
                return value
        return None

    def put(self, key: str, value: Any, nbytes: int,
            tags: Iterable[str] = (), propagate: bool = True) -> bool:
        """Insert (or replace) `key`.  Returns False when the value
        alone exceeds the byte budget (the entry is not stored — one
        giant result must not wipe the whole cache).  With a shared
        tier configured, a local fill also publishes there
        (write-behind, never blocking); `propagate=False` suppresses
        the echo for read-through installs."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            with self._lock:
                self.rejected += 1
            self._count("rejected")
            return False
        tags = tuple(tags)
        expires = (
            time.monotonic() + self.ttl_s if self.ttl_s is not None else None
        )
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop(key, old)
            self._entries[key] = _Entry(value, nbytes, expires, tags)
            self._bytes += nbytes
            for t in tags:
                self._tags.setdefault(t, set()).add(key)
            while self._bytes > self.max_bytes:
                self._evict_lru()
        self._count("inserts")
        if propagate and self.shared is not None:
            self.shared.store(key, value, nbytes, tags)
        return True

    def peek(self, key: str) -> Optional[Any]:
        """Value for `key` without touching hit/miss counters, LRU
        order, or the shared tier — replication reads (the cluster
        service attaching result values to a log-shipping response)
        must not skew the cache's own statistics."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or (entry.expires is not None
                                 and now >= entry.expires):
                return None
            return entry.value

    def export_entries(self) -> list:
        """Snapshot of every live entry as (key, value, nbytes, tags)
        tuples, MRU last — the cluster service's full-state snapshot
        uses this to ship the result tier to a catching-up standby."""
        now = time.monotonic()
        with self._lock:
            return [
                (k, e.value, e.nbytes, e.tags)
                for k, e in self._entries.items()
                if e.expires is None or now < e.expires
            ]

    def invalidate(self, key: str) -> bool:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._drop(key, entry)
            self.invalidations += 1
        self._count("invalidations")
        return True

    def invalidate_tag(self, tag: str) -> int:
        """Drop every entry tagged `tag` (e.g. all cached results that
        scanned a just-re-registered table).  Returns how many fell."""
        with self._lock:
            keys = list(self._tags.get(tag, ()))
            for key in keys:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self._drop(key, entry)
            n = len(keys)
            self.invalidations += n
        if n:
            self._count("invalidations", n)
        return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._tags.clear()
            self._bytes = 0

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def entries(self) -> int:
        return len(self._entries)

    def tags(self) -> set[str]:
        """The live tag vocabulary (table names, for the fragment and
        result stores) — pin advertisement (cluster/agent.py) folds it
        into the worker's lease value under QoS."""
        with self._lock:
            return set(self._tags)

    def stats(self) -> dict:
        """Snapshot for status endpoints / smoke assertions."""
        with self._lock:
            return {
                "name": self.name,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "rejected": self.rejected,
                "shared_hits": self.shared_hits,
                "shared_tier": self.shared is not None,
            }

    def gauges(self, prefix: Optional[str] = None) -> dict:
        """Point-in-time gauges for `prometheus_text(extra_gauges=...)`
        (counters already live in METRICS; only levels go here)."""
        p = prefix if prefix is not None else f"cache.{self.name}"
        return {f"{p}.bytes": self._bytes, f"{p}.entries": len(self._entries)}

    def __repr__(self):
        return (
            f"CacheStore({self.name}, {len(self._entries)} entries, "
            f"{self._bytes}/{self.max_bytes}B)"
        )
