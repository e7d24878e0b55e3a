"""The cluster state service: a replicated lease-KV with a membership
epoch, leadership terms, and primary/standby failover.

`ClusterState` is the pure, thread-safe state machine (run it in-process
for tests); `ClusterNode` wraps it with a replication *role* (primary or
standby), term fencing, and the log-shipping machinery; and
`ClusterStateService` serves a node over TCP reusing the engine's
versioned wire protocol (`parallel/wire.py` length-prefixed frames —
requests advertise `wire_version` and corrupt frames raise
`ProtocolError`, exactly like the fragment protocol).

Semantics (the useful subset of etcd's):

- **Leases**: `lease_grant(ttl_s)` mints an id; keys put with a lease
  die with it.  `lease_refresh` renews AND returns the event-log tail
  plus the current epoch in the same round trip — a worker's heartbeat
  is one request, not three.  Expiry is lazy: every public operation
  first sweeps lapsed leases, so no timer thread is needed and a
  single-threaded test can step time deterministically.
- **Epoch**: a counter bumped by every membership change (a
  ``workers/*`` key appearing or disappearing).  Two coordinators that
  observe the same epoch observed the same worker set.
- **Event log**: revision-numbered, bounded.  Every mutation appends an
  event — membership joins/leaves and ``cache/invalidate`` broadcasts
  (the *client-visible* kinds), plus grants, puts, deletes, and result
  publications (the replication kinds a standby needs to mirror the
  whole state machine).  Client consumers poll with their last seen
  revision (`events_since`) and see only the client-visible kinds; a
  consumer that fell off the retained window gets `truncated=True` and
  resyncs from scratch.  A standby tails the FULL log (`replicate_pull`)
  and falls back to a complete state snapshot after truncation.
- **Term**: a monotonically increasing leadership counter, stamped on
  every event.  A standby that promotes itself bumps the term; writes
  carrying an explicit stale term are rejected (`StaleTermError`), and
  the term exchange on every replication/peer round demotes a revived
  old primary before it can split-brain the KV.
- **Watches**: ``watch(since, timeout_s)`` parks until a client-visible
  event lands past `since` (or the timeout lapses) and answers with the
  event tail plus the current membership — long-poll push, so watch lag
  is one network round trip instead of one poll interval.
- **Result tier**: ``cache/result/<fingerprint>`` entries live in a
  byte-accounted `CacheStore` (LRU+TTL, tagged by table name) holding
  result snapshots with raw numpy columns — `invalidate(table)` drops
  dependent results here and broadcasts the fragment-cache invalidation
  to workers.  Over TCP the columns travel as CRC'd binary RAW wire
  segments, not inline base64.
- **Durability** (``DATAFUSION_TPU_WAL_DIR``; default off = the
  in-memory behavior above, byte-identical): with a WAL directory
  configured, `ClusterNode` appends every replication event to a
  segment-file write-ahead log (`utils/wal.py`) *before* quorum-ack,
  writes compacted `snapshot_state()` snapshots beside it, and replays
  both at boot — terms, revisions, KV, grants, lease *deadlines*
  (re-armed from persisted remaining TTL via `rearm_leases`, never a
  fresh full TTL), and the result tier all survive a whole-fleet
  ``kill -9``.  Elections and `replicate_pull` treat a recovered node
  identically to a caught-up standby.
"""

from __future__ import annotations

import math
import os
import threading
import time
import uuid
from typing import Any, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.cache.store import CacheStore
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.utils.eventloop import LoopServer
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS

_EVENT_LOG_CAP = 1024
# event kinds surfaced to workers/coordinators (lease_refresh piggyback,
# `events`, `watch`); the remaining kinds exist for log-shipping only
CLIENT_EVENT_KINDS = ("join", "leave", "invalidate", "view")
_WATCH_TIMEOUT_CAP_S = 60.0


class _Lease:
    __slots__ = ("lease_id", "ttl_s", "expires", "keys")

    def __init__(self, lease_id: str, ttl_s: float, now: float):
        self.lease_id = lease_id
        self.ttl_s = ttl_s
        self.expires = now + ttl_s
        self.keys: set[str] = set()


class _Key:
    __slots__ = ("value", "lease", "rev", "refreshed")

    def __init__(self, value: Any, lease: Optional[str], rev: int, now: float):
        self.value = value
        self.lease = lease
        self.rev = rev
        self.refreshed = now  # last lease refresh covering this key


class ClusterState:
    """The control-plane state machine.  All public methods are
    thread-safe; time is injectable (`now`) so tests drive lease expiry
    without sleeping."""

    def __init__(self, result_cache_bytes: Optional[int] = None,
                 result_ttl_s: Optional[float] = None):
        if result_cache_bytes is None:
            env = os.environ.get("DATAFUSION_TPU_CLUSTER_CACHE_BYTES", "")
            from datafusion_tpu_torch.cluster import DEFAULT_CACHE_BYTES

            result_cache_bytes = int(env) if env else DEFAULT_CACHE_BYTES
        self._lock = lockcheck.make_lock("cluster.state")
        # serializes REPLICATION applies (apply_event/apply_snapshot)
        # end to end, result-tier side effects included: a quorum push
        # and the pull loop may race the same tail, and the rev guard
        # alone cannot order the side effects (a stalled result_put
        # replaying after a later invalidate would resurrect the
        # invalidated entry).  Client-facing reads/writes never take it.
        self._apply_lock = lockcheck.make_lock("cluster.apply")
        # watchers park here; notified on every appended event (the
        # Condition runs through the tracked lock's acquire/release, so
        # lockcheck's held-stack stays coherent across parked waits)
        self._watch_cond = threading.Condition(self._lock)
        self._kv: dict[str, _Key] = {}
        self._leases: dict[str, _Lease] = {}
        self._epoch = 0
        self._rev = 0
        self.term = 1  # leadership term; stamped on every event
        self._events: list[dict] = []
        self._events_floor = 0  # oldest revision still in the log
        # revision of the newest client-visible event — watchers'
        # wakeup predicate is one comparison, not a log scan
        self._last_client_rev = 0
        # event-loop watch waiters: token -> (since, notify).  A parked
        # long-poll costs one dict entry here (plus its fd in the
        # selector) instead of a thread; `notify` fires under the state
        # lock, so it must be cheap and non-blocking (the event
        # server's is one call_soon)
        self._async_waiters: dict[int, tuple[int, Any]] = {}
        self._waiter_seq = iter(range(1, 1 << 62)).__next__
        # lease deadlines shipped by the upstream primary (standby
        # side): lease_id -> remaining seconds under the PRIMARY's
        # clock at ship time.  `promote()` re-arms each lease with
        # min(shipped remaining, ttl) — never a fresh full TTL, so a
        # worker that was already half-dead before the failover stays
        # half-dead instead of being masked for another whole TTL.
        # The outage window between the last ship and the promotion is
        # deliberately NOT subtracted: holders could not have refreshed
        # through a dead primary, so the lease clock pauses with it.
        self._shipped_deadlines: dict[str, float] = {}
        self.started = time.time()
        # latest telemetry snapshot per worker (obs/aggregate.py node
        # snapshots piggybacked on lease refreshes).  Deliberately
        # EPHEMERAL: not replicated, not evented — after a failover the
        # map refills within one heartbeat interval, which is exactly
        # the staleness the data had anyway
        self._telemetry: dict[str, dict] = {}
        # the shared result tier: raw numpy snapshots, tagged by the
        # tables they scanned so invalidate(table) drops exactly them
        self.results = CacheStore(
            result_cache_bytes, result_ttl_s, name="cluster_result"
        )

    # -- internals (lock held) --
    def _next_rev(self) -> int:
        self._rev += 1
        return self._rev

    _FLIGHT_KINDS = frozenset((
        "join", "leave", "invalidate", "lease_gone", "promoted", "view",
    ))

    def _append_event(self, kind: str, **payload) -> int:
        if kind in self._FLIGHT_KINDS:
            # lease/membership churn lands in the flight recorder (the
            # emit path is lock-free, so recording under self._lock
            # introduces no lock-order edge); scalar payload fields win
            # over the ambient term (the "promoted" event carries its own)
            attrs = {"term": self.term}
            attrs.update(
                (k, v) for k, v in payload.items()
                if isinstance(v, (str, int, float, bool))
            )
            recorder.record(f"cluster.{kind}", **attrs)
        rev = self._next_rev()
        self._events.append(
            {"rev": rev, "kind": kind, "term": self.term, **payload}
        )
        if len(self._events) > _EVENT_LOG_CAP:
            del self._events[0]
        if self._events:
            self._events_floor = self._events[0]["rev"]
        if kind in CLIENT_EVENT_KINDS:
            # watchers only unpark for client-visible kinds; waking
            # every parked handler thread per shared-tier publication
            # or lease grant would be F wakeups + F log scans for
            # nothing (standbys pull — they never park here)
            self._last_client_rev = rev
            self._watch_cond.notify_all()
            self._fire_async_waiters(rev)
        return rev

    def _fire_async_waiters(self, rev: int) -> None:
        # lock held; notify callbacks are cheap by contract (call_soon)
        if not self._async_waiters:
            return
        fired = [t for t, (s, _fn) in self._async_waiters.items() if rev > s]
        for token in fired:
            _, fn = self._async_waiters.pop(token)
            try:
                fn()
            except Exception:  # noqa: BLE001 — a dead watcher must not block the append
                METRICS.add("cluster.watch_notify_errors")

    def _is_member_key(self, key: str) -> bool:
        return key.startswith("workers/")

    def _drop_key(self, key: str, reason: str) -> None:
        entry = self._kv.pop(key, None)
        if entry is None:
            return
        if entry.lease is not None:
            lease = self._leases.get(entry.lease)
            if lease is not None:
                lease.keys.discard(key)
        if self._is_member_key(key):
            self._epoch += 1
            self._telemetry.pop(key.split("/", 1)[1], None)
            self._append_event(
                "leave", key=key, addr=key.split("/", 1)[1], reason=reason
            )
            METRICS.add("cluster.members_left")

    def _expire(self, now: float) -> None:
        dead = [l for l in self._leases.values() if now >= l.expires]
        for lease in dead:
            for key in sorted(lease.keys):
                lease.keys.discard(key)
                self._drop_key(key, "lease_expired")
            del self._leases[lease.lease_id]
            # non-member lease keys leave no per-key event; the
            # lease_gone event lets a standby drop them too
            self._append_event(
                "lease_gone", lease=lease.lease_id, reason="lease_expired"
            )
            METRICS.add("cluster.leases_expired")

    # -- leases --
    def lease_grant(self, ttl_s: float, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        if ttl_s <= 0:
            raise ValueError(f"lease ttl must be positive, got {ttl_s}")
        lease_id = uuid.uuid4().hex[:16]
        with self._lock:
            self._expire(now)
            self._leases[lease_id] = _Lease(lease_id, float(ttl_s), now)
            self._append_event("lease_grant", lease=lease_id,
                               ttl_s=float(ttl_s))
            METRICS.add("cluster.leases_granted")
            # a fresh registrant has no cache to invalidate: it resumes
            # the event log from *here*, not from history
            return {"lease": lease_id, "ttl_s": float(ttl_s),
                    "rev": self._rev, "term": self.term}

    def lease_refresh(self, lease_id: str, since: Optional[int] = None,
                      now: Optional[float] = None,
                      telemetry: Optional[dict] = None) -> dict:
        """Renew a lease; one round trip also returns the epoch and the
        event-log tail past `since` (the worker-heartbeat piggyback),
        and accepts the worker's `telemetry` node snapshot — the same
        heartbeat that keeps the lease alive feeds the coordinator-side
        fleet aggregation, zero extra round trips."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            lease = self._leases.get(lease_id)
            if lease is None:
                return {"found": False, "epoch": self._epoch,
                        "rev": self._rev, "term": self.term}
            lease.expires = now + lease.ttl_s
            for key in lease.keys:
                entry = self._kv.get(key)
                if entry is not None:
                    entry.refreshed = now
                if telemetry is not None and self._is_member_key(key):
                    self._telemetry[key.split("/", 1)[1]] = telemetry
            out: dict = {"found": True, "epoch": self._epoch,
                         "rev": self._rev, "term": self.term}
            if since is not None:
                out.update(self._events_since(since, CLIENT_EVENT_KINDS))
            return out

    def telemetry(self, now: Optional[float] = None) -> dict:
        """Latest piggybacked node snapshot per live worker (a worker
        whose membership key is gone drops out with it)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            live = {
                k.split("/", 1)[1]
                for k in self._kv if self._is_member_key(k)
            }
            return {
                addr: snap for addr, snap in self._telemetry.items()
                if addr in live
            }

    def lease_revoke(self, lease_id: str, now: Optional[float] = None) -> bool:
        """Explicit deregistration: drop the lease and its keys NOW
        (clean shutdown beats waiting out the TTL)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return False
            for key in sorted(lease.keys):
                self._drop_key(key, "lease_revoked")
            self._append_event(
                "lease_gone", lease=lease_id, reason="lease_revoked"
            )
            return True

    # -- KV --
    def put(self, key: str, value: Any, lease: Optional[str] = None,
            now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            if lease is not None and lease not in self._leases:
                raise KeyError(f"unknown lease {lease!r}")
            joined = self._is_member_key(key) and key not in self._kv
            entry = _Key(value, lease, self._next_rev(), now)
            old = self._kv.get(key)
            if old is not None and old.lease not in (None, lease):
                stale = self._leases.get(old.lease)
                if stale is not None:
                    stale.keys.discard(key)
            self._kv[key] = entry
            if lease is not None:
                self._leases[lease].keys.add(key)
            if joined:
                self._epoch += 1
                self._append_event(
                    "join", key=key, addr=key.split("/", 1)[1],
                    value=value, lease=lease,
                )
                METRICS.add("cluster.members_joined")
            else:
                # updates and non-member keys replicate via "put"
                self._append_event("put", key=key, value=value, lease=lease)
            return entry.rev

    def get(self, key: str, now: Optional[float] = None) -> Optional[Any]:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            entry = self._kv.get(key)
            return None if entry is None else entry.value

    def delete(self, key: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            if key not in self._kv:
                return False
            self._drop_key(key, "deleted")  # member keys emit "leave"
            if not self._is_member_key(key):
                self._append_event("delete", key=key)
            return True

    def range(self, prefix: str, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            return {
                k: e.value for k, e in self._kv.items() if k.startswith(prefix)
            }

    # -- membership --
    def _membership(self, now: float) -> dict:
        # lock held
        workers = {}
        for key, entry in self._kv.items():
            if not self._is_member_key(key):
                continue
            info = dict(entry.value) if isinstance(entry.value, dict) else {}
            info["lease_age_s"] = round(now - entry.refreshed, 3)
            workers[key.split("/", 1)[1]] = info
        return {"epoch": self._epoch, "rev": self._rev, "term": self.term,
                "workers": workers}

    def membership(self, now: Optional[float] = None) -> dict:
        """The shared view coordinators subscribe to: the epoch plus
        every live worker with its lease age (seconds since the owning
        lease last refreshed)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            return self._membership(now)

    # -- events / invalidation / watches --
    def _events_since(self, since: int, kinds=None) -> dict:
        # lock held
        events = [e for e in self._events if e["rev"] > since]
        if kinds is not None:
            events = [e for e in events if e["kind"] in kinds]
        out = {"events": events, "rev": self._rev}
        if since and since + 1 < self._events_floor:
            # consumer fell off the retained window: it missed events it
            # can never fetch, so it must resync (drop caches) instead
            # of silently continuing
            out["truncated"] = True
        return out

    def events_since(self, since: int, now: Optional[float] = None,
                     kinds=CLIENT_EVENT_KINDS) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            return self._events_since(since, kinds)

    def watch(self, since: int, timeout_s: float,
              now: Optional[float] = None, resume=None) -> dict:
        """Long-poll push watch: park until a client-visible event past
        `since` lands (or `timeout_s` lapses), then answer with the
        event tail AND the current membership in one response — a
        watcher learns of a join/leave one round trip after it happens
        instead of one poll interval later.  `resume` is the previous
        answer's resumption token (see `_stamp_resume`)."""
        timeout_s = max(0.0, min(float(timeout_s), _WATCH_TIMEOUT_CAP_S))

        def pending() -> bool:
            if since and since + 1 < self._events_floor:
                return True  # truncated: answer now, the client resyncs
            # O(1): every wakeup holds the global state lock, so a log
            # scan here would serialize W watchers x 1024 entries
            # against every KV/lease request
            return self._last_client_rev > since

        with self._watch_cond:
            self._expire(time.monotonic() if now is None else now)
            fired = self._watch_cond.wait_for(pending, timeout=timeout_s)
            # a lease may have lapsed while we were parked and nothing
            # else swept it: expire at wake so the timeout path still
            # notices silent deaths
            wake = time.monotonic() if now is None else now
            self._expire(wake)
            out = self._watch_answer(since, wake, resume)
            out["fired"] = bool(fired or out["events"])
            return out

    # -- event-loop watches (no parked thread) --
    def _watch_answer(self, since: int, now: float, resume=None) -> dict:
        # lock held: the same tail+membership payload `watch` builds
        out = self._events_since(since, CLIENT_EVENT_KINDS)
        out.update(self._membership(now))
        out["fired"] = bool(out["events"])
        self._stamp_resume(out, resume)
        return out

    def _stamp_resume(self, out: dict, resume) -> None:
        """Resumption-token half of the watch protocol: every answer
        carries ``resume = {term, rev}`` — the log position this answer
        is complete up to.  A watcher that failed over mid-park replays
        the token on its next watch; ``resumed: True`` is this node's
        PROOF the watcher missed nothing (every revision past the
        token is still in the retained log of a node whose log is at
        least as new — quorum election guarantees the promoted log
        holds every acked revision).  ``resumed: False`` means the
        proof fails (token past our head, from a newer term than ours,
        or truncated past the retained window): the watcher must
        resync its derived state instead of silently continuing."""
        out["resume"] = {"term": self.term, "rev": self._rev}
        if resume is None:
            return
        ok = self._resume_ok(resume)
        out["resumed"] = ok
        METRICS.add("cluster.watch_resumed" if ok
                    else "cluster.watch_resyncs")

    def _resume_ok(self, resume) -> bool:
        if not isinstance(resume, dict):
            return False
        try:
            rev = int(resume.get("rev", -1))
            term = int(resume.get("term", 0))
        except (TypeError, ValueError):
            return False
        if rev < 0 or rev > self._rev:
            return False  # we hold LESS history than the watcher saw
        if term > self.term:
            return False  # token minted under a newer leadership
        if term < self.term:
            # older-term token: provable only up to the revision this
            # node contiguously held when IT last promoted — a lagging
            # promoted log re-bumps the counter without ever holding
            # the missed events, so a bare rev compare would lie
            floor = getattr(self, "_resume_floor", None)
            if floor is not None and rev > floor:
                return False
        if rev + 1 < self._events_floor:
            # gap: events past the token truncated out of the window.
            # Checked for rev 0 too — unlike `since=0` event reads
            # (which MEAN "from scratch"), a rev-0 resume token claims
            # "I have seen everything through revision 0", and events
            # 1..floor-1 are unreplayable, so the proof fails
            return False
        return True

    def watch_async(self, since: int, notify,
                    now: Optional[float] = None, resume=None):
        """The selector server's watch half: answer immediately when a
        client-visible event past `since` (or a truncation) is already
        pending — returns ``(response, None)`` — else park by
        registering `notify` and return ``(None, token)``.  `notify`
        fires at most once, under the state lock, when such an event
        lands; the CALLER owns the timeout (fire `watch_answer` on
        expiry and `cancel_watch(token)`).  This is what lets thousands
        of parked long-polls cost a file descriptor each instead of a
        thread each."""
        now = time.monotonic() if now is None else now
        since = int(since)
        with self._lock:
            self._expire(now)
            if (since and since + 1 < self._events_floor) \
                    or self._last_client_rev > since:
                return self._watch_answer(since, now, resume), None
            token = self._waiter_seq()
            self._async_waiters[token] = (since, notify)
            return None, token

    def watch_answer(self, since: int, now: Optional[float] = None,
                     resume=None) -> dict:
        """The parked watch's answer (event fired or timeout lapsed)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            return self._watch_answer(int(since), now, resume)

    def cancel_watch(self, token) -> None:
        if token is None:
            return
        with self._lock:
            self._async_waiters.pop(token, None)

    def parked_watchers(self) -> int:
        with self._lock:
            return len(self._async_waiters)

    def invalidate(self, table: str, now: Optional[float] = None) -> dict:
        """Coordinator-driven cache invalidation: drop shared-tier
        results that scanned `table` and broadcast a
        ``cache/invalidate`` event for workers' fragment caches."""
        now = time.monotonic() if now is None else now
        dropped = self.results.invalidate_tag(table)
        with self._lock:
            self._expire(now)
            rev = self._append_event("invalidate", table=table)
            METRICS.add("cluster.invalidations")
            return {"rev": rev, "dropped": dropped}

    def view_advance(self, name: str, revision: int,
                     now: Optional[float] = None) -> dict:
        """Materialized-view revision broadcast (the ingest plane's
        freshness signal): record the view's newest revision under
        ``views/<name>`` so late joiners can read it, and emit a
        client-visible ``view`` event so subscribers parked on `watch`
        wake with the advance — with resumption-token proof that no
        revision was skipped, exactly like invalidations."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            key = f"views/{name}"
            self._kv[key] = _Key(int(revision), None, self._next_rev(), now)
            rev = self._append_event(
                "view", key=key, value=int(revision),
                name=name, revision=int(revision),
            )
            METRICS.add("cluster.view_advances")
            return {"rev": rev, "revision": int(revision)}

    # -- shared result tier --
    def result_put(self, fingerprint: str, value: dict, nbytes: int,
                   tables: tuple = ()) -> bool:
        stored = self.results.put(
            f"cache/result/{fingerprint}", value, nbytes, tags=tables
        )
        if stored:
            with self._lock:
                self._append_event(
                    "result_put", key=fingerprint, nbytes=int(nbytes),
                    tables=list(tables),
                )
        return stored

    def result_get(self, fingerprint: str) -> Optional[dict]:
        return self.results.get(f"cache/result/{fingerprint}")

    def result_put_delta(self, fingerprint: str, digests: list,
                         segments: dict, meta: dict, nbytes: int,
                         tables: tuple = ()) -> dict:
        """Delta republish: the publisher ships per-column digests plus
        ONLY the changed columns' bytes (`segments`: index -> array);
        unchanged columns are reused from the stored entry when its
        digest matches.  Any miss (no previous entry, digest mismatch
        on an unshipped column, shape drift) answers ``need_full`` and
        the publisher falls back to a full snapshot — correctness never
        rides the delta path.  The assembled entry stores and
        replicates exactly like a full ``result_put``."""
        prev = self.results.peek(f"cache/result/{fingerprint}")
        prev_snap = prev.get("snapshot") if isinstance(prev, dict) else None
        prev_digs = prev.get("digests") if isinstance(prev, dict) else None
        digests = [str(d) for d in digests]
        columns = []
        for i, dig in enumerate(digests):
            seg = segments.get(i, segments.get(str(i)))
            if seg is not None:
                columns.append(seg)
            elif (isinstance(prev_snap, dict) and isinstance(prev_digs, list)
                    and i < len(prev_digs) and prev_digs[i] == dig
                    and i < len(prev_snap.get("columns", []))):
                columns.append(prev_snap["columns"][i])
            else:
                METRICS.add("cluster.result_delta_misses")
                return {"stored": False, "need_full": True}
        snapshot = {**meta, "columns": columns}
        value = {"snapshot": snapshot, "tables": list(tables),
                 "digests": digests}
        METRICS.add("cluster.result_delta_puts")
        return {"stored": self.result_put(fingerprint, value, nbytes,
                                          tables)}

    # -- replication (log shipping + snapshots) --
    def apply_event(self, ev: dict, value: Any = None,
                    now: Optional[float] = None) -> bool:
        """Apply one replicated event verbatim: state transitions mirror
        the primary's, the event lands in OUR log under ITS revision
        (so post-promotion consumers resume seamlessly), and leases get
        an infinite local expiry — the primary decides lease life; a
        standby never expires one on its own clock (`promote()` re-arms
        them all when this replica takes over).  `value` carries the
        out-of-band payload for ``result_put`` events.

        Idempotent by revision AND serialized (`_apply_lock`): a
        synchronous quorum push and the pull loop may race the same
        tail, and a replay must never double-apply, duplicate the log,
        or re-order the result-tier side effects around a later
        invalidation."""
        with self._apply_lock:
            return self._apply_event_locked(ev, value, now)

    def _apply_event_locked(self, ev: dict, value: Any,
                            now: Optional[float]) -> bool:
        # _apply_lock held
        now = time.monotonic() if now is None else now
        with self._lock:
            if int(ev["rev"]) <= self._rev:
                return False
        kind = ev.get("kind")
        if kind == "invalidate":
            self.results.invalidate_tag(str(ev.get("table", "")))
        elif kind == "result_put" and value is not None:
            self.results.put(
                f"cache/result/{ev['key']}", value, int(ev.get("nbytes", 0)),
                tags=tuple(ev.get("tables") or ()),
            )
        with self._lock:
            if int(ev["rev"]) <= self._rev:
                return False  # a racing push/pull applied it first
            if kind == "lease_grant":
                lease = _Lease(ev["lease"], float(ev.get("ttl_s", 10.0)), now)
                lease.expires = math.inf
                self._leases[ev["lease"]] = lease
            elif kind == "lease_gone":
                lease = self._leases.pop(ev["lease"], None)
                if lease is not None:
                    for key in sorted(lease.keys):
                        entry = self._kv.get(key)
                        if entry is not None and entry.lease == ev["lease"]:
                            del self._kv[key]
            elif kind in ("join", "put", "view"):
                key = ev["key"]
                joined = self._is_member_key(key) and key not in self._kv
                entry = _Key(ev.get("value"), ev.get("lease"), ev["rev"], now)
                self._kv[key] = entry
                if entry.lease is not None:
                    lease = self._leases.get(entry.lease)
                    if lease is None:
                        # grant fell off the shipped tail (shouldn't
                        # happen in-order, but never KeyError on replay)
                        lease = _Lease(entry.lease, 10.0, now)
                        lease.expires = math.inf
                        self._leases[entry.lease] = lease
                    lease.keys.add(key)
                if joined:
                    self._epoch += 1
            elif kind in ("leave", "delete"):
                key = ev["key"]
                entry = self._kv.pop(key, None)
                if entry is not None:
                    if entry.lease is not None:
                        lease = self._leases.get(entry.lease)
                        if lease is not None:
                            lease.keys.discard(key)
                    if self._is_member_key(key):
                        self._epoch += 1
            # every event carries its writer's term ("promoted" included)
            self.term = max(self.term, int(ev.get("term", 0)))
            self._rev = max(self._rev, int(ev["rev"]))
            self._events.append(ev)
            if len(self._events) > _EVENT_LOG_CAP:
                del self._events[0]
            if self._events:
                self._events_floor = self._events[0]["rev"]
            if kind in CLIENT_EVENT_KINDS:
                self._last_client_rev = max(
                    self._last_client_rev, int(ev["rev"])
                )
                self._watch_cond.notify_all()
                self._fire_async_waiters(self._last_client_rev)
        return True

    def snapshot_state(self) -> dict:
        """Full-state snapshot for standby catch-up past the retained
        log window (result values ride separately — the transport
        decides how to encode the arrays)."""
        with self._lock:
            snap = {
                "term": self.term,
                "epoch": self._epoch,
                "rev": self._rev,
                "events": [dict(e) for e in self._events],
                "events_floor": self._events_floor,
                "leases": [
                    {"lease": l.lease_id, "ttl_s": l.ttl_s}
                    for l in self._leases.values()
                ],
                "kv": [
                    {"key": k, "value": e.value, "lease": e.lease,
                     "rev": e.rev}
                    for k, e in self._kv.items()
                ],
            }
        snap["results"] = [
            {"key": k, "value": v, "nbytes": n, "tables": list(tags)}
            for k, v, n, tags in self.results.export_entries()
        ]
        return snap

    def apply_snapshot(self, snap: dict, now: Optional[float] = None) -> None:
        """Replace this replica's entire state with a primary snapshot
        (leases arrive with infinite local expiry, exactly like
        event-applied ones).  Serialized with `apply_event` so an
        in-flight tail apply cannot interleave its side effects with
        the wholesale replacement."""
        with self._apply_lock:
            self._apply_snapshot_locked(snap, now)

    def _apply_snapshot_locked(self, snap: dict,
                               now: Optional[float]) -> None:
        # _apply_lock held
        now = time.monotonic() if now is None else now
        with self._lock:
            self._kv.clear()
            self._leases.clear()
            self.term = max(self.term, int(snap.get("term", 1)))
            self._epoch = int(snap.get("epoch", 0))
            self._rev = int(snap.get("rev", 0))
            self._events = [dict(e) for e in snap.get("events", [])]
            self._events_floor = int(snap.get("events_floor", 0))
            self._last_client_rev = max(
                (e["rev"] for e in self._events
                 if e.get("kind") in CLIENT_EVENT_KINDS),
                default=0,
            )
            for spec in snap.get("leases", []):
                lease = _Lease(spec["lease"], float(spec["ttl_s"]), now)
                lease.expires = math.inf
                self._leases[lease.lease_id] = lease
            for spec in snap.get("kv", []):
                entry = _Key(spec.get("value"), spec.get("lease"),
                             int(spec.get("rev", 0)), now)
                self._kv[spec["key"]] = entry
                if entry.lease is not None and entry.lease in self._leases:
                    self._leases[entry.lease].keys.add(spec["key"])
            self._watch_cond.notify_all()
        self.results.clear()
        for spec in snap.get("results", []):
            self.results.put(
                spec["key"], spec["value"], int(spec.get("nbytes", 0)),
                tags=tuple(spec.get("tables") or ()),
            )

    def lease_deadlines(self, now: Optional[float] = None) -> dict:
        """Primary side of deadline shipping: remaining seconds per
        live lease under THIS clock.  Rides every replication pull
        response and quorum push so a promoting standby re-arms each
        lease with its true remaining budget instead of a fresh TTL.
        Leases at infinite local expiry (a standby's replicas of
        upstream leases) are omitted — this node knows nothing about
        their real deadlines."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._expire(now)
            return {
                l.lease_id: round(max(0.0, l.expires - now), 3)
                for l in self._leases.values()
                if l.expires != math.inf
            }

    def note_lease_deadlines(self, deadlines) -> None:
        """Standby side: remember the primary's latest shipped
        remaining deadlines (consulted once, at promotion)."""
        if not isinstance(deadlines, dict):
            return
        clean = {}
        for k, v in deadlines.items():
            try:
                clean[str(k)] = max(0.0, float(v))
            except (TypeError, ValueError):
                continue
        with self._lock:
            self._shipped_deadlines = clean

    def promote(self, new_term: int, now: Optional[float] = None) -> None:
        """This replica takes over as primary: adopt the new term,
        re-arm every replicated lease with its SHIPPED remaining
        deadline (capped at the TTL; the outage window is not charged
        to holders — they could not have refreshed through a dead
        primary), and log the term change so it ships to any remaining
        standbys.  A lease whose deadline was never shipped (legacy
        upstream) falls back to the full-TTL re-arm; a lease whose
        shipped remaining already reached zero expires on the next
        sweep instead of being silently revived — a worker that was
        already dead before the failover must not be masked for
        another whole TTL."""
        now = time.monotonic() if now is None else now
        with self._lock:
            # resume-proof floor: everything at or below THIS revision
            # is contiguously in our log from the pre-promotion
            # lineage; an older-term watch token above it names events
            # we cannot prove we hold (see `_resume_ok`)
            self._resume_floor = self._rev
            self.term = max(self.term + 1, int(new_term))
            shipped = self._shipped_deadlines
            for lease in self._leases.values():
                remaining = shipped.get(lease.lease_id)
                if remaining is None:
                    remaining = lease.ttl_s
                lease.expires = now + min(max(0.0, float(remaining)),
                                          lease.ttl_s)
                for key in lease.keys:
                    entry = self._kv.get(key)
                    if entry is not None:
                        entry.refreshed = now
            self._shipped_deadlines = {}
            self._append_event("promoted", term=self.term)

    def rearm_leases(self, deadlines, now: Optional[float] = None) -> None:
        """Recovery-side lease re-arm — the restart sibling of
        `promote()`'s failover re-arm.  WAL replay applies leases with
        infinite local expiry (like any replica); this gives each one
        its PERSISTED remaining deadline back, capped at the TTL and
        never a fresh full TTL, so a lease that was already dead (or
        dying) before the crash expires on the first sweep after it
        instead of masking a dead worker for another whole TTL.  A
        lease with no persisted deadline (granted after the last
        deadline note made it to disk) falls back to the full-TTL arm —
        the WAL's note cadence bounds that window."""
        now = time.monotonic() if now is None else now
        clean = {}
        for k, v in (deadlines or {}).items():
            try:
                clean[str(k)] = max(0.0, float(v))
            except (TypeError, ValueError):
                continue
        with self._lock:
            for lease in self._leases.values():
                remaining = clean.get(lease.lease_id)
                if remaining is None:
                    remaining = lease.ttl_s
                lease.expires = now + min(remaining, lease.ttl_s)
                for key in lease.keys:
                    entry = self._kv.get(key)
                    if entry is not None:
                        entry.refreshed = now

    # -- introspection --
    def gauges(self) -> dict:
        with self._lock:
            out = {
                "cluster.epoch": self._epoch,
                "cluster.rev": self._rev,
                "cluster.term": self.term,
                "cluster.leases": len(self._leases),
                "cluster.members": sum(
                    1 for k in self._kv if self._is_member_key(k)
                ),
                # total pin fingerprints the fleet advertises (QoS pin
                # placement; 0 with QoS off — no member puts any)
                "cluster.pins_advertised": sum(
                    len(e.value.get("pins") or ())
                    for k, e in self._kv.items()
                    if self._is_member_key(k) and isinstance(e.value, dict)
                ),
                "cluster.telemetry_nodes": len(self._telemetry),
                "cluster.watch_parked": len(self._async_waiters),
            }
        out.update(self.results.gauges())
        return out

    def status(self, now: Optional[float] = None,
               extra: Optional[dict] = None) -> dict:
        from datafusion_tpu_torch.obs.export import prometheus_text

        view = self.membership(now)
        gauges = self.gauges()
        if extra:
            gauges.update(extra)
        return {
            "type": "status",
            "uptime_s": round(time.time() - self.started, 1),
            "epoch": view["epoch"],
            "rev": view["rev"],
            "term": self.term,
            "workers": view["workers"],
            "results": self.results.stats(),
            "prometheus": prometheus_text(METRICS, extra_gauges=gauges),
        }


# -- request handling (shared by TCP handler and LocalClusterClient) ------

_MUTATING_REQUESTS = frozenset((
    "lease_grant", "lease_refresh", "lease_revoke", "kv_put", "kv_delete",
    "invalidate", "view_advance", "result_put", "result_put_delta",
))


def _encode_result_value(value, bw):
    """Service-side wire encoding for a stored result value: raw numpy
    snapshot columns become RAW binary segments (or inline base64 under
    the segment threshold); non-snapshot values pass through."""
    if isinstance(value, dict) and isinstance(value.get("snapshot"), dict) \
            and "columns" in value["snapshot"]:
        from datafusion_tpu_torch.cluster.shared_cache import raw_to_wire

        return {**value, "snapshot": raw_to_wire(value["snapshot"], bw)}
    return value


def _decode_result_value(value):
    """Inverse of `_encode_result_value`: normalize an arriving result
    value to the canonical raw-numpy storage form."""
    if isinstance(value, dict) and isinstance(value.get("snapshot"), dict) \
            and "columns" in value["snapshot"]:
        from datafusion_tpu_torch.cluster.shared_cache import wire_to_raw

        return {**value, "snapshot": wire_to_raw(value["snapshot"])}
    return value


def apply_request(state: ClusterState, msg: dict, bw=None) -> dict:
    """One request -> one response against the raw state machine
    (fencing and replication live one layer up in `ClusterNode`)."""
    kind = msg.get("type")
    if kind == "ping":
        return {"type": "pong", "epoch": state.membership()["epoch"]}
    if kind == "lease_grant":
        out = state.lease_grant(float(msg["ttl_s"]))
        return {"type": "lease", **out}
    if kind == "lease_refresh":
        out = state.lease_refresh(msg["lease"], since=msg.get("since"),
                                  telemetry=msg.get("telemetry"))
        return {"type": "lease", **out}
    if kind == "lease_revoke":
        return {"type": "ok", "found": state.lease_revoke(msg["lease"])}
    if kind == "kv_put":
        rev = state.put(msg["key"], msg.get("value"), lease=msg.get("lease"))
        return {"type": "ok", "rev": rev}
    if kind == "kv_get":
        value = state.get(msg["key"])
        return {"type": "kv", "found": value is not None, "value": value}
    if kind == "kv_delete":
        return {"type": "ok", "found": state.delete(msg["key"])}
    if kind == "kv_range":
        return {"type": "kv", "items": state.range(msg.get("prefix", ""))}
    if kind == "membership":
        return {"type": "membership", **state.membership()}
    if kind == "events":
        return {"type": "events", **state.events_since(int(msg.get("since", 0)))}
    if kind == "watch":
        out = state.watch(int(msg.get("since", 0)),
                          float(msg.get("timeout_s", 10.0)),
                          resume=msg.get("resume"))
        return {"type": "watch", **out}
    if kind == "invalidate":
        return {"type": "ok", **state.invalidate(msg["table"])}
    if kind == "view_advance":
        return {"type": "ok", **state.view_advance(
            msg["name"], int(msg.get("revision", 0)))}
    if kind == "result_put":
        stored = state.result_put(
            msg["key"], _decode_result_value(msg["value"]),
            int(msg["nbytes"]), tuple(msg.get("tables") or ()),
        )
        return {"type": "ok", "stored": stored}
    if kind == "result_put_delta":
        from datafusion_tpu_torch.cluster.shared_cache import _as_array

        segments = {
            int(i): _as_array(seg)
            for i, seg in (msg.get("segments") or {}).items()
        }
        meta = {
            "validity": [
                None if v is None else _as_array(v)
                for v in (msg.get("validity") or [])
            ],
            "dict_values": msg.get("dict_values") or [],
            "num_rows": int(msg.get("num_rows", 0)),
            "nbytes": int(msg.get("nbytes", 0)),
        }
        out = state.result_put_delta(
            msg["key"], msg.get("digests") or [], segments, meta,
            int(msg["nbytes"]), tuple(msg.get("tables") or ()),
        )
        return {"type": "ok", **out}
    if kind == "result_get":
        value = state.result_get(msg["key"])
        out = {"type": "kv", "found": value is not None}
        if value is not None:
            out["value"] = _encode_result_value(value, bw) if bw is not None \
                else value
        return out
    if kind == "telemetry":
        return {"type": "telemetry", "workers": state.telemetry()}
    if kind == "status":
        return state.status()
    return {"type": "error", "message": f"unknown request {kind!r}"}


class _ReplicaLink:
    """The primary's push channel to one replica: last acked revision
    plus a lock serializing pushes (concurrent mutations must not
    interleave their tails on one link)."""

    __slots__ = ("target", "acked_rev", "errors", "last_error_at",
                 "lock", "_client")

    def __init__(self, target):
        self.target = target  # addr string or ClusterNode
        self.acked_rev = 0
        self.errors = 0
        self.last_error_at: Optional[float] = None
        # plain, as in the JAX package: a replication round holds it
        # across its push to the replica by design (commits batch
        # behind it), so a lock-order name would record each round trip
        self.lock = threading.Lock()
        self._client = None

    @property
    def name(self) -> str:
        return getattr(self.target, "addr", None) or str(self.target)

    def cooling(self, now: float, cooldown_s: float) -> bool:
        """Recently-failed links sit out quorum rounds for a cooldown
        (they are only dialed when the healthy links cannot reach
        quorum alone) so one dead replica costs each write at most one
        fast skip, not a connect timeout — the pull loop re-syncs it
        when it returns, and the first post-cooldown push re-probes."""
        return (self.last_error_at is not None
                and now - self.last_error_at < cooldown_s)

    def client(self):
        if self._client is None:
            from datafusion_tpu_torch import cluster as _cluster

            self._client = _cluster.connect(self.target)
        return self._client

    def request_once(self, msg: dict, bw=None, timeout: float = 2.5) -> dict:
        """ONE attempt against the replica — no failover sweep, no
        backoff sleeps: a dead replica must cost the quorum commit one
        fast failure, not a retry loop on the write path."""
        return self.client()._request_endpoint(0, msg, timeout, bw)


class ClusterNode:
    """One service replica: a `ClusterState` plus a replication role.

    A **primary** serves every request (replication pulls included)
    and stamps its term on every mutation.  A **standby** serves only
    `ping`/`status` and the peer term exchange — regular reads and
    writes AND replication pulls are answered with a ``not_primary``
    redirect (carrying the upstream hint) so multi-endpoint clients
    fail over and downstream standbys chase the real primary instead
    of tailing a deposed one — while a control loop tails the
    primary's event log (`replicate_once`), falls back to a full-state
    snapshot after log truncation, and promotes itself when the primary
    has been silent past the election timeout (`maybe_promote` — the
    lease-based election: leadership is a lease the primary keeps alive
    by answering pulls).  Term fencing closes the split-brain window: a
    revived old primary is demoted on its first replication or peer
    exchange with a higher-term node, and any write carrying an
    explicitly stale term is rejected outright.

    **Replica sets** (3+ nodes): configure every node with the full
    `peers` list, a succession `rank` (0 = first in line; each rank
    waits half an election timeout longer, so successors don't race),
    and a `write_quorum` W.  With W > 1 the primary *synchronously
    pushes* every mutation's log tail to its peers and acknowledges the
    client only after W replicas (itself included) hold the events —
    an acked write can no longer die with a SIGKILL'd primary.  A
    candidate's election first polls its peers: it needs
    ``N - W + 1`` reachable nodes (quorum intersection — some reachable
    node holds every acked write), aborts on any higher term or live
    primary, and catches up from the highest-revision responder BEFORE
    promoting, so the promoted log contains every acknowledged
    revision.  The pull loop stays on as catch-up for replicas that
    miss pushes, with snapshot resync past the log window.

    Every method takes an injectable `now` so failover tests run
    without sleeping; `partitioned` simulates an unreachable node for
    in-process chaos (the local client raises the same
    `ConnectionRefusedError` a dead TCP endpoint would)."""

    def __init__(self, state: Optional[ClusterState] = None,
                 addr: Optional[str] = None,
                 standby_of=None, peers=(),
                 election_timeout_s: Optional[float] = None,
                 replicate_interval_s: Optional[float] = None,
                 replicas=(), write_quorum: Optional[int] = None,
                 rank: int = 0, wal_dir: Optional[str] = None):
        from datafusion_tpu_torch import cluster as _cluster

        self.state = state or ClusterState()
        self.addr = addr
        self.role = "standby" if standby_of is not None else "primary"
        self.standby_of = standby_of  # upstream: addr string or ClusterNode
        self.peers = [p for p in peers if p]
        if election_timeout_s is None:
            election_timeout_s = _cluster.election_timeout_s()
        self.election_timeout_s = float(election_timeout_s)
        if replicate_interval_s is None:
            replicate_interval_s = max(0.05, self.election_timeout_s / 5.0)
        self.replicate_interval_s = float(replicate_interval_s)
        # replica set: push targets (addr strings or ClusterNodes).
        # Empty + write_quorum > 1 derives them from `peers` at push
        # time, so a freshly promoted node starts pushing with zero
        # reconfiguration.
        self.replicas = [r for r in replicas if r is not None]
        if write_quorum is None:
            write_quorum = _cluster.write_quorum()
        self.write_quorum = max(1, int(write_quorum))
        self.rank = max(0, int(rank))
        self.partitioned = False
        self.promotions = 0
        self.step_downs = 0
        self.elections_deferred = 0
        self.snapshots_applied = 0
        # durability (default OFF: no WAL dir means every hook below is
        # a None test — byte-identical to the in-memory control plane)
        self.wal = None
        self.recovered_revisions = 0
        if wal_dir is None:
            wal_dir = os.environ.get("DATAFUSION_TPU_WAL_DIR") or None
        if wal_dir:
            from datafusion_tpu_torch.utils.wal import WriteAheadLog

            self.wal = WriteAheadLog(wal_dir)
            self._recover_from_wal()
        self.primary_rev = self.state._rev  # last rev observed upstream
        self.last_primary_contact = time.monotonic()
        self._force_snapshot = False
        self._upstream_client = None
        self._links: dict = {}  # push-target identity -> _ReplicaLink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def term(self) -> int:
        return self.state.term

    def __repr__(self):
        return (f"ClusterNode({self.addr or 'in-process'}, {self.role}, "
                f"term={self.term})")

    # -- request surface --
    def handle_request(self, msg: dict, bw=None) -> dict:
        kind = msg.get("type")
        if kind == "peer_status":
            return self._serve_peer_status(msg)
        if kind == "replicate_pull":
            return self._serve_pull(msg, bw)
        if kind == "replicate_push":
            return self._serve_push(msg)
        if kind == "ping":
            return {"type": "pong", "role": self.role, "term": self.term,
                    "epoch": self.state.membership()["epoch"]}
        if kind == "status":
            return self.status()
        if self.role != "primary":
            return self._not_primary_reply()
        claimed = msg.get("term")
        if claimed is not None and kind in _MUTATING_REQUESTS \
                and int(claimed) < self.term:
            METRICS.add("cluster.stale_term_writes_rejected")
            return {
                "type": "error", "code": "stale_term", "term": self.term,
                "message": f"write fenced: term {claimed} is stale "
                           f"(current term {self.term})",
            }
        rev_before = self.state._rev
        out = apply_request(self.state, msg, bw)
        if self.wal is not None and self.state._rev > rev_before:
            # durability BEFORE acknowledgement (and before the quorum
            # round): the events this request appended — lazy lease
            # expiries included — must be on the log first.  A disk
            # fault refuses the ack, exactly like a lost quorum: the
            # write is applied locally but not acknowledged.
            try:
                self._wal_sync()
            except OSError as e:
                METRICS.add("cluster.wal_write_failures")
                if kind in _MUTATING_REQUESTS and \
                        out.get("type") != "error":
                    return {
                        "type": "error", "code": "wal_unavailable",
                        "term": self.term,
                        "message": (
                            f"write applied locally but could not be "
                            f"logged durably ({e}); not acknowledged — "
                            f"retry when the log recovers"
                        ),
                    }
        if (self.write_quorum > 1 and kind in _MUTATING_REQUESTS
                and out.get("type") != "error"
                and self.state._rev > rev_before):
            # the mutation appended events: it is acknowledged only
            # once a write-quorum of replicas holds them.  Reads and
            # no-op mutations (lease refreshes) skip the round trip.
            acks = self._quorum_commit(self.state._rev)
            if acks < self.write_quorum:
                METRICS.add("cluster.quorum_write_failures")
                return {
                    "type": "error", "code": "quorum_unavailable",
                    "term": self.term, "acks": acks,
                    "quorum": self.write_quorum,
                    "message": (
                        f"write applied locally but reached only "
                        f"{acks}/{self.write_quorum} replicas — not "
                        f"acknowledged; retry when the replica set "
                        f"recovers"
                    ),
                }
            METRICS.add("cluster.quorum_writes_acked")
            out = {**out, "quorum_acks": acks}
        return out

    def _primary_hint(self) -> Optional[str]:
        up = self.standby_of
        if isinstance(up, ClusterNode):
            return up.addr
        return up

    def _not_primary_reply(self, what: str = "request") -> dict:
        METRICS.add("cluster.not_primary_rejected")
        return {
            "type": "error", "code": "not_primary",
            "primary": self._primary_hint(), "term": self.term,
            "message": f"{what} refused: this replica is a standby "
                       f"(term {self.term}); primary is "
                       f"{self._primary_hint() or 'unknown'}",
        }

    def _observe_term(self, term: int, role: Optional[str], source) -> None:
        """The single fencing reaction, shared by every term exchange
        (replication pulls, peer probes, being probed): a higher term
        deposes a primary (step down toward `source`); a standby
        adopts the term — and when the higher-term peer IS the
        primary, retargets its replication at it."""
        if term <= self.term:
            return
        if self.role == "primary":
            self.step_down(source, term)
            return
        self.state.term = max(self.state.term, int(term))
        if role == "primary" and source is not None \
                and self._primary_hint() != source:
            self.retarget(source)

    # -- durability (WAL + snapshots, crash-only recovery) --
    def _recover_from_wal(self) -> None:
        """Crash-only boot: replay the newest valid snapshot plus the
        WAL tail into the state machine, then re-arm leases from their
        persisted remaining TTLs.  A recovered node is a caught-up
        standby as far as elections and `replicate_pull` are concerned:
        terms, revisions, KV, grants, and the result tier are all back,
        and the election clock starts at boot."""
        snap, events, deadlines = self.wal.recover()
        state = self.state
        if snap is not None:
            snap = dict(snap)
            snap["results"] = [
                {**spec, "value": _decode_result_value(spec.get("value"))}
                for spec in snap.get("results", [])
            ]
            state.apply_snapshot(snap)
        grant_revs: dict = {}
        for ev in events:
            value = None
            if ev.get("kind") == "result_put":
                value = _decode_result_value(ev.pop("value", None))
            elif ev.get("kind") == "lease_grant":
                grant_revs[ev.get("lease")] = int(ev.get("rev") or 0)
            state.apply_event(ev, value=value)
        # a lease the deadline set COVERS (granted at rev <= the note's
        # cutoff) but omits was already expired or revoked when the
        # note was taken: re-arm it at ZERO so the first sweep kills
        # it.  Only leases granted AFTER the cutoff (the note cadence's
        # bounded window) fall back to a full TTL.
        cutoff = self.wal.deadline_cutoff_rev
        deadlines = dict(deadlines)
        for lease_id in list(state._leases):
            if lease_id in deadlines:
                continue
            if grant_revs.get(lease_id, 0) <= cutoff:
                deadlines[lease_id] = 0.0
        state.rearm_leases(deadlines)
        self.recovered_revisions = state._rev
        if self.recovered_revisions:
            METRICS.add("cluster.recovered_revisions",
                        self.recovered_revisions)
            recorder.record("cluster.wal_recovered",
                            rev=self.recovered_revisions,
                            **self.wal.recovery)

    def _wal_sync(self) -> None:
        """Append every not-yet-logged event (plus a rate-limited
        lease-deadline note) to the WAL, and compact into a snapshot
        once the log crosses its threshold.  Runs OUTSIDE the cluster
        locks — `events_since`/`snapshot_state` copy under the state
        lock and release it before any disk IO (the DF008 contract).
        Raises OSError on disk faults: ack-bearing callers must refuse
        the ack (an unlogged write is an unacknowledged write)."""
        from datafusion_tpu_torch.parallel.wire import BinWriter

        wal = self.wal
        state = self.state
        if state._rev > wal.last_rev:
            if wal.last_rev < max(0, state._events_floor - 1):
                # the un-logged prefix fell off the retained event
                # window (WAL enabled on a warm node, or a log left
                # behind a pulled snapshot-resync): only a full
                # snapshot restores contiguous coverage
                self._wal_snapshot()
            else:
                records = []
                for ev in state.events_since(wal.last_rev,
                                             kinds=None)["events"]:
                    if ev.get("kind") == "result_put":
                        value = state.results.peek(
                            f"cache/result/{ev['key']}")
                        if value is not None:
                            bw = BinWriter()
                            ev = {**ev,
                                  "value": _encode_result_value(value, bw)}
                            records.append((ev, bw))
                            continue
                    records.append((ev, None))
                wal.append(records)
        wal.note_deadlines(state.lease_deadlines)
        if wal.should_snapshot():
            self._wal_snapshot()

    def _wal_snapshot(self) -> None:
        from datafusion_tpu_torch.parallel.wire import BinWriter

        bw = BinWriter()
        snap = self.state.snapshot_state()
        for spec in snap["results"]:
            spec["value"] = _encode_result_value(spec["value"], bw)
        # recovery re-arms from these when no later deadline note exists
        snap["lease_deadlines"] = self.state.lease_deadlines()
        self.wal.write_snapshot(snap, bw)

    def _wal_persist_best_effort(self) -> None:
        """Non-ack-bearing sync sites (pull catch-up, the control loop,
        shutdown): a disk fault here is counted, not fatal — the next
        sync retries the same tail."""
        if self.wal is None:
            return
        try:
            self._wal_sync()
        except OSError:
            METRICS.add("cluster.wal_write_failures")

    # -- replication (primary push path / quorum commit) --
    def _replica_links(self) -> list:
        """Push targets as persistent links.  Explicit `replicas` win;
        otherwise (write_quorum > 1) they derive from `peers` minus
        self — so a promoted standby starts pushing without any
        reconfiguration."""
        targets = self.replicas
        if not targets and self.write_quorum > 1:
            targets = [p for p in self.peers
                       if p is not self and p != self.addr]
        links = []
        for t in targets:
            if t is self or (isinstance(t, str) and t == self.addr):
                continue
            key = id(t) if not isinstance(t, str) else t
            link = self._links.get(key)
            if link is None:
                link = self._links[key] = _ReplicaLink(t)
            links.append(link)
        return links

    def cluster_size(self) -> int:
        """Nodes in the replica set (self + distinct peers/replicas)."""
        names = set()
        for t in list(self.peers) + list(self.replicas):
            if t is self:
                continue
            name = getattr(t, "addr", None) or (
                t if isinstance(t, str) else None
            )
            if name is None:
                name = f"node-{id(t)}"
            if name != self.addr:
                names.add(name)
        return 1 + len(names)

    @property
    def election_quorum(self) -> int:
        """Reachable nodes (self included) an election needs: with
        write quorum W over N nodes, N - W + 1 responders guarantee the
        candidate can reach SOME holder of every acked write."""
        return max(1, self.cluster_size() - self.write_quorum + 1)

    def _push_payload(self, since: int, bw=None,
                      force_snapshot: bool = False) -> dict:
        state = self.state
        msg: dict = {
            "type": "replicate_push", "term": self.term, "addr": self.addr,
            "rev": state._rev,
            # deadline shipping rides every push too: a standby that
            # promotes between pulls still holds fresh remainders
            "lease_deadlines": state.lease_deadlines(),
        }
        tail = state.events_since(since, kinds=None)
        if force_snapshot or tail.get("truncated") or \
                (since == 0 and state._rev > 0 and state._events_floor > 1):
            faults.check("cluster.snapshot", addr=self.addr)
            snap = state.snapshot_state()
            if bw is not None:
                for spec in snap["results"]:
                    spec["value"] = _encode_result_value(spec["value"], bw)
            METRICS.add("cluster.snapshots_served")
            msg["snapshot"] = snap
            return msg
        values = {}
        for ev in tail["events"]:
            if ev.get("kind") != "result_put":
                continue
            value = state.results.peek(f"cache/result/{ev['key']}")
            if value is None:
                continue  # evicted since; the replica just misses it
            values[ev["key"]] = _encode_result_value(value, bw) \
                if bw is not None else value
        msg["events"] = tail["events"]
        msg["result_values"] = values
        return msg

    def _push_to(self, link: _ReplicaLink, needed_rev: int) -> bool:
        """One synchronous push round against one replica; True when it
        acked at least `needed_rev`.  Raises on an unreachable replica
        (the quorum commit counts, never retries inline).

        **Batching under write load**: concurrent commits serialize on
        the link lock, and a push payload is built from the CURRENT
        log tail — so the round in flight while N more mutations apply
        ships THEIR events too.  A commit that acquires the lock and
        finds its revision already acked piggybacked on that round and
        skips its own (``cluster.replicate_push_piggybacked``): an
        invalidation storm pays one round trip per *batch* of
        mutations, not one per mutation.  Actual round trips count as
        ``cluster.replicate_push_rounds``."""
        from datafusion_tpu_torch.parallel.wire import BinWriter

        with link.lock:
            if link.acked_rev >= needed_rev:
                # an overlapping commit's push (payload built after our
                # events applied) already shipped and acked our tail
                METRICS.add("cluster.replicate_push_piggybacked")
                return True
            faults.check("cluster.replicate", addr=self.addr,
                         peer=link.name, push=True)
            tcp = isinstance(link.target, str)
            bw = BinWriter() if tcp else None
            METRICS.add("cluster.replicate_push_rounds")
            resp = link.request_once(
                self._push_payload(link.acked_rev, bw), bw
            )
            if resp.get("need_snapshot"):
                # the replica's log has a gap this tail cannot fill
                # (it lagged past the retained window): resync it with
                # one full snapshot, inline
                bw = BinWriter() if tcp else None
                METRICS.add("cluster.replicate_push_rounds")
                resp = link.request_once(
                    self._push_payload(link.acked_rev, bw,
                                       force_snapshot=True), bw,
                )
            link.acked_rev = int(resp.get("rev", link.acked_rev))
            return link.acked_rev >= needed_rev

    def _quorum_commit(self, needed_rev: int) -> int:
        """Push the pending tail to the replicas; returns how many
        (self included) hold revision `needed_rev`.  Healthy links go
        first; links inside their failure cooldown are dialed only if
        the healthy ones cannot reach quorum alone — a dead replica
        must not tax every write with its connect timeout.  A replica
        that rejects with a stale term triggers a peer probe — the
        usual fencing path then deposes this node."""
        from datafusion_tpu_torch.errors import ExecutionError, StaleTermError

        now = time.monotonic()
        cooldown_s = max(0.5, self.replicate_interval_s)
        links = self._replica_links()
        ordered = [l for l in links if not l.cooling(now, cooldown_s)] + \
                  [l for l in links if l.cooling(now, cooldown_s)]
        acks = 1  # this node's own log
        for link in ordered:
            if acks >= self.write_quorum and link.cooling(now, cooldown_s):
                continue  # quorum met: let the cooling replica pull-sync
            try:
                if self._push_to(link, needed_rev):
                    acks += 1
                link.last_error_at = None
            except StaleTermError:
                link.errors += 1
                link.last_error_at = now
                METRICS.add("cluster.replicate_push_errors")
                # a replica fenced our term: discover the real primary
                try:
                    self.peer_probe_once()
                except Exception:  # noqa: BLE001 — probe is best-effort here
                    pass
            except (ConnectionError, OSError, ExecutionError):
                link.errors += 1
                link.last_error_at = now
                METRICS.add("cluster.replicate_push_errors")
        return acks

    def _serve_push(self, msg: dict) -> dict:
        """Replica side of the synchronous push: apply the shipped tail
        (idempotently — the pull loop may race), record primary
        contact, ack with our revision."""
        term = int(msg.get("term", 0))
        if term < self.term:
            METRICS.add("cluster.stale_term_writes_rejected")
            return {
                "type": "error", "code": "stale_term", "term": self.term,
                "message": f"replication push fenced: term {term} is "
                           f"stale (current term {self.term})",
            }
        self._observe_term(term, "primary", msg.get("addr"))
        if self.role == "primary":
            # an equal-term peer pushing at a primary: the probe sorts
            # out who is who; we must not apply a foreign log meanwhile
            return self._not_primary_reply("replication push")
        state = self.state
        now = time.monotonic()
        applied = 0
        snap = msg.get("snapshot")
        if snap is not None:
            faults.check("cluster.snapshot", addr=self.addr)
            for spec in snap.get("results", []):
                spec["value"] = _decode_result_value(spec.get("value"))
            state.apply_snapshot(snap)
            self.snapshots_applied += 1
            self._force_snapshot = False
            METRICS.add("cluster.snapshots_applied")
            applied = -1
        else:
            events = msg.get("events") or []
            if events and int(events[0]["rev"]) > state._rev + 1:
                # a gap this push cannot fill: ask for a snapshot
                # instead of silently applying a holed log
                self._force_snapshot = True
                return {"type": "replicate_ack", "rev": state._rev,
                        "term": self.term, "need_snapshot": True}
            values = msg.get("result_values") or {}
            for ev in events:
                if state.apply_event(
                    ev,
                    value=_decode_result_value(values.get(ev.get("key"))),
                ):
                    applied += 1
            if applied:
                METRICS.add("cluster.replicated_events", applied)
        if self.wal is not None:
            # the ack below is this replica's durability vote in the
            # primary's quorum count: events must hit OUR log first,
            # and a disk fault withholds the ack
            try:
                self._wal_sync()
            except OSError as e:
                METRICS.add("cluster.wal_write_failures")
                return {
                    "type": "error", "code": "wal_unavailable",
                    "term": self.term,
                    "message": f"replica could not log the pushed tail "
                               f"durably ({e}); push not acknowledged",
                }
        state.note_lease_deadlines(msg.get("lease_deadlines"))
        self.last_primary_contact = now  # a push IS primary contact
        self.primary_rev = max(self.primary_rev, int(msg.get("rev", 0)))
        src = msg.get("addr")
        if src and self._primary_hint() != src:
            # the pusher is the (possibly new) primary: chase it
            self.retarget(src)
        return {"type": "replicate_ack", "rev": state._rev,
                "term": self.term, "applied": applied}

    # -- replication (standby side) --
    def _upstream(self):
        if self._upstream_client is None:
            from datafusion_tpu_torch.cluster.client import LocalClusterClient

            up = self.standby_of
            if isinstance(up, ClusterNode):
                self._upstream_client = LocalClusterClient(up)
            else:
                from datafusion_tpu_torch import cluster as _cluster

                self._upstream_client = _cluster.connect(up)
        return self._upstream_client

    def replicate_once(self, now: Optional[float] = None) -> int:
        """One log-shipping round: pull events (or a snapshot) from the
        upstream, apply them, and record the contact for the election
        clock.  Returns how many events were applied (-1 for a full
        snapshot).  Raises on an unreachable upstream — the control
        loop counts it and lets `maybe_promote` decide."""
        from datafusion_tpu_torch.errors import ClusterNotPrimaryError

        if self.role == "primary":
            return 0
        faults.check("cluster.replicate", addr=self.addr)
        msg = {"type": "replicate_pull", "since": self.state._rev,
               "term": self.term, "addr": self.addr}
        if self._force_snapshot:
            msg["snapshot"] = True
        try:
            resp = self._upstream().request(msg)
        except ClusterNotPrimaryError as e:
            # the upstream stepped down: chase its hint
            if e.primary and e.primary != self._primary_hint():
                self.standby_of = e.primary
                self._upstream_client = None
            raise
        now = time.monotonic() if now is None else now
        self.last_primary_contact = now
        out = self._apply_pull_response(resp)
        self._wal_persist_best_effort()
        return out

    def _apply_pull_response(self, resp: dict,
                             note_deadlines: bool = True) -> int:
        """Fold one replication-pull response into this replica;
        returns events applied (-1 for a full snapshot).  Shared by the
        pull loop and the election catch-up pull."""
        self.primary_rev = max(self.primary_rev,
                               int(resp.get("rev", self.primary_rev)))
        if resp.get("term", 0) > self.term:
            self.state.term = int(resp["term"])
        snap = resp.get("snapshot")
        if snap is not None:
            faults.check("cluster.snapshot", addr=self.addr)
            for spec in snap.get("results", []):
                spec["value"] = _decode_result_value(spec.get("value"))
            self.state.apply_snapshot(snap)
            self.snapshots_applied += 1
            self._force_snapshot = False
            METRICS.add("cluster.snapshots_applied")
            if note_deadlines:
                self.state.note_lease_deadlines(
                    resp.get("lease_deadlines")
                )
            return -1
        if int(resp.get("rev", 0)) < self.state._rev:
            # our log runs PAST the upstream's: we hold orphaned
            # revisions no primary acknowledges (writes we applied
            # during a split, or an upstream that itself lost a race).
            # One primary's history wins — resync via snapshot
            self._force_snapshot = True
            METRICS.add("cluster.replica_divergences")
            return 0
        values = resp.get("result_values") or {}
        applied = 0
        for ev in resp.get("events") or ():
            if self.state.apply_event(
                ev, value=_decode_result_value(values.get(ev.get("key"))),
            ):
                applied += 1
        if applied:
            METRICS.add("cluster.replicated_events", applied)
        if note_deadlines:
            self.state.note_lease_deadlines(resp.get("lease_deadlines"))
        return applied

    @property
    def effective_election_timeout_s(self) -> float:
        """Rank-staggered: each succession rank tolerates half an
        election timeout more silence, so the ranked successor wins
        uncontested and the others observe its new term instead of
        racing it."""
        return self.election_timeout_s * (1.0 + 0.5 * self.rank)

    def _election_poll(self, now: float):
        """Pre-promotion peer poll: term-exchange with every peer.
        Returns ``(reachable, best_rev, best_peer)``, or None when the
        election must abort (a higher term or a live primary exists —
        the exchange already adopted/retargeted)."""
        from datafusion_tpu_torch import cluster as _cluster
        from datafusion_tpu_torch.errors import ExecutionError

        reachable = 1
        best_rev, best_peer = self.state._rev, None
        # poll the same population election_quorum counts: peers AND
        # explicitly configured replicas (a node wired with replicas=
        # but no peers must still be able to win an election)
        candidates, seen = [], set()
        for peer in list(self.peers) + list(self.replicas):
            if peer is self or peer == self.addr:
                continue
            key = getattr(peer, "addr", None) or (
                peer if isinstance(peer, str) else id(peer)
            )
            if key in seen:
                continue
            seen.add(key)
            candidates.append(peer)
        for peer in candidates:
            try:
                resp = _cluster.connect(peer).request({
                    "type": "peer_status", "term": self.term,
                    "role": self.role, "addr": self.addr,
                })
            except (ConnectionError, OSError, ExecutionError):
                continue
            pterm = int(resp.get("term", 0))
            if pterm > self.term or (resp.get("role") == "primary"
                                     and pterm >= self.term):
                # a newer term, or a primary that is demonstrably alive
                # (it just answered us): abort, adopt, chase
                self._observe_term(pterm, resp.get("role"),
                                   resp.get("primary") or peer)
                self.last_primary_contact = now
                return None
            reachable += 1
            prev = int(resp.get("rev", 0))
            if prev > best_rev:
                best_rev, best_peer = prev, peer
        return reachable, best_rev, best_peer

    def _catchup_from(self, peer) -> None:
        """Adopt a higher-revision peer's log before promoting (the
        election's acked-write guarantee).  The `election` flag lets a
        fellow standby serve the pull."""
        from datafusion_tpu_torch import cluster as _cluster

        resp = _cluster.connect(peer).request({
            "type": "replicate_pull", "since": self.state._rev,
            "term": self.term, "addr": self.addr, "election": True,
        })
        applied = self._apply_pull_response(resp, note_deadlines=False)
        if self._force_snapshot and applied == 0:
            # diverged from the best responder: take its snapshot now
            resp = _cluster.connect(peer).request({
                "type": "replicate_pull", "since": self.state._rev,
                "term": self.term, "addr": self.addr, "election": True,
                "snapshot": True,
            })
            self._apply_pull_response(resp, note_deadlines=False)
        METRICS.add("cluster.election_catchups")

    def maybe_promote(self, now: Optional[float] = None) -> bool:
        """The election: promote when the primary has been silent past
        the (rank-staggered) election timeout.  Lease-based — every
        successful pull or inbound push renews the primary's leadership
        lease; silence lets it lapse.  In a quorum replica set the
        candidate first polls its peers: it defers unless
        ``N - W + 1`` nodes are reachable, aborts on any higher term or
        live primary, and catches up from the highest-revision
        responder — the promoted node's log then contains every
        acknowledged revision."""
        if self.role == "primary":
            return False
        now = time.monotonic() if now is None else now
        if now - self.last_primary_contact < self.effective_election_timeout_s:
            return False
        faults.check("cluster.election", addr=self.addr, term=self.term)
        if self.write_quorum > 1:
            poll = self._election_poll(now)
            if poll is None:
                return False  # fenced: a better claimant exists
            reachable, best_rev, best_peer = poll
            if reachable < self.election_quorum:
                self.elections_deferred += 1
                METRICS.add("cluster.elections_deferred")
                return False  # cannot guarantee acked-write coverage
            if best_rev > self.state._rev and best_peer is not None:
                from datafusion_tpu_torch.errors import ExecutionError

                try:
                    self._catchup_from(best_peer)
                except (ConnectionError, OSError, ExecutionError):
                    self.elections_deferred += 1
                    METRICS.add("cluster.elections_deferred")
                    return False  # retry next cycle with a fresh poll
        self.state.promote(self.term + 1, now=now)
        self.role = "primary"
        self.standby_of = None
        self._upstream_client = None
        self.promotions += 1
        METRICS.add("cluster.promotions")
        self._wal_persist_best_effort()  # the "promoted" event + term
        return True

    def retarget(self, upstream) -> None:
        """Point this standby at a (new) upstream — an address string
        (TCP) or another `ClusterNode` (in-process)."""
        self.standby_of = upstream
        self._upstream_client = None

    def step_down(self, to, term: int,
                  now: Optional[float] = None) -> None:
        """A higher term exists: stop serving writes immediately, adopt
        the term, and resync from the new primary via a full snapshot
        (our log may have diverged during the split-brain window — any
        writes we took after the election are discarded, which is the
        fencing contract: one primary's history wins)."""
        now = time.monotonic() if now is None else now
        self.role = "standby"
        self.standby_of = to
        self.state.term = max(self.state.term, int(term))
        self._upstream_client = None
        self._force_snapshot = True
        self.last_primary_contact = now
        self.step_downs += 1
        METRICS.add("cluster.step_downs")

    # -- replication (primary side) --
    def _serve_pull(self, msg: dict, bw=None) -> dict:
        # the puller was promoted past us? if we still think we are
        # primary, we are the revived old primary — step down NOW
        self._observe_term(int(msg.get("term", 0)), None, msg.get("addr"))
        if self.role != "primary" and not msg.get("election"):
            # a demoted (or never-primary) node must not feed the log:
            # the puller follows the hint to the real primary, and a
            # standby that kept "succeeding" against a deposed upstream
            # would otherwise defer its own election forever.  The ONE
            # exception is an election catch-up pull: a candidate that
            # polled us as the highest-revision survivor adopts our log
            # BEFORE promoting — that is how an acked write outlives
            # the primary that acked it.
            return self._not_primary_reply("replication")
        since = int(msg.get("since", 0))
        state = self.state
        base = {"type": "replicate", "term": self.term, "role": self.role,
                "epoch": state.membership()["epoch"], "rev": state._rev,
                "lease_deadlines": state.lease_deadlines()}
        out = state.events_since(since, kinds=None)
        if msg.get("snapshot") or out.get("truncated") or \
                (since == 0 and state._rev > 0 and
                 state._events_floor > 1):
            faults.check("cluster.snapshot", addr=self.addr)
            snap = state.snapshot_state()
            if bw is not None:
                for spec in snap["results"]:
                    spec["value"] = _encode_result_value(spec["value"], bw)
            METRICS.add("cluster.snapshots_served")
            return {**base, "rev": snap["rev"], "snapshot": snap}
        values = {}
        for ev in out["events"]:
            if ev.get("kind") != "result_put":
                continue
            value = state.results.peek(f"cache/result/{ev['key']}")
            if value is None:
                continue  # evicted since; the standby just misses it
            values[ev["key"]] = _encode_result_value(value, bw) \
                if bw is not None else value
        return {**base, "rev": out["rev"], "events": out["events"],
                "result_values": values}

    def _serve_peer_status(self, msg: dict) -> dict:
        # fenced: a newer-term peer exists — depose ourselves (primary)
        # or chase it (standby probed by the new primary)
        self._observe_term(int(msg.get("term", 0)), msg.get("role"),
                           msg.get("addr"))
        return {
            "type": "peer_status", "term": self.term, "role": self.role,
            "rev": self.state._rev, "addr": self.addr,
            "primary": self.addr if self.role == "primary"
            else self._primary_hint(),
        }

    def peer_probe_once(self) -> None:
        """Exchange terms with every configured peer; either side of
        the exchange that learns of a higher term steps down.  This is
        how a restarted old primary discovers the new one within one
        probe interval instead of split-braining indefinitely."""
        from datafusion_tpu_torch import cluster as _cluster
        from datafusion_tpu_torch.errors import ExecutionError

        for peer in self.peers:
            if peer == self.addr:
                continue
            try:
                client = _cluster.connect(peer)
                resp = client.request({
                    "type": "peer_status", "term": self.term,
                    "role": self.role, "addr": self.addr,
                })
            except (ConnectionError, OSError, ExecutionError):
                continue
            self._observe_term(
                int(resp.get("term", 0)), resp.get("role"),
                resp.get("primary") or peer,
            )

    # -- control loop (TCP deployments) --
    def _control_loop(self) -> None:
        from datafusion_tpu_torch.errors import ExecutionError

        probe_every = max(1, int(round(
            self.election_timeout_s / max(self.replicate_interval_s, 1e-3) / 2
        )))
        cycles = 0
        while not self._stop.wait(self.replicate_interval_s):
            cycles += 1
            try:
                if self.role == "standby":
                    try:
                        self.replicate_once()
                    except (ConnectionError, OSError, ExecutionError):
                        METRICS.add("cluster.replicate_errors")
                    self.maybe_promote()
                elif self.peers and cycles % probe_every == 0:
                    self.peer_probe_once()
                # periodic durability sweep: expiry-driven events that
                # no request triggered, deadline notes on idle nodes,
                # and compaction snapshots
                self._wal_persist_best_effort()
            except Exception:  # noqa: BLE001 — the control loop must survive
                METRICS.add("cluster.control_errors")

    def start(self) -> "ClusterNode":
        """Start the replication/peer control thread (and run one
        synchronous peer probe first, so a restarted old primary fences
        itself BEFORE accepting its first client write)."""
        if self.peers:
            try:
                self.peer_probe_once()
            except Exception:  # noqa: BLE001 — boot probe is best-effort
                METRICS.add("cluster.control_errors")
        if self.role == "standby":
            from datafusion_tpu_torch.errors import ExecutionError

            try:
                self.replicate_once()
            except (ConnectionError, OSError, ExecutionError):
                METRICS.add("cluster.replicate_errors")
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._control_loop, name="df-torch-cluster-ctl",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
        if self.wal is not None:
            # clean shutdown: persist whatever the last sweep missed
            # and force the final fsync (crash-only recovery does not
            # NEED this — it just makes a graceful restart lossless
            # even under sync=interval)
            self._wal_persist_best_effort()
            try:
                self.wal.flush()
            except OSError:
                METRICS.add("cluster.wal_write_failures")

    # -- introspection --
    @property
    def replication_lag_revisions(self) -> int:
        if self.role == "primary":
            return 0
        return max(0, self.primary_rev - self.state._rev)

    def gauges(self) -> dict:
        out = {
            "cluster.term": self.term,
            "cluster.role": 1 if self.role == "primary" else 0,
            "cluster.replication_lag_revisions": self.replication_lag_revisions,
            "cluster.write_quorum": self.write_quorum,
            "cluster.replica_set_size": self.cluster_size(),
            "cluster.succession_rank": self.rank,
        }
        if self.wal is not None:
            # keys appear only with durability on: WAL_DIR unset stays
            # byte-identical to the in-memory control plane
            out["cluster.recovered_revisions"] = self.recovered_revisions
            out["wal.last_rev"] = self.wal.last_rev
            out["wal.snapshot_rev"] = self.wal.snapshot_rev
        return out

    def status(self) -> dict:
        out = self.state.status(extra=self.gauges())
        out.update({
            "role": self.role,
            "term": self.term,
            "standby_of": self._primary_hint(),
            "replication_lag_revisions": self.replication_lag_revisions,
            "promotions": self.promotions,
            "step_downs": self.step_downs,
            "write_quorum": self.write_quorum,
            "replica_set_size": self.cluster_size(),
            "rank": self.rank,
            "elections_deferred": self.elections_deferred,
            "parked_watchers": self.state.parked_watchers(),
            # the scale smoke's thread-count assertion reads this: an
            # event-driven node's thread count is O(pool), independent
            # of how many watches/scrapes are parked on it
            "threads": threading.active_count(),
        })
        if self.wal is not None:
            out["wal"] = self.wal.manifest()
            out["recovered_revisions"] = self.recovered_revisions
        return out


def handle_request(target, msg: dict, bw=None) -> dict:
    """One request -> one response, shared by the TCP handler and the
    in-process `LocalClusterClient` so both deployment shapes run the
    exact same semantics (fencing included — pass a `ClusterNode`; a
    bare `ClusterState` is served unfenced for state-machine tests)."""
    if isinstance(target, ClusterNode):
        return target.handle_request(msg, bw)
    return apply_request(target, msg, bw)


def _park_watch(node: ClusterNode, loop, conn, msg: dict) -> None:
    """Event-loop watch: park the request as a waiter + timer instead
    of a thread.  Exactly-once answer: whichever of {event notify,
    timeout} fires first replies; the other is a no-op."""
    state = node.state
    since = int(msg.get("since", 0))
    resume = msg.get("resume")
    timeout_s = max(0.0, min(float(msg.get("timeout_s", 10.0)),
                             _WATCH_TIMEOUT_CAP_S))
    done = {"sent": False}
    holder: dict = {"token": None, "timer": None}

    def finish():
        if done["sent"]:
            return
        done["sent"] = True
        timer = holder["timer"]
        if timer is not None:
            timer.cancel()
        state.cancel_watch(holder["token"])
        if conn.closed:
            return  # the watcher hung up while parked
        conn.reply(msg, {"type": "watch",
                         **state.watch_answer(since, resume=resume)})

    resp, token = state.watch_async(
        since, notify=lambda: loop.call_soon(finish), resume=resume
    )
    if resp is not None:
        conn.reply(msg, {"type": "watch", **resp})
        return
    holder["token"] = token
    holder["timer"] = loop.call_later(timeout_s, finish)
    METRICS.add("cluster.watches_parked")


def _service_on_message(node: ClusterNode, loop, conn, msg: dict) -> None:
    """The event server's per-frame dispatch (loop thread, must not
    block): watches park; everything else — including quorum commits,
    which block on replica round trips — runs on the bounded executor."""
    from datafusion_tpu_torch.parallel.wire import BinWriter

    kind = msg.get("type")
    if kind == "shutdown":
        conn.reply(msg, {"type": "bye"})
        loop.call_later(0.05, loop.stop)  # after the bye flushes
        return
    if kind == "watch" and node.role == "primary":
        _park_watch(node, loop, conn, msg)
        return

    def work():
        bw = BinWriter()
        try:
            out = node.handle_request(msg, bw)
        except Exception as e:  # noqa: BLE001 — the service must not die on a bad request
            out = {"type": "error", "message": f"{type(e).__name__}: {e}"}
            bw = BinWriter()  # a failed build may hold partial segments
        return out, bw

    conn.defer_reply(msg, work)


class ClusterStateService(LoopServer):
    """The cluster service on the selector event loop: parked watches
    and idle client connections cost file descriptors, not threads
    (socketserver-compatible facade — see `utils/eventloop.py`)."""

    cluster_node: ClusterNode
    cluster_state: ClusterState


def serve(bind: str = "127.0.0.1:0",
          state: Optional[ClusterState] = None,
          node: Optional[ClusterNode] = None,
          standby_of: Optional[str] = None,
          peers=(),
          election_timeout_s: Optional[float] = None,
          advertise: Optional[str] = None,
          write_quorum: Optional[int] = None,
          rank: int = 0,
          wal_dir: Optional[str] = None) -> ClusterStateService:
    """Run the service on `bind`; returns the server (embed it, or call
    `serve_forever` via ``python -m datafusion_tpu_torch.cluster``).
    `standby_of` starts this instance as a replicating standby of an
    existing primary; `peers` (addresses, self included or not) arms
    the term-exchange probe that fences a revived old primary AND names
    the replica set for quorum pushes + elections; `write_quorum` > 1
    turns on synchronous quorum-acked writes; `rank` staggers the
    succession order."""
    from datafusion_tpu_torch.utils.eventloop import ServerLoop, WireConnection

    host, _, port = bind.partition(":")
    loop = ServerLoop(pool_size=None, name="df-torch-cluster-svc")
    node_cell: list = []  # filled below; no frame arrives before run()

    def conn_factory(lp, sock, a):
        return WireConnection(
            lp, sock, a,
            lambda conn, msg: _service_on_message(
                node_cell[0], lp, conn, msg
            ),
        )

    lsock = loop.listen(host, int(port or 0), conn_factory)
    bound_host, bound_port = lsock.getsockname()[:2]
    addr = advertise or f"{bound_host}:{bound_port}"
    if node is None:
        node = ClusterNode(
            state=state, addr=addr, standby_of=standby_of, peers=peers,
            election_timeout_s=election_timeout_s,
            write_quorum=write_quorum, rank=rank, wal_dir=wal_dir,
        )
        if standby_of or node.peers or node.wal is not None:
            # a WAL'd solo primary still wants the control loop: it
            # carries the periodic durability sweep (deadline notes,
            # compaction) between requests
            node.start()
    node_cell.append(node)
    server = ClusterStateService(loop, lsock)
    server.cluster_node = node
    server.cluster_state = node.state
    return server


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="datafusion-tpu-cluster",
        description="datafusion-tpu cluster state service "
                    "(replicated lease KV + membership + shared cache tier)",
    )
    ap.add_argument("--bind", default="127.0.0.1:8470",
                    help="host:port to listen on (default 127.0.0.1:8470)")
    ap.add_argument("--standby-of", default=None,
                    help="primary address host:port — start as a "
                         "replicating standby that promotes itself on "
                         "primary silence (default: start as primary)")
    ap.add_argument("--peers", default=None,
                    help="comma-separated replica addresses for the "
                         "term-exchange probe that fences a revived old "
                         "primary (include every replica; self is skipped)")
    ap.add_argument("--advertise", default=None,
                    help="host[:port] peers should dial for this replica "
                         "(default: the bound address)")
    ap.add_argument("--election-timeout-s", type=float, default=None,
                    help="promote after this much primary silence "
                         "(default: env DATAFUSION_TPU_CLUSTER_ELECTION_S "
                         "or half the lease TTL; rank-staggered: each "
                         "succession rank waits half a timeout longer)")
    ap.add_argument("--write-quorum", type=int, default=None,
                    help="replicas (this node included) that must hold a "
                         "mutation before it is acknowledged (default: env "
                         "DATAFUSION_TPU_CLUSTER_QUORUM or 1 = async "
                         "replication; a 3-replica set wants 2)")
    ap.add_argument("--rank", type=int, default=0,
                    help="succession rank for elections (0 = first in "
                         "line; higher ranks wait longer before claiming)")
    ap.add_argument("--wal-dir", default=None,
                    help="write-ahead-log directory for crash-only "
                         "durability — events are logged before quorum-"
                         "ack and replayed at boot (default: env "
                         "DATAFUSION_TPU_WAL_DIR, unset = in-memory "
                         "only; never share a directory between nodes)")
    args = ap.parse_args(argv)
    peers = [p.strip() for p in (args.peers or "").split(",") if p.strip()]
    server = serve(args.bind, standby_of=args.standby_of, peers=peers,
                   election_timeout_s=args.election_timeout_s,
                   advertise=args.advertise,
                   write_quorum=args.write_quorum, rank=args.rank,
                   wal_dir=args.wal_dir)
    host, port = server.server_address[:2]
    node: ClusterNode = server.cluster_node  # type: ignore[attr-defined]
    # NB: smoke harnesses parse this line for the address — keep the
    # role/term detail on its own line
    print(f"cluster service listening on {host}:{port}", flush=True)
    print(f"cluster service role={node.role} term={node.term} "
          f"quorum={node.write_quorum} rank={node.rank}"
          + (f" standby_of={args.standby_of}" if args.standby_of else "")
          + (f" wal_recovered_rev={node.recovered_revisions}"
             if node.wal is not None else ""),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
    return 0
