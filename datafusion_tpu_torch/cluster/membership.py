"""Coordinator-side membership subscription.

`MembershipView` replaces the per-coordinator probe loop as the source
of worker liveness when cluster mode is on: instead of every
coordinator privately pinging every worker (N_coordinators x N_workers
probe traffic, and each coordinator re-learning liveness alone), each
`refresh()` is ONE request to the cluster service returning the epoch
plus the live worker set — the view all coordinators share.  The
`HeartbeatMonitor` consumes it in place of its probe cycle
(`parallel/coordinator.py`); dispatch's last-gasp re-probe is
unaffected (a coordinator facing an all-dead view still probes workers
directly before failing a query).

**Push watch**: `watch(timeout_s)` parks a long-poll at the view's last
seen revision — the service answers on the next membership or
invalidation event (or at the timeout) with the event tail AND the
fresh membership in one response, so a join/leave reaches every watcher
one round trip after it happens instead of one poll interval later.
The heartbeat monitor uses it when cluster mode is on; `poll()` remains
for callers that want an immediate pull.

**Change callbacks**: `subscribe(fn)` registers a callback fired (from
whatever thread refreshed the view) whenever the epoch moves —
`DistributedContext` hangs its automatic `sync_workers()` off this, so
a fleet scales out and shrinks with zero coordinator intervention.

A refresh that cannot reach the service keeps the last view (stale
liveness beats no liveness) and the staleness is observable: the
``cluster.watch_lag_s`` gauge is the age of the last successful
refresh, and once that age outruns the **grace window**
(``DATAFUSION_TPU_STALE_VIEW_GRACE_S``, default 15s) the view flips
an explicit degraded-mode flag — the ``cluster.view_stale`` gauge
goes to 1, ``coord.membership_went_stale`` counts the transition, and
a ``cluster.view_stale`` flight event marks the moment — so "the
coordinator is serving worker liveness off a last-good view" is an
alarmable state, not a silent one.  The fault site ``cluster.watch``
makes stale-view handling testable on demand.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS


class MembershipView:
    """A coordinator's subscription to the shared worker membership."""

    def __init__(self, client):
        self.client = client
        self.epoch = -1  # -1 = never refreshed
        self.rev = 0
        self.term = 0  # leadership term last observed on the service
        self.workers: dict[str, dict] = {}  # addr -> info (lease_age_s, ...)
        self._lock = lockcheck.make_lock("cluster.membership_view")
        self._last_refresh: Optional[float] = None
        self.refresh_errors = 0
        self.rev_regressions = 0
        self._callbacks: list[Callable[["MembershipView"], None]] = []
        # degraded-mode grace window: a view older than this is STALE
        # (served, tolerated, but gauge-flagged — see module doc)
        env = os.environ.get("DATAFUSION_TPU_STALE_VIEW_GRACE_S", "")
        self.stale_grace_s = float(env) if env else 15.0
        self._stale_flagged = False

    def subscribe(self, fn: Callable[["MembershipView"], None]) -> None:
        """Call `fn(view)` after every refresh/watch that observed an
        epoch change (runs on the refreshing thread — keep it cheap and
        re-entrant-safe; it must NOT call `poll`/`refresh` itself)."""
        self._callbacks.append(fn)

    def _ingest(self, out: dict) -> bool:
        """Fold a membership-bearing response into the view; returns
        whether the epoch moved (and fires subscribers if so)."""
        with self._lock:
            changed = out["epoch"] != self.epoch
            if changed:
                METRICS.add("coord.membership_epoch_changes")
            new_rev = out.get("rev", self.rev)
            if new_rev < self.rev and out.get("term", self.term) >= self.term:
                # the service's revision went BACKWARDS under a same-or-
                # newer term: a failover landed on a replica missing
                # events this view already consumed.  With quorum-acked
                # writes this gauge stays zero — it is the coordinator-
                # side proof the async loss window is closed (the
                # worker-agent twin is worker.cluster_rev_regressions)
                self.rev_regressions += 1
                METRICS.add("coord.membership_rev_regressions")
            self.epoch = out["epoch"]
            self.rev = new_rev
            self.term = out.get("term", self.term)
            self.workers = out.get("workers", {})
            self._last_refresh = time.monotonic()
            self._stale_flagged = False  # fresh view: degraded mode over
        if changed:
            for fn in self._callbacks:
                try:
                    fn(self)
                except Exception:  # noqa: BLE001 — a bad subscriber must not kill the watch
                    METRICS.add("coord.membership_callback_errors")
        return changed

    def refresh(self) -> "MembershipView":
        """Pull the current view from the service.  Raises
        ConnectionError/OSError when the service is unreachable — the
        caller decides whether stale is acceptable (`poll` swallows)."""
        faults.check("cluster.watch", epoch=self.epoch)
        with obs_trace.span("cluster.watch", epoch=self.epoch):
            out = self.client.membership()
        self._ingest(out)
        return self

    def poll(self) -> bool:
        """`refresh()` that tolerates a partitioned service: keeps the
        last view and returns False instead of raising."""
        try:
            self.refresh()
            return True
        except (ConnectionError, OSError, ExecutionError):
            with self._lock:
                self.refresh_errors += 1
            METRICS.add("coord.membership_refresh_errors")
            return False

    def watch(self, timeout_s: float = 10.0) -> bool:
        """Park a long-poll at the last seen revision; the view updates
        the moment the service logs a membership/invalidation event.
        Returns True when the view refreshed (event OR clean timeout —
        both carry a fresh membership), False when the service was
        unreachable (stale view kept, like `poll`)."""
        faults.check("cluster.watch", epoch=self.epoch)
        try:
            with obs_trace.span("cluster.watch", epoch=self.epoch,
                                long_poll=True):
                out = self.client.watch(self.rev, timeout_s=timeout_s)
        except (ConnectionError, OSError, ExecutionError):
            with self._lock:
                self.refresh_errors += 1
            METRICS.add("coord.membership_refresh_errors")
            return False
        self._ingest(out)
        return True

    def live_addresses(self) -> set[str]:
        with self._lock:
            return set(self.workers)

    @property
    def watch_lag_s(self) -> Optional[float]:
        """Seconds since the last successful refresh (None = never)."""
        with self._lock:
            if self._last_refresh is None:
                return None
            return time.monotonic() - self._last_refresh

    def stale(self) -> bool:
        """The degraded-mode flag: every refresh inside the grace
        window failed, so worker liveness is being served off a
        last-good view.  A view that never refreshed is *starting*,
        not degraded.  The False→True transition counts once
        (``coord.membership_went_stale``) and emits a flight event —
        the worked evidence of a cluster outage the coordinator rode
        out.  Check-and-flip runs under the view lock: concurrent
        scrapes must not double-count the transition, and a racing
        refresh must not have its reset overwritten (which would
        silence the NEXT outage's transition entirely)."""
        with self._lock:
            if self._last_refresh is None:
                return False
            lag = time.monotonic() - self._last_refresh
            if lag <= self.stale_grace_s:
                return False
            transition = not self._stale_flagged
            self._stale_flagged = True
            epoch = self.epoch
        if transition:
            METRICS.add("coord.membership_went_stale")
            from datafusion_tpu_torch.obs.recorder import record as flight_record

            flight_record("cluster.view_stale",
                          lag_s=round(lag, 3), epoch=epoch)
        return True

    def gauges(self) -> dict:
        """Prometheus gauges for `prometheus_text(extra_gauges=...)`."""
        lag = self.watch_lag_s
        stale = self.stale()
        with self._lock:
            return {
                "cluster.epoch": self.epoch,
                "cluster.term": self.term,
                "cluster.workers_live": len(self.workers),
                "cluster.watch_lag_s": round(lag, 3) if lag is not None else -1,
                "cluster.watch_errors": self.refresh_errors,
                "cluster.rev_regressions": self.rev_regressions,
                "cluster.view_stale": int(stale),
            }

    def __repr__(self):
        return (
            f"MembershipView(epoch={self.epoch}, term={self.term}, "
            f"workers={sorted(self.workers)})"
        )
