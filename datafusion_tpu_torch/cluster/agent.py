"""Worker-side cluster agent: lease registration + invalidation apply.

A worker in cluster mode registers ``workers/<addr>`` under a TTL lease
and keeps it alive from a heartbeat thread.  The refresh is ONE round
trip that renews the lease AND returns the event-log tail: the
invalidation broadcast rides the heartbeat, so a
coordinator-driven ``invalidate(table)`` drops this worker's tagged
fragment-cache entries within one refresh interval, far sooner than
TTL/file-version aging would.

Failure behavior: a refresh that finds its lease gone (the service
restarted, or injected lease expiry via the ``cluster.lease.refresh``
fault site) re-registers from scratch — the membership epoch records
the leave/join pair, and the agent clears the fragment cache first
because it may have missed invalidation events while deregistered
(the event log is only guaranteed to cover a held lease).

HA: the client underneath handles primary failover (multi-endpoint
sweep + redirect-on-``not_primary``), and a promoted standby re-arms
every replicated lease with its SHIPPED remaining deadline on takeover
— so a primary SIGKILL costs at most one errored heartbeat cycle,
never a live lease, and never masks an already-dead worker behind a
fresh TTL.  The agent tracks the leadership ``term`` it last observed
(`cluster.term` gauge): a bump is the visible trace of a failover.

Durability: against a WAL-backed service (``DATAFUSION_TPU_WAL_DIR``),
a full-fleet restart looks like a failover, not a reset — the recovered
primary's revision counter and lease deadlines continue from the
replayed log, so the agent's rev-regression and truncation guards stay
quiet and an already-dead lease stays dead (it recovers with its
REMAINING deadline, never a fresh TTL).  A worker that re-materialized
its pin manifest before registering advertises ``pins_rehydrated`` in
its membership record.

Storm control: consecutive heartbeat failures back the loop off with
capped full jitter, and a re-registration from the background loop
staggers a bounded random delay first — a mass lease lapse across a
failover reaches the new primary as a spread-out trickle, not one
synchronized re-register burst (``DATAFUSION_TPU_CLUSTER_REREG_JITTER_S``
caps the stagger).  The
backoff never passes one refresh interval while the agent holds a
lease: a promoted standby re-arms that lease with its shipped remaining
TTL, at least TTL - refresh after a healthy beat, so a longer wait
would lapse a live lease across the failover.  Only an agent without a
lease (registration failing) backs off up to one TTL.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS


class WorkerClusterAgent:
    """Keeps one worker registered in the cluster and applies broadcast
    invalidations to its fragment cache.  `poll_once()` runs one
    heartbeat synchronously — tests drive it deterministically without
    the thread."""

    def __init__(self, client, addr: str, worker_state,
                 ttl_s: Optional[float] = None,
                 refresh_s: Optional[float] = None):
        from datafusion_tpu_torch import cluster as _cluster

        self.client = client
        self.addr = addr
        self.worker_state = worker_state
        self.ttl_s = ttl_s if ttl_s is not None else _cluster.lease_ttl_s()
        # 3 refresh chances per TTL: one lost heartbeat never expires us
        self.refresh_s = refresh_s if refresh_s is not None else self.ttl_s / 3.0
        self.lease: Optional[str] = None
        self.last_rev = 0
        self.epoch = -1
        self.term = 0  # leadership term last observed (bumps on failover)
        self.events_applied = 0
        self.reregistrations = 0
        self._lease_refreshed: Optional[float] = None
        # last (pin set, saturated) put under the lease — QoS pin
        # advertisement re-puts only when this changes
        self._advertised_pins: Optional[tuple] = None
        # consecutive heartbeat failures: drives the capped full-jitter
        # backoff below so a fleet whose leases lapsed together (mass
        # expiry across a failover) re-registers SPREAD over a window
        # instead of stampeding the new primary in one synchronized
        # burst.  Capped at one refresh interval while a lease is held
        # (it must reach a promoted standby inside the remaining TTL
        # that standby re-arms), at one TTL while none is.
        self._failures = 0
        self._backoff_cap_s = max(self.ttl_s, self.refresh_s)
        env = os.environ.get("DATAFUSION_TPU_CLUSTER_REREG_JITTER_S", "")
        # re-register stagger ceiling (loop path only; poll_once stays
        # deterministic for tests): uniform [0, min(this, refresh))
        self.reregister_jitter_s = (
            float(env) if env else min(1.0, self.refresh_s)
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _telemetry(self) -> Optional[dict]:
        """The node snapshot piggybacked on each heartbeat (None when
        the worker state doesn't expose one — bare embedders)."""
        fn = getattr(self.worker_state, "telemetry_snapshot", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — a broken snapshot must not break the lease
            METRICS.add("worker.telemetry_snapshot_errors")
            return None

    def _membership_info(self) -> dict:
        """The membership record this worker puts under its lease."""
        info = {"addr": self.addr, "pid": os.getpid(),
                "batch_size": self.worker_state.batch_size}
        # a rebooted worker that re-materialized device pins from its
        # durable manifest (serve.py pin seam) advertises the warm
        # rejoin in its membership record: registration happens AFTER
        # rehydration, so "ready" in the membership view means the
        # pins are already resident, never cold-path-pending
        rehydrated = getattr(self.worker_state, "pins_rehydrated", 0)
        if rehydrated:
            info["pins_rehydrated"] = int(rehydrated)
        # advertise the debug HTTP plane (obs/httpd.py) in the lease:
        # the console's `debug-bundle --cluster` resolves every live
        # member's bundle endpoint from the membership view alone
        debug_port = getattr(self.worker_state, "debug_port", None)
        if debug_port:
            info["debug_port"] = int(debug_port)
        # pin-aware placement (qos.py, default off): the
        # resident-table fingerprints plus device headroom ride the lease
        # value beside the debug port, so the coordinator routes a
        # query to a worker already holding its tables — and spots a
        # saturated holder it should replicate away from
        adv = self._pin_advertisement()
        if adv is not None:
            pins, headroom = adv
            info["pins"] = pins
            if headroom is not None:
                info["hbm_headroom_bytes"] = int(headroom)
        return info

    def _pin_advertisement(self):
        """``(pins, hbm_headroom_bytes)`` to advertise, or None when
        QoS is off (the lease value stays byte-identical to pre-QoS)
        or the embedder's worker state exposes no fingerprints."""
        from datafusion_tpu_torch import qos

        if not qos.enabled():
            return None
        fn = getattr(self.worker_state, "pinned_fingerprints", None)
        if fn is None:
            return None
        try:
            pins = list(fn())
        except Exception:  # noqa: BLE001 — advertisement must not break the lease
            METRICS.add("worker.pin_advert_errors")
            return None
        from datafusion_tpu_torch.obs.device import LEDGER

        return pins, LEDGER.headroom()

    @staticmethod
    def _pin_state(info: dict):
        """The change-detection key for re-advertisement: the pin set
        plus the SATURATED flag (headroom crossing zero flips routing
        decisions; raw headroom jitter must not re-put every beat)."""
        pins = info.get("pins")
        if pins is None:
            return None
        headroom = info.get("hbm_headroom_bytes")
        return tuple(pins), bool(headroom is not None and headroom <= 0)

    # -- registration / heartbeat --
    def register(self) -> None:
        granted = self.client.lease_grant(self.ttl_s)
        self.lease = granted["lease"]
        # resume the event log from the grant: events before this worker
        # held a lease concern caches it does not have
        self.last_rev = granted.get("rev", 0)
        info = self._membership_info()
        self.client.put(f"workers/{self.addr}", info, lease=self.lease)
        self._advertised_pins = self._pin_state(info)
        self._lease_refreshed = time.monotonic()
        METRICS.add("worker.cluster_registered")

    def _readvertise_pins(self) -> None:
        """Re-put the membership record when the advertised pin set
        (or the saturated flag) changed since the last put: re-putting
        an existing ``workers/`` key bumps the revision — watchers
        wake, views refresh their info dicts — WITHOUT bumping the
        membership epoch, so placement sees fresh pins within one
        heartbeat while epoch-driven machinery stays quiet."""
        if self.lease is None:
            return
        info = self._membership_info()
        state = self._pin_state(info)
        if state is None or state == self._advertised_pins:
            return
        self.client.put(f"workers/{self.addr}", info, lease=self.lease)
        self._advertised_pins = state
        METRICS.add("worker.pins_readvertised")
        recorder.record("pins.advertise", addr=self.addr,
                        pins=len(state[0]), saturated=int(state[1]))

    def poll_once(self, stagger: bool = False) -> None:
        """One heartbeat: refresh the lease, apply any broadcast events
        that arrived since the last one.  Raises on a partitioned
        service (the loop counts and retries next cycle).  `stagger`
        (the background loop's setting) sleeps a bounded random delay
        before any RE-registration so a mass lease lapse doesn't
        produce a synchronized re-register storm; direct test drivers
        keep the default deterministic path."""
        faults.check("cluster.lease.refresh", addr=self.addr)
        if self.lease is None:
            self.register()
        resp = self.client.lease_refresh(self.lease, since=self.last_rev,
                                         telemetry=self._telemetry())
        if not resp.get("found"):
            # lease lapsed out from under us (expiry, service restart):
            # we may have missed invalidations, so the cache is suspect
            self.reregistrations += 1
            METRICS.add("worker.cluster_reregistered")
            recorder.record("lease.reregistered", addr=self.addr)
            cache = self.worker_state.fragment_cache
            if cache is not None:
                cache.clear()
            if stagger and self.reregister_jitter_s > 0:
                # every worker in the fleet noticed the lapse within
                # one refresh interval of each other; spread the herd
                self._stop.wait(self._register_stagger_s())
            self.register()
            resp = self.client.lease_refresh(self.lease, since=self.last_rev,
                                             telemetry=self._telemetry())
        self._lease_refreshed = time.monotonic()
        self.epoch = resp.get("epoch", self.epoch)
        new_term = int(resp.get("term", self.term))
        if self.term and new_term > self.term:
            # the control plane failed over under us; the lease
            # survived (the new primary re-armed it) — just record it
            METRICS.add("worker.cluster_term_changes")
            recorder.record("cluster.term_change", addr=self.addr,
                            old_term=self.term, new_term=new_term)
        self.term = max(self.term, new_term)
        if resp.get("rev", self.last_rev) < self.last_rev:
            # the service's revision counter went BACKWARDS: a failover
            # landed on a standby whose replicated log was behind what
            # we had already consumed.  Events issued on the new
            # primary at revisions <= our old cursor are filtered out
            # of every future `since` tail — unobservable, exactly like
            # a truncation — so the cache is suspect and must clear
            cache = self.worker_state.fragment_cache
            if cache is not None:
                cache.clear()
            METRICS.add("worker.cluster_rev_regressions")
        if resp.get("truncated"):
            # fell off the retained event window: same cache-suspect
            # resync as a lapsed lease
            cache = self.worker_state.fragment_cache
            if cache is not None:
                cache.clear()
            METRICS.add("worker.cluster_event_log_truncated")
        for ev in resp.get("events", ()):
            self._apply(ev)
        self.last_rev = resp.get("rev", self.last_rev)
        self._readvertise_pins()

    def _apply(self, event: dict) -> None:
        if event.get("kind") != "invalidate":
            return  # join/leave events are membership bookkeeping
        self.events_applied += 1
        cache = self.worker_state.fragment_cache
        if cache is None:
            return
        dropped = cache.invalidate_tag(str(event.get("table", "")))
        if dropped:
            METRICS.add("worker.cluster_invalidations_applied", dropped)

    def _register_stagger_s(self) -> float:
        """Uniform random re-register stagger in
        [0, min(reregister_jitter_s, refresh_s))."""
        import random

        cap = min(self.reregister_jitter_s, self.refresh_s)
        return random.uniform(0.0, max(0.0, cap))

    def _retry_delay_s(self) -> float:
        """The wait before the next heartbeat cycle: the plain refresh
        interval when healthy; after consecutive failures, capped
        full-jitter backoff (never a sub-50ms hot loop) — the
        re-register storm killer for service outages.  The cap is one
        refresh interval while a lease is held, one TTL while none is."""
        from datafusion_tpu_torch.utils.retry import backoff_s

        if not self._failures:
            return self.refresh_s
        cap = self.refresh_s if self.lease is not None else self._backoff_cap_s
        delay = backoff_s(min(self._failures, 6),
                          base=self.refresh_s / 2.0, cap=cap)
        return min(max(0.05, delay), cap)

    # -- lifecycle --
    def _loop(self) -> None:
        while not self._stop.wait(self._retry_delay_s()):
            try:
                self.poll_once(stagger=True)
                self._failures = 0
            except (ConnectionError, OSError, ExecutionError):
                self._failures += 1
                METRICS.add("worker.cluster_refresh_errors")
            except Exception:  # noqa: BLE001 — the heartbeat must outlive surprises
                self._failures += 1
                METRICS.add("worker.cluster_refresh_errors")

    def start(self) -> "WorkerClusterAgent":
        try:
            self.poll_once()  # register before serving, not a cycle later
        except (ConnectionError, OSError, ExecutionError):
            METRICS.add("worker.cluster_refresh_errors")
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="df-torch-cluster-agent", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None

    def close(self) -> None:
        """Clean shutdown: stop the heartbeat and revoke the lease so
        the membership epoch moves now, not a TTL later."""
        self.stop()
        if self.lease is not None:
            try:
                self.client.lease_revoke(self.lease)
            except (ConnectionError, OSError, ExecutionError):
                pass  # the TTL will collect us
            self.lease = None

    # -- introspection --
    @property
    def lease_age_s(self) -> Optional[float]:
        if self._lease_refreshed is None:
            return None
        return time.monotonic() - self._lease_refreshed

    def gauges(self) -> dict:
        age = self.lease_age_s
        return {
            "cluster.lease_age_s": round(age, 3) if age is not None else -1,
            "cluster.lease_ttl_s": self.ttl_s,
            "cluster.epoch": self.epoch,
            "cluster.term": self.term,
            "cluster.events_applied": self.events_applied,
        }

    def snapshot(self) -> dict:
        """Status-endpoint block (worker `{"type": "status"}`)."""
        age = self.lease_age_s
        return {
            "addr": self.addr,
            "registered": self.lease is not None,
            "lease_ttl_s": self.ttl_s,
            "lease_age_s": round(age, 3) if age is not None else None,
            "epoch": self.epoch,
            "term": self.term,
            "events_applied": self.events_applied,
            "reregistrations": self.reregistrations,
        }
