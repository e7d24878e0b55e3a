"""Cluster service clients: TCP (`ClusterClient`) and in-process
(`LocalClusterClient`).

Both expose the same typed surface over the same request dicts —
`LocalClusterClient` routes them through the node's `handle_request`
directly (fencing included: an in-process standby rejects writes with
``not_primary`` exactly like a TCP one), so in-process tests exercise
the exact wire semantics minus the sockets.  The TCP client mirrors
`WorkerHandle`'s discipline: one connection per request (the control
plane is low-rate; no pooled sockets to leak), the `wire_version` CRC
handshake, and a bounded connect timeout so a partitioned service
surfaces as `ConnectionError` instead of a hang.

**HA failover** lives here, shared by both transports: a client holds a
*list* of endpoints (``DATAFUSION_TPU_CLUSTER=host1:p1,host2:p2``), and
every request sweeps them — a dead endpoint (`ConnectionError`/OSError)
advances to the next; a ``not_primary`` rejection follows the replica's
redirect hint; sweeps are separated by capped full-jitter backoff
(`utils/retry.backoff_s`, the `TransientError` taxonomy's policy).  A
primary kill therefore costs one retried round inside the client, not a
failed lease refresh or membership poll.  The sweep *classifies*
failures: an instant ``ECONNREFUSED`` is cheap to re-probe, but an
endpoint that TIMED OUT (blackholed: SYN retries, a response that never
came) is skipped for the rest of that request's sweep, and per-endpoint
circuit breakers (`utils/breaker.py`, env-armed) carry the evidence
across requests.

**Persistent channels** (TCP client): watch long-polls and heartbeat
lease refreshes each ride ONE kept-alive socket (`_Channel`), dialed
once and re-pinned only after a failover — the selector-loop service
parks them threadless, so neither watchers nor heartbeating agents pay
a connect per interval (``cluster.watch_channel_*`` /
``cluster.heartbeat_channel_*`` counters).

The fault site ``cluster.request`` fires per request attempt with the
request type as context — a chaos rule raising
`ConnectionRefusedError` at ``{"where": {"op": "membership"}}``
simulates a partition of the whole endpoint set for exactly the
membership path (the injection sits above the failover sweep: it
models "the request failed after every endpoint", so rules keep their
one-raise-one-failure determinism).  Per-endpoint chaos uses
`ClusterNode.partitioned` (in-process) or a killed service process.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Optional

from datafusion_tpu_torch.errors import (
    ClusterNotPrimaryError,
    ClusterQuorumError,
    ExecutionError,
    StaleTermError,
)
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import backoff_s

# full endpoint sweeps before a request gives up (per request, not per
# client: the next request starts a fresh sweep at the active endpoint)
_FAILOVER_SWEEPS = 3


def _raise_error_reply(out: dict) -> dict:
    """Map an error reply onto the typed taxonomy (`not_primary` ->
    transient redirect, `quorum_unavailable` -> transient retry-in-
    place, `stale_term` -> permanent fence)."""
    if out.get("type") == "error":
        code = out.get("code")
        if code == "not_primary":
            raise ClusterNotPrimaryError(
                f"cluster service: {out.get('message')}",
                primary=out.get("primary"),
            )
        if code == "quorum_unavailable":
            raise ClusterQuorumError(
                f"cluster service: {out.get('message')}",
                acks=out.get("acks", 0), quorum=out.get("quorum", 0),
            )
        if code == "stale_term":
            raise StaleTermError(f"cluster service: {out.get('message')}")
        raise ExecutionError(f"cluster service: {out['message']}")
    return out


class _ClientApi:
    """Typed helpers + the endpoint-failover sweep, shared by both
    transports; subclasses implement `_endpoint_count()` and
    `_request_endpoint(idx, msg, timeout, bw)`."""

    _active = 0

    def _endpoint_count(self) -> int:  # pragma: no cover — interface
        raise NotImplementedError

    def _request_endpoint(self, idx: int, msg: dict,
                          timeout: Optional[float], bw=None,
                          sent_box=None) -> dict:  # pragma: no cover — interface
        raise NotImplementedError

    def _endpoint_index_for(self, addr) -> Optional[int]:
        """Index of the endpoint matching a redirect hint, if known."""
        return None

    def _endpoint_label(self, idx: int) -> str:
        """Stable identity of one endpoint (breaker naming)."""
        return str(idx)

    def _endpoint_breaker(self, idx: int):
        from datafusion_tpu_torch.utils import breaker as breaker_mod

        return breaker_mod.breaker_for(
            f"cluster:{self._endpoint_label(idx)}")

    def request(self, msg: dict, timeout: Optional[float] = None,
                bw=None, sent_box: Optional[list] = None) -> dict:
        """One request with the endpoint-failover sweep.  `sent_box`
        (a caller-owned single-slot list) receives the byte count of
        the attempt that succeeded — per call, so concurrent requests
        on a shared client never read each other's sizes.

        The sweep classifies endpoint failures: an instant fast-fail
        (`ECONNREFUSED`, reset) just advances, but a *timeout* —
        connect SYN retries or a response that never came, the
        blackholed-endpoint signature — marks the endpoint for the
        rest of THIS request's sweep, so later laps skip it instead of
        re-paying its full timeout per lap (``cluster.client_timeout_
        skips``).  Per-endpoint circuit breakers (env-armed,
        `utils/breaker.py`) carry that memory *across* requests: an
        open endpoint is skipped while any alternative exists
        (``cluster.client_breaker_skips``), and transport outcomes
        feed it — a healthy typed reply (redirect, quorum shortfall)
        counts as success, the service answered."""
        n = self._endpoint_count()
        max_attempts = n * _FAILOVER_SWEEPS
        attempts = 0
        last: Optional[Exception] = None
        timed_out: set = set()  # endpoints that ate a timeout this sweep
        # endpoints a standby NAMED as primary this request: fresher
        # evidence than any timeout mark or open breaker — without the
        # override, a recovered-but-open-circuited primary would be
        # skip/redirect-ping-ponged until the sweep exhausts
        redirected_to: set = set()

        def avoided(i: int) -> bool:
            if i in redirected_to:
                return False
            if i in timed_out:
                return True
            b = self._endpoint_breaker(i)
            return b is not None and b.denies()

        while True:
            idx = self._active % n
            if avoided(idx) and not all(avoided(i) for i in range(n)):
                # a known-blackholed / open-circuited endpoint with a
                # live alternative ahead: skip, don't re-pay
                METRICS.add("cluster.client_timeout_skips"
                            if idx in timed_out
                            else "cluster.client_breaker_skips")
                self._active = idx + 1
                attempts += 1
                if attempts >= max_attempts:
                    if last is None:  # skipped before any real attempt
                        raise ConnectionError(
                            "every cluster endpoint is avoided "
                            "(open circuits / timeouts)")
                    raise last
                continue
            breaker = self._endpoint_breaker(idx)
            faults.check("cluster.request", op=msg.get("type"), endpoint=idx)
            try:
                out = self._request_endpoint(idx, msg, timeout, bw, sent_box)
                if breaker is not None:
                    breaker.record(True)
                return out
            except ClusterQuorumError as e:
                # the PRIMARY answered but could not gather its write
                # quorum: rotating endpoints would only bounce off
                # standbys' redirects — retry in place after a backoff
                # and give the replica set (or the election) a moment
                last = e
                if breaker is not None:
                    breaker.record(True)  # transport healthy
                METRICS.add("cluster.client_quorum_retries")
                attempts += 1
                if attempts >= max_attempts:
                    raise last
                time.sleep(backoff_s(
                    max(1, attempts), base=0.05, cap=0.5
                ))
                continue
            except ClusterNotPrimaryError as e:
                last = e
                if breaker is not None:
                    breaker.record(True)  # a standby answering is healthy
                hinted = self._endpoint_index_for(e.primary)
                self._active = hinted if hinted is not None else idx + 1
                if hinted is not None:
                    # a standby naming THIS endpoint as primary is
                    # fresher evidence than one old timeout on it (or
                    # its open breaker): a transiently-stalled primary
                    # must be retried, not skipped until exhaustion
                    timed_out.discard(hinted % n)
                    redirected_to.add(hinted % n)
                METRICS.add("cluster.client_redirects")
            except (ConnectionError, OSError) as e:
                last = e
                if breaker is not None:
                    breaker.record(False)
                if isinstance(e, TimeoutError):
                    # connect SYN retries or a response that never came:
                    # the blackholed signature — remember it this sweep
                    # (and void any older redirect naming it: evidence
                    # freshness goes both ways)
                    timed_out.add(idx)
                    redirected_to.discard(idx)
                self._active = idx + 1
                METRICS.add("cluster.client_failovers")
            attempts += 1
            if attempts >= max_attempts:
                raise last
            if attempts % n == 0:
                # a full sweep failed (dead primary, election still in
                # flight): back off before the next one — capped, full
                # jitter, same policy as every other transient retry
                time.sleep(backoff_s(attempts // n, base=0.05, cap=0.5))

    def ping(self) -> bool:
        try:
            return self.request({"type": "ping"})["type"] == "pong"
        except (ConnectionError, OSError, ExecutionError):
            return False

    def lease_grant(self, ttl_s: float) -> dict:
        return self.request({"type": "lease_grant", "ttl_s": ttl_s})

    @staticmethod
    def _lease_refresh_msg(lease: str, since: Optional[int],
                           telemetry: Optional[dict]) -> dict:
        msg: dict = {"type": "lease_refresh", "lease": lease}
        if since is not None:
            msg["since"] = since
        if telemetry is not None:
            # worker node snapshot piggybacked on the heartbeat
            # (obs/aggregate.py; served back via `telemetry()`)
            msg["telemetry"] = telemetry
        return msg

    def lease_refresh(self, lease: str, since: Optional[int] = None,
                      telemetry: Optional[dict] = None) -> dict:
        return self.request(self._lease_refresh_msg(lease, since, telemetry))

    def lease_revoke(self, lease: str) -> bool:
        return bool(self.request({"type": "lease_revoke", "lease": lease}).get("found"))

    def put(self, key: str, value: Any, lease: Optional[str] = None) -> int:
        return self.request(
            {"type": "kv_put", "key": key, "value": value, "lease": lease}
        )["rev"]

    def get(self, key: str) -> Optional[Any]:
        out = self.request({"type": "kv_get", "key": key})
        return out.get("value") if out.get("found") else None

    def delete(self, key: str) -> bool:
        return bool(self.request({"type": "kv_delete", "key": key}).get("found"))

    def range(self, prefix: str) -> dict:
        return self.request({"type": "kv_range", "prefix": prefix})["items"]

    def membership(self) -> dict:
        return self.request({"type": "membership"})

    def telemetry(self) -> dict:
        """Latest heartbeat-piggybacked node snapshot per live worker
        ({"workers": {addr: snapshot}}) — ONE round trip feeds the
        coordinator's whole fleet aggregation."""
        return self.request({"type": "telemetry"})

    def events_since(self, since: int) -> dict:
        return self.request({"type": "events", "since": since})

    # resumption token from the last watch answer ({"term", "rev"}):
    # replayed on the next watch so the service — the SAME node or the
    # one a failover sweep landed on — can prove the watcher missed
    # nothing (`resumed: True`) or demand a resync (`resumed: False`)
    _watch_resume = None

    @property
    def last_watch_resume(self):
        return self._watch_resume

    def _watch_msg(self, since: int, timeout_s: float) -> dict:
        msg = {"type": "watch", "since": since, "timeout_s": timeout_s}
        if self._watch_resume is not None:
            msg["resume"] = self._watch_resume
        return msg

    def _note_watch_answer(self, out: dict) -> dict:
        tok = out.get("resume")
        if tok is not None:
            self._watch_resume = tok
        if out.get("resumed") is False:
            METRICS.add("cluster.client_watch_resyncs")
        return out

    def watch(self, since: int, timeout_s: float = 10.0) -> dict:
        """Long-poll push watch: the service answers on the next
        membership/invalidation event past `since`, or at `timeout_s`.
        The socket timeout is widened past the park interval so the
        park itself never reads as a dead service.  Answers carry a
        resumption token this client replays automatically; after a
        failover, ``resumed: False`` in the answer means events were
        missed and derived state must resync."""
        return self._note_watch_answer(self.request(
            self._watch_msg(since, timeout_s), timeout=timeout_s + 10.0,
        ))

    def invalidate(self, table: str) -> dict:
        return self.request({"type": "invalidate", "table": table})

    def view_advance(self, name: str, revision: int) -> dict:
        """Broadcast a materialized view's new revision; watchers
        parked on `watch` wake with a ``view`` event."""
        return self.request({
            "type": "view_advance", "name": name, "revision": int(revision),
        })

    def result_put(self, key: str, value: dict, nbytes: int,
                   tables: tuple = ()) -> bool:
        return bool(self.request({
            "type": "result_put", "key": key, "value": value,
            "nbytes": nbytes, "tables": list(tables),
        }).get("stored"))

    def result_get(self, key: str) -> dict:
        return self.request({"type": "result_get", "key": key})

    def result_publish(self, key: str, entry, nbytes: int,
                       tables: tuple = (), digests=None) -> int:
        """Publish a `CachedResult` snapshot; returns the bytes that
        actually crossed the transport (the in-process client moves
        references, not bytes).  `digests` (per-column, from
        `shared_cache.column_digests`) ride the stored value so later
        delta republishes can reuse unchanged columns."""
        from datafusion_tpu_torch.cluster.shared_cache import result_raw

        value = {"snapshot": result_raw(entry), "tables": list(tables)}
        if digests is not None:
            value["digests"] = list(digests)
        self.request({
            "type": "result_put", "key": key, "value": value,
            "nbytes": nbytes, "tables": list(tables),
        })
        return 0  # in-process: nothing serialized

    def result_publish_delta(self, key: str, entry, nbytes: int,
                             tables: tuple, digests: list,
                             prev_digests: list) -> Optional[int]:
        """Delta republish: ship only the columns whose digest moved
        since `prev_digests` (this publisher's last publication of
        `key`).  Returns the bytes sent, or None when the service
        demanded a full snapshot (no previous entry, or its digests
        disagree) — the caller falls back to `result_publish`."""
        from datafusion_tpu_torch.cluster.shared_cache import result_raw

        raw = result_raw(entry)
        changed = [
            i for i, d in enumerate(digests)
            if i >= len(prev_digests) or prev_digests[i] != d
        ]
        out = self.request({
            "type": "result_put_delta", "key": key, "nbytes": nbytes,
            "tables": list(tables), "digests": list(digests),
            "segments": {str(i): raw["columns"][i] for i in changed},
            "validity": raw["validity"],
            "dict_values": raw["dict_values"],
            "num_rows": raw["num_rows"],
        })
        if not out.get("stored"):
            return None
        return 0  # in-process: references moved, nothing serialized

    def result_fetch(self, key: str):
        """Fetch a published snapshot: (CachedResult, tables) or None."""
        from datafusion_tpu_torch.cluster.shared_cache import decode_result

        out = self.result_get(key)
        if not out.get("found"):
            return None
        value = out.get("value")
        if not isinstance(value, dict):
            return None
        snap = value.get("snapshot")
        if not isinstance(snap, dict) or "columns" not in snap:
            return None
        return decode_result(snap), tuple(value.get("tables") or ())

    def status(self) -> dict:
        return self.request({"type": "status"})

    def close(self) -> None:
        """Release persistent transport resources (watch channels);
        the in-process client holds none."""


class LocalClusterClient(_ClientApi):
    """In-process client over shared `ClusterNode`s (a bare
    `ClusterState` wraps in an implicit primary node) — the deployment
    shape for tests and single-binary demos.  Accepts a list of nodes
    for in-process HA: the same failover sweep the TCP client runs,
    with a `partitioned` node raising the `ConnectionRefusedError` a
    dead endpoint would."""

    def __init__(self, target):
        from datafusion_tpu_torch.cluster.service import ClusterNode, ClusterState

        def as_node(t):
            if isinstance(t, ClusterNode):
                return t
            if isinstance(t, ClusterState):
                return ClusterNode(state=t)
            raise TypeError(f"cannot serve cluster target {t!r} in-process")

        targets = target if isinstance(target, (list, tuple)) else [target]
        if not targets:
            raise ValueError("LocalClusterClient needs at least one node")
        self.nodes = [as_node(t) for t in targets]
        self._active = 0

    @property
    def state(self):
        """The first node's state machine (single-node back-compat)."""
        return self.nodes[0].state

    def __repr__(self):
        return f"LocalClusterClient({self.nodes!r})"

    def _endpoint_count(self) -> int:
        return len(self.nodes)

    def _endpoint_label(self, idx: int) -> str:
        return self.nodes[idx].addr or f"node{idx}"

    def _endpoint_index_for(self, addr) -> Optional[int]:
        if addr is None:
            return None
        for i, node in enumerate(self.nodes):
            if node.addr == addr or node is addr:
                return i
        return None

    def _request_endpoint(self, idx: int, msg: dict,
                          timeout: Optional[float], bw=None,
                          sent_box=None) -> dict:
        node = self.nodes[idx]
        if node.partitioned:
            raise ConnectionRefusedError(
                f"cluster node {node.addr or idx} is partitioned (injected)"
            )
        return _raise_error_reply(node.handle_request(msg))


class _Channel:
    """One kept-alive socket for a repeating request pattern (watch
    long-polls, heartbeat lease refreshes): requests ride the pinned
    socket until it dies, then fall back to the failover sweep and
    re-pin on whatever endpoint the sweep settled on.  Connects and
    drops count as ``cluster.<name>_channel_connects/_drops``."""

    __slots__ = ("name", "sock", "lock")

    def __init__(self, name: str):
        self.name = name
        self.sock: Optional[socket.socket] = None
        # plain, as in the JAX package: it serializes this one socket's
        # request and reply by design, so a lock-order name would record
        # each `wire.recv` under it as a blocking call
        self.lock = threading.Lock()


class ClusterClient(_ClientApi):
    """TCP client for one or more `ClusterStateService` replicas."""

    def __init__(self, host, port: Optional[int] = None,
                 request_timeout: Optional[float] = 10.0):
        if port is not None:
            endpoints = [(host, int(port))]
        elif isinstance(host, str):
            endpoints = []
            for spec in host.split(","):
                spec = spec.strip()
                if not spec:
                    continue
                h, _, p = spec.rpartition(":")
                endpoints.append((h or "127.0.0.1", int(p)))
        else:
            endpoints = [(h, int(p)) for h, p in host]
        if not endpoints:
            raise ValueError(f"no cluster endpoints in {host!r}")
        self.endpoints = endpoints
        self.request_timeout = request_timeout
        self._active = 0
        # persistent channels: long-poll watches AND heartbeat lease
        # refreshes each re-arm on ONE kept-alive socket (the selector
        # service parks/serves it threadless), so a watcher or a
        # heartbeating agent costs the fleet a connect per failover,
        # not a connect per poll/refresh interval
        self._channels = {"watch": _Channel("watch"),
                          "heartbeat": _Channel("heartbeat")}
        self._closed = False

    def __repr__(self):
        return f"ClusterClient({self.address})"

    def close(self) -> None:
        """Deliberately does NOT take the channel locks: a watcher
        thread may be parked in a long poll (or mid-failover-sweep)
        holding one, and close must not wait that out.  Closing the
        socket out from under the parked recv surfaces as OSError in
        the watcher, which drops the channel; the closed flag stops it
        re-pinning."""
        self._closed = True
        for ch in self._channels.values():
            self._drop_channel(ch)

    @staticmethod
    def _drop_channel(ch: _Channel) -> None:
        sock, ch.sock = ch.sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _channel_send(self, ch: _Channel, msg: dict,
                      reply_timeout: Optional[float]) -> dict:
        # channel lock held; raises on any transport/reply problem — the
        # caller drops the channel and falls back to the failover sweep
        from datafusion_tpu_torch.parallel.wire import (
            CRC_ENABLED,
            WIRE_VERSION,
            recv_msg,
            send_msg,
        )

        if CRC_ENABLED and "wire_version" not in msg:
            msg = {**msg, "wire_version": WIRE_VERSION}
        s = ch.sock
        s.settimeout(reply_timeout)
        send_msg(s, msg, crc=CRC_ENABLED)
        out = recv_msg(s)
        if out is None:
            raise ConnectionError(
                f"cluster service closed the {ch.name} channel")
        return _raise_error_reply(out)

    def _channel_request(self, name: str, msg: dict,
                         reply_timeout: Optional[float]) -> dict:
        """One request over the named persistent channel, falling back
        to the failover sweep (which follows ``not_primary`` redirects)
        and re-pinning a fresh socket on the surviving endpoint."""
        ch = self._channels[name]
        with ch.lock:
            if ch.sock is not None:
                try:
                    return self._channel_send(ch, dict(msg), reply_timeout)
                except (ConnectionError, OSError, ExecutionError):
                    # channel died (failover, idle reset): sweep below
                    self._drop_channel(ch)
                    METRICS.add(f"cluster.{name}_channel_drops")
            out = self.request(msg, timeout=reply_timeout)
            if self._closed:
                return out  # closed mid-sweep: don't re-pin a channel
            try:
                ch.sock = socket.create_connection(
                    self.endpoints[self._active % len(self.endpoints)],
                    timeout=5.0,
                )
                METRICS.add(f"cluster.{name}_channel_connects")
            except OSError:
                ch.sock = None
            return out

    def watch(self, since: int, timeout_s: float = 10.0) -> dict:
        # reply timeout widened past the park interval: the park itself
        # must never read as a dead service
        return self._note_watch_answer(self._channel_request(
            "watch", self._watch_msg(since, timeout_s), timeout_s + 10.0,
        ))

    def lease_refresh(self, lease: str, since: Optional[int] = None,
                      telemetry: Optional[dict] = None) -> dict:
        """Heartbeats ride the persistent channel: an agent refreshes
        every TTL/3 forever, and a fleet of workers each dialing a
        fresh TCP connection per refresh taxes the service's accept
        loop exactly when it is busiest (as the watch channel already
        spares watchers)."""
        return self._channel_request(
            "heartbeat", self._lease_refresh_msg(lease, since, telemetry),
            self.request_timeout,
        )

    @property
    def host(self) -> str:
        return self.endpoints[self._active % len(self.endpoints)][0]

    @property
    def port(self) -> int:
        return self.endpoints[self._active % len(self.endpoints)][1]

    @property
    def address(self) -> str:
        return ",".join(f"{h}:{p}" for h, p in self.endpoints)

    def _endpoint_count(self) -> int:
        return len(self.endpoints)

    def _endpoint_label(self, idx: int) -> str:
        h, p = self.endpoints[idx]
        return f"{h}:{p}"

    def _endpoint_index_for(self, addr) -> Optional[int]:
        if not isinstance(addr, str) or ":" not in addr:
            return None
        h, _, p = addr.rpartition(":")
        try:
            target = (h, int(p))
        except ValueError:
            return None
        for i, ep in enumerate(self.endpoints):
            if ep == target:
                return i
        return None

    def _request_endpoint(self, idx: int, msg: dict,
                          timeout: Optional[float], bw=None,
                          sent_box=None) -> dict:
        from datafusion_tpu_torch.parallel.wire import (
            CRC_ENABLED,
            WIRE_VERSION,
            recv_msg,
            send_msg,
        )

        if CRC_ENABLED and "wire_version" not in msg:
            msg = {**msg, "wire_version": WIRE_VERSION}
        host, port = self.endpoints[idx]
        with obs_trace.span("cluster.request", op=msg.get("type"),
                            endpoint=f"{host}:{port}"):
            with socket.create_connection((host, port), timeout=5.0) as s:
                s.settimeout(timeout if timeout is not None
                             else self.request_timeout)
                sent = send_msg(s, msg, bw, crc=CRC_ENABLED)
                if sent_box is not None:
                    sent_box[0] = sent
                out = recv_msg(s)
        if out is None:
            raise ConnectionError("cluster service closed the connection")
        return _raise_error_reply(out)

    def result_publish(self, key: str, entry, nbytes: int,
                       tables: tuple = (), digests=None) -> int:
        """Publish with the snapshot columns as RAW binary wire
        segments (CRC'd like any fragment payload) instead of inline
        base64 JSON — for large results this is the difference between
        shipping the bytes and shipping the bytes plus a third."""
        from datafusion_tpu_torch.cluster.shared_cache import raw_to_wire, result_raw
        from datafusion_tpu_torch.parallel.wire import BinWriter

        bw = BinWriter()
        wire_snap = raw_to_wire(result_raw(entry), bw)
        value = {"snapshot": wire_snap, "tables": list(tables)}
        if digests is not None:
            value["digests"] = list(digests)
        sent_box = [0]
        self.request({
            "type": "result_put", "key": key, "value": value,
            "nbytes": nbytes, "tables": list(tables),
        }, bw=bw, sent_box=sent_box)
        return sent_box[0]

    def result_publish_delta(self, key: str, entry, nbytes: int,
                             tables: tuple, digests: list,
                             prev_digests: list) -> Optional[int]:
        """Delta republish over TCP: only the changed columns ship as
        RAW binary segments; unchanged ones ship as 16-char digests.
        On a warm republish this cuts `coord.shared_cache_publish_bytes`
        from the full snapshot to roughly the changed fraction."""
        from datafusion_tpu_torch.cluster.shared_cache import _as_array, result_raw
        from datafusion_tpu_torch.parallel.wire import BinWriter, enc_array

        raw = result_raw(entry)
        changed = [
            i for i, d in enumerate(digests)
            if i >= len(prev_digests) or prev_digests[i] != d
        ]
        bw = BinWriter()
        segments = {
            str(i): enc_array(_as_array(raw["columns"][i]), bw)
            for i in changed
        }
        validity = [
            None if v is None else enc_array(_as_array(v), bw)
            for v in raw["validity"]
        ]
        sent_box = [0]
        out = self.request({
            "type": "result_put_delta", "key": key, "nbytes": nbytes,
            "tables": list(tables), "digests": list(digests),
            "segments": segments, "validity": validity,
            "dict_values": raw["dict_values"],
            "num_rows": raw["num_rows"],
        }, bw=bw, sent_box=sent_box)
        if not out.get("stored"):
            return None
        return sent_box[0]
