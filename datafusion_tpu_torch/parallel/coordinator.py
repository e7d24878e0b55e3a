"""Multi-process coordinator: ships plan fragments to worker processes
and merges their partial results (the JAX package's
`parallel/coordinator.py`, less its cluster half).

Each partition becomes a `PlanFragment` (JSON logical plan +
DataSourceMeta); a worker (`python -m datafusion_tpu_torch.worker`)
runs the scan, the filter and the aggregate through the port's kernels
on its device and returns *partial aggregate state*; the coordinator
re-encodes every worker's group keys into its own dense id space and
combines the accumulators on the host (SUM/COUNT add, MIN/MAX meet,
Utf8 MIN/MAX on the strings themselves: worker dictionary codes never
cross processes).  Row fragments return rows, which the coordinator
unions; a join over partitioned inputs runs as a hash-partitioned
shuffle (parallel/shuffle.py).  What the coordinator itself runs above
them (a sort, an aggregate over a shuffle join, a local hash join under
``DATAFUSION_TPU_SHUFFLE=0``) runs on its own device through the port's
kernels.

Failure handling: the query is the recovery unit.  A fragment whose
worker dies (connection refused/reset, mid-query EOF, garbled stream)
is reassigned to the next live worker; the query fails only when no
workers remain *and* a synchronous re-probe round finds none
recovered.  A `HeartbeatMonitor` keeps probing down workers in the
background and re-admits them after a probation cycle.  Fragments
carry idempotent ids (`query_id/shard`), and the merge loops skip
duplicate responses, so a replayed fragment is never double-merged.
A per-query deadline (`query_deadline_s`) rides every fragment request
as the remaining budget.  Hedged requests (`utils/hedge.py`), circuit
breakers (`utils/breaker.py`) and the retry budget
(`utils/retry.retry_budget`) guard the dispatch, each off by default.

Cluster membership, the shared result tier, the fleet telemetry
aggregator, the debug HTTP server, the `fleet_*` gauges, `top_text`
and the pin-aware placement wait for ROADMAP item 13.2.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Iterator, Optional, Sequence

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import (
    ExecutionError,
    PlanError,
    QueryDeadlineError,
)
from datafusion_tpu_torch.exec.aggregate import AggregateRelation, _flips, _HostState
from datafusion_tpu_torch.exec.batch import RecordBatch, StringDictionary, make_host_batch
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.obs import recorder as flight
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.parallel.partition import PartitionedDataSource
from datafusion_tpu_torch.parallel.physical import PlanFragment
from datafusion_tpu_torch.parallel.wire import (
    CRC_ENABLED,
    WIRE_VERSION,
    BinWriter,
    dec_array,
    enc_array,
    recv_msg,
    send_msg,
)
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    Join,
    LogicalPlan,
    Projection,
    Selection,
    TableScan,
)
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.deadline import Deadline
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import backoff_s


class RequestTimeoutError(ExecutionError):
    """A worker accepted the connection but its response outran the
    request timeout.  Distinct type so the dispatcher can tell "the
    deadline budget ran out" apart from a genuine worker error."""


class WorkerHandle:
    """One worker endpoint; lazily (re)connects per use."""

    def __init__(self, host: str, port: int, request_timeout: Optional[float] = None):
        self.host = host
        self.port = port
        self.alive = True
        # None = wait for the fragment however long it takes; a slow
        # worker is NOT a dead worker (marking it dead on a response
        # timeout would replay the fragment elsewhere, time out again,
        # and cascade to "all workers down")
        self.request_timeout = request_timeout

    def __repr__(self):
        return f"worker({self.host}:{self.port}, {'up' if self.alive else 'down'})"

    def request(self, msg: dict, timeout: Optional[float] = -1,
                bw=None) -> dict:
        """`bw` (a wire.BinWriter) attaches CRC'd binary segments to
        the REQUEST frame — shuffle-join dispatches ship their block
        payloads this way instead of base64-inlining them in JSON."""
        if timeout == -1:
            timeout = self.request_timeout
        if CRC_ENABLED and "wire_version" not in msg:
            # advertise the protocol version (the CRC handshake): a v2
            # worker answers binary frames with per-segment CRC32s
            msg = {**msg, "wire_version": WIRE_VERSION}
        # connect is bounded by the per-call timeout too (capped at
        # 10s): a scrape-path pull with timeout=2.0 must not spend 10s
        # in SYN retries against a blackholed worker.  timeout=None
        # means "wait however long for the RESPONSE" — the connect
        # itself still gets the 10s cap
        connect_timeout = 10.0 if timeout is None else min(timeout, 10.0)
        import socket

        with socket.create_connection(
            (self.host, self.port), timeout=connect_timeout
        ) as s:
            s.settimeout(timeout)
            METRICS.add("wire.bytes_sent", send_msg(s, msg, bw, crc=CRC_ENABLED))
            try:
                out = recv_msg(s)
            except TimeoutError as e:
                # distinguish slow from dead: the connection succeeded,
                # so surface the deadline instead of failing over
                raise RequestTimeoutError(
                    f"worker {self.host}:{self.port} exceeded the "
                    f"{timeout}s request timeout (raise request_timeout "
                    "for long fragments)"
                ) from e
        if out is None:
            raise ConnectionError("worker closed the connection")
        if out.get("type") == "error":
            raise ExecutionError(f"worker {self.host}:{self.port}: {out['message']}")
        return out

    def probe(self) -> bool:
        """Liveness check that does NOT touch `alive` — state
        transitions belong to the heartbeat monitor / dispatch loop, so
        a concurrent probe can't yank a worker out from under them."""
        try:
            return self.request({"type": "ping"}, timeout=5.0)["type"] == "pong"
        except (ConnectionError, OSError, ExecutionError):
            # unreachable, wedged past the probe deadline, or erroring:
            # all report as not-healthy rather than crashing the probe
            return False

    def ping(self) -> bool:
        self.alive = self.probe()
        return self.alive

    def mark_down(self) -> None:
        if self.alive:
            METRICS.add("coord.worker_marked_down")
        self.alive = False

    def readmit(self) -> None:
        if not self.alive:
            METRICS.add("coord.worker_readmitted")
        self.alive = True

    def status(self) -> dict:
        """Operator introspection: uptime, query/error counts, device,
        metrics snapshot (the worker web UI the reference planned,
        delivered over the fragment protocol instead)."""
        return self.request({"type": "status"}, timeout=10.0)


class HeartbeatMonitor:
    """Coordinator-side failure detection and worker re-admission.

    Dispatch failover marks a worker dead on connection failure; this
    loop probes every worker each cycle:

    - a DOWN worker that answers `probation_pings` consecutive probes
      (its probation cycle) is re-admitted to the rotation;
    - an UP worker that misses `fail_threshold` consecutive probes is
      marked down, so dispatch stops picking it before the next connect
      has to fail.

    The sleep between cycles is jittered (+-20%).  `poll_once()` runs
    one cycle synchronously, for tests.  (The JAX package's cluster mode,
    which consumes a shared membership view instead of probing, waits
    for ROADMAP item 13.2.)
    """

    def __init__(self, workers: list[WorkerHandle], interval: float = 5.0,
                 probation_pings: int = 1, fail_threshold: int = 2):
        self.workers = workers
        self.interval = interval
        self.probation_pings = probation_pings
        self.fail_threshold = fail_threshold
        self._ok: dict[int, int] = {}
        self._bad: dict[int, int] = {}
        self._seen_alive: dict[int, bool] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> None:
        for i, w in enumerate(self.workers):
            # dispatch failover (or a last-gasp re-probe) can flip a
            # worker's state between cycles; stale streaks must not
            # carry over or probation/fail thresholds are bypassed
            if self._seen_alive.get(i, w.alive) != w.alive:
                self._ok[i] = 0
                self._bad[i] = 0
            if w.probe():
                self._bad[i] = 0
                self._ok[i] = self._ok.get(i, 0) + 1
                if not w.alive and self._ok[i] >= self.probation_pings:
                    w.readmit()
            else:
                self._ok[i] = 0
                self._bad[i] = self._bad.get(i, 0) + 1
                if w.alive and self._bad[i] >= self.fail_threshold:
                    w.mark_down()
            self._seen_alive[i] = w.alive

    def _loop(self) -> None:
        import random

        while not self._stop.wait(self.interval * random.uniform(0.8, 1.2)):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the monitor must outlive probes
                METRICS.add("coord.heartbeat_errors")

    def start(self) -> "HeartbeatMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="df-torch-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None


class _SchemaOnlyRelation(Relation):
    """Zero-batch child used to instantiate the coordinator's template
    AggregateRelation (it supplies slot/spec machinery + finalize; the
    actual scanning happens on workers)."""

    def __init__(self, schema: Schema):
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[RecordBatch]:
        return iter(())


# how many synchronous re-probe rounds dispatch runs when every worker
# looks dead before it gives up on the query
_DISPATCH_PROBE_ROUNDS = 2


def _dispatch(workers: list[WorkerHandle], fragments: list[PlanFragment],
              request_type: str,
              deadline: Optional[Deadline] = None,
              hedge=None, local_exec=None, extra: Optional[dict] = None,
              ) -> list[tuple[PlanFragment, dict]]:
    """Send the fragments to the workers concurrently (round-robin over
    live workers; one thread per in-flight fragment, so N workers
    genuinely run N fragments at once), reassigning on connection
    failure.  Returns one (fragment, response) pair per fragment.

    When every worker looks dead the dispatcher does not fail
    immediately: it runs up to `_DISPATCH_PROBE_ROUNDS` synchronous
    probe rounds (with jittered backoff between them) and re-admits any
    worker that answers — a crashed-then-restarted worker recovers a
    query even with the background heartbeat disabled.  `deadline`
    bounds the whole fragment, including reassignment retries, and
    rides each request as the remaining budget in seconds.

    **Gray-failure resilience** (each default off, each leaving the
    path above byte-identical when off):

    - `hedge` (a `utils/hedge.HedgeTracker`): a dispatched fragment
      that outruns its worker's hedge threshold (observed-quantile x
      factor, floor-clamped) is speculatively re-sent to a different
      live worker; the first successful response wins, the loser's
      duplicate is discarded (idempotent ``(query_id, shard)`` ids +
      merge-side dedup make that safe).  ``coord.hedges_*`` counters
      and ``hedged``/``hedge_won`` span markers record every decision.
    - per-target **circuit breakers** (`utils/breaker`, env-armed):
      worker picks skip targets whose breaker is open (recent evidence
      says sick) while any alternative exists; request outcomes —
      including a hedge loser's, reported from its own attempt thread —
      feed the breakers, a response *timeout* counting as the gray
      failure it is (without marking the worker dead: slow != dead).
    - the process **retry budget** (`utils/retry.retry_budget`): each
      fragment's first dispatch earns credit, each reassignment replay
      spends it, and an empty bucket fails the fragment instead of
      joining a correlated retry storm.
    - `local_exec` (degraded mode, DATAFUSION_TPU_LOCAL_FALLBACK):
      when every worker is dead AND the synchronous probe rounds find
      nothing, run the fragment on the coordinator itself rather than
      failing the query (``coord.local_fallbacks``).
    """
    import itertools
    import queue as _queue
    from concurrent.futures import ThreadPoolExecutor

    from datafusion_tpu_torch.utils import breaker as breaker_mod
    from datafusion_tpu_torch.utils.retry import retry_budget

    from datafusion_tpu_torch.obs import attribution as _attribution

    if not workers:
        raise ExecutionError("no workers configured")
    rr = itertools.count()
    budget = retry_budget()
    # captured HERE because contextvars don't cross into pool threads:
    # per-fragment dispatch spans parent under the caller's span, and
    # the wire context makes worker-side spans chain under those
    trace_parent = obs_trace.current_span()
    trace_wire = obs_trace.wire_context()
    # the metering scope is thread-published like the profiler tables,
    # so it too is captured at the dispatch boundary: a hedge LOSER's
    # duplicate wall — reported from its own attempt thread, possibly
    # minutes later — must charge the hedging query's client
    meter_scope = _attribution.current_scope()
    # the tenant the per-tenant isolation budgets bill (qos.py): the
    # dispatch scope's solo client, or a shared scope's dominant-weight
    # member — None (untenanted / QoS off) keeps the global-only path
    from datafusion_tpu_torch import qos as _qos

    tenant = _qos.scope_client(meter_scope)

    def _breaker(w):
        return breaker_mod.breaker_for(f"worker:{w.host}:{w.port}")

    def pick_worker(live):
        """Round-robin over live workers, skipping targets whose
        breaker denies (open circuit: fast-fail instead of paying the
        sick target's timeout) — unless every live worker is denied,
        where availability beats protection."""
        for _ in range(len(live)):
            cand = live[next(rr) % len(live)]
            b = _breaker(cand)
            if b is None or b.allow():
                return cand
            METRICS.add("coord.breaker_skips")
        METRICS.add("coord.breaker_bypassed")
        return live[next(rr) % len(live)]

    def pick_hedge_target(primary):
        """A different live, breaker-admitted worker for the hedge —
        None when the primary is the only choice."""
        live = [w for w in workers if w.alive and w is not primary]
        for _ in range(len(live)):
            cand = live[next(rr) % len(live)]
            b = _breaker(cand)
            if b is None or b.allow():
                return cand
        return None

    def hedged_request(primary, frag, msg, timeout, sp):
        """Dispatch with speculative re-dispatch (see the function
        doc).  Each attempt runs on its own daemon thread and does its
        OWN outcome bookkeeping (breaker record, latency observation,
        mark-down on connection failure) before reporting — so an
        abandoned loser still delivers its evidence when it eventually
        finishes, minutes after the winner returned."""
        results: _queue.Queue = _queue.Queue()
        # the winning worker's handle, written by the chooser the
        # moment a first valid response is accepted: an attempt that
        # finishes AFTER that and is not the winner is a hedge LOSER —
        # its wall was pure duplicate cost, metered to the hedging
        # query's client (never to the critical path)
        won: list = [None]

        def attempt(worker, a_msg, hedged, a_sp, a_timeout):
            t0 = time.perf_counter()
            r, err = None, None
            try:
                try:
                    r = worker.request(a_msg, timeout=a_timeout)
                except Exception as e:  # noqa: BLE001 — ferried to the chooser below
                    err = e
                b = _breaker(worker)
                if err is None:
                    if b is not None:
                        b.record(True)
                    hedge.observe(f"{worker.host}:{worker.port}",
                                  time.perf_counter() - t0)
                elif isinstance(err, RequestTimeoutError):
                    # alive-but-slow: the gray-failure evidence breakers
                    # exist for — but NOT a mark_down (slow != dead)
                    if b is not None:
                        b.record(False)
                elif isinstance(err, (ConnectionError, OSError)):
                    if b is not None:
                        b.record(False)
                    worker.mark_down()
                elif b is not None:
                    # answered-with-error (bad plan, execution failure):
                    # transport-healthy; also releases the probe slot
                    b.record(True)
                if a_sp is not None:
                    if err is not None:
                        a_sp.attrs["failed"] = type(err).__name__
                    obs_trace.finish_span(a_sp)
            finally:
                results.put((worker, hedged, r, err))
                if won[0] is not None and won[0] is not worker:
                    # abandoned loser finishing late: its whole wall
                    # is duplicate work the hedging client pays for
                    # (a loser that finished BEFORE any winner failed
                    # — an error, not duplicate device time)
                    _attribution.charge_hedge_loss(
                        meter_scope, time.perf_counter() - t0
                    )

        hedge.observe_dispatch(tenant)
        threading.Thread(
            target=attempt, args=(primary, msg, False, None, timeout),
            name="df-torch-dispatch", daemon=True,
        ).start()
        inflight = 1
        launched = False

        def launch_hedge(after_s):
            nonlocal inflight, launched
            # budget BEFORE target: pick_hedge_target's allow() reserves
            # a half-open probe slot on the chosen worker, and a denied
            # budget after that reservation would leak the slot (no
            # request ever pairs a record() with it) — permanently
            # exiling a recovering worker
            if not hedge.try_hedge(tenant):
                METRICS.add("coord.hedges_suppressed")
                return
            # deadline BEFORE target, for the same reason as budget:
            # any return after pick_hedge_target's allow() reservation
            # that never dispatches would leak the probe slot.  The
            # hedge also gets the budget REMAINING NOW, not the stale
            # value computed at primary-dispatch time — a hedged
            # fragment must not run up to ~2x the query deadline
            h_timeout = timeout
            if deadline is not None:
                remaining = deadline.remaining()
                if remaining <= 0.001:
                    hedge.refund(tenant)  # no budget left to hedge inside
                    METRICS.add("coord.hedges_suppressed")
                    return
                h_timeout = remaining
            alt = pick_hedge_target(primary)
            if alt is None:
                hedge.refund(tenant)  # approved but nobody to send it to
                METRICS.add("coord.hedges_suppressed")
                return
            if deadline is not None and alt.request_timeout is not None:
                h_timeout = min(h_timeout, alt.request_timeout)
            # `launched` only flips once an attempt REALLY starts: a
            # suppressed threshold-time hedge leaves the timeout-time
            # retry armed (tokens may have accrued, a breaker cooled)
            launched = True
            h_msg = dict(msg)
            if deadline is not None:
                h_msg["deadline_s"] = max(deadline.remaining(), 0.001)
            h_sp = None
            if trace_wire is not None:
                # "hedge_attempt" distinguishes the speculative
                # attempt's own span from the primary request-record
                # span (which gets a mutated "hedged" marker): the
                # critical-path walk (obs/attribution.py) excludes a
                # still-running attempt as a loser ONLY when the
                # primary record lacks hedge_won
                h_sp = obs_trace.begin_span(
                    "coord.dispatch", parent=trace_parent,
                    trace_id=trace_wire["trace_id"],
                    attrs={**frag.span_attrs(), "hedged": True,
                           "hedge_attempt": True,
                           "worker": f"{alt.host}:{alt.port}"},
                )
                h_msg["trace"] = {**trace_wire,
                                  "parent_span_id": h_sp.span_id}
            METRICS.add("coord.hedges_dispatched")
            flight.record("query.hedge", shard=frag.shard,
                          slow=f"{primary.host}:{primary.port}",
                          hedge=f"{alt.host}:{alt.port}",
                          after_s=round(after_s, 4))
            if sp is not None:
                sp.attrs["hedged"] = True
            threading.Thread(
                target=attempt, args=(alt, h_msg, True, h_sp, h_timeout),
                name="df-torch-hedge", daemon=True,
            ).start()
            inflight += 1

        first = None
        wait_s = hedge.threshold_s(f"{primary.host}:{primary.port}")
        if deadline is not None:
            wait_s = min(wait_s, max(deadline.remaining(), 0.001))
        try:
            first = results.get(timeout=wait_s)
        except _queue.Empty:
            launch_hedge(wait_s)
        errors = []
        while True:
            if first is None:
                if inflight <= 0:
                    break
                first = results.get()
            worker, hedged, resp, err = first
            first = None
            inflight -= 1
            if err is None:
                won[0] = worker  # late-finishing losers self-report
                if hedged:
                    METRICS.add("coord.hedges_won")
                    flight.record("query.hedge_won", shard=frag.shard,
                                  worker=f"{worker.host}:{worker.port}")
                    if sp is not None:
                        sp.attrs["hedge_won"] = True
                        sp.attrs["winner"] = f"{worker.host}:{worker.port}"
                elif inflight:
                    METRICS.add("coord.hedges_lost")  # primary outran it
                return resp
            errors.append((hedged, err))
            if not hedged and not launched \
                    and isinstance(err, RequestTimeoutError):
                # the primary's request TIMEOUT beat the hedge threshold
                # (a tight per-request timeout, or a threshold inflated
                # by cold-run history): the timeout IS the straggler
                # signal — hedge now rather than fail the fragment
                launch_hedge(wait_s)
        # every attempt failed: surface the PRIMARY's error — its type
        # drives the caller's failover-vs-timeout handling, and the
        # attempt threads already did the per-worker bookkeeping
        for hedged, err in errors:
            if not hedged:
                raise err
        raise errors[0][1]

    def run(item):
        fi, frag = item
        attempts = 0
        probe_rounds = 0
        if budget is not None:
            budget.earn(tenant)  # a fragment's first dispatch accrues credit
        while True:
            if deadline is not None:
                deadline.check(f"fragment {fi}/{len(fragments)}")
            live = [w for w in workers if w.alive]
            if not live:
                # last-gasp synchronous re-probe: restart recovery must
                # not depend on the heartbeat thread being enabled
                probe_rounds += 1
                recovered = False
                for w in workers:
                    if w.probe():
                        w.readmit()
                        recovered = True
                if recovered:
                    continue
                if probe_rounds <= _DISPATCH_PROBE_ROUNDS:
                    time.sleep(backoff_s(probe_rounds, base=0.05, cap=0.5))
                    continue
                if local_exec is not None:
                    # degraded mode: every worker is gone and probing
                    # found nothing — run the fragment HERE rather than
                    # fail the query (explicit, counted, flight-marked)
                    METRICS.add("coord.local_fallbacks")
                    flight.record("query.local_fallback", shard=frag.shard)
                    return frag, local_exec(frag, request_type)
                raise ExecutionError(
                    f"all {len(workers)} workers are down "
                    f"(fragment {fi}/{len(fragments)})"
                )
            w = pick_worker(live)
            msg = {"type": request_type, "fragment": frag.to_json_str()}
            if extra:
                # request-kind parameters riding beside the fragment
                # (e.g. shuffle_map's keys/num_parts/side)
                msg.update(extra)
            timeout = -1
            if deadline is not None:
                msg["deadline_s"] = max(deadline.remaining(), 0.001)
                timeout = msg["deadline_s"]
                if w.request_timeout is not None:
                    timeout = min(timeout, w.request_timeout)
            sp = None
            if trace_wire is not None:
                sp = obs_trace.begin_span(
                    "coord.dispatch", parent=trace_parent,
                    trace_id=trace_wire["trace_id"],
                    attrs={**frag.span_attrs(),
                           "worker": f"{w.host}:{w.port}",
                           "attempt": attempts},
                )
                # worker-side spans parent under THIS dispatch span
                msg["trace"] = {**trace_wire, "parent_span_id": sp.span_id}
            flight.record("query.dispatch", shard=frag.shard,
                          worker=f"{w.host}:{w.port}", attempt=attempts)
            # hedging needs a second live worker to re-dispatch to; the
            # hedged path owns its per-attempt breaker/liveness
            # bookkeeping — but only once an attempt actually STARTS
            # (`attempted_by_hedge`): an exception before that (the
            # coord.request fault site) is handled inline like the
            # non-hedged path, or the pick's probe reservation leaks
            hedging = hedge is not None and len(live) > 1
            attempted_by_hedge = False
            try:
                faults.check("coord.request", shard=frag.shard)
                if hedging:
                    attempted_by_hedge = True
                    resp = hedged_request(w, frag, msg, timeout, sp)
                else:
                    resp = w.request(msg, timeout=timeout)
                    b = _breaker(w)
                    if b is not None:
                        b.record(True)
                if resp.get("cache_hit"):
                    # the worker served this fragment from its fragment
                    # cache (no partition re-scan) — the flag rides the
                    # wire response and surfaces in the dispatch span
                    METRICS.add("coord.fragment_cache_hits")
                    if sp is not None:
                        sp.attrs["cache_hit"] = True
                obs_trace.finish_span(sp)
                obs_trace.ingest(resp.pop("spans", None))
                return frag, resp
            except (ConnectionError, OSError):
                if sp is not None:
                    sp.attrs["failed_over"] = True
                    obs_trace.finish_span(sp)
                # connect refused/reset, mid-query EOF, or a garbled
                # stream (wire.ProtocolError): the query is the recovery
                # unit — mark the worker dead and replay this fragment
                # elsewhere.  (A response *timeout* is an ExecutionError,
                # not a failover: slow != dead.)
                if not attempted_by_hedge:
                    w.mark_down()
                    b = _breaker(w)
                    if b is not None:
                        b.record(False)
                METRICS.add("coord.fragment_reassigned")
                flight.record("worker.failover", shard=frag.shard,
                              worker=f"{w.host}:{w.port}",
                              attempt=attempts)
                attempts += 1
                if attempts > len(workers) + _DISPATCH_PROBE_ROUNDS:
                    raise ExecutionError(
                        f"fragment reassignment exhausted "
                        f"(fragment {fi}: {attempts} attempts)"
                    ) from None
                if budget is not None and not budget.spend(tenant):
                    METRICS.add("coord.reassign_budget_denied")
                    raise ExecutionError(
                        f"fragment {fi} reassignment denied: the retry "
                        f"budget is exhausted (correlated-failure storm "
                        f"control; utils/retry.set_retry_budget)"
                    ) from None
            except RequestTimeoutError as e:
                if sp is not None:
                    sp.attrs["timed_out"] = True
                    obs_trace.finish_span(sp)
                if not attempted_by_hedge:
                    b = _breaker(w)
                    if b is not None:
                        b.record(False)  # gray failure: slow, not dead
                # only the socket-timeout error is eligible: a genuine
                # worker error (bad plan, execution failure) must keep
                # its message even when the deadline has since lapsed
                if deadline is not None and deadline.expired:
                    raise QueryDeadlineError(
                        f"fragment {fi}/{len(fragments)} exceeded the "
                        f"query deadline"
                    ) from e
                raise
            except ExecutionError:
                # the worker ANSWERED, with an application error (bad
                # plan, execution failure): transport-healthy evidence
                # — and the half-open probe slot a reserving pick took
                # must be released.  The error itself propagates.
                if not attempted_by_hedge:
                    b = _breaker(w)
                    if b is not None:
                        b.record(True)
                raise

    with ThreadPoolExecutor(max_workers=min(len(fragments) or 1, 32)) as ex:
        return list(ex.map(run, enumerate(fragments)))


def _check_fragment_plan(plan: LogicalPlan) -> None:
    """Reject a fragment plan that fails static verification BEFORE any
    dispatch happens (analysis/verify.py).  `PlanVerificationError` is
    deliberately non-transient: an invalid plan replayed on another
    worker is still invalid, so the failover/retry machinery must not
    burn its budget on it.  Rejections count as ``coord.plan_rejected``
    (rendered by EXPLAIN ANALYZE when nonzero)."""
    from datafusion_tpu_torch.analysis import verify as _averify

    if not _averify.verify_enabled():
        return
    report = _averify.verify_plan(plan)
    if not report.ok:
        METRICS.add("coord.plan_rejected")
        report.raise_if_failed()



def _iter_unique_responses(responses):
    """Yield (fragment, response) once per fragment id.  Defense in
    depth behind the idempotent-id scheme: today's `_dispatch` returns
    exactly one response per fragment, but any future retry path that
    races a replay against a merely-slow first response lands here — a
    duplicate must be dropped, never double-merged into SUM/COUNT
    accumulators."""
    seen: set = set()
    for frag, resp in responses:
        fid = resp.get("fragment_id") or frag.fragment_id
        if fid in seen:
            METRICS.add("coord.duplicate_responses_dropped")
            continue
        seen.add(fid)
        yield frag, resp


def _device_image(sl, acc: np.ndarray) -> np.ndarray:
    """A merged accumulator (the slot's numpy dtype, as workers ship
    it) in the layout the aggregate's finalize reads back
    (`exec/aggregate._host_acc`'s inverse): a UInt64 MIN/MAX slot as
    its sign-flipped int64 image, every other slot as it is."""
    if _flips(sl):
        return acc.view(np.int64) ^ np.int64(-(1 << 63))
    return acc


class DistributedAggregateRelation(Relation):
    """[Selection +] Aggregate over partitions executed by remote
    workers; the coordinator merges partial states by *key*, on the
    host, in fragment order (so the f64 bits repeat run to run)."""

    def __init__(self, plan, agg, pred, scan, ds: PartitionedDataSource,
                 workers: list[WorkerHandle], device, functions=None,
                 query_deadline_s: Optional[float] = None,
                 hedge=None, local_exec=None):
        # verified once at construction: the plan is immutable, and
        # batches()/re-collects must not re-walk it per iteration
        _check_fragment_plan(plan)
        in_schema = scan.schema
        self.template = AggregateRelation(
            _SchemaOnlyRelation(in_schema),
            agg.group_expr,
            agg.aggr_expr,
            agg.schema,
            device,
            predicate=pred,
            functions=functions,
        )
        self.plan = plan
        self.ds = ds
        self.workers = workers
        self.in_schema = in_schema
        self.query_deadline_s = query_deadline_s
        self.hedge = hedge
        self.local_exec = local_exec

    @property
    def schema(self) -> Schema:
        return self.template.schema

    def _fragments(self) -> list[PlanFragment]:
        n = len(self.ds.partitions)
        plan_json = self.plan.to_json()
        qid = uuid.uuid4().hex[:12]
        return [
            PlanFragment(i, n, plan_json, p.to_meta(), qid)
            for i, p in enumerate(self.ds.partitions)
        ]

    def op_label(self) -> str:
        return (
            f"DistributedAggregate[partitions={len(self.ds.partitions)}, "
            f"workers={len(self.workers)}]"
        )

    def batches(self) -> Iterator[RecordBatch]:
        t = self.template
        if obs_trace.enabled():
            self.stats.attrs.update(
                partitions=len(self.ds.partitions), workers=len(self.workers)
            )
        deadline = (
            None
            if self.query_deadline_s is None
            else Deadline.after(self.query_deadline_s)
        )
        responses = _dispatch(
            self.workers, self._fragments(), "execute_fragment", deadline,
            hedge=self.hedge, local_exec=self.local_exec,
        )

        n_keys = len(t.key_cols)
        global_agg = n_keys == 0
        counts = np.zeros(1 if global_agg else 0, np.int64)
        accs = [
            np.full(
                1 if global_agg else 0,
                t.core._slot_identity(sl),
                dtype=np.dtype(t.core._slot_identity(sl).dtype),
            )
            for sl in t.slots
        ]
        # Utf8 MIN/MAX merges on the strings themselves (worker codes
        # are process-local); best[s] holds the current best string per
        # group, converted to coordinator codes at the end (length 1 up
        # front for the global-aggregate single group)
        best_str: dict[int, list] = {
            i: ([None] if global_agg else [])
            for i, sl in enumerate(t.slots)
            if sl.is_string
        }
        key_dicts: dict[int, StringDictionary] = {}

        def grow(n_groups: int):
            nonlocal counts
            pad = n_groups - len(counts)
            if pad <= 0:
                return
            counts = np.concatenate([counts, np.zeros(pad, np.int64)])
            for i, sl in enumerate(t.slots):
                ident = t.core._slot_identity(sl)
                accs[i] = np.concatenate(
                    [accs[i], np.full(pad, ident, dtype=accs[i].dtype)]
                )
            for s in best_str:
                best_str[s].extend([None] * pad)

        for _frag, resp in _iter_unique_responses(responses):
            g = resp["num_groups"]
            if g == 0:
                continue  # empty partition: nothing to merge
            w_counts = dec_array(resp["counts"])
            w_slots = [dec_array(s) for s in resp["slots"]]
            if global_agg:
                ids = np.zeros(g, np.int64)
            else:
                key_rows = dec_array(resp["key_rows"])  # (g, 2K) int64
                cols, valids = [], []
                for k, idx in enumerate(t.key_cols):
                    vals = key_rows[:, 2 * k].copy()
                    isnull = key_rows[:, 2 * k + 1] != 0
                    wdict = resp["key_dicts"].get(str(k))
                    if self.in_schema.field(idx).data_type == DataType.UTF8:
                        d = key_dicts.setdefault(idx, StringDictionary())
                        t._key_dicts[idx] = d
                        if wdict:
                            lut = np.fromiter(
                                (d.add(s) for s in wdict), np.int64, len(wdict)
                            )
                            in_range = (vals >= 0) & (vals < len(lut))
                            vals = np.where(in_range, lut[np.clip(vals, 0, len(lut) - 1)], 0)
                    cols.append(vals)
                    valids.append(None if not isnull.any() else ~isnull)
                ids = t.encoder.encode(cols, valids).astype(np.int64)
                grow(t.encoder.num_groups)

            np.add.at(counts, ids, w_counts)
            for i, sl in enumerate(t.slots):
                w = w_slots[i]
                if sl.kind in ("sum", "cnt"):
                    np.add.at(accs[i], ids, w.astype(accs[i].dtype))
                elif sl.kind == "min":
                    np.minimum.at(accs[i], ids, w.astype(accs[i].dtype))
                elif sl.kind == "max":
                    np.maximum.at(accs[i], ids, w.astype(accs[i].dtype))
                else:  # smin / smax: compare actual strings
                    values = resp["slot_dicts"].get(str(i)) or []
                    bl = best_str[i]
                    for gi, code in zip(ids.tolist(), w.tolist()):
                        if code < 0 or code >= len(values):
                            continue
                        s = values[code]
                        cur = bl[gi]
                        if cur is None or (
                            s < cur if sl.kind == "smin" else s > cur
                        ):
                            bl[gi] = s

        flight.record("query.merge", partitions=len(self.ds.partitions),
                      groups=int(len(counts)))
        # convert best strings to coordinator dictionary codes so the
        # standard finalize path decodes them
        for i, bl in best_str.items():
            d = StringDictionary()
            t._str_dicts[i] = d
            accs[i] = np.asarray(
                [-1 if s is None else d.add(s) for s in bl], np.int32
            )

        yield t.finalize(_HostState(
            counts, [_device_image(sl, a) for sl, a in zip(t.slots, accs)]))


class DistributedUnionRelation(Relation):
    """Projection/Selection fragments over partitions, executed by
    workers; the coordinator unions the returned rows (parallel scans,
    not only aggregates)."""

    def __init__(self, plan, ds: PartitionedDataSource, workers: list[WorkerHandle],
                 query_deadline_s: Optional[float] = None,
                 hedge=None, local_exec=None):
        _check_fragment_plan(plan)
        self.plan = plan
        self.ds = ds
        self.workers = workers
        self._schema = plan.schema
        self.query_deadline_s = query_deadline_s
        self.hedge = hedge
        self.local_exec = local_exec

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        return (
            f"DistributedUnion[partitions={len(self.ds.partitions)}, "
            f"workers={len(self.workers)}]"
        )

    def batches(self) -> Iterator[RecordBatch]:
        n = len(self.ds.partitions)
        if obs_trace.enabled():
            self.stats.attrs.update(partitions=n, workers=len(self.workers))
        plan_json = self.plan.to_json()
        qid = uuid.uuid4().hex[:12]
        fragments = [
            PlanFragment(i, n, plan_json, p.to_meta(), qid)
            for i, p in enumerate(self.ds.partitions)
        ]
        deadline = (
            None
            if self.query_deadline_s is None
            else Deadline.after(self.query_deadline_s)
        )
        responses = _dispatch(self.workers, fragments, "execute_plan", deadline,
                              hedge=self.hedge, local_exec=self.local_exec)
        dicts: list[Optional[StringDictionary]] = [
            StringDictionary() if f.data_type == DataType.UTF8 else None
            for f in self._schema.fields
        ]
        flight.record("query.merge", partitions=n,
                      responses=len(responses))
        for _frag, resp in _iter_unique_responses(responses):
            if resp["num_rows"] == 0:
                continue
            cols = []
            for i, f in enumerate(self._schema.fields):
                c = resp["columns"][i]
                if f.data_type == DataType.UTF8:
                    # codes + value table (codes ride the binary frame);
                    # remap the worker-local codes into OUR dictionary
                    codes = dec_array(c["codes"])
                    cols.append(dicts[i].merge_codes(codes, c["values"]))
                else:
                    cols.append(dec_array(c).astype(f.data_type.np_dtype))
            valids = [
                None if v is None else dec_array(v)
                for v in resp["validity"]
            ]
            yield make_host_batch(self._schema, cols, valids, list(dicts))


def _match_shippable_aggregate(plan: LogicalPlan, datasources: dict):
    """Aggregate[(Selection)](TableScan over a partitioned table) —
    the fragment shape workers execute wholesale."""
    if not isinstance(plan, Aggregate):
        return None, None, None
    inner = plan.input
    pred = None
    if isinstance(inner, Selection):
        pred = inner.expr
        inner = inner.input
    if not isinstance(inner, TableScan):
        return None, None, None
    if not isinstance(datasources.get(inner.table_name), PartitionedDataSource):
        return None, None, None
    return plan, pred, inner


class DistributedShuffleJoinRelation(Relation):
    """Hash-partitioned shuffle join (parallel/shuffle.py).

    Each side is either **shippable** — a Projection/Selection chain
    over a partitioned table, executed as `shuffle_map` fragments on
    workers — or **coordinator-local** (any other relation, including
    a nested distributed join), whose rows the coordinator partitions
    itself.  Map blocks for partition `p` from both sides then meet in
    one `shuffle_join` reduce request at a worker, which builds the
    hash table from the right side's blocks and probes with the left.

    Fault model: map fragments inherit `_dispatch`'s full failover /
    hedging / dedup machinery; duplicate blocks drop by fingerprint at
    the reduce.  A reduce request whose worker dies replays on the
    next live worker (`shuffle.reduce_replayed`) — it is a pure
    function of its blocks, so the replay is exact — and when every
    worker is gone the coordinator runs the reduce itself
    (`shuffle.local_reduces`) rather than failing the query.
    """

    def __init__(self, plan, sides, workers: list[WorkerHandle],
                 query_deadline_s: Optional[float] = None, hedge=None):
        # sides: per (left, right) input either ("frags", side_plan, ds)
        # or ("local", relation)
        self.plan = plan
        self.sides = sides
        self.workers = workers
        self._schema = plan.schema
        self.query_deadline_s = query_deadline_s
        self.hedge = hedge

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        kinds = "/".join(s[0] for s in self.sides)
        return (
            f"DistributedShuffleJoin[{self.plan.join_type}, sides={kinds}, "
            f"workers={len(self.workers)}]"
        )

    def _map_side(self, si: int, tag: str, qid: str, num_parts: int,
                  deadline) -> dict:
        """Run one side's map phase; returns {partition: [host block]}."""
        from datafusion_tpu_torch.parallel import shuffle

        keys = [l for l, _ in self.plan.on] if si == 0 else [
            r for _, r in self.plan.on
        ]
        per_part: dict = {p: [] for p in range(num_parts)}
        side = self.sides[si]
        if side[0] == "frags":
            _, side_plan, ds = side
            plan_json = side_plan.to_json()
            n = len(ds.partitions)
            fragments = [
                PlanFragment(i, n, plan_json, pt.to_meta(), f"{qid}{tag}")
                for i, pt in enumerate(ds.partitions)
            ]
            responses = _dispatch(
                self.workers, fragments, "shuffle_map", deadline,
                hedge=self.hedge, extra={"keys": keys, "num_parts": num_parts, "side": tag},
            )
            for _frag, resp in _iter_unique_responses(responses):
                for ob in resp["blocks"]:
                    b = shuffle.decode_block(ob)
                    per_part[b["partition"]].append(b)
            flight.record("shuffle.map", side=tag, fragments=n,
                          partitions=num_parts)
            return per_part
        # coordinator-local side: materialize the relation here and
        # split it with the SAME partitioner the workers use
        from datafusion_tpu_torch.exec.materialize import collect_columns

        rel = side[1]
        columns, validity, dicts, total = collect_columns(rel)
        raw_cols = []
        for i, f in enumerate(rel.schema.fields):
            if f.data_type == DataType.UTF8:
                d = dicts[i]
                raw_cols.append({
                    "codes": np.asarray(columns[i], np.int32),
                    "values": [] if d is None else d.values,
                })
            else:
                raw_cols.append(columns[i])
        raw = {"num_rows": total, "columns": raw_cols,
               "validity": list(validity)}
        for b in shuffle.split_blocks(
            raw, keys, num_parts, (qid, tag, "local", num_parts, keys)
        ):
            per_part[b["partition"]].append(b)
        flight.record("shuffle.map", side=tag, fragments=0, rows=total,
                      partitions=num_parts)
        return per_part

    def _reduce_one(self, p: int, qid: str, left_blocks, right_blocks,
                    deadline) -> Optional[dict]:
        """One partition's reduce, with worker failover and a
        coordinator-local last resort."""
        from datafusion_tpu_torch.parallel import shuffle

        if not any(b["num_rows"] for b in left_blocks):
            # no probe rows: both join types emit nothing here
            METRICS.add("shuffle.partitions_skipped")
            return None
        if self.plan.join_type == "inner" and not any(
            b["num_rows"] for b in right_blocks
        ):
            METRICS.add("shuffle.partitions_skipped")
            return None
        bw = BinWriter()
        msg = {
            "type": "shuffle_join",
            "partition": p,
            "query_id": qid,
            "on": [[l, r] for l, r in self.plan.on],
            "join_type": self.plan.join_type,
            "left_blocks": [shuffle.encode_block(b, bw) for b in left_blocks],
            "right_blocks": [shuffle.encode_block(b, bw) for b in right_blocks],
        }
        for attempt in range(len(self.workers) + _DISPATCH_PROBE_ROUNDS + 1):
            if deadline is not None:
                deadline.check(f"shuffle partition {p}")
            live = [w for w in self.workers if w.alive]
            if not live:
                for w in self.workers:
                    if w.probe():
                        w.readmit()
                live = [w for w in self.workers if w.alive]
            if not live:
                break
            w = live[(p + attempt) % len(live)]
            timeout = -1
            if deadline is not None:
                msg["deadline_s"] = max(deadline.remaining(), 0.001)
                timeout = msg["deadline_s"]
                if w.request_timeout is not None:
                    timeout = min(timeout, w.request_timeout)
            try:
                return w.request(msg, timeout=timeout, bw=bw)
            except (ConnectionError, OSError):
                # worker died mid-shuffle: the blocks are still here,
                # the reduce is a pure function of them — replay on
                # the next live worker is exact, and the dedup
                # fingerprints make a racing duplicate harmless
                w.mark_down()
                METRICS.add("shuffle.reduce_replayed")
                flight.record("shuffle.failover", partition=p,
                              worker=f"{w.host}:{w.port}", attempt=attempt)
        # every worker is gone: run the reduce HERE (degraded but
        # correct — same code path the workers run)
        METRICS.add("shuffle.local_reduces")
        flight.record("shuffle.local_reduce", partition=p)
        raw = shuffle.reduce_join(
            left_blocks, right_blocks, list(self.plan.on),
            self.plan.join_type,
        )
        # inline-encode (bw=None) so the merge path below decodes it
        # exactly like a remote response
        return {
            "type": "rows",
            "fragment_id": f"{qid}/p{p}",
            "num_rows": raw["num_rows"],
            "columns": [
                {"codes": enc_array(c["codes"]), "values": c["values"]}
                if isinstance(c, dict)
                else enc_array(np.asarray(c))
                for c in raw["columns"]
            ],
            "validity": [
                None if v is None else enc_array(np.asarray(v))
                for v in raw["validity"]
            ],
        }

    def batches(self) -> Iterator[RecordBatch]:
        from concurrent.futures import ThreadPoolExecutor

        from datafusion_tpu_torch.parallel import shuffle

        qid = uuid.uuid4().hex[:12]
        num_parts = shuffle.shuffle_parts(len(self.workers))
        if obs_trace.enabled():
            self.stats.attrs.update(partitions=num_parts,
                                    workers=len(self.workers))
        deadline = (
            None
            if self.query_deadline_s is None
            else Deadline.after(self.query_deadline_s)
        )
        with METRICS.timer("shuffle.map"):
            left_parts = self._map_side(0, "L", qid, num_parts, deadline)
            right_parts = self._map_side(1, "R", qid, num_parts, deadline)
        with ThreadPoolExecutor(
            max_workers=min(num_parts, max(2, len(self.workers) * 2)),
            thread_name_prefix="df-torch-shuffle",
        ) as pool:
            responses = list(pool.map(
                lambda p: self._reduce_one(
                    p, qid, left_parts[p], right_parts[p], deadline
                ),
                range(num_parts),
            ))
        dicts: list[Optional[StringDictionary]] = [
            StringDictionary() if f.data_type == DataType.UTF8 else None
            for f in self._schema.fields
        ]
        flight.record("shuffle.merge", partitions=num_parts,
                      responses=sum(1 for r in responses if r is not None))
        seen: set = set()
        for resp in responses:
            if resp is None or resp["num_rows"] == 0:
                continue
            fid = resp.get("fragment_id")
            if fid in seen:
                METRICS.add("coord.duplicate_responses_dropped")
                continue
            seen.add(fid)
            cols = []
            for i, f in enumerate(self._schema.fields):
                c = resp["columns"][i]
                if f.data_type == DataType.UTF8:
                    codes = dec_array(c["codes"])
                    cols.append(dicts[i].merge_codes(codes, c["values"]))
                else:
                    cols.append(dec_array(c).astype(f.data_type.np_dtype))
            valids = [
                None if v is None else dec_array(v).astype(bool)
                for v in resp["validity"]
            ]
            yield make_host_batch(self._schema, cols, valids, list(dicts))


def _match_distributed_pipeline(plan: LogicalPlan, datasources: dict):
    """Projection/Selection chains over a partitioned serializable
    table — shippable as row-returning fragments."""
    node = plan
    while isinstance(node, (Projection, Selection)):
        node = node.input
    if not isinstance(node, TableScan):
        return None
    ds = datasources.get(node.table_name)
    if not isinstance(ds, PartitionedDataSource):
        return None
    return ds


class DistributedContext(ExecutionContext):
    """ExecutionContext that executes partitioned queries on remote
    worker processes (`python -m datafusion_tpu_torch.worker`).

    `device` is the coordinator's own device, for the operators it runs
    above the workers' results: None means `cuda:0` and raises without
    CUDA, as `ExecutionContext()` does; the tests pass "cpu".

    `heartbeat_interval` (seconds) enables the background
    `HeartbeatMonitor`: dead workers re-admit after `probation_pings`
    consecutive healthy probes, silently-dead ones leave the rotation
    after `fail_threshold` misses.
    `query_deadline_s` (or env DATAFUSION_TPU_QUERY_DEADLINE_S) bounds
    every query end to end: dispatch, reassignment retries, and
    worker-side device retries all honor the remaining budget.

    Gray-failure resilience (each default off): `hedge` (a
    `utils/hedge.HedgeTracker`, or env DATAFUSION_TPU_HEDGE) arms hedged
    fragment dispatch; env DATAFUSION_TPU_BREAKER arms per-worker
    circuit breakers; the process retry budget
    (`utils/retry.set_retry_budget`) bounds reassignment retries; env
    DATAFUSION_TPU_LOCAL_FALLBACK serves fragments on the coordinator,
    through the same kernels on its own device, when every worker is
    dead.  A join with a shippable partitioned input runs as a shuffle
    (`DistributedShuffleJoinRelation`) unless DATAFUSION_TPU_SHUFFLE=0,
    which keeps the local hash join over distributed scans.

    Cluster membership (`cluster=`), the shared result tier, fleet
    telemetry and the debug server wait for ROADMAP item 13.2.
    """

    def __init__(
        self,
        workers: Sequence[tuple[str, int]] = (),
        batch_size: int = 131072,
        request_timeout: Optional[float] = None,
        heartbeat_interval: Optional[float] = None,
        probation_pings: int = 1,
        fail_threshold: int = 2,
        query_deadline_s: Optional[float] = None,
        result_cache=None,
        hedge=None,
        device=None,
    ):
        import os

        super().__init__(device=device, batch_size=batch_size,
                         result_cache=result_cache)
        self._request_timeout = request_timeout
        self.workers = [WorkerHandle(h, p, request_timeout) for h, p in workers]
        if query_deadline_s is None:
            env = os.environ.get("DATAFUSION_TPU_QUERY_DEADLINE_S")
            # "0" means off (the documented default), not a 0s budget
            query_deadline_s = (float(env) or None) if env else None
        self.query_deadline_s = query_deadline_s
        if hedge is None:
            from datafusion_tpu_torch.utils import hedge as hedge_mod

            hedge = hedge_mod.from_env()
        self.hedge = hedge
        self._local_worker = None
        from datafusion_tpu_torch.utils.retry import _env_bool

        if _env_bool("DATAFUSION_TPU_LOCAL_FALLBACK"):
            from datafusion_tpu_torch.parallel.worker import WorkerState

            # minted eagerly: dispatch threads share it without a
            # creation race; idle cost is one fragment-cache store
            self._local_worker = WorkerState(device=self.device, batch_size=batch_size)
        self.heartbeat: Optional[HeartbeatMonitor] = None
        if heartbeat_interval:
            self.heartbeat = HeartbeatMonitor(
                self.workers,
                interval=heartbeat_interval,
                probation_pings=probation_pings,
                fail_threshold=fail_threshold,
            ).start()

    def _local_exec(self, frag: PlanFragment, request_type: str) -> dict:
        """Degraded-mode fragment execution on the coordinator: the
        `WorkerState` entry points a remote worker serves, producing the
        same wire payload (inline-encoded arrays)."""
        if request_type == "execute_fragment":
            return self._local_worker.execute_fragment(frag.to_json_str())
        return self._local_worker.execute_plan(frag.to_json_str())

    @property
    def _local_exec_fn(self):
        return self._local_exec if self._local_worker is not None else None

    def close(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()

    def __enter__(self) -> "DistributedContext":
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def ping_workers(self) -> dict[str, bool]:
        """Liveness probe of every worker."""
        return {f"{w.host}:{w.port}": w.ping() for w in self.workers}

    def worker_status(self) -> dict[str, Optional[dict]]:
        """Per-worker `status` snapshot (None for unreachable workers)."""
        out: dict[str, Optional[dict]] = {}
        for w in self.workers:
            try:
                out[f"{w.host}:{w.port}"] = w.status()
            except (ConnectionError, OSError, ExecutionError):
                out[f"{w.host}:{w.port}"] = None
        return out

    def sync_workers(self) -> list[str]:
        """Fold newly registered cluster workers into the rotation: with
        no cluster membership (ROADMAP item 13.2) there are none."""
        return []

    def broadcast_invalidate(self, table: str) -> int:
        """The cluster's fleet-wide fragment-cache invalidation: with no
        cluster (ROADMAP item 13.2) nothing is broadcast.  Worker
        fragment caches key on the partition files' (mtime, size), so a
        rewritten partition misses there anyway."""
        return 0

    def register_datasource(self, name: str, ds) -> None:
        rereg = self.catalog_version(name) > 0
        super().register_datasource(name, ds)
        if rereg:
            self.broadcast_invalidate(name)

    def _lower(self, plan: LogicalPlan) -> Relation:
        # unlike the single-process mesh, Utf8 MIN/MAX ship too: the
        # coordinator merges the strings themselves.  (The result cache
        # sits above this in ExecutionContext.execute.)
        agg, pred, scan = _match_shippable_aggregate(plan, self.datasources)
        if agg is not None:
            ds = self.datasources[scan.table_name]
            if scan.projection is not None:
                ds = ds.with_projection(scan.projection)
            try:
                ds.to_meta()  # fragments must be serializable
            except PlanError:
                return super()._lower(plan)
            return DistributedAggregateRelation(
                plan, agg, pred, scan, ds, self.workers, self.device,
                functions=self._torch_functions(),
                query_deadline_s=self.query_deadline_s,
                hedge=self.hedge, local_exec=self._local_exec_fn,
            )
        ds = _match_distributed_pipeline(plan, self.datasources)
        if ds is not None:
            try:
                ds.to_meta()
            except PlanError:
                return super()._lower(plan)
            return DistributedUnionRelation(
                plan, ds, self.workers,
                query_deadline_s=self.query_deadline_s,
                hedge=self.hedge, local_exec=self._local_exec_fn,
            )
        if isinstance(plan, Join):
            rel = self._maybe_shuffle_join(plan)
            if rel is not None:
                return rel
        return super()._lower(plan)

    def _shippable_join_side(self, side_plan: LogicalPlan):
        """The side's PartitionedDataSource when it is a shippable row
        pipeline with serializable partition meta, else None."""
        ds = _match_distributed_pipeline(side_plan, self.datasources)
        if ds is None:
            return None
        try:
            ds.to_meta()
        except PlanError:
            return None
        return ds

    def _maybe_shuffle_join(self, plan: Join):
        """Shuffle-exchange lowering for a Join: engages when at least
        one input is a shippable partitioned pipeline (the other side,
        e.g. a nested join's output, materializes at the coordinator and
        is partitioned with the same hash).  Falls back to the local
        hash join (whose children still distribute their scans) when
        neither side ships, or when DATAFUSION_TPU_SHUFFLE=0."""
        import os

        if os.environ.get("DATAFUSION_TPU_SHUFFLE", "1") == "0":
            return None
        side_ds = [
            self._shippable_join_side(side_plan)
            for side_plan in (plan.left, plan.right)
        ]
        if not any(ds is not None for ds in side_ds):
            return None
        sides = []
        for side_plan, ds in zip((plan.left, plan.right), side_ds):
            if ds is not None:
                _check_fragment_plan(side_plan)
                sides.append(("frags", side_plan, ds))
            else:
                sides.append(("local", self._lower(side_plan)))
        METRICS.add("shuffle.joins")
        return DistributedShuffleJoinRelation(
            plan, sides, self.workers,
            query_deadline_s=self.query_deadline_s, hedge=self.hedge,
        )
