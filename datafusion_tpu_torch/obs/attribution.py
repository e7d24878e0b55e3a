"""Tail-latency attribution and per-client metering (the JAX package's
`obs/attribution.py`, whole).

The serving front door (serve.py) blurs every per-query signal: N
queries fold into one megabatched launch of the grouped reduce's query
axis, hot tables are shared pins in the device ledger.  This module
un-blurs it, in two halves.

**Critical paths.**  A served query's end-to-end wall decomposes into
the serving chain, observed from its ticket's stamps and apportioned
launch shares (`Server._segments`)::

    admission -> megabatch_window -> queue_wait -> shared_launch_share
        -> demux_pull -> merge -> other

`observe_path` feeds each path to a windowed `TailExplainer`, which
ranks segments by their p99 contribution so a slow tail names its
segment (`EXPLAINER.explain()`).  `observe_phases` is the non-served
fallback over the phase set of `obs/device.PHASE_ORDER`.
`critical_path_from_spans` decomposes a merged span tree with hedge
losers excluded (`hedge_loser_span_ids`); in the port the coordinator's
hedged dispatch (parallel/coordinator.py) produces such spans when
tracing is on, and the two are pure functions over span dicts.

**Per-client metering.**  `Server.submit(client_id=...)` and
`Server.append(client_id=...)` publish the client as this thread's
charge scope (`client_scope`; a megabatch publishes its members with
row weights, `shared_scope`), and the shared costs apportion back:

- device seconds: every pass's wall as `utils/retry.device_call`
  measures it (`note_launch`), split by weight under a shared scope;
- H2D bytes: every copy at the copy seam (`obs/device.note_h2d` ->
  `charge_h2d`);
- pin byte-seconds: each pin of the device ledger (`obs/device.LEDGER`)
  charges bytes x seconds since the last accrual to the clients whose
  queries used it in that interval, by use count (`note_pin_use`,
  `accrue_pins`), or to the client that materialized it
  (`register_pin_client`) when nobody did; the ledger's eviction calls
  `forget_pin`;
- hedge duplicates (`charge_hedge_loss`), queries and sheds.

Costs surface as ``tenant.<id>.*`` gauges (`refresh_tenant_gauges`, run
by `ExecutionContext.metrics_text`) and `tenants_text`.  Conservation
holds by construction: the sum of per-client device seconds equals the
seconds charged under scopes, because both come from the one
measurement in `device_call` (`tenants_snapshot()["conservation"]`
compares it with the ``device.dispatch`` timer, which also holds
unscoped launches).  On the card a scoped pass is charged its device
time (a CUDA event pair, settled when its scope closes), which also
goes into ``device.dispatch`` in place of its host launch wall; on the
CPU, and for unscoped launches, the seconds are the host's wall around
the pass.

The charge path takes no lock: `Meter.charge` is a dict setdefault and
a float add, `TailExplainer.observe` a bounded-deque append, scope
publication a plain dict store in `utils/metrics.CLIENT_SCOPES`.
Concurrent writers may lose the odd increment (the trade the counters'
statsd cousins make); aggregation happens on the scrape paths only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterable, Optional

from datafusion_tpu_torch.utils import metrics as _metrics
from datafusion_tpu_torch.utils.metrics import METRICS

# the canonical serving-chain segments, in causal order (the vocabulary
# the serve.py ticket path observes); non-served queries fall back to
# obs/device.PHASE_ORDER
SERVED_SEGMENTS = (
    "queue_wait", "admission", "megabatch_window",
    "shared_launch_share", "demux_pull", "merge", "other",
)

# per-client cost dimensions (all extensive: they sum across queries,
# scrapes, and — merged node-wise — the fleet)
COST_KEYS = (
    "device_seconds", "h2d_bytes", "pin_byte_seconds",
    "hedge_duplicate_seconds", "queries", "shed",
)

_UNTENANTED = "default"

# cardinality bound on distinct metered clients: a serving plane built
# for "millions of users" must not let per-user client_ids grow the
# meter — and the tenant.<id>.* gauges that ride EVERY scrape and
# heartbeat piggyback — without bound.  Past the cap, new clients'
# costs fold into one overflow bucket (totals and conservation stay
# exact; only per-client resolution for the long tail is sacrificed).
_OVERFLOW = "~overflow"
_MAX_CLIENTS = 256


# -- client scopes ------------------------------------------------------
# Which client's work is this thread doing right now?  Published into
# utils/metrics.CLIENT_SCOPES (the same cross-thread-table pattern as
# the profiler's PROFILE_STAGES/PROFILE_TRACES: a hook on another
# subsystem's hot path pays one module-global dict read, no imports of
# this module needed to publish).  Two scope shapes:
#
#   ("solo", client_id, [acc], pending)   one client owns the work
#   ("shared", ((cid, weight), ...), [acc], pending)   a megabatched
#                                         launch's members, weights
#                                         summing ~1
#
# `acc[0]` accumulates the launch seconds charged under the scope so
# the serving path can read back its own apportioned share (the
# shared_launch_share segment) without re-measuring.  `pending` holds
# the CUDA event pairs of the scope's passes on the card, which the
# scope's exit settles (`_settle`): a pass there queues its work and
# returns, so its device time is known only once the card has run it.


def current_scope():
    """This thread's published charge scope (None = untenanted work)."""
    return _metrics.CLIENT_SCOPES.get(threading.get_ident())


def current_client() -> Optional[str]:
    """This thread's client id (None when untenanted or shared)."""
    scope = _metrics.CLIENT_SCOPES.get(threading.get_ident())
    if scope is not None and scope[0] == "solo":
        return scope[1]
    return None


@contextmanager
def client_scope(client_id: str):
    """Publish `client_id` as this thread's cost owner for the block.
    Yields the scope's launch-wall accumulator (a one-slot list)."""
    tbl = _metrics.CLIENT_SCOPES
    tid = threading.get_ident()
    prev = tbl.get(tid)
    acc = [0.0]
    scope = tbl[tid] = ("solo", str(client_id), acc, [])
    try:
        yield acc
    finally:
        if prev is None:
            tbl.pop(tid, None)
        else:
            tbl[tid] = prev
        _settle(scope)


@contextmanager
def shared_scope(members: Iterable[tuple[str, float]]):
    """Publish a weighted member set as this thread's cost owners (a
    megabatched launch: every charge under the scope splits by
    weight).  Yields the launch-wall accumulator."""
    tbl = _metrics.CLIENT_SCOPES
    tid = threading.get_ident()
    prev = tbl.get(tid)
    acc = [0.0]
    scope = tbl[tid] = ("shared", tuple(members), acc, [])
    try:
        yield acc
    finally:
        if prev is None:
            tbl.pop(tid, None)
        else:
            tbl[tid] = prev
        _settle(scope)


def _settle(scope) -> None:
    """Charge a closing scope's passes on the card their device time:
    wait for the last pass's end event (the scope's work has as a rule
    been read back by then) and fold each pair's elapsed time into the
    ``device.dispatch`` timer, the meter and the scope's accumulator."""
    pending = scope[3]
    if not pending:
        return
    try:
        pending[-1][1].synchronize()
        seconds = sum(a.elapsed_time(b) for a, b in pending) / 1e3
    except Exception:  # noqa: BLE001 — a failed card must not mask the query's error
        METRICS.add("obs.telemetry_errors")
        return
    finally:
        pending.clear()
    METRICS.observe("device.dispatch", seconds)
    METER.charge_scope(scope, "device_seconds", seconds)
    scope[2][0] += seconds


# -- the meter ----------------------------------------------------------
class Meter:
    """Per-client cost accumulators.  `charge` is the lock-free hot
    path (dict setdefault + float add — DF005 enforced); snapshot /
    clear are scrape-path operations."""

    def __init__(self):
        self._clients: dict[str, dict[str, float]] = {}

    def _entry(self, client: str) -> dict[str, float]:
        e = self._clients.get(client)
        if e is None:
            if len(self._clients) >= _MAX_CLIENTS \
                    and client != _OVERFLOW:
                # cardinality cap: the long tail of client ids folds
                # into one bucket (a racing pair of creators may
                # briefly overshoot the cap by one — the statsd trade,
                # never unbounded growth)
                METRICS.add("tenant.overflow_charges")
                return self._entry(_OVERFLOW)
            # setdefault keeps a racing creator's entry (and charges)
            e = self._clients.setdefault(
                client, {k: 0.0 for k in COST_KEYS}
            )
        return e

    def charge(self, client: str, key: str, amount: float) -> None:
        e = self._entry(client)
        e[key] = e.get(key, 0.0) + amount

    def charge_scope(self, scope, key: str, amount: float) -> None:
        """Charge under a published scope: solo charges one client,
        shared splits by weight; None scopes charge nobody (untenanted
        engine work stays unmetered rather than guessed)."""
        if scope is None:
            return
        if scope[0] == "solo":
            self.charge(scope[1], key, amount)
        else:
            for cid, w in scope[1]:
                self.charge(cid, key, amount * w)

    def clients(self) -> list[str]:
        return sorted(self._clients)

    def snapshot(self) -> dict[str, dict[str, float]]:
        return {
            cid: dict(costs)
            for cid, costs in list(self._clients.items())
        }

    def totals(self) -> dict[str, float]:
        out = {k: 0.0 for k in COST_KEYS}
        for costs in list(self._clients.values()):
            for k, v in costs.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def clear(self) -> None:
        self._clients.clear()


METER = Meter()


# -- charge hooks (other subsystems' hot paths) -------------------------
def note_launch(seconds: float, events=None) -> None:
    """One device launch, from ``utils/retry.device_call`` — charged to
    this thread's published scope (split by weight when the launch is a
    megabatch serving several clients): `seconds` now, or, for a pass
    on the card, the device time between `events` (a CUDA event pair)
    when the scope closes.  Untenanted launches charge nobody.
    Lock-free."""
    scope = _metrics.CLIENT_SCOPES.get(threading.get_ident())
    if scope is None:
        return
    if events is not None:
        scope[3].append(events)
        return
    METER.charge_scope(scope, "device_seconds", seconds)
    scope[2][0] += seconds


def charge_h2d(nbytes: int) -> None:
    """One H2D transfer's bytes, from the ledger seam
    (``obs/device.DeviceLedger.note_h2d``).  Lock-free."""
    scope = _metrics.CLIENT_SCOPES.get(threading.get_ident())
    if scope is not None:
        METER.charge_scope(scope, "h2d_bytes", float(nbytes))


def charge_hedge_loss(scope, seconds: float) -> None:
    """A hedge loser's duplicate wall — the speculative attempt that
    did NOT win still burned a worker for `seconds`; the *hedging
    query's* client pays for it (`scope` is captured at dispatch time:
    the loser reports from its own attempt thread, where no scope is
    ambient).  Lock-free."""
    if scope is None:
        return
    METER.charge_scope(scope, "hedge_duplicate_seconds", seconds)
    METRICS.add("tenant.hedge_losses")


# -- HBM pin byte-seconds -----------------------------------------------
# The ledger's pin table (obs/device.py) knows bytes and owner tag
# (pin.<table>); THESE maps know who to bill.  Accrual is
# integral-of-residency: on every scrape, each registered pin charges
# bytes x elapsed-since-last-accrual, split across the clients whose
# queries USED the pin in that interval proportionally to their use
# counts — a hot shared table costs its readers, not whoever happened
# to touch it first.  An interval with no uses bills the materializing
# client: held-but-unread residency is the holder's cost.
_PIN_CLIENTS: dict[str, str] = {}      # fingerprint -> materializer
_PIN_ACCRUED_AT: dict[str, float] = {}  # fingerprint -> monotonic
_PIN_USERS: dict[str, dict[str, float]] = {}  # fp -> {client: uses}


def register_pin_client(fingerprint: str, client_id: str) -> None:
    """Attribute a pinned resident to the client whose query
    materialized it (serve.Server._ensure_resident) — the fallback
    payer for intervals in which nobody scans the pin."""
    _PIN_CLIENTS[fingerprint] = str(client_id)
    _PIN_ACCRUED_AT[fingerprint] = time.monotonic()


def note_pin_use(fingerprint: str, client_id: str) -> None:
    """One query's scan of a pinned resident: bumps the client's use
    count for the current accrual interval (dict get + float add —
    lock-free, DF005; a racing pair may lose an increment, the statsd
    trade)."""
    users = _PIN_USERS.get(fingerprint)
    if users is None:
        users = _PIN_USERS.setdefault(fingerprint, {})
    users[client_id] = users.get(client_id, 0.0) + 1.0


def forget_pin(fingerprint: str) -> None:
    """Eviction hook: stop accruing for a dropped pin."""
    _PIN_CLIENTS.pop(fingerprint, None)
    _PIN_ACCRUED_AT.pop(fingerprint, None)
    _PIN_USERS.pop(fingerprint, None)


def accrue_pins(now: Optional[float] = None) -> None:
    """Charge pin byte-seconds accrued since the last accrual (called
    from scrape paths: `refresh_tenant_gauges`, `tenants_snapshot`).
    The interval's cost splits across its recorded users by use count
    (counts reset per interval — each accrual window bills the clients
    active IN it); no users = the materializer pays.  Pins that left
    the ledger stop accruing and are pruned."""
    from datafusion_tpu_torch.obs.device import LEDGER

    now = time.monotonic() if now is None else now
    pins = LEDGER.pins_snapshot()
    for fp in list(_PIN_CLIENTS):
        info = pins.get(fp)
        if info is None:
            forget_pin(fp)
            continue
        last = _PIN_ACCRUED_AT.get(fp, now)
        dt = max(now - last, 0.0)
        _PIN_ACCRUED_AT[fp] = now
        if dt <= 0:
            continue
        cost = float(info.get("bytes", 0)) * dt
        users = _PIN_USERS.get(fp)
        counts = dict(users) if users else None
        if users:
            # window reset; a use recorded between the copy and the
            # clear slides into the next interval's split (statsd
            # trade, never lost from the totals)
            users.clear()
        total = sum(counts.values()) if counts else 0.0
        if counts and total > 0:
            for cid, n in counts.items():
                METER.charge(cid, "pin_byte_seconds", cost * (n / total))
        else:
            METER.charge(_PIN_CLIENTS[fp], "pin_byte_seconds", cost)


# -- the tail explainer -------------------------------------------------
def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile over a sorted sample list."""
    if not sorted_vals:
        return 0.0
    i = min(max(int(q * len(sorted_vals) + 0.5) - 1, 0),
            len(sorted_vals) - 1)
    return sorted_vals[i]


class TailExplainer:
    """Windowed per-segment tail aggregation: every observed query
    path (served segments or phase fallback) appends to a bounded
    deque; `explain()` ranks segments by their p99 *contribution* to
    query wall so a breach names the guilty segment.

    ``observe`` is one deque append (lock-free, DF005); ``explain``
    sorts on the scrape path only."""

    def __init__(self, maxlen: int = 4096, window_s: float = 600.0):
        self.window_s = float(window_s)
        # (monotonic_ts, kind, wall_s, {segment: seconds})
        self._paths: deque = deque(maxlen=maxlen)

    def observe(self, wall_s: float, segments: dict[str, float],
                kind: str = "served") -> None:
        self._paths.append(
            (time.monotonic(), kind, float(wall_s), segments)
        )

    def clear(self) -> None:
        self._paths.clear()

    def __len__(self) -> int:
        return len(self._paths)

    def explain(self, window_s: Optional[float] = None) -> dict:
        """The tail report: per-segment p50/p95/p99 contribution
        seconds plus each segment's share of total observed wall,
        ranked by p99 contribution (ties to share).  ``top`` names
        the ranked-first segment — the breach's suspect."""
        window = self.window_s if window_s is None else float(window_s)
        cutoff = time.monotonic() - window
        rows = [p for p in list(self._paths) if p[0] >= cutoff]
        per_seg: dict[str, list[float]] = {}
        total_wall = 0.0
        kinds: dict[str, int] = {}
        for _, kind, wall, segments in rows:
            total_wall += wall
            kinds[kind] = kinds.get(kind, 0) + 1
            for name, v in segments.items():
                per_seg.setdefault(name, []).append(float(v))
        out_rows = []
        for name, vals in per_seg.items():
            vals.sort()
            seg_sum = sum(vals)
            out_rows.append({
                "segment": name,
                "count": len(vals),
                "p50_s": round(_quantile(vals, 0.50), 6),
                "p95_s": round(_quantile(vals, 0.95), 6),
                "p99_s": round(_quantile(vals, 0.99), 6),
                "share_of_wall": round(
                    seg_sum / total_wall, 4) if total_wall > 0 else 0.0,
            })
        out_rows.sort(
            key=lambda r: (r["p99_s"], r["share_of_wall"]), reverse=True
        )
        return {
            "queries": len(rows),
            "window_s": window,
            "kinds": kinds,
            "top": out_rows[0]["segment"] if out_rows else None,
            "segments": out_rows,
        }


EXPLAINER = TailExplainer()


def queue_wait_share(window_s: Optional[float] = None) -> float:
    """The ``queue_wait`` segment's share of observed query wall in
    the explainer's window — the queueing half of the QoS
    elastic-capacity signal (`qos.scale_hint`): a
    fleet whose tail is dominated by admission queueing needs more
    capacity, one whose tail is compute-bound does not.  0.0 with no
    observed paths (no evidence of queueing)."""
    report = EXPLAINER.explain(window_s)
    for row in report["segments"]:
        if row["segment"] == "queue_wait":
            return float(row["share_of_wall"])
    return 0.0


def observe_path(client_id: str, wall_s: float,
                 segments: dict[str, float]) -> None:
    """One served query's decomposed critical path (serve.Server's
    finish point): feeds the tail explainer and counts the client's
    query.  Lock-free."""
    EXPLAINER.observe(wall_s, segments, kind="served")
    METER.charge(client_id, "queries", 1.0)


def observe_phases(wall_s: float,
                   phases: Optional[dict[str, float]]) -> None:
    """The non-served fallback: a query's phase breakdown
    (`obs/device.PHASE_ORDER`) stands in for the serving chain.  A
    thread running under a client scope is a *served* query finishing
    its materialization — it observes its own richer path, so the
    fallback skips to avoid double counting.  Lock-free."""
    if _metrics.CLIENT_SCOPES.get(threading.get_ident()) is not None:
        return
    EXPLAINER.observe(
        wall_s, dict(phases) if phases else {"other": float(wall_s)},
        kind="phases",
    )


# -- span-tree critical path (distributed traced queries) ---------------
def _interval_union_s(intervals: list[tuple[int, int]]) -> float:
    """Total seconds covered by a set of [start_ns, end_ns) intervals
    (overlaps counted once: two shards dispatched in parallel
    contribute their envelope, not their sum — this is the *critical
    path*, not CPU time)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total / 1e9


def hedge_loser_span_ids(span_dicts: list[dict]) -> set[str]:
    """Span ids of hedge-LOSER dispatch attempts (and their
    descendants) in a merged trace, matching what the coordinator
    actually emits (parallel/coordinator.py ``hedged_request``):

    - the PRIMARY dispatch span is the *request record* — it always
      ends when the first valid response returns, gets ``hedged``
      when a hedge launched and ``hedge_won`` when the hedge won;
    - the speculative attempt's own span carries ``hedge_attempt``
      and, when it LOSES, outlives the request record (the abandoned
      thread finishes whenever its worker answers).

    So: only ``hedge_attempt`` spans are ever losers, and only in
    groups whose request record does NOT carry ``hedge_won`` — when
    the hedge won, the attempt span IS the answer's provenance (the
    winner's worker spans parent under it) and the abandoned primary
    request has no span of its own to exclude.  Crucially, plain
    failover retries (multiple dispatch spans for one shard with
    ``attempt=N``/``failed_over`` markers, no hedge attrs) are NOT
    hedge pairs: the successful retry is real critical-path time.
    Everything parented under a loser is excluded with it."""
    groups: dict[tuple, list[dict]] = {}
    for s in span_dicts:
        if s.get("name") == "coord.dispatch":
            attrs = s.get("attrs") or {}
            groups.setdefault(
                (s.get("trace_id"), attrs.get("shard")), []
            ).append(s)
    losers: set[str] = set()
    for group in groups.values():
        attempts = [s for s in group
                    if (s.get("attrs") or {}).get("hedge_attempt")]
        if not attempts:
            continue  # no hedge here (failover retries stay counted)
        if any((s.get("attrs") or {}).get("hedge_won") for s in group):
            # the hedge WON: its attempt span is the winner's
            # provenance; the abandoned primary request has no span
            continue
        for s in attempts:
            losers.add(s["span_id"])
    if losers:
        # transitive closure: worker spans parent under the loser's
        # dispatch span and must go with it
        children: dict[Optional[str], list[dict]] = {}
        for s in span_dicts:
            children.setdefault(s.get("parent_id"), []).append(s)
        frontier = list(losers)
        while frontier:
            pid = frontier.pop()
            for child in children.get(pid, ()):
                if child["span_id"] not in losers:
                    losers.add(child["span_id"])
                    frontier.append(child["span_id"])
    return losers


def critical_path_from_spans(span_dicts: list[dict]) -> dict:
    """Decompose a merged span tree's end-to-end wall into per-name
    segments: the root span's wall splits by the interval *union* of
    its direct children grouped by name (parallel same-name spans
    count once — critical path, not CPU time), with hedge losers
    excluded first; the unaccounted remainder reports as ``other``.
    The excluded losers' summed wall reports separately as
    ``hedge_loser_s`` — it is duplicate cost, metered to the hedging
    client, never critical-path time."""
    spans = [s for s in span_dicts if s.get("end_ns")]
    if not spans:
        return {"wall_s": 0.0, "segments": {}, "excluded_spans": 0,
                "hedge_loser_s": 0.0}
    losers = hedge_loser_span_ids(spans)
    loser_wall = sum(
        max(int(s["end_ns"]) - int(s["start_ns"]), 0)
        for s in spans if s["span_id"] in losers
        and s.get("name") == "coord.dispatch"
    ) / 1e9
    live = [s for s in spans if s["span_id"] not in losers]
    ids = {s["span_id"] for s in live}
    roots = [s for s in live if s.get("parent_id") not in ids]
    root = max(
        roots or live,
        key=lambda s: int(s["end_ns"]) - int(s["start_ns"]),
    )
    r_start, r_end = int(root["start_ns"]), int(root["end_ns"])
    by_name: dict[str, list[tuple[int, int]]] = {}
    for s in live:
        if s.get("parent_id") != root["span_id"]:
            continue
        start = max(int(s["start_ns"]), r_start)
        end = min(int(s["end_ns"]), r_end)
        if end > start:
            by_name.setdefault(s["name"], []).append((start, end))
    wall_s = max(r_end - r_start, 0) / 1e9
    segments = {
        name: round(_interval_union_s(iv), 6)
        for name, iv in by_name.items()
    }
    all_iv = [iv for ivs in by_name.values() for iv in ivs]
    covered = _interval_union_s(all_iv)
    segments["other"] = round(max(wall_s - covered, 0.0), 6)
    return {
        "root": root.get("name"),
        "wall_s": round(wall_s, 6),
        "segments": segments,
        "excluded_spans": len(losers),
        "hedge_loser_s": round(loser_wall, 6),
    }


# -- surfacing ----------------------------------------------------------
def tenant_gauges() -> dict[str, float]:
    """Flat ``tenant.<id>.<cost>`` gauges for the scrape (pin
    byte-seconds accrued first so residency time is current)."""
    out: dict[str, float] = {}
    for cid, costs in METER.snapshot().items():
        for key, v in costs.items():
            out[f"tenant.{cid}.{key}"] = round(v, 6)
    return out


def refresh_tenant_gauges() -> dict[str, float]:
    """Accrue pin residency and fold the per-client gauges into the
    METRICS registry so every scrape path (worker status,
    /debug/metrics, heartbeat snapshot) carries them."""
    try:
        accrue_pins()
    except Exception:  # noqa: BLE001 — a ledger hiccup must not break the scrape
        METRICS.add("obs.telemetry_errors")
    g = tenant_gauges()
    for name, v in g.items():
        METRICS.gauge(name, v)
    return g


def tenants_snapshot() -> dict:
    """The ``/debug/tenants`` document: per-client costs, totals, and
    the conservation check — summed per-client device-seconds against
    the measured total launch wall (the ``device.dispatch`` stage
    timing both derive from)."""
    try:
        accrue_pins()
    except Exception:  # noqa: BLE001 — best-effort accrual, like the scrape path
        METRICS.add("obs.telemetry_errors")
    clients = METER.snapshot()
    totals = METER.totals()
    launch_wall = float(METRICS.timings.get("device.dispatch", 0.0))
    metered = totals.get("device_seconds", 0.0)
    return {
        "clients": clients,
        "totals": totals,
        "conservation": {
            "device_seconds_sum": round(metered, 6),
            "launch_wall_s": round(launch_wall, 6),
            # < 1.0 means untenanted launches ran too (work outside
            # any serving scope is deliberately unmetered, not guessed)
            "coverage": round(metered / launch_wall, 4)
            if launch_wall > 0 else None,
        },
    }


def clients_from_gauges(gauges: dict) -> dict[str, dict[str, float]]:
    """Reconstruct {client: {cost: value}} from flat
    ``[fleet.]tenant.<id>.<cost>`` gauge names (the cost key never
    contains a dot, so rsplit is safe even for dotted client ids) —
    how a coordinator renders a REMOTE fleet's metering from the
    node-summed gauges it already aggregates."""
    out: dict[str, dict[str, float]] = {}
    for name, v in gauges.items():
        if name.startswith("fleet."):
            name = name[len("fleet."):]
        if not name.startswith("tenant."):
            continue
        rest = name[len("tenant."):]
        cid, _, key = rest.rpartition(".")
        if cid:
            out.setdefault(cid, {})[key] = float(v)
    return out


def _client_rows(clients: dict[str, dict[str, float]]) -> list[str]:
    lines = []
    if clients:
        lines.append(
            f"  {'client':<16} {'queries':>8} {'dev_s':>10} "
            f"{'h2d_MB':>9} {'pin_GBs':>9} {'hedge_s':>8} {'shed':>5}"
        )
    else:
        lines.append("  (no metered clients — serve with client_id "
                     "to attribute costs)")
    for cid in sorted(clients):
        c = clients[cid]
        lines.append(
            f"  {cid:<16} {int(c.get('queries', 0)):>8} "
            f"{c.get('device_seconds', 0.0):>10.4f} "
            f"{c.get('h2d_bytes', 0.0) / 1e6:>9.2f} "
            f"{c.get('pin_byte_seconds', 0.0) / 1e9:>9.3f} "
            f"{c.get('hedge_duplicate_seconds', 0.0):>8.3f} "
            f"{int(c.get('shed', 0)):>5}"
        )
    return lines


def tenants_text() -> str:
    """The ``datafusion-tpu top --tenants`` table for THIS process's
    meter, with the conservation line."""
    doc = tenants_snapshot()
    lines = ["tenants:"] + _client_rows(doc["clients"])
    cons = doc["conservation"]
    cov = cons["coverage"]
    lines.append(
        f"  conservation: sum(device_seconds)="
        f"{cons['device_seconds_sum']:.4f}s vs launch wall "
        f"{cons['launch_wall_s']:.4f}s"
        + (f" (coverage {cov * 100:.1f}%)" if cov is not None else "")
    )
    return "\n".join(lines)


def tenants_text_from_gauges(gauges: dict) -> str:
    """The ``--tenants`` table for a REMOTE fleet, rendered from the
    coordinator's node-summed ``tenant.<id>.*`` gauges (a fresh CLI
    process's own meter is empty — the fleet's is not)."""
    lines = ["tenants (fleet sums):"]
    lines += _client_rows(clients_from_gauges(gauges))
    return "\n".join(lines)


def reset_for_tests() -> None:
    """Drop every accumulator (tests own the process-global state)."""
    METER.clear()
    EXPLAINER.clear()
    _PIN_CLIENTS.clear()
    _PIN_ACCRUED_AT.clear()
    _PIN_USERS.clear()
    _metrics.CLIENT_SCOPES.clear()


# typing helper for embedders wiring custom scopes
Scope = Any
