"""Telemetry aggregation: per-node latency histograms, the per-query
funnel, and their merge into fleet-wide views (the JAX package's
`obs/aggregate.py`, with its buckets, quantiles and gauge names).

Every node (an engine, a coordinator, a worker) keeps cheap log2-bucketed
latency histograms (`observe_latency`: ``query.latency``,
``serve.latency``, ``fragment.latency``, ``scan.<table>.latency`` and
``scan.<table>.bytes``) beside the flat `METRICS` counters.
`query_completed` is the per-query funnel: the engine's materialization
boundary (`exec/materialize.collect_columns`) calls it once per root
query, on success and on failure, and it feeds the histogram, the SLO
watchdog, the tail explainer (for a query that is not served), the
flight ring, the device ledger's leak sweep, the slow or failed query's
artifact capture and the OTLP export; it never raises (a failure counts
``obs.telemetry_errors``).  `node_snapshot` is what a worker answers its
coordinator's ``telemetry`` request with, and `FleetAggregator` merges
such snapshots (histograms bucket-wise, counters and extensive gauges by
sum) into fleet p50/p95/p99 latency, cache hit rates, launches a pass
and byte totals: `gauges()` feeds a Prometheus scrape, `top_text()` the
console's ``top``.

The host gauges (``host.rss_bytes``, ``host.rss_peak_bytes``,
``host.open_fds`` from ``/proc/self``; absent where there is no
``/proc``, never zeros) and the GC pause timer (``host.gc_pause``,
``host.gc_collections``, a ``gc.callbacks`` hook installed at import)
ride every snapshot.

Histogram cost: a bucket bump is a plain int add on a preallocated list,
no lock (observation runs inside query paths), so concurrent observers
may rarely lose an increment.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

from datafusion_tpu_torch.utils.metrics import METRICS

# -- host-resource gauges ---------------------------------------------
# Process RSS / peak RSS / open-FD count in every scrape, and GC pause
# time as a stage timer: the host-side complement of the device-ledger
# HBM gauges — a node whose decode path is eating memory or leaking
# descriptors shows it in the same scrape that shows its latency.
# Platform-guarded: no /proc (macOS, exotic containers) simply means
# the gauges are absent — never published as fake zeros (the same
# "a blind node must not read as a measured-empty one" rule the
# ledger-off path follows).

_PROC_STATUS = "/proc/self/status"
_PROC_FD = "/proc/self/fd"


# observed RSS high-water mark: some sandboxed kernels publish VmRSS
# but omit VmHWM — fall back to the max RSS this process has ever
# measured (an under-estimate between scrapes, but monotone and real)
_rss_peak_seen = 0


def host_gauges() -> dict:
    """Point-in-time host-resource gauges (empty off-Linux)."""
    global _rss_peak_seen
    out: dict = {}
    try:
        with open(_PROC_STATUS, "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["host.rss_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["host.rss_peak_bytes"] = int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    rss = out.get("host.rss_bytes")
    if rss is not None:
        _rss_peak_seen = max(_rss_peak_seen, rss,
                             out.get("host.rss_peak_bytes", 0))
        out.setdefault("host.rss_peak_bytes", _rss_peak_seen)
    try:
        out["host.open_fds"] = len(os.listdir(_PROC_FD))
    except OSError:
        pass
    return out


def refresh_host_gauges() -> dict:
    """Fold the host-resource gauges into the METRICS registry so every
    scrape path (worker status, /debug/metrics, heartbeat snapshot)
    carries them; returns what was set."""
    g = host_gauges()
    for name, v in g.items():
        METRICS.gauge(name, v)
    _fold_gc()
    return g


# GC pause accounting, via gc.callbacks: "start" stamps a wall anchor,
# "stop" adds the pause to module counters.  A collection runs on the
# thread whose allocation triggered it, possibly while that thread holds
# METRICS' lock, so the callback touches only these plain numbers, and
# `refresh_host_gauges` folds what accrued into the `host.gc_pause`
# timer and the `host.gc_collections` counter.  CPython runs one
# collection at a time, so one anchor is race-free.
_gc_t0: Optional[float] = None
_gc_installed = False
_gc_pause_s = 0.0
_gc_count = 0
_gc_folded = (0.0, 0)  # what `refresh_host_gauges` already folded


def _gc_callback(phase: str, info: dict) -> None:
    global _gc_t0, _gc_pause_s, _gc_count
    if phase == "start":
        _gc_t0 = time.perf_counter()
    elif phase == "stop" and _gc_t0 is not None:
        _gc_pause_s += time.perf_counter() - _gc_t0
        _gc_count += 1
        _gc_t0 = None


def _fold_gc() -> None:
    global _gc_folded
    pause, count = _gc_pause_s, _gc_count
    done_pause, done_count = _gc_folded
    _gc_folded = (pause, count)
    if count > done_count:
        METRICS.observe("host.gc_pause", pause - done_pause)
        METRICS.add("host.gc_collections", count - done_count)


def install_gc_hook() -> None:
    """Idempotently register the GC pause callback."""
    global _gc_installed
    if _gc_installed:
        return
    import gc

    gc.callbacks.append(_gc_callback)
    _gc_installed = True


install_gc_hook()

# gauges summed node-wise into fleet.* (like counters, these are
# extensive quantities: total fleet residency / memory / descriptors)
_SUMMED_GAUGES = (
    "device.hbm.live_bytes", "device.hbm.peak_bytes",
    "host.rss_bytes", "host.rss_peak_bytes", "host.open_fds",
)

# log2 buckets over [1us, ~137s): bucket i covers
# [1us * 2^i, 1us * 2^(i+1)); the final slot is the +inf overflow
_BASE_S = 1e-6
_BUCKETS = 28


def _bucket_index(seconds: float) -> int:
    if seconds <= _BASE_S:
        return 0
    return min(int(math.log2(seconds / _BASE_S)) + 1, _BUCKETS - 1)


def bucket_upper_bound_s(i: int) -> float:
    """Upper bound of bucket ``i`` (inf for the overflow slot)."""
    if i >= _BUCKETS - 1:
        return math.inf
    return _BASE_S * (2.0 ** i)


class LatencyHistogram:
    """Mergeable log2 histogram with quantile estimation.

    Default geometry covers latencies ([1us, ~137s) over 28 buckets);
    a custom ``base``/``nbuckets`` re-purposes the same machinery for
    other log2-distributed values — the per-table ``scan.<t>.bytes``
    histograms use base=1 byte over 48 buckets (~140TB ceiling).  The
    geometry rides the snapshot so fleet merges reconstruct it."""

    __slots__ = ("buckets", "count", "sum_s", "base", "nbuckets")

    def __init__(self, base: float = _BASE_S, nbuckets: int = _BUCKETS):
        self.base = float(base)
        self.nbuckets = int(nbuckets)
        self.buckets = [0] * self.nbuckets
        self.count = 0
        self.sum_s = 0.0

    @classmethod
    def empty_like(cls, other) -> "LatencyHistogram":
        """A fresh zero histogram with ``other``'s geometry (``other``
        may be an instance or a snapshot dict)."""
        if isinstance(other, dict):
            bk = other.get("buckets") or []
            return cls(base=float(other.get("base", _BASE_S)),
                       nbuckets=max(len(bk), 1) if bk else _BUCKETS)
        return cls(base=other.base, nbuckets=other.nbuckets)

    def _index(self, value: float) -> int:
        if value <= self.base:
            return 0
        return min(int(math.log2(value / self.base)) + 1, self.nbuckets - 1)

    def _upper(self, i: int) -> float:
        if i >= self.nbuckets - 1:
            return math.inf
        return self.base * (2.0 ** i)

    def observe(self, seconds: float) -> None:
        self.buckets[self._index(seconds)] += 1
        self.count += 1
        self.sum_s += seconds

    def merge(self, other) -> "LatencyHistogram":
        """Fold another histogram (object or snapshot dict) in."""
        if isinstance(other, dict):
            bk = other.get("buckets") or []
            for i, n in enumerate(bk[:self.nbuckets]):
                self.buckets[i] += int(n)
            self.count += int(other.get("count", sum(int(n) for n in bk)))
            self.sum_s += float(other.get("sum_s", 0.0))
        else:
            for i in range(min(self.nbuckets, other.nbuckets)):
                self.buckets[i] += other.buckets[i]
            self.count += other.count
            self.sum_s += other.sum_s
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket containing the q-quantile (the
        conservative read: the true latency is <= this).  None when
        empty."""
        if self.count <= 0:
            return None
        rank = max(math.ceil(q * self.count), 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= rank:
                ub = self._upper(i)
                if math.isinf(ub):
                    break  # overflow bucket: no finite bound
                return ub
        # the quantile landed in the +inf overflow bucket.  Report a
        # LOWER bound: at least the largest finite bucket edge, and at
        # least the overall mean (which exceeds the edge when overflow
        # members dominate).  Never the plain mean — 2 hung 200s
        # queries among 98 fast ones would render a "4s p99" during an
        # incident where the true tail is 50x that.
        return max(self._upper(self.nbuckets - 2),
                   self.sum_s / self.count)

    def snapshot(self) -> dict:
        out = {
            "buckets": list(self.buckets),
            "count": self.count,
            "sum_s": self.sum_s,
        }
        if self.base != _BASE_S:
            out["base"] = self.base
        return out

    def __repr__(self):
        return (f"LatencyHistogram(n={self.count}, "
                f"p50={self.quantile(0.5)}, p99={self.quantile(0.99)})")


# process-global histogram registry (same rationale as METRICS: one
# engine per process, contention nil, snapshot on scrape)
HISTOGRAMS: dict[str, LatencyHistogram] = {}


def reset_histograms() -> None:
    HISTOGRAMS.clear()


def observe_latency(name: str, seconds: float) -> None:
    """Record one latency observation into the named histogram."""
    h = HISTOGRAMS.get(name)
    if h is None:
        # setdefault keeps a racing creator's histogram (and its
        # observations) instead of clobbering it
        h = HISTOGRAMS.setdefault(name, LatencyHistogram())
    h.observe(seconds)


# scan-bytes histogram geometry: base 1 byte, 48 buckets (~140TB cap)
_BYTES_BASE = 1.0
_BYTES_BUCKETS = 48


def observe_scan(table: str, seconds: float, nbytes: int) -> None:
    """One complete table scan at the datasource boundary: latency into
    ``scan.<table>.latency`` (default log2-latency geometry) and host
    bytes scanned into ``scan.<table>.bytes`` (log2-bytes geometry).
    Both merge fleet-wide exactly like ``query.latency``."""
    observe_latency(f"scan.{table}.latency", seconds)
    name = f"scan.{table}.bytes"
    h = HISTOGRAMS.get(name)
    if h is None:
        h = HISTOGRAMS.setdefault(
            name, LatencyHistogram(base=_BYTES_BASE, nbuckets=_BYTES_BUCKETS)
        )
    h.observe(float(nbytes))


def histogram_gauges(hists: Optional[dict] = None,
                     prefix: str = "") -> dict:
    """Quantile/count gauges for a histogram set (the local scrape's
    view of HISTOGRAMS; the fleet aggregator passes its merged set with
    prefix="fleet.").  ``.bytes`` histograms label their quantiles
    without the ``_s`` unit suffix."""
    out: dict = {}
    for name, h in sorted((hists if hists is not None
                           else HISTOGRAMS).items()):
        unit = "" if name.endswith(".bytes") else "_s"
        for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = h.quantile(q)
            if v is not None:
                out[f"{prefix}{name}.{label}{unit}"] = (
                    round(v) if not unit else round(v, 6)
                )
        out[f"{prefix}{name}.count"] = h.count
    return out


def node_snapshot() -> dict:
    """This process's telemetry snapshot: the histogram set plus the
    flat counter/gauge registries — the payload a worker piggybacks on
    its cluster heartbeat and folds into its status response."""
    # refresh the device-ledger gauges first: live_bytes() recomputes
    # the exact sum (correcting any lock-free-writer drift) and rewrites
    # device.hbm.live_bytes/peak_bytes, so the piggybacked snapshot —
    # and every fleet.hbm.* sum derived from it — reports measured
    # residency, not the last put's running estimate.  A ledger-off
    # node publishes NO hbm gauges at all: a zero from a node that
    # measures nothing would sum into fleet.hbm.* looking like a
    # measured empty device
    from datafusion_tpu_torch.obs import device as _device

    if _device.enabled():
        _device.LEDGER.buffer_bytes()
    # host-resource gauges (RSS, peak RSS, open FDs) refresh the same
    # way: measured at snapshot time, absent when the platform hides
    # them — the fleet sums only measured values
    refresh_host_gauges()
    # per-client metering gauges (tenant.<id>.*): pin byte-seconds
    # accrue at snapshot time, and the costs ride every scrape and
    # heartbeat piggyback like the histograms do
    from datafusion_tpu_torch.obs import attribution

    attribution.refresh_tenant_gauges()
    snap = METRICS.snapshot()
    gauges = snap["gauges"]
    if not _device.enabled():
        gauges = {
            k: v for k, v in gauges.items()
            if not k.startswith("device.hbm.")
        }
    return {
        "ts": time.time(),
        "histograms": {k: h.snapshot() for k, h in HISTOGRAMS.items()},
        "counts": snap["counts"],
        "gauges": gauges,
    }


def _rate(hits: float, misses: float) -> Optional[float]:
    total = hits + misses
    return None if total <= 0 else hits / total


# -- query lifecycle seam ---------------------------------------------
# throttle for piggybacked SLO evaluation: completions trigger an
# evaluate pass at most this often (scrapes/top always evaluate fresh)
_EVAL_EVERY_S = 5.0
_last_eval = 0.0


def query_completed(wall_s: float, rows: Optional[int] = None,
                    root=None, label: Optional[str] = None,
                    error: Optional[str] = None,
                    trace_id: Optional[str] = None,
                    export_otlp: bool = True,
                    phases: Optional[dict] = None) -> None:
    """The per-query telemetry funnel, called once per root query at
    the materialization boundary (exec/materialize.py) — success or
    failure.  Feeds the latency histogram and the SLO watchdog,
    records the flight event, and on a slow or failed query captures
    the correlated artifact set (flight dump of every involved node +
    stitched OTLP trace + operator report) with no configuration
    beyond the defaults.  Never raises."""
    global _last_eval
    try:
        # imports INSIDE the guard: the never-raises contract must
        # cover an import-time failure in a sibling obs module too
        # (collect_columns calls this unguarded on both paths)
        from datafusion_tpu_torch.obs import recorder, slo
        from datafusion_tpu_torch.obs import trace as obs_trace

        observe_latency("query.latency", wall_s)
        # a SERVED query (this thread carries a client charge scope)
        # reports to the SLO watchdog at the front door with its
        # CLIENT-VISIBLE wall, queue wait included — feeding the inner
        # materialization wall here too would put 2N samples in the
        # window, diluting exactly the queueing tail serving SLOs
        # exist to catch
        from datafusion_tpu_torch.obs import attribution

        served = attribution.current_scope() is not None
        if not served:
            slo.WATCHDOG.observe(wall_s, error=error is not None)
        # tail attribution fallback: a NON-served query's wall
        # decomposes by the stage phases (decode, h2d, ...) into the same tail
        # explainer the serving segments feed (a served query observes
        # its richer serving chain at the front door instead;
        # obs/attribution.py skips under a client scope)
        attribution.observe_phases(wall_s, phases)
        recorder.record(
            "query.done" if error is None else "query.error",
            wall_s=round(wall_s, 6), rows=rows, label=label, error=error,
            phases=phases,
        )
        # device-ledger leak sweep: non-cache buffers this query placed
        # that outlive it become candidates; earlier candidates still
        # alive past the grace report as leaks (obs/device.py)
        from datafusion_tpu_torch.obs.device import LEDGER

        LEDGER.sweep(trace_id)
        slow = error is None and wall_s >= recorder.slow_threshold_s()
        if slow:
            METRICS.add("flight.slow_queries")
        if slow or error is not None:
            # a distributed root knows how to pull every involved
            # worker's ring (coordinator relations implement this);
            # invoked lazily inside the capture so a throttled dump
            # costs zero round trips
            dumps_fn = getattr(root, "collect_flight_dumps", None)
            recorder.capture_query_artifacts(
                "slow_query" if slow else "query_failure",
                wall_s=wall_s, trace_id=trace_id, root=root, label=label,
                error=error, phases=phases,
                node_dumps_fn=(
                    None if dumps_fn is None
                    else lambda: dumps_fn(trace_id)
                ),
            )
        if trace_id is not None and export_otlp:
            # env-gated OTLP push (file/endpoint) of this query's
            # spans.  EXPLAIN ANALYZE passes export_otlp=False: it
            # exports the COMPLETE drained set (including the root
            # span, still open here) itself — one document per query,
            # not two overlapping ones
            from datafusion_tpu_torch.obs import otlp

            otlp.export_spans(obs_trace.spans(trace_id))
        now = time.monotonic()
        if slo.WATCHDOG.armed() and now - _last_eval >= _EVAL_EVERY_S:
            _last_eval = now
            slo.WATCHDOG.evaluate()
    except Exception:  # noqa: BLE001 — telemetry must never fail the query it measures
        METRICS.add("obs.telemetry_errors")


class FleetAggregator:
    """Merges node snapshots into per-worker and fleet-wide views.

    ``ingest(addr, snapshot)`` retains the latest snapshot per node;
    ``fleet()`` merges retained snapshots (plus this process's own
    live one as node ``"local"``) and derives the headline facts:
    latency quantiles per histogram, cache hit rates, launches per
    pass.  Snapshots older than ``stale_s`` drop out of the merge —
    a worker that left the fleet stops haunting the percentiles."""

    def __init__(self, stale_s: float = 120.0, include_local: bool = True):
        self.stale_s = stale_s
        self.include_local = include_local
        self._nodes: dict[str, dict] = {}

    def ingest(self, addr: str, snapshot: Optional[dict]) -> None:
        if isinstance(snapshot, dict) and "histograms" in snapshot:
            self._nodes[str(addr)] = snapshot

    def forget(self, addr: str) -> None:
        self._nodes.pop(str(addr), None)

    def nodes(self) -> dict[str, dict]:
        now = time.time()
        live = {
            addr: snap for addr, snap in self._nodes.items()
            if now - float(snap.get("ts", now)) <= self.stale_s
        }
        if self.include_local:
            live["local"] = node_snapshot()
        return live

    def fleet(self) -> dict:
        """The merged view: {"nodes": int, "histograms": {name:
        LatencyHistogram}, "counts": summed counters, "derived":
        headline rates}."""
        nodes = self.nodes()
        hists: dict[str, LatencyHistogram] = {}
        counts: dict[str, float] = {}
        sums: dict[str, float] = {}
        for snap in nodes.values():
            for name, h in (snap.get("histograms") or {}).items():
                tgt = hists.get(name)
                if tgt is None:
                    # geometry rides the snapshot (scan-bytes histograms
                    # use a different base than latency ones)
                    tgt = hists[name] = LatencyHistogram.empty_like(h)
                tgt.merge(h)
            for name, n in (snap.get("counts") or {}).items():
                counts[name] = counts.get(name, 0) + n
            # extensive gauges sum across the fleet: device-ledger HBM
            # residency into fleet.hbm.*, host RSS/FDs into fleet.host.*
            g = snap.get("gauges") or {}
            for name in _SUMMED_GAUGES:
                if name in g:
                    sums[name] = sums.get(name, 0) + float(g[name])
            # per-client metering gauges are extensive too: a client's
            # fleet-wide cost is the sum of what every node charged it
            for name, v in g.items():
                if name.startswith("tenant."):
                    sums[name] = sums.get(name, 0) + float(v)
        hbm = {k: v for k, v in sums.items() if k.startswith("device.hbm.")}
        host = {k: v for k, v in sums.items() if k.startswith("host.")}
        tenants = {k: v for k, v in sums.items() if k.startswith("tenant.")}
        derived = {
            "result_cache_hit_rate": _rate(
                counts.get("cache.result.hits", 0),
                counts.get("cache.result.misses", 0)),
            "fragment_cache_hit_rate": _rate(
                counts.get("cache.fragment.hits", 0),
                counts.get("cache.fragment.misses", 0)),
            "compile_cache_hit_rate": _rate(
                counts.get("kernel_cache.hits", 0),
                counts.get("kernel_cache.misses", 0)),
            "launches_per_pass": (
                None if not counts.get("fused.groups")
                else counts.get("device.launches", 0)
                / counts["fused.groups"]),
        }
        return {"nodes": len(nodes), "node_names": sorted(nodes),
                "histograms": hists, "counts": counts, "derived": derived,
                "hbm": hbm, "host": host, "tenants": tenants}

    def gauges(self) -> dict:
        """Fleet gauges for ``prometheus_text(extra_gauges=...)``."""
        f = self.fleet()
        out: dict = {"fleet.nodes": f["nodes"]}
        out.update(histogram_gauges(f["histograms"], prefix="fleet."))
        # fleet HBM residency: summed device-ledger gauges — the fleet-
        # wide answer to "how much accelerator memory is pinned"
        if "device.hbm.live_bytes" in f["hbm"]:
            out["fleet.hbm.live_bytes"] = int(f["hbm"]["device.hbm.live_bytes"])
        if "device.hbm.peak_bytes" in f["hbm"]:
            out["fleet.hbm.peak_bytes"] = int(f["hbm"]["device.hbm.peak_bytes"])
        # fleet host-resource totals: summed RSS / peak RSS / open FDs
        # (absent off-Linux — only measured nodes contribute)
        for name, v in f["host"].items():
            out[f"fleet.{name}"] = int(v)
        # fleet per-client metering: each client's node-wise summed
        # costs (serve_smoke's conservation gate reads these)
        for name, v in f.get("tenants", {}).items():
            out[f"fleet.{name}"] = round(v, 6)
        for name, v in f["derived"].items():
            if v is not None:
                out[f"fleet.{name}"] = round(v, 4)
        for name in ("coord.fragment_reassigned", "queries_admitted",
                     "queries_queued", "queries_shed",
                     "device.transient_retries", "slo.breaches"):
            if f["counts"].get(name):
                out[f"fleet.{name}"] = f["counts"][name]
        return out

    def top_text(self, slo_rows: Optional[list[dict]] = None) -> str:
        """The ``datafusion-tpu top`` view: one fleet summary line,
        one row per node, and the SLO burn-rate table when a watchdog
        is armed."""
        f = self.fleet()
        lines = [f"fleet: {f['nodes']} node(s) "
                 f"[{', '.join(f['node_names'])}]"]

        def _q(h: Optional[LatencyHistogram], q: float) -> str:
            v = None if h is None else h.quantile(q)
            return "-" if v is None else f"{v * 1e3:.1f}ms"

        def _pct(v) -> str:
            return "-" if v is None else f"{v * 100:.1f}%"

        qh = f["histograms"].get("query.latency")
        fh = f["histograms"].get("fragment.latency")
        d = f["derived"]
        lines.append(
            f"  queries: n={qh.count if qh else 0} "
            f"p50={_q(qh, 0.5)} p95={_q(qh, 0.95)} p99={_q(qh, 0.99)}"
            f"   fragments: n={fh.count if fh else 0} "
            f"p50={_q(fh, 0.5)} p99={_q(fh, 0.99)}"
        )
        lines.append(
            f"  caches: result={_pct(d['result_cache_hit_rate'])} "
            f"fragment={_pct(d['fragment_cache_hit_rate'])} "
            f"compile={_pct(d['compile_cache_hit_rate'])}"
            + ("" if d["launches_per_pass"] is None
               else f"   launches/pass={d['launches_per_pass']:.2f}")
        )
        if f.get("hbm"):
            from datafusion_tpu_torch.obs.device import _fmt_bytes

            live = f["hbm"].get("device.hbm.live_bytes", 0)
            peak = f["hbm"].get("device.hbm.peak_bytes", 0)
            lines.append(
                f"  hbm: live={_fmt_bytes(live)} peak={_fmt_bytes(peak)} "
                f"(device ledger, fleet sum)"
            )
        if f.get("host"):
            from datafusion_tpu_torch.obs.device import _fmt_bytes

            lines.append(
                f"  host: rss={_fmt_bytes(f['host'].get('host.rss_bytes', 0))}"
                f" peak={_fmt_bytes(f['host'].get('host.rss_peak_bytes', 0))}"
                f" fds={int(f['host'].get('host.open_fds', 0))} (fleet sum)"
            )
        admitted = f["counts"].get("queries_admitted", 0)
        shed = f["counts"].get("queries_shed", 0)
        lines.append(
            f"  admission: admitted={int(admitted)} "
            f"queued={int(f['counts'].get('queries_queued', 0))} "
            f"shed={int(shed)}   retries="
            f"{int(f['counts'].get('device.transient_retries', 0))} "
            f"failovers="
            f"{int(f['counts'].get('coord.fragment_reassigned', 0))}"
        )
        for addr, snap in sorted(self.nodes().items()):
            h = LatencyHistogram()
            hs = (snap.get("histograms") or {})
            for name in ("query.latency", "fragment.latency"):
                if name in hs:
                    h.merge(hs[name])
            c = snap.get("counts") or {}
            g = snap.get("gauges") or {}
            extras = []
            if g.get("cluster.replication_lag_revisions") is not None:
                extras.append(
                    f"repl_lag={g['cluster.replication_lag_revisions']}")
            if g.get("cluster.lease_age_s") is not None:
                extras.append(f"lease_age={g['cluster.lease_age_s']}s")
            if g.get("device.hbm.live_bytes"):
                from datafusion_tpu_torch.obs.device import _fmt_bytes

                extras.append(
                    f"hbm={_fmt_bytes(g['device.hbm.live_bytes'])}")
            lines.append(
                f"  node {addr}: work={h.count} p50={_q(h, 0.5)} "
                f"p99={_q(h, 0.99)} launches="
                f"{int(c.get('device.launches', 0))} "
                f"frag_hits={int(c.get('cache.fragment.hits', 0))}"
                + (" " + " ".join(extras) if extras else "")
            )
        if slo_rows:
            lines.append("  slo:")
            for row in slo_rows:
                lines.append(
                    f"    {row['name']}: value={row['value']} "
                    f"target={row['target']} burn={row['burn_rate']:.2f}"
                    f"{'  BREACHED' if row['breached'] else ''}"
                )
        return "\n".join(lines)
