"""SLO watchdog: declared latency, error, memory and freshness
objectives evaluated over sliding windows, with burn-rate gauges and a
flight-recorder dump on breach (the JAX package's `obs/slo.py`).

An objective says what healthy means ("warm Q1 p99 under 500 ms",
"error rate under 1 %"); the watchdog turns per-query observations into
a burn rate, where 1.0 is exactly at the objective.  A latency objective
at quantile q allows a (1 - q) fraction over its threshold, and burns at
the observed over-threshold fraction over that allowance; an error-rate
objective at the observed failure fraction over the allowed one.  On a
breach (burn >= 1.0 with enough samples) the watchdog counts
``slo.breaches``, sets ``slo.<name>.breached`` and asks the recorder for
a throttled dump carrying the row and the tail explainer's report.

Declared in the environment, the JAX package's names, so one deployment
configures both packages:

    DATAFUSION_TPU_SLO_WARM_Q1_P99=0.5       # seconds at the quantile
    DATAFUSION_TPU_SLO_ERROR_RATE=0.01       # allowed failure fraction
    DATAFUSION_TPU_SLO_PRESSURE_HBM_FRAC=0.8 # allowed live device-memory fraction
    DATAFUSION_TPU_SLO_Q1_VIEW_FRESHNESS_S=5 # allowed view staleness (s)
    DATAFUSION_TPU_SLO_WINDOW_S=300          # sliding window (default)
    DATAFUSION_TPU_SLO_MIN_SAMPLES=20        # breach quorum (default)

or through `WATCHDOG.add(Objective(...))`.  With no objective the
watchdog is dormant: `observe` is one deque append.

``hbm_frac`` reads the port's device ledger fresh at each evaluation:
`obs/device.LEDGER.live_bytes()` (pins plus
``torch.cuda.memory_allocated``) over `hbm_capacity_bytes()`
(``DATAFUSION_TPU_HBM_BYTES``, else ``torch.cuda.mem_get_info``); with
no known capacity, or the ledger off, it stays dormant.  ``freshness_s``
reads the port's `ingest.freshness_lags`: the view the objective names,
else the worst lag; no live view is dormant.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.utils.metrics import METRICS

_QUANTILES = {"p50": 0.50, "p95": 0.95, "p99": 0.99}


class Objective:
    """One declared objective.  ``kind`` is ``p50``/``p95``/``p99``
    (``threshold`` = latency seconds at that quantile), ``error_rate``
    (``threshold`` = allowed failure fraction), ``hbm_frac``
    (``threshold`` = allowed live-HBM fraction of device capacity,
    measured by the residency ledger), or ``freshness_s``
    (``threshold`` = allowed materialized-view staleness in seconds;
    the name selects one view, or the process-wide worst lag)."""

    __slots__ = ("name", "kind", "threshold", "window_s")

    def __init__(self, name: str, kind: str, threshold: float,
                 window_s: Optional[float] = None):
        if kind not in (*_QUANTILES, "error_rate", "hbm_frac",
                        "freshness_s"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if threshold <= 0:
            raise ValueError(f"SLO threshold must be positive: {threshold}")
        self.name = name
        self.kind = kind
        self.threshold = float(threshold)
        self.window_s = window_s

    def __repr__(self):
        return f"Objective({self.name}, {self.kind}<={self.threshold})"


class SloWatchdog:
    """Sliding-window objective evaluation.

    ``observe(latency_s, error=...)`` appends to a bounded deque (an
    atomic, lock-free operation); ``evaluate()`` — called from scrape
    paths and the ``top`` view, never the query hot path — prunes the
    window, computes each objective's burn rate, exports the gauges,
    and triggers the breach capture."""

    def __init__(self, window_s: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 capture_on_breach: bool = True):
        env_w = os.environ.get("DATAFUSION_TPU_SLO_WINDOW_S", "")
        env_n = os.environ.get("DATAFUSION_TPU_SLO_MIN_SAMPLES", "")
        self.window_s = (window_s if window_s is not None
                         else float(env_w) if env_w else 300.0)
        self.min_samples = (min_samples if min_samples is not None
                            else int(env_n) if env_n else 20)
        self.capture_on_breach = capture_on_breach
        self.objectives: list[Objective] = []
        # (monotonic_ts, latency_s, is_error); maxlen bounds memory on
        # serving rates far above the evaluation cadence
        self._window: deque = deque(maxlen=100_000)
        self._breached: set[str] = set()

    def add(self, objective: Objective) -> "SloWatchdog":
        self.objectives.append(objective)
        return self

    def armed(self) -> bool:
        return bool(self.objectives)

    def observe(self, latency_s: float, error: bool = False) -> None:
        """One query outcome.  Called on every query completion — a
        single deque append, no locks (DF005 territory)."""
        self._window.append((time.monotonic(), float(latency_s), bool(error)))

    def _samples(self, window_s: float) -> list[tuple[float, float, bool]]:
        cutoff = time.monotonic() - window_s
        # prune from the left at the LONGEST horizon any objective
        # needs (deque popleft is O(1)), so an objective with a wider
        # window than this one still sees its full history
        longest = max([self.window_s] + [
            o.window_s for o in self.objectives if o.window_s
        ])
        while self._window and self._window[0][0] < time.monotonic() - longest:
            self._window.popleft()
        return [s for s in self._window if s[0] >= cutoff]

    def _hbm_burn(self, obj: Objective) -> dict:
        """Memory-pressure burn: measured live-HBM fraction over the
        allowance, read fresh from the device ledger.  Unknown device
        capacity OR a disabled ledger = dormant (burn 0, samples 0),
        never a guess — with DATAFUSION_TPU_DEVICE_LEDGER=0 nothing
        registers, so live_bytes()=0 would read as a confidently
        healthy device while HBM might be exhausted."""
        from datafusion_tpu_torch.obs import device as _device
        from datafusion_tpu_torch.obs.device import LEDGER, hbm_capacity_bytes

        cap = hbm_capacity_bytes() if _device.enabled() else None
        value = LEDGER.live_bytes() / cap if cap else 0.0
        burn = value / obj.threshold
        return {
            "name": obj.name,
            "kind": obj.kind,
            "target": obj.threshold,
            "samples": 1 if cap else 0,
            "value": round(value, 6),
            "burn_rate": round(burn, 4),
            # a gauge objective needs no sample quorum — the reading
            # is exact, not an estimate over a window
            "breached": bool(cap) and burn >= 1.0,
        }

    def _freshness_burn(self, obj: Objective) -> dict:
        """Ingest-freshness burn: a view's measured staleness (seconds
        since its oldest unfolded append) over the allowance, read
        fresh from the live views.  The objective's name selects one
        view when it matches; otherwise the process-wide worst lag.
        No live views (or no matching one) = dormant — a fleet-wide
        objective must not page on processes that serve no views."""
        from datafusion_tpu_torch import ingest

        lags = ingest.freshness_lags()
        value = lags.get(obj.name) if obj.name in lags else (
            max(lags.values()) if lags else None
        )
        burn = (value / obj.threshold) if value is not None else 0.0
        return {
            "name": obj.name,
            "kind": obj.kind,
            "target": obj.threshold,
            "samples": 1 if value is not None else 0,
            "value": round(value, 6) if value is not None else 0.0,
            "burn_rate": round(burn, 4),
            # gauge objective: the reading is exact, no sample quorum
            "breached": value is not None and burn >= 1.0,
        }

    def _burn(self, obj: Objective,
              samples: list[tuple[float, float, bool]]) -> dict:
        if obj.kind == "hbm_frac":
            return self._hbm_burn(obj)
        if obj.kind == "freshness_s":
            return self._freshness_burn(obj)
        n = len(samples)
        if obj.kind == "error_rate":
            bad = sum(1 for _, _, err in samples if err)
            value = bad / n if n else 0.0
            burn = value / obj.threshold if n else 0.0
            target = obj.threshold
        else:
            q = _QUANTILES[obj.kind]
            allowance = max(1.0 - q, 1e-9)
            bad = sum(1 for _, lat, _ in samples if lat > obj.threshold)
            value = bad / n if n else 0.0  # over-threshold fraction
            burn = value / allowance if n else 0.0
            target = obj.threshold
        return {
            "name": obj.name,
            "kind": obj.kind,
            "target": target,
            "samples": n,
            "value": round(value, 6),
            "burn_rate": round(burn, 4),
            "breached": n >= self.min_samples and burn >= 1.0,
        }

    def evaluate(self) -> list[dict]:
        """Compute burn rates, export gauges, capture on NEW breaches
        (a persisting breach re-captures only after it clears first —
        the flight recorder's own throttle bounds the artifact rate
        anyway)."""
        rows = []
        for obj in self.objectives:
            samples = self._samples(obj.window_s or self.window_s)
            row = self._burn(obj, samples)
            rows.append(row)
            METRICS.gauge(f"slo.{obj.name}.burn_rate", row["burn_rate"])
            METRICS.gauge(f"slo.{obj.name}.breached",
                          1 if row["breached"] else 0)
            if row["breached"] and obj.name not in self._breached:
                self._breached.add(obj.name)
                METRICS.add("slo.breaches")
                if self.capture_on_breach:
                    recorder.auto_capture(
                        "slo_breach",
                        lambda row=row: _breach_extra(row),
                    )
            elif not row["breached"]:
                self._breached.discard(obj.name)
        return rows

    def snapshot(self) -> list[dict]:
        """Burn-rate rows without gauge/capture side effects (status
        endpoints that must stay read-only)."""
        return [
            self._burn(obj, self._samples(obj.window_s or self.window_s))
            for obj in self.objectives
        ]


def max_burn_rate(rows: "list[dict] | None" = None) -> Optional[float]:
    """The worst burn rate across the watchdog's objectives — the
    overload half of the QoS elastic-capacity signal
    (`qos.scale_hint`).  Pass ``rows`` when the caller
    already holds an `evaluate()` result (scrape paths evaluate once
    and reuse); otherwise a side-effect-free `snapshot()` is taken.
    None when the watchdog is unarmed: no objectives is *no
    evidence*, which must read as "hold", never as idle-capacity
    proof the hint could shrink on."""
    if rows is None:
        rows = WATCHDOG.snapshot() if WATCHDOG.armed() else []
    if not rows:
        return None
    return max(row.get("burn_rate", 0.0) for row in rows)


def _breach_extra(row: dict) -> dict:
    """The breach artifact's context: the burn-rate row PLUS the tail
    explainer's ranked per-segment report (obs/attribution.py) — the
    artifact an operator reads after the page should already name the
    guilty segment (queue wait vs batching window vs shared launch vs
    demux), not just say "p99 burned"."""
    out = {"slo": row}
    try:
        from datafusion_tpu_torch.obs import attribution

        out["tail"] = attribution.EXPLAINER.explain()
    except Exception:  # noqa: BLE001 — the breach artifact must survive a broken explainer
        pass
    return out


def objectives_from_env(environ=None) -> list[Objective]:
    """Parse ``DATAFUSION_TPU_SLO_<NAME>_<KIND>`` declarations.  The
    kind suffix is ``P50``/``P95``/``P99``/``ERROR_RATE``; the name is
    whatever precedes it (``ERROR_RATE`` alone names itself).  The
    reserved tuning knobs (``WINDOW_S``, ``MIN_SAMPLES``) are not
    objectives."""
    environ = os.environ if environ is None else environ
    prefix = "DATAFUSION_TPU_SLO_"
    reserved = {"WINDOW_S", "MIN_SAMPLES"}
    out = []
    for key in sorted(environ):
        if not key.startswith(prefix):
            continue
        suffix = key[len(prefix):]
        if suffix in reserved:
            continue
        kind = None
        name = None
        for tail, k in (("_P50", "p50"), ("_P95", "p95"), ("_P99", "p99"),
                        ("_ERROR_RATE", "error_rate"),
                        ("_HBM_FRAC", "hbm_frac"),
                        ("_FRESHNESS_S", "freshness_s")):
            if suffix.endswith(tail):
                kind, name = k, suffix[: -len(tail)].lower()
                break
        if kind is None and suffix == "ERROR_RATE":
            kind, name = "error_rate", "error_rate"
        if kind is None:
            continue
        try:
            threshold = float(environ[key])
            out.append(Objective(name or kind, kind, threshold))
        except (TypeError, ValueError):
            # malformed declarations (non-numeric, zero, negative —
            # `_ERROR_RATE=0` is a natural but unrepresentable ask:
            # burn rate would divide by it) skip rather than raise:
            # this runs at module import, and an exception here would
            # fail every query in the process over an env typo
            continue
    return out


def _arm_from_env() -> SloWatchdog:
    wd = SloWatchdog()
    for obj in objectives_from_env():
        wd.add(obj)
    return wd


# process-wide watchdog, armed from the environment at import; embedders
# add() objectives or swap the instance
WATCHDOG = _arm_from_env()
