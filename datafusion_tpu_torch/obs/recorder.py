"""Always-on query flight recorder: a lock-free bounded ring of
trace-correlated structured events (the JAX package's
`obs/recorder.py`).

Every node (the engine, a serving front door, a worker) records
lifecycle events (`query.done`, `serve.pin`, `device.h2d`,
`fragment.serve`, `device.retry`, ...) into a fixed-size ring, always,
and the ring is dumpable as JSON:

- on demand (`dump()`, the worker's ``{"type": "flight_dump"}``
  request, ``/debug/flights``);
- automatically on a slow query (its wall crosses
  ``DATAFUSION_TPU_FLIGHT_SLOW_S``) and on a failed one: a correlated
  artifact set (the ring, the query's span tree as OTLP, the operator
  report, the tail explainer, the continuous host profile, every
  involved worker's ring;
  `capture_query_artifacts`);
- on an SLO breach (obs/slo.py) and on a process crash (a chained
  ``sys.excepthook``, `install_crash_hook`).

Cost model: `record` takes no lock: one module-flag read, one
contextvar read for the trace id, one ``itertools.count`` bump (atomic
under the interpreter lock) and one slot store, so it may run inside any
other subsystem's critical section.  A reader snapshots the slot list
and tolerates torn ordering at the wrap boundary (events carry their
own nanosecond timestamps).

Knobs, the JAX package's names and defaults, so one deployment
configures both packages: ``DATAFUSION_TPU_FLIGHT`` (default on; ``0``
turns `record` into a no-op), ``DATAFUSION_TPU_FLIGHT_BUF`` (ring
capacity, 8192), ``DATAFUSION_TPU_FLIGHT_SLOW_S`` (slow-query threshold,
10 s), ``DATAFUSION_TPU_FLIGHT_DIR`` (dump directory,
``$TMPDIR/datafusion_tpu_flight``),
``DATAFUSION_TPU_FLIGHT_DUMP_INTERVAL_S`` (automatic-dump throttle,
30 s: a failure storm leaves one artifact an interval).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Optional

from datafusion_tpu_torch.obs.trace import _current_trace
from datafusion_tpu_torch.utils.metrics import METRICS

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("0", "false", "off", "no")


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name, "").lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    return default


_ENABLED = _env_flag("DATAFUSION_TPU_FLIGHT", True)
_CAP = max(int(os.environ.get("DATAFUSION_TPU_FLIGHT_BUF", "8192") or 8192), 8)
_SLOW_S = float(os.environ.get("DATAFUSION_TPU_FLIGHT_SLOW_S", "10") or 10)
_DIR = os.environ.get("DATAFUSION_TPU_FLIGHT_DIR") or os.path.join(
    tempfile.gettempdir(), "datafusion_tpu_flight")
_DUMP_INTERVAL_S = float(os.environ.get("DATAFUSION_TPU_FLIGHT_DUMP_INTERVAL_S", "30") or 30)

# slot i % cap holds the i'th event emitted; the cursor's value is the
# count emitted.  Slots and capacity live in ONE tuple so a resize swaps
# both in one store: an emitter that read the tuple before the swap
# indexes the old list with the old capacity, never a mix.
_ring: tuple[list, int] = ([None] * _CAP, _CAP)
_cursor = itertools.count()
# time.monotonic of the last automatic dump; None = never (not 0.0: the
# monotonic clock is uptime, and a fresh host would throttle the first)
_last_auto_dump: Optional[float] = None


def enabled() -> bool:
    return _ENABLED


def slow_threshold_s() -> float:
    """Queries whose wall crosses this capture an artifact set."""
    return _SLOW_S


def dump_dir() -> str:
    return _DIR


def configure(enabled: Optional[bool] = None, capacity: Optional[int] = None,
              slow_s: Optional[float] = None, directory: Optional[str] = None,
              dump_interval_s: Optional[float] = None) -> None:
    """Override the knobs (tests, embedders).  Resizing clears the ring."""
    global _ENABLED, _CAP, _SLOW_S, _DIR, _DUMP_INTERVAL_S
    global _ring, _cursor, _last_auto_dump
    if enabled is not None:
        _ENABLED = bool(enabled)
    if capacity is not None and capacity != _CAP:
        _CAP = max(int(capacity), 8)
        _cursor = itertools.count()
        _ring = ([None] * _CAP, _CAP)
    if slow_s is not None:
        _SLOW_S = float(slow_s)
    if directory is not None:
        _DIR = directory
    if dump_interval_s is not None:
        _DUMP_INTERVAL_S = float(dump_interval_s)
        _last_auto_dump = None


def clear() -> None:
    """Drop every buffered event (tests: old events age out by wraparound)."""
    global _ring, _cursor
    _cursor = itertools.count()
    _ring = ([None] * _CAP, _CAP)


def record(kind: str, **attrs: Any) -> None:
    """Emit one event; `attrs` are JSON-representable scalars."""
    if not _ENABLED:
        return
    tc = _current_trace.get()
    slots, cap = _ring  # one read: list and capacity match
    i = next(_cursor)
    slots[i % cap] = (time.time_ns(), kind, None if tc is None else tc.trace_id,
                      threading.get_ident(), attrs or None)


def emitted() -> int:
    """Events ever emitted (`emitted() - len(events())` aged out)."""
    # the counter's repr, "count(N)", shows the next value unconsumed
    return int(repr(_cursor)[6:-1])


def events(kind: Optional[str] = None, trace_id: Optional[str] = None) -> list[dict]:
    """The ring as event dicts, oldest first: of one `kind`, of one
    query's `trace_id`, or all."""
    slots, cap = _ring
    snap = list(slots)
    n = emitted()
    if n >= cap:
        start = n % cap  # the oldest surviving slot
        ordered = snap[start:] + snap[:start]
    else:
        ordered = snap[:n]
    out = []
    for ev in ordered:
        if ev is None:
            continue
        ts, k, tid_trace, tid, attrs = ev
        if kind is not None and k != kind:
            continue
        if trace_id is not None and tid_trace != trace_id:
            continue
        d = {"ts_ns": ts, "kind": k, "tid": tid}
        if tid_trace is not None:
            d["trace_id"] = tid_trace
        if attrs:
            d["attrs"] = dict(attrs)
        out.append(d)
    # writes racing at the wrap boundary can land out of order
    out.sort(key=lambda d: d["ts_ns"])
    return out


def _node_label() -> str:
    from datafusion_tpu_torch.obs import trace

    return f"{trace._ROLE}:{os.getpid()}"


def dump(reason: str, path: Optional[str] = None, extra: Optional[dict] = None) -> str:
    """Write the ring to a JSON artifact and return its path; `extra`
    folds caller context (the query, worker rings) into the document."""
    if path is None:
        os.makedirs(_DIR, exist_ok=True)
        path = os.path.join(
            _DIR, f"flight-{_node_label().replace(':', '-')}-{time.time_ns()}.json")
    doc = {
        "reason": reason,
        "node": _node_label(),
        "recorded_at_ns": time.time_ns(),
        "events_emitted": emitted(),
        "events": events(),
    }
    if extra:
        doc.update(extra)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    METRICS.add("flight.dumps")
    return path


def auto_capture(reason: str, extra_fn: Optional[Callable[[], dict]] = None) -> Optional[str]:
    """Throttled automatic dump (slow or failed query, SLO breach): at
    most one an interval, and never raises.  `extra_fn` builds the
    context only when a dump happens."""
    global _last_auto_dump
    if not _ENABLED:
        return None
    now = time.monotonic()
    if _DUMP_INTERVAL_S > 0 and _last_auto_dump is not None \
            and now - _last_auto_dump < _DUMP_INTERVAL_S:
        METRICS.add("flight.dumps_throttled")
        return None
    _last_auto_dump = now
    try:
        extra = extra_fn() if extra_fn is not None else None
        return dump(reason, extra=extra)
    except Exception:  # noqa: BLE001 — capture is best-effort by contract
        METRICS.add("flight.dump_errors")
        return None


def capture_query_artifacts(reason: str, *, wall_s: Optional[float] = None,
                            trace_id: Optional[str] = None, root=None,
                            label: Optional[str] = None, error: Optional[str] = None,
                            phases: Optional[dict] = None,
                            node_dumps_fn: Optional[Callable[[], dict]] = None,
                            ) -> Optional[str]:
    """One correlated artifact for a slow or failed query: this node's
    events, every involved node's (`node_dumps_fn`, called only when a
    dump happens, so a throttled capture touches no network), the
    query's spans as an OTLP document, its phase breakdown, the
    continuous profile (`profile`, when DATAFUSION_TPU_PROFILE_HZ runs
    one), the tail explainer's report and the operator report of an
    instrumented run."""

    def _extra() -> dict:
        from datafusion_tpu_torch.obs import attribution
        from datafusion_tpu_torch.obs import trace as obs_trace
        from datafusion_tpu_torch.obs.otlp import spans_to_otlp

        spans = obs_trace.spans(trace_id) if trace_id else []
        extra: dict = {"query": {"label": label, "wall_s": wall_s,
                                 "trace_id": trace_id, "error": error}}
        if phases:
            extra["query"]["phases"] = dict(phases)
        # the continuous host profiler's rolling report rides along
        # (DATAFUSION_TPU_PROFILE_HZ): the slow query's artifact then
        # says where the host's time went beside what happened
        from datafusion_tpu_torch.obs import profiler as _profiler

        prof = _profiler.continuous_report()
        if prof is not None and prof.samples:
            extra["profile"] = prof.to_json()
        try:
            extra["tail"] = attribution.EXPLAINER.explain()
            if spans:
                extra["critical_path"] = attribution.critical_path_from_spans(spans)
        except Exception:  # noqa: BLE001 — attribution must not block the dump
            pass
        if spans:
            extra["otlp"] = spans_to_otlp(spans)
        if node_dumps_fn is not None:
            try:
                extra["nodes"] = node_dumps_fn()
            except Exception:  # noqa: BLE001 — the survivors' evidence only
                pass
        if root is not None:
            try:
                from datafusion_tpu_torch.obs.explain import _op_line
                from datafusion_tpu_torch.obs.stats import collect_tree

                extra["explain"] = ["  " * depth + _op_line(rel)
                                    for depth, rel in collect_tree(root)]
            except Exception:  # noqa: BLE001 — a half-built tree must not block the dump
                pass
        return extra

    return auto_capture(reason, _extra)


# -- crash hook ---------------------------------------------------------
_prev_excepthook = None
_hook_installed = False


def install_crash_hook() -> None:
    """Chain a ``sys.excepthook`` that dumps the ring on an unhandled
    exception, then calls the previous hook.  Idempotent;
    KeyboardInterrupt and SystemExit pass through undumped."""
    global _prev_excepthook, _hook_installed
    if _hook_installed:
        return
    _hook_installed = True
    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            try:
                dump("crash", extra={"error": f"{exc_type.__name__}: {exc}"})
            except Exception:  # noqa: BLE001 — the hook must reach the original handler
                pass
        (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    sys.excepthook = _hook


if _ENABLED:
    install_crash_hook()
