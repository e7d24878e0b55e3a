"""Exporters: Chrome-trace / Perfetto JSON and Prometheus text.

The counterpart of the JAX package's `obs/export.py`, the same
functions and the same output.  `chrome_trace(spans)` turns span dicts
(local or ingested from another process; timelines merge by trace id,
since both sides stamp the shared wall clock) into the Chrome
`traceEvents` format that `chrome://tracing` and
https://ui.perfetto.dev load.  `prometheus_text()` renders the engine's
counter, timing and gauge registry (`utils.metrics.METRICS`, the one
counter backend: nothing is counted again here) in the Prometheus text
exposition format; `ExecutionContext.metrics_text()` returns it.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from datafusion_tpu_torch.utils.metrics import METRICS

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]+")


def chrome_trace(spans: list[dict]) -> dict:
    """Complete-event (`ph: "X"`) Chrome trace from span dicts.  Each
    distinct span `proc` becomes a trace process (with a process_name
    metadata record), so coordinator and worker timelines render as
    separate swimlanes of one merged trace."""
    pids: dict[str, int] = {}
    events: list[dict] = []
    for sp in spans:
        proc = str(sp.get("proc", "?"))
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": proc},
            })
        args = dict(sp.get("attrs") or {})
        args["trace_id"] = sp.get("trace_id")
        args["span_id"] = sp.get("span_id")
        if sp.get("parent_id"):
            args["parent_id"] = sp["parent_id"]
        events.append({
            "ph": "X",
            "name": sp["name"],
            "cat": "datafusion_tpu",
            "ts": sp["start_ns"] / 1e3,  # chrome wants microseconds
            "dur": max(sp["end_ns"] - sp["start_ns"], 0) / 1e3,
            "pid": pid,
            "tid": int(sp.get("tid", 0)) % (1 << 31),
            "args": args,
        })
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: list[dict]) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans), f)
    return path


def _metric_name(name: str) -> str:
    """Sanitize a string into a legal Prometheus metric IDENTIFIER
    (`[a-zA-Z_:][a-zA-Z0-9_:]*`): runs of illegal characters collapse
    to one underscore (so `a.b` and `a-b` stay distinguishable from a
    literal `a_b` only via labels — identifiers genuinely cannot carry
    dots), and a leading digit gains a `_` prefix.  Only for names
    used AS identifiers; label values go through `_label_value`, which
    preserves the original spelling."""
    out = _NAME_RE.sub("_", name) or "_"
    if out[0].isdigit():
        out = "_" + out
    return out


def _label_value(value: str) -> str:
    """Escape a label VALUE per the exposition format (backslash,
    double-quote, newline).  Label values are free-form UTF-8 — dotted
    engine metric names (`cache.result.hits`) pass through verbatim
    instead of being flattened to underscores, so two counters that
    differ only in punctuation can no longer collide in a scrape."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def prometheus_text(metrics=None, extra_gauges: Optional[dict] = None) -> str:
    """The engine counter registry in Prometheus text exposition format.

    Timings render as `datafusion_tpu_timing_seconds_total{stage=...}`,
    counters as `datafusion_tpu_events_total{name=...}`; `extra_gauges`
    ({name: value}) lets callers add point-in-time gauges (queue depths,
    buffered spans) without minting a second registry.  Engine metric
    names land in label values with their dots intact (see
    `_label_value`).
    """
    snap = (metrics if metrics is not None else METRICS).snapshot()
    lines = [
        "# HELP datafusion_tpu_timing_seconds_total cumulative engine "
        "stage timings",
        "# TYPE datafusion_tpu_timing_seconds_total counter",
    ]
    for k in sorted(snap["timings_s"]):
        lines.append(
            f'datafusion_tpu_timing_seconds_total{{stage="{_label_value(k)}"}} '
            f"{snap['timings_s'][k]:.9f}"
        )
    lines += [
        "# HELP datafusion_tpu_events_total cumulative engine counters",
        "# TYPE datafusion_tpu_events_total counter",
    ]
    for k in sorted(snap["counts"]):
        lines.append(
            f'datafusion_tpu_events_total{{name="{_label_value(k)}"}} '
            f"{snap['counts'][k]}"
        )
    gauges = dict(snap.get("gauges") or {})
    if extra_gauges:
        gauges.update(extra_gauges)
    if gauges:
        lines.append("# TYPE datafusion_tpu_gauge gauge")
        for k in sorted(gauges):
            lines.append(
                f'datafusion_tpu_gauge{{name="{_label_value(k)}"}} '
                f"{gauges[k]}"
            )
    return "\n".join(lines) + "\n"
