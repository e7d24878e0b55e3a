"""EXPLAIN ANALYZE: run the query under a trace session, annotate the
physical operator tree with its measured runtime stats, and render the
span timeline.

The counterpart of the JAX package's `obs/explain.py`, with its report
line for line: the phase bar (`obs/device.phase_bar`; "execute" is
device time, from CUDA events, since the run is under
`obs/device.profile_sync`), the HBM line of the device ledger, the host
profile's top frames per phase (`obs/profiler.py`;
`DATAFUSION_TPU_PROFILE_EXPLAIN=0` leaves it out), one line per
operator with its rows, batches, times, bytes and launches and the
`<- fused pass [...]` marker of a collapsed chain, the fused-pass line
of the query's counter deltas, the cost planner's decisions and replans
made while this query planned and ran ("Cost decisions", "Replans";
cost/), and the span tree.  A query the result
cache answers shows as one `CachedResult[rows=..., bytes=..., fp=...]`
operator with `cache.hit=True`; an analyzed miss fills the cache as a
plain run does.

The run feeds the per-query telemetry funnel as a plain query does
(obs/aggregate.query_completed); `otlp()` and `write_otlp()` give its
spans as an OTLP/JSON document (obs/otlp.py), and the environment's
OTLP export (``DATAFUSION_TPU_OTLP_FILE`` / ``_ENDPOINT``) receives the
complete span set once, from here and not from the funnel.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from datafusion_tpu_torch.obs import trace
from datafusion_tpu_torch.obs.device import _fmt_bytes
from datafusion_tpu_torch.obs.stats import collect_tree, iter_stats

# the counters whose per-query deltas the report's fused-pass line reads
_WATCHED = ("device.launches", "kernel_cache.hits", "kernel_cache.misses",
            "fused.groups", "fused.group_batches")


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.3f}ms" if s < 1.0 else f"{s:.3f}s"


def _op_line(rel) -> str:
    st = rel.stats
    parts = [f"rows={st.rows_out}", f"batches={st.batches_out}",
             f"time={_fmt_s(st.time_s)}"]
    if st.execute_s:
        parts.append(f"device={_fmt_s(st.execute_s)}")
    if st.compile_s:
        parts.append(f"compile={_fmt_s(st.compile_s)}")
    if st.h2d_bytes:
        parts.append(f"h2d={_fmt_bytes(st.h2d_bytes)}")
    if st.d2h_bytes:
        parts.append(f"d2h={_fmt_bytes(st.d2h_bytes)}")
    if st.retries:
        parts.append(f"retries={st.retries}")
    for k, v in st.attrs.items():
        parts.append(f"{k}={v}")
    return f"{rel.op_label()}  [{', '.join(parts)}]"


def _render_spans(span_dicts: list[dict]) -> list[str]:
    """Indent spans under their parents (orphans, such as a prefetch
    thread's, sit at the root) in start-time order."""
    by_id = {s["span_id"]: s for s in span_dicts}
    children: dict[Optional[str], list[dict]] = {}
    for s in span_dicts:
        parent = s.get("parent_id")
        if parent not in by_id:
            parent = None
        children.setdefault(parent, []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s["start_ns"])
    lines: list[str] = []

    def walk(parent_id, depth):
        for s in children.get(parent_id, ()):
            dur = max(s["end_ns"] - s["start_ns"], 0) / 1e9
            attrs = s.get("attrs") or {}
            attr_txt = (
                "{" + ", ".join(f"{k}={v}" for k, v in attrs.items()) + "}"
                if attrs else ""
            )
            lines.append("  " * depth
                         + f"{s['name']}{attr_txt}  {_fmt_s(dur)}  [{s.get('proc', '?')}]")
            walk(s["span_id"], depth + 1)

    walk(None, 0)
    return lines


class ExplainAnalyzeResult:
    """The result of `EXPLAIN ANALYZE <stmt>`: the logical plan, the
    executed operator tree (stats attached), the query's rows
    (`.result`) and its spans (`.spans`).  `repr()` renders the
    annotated report; `chrome_trace()` exports the timeline."""

    def __init__(self, plan, root, result, spans: list[dict], trace_id: str,
                 wall_s: float, counters: Optional[dict] = None,
                 phases: Optional[dict] = None, hbm: Optional[dict] = None,
                 host_profile=None, cost: Optional[dict] = None):
        self.plan = plan
        self.root = root
        self.result = result
        self.spans = spans
        self.trace_id = trace_id
        self.wall_s = wall_s
        # the query's counter deltas (passes, core-cache hits and
        # misses, batch groups)
        self.counters = counters or {}
        # seconds per phase (obs/device.phase_breakdown) and the query's
        # high-water mark in the device ledger
        self.phases = phases or {}
        self.hbm = hbm or {}
        # the host sampling profile of the run (None when
        # DATAFUSION_TPU_PROFILE_EXPLAIN=0)
        self.host_profile = host_profile
        # the cost store's decisions and replans made during this query
        self.cost = cost or {}

    def report(self) -> str:
        lines = [f"EXPLAIN ANALYZE  (trace {self.trace_id}, "
                 f"wall {_fmt_s(self.wall_s)}, rows {self.result.num_rows})"]
        if self.phases:
            from datafusion_tpu_torch.obs.device import phase_bar

            lines.append("Phases: " + phase_bar(self.phases, self.wall_s))
        if self.hbm:
            lines.append(
                f"HBM: peak {_fmt_bytes(self.hbm.get('peak_bytes', 0))} "
                f"(live {_fmt_bytes(self.hbm.get('live_bytes', 0))}, "
                f"{self.hbm.get('buffers', 0)} buffer(s); device ledger)"
            )
        prof = self.host_profile
        if prof is not None and prof.samples:
            lines.append(f"Host profile ({prof.summary()}):")
            for phase, d in prof.by_phase(3).items():
                frames = " · ".join(f"{label} ×{count}" for label, count in d["top_frames"])
                lines.append(f"  {phase}: {d['samples']} sample(s) — {frames}")
        for depth, rel in collect_tree(self.root):
            fused_chain = getattr(rel, "_fused_chain", None)
            marker = f"  <- fused pass [{fused_chain}]" if fused_chain else ""
            lines.append("  " * (depth + 1) + _op_line(rel) + marker)
        if self.counters:
            c = self.counters
            lines.append(
                "Fused passes: "
                f"launches_per_pass={c.get('device.launches', 0)}, "
                f"fused_groups={c.get('fused.groups', 0)} "
                f"({c.get('fused.group_batches', 0)} batches), "
                f"kernel_cache hit/miss="
                f"{c.get('kernel_cache.hits', 0)}/"
                f"{c.get('kernel_cache.misses', 0)}"
            )
        decisions = self.cost.get("decisions") or []
        replans = self.cost.get("replans") or []
        if decisions:
            lines.append(f"Cost decisions ({len(decisions)}):")
            for d in decisions:
                where = f" [{d['table']}]" if d.get("table") else ""
                lines.append(f"  {d['decision']}{where}: chose {d['chosen']} "
                             f"(default {d['default']}) — {d['reason']}")
        if replans:
            lines.append(f"Replans ({len(replans)}):")
            for r in replans:
                lines.append(f"  {r['what']}: estimated {r['estimate']}, "
                             f"observed {r['actual']} — {r['action']}")
        worker_spans = sum(1 for s in self.spans
                           if str(s.get("proc", "")).startswith("worker"))
        lines.append(f"Spans ({len(self.spans)} total, {worker_spans} worker-side):")
        lines += ["  " + ln for ln in _render_spans(self.spans)]
        return "\n".join(lines)

    def chrome_trace(self) -> dict:
        from datafusion_tpu_torch.obs.export import chrome_trace

        return chrome_trace(self.spans)

    def write_chrome_trace(self, path: str) -> str:
        from datafusion_tpu_torch.obs.export import write_chrome_trace

        return write_chrome_trace(path, self.spans)

    def otlp(self) -> dict:
        from datafusion_tpu_torch.obs.otlp import spans_to_otlp

        return spans_to_otlp(self.spans)

    def write_otlp(self, path: str) -> str:
        from datafusion_tpu_torch.obs.otlp import write_otlp

        return write_otlp(path, self.spans)

    def __repr__(self):
        return self.report()


class _RootTap:
    """Relation facade whose batches() run through the instrumentation
    seam: gives the ROOT operator its stats (interior operators are
    instrumented by their consumers)."""

    def __init__(self, rel):
        self.rel = rel
        # the result cache's capture hook: an analyzed run fills the
        # cache as a plain run does (cache/result.py)
        fill = getattr(rel, "_result_cache_fill", None)
        if fill is not None:
            self._result_cache_fill = fill
        # the telemetry markers: an analyzed query feeds the funnel as a
        # plain one does, with the real tree for its operator report and
        # the context's stage-timer snapshot for its phases; the complete
        # span set exports after the run, so the funnel does not
        label = getattr(rel, "_telemetry_query", None)
        if label is not None:
            self._telemetry_query = label
            self._telemetry_root = rel
            pb = getattr(rel, "_phase_before", None)
            if pb is not None:
                self._phase_before = pb
            self._telemetry_skip_otlp = True
        dumps = getattr(rel, "collect_flight_dumps", None)
        if dumps is not None:
            self.collect_flight_dumps = dumps

    @property
    def schema(self):
        return self.rel.schema

    def batches(self):
        return iter_stats(self.rel)


def _profile_explain() -> bool:
    return os.environ.get("DATAFUSION_TPU_PROFILE_EXPLAIN", "").lower() not in (
        "0", "false", "off", "no")


def explain_analyze(ctx, plan, decision_mark: Optional[int] = None) -> ExplainAnalyzeResult:
    """Execute `plan` on `ctx` under a fresh trace session and package
    the annotated result.  The query runs to completion: EXPLAIN ANALYZE
    measures a real execution.  `decision_mark` is the cost store's
    decision serial from before `plan` was planned (the caller marks it,
    so the logical rewrites' decisions show); the decisions past it and
    the replans from this run are the report's cost view."""
    from datafusion_tpu_torch import cost as _cost
    from datafusion_tpu_torch.exec.materialize import collect
    from datafusion_tpu_torch.obs import profiler
    from datafusion_tpu_torch.obs.device import (
        LEDGER,
        phase_breakdown,
        phase_snapshot,
        profile_sync,
    )
    from datafusion_tpu_torch.utils.metrics import METRICS

    cstore = _cost.store()
    if decision_mark is None:
        decision_mark = cstore.decision_serial
    replan_mark = time.time()
    before = METRICS.snapshot()["counts"]
    phase_before = phase_snapshot()
    LEDGER.begin_peak_window()
    # profile(): host-stack sampling for the run, started first so the
    # session publishes its trace id to the sampler; profile_sync: each
    # pass is timed by CUDA events, so "execute" is device time
    with profiler.profile(name="explain_analyze", enabled=_profile_explain()) as cap, \
            trace.session() as tc, profile_sync():
        t0 = time.perf_counter()
        with trace.span("query", plan=type(plan).__name__):
            rel = ctx.execute(plan)
            table = collect(_RootTap(rel))
        wall = time.perf_counter() - t0
    host_profile = None if cap is None else cap.report()
    cost_view = {
        "decisions": [d for d in list(cstore.decisions) if d.get("seq", 0) > decision_mark],
        "replans": [r for r in list(cstore.replans) if r.get("ts", 0.0) >= replan_mark],
    }
    phases = phase_breakdown(phase_before, wall)
    hbm = {"peak_bytes": LEDGER.window_peak_bytes(), "live_bytes": LEDGER.buffer_bytes(),
           "buffers": LEDGER.entries}
    after = METRICS.snapshot()["counts"]
    counters = {k: after.get(k, 0) - before.get(k, 0) for k in _WATCHED}
    METRICS.gauge("query.launches_per_pass", counters["device.launches"])
    METRICS.gauge("query.kernel_cache_misses", counters["kernel_cache.misses"])
    spans = trace.drain(tc.trace_id)
    spans.sort(key=lambda s: s["start_ns"])
    # the environment's OTLP export gets the COMPLETE set (the funnel ran
    # while the root span was still open)
    from datafusion_tpu_torch.obs.otlp import export_spans

    export_spans(spans)
    return ExplainAnalyzeResult(plan, rel, table, spans, tc.trace_id, wall, counters,
                                phases=phases, hbm=hbm, host_profile=host_profile,
                                cost=cost_view)
