"""Per-query observability: hierarchical spans, per-operator runtime
stats, EXPLAIN ANALYZE, the device ledger, the host sampling profiler
and exporters (the JAX package's `obs/`).

- `obs.trace`: Dapper-style hierarchical spans (`span(name, **attrs)`)
  with a per-query `TraceContext`; near-zero cost when disabled.
- `obs.stats`: per-operator runtime stats (rows and batches out, device
  and compile time, H2D/D2H bytes, launches) attached to physical
  operators (`Relation.stats`).
- `obs.explain`: `EXPLAIN ANALYZE <sql>` runs the query under a trace
  session and renders the annotated operator tree and span tree.
- `obs.device`: the device ledger (registered buffers, live and peak
  bytes, pins, headroom), `profile_sync` and the phase breakdown.
- `obs.profiler`: the host wall-clock sampling profiler (collapsed
  stacks, speedscope, per-phase top frames).
- `obs.export`: Chrome-trace / Perfetto JSON and Prometheus text over
  `utils.metrics.METRICS`.
- `obs.recorder`: the flight recorder: its event ring, dumps, the
  slow- and failed-query artifact capture and the crash hook.
- `obs.aggregate`: latency histograms, the per-query telemetry funnel
  (`query_completed`), node snapshots and the fleet aggregator.
- `obs.otlp`: OTLP/JSON span export (file, batched HTTP POST).
- `obs.slo`: the SLO watchdog (burn rates, breach captures).
- `obs.httpd`: the debug HTTP plane (`/metrics`, `/debug/*`, bundles).

Env knobs: `DATAFUSION_TPU_TRACE=1` collects spans engine-wide;
`DATAFUSION_TPU_TRACE_FILE=path.json` also writes a Chrome trace at
process exit (with `DATAFUSION_TPU_TRACE_FLUSH_S`, a flusher appends
JSON lines).  The span buffer holds 100000 spans (overflow counts in
`obs.spans_dropped`).  The flight recorder, the SLO watchdog, OTLP
export and the debug plane read the JAX package's variables
(``DATAFUSION_TPU_FLIGHT*``, ``DATAFUSION_TPU_SLO_*``,
``DATAFUSION_TPU_OTLP_*``, ``DATAFUSION_TPU_DEBUG_*``).
"""

from datafusion_tpu_torch.obs.trace import (  # noqa: F401 — public API surface
    TraceContext,
    adopt,
    current_span,
    current_trace,
    disable,
    drain,
    enable,
    enabled,
    ingest,
    session,
    span,
    spans,
)
