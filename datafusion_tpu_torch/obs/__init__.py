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
- `obs.recorder`: the flight recorder's event ring.

Env knobs: `DATAFUSION_TPU_TRACE=1` collects spans engine-wide;
`DATAFUSION_TPU_TRACE_FILE=path.json` also writes a Chrome trace at
process exit (with `DATAFUSION_TPU_TRACE_FLUSH_S`, a flusher appends
JSON lines).  The span buffer holds 100000 spans (overflow counts in
`obs.spans_dropped`).  The JAX package's
recorder dumps, OTLP export, fleet aggregation, SLOs and debug HTTP
plane wait for ROADMAP queue 1 item 13.2.
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
