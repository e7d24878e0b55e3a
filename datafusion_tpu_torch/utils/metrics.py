"""Per-stage timing, counters and gauges.

The counterpart of the JAX package's `utils/metrics.py`: `METRICS`, one
process-wide registry of named counters (`add`), stage timings
(`timer`, `timed_iter`, `observe`) and point-in-time gauges (`gauge`).
The counters the serving front door and EXPLAIN ANALYZE read:

- `device.h2d.transfers` and `h2d.bytes`: every host-to-device copy of
  a column, a mask, group ids or an aux table (`exec/batch.to_device`);
  `d2h.bytes`: every pull (`exec/batch.to_host`);
- `device.launches` and `device.launches.<tag>`: every device pass
  (`utils/retry.device_call`); `fused.groups` and
  `fused.group_batches`: passes over more than one batch and the
  batches they folded; `kernel_cache.hits` and `kernel_cache.misses`
  (`exec/kernels.cached_kernel`);
- `queries_admitted`: every plan `ExecutionContext.execute` lowers;
- `queries_queued`, `queries_shed` and the `serve.*` counters of
  `serve.py`: `serve.megabatches` (megabatches run),
  `serve.megabatch_queries` (the queries they folded),
  `serve.megabatch_launches` and `serve.megabatch_batches` (their
  passes, one per batch group, and the batches those read);
  `join.build.reuse` (join/relation.py).

Counter and timing updates take one lock, `utils.metrics`: the serving
workers and the prefetch threads count concurrently, and the gates that
compare metered seconds with `device.dispatch` to 1e-6 need exact
counts.  This departs from the JAX package, whose increments take no
lock (rule DF005 of `analysis/lint.py`), so the lock is a named leaf
(`analysis/lockcheck.make_lock`): nothing is called under it but dict
arithmetic, it acquires no other lock, and each `with` carries the
reviewed DF005 marker.  A lock-order run shows edges into it and none
out of it.  Gauges and the profiler's stage tables take no lock: the
device ledger sets gauges from weak-reference callbacks, which may run
inside any critical section, this registry's included.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from datafusion_tpu_torch.analysis import lockcheck

# -- profiler publication tables (obs/profiler.py) --------------------
# While the sampling profiler has at least one capture running, these
# hold {thread ident: current stage timer name} and {thread ident:
# current trace id}; the sampler thread reads them to attribute each
# stack sample to a phase and a query (a sampler cannot read another
# thread's contextvars).  The publishers (`Metrics.timer`, `timed_iter`,
# the copy seams, `obs/trace.session`/`adopt`) pay one module-global
# read and a None check when no capture runs.  Plain dict operations, no
# lock: publication runs inside other subsystems' critical sections.  A
# table swapped out mid-scope means a stale restore writes into an
# orphaned dict, which the profiler tolerates.
PROFILE_STAGES = None  # type: ignore[var-annotated]
PROFILE_TRACES = None  # type: ignore[var-annotated]


# -- per-client charge scopes (obs/attribution.py) --------------------
# {thread ident: scope}: which client's work this thread is doing,
# published by the serving front door (`attribution.client_scope`,
# `shared_scope`) and read by the charge hooks on other subsystems' hot
# paths (`utils/retry.device_call`'s launch walls, `obs/device.note_h2d`).
# Plain dict operations, no lock, as for the tables above; always a
# dict, so a reader pays one `.get` miss when nothing is served.
CLIENT_SCOPES: dict = {}


def set_profile_tables(stages, traces) -> None:
    """Install (or clear, with None/None) the publication tables: the
    profiler calls this when its first capture starts and its last
    ends."""
    global PROFILE_STAGES, PROFILE_TRACES
    PROFILE_STAGES = stages
    PROFILE_TRACES = traces


def stage_enter(name: str):
    """Publish `name` as this thread's stage for the sampling profiler.
    Returns a restore token for `stage_exit` (None when no capture
    runs)."""
    tbl = PROFILE_STAGES
    if tbl is None:
        return None
    tid = threading.get_ident()
    prev = tbl.get(tid)
    tbl[tid] = name
    return (tbl, tid, prev)


def stage_exit(token) -> None:
    if token is None:
        return
    tbl, tid, prev = token
    if prev is None:
        tbl.pop(tid, None)
    else:
        tbl[tid] = prev


class Metrics:
    def __init__(self):
        self.timings: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = {}
        self._declared: set[str] = set()
        self._lock = lockcheck.make_lock("utils.metrics")  # df-lint: ok(DF005) — a leaf lock: exact counts, nothing acquired under it

    @contextmanager
    def timer(self, name: str):
        tok = stage_enter(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stage_exit(tok)
            with self._lock:  # df-lint: ok(DF005) — the leaf lock above
                self.timings[name] += dt

    def timed_iter(self, name: str, it):
        """Wrap a generator so time spent producing items (a reader's
        parse) accrues to `name`, while the consumer's time does not."""
        while True:
            tok = stage_enter(name)
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                dt = time.perf_counter() - t0
                stage_exit(tok)
                with self._lock:  # df-lint: ok(DF005) — the leaf lock above
                    self.timings[name] += dt
            yield item

    def observe(self, name: str, seconds: float) -> None:
        """Fold a duration measured elsewhere (a CUDA event pair, a
        build) into a stage timing."""
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            self.timings[name] += seconds

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            self.counts[name] += n

    def tally(self, timer: str, seconds: float, *counts) -> None:
        """Fold one timed event, `seconds` into `timer` and each
        (name, n) of `counts` into its counter, under one acquisition of
        the lock (the copy and pass seams call this once an event)."""
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            self.timings[timer] += seconds
            for name, n in counts:
                self.counts[name] += n

    def declare(self, *names: str) -> None:
        """Materialize counters at zero so their names render in every
        snapshot from process start; declared names survive `reset`."""
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            self._declared.update(names)
            for name in names:
                self.counts[name] += 0

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge (last write wins).  Lock-free: see
        the module docstring."""
        self.gauges[name] = value

    def reset(self) -> None:
        """Clear every timing, counter and gauge but the declared
        counters (the console's `\\timing` shows one statement's)."""
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            self.timings.clear()
            self.counts.clear()
            self.gauges.clear()
            for name in self._declared:
                self.counts[name] += 0

    def snapshot(self) -> dict:
        with self._lock:  # df-lint: ok(DF005) — the leaf lock above
            return {"timings_s": dict(self.timings), "counts": dict(self.counts),
                    "gauges": dict(self.gauges)}


METRICS = Metrics()
