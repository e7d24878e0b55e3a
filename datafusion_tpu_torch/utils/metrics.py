"""Per-stage timing and counters.

The counterpart of the JAX package's `utils/metrics.py`: `METRICS`, one
process-wide registry of named counters (`add`) and stage timings
(`timer`, `timed_iter`).  The counters the serving front door asserts on:

- `device.h2d.transfers` and `h2d.bytes`: every host-to-device copy of
  a column, a mask, group ids or an aux table (`exec/batch.to_device`);
- `queries_admitted`: every plan `ExecutionContext.execute` lowers;
- `queries_queued`, `queries_shed` and the `serve.*` counters of
  `serve.py`: `serve.megabatches` (megabatches run),
  `serve.megabatch_queries` (the queries they folded),
  `serve.megabatch_launches` and `serve.megabatch_batches` (their
  passes, one per batch group, and the batches those read);
  `join.build.reuse` (join/relation.py).

Updates take one lock: the serving workers and the prefetch threads
count concurrently.  The JAX package's gauges and profiler publication
tables wait for the observability slice (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self.timings: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name] += dt

    def timed_iter(self, name: str, it):
        """Wrap a generator so time spent producing items (a reader's
        parse) accrues to `name`, while the consumer's time does not."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.timings[name] += dt
            yield item

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def reset(self) -> None:
        """Clear every timing and counter (the console's `\\timing`
        shows one statement's)."""
        with self._lock:
            self.timings.clear()
            self.counts.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"timings_s": dict(self.timings), "counts": dict(self.counts)}


METRICS = Metrics()
