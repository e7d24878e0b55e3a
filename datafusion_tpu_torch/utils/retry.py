"""The device pass seam (the launch seam of the JAX package's
`utils/retry.py`, `device_call`).

Every device pass of an operator (one batch group of the aggregate, the
pipeline or the TopK, a full sort's run, a join's build and probe) runs
through `device_call(fn, *args, _tag=..., _device=...)`, which

- counts `device.launches` and `device.launches.<tag>` with the JAX
  package's tags (`agg`, `agg.group`, `pipeline`, `pipeline.group`,
  `topk`, `topk.group`, `sort`, `join.build`, `join.probe`),
- times the pass into the `device.dispatch` stage timer (the "execute"
  phase of `obs/device.phase_breakdown`) and publishes that stage to the
  sampling profiler while `fn` runs,
- attributes the launch to the ambient operator (`obs/stats.record_launch`).

A pass queues CUDA work and returns before the card has done it, so
outside `obs/device.profile_sync()` the timer measures the host's
launch work only, and the seam adds no synchronize and no event.
Inside it, a pass on a CUDA device records a
`torch.cuda.Event(enable_timing=True)` pair around `fn`, waits on the
second at the end of the pass and accrues the elapsed device time
instead, so EXPLAIN ANALYZE's "execute" is device time.

The JAX package's retry budgets and transient-error classification are
not ported (ROADMAP queue 1, item 13.2): a pass that raises, raises.
"""

from __future__ import annotations

import time

from datafusion_tpu_torch.obs.device import profile_sync_active
from datafusion_tpu_torch.obs.stats import record_launch
from datafusion_tpu_torch.utils.metrics import METRICS, stage_enter, stage_exit


def device_call(fn, /, *args, _tag=None, _device=None, **kwargs):
    """Run one device pass `fn(*args, **kwargs)` on `_device` (see the
    module docstring) and return its result."""
    events = None
    if _device is not None and _device.type == "cuda" and profile_sync_active():
        import torch

        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    tok = stage_enter("device.dispatch")
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
        if events is not None:
            events[1].record()
            events[1].synchronize()
    finally:
        stage_exit(tok)
    wall = (time.perf_counter() - t0 if events is None
            else events[0].elapsed_time(events[1]) / 1e3)
    if _tag is None:
        METRICS.tally("device.dispatch", wall, ("device.launches", 1))
    else:
        METRICS.tally("device.dispatch", wall, ("device.launches", 1),
                      (f"device.launches.{_tag}", 1))
    record_launch()
    return out
