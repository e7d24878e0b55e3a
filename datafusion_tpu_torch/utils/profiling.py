"""The PyTorch profiler around a block (the JAX package's
`utils/profiling.py`, which wraps the XLA profiler).

`trace(log_dir)` profiles a block with `torch.profiler` over the CPU
and, where CUDA is available, the card, and writes a Chrome trace
(`trace.json`, loadable in `chrome://tracing` or
https://ui.perfetto.dev) into `log_dir`: every kernel launch (the
hand-written `hash_agg`, `sort_kernel` and `hash_build` kernels among
them), every copy and the host ops around them, with `annotate` spans:

    from datafusion_tpu_torch.utils.profiling import trace
    with trace("build/q1_profile") as prof:
        ctx.sql_collect(sql)
    prof.key_averages()  # per-op and per-kernel sums
"""

from __future__ import annotations

import os
from contextlib import contextmanager


@contextmanager
def trace(log_dir: str):
    """Profile a block; yields the `torch.profiler.profile` and writes
    `log_dir/trace.json` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span inside a trace (on the host timeline)."""
    from torch.profiler import record_function

    return record_function(name)
