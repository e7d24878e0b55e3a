"""Per-operator runtime statistics.

The counterpart of the JAX package's `obs/stats.py`.  Every physical
operator (`exec/relation.Relation` and subclasses) lazily owns an
`OperatorStats`; when observability is enabled (`obs/trace.enabled()`),
consumers pull child batches through `iter_stats(child)`, which records
rows and batches out and the cumulative produce time, and, through a
contextvar, makes the producing operator *ambient*, so the copy seams
(`exec/batch.to_device`/`to_host`), the pass seam
(`utils/retry.device_call`) and the kernel build (`exec/cuda.load`)
attribute bytes, launches and compile seconds to the operator whose
`batches()` body is running.  When disabled, `iter_stats` returns the
child's iterator unchanged and `op_timer` the shared no-op: the hot path
pays one module-flag read.

Threads: the contextvar does not cross into the prefetch threads
(`exec/prefetch.py`), so bytes copied there count in `h2d.bytes` but
to no operator.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch.obs.trace import _NOOP, begin_span, enabled, finish_span

_CUR_OP: contextvars.ContextVar[Optional["OperatorStats"]] = (
    contextvars.ContextVar("datafusion_tpu_torch_cur_op", default=None)
)


class OperatorStats:
    """Counters for one physical operator in one (or more) runs.

    `time_s` is the cumulative wall spent *producing* this operator's
    output (its children's time included: the standard EXPLAIN ANALYZE
    reading); `execute_s` is the slice spent inside its own device
    passes; `compile_s` the kernel builds made while it was ambient.
    """

    __slots__ = ("rows_out", "batches_out", "time_s", "execute_s",
                 "compile_s", "h2d_bytes", "d2h_bytes", "h2d_s", "d2h_s",
                 "retries", "attrs")

    def __init__(self):
        self.rows_out = 0
        self.batches_out = 0
        self.time_s = 0.0
        self.execute_s = 0.0
        self.compile_s = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_s = 0.0
        self.d2h_s = 0.0
        self.retries = 0
        self.attrs: dict = {}

    def snapshot(self) -> dict:
        out = {
            "rows_out": self.rows_out,
            "batches_out": self.batches_out,
            "time_s": self.time_s,
            "execute_s": self.execute_s,
            "compile_s": self.compile_s,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "h2d_s": self.h2d_s,
            "d2h_s": self.d2h_s,
            "retries": self.retries,
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    def __repr__(self):
        return f"OperatorStats({self.snapshot()})"


def current_op() -> Optional[OperatorStats]:
    """The ambient operator's stats (None outside instrumented runs)."""
    return _CUR_OP.get()


def record_h2d(nbytes: int) -> None:
    st = _CUR_OP.get()
    if st is not None:
        st.h2d_bytes += nbytes


def record_d2h(nbytes: int) -> None:
    st = _CUR_OP.get()
    if st is not None:
        st.d2h_bytes += nbytes


def record_h2d_time(seconds: float) -> None:
    st = _CUR_OP.get()
    if st is not None:
        st.h2d_s += seconds


def record_d2h_time(seconds: float) -> None:
    st = _CUR_OP.get()
    if st is not None:
        st.d2h_s += seconds


def record_compile(seconds: float) -> None:
    """Attribute a kernel build (nvcc on first use) to the ambient
    operator."""
    st = _CUR_OP.get()
    if st is not None:
        st.compile_s += seconds


def record_retry() -> None:
    """Attribute one replayed device pass to the ambient operator
    (`retries` in EXPLAIN ANALYZE)."""
    st = _CUR_OP.get()
    if st is not None:
        st.retries += 1


def record_launch() -> None:
    """Attribute one device pass to the ambient operator (`launches=` in
    EXPLAIN ANALYZE: the batch-group fold is judged by this number going
    down)."""
    st = _CUR_OP.get()
    if st is not None:
        st.attrs["launches"] = st.attrs.get("launches", 0) + 1


def live_rows(batch) -> int:
    """Rows a batch contributes (mask- and padding-aware).  A mask on
    the device is summed there and read back: only instrumented runs
    call this."""
    mask = batch.mask
    if mask is None:
        return int(batch.num_rows)
    if hasattr(mask, "cpu"):  # a torch tensor
        return int(mask[: batch.num_rows].sum().item())
    return int(np.asarray(mask)[: batch.num_rows].sum())


class _ExecTimer:
    """Times a device pass into the operator's `execute_s` and makes the
    operator ambient for it."""

    __slots__ = ("_st", "_t0", "_tok")

    def __init__(self, st: OperatorStats):
        self._st = st

    def __enter__(self):
        self._tok = _CUR_OP.set(self._st)
        self._t0 = time.perf_counter()
        return self._st

    def __exit__(self, *exc_info):
        self._st.execute_s += time.perf_counter() - self._t0
        _CUR_OP.reset(self._tok)
        return False


def op_timer(relation):
    """`with op_timer(self):` around an operator's device pass; the
    shared no-op singleton (trace._NOOP) when observability is off."""
    if not enabled():
        return _NOOP
    return _ExecTimer(relation.stats)


def iter_stats(relation, it=None):
    """The instrumentation seam: wrap `relation.batches()` (or an
    explicit iterator over its output) so the relation's OperatorStats
    record rows, batches and time and the relation is ambient while its
    batches are produced.  Pass-through when disabled."""
    if not enabled():
        return relation.batches() if it is None else it
    return _instrumented(relation, relation.batches() if it is None else it)


def _instrumented(relation, it):
    st = relation.stats
    sp = begin_span(f"op.{relation.op_name()}")
    try:
        while True:
            tok = _CUR_OP.set(st)
            t0 = time.perf_counter()
            try:
                try:
                    batch = next(it)
                except StopIteration:
                    return
            finally:
                st.time_s += time.perf_counter() - t0
                _CUR_OP.reset(tok)
            st.batches_out += 1
            st.rows_out += live_rows(batch)
            yield batch
    finally:
        if sp is not None:
            sp.attrs.update(rows=st.rows_out, batches=st.batches_out)
            finish_span(sp)


def collect_tree(relation) -> list[tuple[int, object]]:
    """Flatten an operator tree into (depth, relation) pairs, root
    first (the EXPLAIN ANALYZE rendering order)."""
    out: list[tuple[int, object]] = []

    def walk(rel, depth):
        out.append((depth, rel))
        for child in rel.op_children():
            walk(child, depth + 1)

    walk(relation, 0)
    return out
