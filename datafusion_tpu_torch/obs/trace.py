"""Hierarchical span tracing (the Dapper model, sized for one engine).

The counterpart of the JAX package's `obs/trace.py`.  A *span* is a
named, timed interval with attributes; spans nest via a contextvar, so
`with span("a"): with span("b"): ...` records b with a as its parent.
A *trace* groups every span of one query under a shared `trace_id`.
`TraceContext.to_wire` / `wire_context` give the dict a request would
carry to another process, `adopt` makes such a dict this thread's
trace, and `ingest` folds spans another process returned into the local
buffer; all of them stamp the shared wall clock (`time.time_ns`).

Cost model: when disabled, `span(name)` returns a process-wide no-op
singleton: one module-flag read, zero allocations; instrumentation that
wants to pass attributes guards with `enabled()` first.  When enabled,
finished spans append to a lock-protected buffer bounded at `_MAX_SPANS`
(100000; drops count in the `obs.spans_dropped` counter of
`utils/metrics.METRICS`).

The JAX package's `jax.monitoring` compile listener has no counterpart
here: the port compiles its kernels once, with nvcc on first use, and
`exec/cuda.load` times that build into the `compile.nvcc` timer and the
ambient operator's `compile_s` (`obs/stats.record_compile`).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.utils import metrics as _metrics
from datafusion_tpu_torch.utils.metrics import METRICS


def _publish_thread_trace(trace_id: Optional[str]):
    """Project this thread's trace id into the sampling profiler's
    cross-thread table (utils/metrics.PROFILE_TRACES).  Returns a
    restore token; one module-global read and a None check when no
    capture runs."""
    tbl = _metrics.PROFILE_TRACES
    if tbl is None:
        return None
    tid = threading.get_ident()
    prev = tbl.get(tid)
    if trace_id is None:
        tbl.pop(tid, None)
    else:
        tbl[tid] = trace_id
    return (tbl, tid, prev)


def _restore_thread_trace(token) -> None:
    if token is None:
        return
    tbl, tid, prev = token
    if prev is None:
        tbl.pop(tid, None)
    else:
        tbl[tid] = prev


_TRUTHY = ("1", "true", "on", "yes")
_ENABLED = os.environ.get("DATAFUSION_TPU_TRACE", "").lower() in _TRUTHY
_SESSION_DEPTH = 0  # active trace sessions (EXPLAIN ANALYZE runs)
_MAX_SPANS = 100000
_ROLE = "main"  # a span's `proc` is "<role>:<pid>" (`set_process_role`)

_lock = lockcheck.make_lock("obs.trace_buffer")
_spans: list["Span"] = []


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One query's trace identity: the shared `trace_id` plus the span
    id that children created from this context parent under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: Optional[str] = None,
                 span_id: Optional[str] = None):
        self.trace_id = trace_id or _new_id()
        self.span_id = span_id

    def to_wire(self) -> dict:
        """The dict a request carries to another process."""
        return {"trace_id": self.trace_id, "parent_span_id": self.span_id}

    @staticmethod
    def from_wire(obj: Optional[dict]) -> Optional["TraceContext"]:
        if not isinstance(obj, dict) or not obj.get("trace_id"):
            return None
        return TraceContext(str(obj["trace_id"]), obj.get("parent_span_id") or None)

    def __repr__(self):
        return f"TraceContext({self.trace_id}, parent={self.span_id})"


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "attrs", "tid", "proc")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attrs = attrs or {}
        self.tid = threading.get_ident()
        self.proc = f"{_ROLE}:{os.getpid()}"

    @property
    def duration_s(self) -> float:
        return max(self.end_ns - self.start_ns, 0) / 1e9

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "attrs": self.attrs,
            "tid": self.tid,
            "proc": self.proc,
        }

    @staticmethod
    def from_json(obj: dict) -> "Span":
        sp = Span.__new__(Span)
        sp.name = obj["name"]
        sp.trace_id = obj["trace_id"]
        sp.span_id = obj["span_id"]
        sp.parent_id = obj.get("parent_id")
        sp.start_ns = int(obj["start_ns"])
        sp.end_ns = int(obj["end_ns"])
        sp.attrs = obj.get("attrs") or {}
        sp.tid = obj.get("tid", 0)
        sp.proc = obj.get("proc", "?")
        return sp

    def __repr__(self):
        return f"Span({self.name}, {self.duration_s * 1e3:.3f}ms)"


_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "datafusion_tpu_torch_span", default=None
)
_current_trace: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("datafusion_tpu_torch_trace", default=None)
)
# process-default trace for spans recorded outside any session or
# adoption (DATAFUSION_TPU_TRACE=1 with plain queries)
_ambient_trace: Optional[TraceContext] = None


def enabled() -> bool:
    """Collection is on when the engine-wide flag is set, a trace
    session (EXPLAIN ANALYZE) is active, or THIS thread carries an
    adopted trace context (contextvar-scoped, so untraced work on other
    threads stays dark)."""
    return _ENABLED or _SESSION_DEPTH > 0 or _current_trace.get() is not None


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def set_process_role(role: str) -> None:
    """Tag this process's spans and flight dumps (workers pass
    "worker"); mirrors `testing.faults.set_role`."""
    global _ROLE
    _ROLE = role


def current_trace(create: bool = False) -> Optional[TraceContext]:
    tc = _current_trace.get()
    if tc is None and create:
        global _ambient_trace
        with _lock:  # two threads must not mint two ambient traces
            if _ambient_trace is None:
                _ambient_trace = TraceContext()
            tc = _ambient_trace
    return tc


def current_span() -> Optional[Span]:
    return _current_span.get()


def wire_context() -> Optional[dict]:
    """The propagation dict for an outgoing request: the current trace
    id plus the current span as the remote parent.  None when tracing
    is disabled."""
    if not enabled():
        return None
    tc = current_trace(create=True)
    sp = _current_span.get()
    return {
        "trace_id": tc.trace_id,
        "parent_span_id": sp.span_id if sp is not None else tc.span_id,
    }


def begin_span(name: str, parent: Optional[Span] = None,
               attrs: Optional[dict] = None,
               trace_id: Optional[str] = None) -> Optional[Span]:
    """Start a span WITHOUT making it the contextvar current (for spans
    whose lifetime crosses generator resumes or threads; pair with
    `finish_span`).  Returns None when disabled.  Code on another
    thread passes `parent` and/or `trace_id`: contextvars do not cross
    threads."""
    if not enabled():
        return None
    if parent is None:
        parent = _current_span.get()
    if trace_id is None:
        trace_id = getattr(parent, "trace_id", None)
    parent_id = parent.span_id if parent is not None else None
    if trace_id is None:
        tc = current_trace(create=True)
        trace_id = tc.trace_id
        if parent_id is None:
            parent_id = tc.span_id
    return Span(name, trace_id, parent_id, attrs)


def finish_span(sp: Optional[Span]) -> None:
    if sp is None:
        return
    sp.end_ns = time.time_ns()
    _record(sp)


def _record(sp: Span) -> None:
    with _lock:
        _spans.append(sp)
        dropped = len(_spans) > _MAX_SPANS
        if dropped:
            # drop the OLDEST: a long-lived traced process whose spans
            # are never drained must not wedge the buffer
            del _spans[0]
    if dropped:
        METRICS.add("obs.spans_dropped")
    METRICS.add("obs.spans")


class _NoopSpan:
    """Singleton no-op context manager: the disabled hot path allocates
    nothing (`span("x") is span("y")`)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc_info):
        return False


_NOOP = _NoopSpan()


class _SpanScope:
    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, attrs: Optional[dict]):
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        sp = begin_span(self._name, attrs=self._attrs)
        if sp is None:  # disabled between construction and entry
            sp = Span(self._name, "disabled", None, self._attrs)
        self._span = sp
        self._token = _current_span.set(sp)
        return sp

    def __exit__(self, *exc_info):
        _current_span.reset(self._token)
        if self._span.trace_id != "disabled":
            finish_span(self._span)
        return False


def span(name: str, **attrs: Any):
    """`with span("stage", key=value): ...` records a nested span.  When
    tracing is disabled this returns the shared no-op singleton."""
    if not enabled():
        return _NOOP
    return _SpanScope(name, attrs or None)


def buffered() -> int:
    """Finished spans buffered now (the worker's
    `obs.span_buffer_depth` gauge)."""
    with _lock:
        return len(_spans)


def spans(trace_id: Optional[str] = None) -> list[dict]:
    """Snapshot of buffered spans (of one trace when given)."""
    with _lock:
        out = list(_spans)
    if trace_id is not None:
        out = [s for s in out if s.trace_id == trace_id]
    return [s.to_json() for s in out]


def drain(trace_id: Optional[str] = None) -> list[dict]:
    """Remove and return buffered spans (one trace, or everything)."""
    global _spans
    with _lock:
        if trace_id is None:
            out, _spans = _spans, []
        else:
            out = [s for s in _spans if s.trace_id == trace_id]
            _spans = [s for s in _spans if s.trace_id != trace_id]
    return [s.to_json() for s in out]


def ingest(span_dicts) -> int:
    """Fold spans produced elsewhere (another process's `drain`) into
    the local buffer; returns how many were accepted."""
    if not span_dicts:
        return 0
    n = 0
    for obj in span_dicts:
        try:
            sp = Span.from_json(obj)
        except (KeyError, TypeError, ValueError):
            METRICS.add("obs.spans_rejected")
            continue
        _record(sp)
        n += 1
    return n


class adopt:
    """`with adopt(wire):` makes a request's trace this thread's (spans
    record and parent under the remote span) and turns collection on
    for exactly this thread's work.  A None or invalid dict is a
    no-op."""

    __slots__ = ("_tc", "_tok_trace", "_tok_span", "_active", "_tok_pub")

    def __init__(self, wire: Optional[dict]):
        self._tc = TraceContext.from_wire(wire)
        self._active = False

    def __enter__(self) -> Optional[TraceContext]:
        if self._tc is None:
            return None
        self._active = True
        self._tok_pub = _publish_thread_trace(self._tc.trace_id)
        self._tok_trace = _current_trace.set(self._tc)
        # a never-recorded parent handle, so children chain to the
        # remote span
        parent = None
        if self._tc.span_id:
            parent = Span.__new__(Span)
            parent.span_id = self._tc.span_id
            parent.trace_id = self._tc.trace_id
        self._tok_span = _current_span.set(parent)
        return self._tc

    def __exit__(self, *exc_info):
        if self._active:
            _current_span.reset(self._tok_span)
            _current_trace.reset(self._tok_trace)
            _restore_thread_trace(self._tok_pub)
            self._active = False
        return False

    @property
    def trace_id(self) -> Optional[str]:
        return None if self._tc is None else self._tc.trace_id


@contextmanager
def session():
    """Enable tracing for a block under a fresh TraceContext (the
    EXPLAIN ANALYZE entry).  Session-active state is a depth counter,
    so one session ending cannot disable another still running on a
    sibling thread; the session's trace also becomes the process-ambient
    fallback, so spans opened on helper threads (the prefetch threads)
    join it.  Spans stay buffered for `drain(tc.trace_id)` after exit."""
    global _SESSION_DEPTH, _ambient_trace
    tc = TraceContext()
    token = _current_trace.set(tc)
    pub = _publish_thread_trace(tc.trace_id)
    with _lock:
        _SESSION_DEPTH += 1
        prev_ambient = _ambient_trace
        _ambient_trace = tc
    try:
        yield tc
    finally:
        with _lock:
            _SESSION_DEPTH -= 1
            if _ambient_trace is tc:
                _ambient_trace = prev_ambient
        _current_trace.reset(token)
        _restore_thread_trace(pub)


# -- background trace flusher ------------------------------------------
# With DATAFUSION_TPU_TRACE_FILE and DATAFUSION_TPU_TRACE_FLUSH_S (> 0)
# set, a daemon thread drains finished spans every interval and APPENDS
# them to the file as JSON lines (one span dict a line; chrome_trace()
# takes the list).  With the file alone, an atexit hook writes one
# Chrome-trace document.
_flush_stop = threading.Event()
_flush_thread: Optional[threading.Thread] = None
# once the flusher has run, the file is JSON lines: the atexit dump
# appends the tail instead of truncating it
_flush_path: Optional[str] = None


def _flush_once(path: str) -> int:
    out = drain()
    if out:
        import json

        with open(path, "a", encoding="utf-8") as f:
            for sp in out:
                f.write(json.dumps(sp) + "\n")
    return len(out)


def start_flusher(path: Optional[str] = None,
                  interval_s: Optional[float] = None) -> bool:
    """Start (idempotently) the background span flusher.  Defaults come
    from DATAFUSION_TPU_TRACE_FILE / DATAFUSION_TPU_TRACE_FLUSH_S;
    returns False when either is missing."""
    global _flush_thread, _flush_path
    path = path or os.environ.get("DATAFUSION_TPU_TRACE_FILE")
    if interval_s is None:
        env = os.environ.get("DATAFUSION_TPU_TRACE_FLUSH_S", "")
        interval_s = float(env) if env else 0.0
    if not path or not interval_s or _flush_thread is not None:
        return _flush_thread is not None
    _flush_path = path

    def _loop():
        while not _flush_stop.wait(interval_s):
            try:
                _flush_once(path)
            except OSError:  # the flusher outlives a failed write
                METRICS.add("obs.flush_errors")

    _flush_stop.clear()
    _flush_thread = threading.Thread(target=_loop, name="df-torch-trace-flush",
                                     daemon=True)
    _flush_thread.start()
    return True


def stop_flusher(flush: bool = True) -> None:
    global _flush_thread
    if _flush_thread is None:
        return
    _flush_stop.set()
    _flush_thread.join(timeout=10)
    _flush_thread = None
    if flush and _flush_path:
        _flush_once(_flush_path)


_trace_file = os.environ.get("DATAFUSION_TPU_TRACE_FILE")
if _trace_file:
    import atexit

    def _dump_at_exit(path=_trace_file):
        try:
            if _flush_path is not None:
                _flush_once(_flush_path)
                return
            from datafusion_tpu_torch.obs.export import write_chrome_trace

            write_chrome_trace(path, spans())
        except OSError:  # an exit hook must not raise
            pass

    atexit.register(_dump_at_exit)
    start_flusher()
del _trace_file
