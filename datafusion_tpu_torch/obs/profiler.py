"""Host-side wall-clock sampling profiler (stdlib only).

The counterpart of the JAX package's `obs/profiler.py`.  The phase bar
says *that* a query burns its wall in ``decode``; this module says
*where in host code*: a timer thread samples every thread's Python stack
via ``sys._current_frames()`` and folds the samples into collapsed
stacks, attributed to the engine phase (decode/h2d/compile/execute/d2h)
the sampled thread was inside and to the query (trace id) it was
serving.  Rendered three ways:

- **collapsed-stack text** (``ProfileReport.collapsed()``): the
  ``frame;frame;frame count`` format every flamegraph tool reads;
- **speedscope JSON** (``ProfileReport.speedscope()``): one sampled
  profile per thread, loadable at https://speedscope.app;
- **per-phase top frames** (``ProfileReport.by_phase()``): the EXPLAIN
  ANALYZE rendering: for each phase, the top self-frames by sample
  count.

Correlation: publishers write {thread_ident: stage} / {thread_ident:
trace_id} into ``utils.metrics.PROFILE_STAGES`` / ``PROFILE_TRACES``
while a capture is active: ``Metrics.timer``/``timed_iter`` publish
every stage timer scope, the copy seams (``exec/batch.to_device`` /
``to_host``) publish ``h2d.dispatch`` / ``d2h.wait``,
``utils/retry.device_call`` publishes ``device.dispatch``, and
``obs/trace.adopt``/``session`` publish the thread's trace.  The stage
-> phase mapping is ``obs/device.py``'s ``_PHASE_TIMERS``, so the
profile's phases are exactly the phase bar's.

Cost model: everything on the sampled threads is lock-free dict ops
behind one module-global None check (zero when off).  The sampler
thread itself does no blocking IO and takes no locks: ``_sample_once``
is frame walking and dict folds only; output rendering happens on the
caller's thread at report time.

Modes:

Captures are scoped (``with profile() as cap: ...; cap.report()``):
EXPLAIN ANALYZE runs under one (``DATAFUSION_TPU_PROFILE_EXPLAIN=0``
opts out), and ``capture_seconds`` samples for a fixed time.  The
sampler thread exists only while a capture is active: by default there
is none.  The debug plane's ``/debug/profile`` and bundles capture on
demand (obs/httpd.py).  Continuous mode, as in the JAX package:
``DATAFUSION_TPU_PROFILE_HZ`` > 0 starts one process-lifetime capture
at import (``maybe_start_continuous``); its rolling report
(``continuous_report``) rides in every slow or failed query's flight
artifact as ``profile`` (obs/recorder.py) and in every debug bundle as
``profile_continuous`` (obs/httpd.py).  Unset or 0, the default, starts
no thread.

A capture samples at ``_CAPTURE_HZ`` (97 — a prime, so periodic engine
work can't alias the sampler) unless it is given a rate, keeps at most
``_MAX_STACKS`` distinct stacks (overflow folds into a ``(truncated)``
bucket) and at most ``_MAX_DEPTH`` frames per stack.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.utils import metrics as _metrics
from datafusion_tpu_torch.utils.metrics import METRICS

_HZ = float(os.environ.get("DATAFUSION_TPU_PROFILE_HZ", "0") or 0)
_CAPTURE_HZ = 97.0
_MAX_STACKS = 8192
_MAX_DEPTH = 64

# phases rendered in bar order (mirrors obs/device.PHASE_ORDER without
# importing it here — profiler stays a leaf module, see _stage_phase)
_TRUNCATED = "(truncated)"


def capture_hz() -> float:
    """The scoped-capture default rate (EXPLAIN ANALYZE,
    /debug/profile): the continuous rate when one is configured, else
    ``_CAPTURE_HZ``."""
    return _HZ if _HZ > 0 else _CAPTURE_HZ


def configure(capture_hz: Optional[float] = None,
              max_stacks: Optional[int] = None) -> None:
    """Test/embedding override of the capture rate and the stack cap."""
    global _CAPTURE_HZ, _MAX_STACKS
    if capture_hz is not None:
        _CAPTURE_HZ = float(capture_hz)
    if max_stacks is not None:
        _MAX_STACKS = int(max_stacks)


_STAGE_PHASE: Optional[dict] = None


def _stage_phase() -> dict:
    """stage-timer name -> phase, inverted from obs/device.py's
    ``_PHASE_TIMERS`` (imported lazily: the profiler must stay a leaf
    module — obs/trace imports nothing from it, but obs/device imports
    obs/trace, and a module-level import here would cycle through the
    package __init__)."""
    global _STAGE_PHASE
    if _STAGE_PHASE is None:
        from datafusion_tpu_torch.obs.device import _PHASE_TIMERS

        _STAGE_PHASE = {
            t: phase for phase, timers in _PHASE_TIMERS.items()
            for t in timers
        }
    return _STAGE_PHASE


def _frame_label(code) -> str:
    """Stable frame label: ``func (pkg/module.py:firstline)``.  The
    function's FIRST line, not the sampled line — per-line labels would
    explode one function into dozens of barely-distinct stacks."""
    fname = code.co_filename.replace(os.sep, "/")
    parts = fname.rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else fname
    return f"{code.co_name} ({short}:{code.co_firstlineno})"


def _walk_stack(frame) -> tuple:
    """Root-first tuple of frame labels, bounded by _MAX_DEPTH (the
    DEEPEST frames win a truncation — the leaf is what attributes
    cost)."""
    labels = []
    f = frame
    while f is not None and len(labels) < _MAX_DEPTH * 2:
        labels.append(_frame_label(f.f_code))
        f = f.f_back
    if len(labels) > _MAX_DEPTH:
        labels = labels[:_MAX_DEPTH]
    labels.reverse()
    return tuple(labels)


class ProfileCapture:
    """One capture window's accumulating state.  ``_fold`` is called by
    the sampler thread ONLY (single writer — plain dict ops, no locks);
    readers snapshot via ``report()``, which tolerates a concurrent
    fold (dict iteration over a copied items list)."""

    __slots__ = ("hz", "stacks", "samples", "trace_counts", "truncated",
                 "started", "stopped", "name")

    def __init__(self, hz: float, name: str = "capture"):
        self.hz = hz
        self.name = name
        # {(tid, phase, frames-tuple): count}
        self.stacks: dict = {}
        self.samples = 0
        self.trace_counts: dict = {}
        self.truncated = 0
        self.started = time.monotonic()
        self.stopped: Optional[float] = None

    # sampler-thread only (lock-free)
    def _fold(self, tid: int, phase: str, frames: tuple,
              trace_id: Optional[str]) -> None:
        key = (tid, phase, frames)
        cur = self.stacks.get(key)
        if cur is None and len(self.stacks) >= _MAX_STACKS:
            key = (tid, phase, (_TRUNCATED,))
            cur = self.stacks.get(key)
            self.truncated += 1
        self.stacks[key] = (cur or 0) + 1
        self.samples += 1
        if trace_id is not None:
            self.trace_counts[trace_id] = \
                self.trace_counts.get(trace_id, 0) + 1

    def duration_s(self) -> float:
        return (self.stopped or time.monotonic()) - self.started

    def report(self) -> "ProfileReport":
        """Snapshot this capture into an immutable report (callable
        mid-capture)."""
        names = {}
        for t in threading.enumerate():
            names[t.ident] = t.name
        return ProfileReport(
            dict(self.stacks), self.samples, dict(self.trace_counts),
            self.truncated, self.duration_s(), self.hz, names, self.name,
        )


class ProfileReport:
    """An immutable profile snapshot with the three renderings (see
    module doc)."""

    def __init__(self, stacks: dict, samples: int, trace_counts: dict,
                 truncated: int, duration_s: float, hz: float,
                 thread_names: Optional[dict] = None,
                 name: str = "profile"):
        self.stacks = stacks
        self.samples = samples
        self.trace_counts = trace_counts
        self.truncated = truncated
        self.duration_s = duration_s
        self.hz = hz
        self.thread_names = thread_names or {}
        self.name = name

    def _thread_label(self, tid: int) -> str:
        n = self.thread_names.get(tid)
        return f"{n} ({tid})" if n else f"thread-{tid}"

    # -- per-phase attribution (the EXPLAIN ANALYZE rendering) --------
    def phase_samples(self) -> dict:
        """{phase: sample count}, every observed phase."""
        out: dict = {}
        for (_tid, phase, _frames), n in self.stacks.items():
            out[phase] = out.get(phase, 0) + n
        return out

    def top_frames(self, n: int = 3, phase: Optional[str] = None,
                   ) -> list[tuple[str, int]]:
        """Top SELF frames (leaf of each sampled stack) by sample
        count, optionally restricted to one phase — self time is what
        names the guilty function."""
        counts: dict = {}
        for (_tid, ph, frames), c in self.stacks.items():
            if phase is not None and ph != phase:
                continue
            if not frames:
                continue
            leaf = frames[-1]
            counts[leaf] = counts.get(leaf, 0) + c
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    def by_phase(self, top_n: int = 3) -> dict:
        """{phase: {"samples": n, "top_frames": [[label, count], ...]}}
        for every phase that captured at least one sample, ordered by
        sample count."""
        out: dict = {}
        for phase, n in sorted(self.phase_samples().items(),
                               key=lambda kv: -kv[1]):
            out[phase] = {
                "samples": n,
                "top_frames": [
                    [label, c] for label, c in self.top_frames(top_n, phase)
                ],
            }
        return out

    # -- collapsed stacks ---------------------------------------------
    def collapsed(self, phase: Optional[str] = None,
                  threads: bool = True) -> str:
        """Flamegraph collapsed format, one ``a;b;c count`` line per
        distinct stack (root first), optionally prefixed with the
        thread label as the root frame."""
        merged: dict = {}
        for (tid, ph, frames), c in sorted(
                self.stacks.items(), key=lambda kv: str(kv[0])):
            if phase is not None and ph != phase:
                continue
            prefix = (self._thread_label(tid),) if threads else ()
            key = ";".join(prefix + frames)
            merged[key] = merged.get(key, 0) + c
        return "\n".join(f"{k} {v}" for k, v in merged.items())

    # -- speedscope ---------------------------------------------------
    def speedscope(self) -> dict:
        """The speedscope file format (sampled profiles, one per
        thread; weights are sample counts).  Round-trips: the frames
        table plus samples/weights reconstruct `stacks` exactly up to
        thread naming."""
        frame_index: dict = {}
        frames_table: list[dict] = []

        def idx(label: str) -> int:
            i = frame_index.get(label)
            if i is None:
                i = frame_index[label] = len(frames_table)
                frames_table.append({"name": label})
            return i

        by_thread: dict = {}
        for (tid, _ph, frames), c in sorted(
                self.stacks.items(), key=lambda kv: str(kv[0])):
            by_thread.setdefault(tid, []).append((frames, c))
        profiles = []
        for tid, entries in sorted(by_thread.items()):
            samples = [[idx(lbl) for lbl in frames]
                       for frames, _c in entries]
            weights = [c for _frames, c in entries]
            profiles.append({
                "type": "sampled",
                "name": self._thread_label(tid),
                "unit": "none",
                "startValue": 0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "exporter": "datafusion-tpu",
            "name": self.name,
            "activeProfileIndex": 0 if profiles else None,
            "shared": {"frames": frames_table},
            "profiles": profiles,
        }

    # -- artifact form ------------------------------------------------
    def to_json(self, top_n: int = 5, max_lines: int = 500) -> dict:
        """The JSON block of a report: headline numbers, the
        per-phase attribution, and the collapsed text (bounded —
        artifacts must stay readable)."""
        lines = self.collapsed().splitlines()
        return {
            "samples": self.samples,
            "duration_s": round(self.duration_s, 3),
            "hz": self.hz,
            "truncated_stacks": self.truncated,
            "phases": self.by_phase(top_n),
            "traces": dict(sorted(self.trace_counts.items(),
                                  key=lambda kv: -kv[1])[:20]),
            "collapsed": "\n".join(lines[:max_lines]),
            "collapsed_dropped_lines": max(len(lines) - max_lines, 0),
        }

    def summary(self) -> str:
        return (f"{self.samples} samples @ {self.hz:g}Hz over "
                f"{self.duration_s:.2f}s, "
                f"{len(self.phase_samples())} phase(s)")


class SamplingProfiler:
    """The sampler: one daemon thread while >= 1 capture is active,
    zero threads otherwise.  Captures register/unregister via an
    atomically-swapped tuple, so ``_sample_once`` never takes a lock;
    registration itself is serialized by a plain lock on the CALLER's
    side only (start/stop are cold paths)."""

    def __init__(self):
        self._captures: tuple = ()
        self._thread: Optional[threading.Thread] = None
        # one Event per sampler-thread GENERATION (created at spawn,
        # handed to the thread): a stale generation can never miss its
        # stop or be un-stopped by a later start's clear()
        self._stop = threading.Event()
        # start/stop only: the SAMPLE path never touches it
        self._admin = lockcheck.make_lock("obs.profiler_admin")
        self._interval = 1.0

    # -- capture lifecycle (cold path) --------------------------------
    def start_capture(self, hz: Optional[float] = None,
                      name: str = "capture") -> ProfileCapture:
        hz = float(hz) if hz else capture_hz()
        hz = max(min(hz, 1000.0), 0.1)
        cap = ProfileCapture(hz, name)
        with self._admin:
            self._captures = (*self._captures, cap)
            self._interval = 1.0 / max(c.hz for c in self._captures)
            if self._thread is None:
                _metrics.set_profile_tables({}, {})
                self._stop = stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._run, args=(stop,),
                    name="df-torch-profiler", daemon=True,
                )
                self._thread.start()
        METRICS.add("profiler.captures")
        return cap

    def stop_capture(self, cap: ProfileCapture) -> ProfileReport:
        with self._admin:
            cap.stopped = time.monotonic()
            self._captures = tuple(
                c for c in self._captures if c is not cap
            )
            if not self._captures and self._thread is not None:
                # teardown happens UNDER the admin lock: a concurrent
                # start_capture serializes behind it, so the dying
                # sampler can't fold into the new capture and this
                # table-clear can't wipe tables the new start just
                # installed.  Join is bounded and fast (the sampler
                # parks on its per-generation event, already set) and
                # the sampler thread never takes _admin — no deadlock.
                self._stop.set()
                t = self._thread
                self._thread = None
                t.join(timeout=5)
                _metrics.set_profile_tables(None, None)
            elif self._captures:
                self._interval = 1.0 / max(c.hz for c in self._captures)
        return cap.report()

    def running(self) -> bool:
        return self._thread is not None

    def active_captures(self) -> int:
        return len(self._captures)

    # -- the sampler thread (lock-free, no blocking IO) ---------------
    def _run(self, stop: threading.Event) -> None:
        me = threading.get_ident()
        while not stop.wait(self._interval):
            self._sample_once(me)

    def _sample_once(self, self_ident: int) -> None:
        caps = self._captures
        if not caps:
            return
        stages = _metrics.PROFILE_STAGES or {}
        traces = _metrics.PROFILE_TRACES or {}
        phase_of = _stage_phase()
        for tid, frame in sys._current_frames().items():
            if tid == self_ident:
                continue
            frames = _walk_stack(frame)
            stage = stages.get(tid)
            phase = phase_of.get(stage, "other") if stage else "other"
            trace_id = traces.get(tid)
            for cap in caps:
                cap._fold(tid, phase, frames, trace_id)
        METRICS.add("profiler.samples")


PROFILER = SamplingProfiler()

# the continuous (process-lifetime) capture, when DATAFUSION_TPU_PROFILE_HZ
# is set: its rolling report attaches to slow-query flight artifacts
# and debug bundles
_continuous: Optional[ProfileCapture] = None


def continuous_running() -> bool:
    return _continuous is not None


def continuous_report() -> Optional[ProfileReport]:
    """Rolling snapshot of the continuous capture (None when off)."""
    return None if _continuous is None else _continuous.report()


def maybe_start_continuous() -> bool:
    """Start the env-configured continuous profiler (idempotent; False
    when ``DATAFUSION_TPU_PROFILE_HZ`` is unset or 0, the default, which
    creates no thread)."""
    global _continuous
    if _HZ <= 0 or _continuous is not None:
        return _continuous is not None
    _continuous = PROFILER.start_capture(_HZ, name="continuous")
    return True


def stop_continuous() -> Optional[ProfileReport]:
    global _continuous
    if _continuous is None:
        return None
    cap, _continuous = _continuous, None
    return PROFILER.stop_capture(cap)


class profile:
    """``with profile() as cap: ...`` — scoped capture; read
    ``cap.report()`` after the block (EXPLAIN ANALYZE).  ``hz=0``/``enabled=False`` degrades to
    a no-op scope yielding None (callers need no branching)."""

    __slots__ = ("_hz", "_name", "_cap", "_enabled")

    def __init__(self, hz: Optional[float] = None, name: str = "capture",
                 enabled: bool = True):
        self._hz = hz
        self._name = name
        self._enabled = enabled and (hz is None or hz > 0)
        self._cap: Optional[ProfileCapture] = None

    def __enter__(self) -> Optional[ProfileCapture]:
        if not self._enabled:
            return None
        self._cap = PROFILER.start_capture(self._hz, self._name)
        return self._cap

    def __exit__(self, *exc_info):
        if self._cap is not None:
            PROFILER.stop_capture(self._cap)
        return False


def capture_seconds(seconds: float, hz: Optional[float] = None,
                    name: str = "on-demand") -> ProfileReport:
    """Block for ``seconds`` while sampling every thread, and return the
    report.  The wait happens on the caller's thread: the sampler thread
    never sleeps beyond its tick."""
    cap = PROFILER.start_capture(hz, name)
    try:
        time.sleep(max(float(seconds), 0.0))
    finally:
        report = PROFILER.stop_capture(cap)
    return report


maybe_start_continuous()
