"""The device ledger: every device buffer the engine copies or builds,
the pinned residents, and the phase breakdown of a query.

The counterpart of the JAX package's `obs/device.py`.  Three
instruments:

- **Buffers.** Every host-to-device copy (`exec/batch.to_device`, the
  port's one copy seam, where the JAX package has `DeviceLedger.put`)
  and every batch group's concatenation (the fold, `exec/fused.py`)
  registers its tensors here (`adopt`), each under an owner tag
  (`batch`, `group_ids`, `aux`, `sort.keys`, `join.build`, `fold`,
  ...).  A tensor's bytes are its storage's, counted once per storage
  (`untyped_storage().data_ptr()`): views and tensors that share one
  storage (a pinned table's subset views, a megabatch's shared values)
  are one entry, which lives until the last registered tensor on it
  dies (a weak reference's callback).  Live and peak bytes over these entries
  are measured facts; `begin_peak_window` / `window_peak_bytes` give
  one query's high-water mark without moving the process peak, and the
  `device.hbm.live_bytes` / `device.hbm.peak_bytes` gauges follow them.
  `\\hbm` renders `report_text`.  Registration and release take no lock
  (dict stores and int adds), so they may run inside any critical
  section.  Each entry carries the trace id of the query that
  registered it and whether it is a cache entry (a batch's cached copy,
  ids or tables, a pin); `sweep`, run by the per-query funnel
  (obs/aggregate.query_completed), makes the completed query's
  non-cache buffers leak candidates and reports a candidate still live
  past the grace period (``DATAFUSION_TPU_LEDGER_LEAK_GRACE_S``, 5 s) at
  a later sweep: ``device.ledger.leaks`` and a ``device.leak`` flight
  event.  Every copy at the copy seams records a ``device.h2d`` or
  ``device.d2h`` flight event (bytes, wall, and GB/s where the copy was
  waited for).
- **Pins.** A pin is a named artifact owned by the ledger (a served
  table's resident batches, a join build) with its accounted bytes, an
  owner tag, a priority and an eviction hook.  `pinned(fp)` returns the
  artifact and counts a use; `evict_pins` drops pins in (priority,
  least recent use) order, where a pin's priority is the most uses it
  has seen, until the bytes asked for are freed.
- **Phases.** Per-query deltas of the stage timers split a run into
  decode -> h2d -> compile -> execute -> d2h -> other
  (`phase_breakdown`, `phase_bar`).  Inside `profile_sync()` the pass
  seam (`utils/retry.device_call`) times each pass by CUDA events and
  the copy seam waits for its copy, so "execute" and "h2d" are device
  time; outside it nothing is synchronized and the timers hold host
  time only.

``DATAFUSION_TPU_DEVICE_LEDGER=0`` turns the ledger off: nothing
registers, the copy seams record no flight event, no
``device.hbm.*`` gauge is published and there is no phase breakdown;
pins, admission and every copy work as before, on the same device.

Capacity and admission (`headroom`) keep their own definition, which
the serving front door's sheds rest on:
- capacity: `DATAFUSION_TPU_HBM_BYTES` when set, else
  `torch.cuda.mem_get_info` of the current device when CUDA is there,
  else unknown (None): on the CPU nothing sheds for memory, as in the
  JAX package;
- `live_bytes()`: the pins' accounted bytes plus
  `torch.cuda.memory_allocated()` where CUDA is initialized.  A pinned
  table's device copies count in both terms, so the headroom is
  conservative.  `buffer_bytes()` is the sum over the registered
  buffers.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import time
import weakref
from typing import Any, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs import stats as _stats
from datafusion_tpu_torch.obs.trace import _current_trace
from datafusion_tpu_torch.obs.attribution import charge_h2d, forget_pin
from datafusion_tpu_torch.utils.metrics import METRICS


_ENABLED = recorder._env_flag("DATAFUSION_TPU_DEVICE_LEDGER", True)
# a non-cache buffer live this long past its query's completion is a
# leak (two sweeps must see it: one marks, a later one reports)
_LEAK_GRACE_S = float(os.environ.get("DATAFUSION_TPU_LEDGER_LEAK_GRACE_S", "5") or 5)


def enabled() -> bool:
    return _ENABLED


def configure(enabled: Optional[bool] = None, leak_grace_s: Optional[float] = None) -> None:
    """Override the environment's ledger switch and leak grace (tests)."""
    global _ENABLED, _LEAK_GRACE_S
    if enabled is not None:
        _ENABLED = bool(enabled)
    if leak_grace_s is not None:
        _LEAK_GRACE_S = float(leak_grace_s)


# -- profiling-sync mode ----------------------------------------------
# A pass queues CUDA work and returns; the card computes while the host
# moves on, and the wall lands in whichever seam waits next (a pull).
# Synchronizing every pass would serialize the prefetch threads against
# the fold, so phase-accurate timing is opt-in: EXPLAIN ANALYZE runs its
# query under `profile_sync()`, inside which the pass seam times each
# pass by CUDA events and the copy seam waits for its copy.
# Contextvar-scoped, so one traced query never syncs a concurrent one.
_profile_sync_depth: contextvars.ContextVar[int] = contextvars.ContextVar(
    "datafusion_tpu_torch_profile_sync", default=0
)


@contextlib.contextmanager
def profile_sync():
    """Scope in which device passes and copies are timed on the device
    (see the comment above)."""
    tok = _profile_sync_depth.set(_profile_sync_depth.get() + 1)
    try:
        yield
    finally:
        _profile_sync_depth.reset(tok)


def profile_sync_active() -> bool:
    return _ENABLED and _profile_sync_depth.get() > 0


class _BufEntry:
    """One registered storage: its bytes, owner, device, a weak
    reference to each registered tensor that still holds it, and the
    leak sweep's state: the registering query's trace id, whether it is
    a cache entry, since when it is a candidate and whether it was
    reported."""

    __slots__ = ("nbytes", "owner", "device", "holders", "trace_id", "cached", "ts",
                 "candidate_since", "reported")

    def __init__(self, nbytes: int, owner: str, device: str, trace_id: Optional[str],
                 cached: bool):
        self.nbytes = nbytes
        self.owner = owner
        self.device = device
        self.holders: dict = {}
        self.trace_id = trace_id
        self.cached = cached
        self.ts = time.monotonic()
        self.candidate_since: Optional[float] = None
        self.reported = False


class _PinEntry:
    """One ledger-owned pinned resident."""

    __slots__ = ("fingerprint", "owner", "priority", "on_evict", "artifact",
                 "nbytes", "uses", "last_used")

    def __init__(self, fingerprint: str, owner: str, priority: int,
                 on_evict, artifact):
        self.fingerprint = fingerprint
        self.owner = owner
        self.priority = int(priority)
        self.on_evict = on_evict
        self.artifact = artifact
        self.nbytes = 0
        self.uses = 0
        self.last_used = time.monotonic()


def hbm_capacity_bytes() -> Optional[int]:
    """The device memory capacity admission checks against:
    DATAFUSION_TPU_HBM_BYTES, else the current CUDA device's total
    memory, else None (unknown)."""
    env = os.environ.get("DATAFUSION_TPU_HBM_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            return None
    import torch

    if not torch.cuda.is_available():
        return None
    return _device_total_bytes(torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _device_total_bytes(index: int) -> int:
    """A CUDA device's total memory (fixed: read once per device)."""
    import torch

    return int(torch.cuda.mem_get_info(index)[1])


def device_allocated_bytes() -> int:
    """Bytes the caching allocator holds in live tensors on the current
    CUDA device; 0 where CUDA is not initialized (the CPU tests)."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


# owners whose buffers live one query: a batch group's concatenation
TRANSIENT_OWNERS = frozenset({"fold"})


class DeviceLedger:
    """Process-wide registry of device buffers and pinned residents."""

    def __init__(self):
        self._lock = lockcheck.make_lock("obs.device_pins")
        self._pins: dict[str, _PinEntry] = {}
        # (device, storage pointer) -> entry; mutated without a lock
        self._bufs: dict[tuple, _BufEntry] = {}
        self._tokens = itertools.count()
        # bound here, not looked up at release: a weak-reference callback
        # may run while the interpreter tears module globals down
        self._gauge = METRICS.gauge
        self._live = 0  # running sum; exact on buffer_bytes()
        self._peak = 0
        self._window_peak: Optional[int] = None
        self.leaks_reported = 0

    # -- buffers -------------------------------------------------------
    def adopt(self, value: Any, owner: str = "anon", cached: bool = True) -> Any:
        """Register every tensor of `value` (a tensor, or a tuple or list
        nesting tensors and None) under `owner`; returns `value`.
        Buffers that should die with their query (`cached=False`, and
        every owner in `TRANSIENT_OWNERS`) are the only ones the leak
        sweep flags."""
        if not _ENABLED:
            return value
        self._adopt(value, owner, cached and owner not in TRANSIENT_OWNERS)
        return value

    def _adopt(self, value: Any, owner: str, cached: bool) -> None:
        if isinstance(value, (tuple, list)):
            for v in value:
                self._adopt(v, owner, cached)
        elif value is not None:
            self._register(value, owner, cached)

    def retag(self, value: Any, owner: str, cached: bool = True) -> None:
        """Re-attribute the registered storages of `value` to `owner`
        (and mark them cache entries unless `cached` is False)."""
        if isinstance(value, (tuple, list)):
            for v in value:
                self.retag(v, owner, cached)
            return
        e = self._bufs.get(_buf_key(value)) if value is not None else None
        if e is not None:
            e.owner = owner
            e.cached = cached
            e.candidate_since = None

    def _register(self, t, owner: str, cached: bool) -> None:
        st = t.untyped_storage()
        nbytes = st.nbytes()
        if nbytes == 0:
            return
        key = (t.device, st.data_ptr())
        e = self._bufs.get(key)
        if e is None:
            tc = _current_trace.get()
            e = self._bufs[key] = _BufEntry(nbytes, owner, str(key[0]),
                                            None if tc is None else tc.trace_id, cached)
            live = self._live = self._live + nbytes
            if live > self._peak:
                self._peak = live
            wp = self._window_peak
            if wp is not None and live > wp:
                self._window_peak = live
            METRICS.gauge("device.hbm.live_bytes", live)
            METRICS.gauge("device.hbm.peak_bytes", self._peak)
        else:
            # the latest registration names the owner, and a buffer just
            # shown in use is no leak candidate
            e.owner = owner
            e.cached = cached
            e.candidate_since = None
        token = next(self._tokens)
        # the entry keeps the weak reference (and with it the callback)
        # alive; dict stores and pops are atomic: no lock
        e.holders[token] = weakref.ref(t, functools.partial(self._release, key, e, token))

    def _release(self, key: tuple, e: _BufEntry, token: int, _ref=None) -> None:
        # a weak-reference callback: runs at any refcount drop, so it
        # takes no lock and never raises
        e.holders.pop(token, None)
        if e.holders or self._bufs.get(key) is not e:
            return
        if self._bufs.pop(key, None) is e:
            self._live -= e.nbytes
            self._gauge("device.hbm.live_bytes", self._live)

    def buffer_bytes(self) -> int:
        """Exact sum over the registered storages (also corrects the
        running sum the lock-free writers may have drifted)."""
        exact = sum(e.nbytes for e in list(self._bufs.values()))
        self._live = exact
        if exact > self._peak:
            self._peak = exact
        wp = self._window_peak
        if wp is not None and exact > wp:
            self._window_peak = exact
        if _ENABLED:  # a ledger that measures nothing publishes nothing
            METRICS.gauge("device.hbm.live_bytes", exact)
            METRICS.gauge("device.hbm.peak_bytes", self._peak)
        return exact

    def peak_bytes(self) -> int:
        return self._peak

    def reset_peak(self) -> int:
        """Re-arm the process-wide watermark at the live level now.
        Scrapes then lose the true high-water mark: a per-run
        measurement uses `begin_peak_window`."""
        self._peak = self.live_bytes()
        self._gauge("device.hbm.peak_bytes", self._peak)
        return self._peak

    def clear(self) -> None:
        """Drop every tracked buffer (tests).  The finalizers of
        buffers still alive later release entries that no longer
        exist, which `_release` tolerates."""
        self._bufs.clear()
        self._live = 0
        self._peak = 0

    def begin_peak_window(self) -> int:
        """Start a per-run watermark (EXPLAIN ANALYZE): `window_peak_bytes`
        then reports the high-water mark since this call, leaving the
        process peak alone.  One window at a time."""
        self._window_peak = self.buffer_bytes()
        return self._window_peak

    def window_peak_bytes(self) -> int:
        """High-water mark since `begin_peak_window` (the process peak if
        no window was begun)."""
        wp = self._window_peak
        return self._peak if wp is None else wp

    @property
    def entries(self) -> int:
        return len(self._bufs)

    def owners(self) -> dict[str, dict]:
        """Per-owner residency: {owner: {bytes, buffers}}."""
        out: dict[str, dict] = {}
        for e in list(self._bufs.values()):
            d = out.setdefault(e.owner, {"bytes": 0, "buffers": 0})
            d["bytes"] += e.nbytes
            d["buffers"] += 1
        return out

    def devices(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in list(self._bufs.values()):
            out[e.device] = out.get(e.device, 0) + e.nbytes
        return out

    # -- leak detection ------------------------------------------------
    def sweep(self, trace_id: Optional[str] = None, grace_s: Optional[float] = None) -> int:
        """At a root query's completion: non-cache buffers of the
        completed query (or of no query) become leak candidates, and
        candidates of an earlier sweep still live past the grace period
        report as leaks (``device.ledger.leaks``, a ``device.leak``
        flight event), each once.  Returns the leaks newly reported.
        With tracing off every buffer is trace-less, so a concurrent
        query's buffer held past the grace can be flagged; tracing
        scopes buffers to their query."""
        if not _ENABLED:
            return 0
        grace = _LEAK_GRACE_S if grace_s is None else grace_s
        now = time.monotonic()
        leaks = 0
        for e in list(self._bufs.values()):
            if e.cached or e.reported:
                continue
            if e.candidate_since is None:
                if e.trace_id is None or e.trace_id == trace_id:
                    e.candidate_since = now
                continue
            if now - e.candidate_since >= grace:
                e.reported = True
                leaks += 1
                self.leaks_reported += 1
                METRICS.add("device.ledger.leaks")
                recorder.record("device.leak", owner=e.owner, bytes=e.nbytes,
                                device=e.device, age_s=round(now - e.ts, 3),
                                trace_id_put=e.trace_id)
        return leaks

    def snapshot(self) -> dict:
        return {
            "live_bytes": self.buffer_bytes(),
            "peak_bytes": self._peak,
            "buffers": len(self._bufs),
            "leaks_reported": self.leaks_reported,
            "owners": self.owners(),
            "devices": self.devices(),
            "pinned_bytes": self.pinned_bytes(),
            "pins": self.pins_snapshot(),
        }

    def report_text(self) -> str:
        """The console's `\\hbm` view."""
        snap = self.snapshot()
        lines = [
            f"Device ledger: {snap['buffers']} buffer(s), "
            f"live {_fmt_bytes(snap['live_bytes'])}, "
            f"peak {_fmt_bytes(snap['peak_bytes'])}"
            + ("" if _ENABLED else "  [DISABLED]")
        ]
        for dev, nbytes in sorted(snap["devices"].items()):
            lines.append(f"  device {dev}: {_fmt_bytes(nbytes)}")
        for owner, d in sorted(snap["owners"].items(), key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"  owner {owner}: {_fmt_bytes(d['bytes'])} "
                         f"in {d['buffers']} buffer(s)")
        for fp, p in sorted(snap["pins"].items(), key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"  pinned {fp}: {_fmt_bytes(p['bytes'])} "
                         f"(owner {p['owner']}, uses {p['uses']})")
        if snap["leaks_reported"]:
            lines.append(f"  leaks reported: {snap['leaks_reported']}")
        return "\n".join(lines)

    # -- pins ----------------------------------------------------------

    def pin(self, fingerprint: str, nbytes: int = 0, owner: str = "pin",
            priority: int = 0, on_evict=None, artifact: Any = None) -> None:
        """Register (or refresh) a pinned resident under `fingerprint`.
        Re-pinning keeps the entry's use count and updates its
        artifact, hook and bytes."""
        with self._lock:
            e = self._pins.get(fingerprint)
            if e is None:
                e = self._pins[fingerprint] = _PinEntry(
                    fingerprint, owner, priority, on_evict, artifact)
                METRICS.add("device.pins")
                recorder.record("device.pin", fingerprint=fingerprint, owner=owner,
                                bytes=int(nbytes))
            else:
                e.owner = owner
                e.on_evict = on_evict if on_evict is not None else e.on_evict
                e.artifact = artifact if artifact is not None else e.artifact
            e.nbytes = int(nbytes)
            e.priority = max(e.priority, int(priority))

    def pinned(self, fingerprint: str):
        """The artifact pinned under `fingerprint`, or None.  Counts a
        use: use count and recency order eviction."""
        with self._lock:
            e = self._pins.get(fingerprint)
            if e is None:
                return None
            e.uses += 1
            e.priority = max(e.priority, e.uses)
            e.last_used = time.monotonic()
            return e.artifact

    def unpin(self, fingerprint: str, reason: str = "unpin", artifact: Any = None) -> bool:
        """Drop one pin, calling its eviction hook.  With `artifact`,
        only while the pin holds that artifact (another owner may have
        pinned the fingerprint since)."""
        with self._lock:
            e = self._pins.get(fingerprint)
            if e is None or (artifact is not None and e.artifact is not artifact):
                return False
            del self._pins[fingerprint]
        self._evict_entry(e, reason)
        return True

    def _evict_entry(self, e: _PinEntry, reason: str) -> None:
        METRICS.add("device.pin_evictions")
        recorder.record("device.pin_evict", fingerprint=e.fingerprint, owner=e.owner,
                        bytes=e.nbytes, reason=reason)
        cb = e.on_evict
        e.artifact = None
        # the pin stops accruing byte-seconds to its clients
        forget_pin(e.fingerprint)
        if cb is not None:
            cb()

    def evict_pins(self, need_bytes: int, exclude=()) -> int:
        """Free at least `need_bytes` of pinned bytes by dropping pins in
        (priority, least recent use) order, sparing the fingerprints in
        `exclude`.  Returns the accounted bytes freed."""
        victims: list[_PinEntry] = []
        skip = frozenset(exclude)
        with self._lock:
            freed = 0
            for e in sorted(self._pins.values(), key=lambda e: (e.priority, e.last_used)):
                if freed >= need_bytes:
                    break
                if e.fingerprint in skip:
                    continue
                del self._pins[e.fingerprint]
                victims.append(e)
                freed += e.nbytes
        for e in victims:
            self._evict_entry(e, "pressure")
        return sum(e.nbytes for e in victims)

    def add_pin_bytes(self, fingerprint: str, nbytes: int) -> None:
        """Grow a pin's accounted bytes (an append's batch, before its
        device copies exist to be measured: serve.py)."""
        with self._lock:
            e = self._pins.get(fingerprint)
            if e is not None:
                e.nbytes += int(nbytes)

    def set_pin_bytes(self, fingerprint: str, nbytes: int) -> None:
        """Set a pin's accounted bytes (serve.py: the measured bytes of a
        pinned table's device copies)."""
        with self._lock:
            e = self._pins.get(fingerprint)
            if e is not None:
                e.nbytes = int(nbytes)

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._pins.values())

    def pins_snapshot(self) -> dict:
        """{fingerprint: {owner, bytes, priority, uses}}."""
        with self._lock:
            return {
                fp: {"owner": e.owner, "bytes": e.nbytes, "priority": e.priority,
                     "uses": e.uses}
                for fp, e in self._pins.items()
            }

    def live_bytes(self) -> int:
        """Pinned bytes plus the bytes live in tensors on the current
        CUDA device."""
        return self.pinned_bytes() + device_allocated_bytes()

    def headroom(self) -> Optional[int]:
        """Bytes left before the capacity (None when it is unknown:
        admission then never sheds for memory)."""
        cap = hbm_capacity_bytes()
        if cap is None:
            return None
        return cap - self.live_bytes()


def _buf_key(t) -> tuple:
    return (t.device, t.untyped_storage().data_ptr())


def _fmt_bytes(n: float) -> str:
    n = int(n)
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f}GiB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"


LEDGER = DeviceLedger()


def note_h2d(nbytes: int, seconds: float) -> None:
    """One host-to-device copy (`exec/batch.to_device`): the
    `device.h2d.transfers` and `h2d.bytes` counters, the `h2d.dispatch`
    timer, the ambient operator's bytes and time, and the bytes charged
    to this thread's client (`obs/attribution.charge_h2d`)."""
    METRICS.tally("h2d.dispatch", seconds, ("device.h2d.transfers", 1),
                  ("h2d.bytes", nbytes))
    _stats.record_h2d(nbytes)
    _stats.record_h2d_time(seconds)
    charge_h2d(nbytes)  # this thread's client, if a served query copies
    if _ENABLED:
        recorder.record("device.h2d", **_copy_attrs(nbytes, seconds, profile_sync_active()))


def _copy_attrs(nbytes: int, seconds: float, synced: bool) -> dict:
    """A copy's flight-event attributes: bytes and wall, and the
    achieved GB/s only where the wall covers the copy itself (a copy
    that was waited for); an asynchronous copy's wall is its enqueue
    and is marked `dispatch_only`."""
    attrs = {"bytes": nbytes, "ms": round(seconds * 1e3, 3)}
    if synced:
        attrs["gbps"] = round(nbytes / max(seconds, 1e-9) / 1e9, 3)
    else:
        attrs["dispatch_only"] = True
    return attrs


def record_d2h(nbytes: int, seconds: float) -> None:
    """One device-to-host pull (`exec/batch.to_host`): the
    `device.d2h.transfers` and `d2h.bytes` counters, the `d2h.wait`
    timer, and the ambient operator's bytes and time."""
    METRICS.tally("d2h.wait", seconds, ("device.d2h.transfers", 1), ("d2h.bytes", nbytes))
    _stats.record_d2h(nbytes)
    _stats.record_d2h_time(seconds)
    if _ENABLED:
        # a pull blocks until its bytes are on the host: the wall is the copy's
        recorder.record("device.d2h", **_copy_attrs(nbytes, seconds, True))


# -- phase breakdown ---------------------------------------------------
# Phases over the stage timers: "decode" is the scan's parse
# (`scan.parse`, timed around every reader), the aggregate's host
# group-key encode (`agg.host_encode`) and the wire codec's host encode
# (`h2d.encode`, exec/batch.put_compressed); "h2d" the copy seam
# (`h2d.dispatch`, exec/batch.to_device); "compile" the first-use kernel
# build (`compile.nvcc`, exec/cuda.load); "execute" the pass seam
# (`device.dispatch`, utils/retry.device_call) less the builds made
# inside it; "d2h" the pulls (`d2h.wait`, exec/batch.to_host and
# device_pull) and the compaction gathers (`d2h.compact`); "other"
# the rest of the query's wall (planning, host merges, assembly).
PHASE_ORDER = ("decode", "h2d", "compile", "execute", "d2h", "other")

_PHASE_TIMERS = {
    "decode": ("scan.parse", "agg.host_encode", "h2d.encode"),
    "h2d": ("h2d.dispatch",),
    "compile": ("compile.nvcc",),
    "execute": ("device.dispatch",),
    "d2h": ("d2h.wait", "d2h.compact"),
}


def phase_snapshot() -> dict[str, float]:
    """Current values of every timer a phase derives from: take one
    before a query and give it to `phase_breakdown` after.  Timers are
    process-wide: with concurrent queries the breakdown is approximate,
    and the prefetch threads' parse and encode overlap the passes, so
    the phases may add up to more than the wall ("other" is then 0)."""
    if not _ENABLED:
        return {}
    timings = METRICS.snapshot()["timings_s"]
    return {t: timings.get(t, 0.0) for timers in _PHASE_TIMERS.values() for t in timers}


def phase_breakdown(before: Optional[dict], wall_s: float) -> dict[str, float]:
    """Per-phase seconds of one query from the timer deltas since
    `before` (None or {}: since the process started) and its wall."""
    before = before or {}
    cur = phase_snapshot()
    phases: dict[str, float] = {}
    for name, timers in _PHASE_TIMERS.items():
        phases[name] = max(sum(cur.get(t, 0.0) - before.get(t, 0.0) for t in timers), 0.0)
    # a build happens inside the first pass's wall: split it out
    phases["execute"] = max(phases["execute"] - phases["compile"], 0.0)
    phases["other"] = max(wall_s - sum(phases.values()), 0.0)
    return phases


def phase_ms(phases: dict[str, float]) -> dict[str, float]:
    """Milliseconds form for JSON lines."""
    return {k: round(v * 1e3, 2) for k, v in phases.items()}


def phase_bar(phases: dict[str, float], wall_s: float, width: int = 30) -> str:
    """The one-line EXPLAIN ANALYZE bar: each phase's share of the query
    wall as a proportional run of blocks."""
    wall = max(wall_s, 1e-9)
    parts = []
    for name in PHASE_ORDER:
        frac = phases.get(name, 0.0) / wall
        if frac < 0.005:
            continue
        blocks = "\u2588" * max(1, round(frac * width))
        parts.append(f"{name} {blocks} {frac * 100:.0f}%")
    return " \u00b7 ".join(parts) if parts else "(no phases recorded)"
