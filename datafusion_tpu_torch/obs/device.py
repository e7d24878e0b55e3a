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
  section.  The JAX package's leak sweep waits for ROADMAP queue 1 item
  13.2.
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
import threading
import time
import weakref
from typing import Any, Optional

from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs import stats as _stats
from datafusion_tpu_torch.utils.metrics import METRICS


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
    return _profile_sync_depth.get() > 0


class _BufEntry:
    """One registered storage: its bytes, owner, device and a weak
    reference to each registered tensor that still holds it."""

    __slots__ = ("nbytes", "owner", "device", "holders")

    def __init__(self, nbytes: int, owner: str, device: str):
        self.nbytes = nbytes
        self.owner = owner
        self.device = device
        self.holders: dict = {}


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


class DeviceLedger:
    """Process-wide registry of device buffers and pinned residents."""

    def __init__(self):
        self._lock = threading.Lock()
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

    # -- buffers -------------------------------------------------------
    def adopt(self, value: Any, owner: str = "anon") -> Any:
        """Register every tensor of `value` (a tensor, or a tuple or list
        nesting tensors and None) under `owner`; returns `value`."""
        if isinstance(value, (tuple, list)):
            for v in value:
                self.adopt(v, owner)
        elif value is not None:
            self._register(value, owner)
        return value

    def retag(self, value: Any, owner: str) -> None:
        """Re-attribute the registered storages of `value` to `owner`."""
        if isinstance(value, (tuple, list)):
            for v in value:
                self.retag(v, owner)
            return
        e = self._bufs.get(_buf_key(value)) if value is not None else None
        if e is not None:
            e.owner = owner

    def _register(self, t, owner: str) -> None:
        st = t.untyped_storage()
        nbytes = st.nbytes()
        if nbytes == 0:
            return
        key = (t.device, st.data_ptr())
        e = self._bufs.get(key)
        if e is None:
            e = self._bufs[key] = _BufEntry(nbytes, owner, str(key[0]))
            live = self._live = self._live + nbytes
            if live > self._peak:
                self._peak = live
            wp = self._window_peak
            if wp is not None and live > wp:
                self._window_peak = live
            METRICS.gauge("device.hbm.live_bytes", live)
            METRICS.gauge("device.hbm.peak_bytes", self._peak)
        else:
            e.owner = owner  # the latest registration names the owner
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
        METRICS.gauge("device.hbm.live_bytes", exact)
        METRICS.gauge("device.hbm.peak_bytes", self._peak)
        return exact

    def peak_bytes(self) -> int:
        return self._peak

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

    def snapshot(self) -> dict:
        return {
            "live_bytes": self.buffer_bytes(),
            "peak_bytes": self._peak,
            "buffers": len(self._bufs),
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
        ]
        for dev, nbytes in sorted(snap["devices"].items()):
            lines.append(f"  device {dev}: {_fmt_bytes(nbytes)}")
        for owner, d in sorted(snap["owners"].items(), key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"  owner {owner}: {_fmt_bytes(d['bytes'])} "
                         f"in {d['buffers']} buffer(s)")
        for fp, p in sorted(snap["pins"].items(), key=lambda kv: -kv[1]["bytes"]):
            lines.append(f"  pinned {fp}: {_fmt_bytes(p['bytes'])} "
                         f"(owner {p['owner']}, uses {p['uses']})")
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

    def set_pin_bytes(self, fingerprint: str, nbytes: int) -> None:
        """Update a pin's accounted bytes (a pinned table that grew by an
        append, serve.py)."""
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
    timer, and the ambient operator's bytes and time."""
    METRICS.tally("h2d.dispatch", seconds, ("device.h2d.transfers", 1),
                  ("h2d.bytes", nbytes))
    _stats.record_h2d(nbytes)
    _stats.record_h2d_time(seconds)


def record_d2h(nbytes: int, seconds: float) -> None:
    """One device-to-host pull (`exec/batch.to_host`): the
    `device.d2h.transfers` and `d2h.bytes` counters, the `d2h.wait`
    timer, and the ambient operator's bytes and time."""
    METRICS.tally("d2h.wait", seconds, ("device.d2h.transfers", 1), ("d2h.bytes", nbytes))
    _stats.record_d2h(nbytes)
    _stats.record_d2h_time(seconds)


# -- phase breakdown ---------------------------------------------------
# Phases over the stage timers: "decode" is the scan's parse
# (`scan.parse`, timed around every reader) and the aggregate's host
# group-key encode (`agg.host_encode`); "h2d" the copy seam
# (`h2d.dispatch`, exec/batch.to_device); "compile" the first-use kernel
# build (`compile.nvcc`, exec/cuda.load); "execute" the pass seam
# (`device.dispatch`, utils/retry.device_call) less the builds made
# inside it; "d2h" the pulls (`d2h.wait`, exec/batch.to_host); "other"
# the rest of the query's wall (planning, host merges, assembly).
PHASE_ORDER = ("decode", "h2d", "compile", "execute", "d2h", "other")

_PHASE_TIMERS = {
    "decode": ("scan.parse", "agg.host_encode"),
    "h2d": ("h2d.dispatch",),
    "compile": ("compile.nvcc",),
    "execute": ("device.dispatch",),
    "d2h": ("d2h.wait",),
}


def phase_snapshot() -> dict[str, float]:
    """Current values of every timer a phase derives from: take one
    before a query and give it to `phase_breakdown` after.  Timers are
    process-wide: with concurrent queries the breakdown is approximate,
    and the prefetch threads' parse and encode overlap the passes, so
    the phases may add up to more than the wall ("other" is then 0)."""
    timings = METRICS.snapshot()["timings_s"]
    return {t: timings.get(t, 0.0) for timers in _PHASE_TIMERS.values() for t in timers}


def phase_breakdown(before: Optional[dict], wall_s: float) -> dict[str, float]:
    """Per-phase seconds of one query from the timer deltas since
    `before` (None or {}: since the process started) and its wall."""
    before = before or {}
    cur = phase_snapshot()
    phases: dict[str, float] = {}
    for name, timers in _PHASE_TIMERS.items():
        phases[name] = max(sum(cur[t] - before.get(t, 0.0) for t in timers), 0.0)
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
