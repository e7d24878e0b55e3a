"""The device ledger's pins: HBM-resident artifacts owned by the
ledger, evicted under memory pressure.

The counterpart of the pin section of the JAX package's `obs/device.py`
(`_PinEntry`, `DeviceLedger.pin` ... `headroom`, `LEDGER`).  A pin is a
named artifact (a served table's resident batches, a join build) with
its accounted bytes, an owner tag, a priority and an eviction hook.
`pinned(fp)` returns the artifact and counts a use; `evict_pins` drops
pins in (priority, least recent use) order, where a pin's priority is
the most uses it has seen, until the bytes asked for are freed.

Capacity and live bytes (`headroom`):
- capacity: `DATAFUSION_TPU_HBM_BYTES` when set, else
  `torch.cuda.mem_get_info` of the current device when CUDA is there,
  else unknown (None): on the CPU nothing sheds for memory, as in the
  JAX package;
- live bytes: the pins' accounted bytes plus
  `torch.cuda.memory_allocated()` where CUDA is initialized.  A pinned
  table's device copies count in both terms, so the headroom is
  conservative.  The JAX ledger's per-buffer entries wait for the
  observability slice (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Optional

from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.utils.metrics import METRICS


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
    """Process-wide registry of pinned residents."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pins: dict[str, _PinEntry] = {}

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


LEDGER = DeviceLedger()
