"""Host gate on a serving stream: a served pass is billed the time the
card spent on its work, not the time its stream sat idle while the host
enqueued it.

A served pass on the card is timed by CUDA event pairs on the worker's
own stream (`utils/retry._pass`, exec/streams.py).  Without a gate the
start event fires as soon as it is recorded on an idle stream, and every
gap between two kernels while the host enqueues the next one (Python,
or another worker's Python holding the interpreter lock for
milliseconds) lands in the pair.  With the gate the stream first waits
(`cuStreamWaitValue32`) on a 32-bit word in pinned, device-mapped host
memory; the start event, the pass's work and the end event are enqueued
behind the wait, and only then does the host write the word.  The card
then runs the pass back to back, so the pair holds device work alone.

A host wait inside a gated pass would never return, since the stream
cannot run until the pass's enqueue ends.  Every such wait runs under
`host_wait()`, which ends the segment (an end event), opens the gate,
waits, then closes the gate again behind a new start event: the pass is
billed the sum of its segments.  The sites inside passes: the radix
sort's digit pull (exec/cuda/sort_kernel.py), the join build's duplicate
flag (exec/cuda/hash_build.py), `exec/batch.device_pull` and `to_host`,
and the sort-merge's span pull (exec/aggregate.py).  A wait that no
`host_wait` covers is a fault: a watchdog opens any gate still closed
`FORCE_OPEN_S` after it closed, counts ``meter.gate_forced`` and records
a ``meter.gate_forced`` flight event with the pass thread's innermost
frames, so such a wait stalls for that long and is billed its host time
rather than hanging the worker.

The gate needs CUDA's stream memory operations
(`cuStreamWaitValue32_v2`, CUDA 12): a CUDA driver or device without them
raises `ExecutionError` at the first gated pass; nothing falls back to
the ungated pair.  Outside a charge scope nothing here runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import heapq
import os
import threading
import time
from typing import Optional

import torch

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.utils.metrics import METRICS

# a closed gate that no pass opened within this long is opened by the
# watchdog (``meter.gate_forced``): long enough that a pass's enqueue
# slowed by another thread holding the interpreter lock (a numpy call
# on millions of rows holds it for tens of ms) or a kernel library's
# first build is not taken for a host wait
FORCE_OPEN_S = 1.0

_CU_STREAM_WAIT_VALUE_GEQ = 0x0
_CU_MEMHOSTALLOC_PORTABLE = 0x01
_CU_MEMHOSTALLOC_DEVICEMAP = 0x02
_CU_DEVICE_ATTRIBUTE_UNIFIED_ADDRESSING = 41
_CU_DEVICE_ATTRIBUTE_CAN_USE_HOST_POINTER_FOR_REGISTERED_MEM = 91

_LOCK = lockcheck.make_lock("exec.gate_driver")
_DRIVER: Optional["_Driver"] = None
_local = threading.local()


class _Driver:
    """The few CUDA driver entry points the gate needs, bound with ctypes."""

    def __init__(self):
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise ExecutionError(f"the meter's stream gate needs libcuda: {e}") from e
        self.lib = lib
        vp, u32, i = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
        self._bind("cuInit", [ctypes.c_uint])
        self._bind("cuDeviceGet", [ctypes.POINTER(i), i])
        self._bind("cuDeviceGetAttribute", [ctypes.POINTER(i), i, i])
        self._bind("cuCtxGetCurrent", [ctypes.POINTER(vp)])
        self._bind("cuCtxSetCurrent", [vp])
        self._bind("cuDevicePrimaryCtxRetain", [ctypes.POINTER(vp), i])
        self._bind("cuMemHostAlloc", [ctypes.POINTER(vp), ctypes.c_size_t, ctypes.c_uint])
        self._bind("cuMemHostGetDevicePointer_v2", [ctypes.POINTER(ctypes.c_uint64), vp,
                                                    ctypes.c_uint])
        name = "cuStreamWaitValue32_v2"
        if not hasattr(lib, name):
            raise ExecutionError("the CUDA driver has no stream memory operations "
                                 "(cuStreamWaitValue32_v2): the meter cannot gate a "
                                 "served pass")
        self.wait_value = getattr(lib, name)
        self.wait_value.argtypes = [vp, ctypes.c_uint64, u32, ctypes.c_uint]
        self.wait_value.restype = i
        self.check("cuInit", self.lib.cuInit(0))

    def _bind(self, name: str, argtypes) -> None:
        fn = getattr(self.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

    @staticmethod
    def check(what: str, rc: int) -> None:
        if rc != 0:
            raise ExecutionError(f"{what} failed: CUDA driver error {rc}")

    def supports(self, index: int) -> None:
        """Raise unless device `index` can wait on a mapped host word:
        unified addressing, and host memory the device reads at the
        host's address.  (The 32-bit wait itself has no attribute of its
        own in CUDA 12: the V1 attribute, 92, reads 0 on an H100 whose
        `cuStreamWaitValue32_v2` works.)"""
        dev = ctypes.c_int()
        self.check("cuDeviceGet", self.lib.cuDeviceGet(ctypes.byref(dev), index))
        for attr, what in ((_CU_DEVICE_ATTRIBUTE_UNIFIED_ADDRESSING, "unified addressing"),
                           (_CU_DEVICE_ATTRIBUTE_CAN_USE_HOST_POINTER_FOR_REGISTERED_MEM,
                            "host pointers for registered memory")):
            v = ctypes.c_int()
            self.check("cuDeviceGetAttribute",
                       self.lib.cuDeviceGetAttribute(ctypes.byref(v), attr, dev))
            if not v.value:
                raise ExecutionError(f"device {index} reports no {what}: the meter "
                                     "cannot gate a served pass on a host word")

    def ensure_context(self, index: int) -> None:
        """Make device `index`'s primary context current on this thread
        (the one torch's runtime calls use)."""
        ctx = ctypes.c_void_p()
        self.check("cuCtxGetCurrent", self.lib.cuCtxGetCurrent(ctypes.byref(ctx)))
        if ctx.value:
            return
        self.check("cuDevicePrimaryCtxRetain",
                   self.lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), index))
        self.check("cuCtxSetCurrent", self.lib.cuCtxSetCurrent(ctx))


def _driver(index: int) -> _Driver:
    global _DRIVER
    with _LOCK:
        if _DRIVER is None:
            drv = _Driver()
            drv.supports(index)
            _DRIVER = drv
        return _DRIVER


class Gate:
    """One thread's gate on one device: a mapped host word and the value
    the next close waits for.  The word only grows (a wait is `>=`, which
    CUDA compares cyclically, so it wraps safely); the lock keeps
    the watchdog from writing back a value the pass already passed."""

    __slots__ = ("host", "dptr", "value", "_word", "_lock", "thread")

    def __init__(self, index: int):
        drv = _driver(index)
        drv.ensure_context(index)
        host = ctypes.c_void_p()
        drv.check("cuMemHostAlloc", drv.lib.cuMemHostAlloc(
            ctypes.byref(host), 4, _CU_MEMHOSTALLOC_PORTABLE | _CU_MEMHOSTALLOC_DEVICEMAP))
        dptr = ctypes.c_uint64()
        drv.check("cuMemHostGetDevicePointer_v2",
                  drv.lib.cuMemHostGetDevicePointer_v2(ctypes.byref(dptr), host, 0))
        self.host = host  # the allocation lives as long as the process
        self.dptr = dptr.value
        self._word = ctypes.c_uint32.from_address(host.value)
        self._word.value = 0
        self.value = 0
        self._lock = lockcheck.make_lock("exec.gate")
        self.thread = threading.get_ident()  # a gate serves one thread

    def close(self, stream: int) -> None:
        """Make `stream` wait until the host opens the gate."""
        self.value = (self.value + 1) & 0xFFFFFFFF
        _DRIVER.check("cuStreamWaitValue32_v2", _DRIVER.wait_value(
            stream, self.dptr, self.value, _CU_STREAM_WAIT_VALUE_GEQ))
        _WATCHDOG.arm(self, self.value)

    def open(self) -> None:
        with self._lock:
            self._word.value = self.value

    def force(self, value: int, note=None) -> bool:
        """Open the gate up to `value` unless it is open that far already
        (True when it was not), calling `note()` first: the waiting
        pass resumes only once the note is taken."""
        with self._lock:
            if ((self._word.value - value) & 0xFFFFFFFF) < 0x80000000:
                return False
            if note is not None:
                note()
            self._word.value = value
            return True


class _Watchdog:
    """Opens a gate still closed `FORCE_OPEN_S` after it closed: the
    backstop against a host wait that runs under no `host_wait()`."""

    def __init__(self):
        self._cv = threading.Condition(lockcheck.make_lock("exec.gate_watchdog"))
        self._heap: list = []
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    def arm(self, gate: Gate, value: int) -> None:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (time.monotonic() + FORCE_OPEN_S, self._seq,
                                        gate, value))
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="df-torch-gate",
                                                daemon=True)
                self._thread.start()
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    self._cv.wait()
                when, _, gate, value = self._heap[0]
                delay = when - time.monotonic()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                heapq.heappop(self._heap)
            gate.force(value, lambda: _note_forced(gate, value))


def _note_forced(gate: Gate, value: int) -> None:
    """A forced open: the ``meter.gate_forced`` count and a flight event
    with the pass thread's innermost frames."""
    import sys
    import traceback

    from datafusion_tpu_torch.obs import recorder

    METRICS.add("meter.gate_forced")
    try:
        frame = sys._current_frames().get(gate.thread)
        where = "" if frame is None else " <- ".join(
            f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
            for f in reversed(traceback.extract_stack(frame)[-6:]))
        recorder.record("meter.gate_forced", value=value, where=where)
    except Exception:  # noqa: BLE001 — the note must not keep the gate shut
        METRICS.add("obs.telemetry_errors")


_WATCHDOG = _Watchdog()


def _gate(index: int) -> Gate:
    gates = getattr(_local, "gates", None)
    if gates is None:
        gates = _local.gates = {}
    g = gates.get(index)
    if g is None:
        g = gates[index] = Gate(index)
    return g


class GatedPass:
    """One served pass on the card: the event pairs of its segments,
    each enqueued behind a closed gate.  `begin` closes the gate and
    records a segment's start event; `end` records its end event and
    opens the gate."""

    __slots__ = ("gate", "stream", "pairs", "_start")

    def __init__(self, device):
        from datafusion_tpu_torch.exec.cuda import raw_stream

        index = device.index if device.index is not None else torch.cuda.current_device()
        self.gate = _gate(index)
        self.stream = raw_stream(device)
        self.pairs: list = []
        self._start = None
        self.begin()

    def begin(self) -> None:
        self.gate.close(self.stream)
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def end(self) -> None:
        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        self.pairs.append((self._start, stop))
        self._start = None
        self.gate.open()


def active() -> Optional[GatedPass]:
    return getattr(_local, "active", None)


@contextlib.contextmanager
def gated_pass(device):
    """Gate the current stream of `device` for one served pass; yields
    the `GatedPass` (its `pairs` are read after the block).  A pass
    nested in another runs inside the outer one's segment: yields None."""
    if active() is not None:
        yield None
        return
    p = GatedPass(device)
    _local.active = p
    try:
        yield p
    except BaseException:
        p.pairs.clear()  # the pass raised: bill nothing
        raise
    finally:
        _local.active = None
        if p._start is not None:
            p.end()


@contextlib.contextmanager
def host_wait():
    """Around a host wait for the card's work (a copy back, `.item()`, a
    synchronize): inside a gated pass, end the segment and open the gate
    first, and close it behind a new start event after; elsewhere a
    no-op."""
    p = active()
    if p is None:
        yield
        return
    p.end()
    try:
        yield
    finally:
        p.begin()
