"""The flight recorder's event ring (the JAX package's
`obs/recorder.py`, its ring only).

A bounded ring of structured events (`serve.pin`, `serve.evict`,
`serve.shed`, ...), each a timestamp, a kind, the emitting thread and
its attributes; the ring keeps the last 8192.  `record` takes no lock:
one counter bump (atomic under the interpreter lock) and one slot
store, so it may run inside any other subsystem's critical section.
`events` snapshots the ring, oldest first.  The JAX package's knobs,
dumps, slow-query capture and crash hook wait for the observability
slice (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any

_CAP = 8192

# slot i % _CAP holds the i'th event emitted
_slots: list = [None] * _CAP
_cursor = itertools.count()


def record(kind: str, **attrs: Any) -> None:
    """Emit one event; `attrs` are JSON-representable scalars."""
    i = next(_cursor)
    _slots[i % _CAP] = (time.time_ns(), kind, threading.get_ident(), attrs or None)


def events(kind: str = None) -> list[dict]:
    """The ring as event dicts, oldest first (of one `kind` if given)."""
    snap = list(_slots)
    out = []
    for ev in snap:
        if ev is None:
            continue
        ts, k, tid, attrs = ev
        if kind is not None and k != kind:
            continue
        d = {"ts_ns": ts, "kind": k, "tid": tid}
        if attrs:
            d["attrs"] = dict(attrs)
        out.append(d)
    out.sort(key=lambda d: d["ts_ns"])
    return out
