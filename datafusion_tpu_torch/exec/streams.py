"""Serving streams: each serving worker thread launches on a CUDA stream
of its own.

A served pass is metered by a CUDA event pair recorded on the stream it
launches on (`utils/retry._pass`).  With every worker on one stream, a
kernel or a copy another worker enqueued between the two records fell
inside the pair and was billed to the wrong tenant.  `serving_scope`
enters the thread's own stream (created once per thread and device, on
first use, and kept in a thread-local), so a pair times that worker's
work alone.  Creating the stream raises where it fails: nothing falls
back to the default stream.  The pass's pairs sit behind a host gate
on that stream (exec/gate.py), so they hold no idle gap while the host
thread enqueues.

Device values that outlive a query are read by whichever worker scans
them next, on another stream: a pinned table's cached copies, its
group ids and aux tables, a pinned join build.  Each is ordered by an
event that travels with its tensors, on one path whether a server runs
or not, and the host never waits:

- `publish(value)`: inside a serving scope, the producer records an
  event on its stream as the value enters such a cache and tags each
  CUDA tensor of it with the event; outside one (the default stream)
  nothing is recorded;
- `shared(value)`: a reader on another stream than the producer's makes
  its stream wait for the tag's event (`Stream.wait_event`), or, for an
  untagged tensor, made outside a serving scope, for the default
  stream's work so far; and it marks each such tensor as used by its
  stream (`Tensor.record_stream`), so PyTorch's caching allocator,
  which ties a block to the stream that allocated it, holds a block an
  eviction frees until the reader's queued work is done.  A stream
  does both once a tensor: later reads on it cost a set lookup.

A plain query reads untagged values on the default stream: nothing to
order, so it records no event and asks for no stream.  On the CPU there
is nothing to order.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_local = threading.local()
_TAG = "_df_ready"  # a published tensor's `_Ready`


def worker_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's serving stream on `device`, created on first use."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device=device)
    return s


def current() -> Optional[torch.cuda.Stream]:
    """The serving stream this thread launches on, or None outside a
    serving scope."""
    return getattr(_local, "current", None)


@contextlib.contextmanager
def stream_scope(s: Optional[torch.cuda.Stream]):
    """Launch on `s` and count it as this thread's serving stream (a
    helper thread takes its consumer's `current()`); None: a no-op."""
    if s is None:
        yield None
        return
    prev = current()
    _local.current = s
    try:
        with torch.cuda.device(s.device), torch.cuda.stream(s):
            yield s
    finally:
        _local.current = prev


def serving_scope(device: torch.device):
    """Launch on `device` and on this thread's own stream there (a no-op
    on the CPU)."""
    return stream_scope(worker_stream(device) if device.type == "cuda" else None)


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


class _Ready:
    """One published tensor's tag: the event recorded on its producing
    stream (shared by the tensors published together), and the streams
    (raw handles) that already waited for it and recorded their use of
    this tensor: each does so once."""

    __slots__ = ("event", "readers")

    def __init__(self, event, stream):
        self.event = event
        self.readers = {stream.cuda_stream}


def _event_on(stream):
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def publish(value):
    """`value` about to enter a cache other streams read: tag its CUDA
    tensors with an event recorded now on this thread's serving stream,
    which produced them.  Returns `value`."""
    s = current()
    if s is None:
        return value
    tensors = [t for t in _tensors(value) if t.is_cuda]
    if tensors:
        ev = _event_on(s)
        for t in tensors:
            setattr(t, _TAG, _Ready(ev, s))
    return value


def shared(value):
    """`value` read from a cache another stream may have filled: order
    this thread's stream after each CUDA tensor's producer and record
    its use of the tensor, once a stream.  Returns `value`."""
    s = current()
    for t in _tensors(value):
        if not t.is_cuda:
            continue
        tag = getattr(t, _TAG, None)
        if s is None:
            if tag is None:
                continue  # made and read outside serving
            reader = torch.cuda.current_stream(t.device)
        else:
            if tag is None:
                # made outside a serving scope, on the default stream:
                # tag it with that stream's work so far, once
                default = torch.cuda.default_stream(t.device)
                tag = _Ready(_event_on(default), default)
                setattr(t, _TAG, tag)
            reader = s
        if reader.cuda_stream in tag.readers:
            continue
        reader.wait_event(tag.event)
        t.record_stream(reader)
        tag.readers.add(reader.cuda_stream)
    return value
