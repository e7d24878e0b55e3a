"""Host-side pipeline: the parse of batch N+2, the host prep and H2D
of batch N+1 and the device dispatch of batch N overlap.

The counterpart of the JAX package's `exec/prefetch.py`, with its
semantics.  `staged_prefetch` moves a scan's host stages onto a producer
thread with a bounded queue, so the consumer (the dispatch, which stays
ordered: an aggregate's state threads through every update) waits only
when the producer is behind.  `staged_pipeline` chains two of them: one
thread pulls (parses) batches, a second runs `stage` (group-id encode,
aux tables, H2D of the used columns).

The pipeline runs on a CUDA device over a source that parses as it
reads, a CSV file (`pipeline_enabled`).  The JAX package turns it on for
every accelerator; on the H100 the threads won every interleaved cold
run of a CSV scan (the pull thread parses ahead) and lost on every warm
scan of batches already in memory (nothing to parse ahead; PERF.md §6),
so the scan's source chooses.  DATAFUSION_TPU_PREFETCH=1 or 0 forces
the threads on or off; the CPU tests use 1.

CUDA: a producer thread enters the consumer's serving stream
(exec/streams.py; outside serving a new thread's current stream is the
device's default stream, the consumer's) and issues its copies (pinned
memory, then `non_blocking`) there; the queue hands a batch over only
after its copies were enqueued, so the consumer's kernels run after
them.  Callers pass the device explicitly
(a new thread's current device is `cuda:0`).

numpy's bulk work, the native CSV parser and torch ops release the
interpreter lock, so one thread per stage buys the overlap without
processes or copies.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional

from datafusion_tpu_torch.exec import streams

_DEPTH = 2  # batches in flight: N computing, N+1 staged, N+2 parsing


def pipeline_enabled(device, child) -> bool:
    """Whether an operator on `device` stages the batches of its input
    relation `child` on the prefetch threads: on a CUDA device when
    `child` scans a source that parses as it reads (`DataSource.parses`).
    DATAFUSION_TPU_PREFETCH=1 or 0 forces it on or off."""
    knob = os.environ.get("DATAFUSION_TPU_PREFETCH")
    if knob in ("0", "1"):
        return knob == "1"
    source = getattr(child, "datasource", None)
    return getattr(device, "type", "cpu") == "cuda" and getattr(source, "parses", False)


class _Stop(Exception):
    pass


def staged_prefetch(
    batches: Iterator,
    stage: Optional[Callable] = None,
    depth: int = _DEPTH,
) -> Iterator:
    """Yield `batches` in order, pulling and staging them on a
    background thread.

    `stage(batch)` runs on the producer thread right after the batch is
    produced; its results land in caches the consumer re-reads
    (`batch.cache` and the relation's caches).  The producer is one
    thread, so `stage` may mutate relation state (encoders, caches)
    without locks: the queue orders each batch's stage before the
    consumer sees the batch.

    An exception from the source iterator or `stage` re-raises in the
    consumer.  Abandoning the generator (closing it, as a LIMIT does)
    stops the producer, which then closes the source iterator on its own
    thread; the consumer waits for it, so nothing of a scan (a stage, a
    launch it counts) outlives the query that abandoned it.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    done = object()
    stream = streams.current()  # None: the default stream

    def put(item) -> None:
        while True:
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                if stop.is_set():
                    raise _Stop() from None

    def producer() -> None:
        try:
            with streams.stream_scope(stream):
                _produce()
        except _Stop:
            pass
        except BaseException as e:  # noqa: BLE001 (handed to the consumer)
            try:
                put(e)
            except _Stop:
                pass
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()

    def _produce() -> None:
        for b in batches:
            if stop.is_set():
                return
            if stage is not None:
                stage(b)
            put(b)
        put(done)

    t = threading.Thread(target=producer, name="df-torch-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # the producer leaves at its next put (it waits at most 0.1 s
        # there) or once the stage or the pull it is in returns
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        if t is not threading.current_thread():
            t.join()


def staged_pipeline(batches: Iterator, stage: Callable, depth: int = _DEPTH,
                    pull: Optional[Callable] = None):
    """Two-thread pipeline: one thread pulls (parses) batches ahead and
    runs `pull(batch)` as each leaves the source, a second runs `stage`,
    so the parse of batch N+2 overlaps the prep of batch N+1 overlaps
    the consumer's dispatch of batch N."""
    return staged_prefetch(staged_prefetch(batches, pull, depth), stage, depth)
