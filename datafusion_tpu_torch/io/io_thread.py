"""Process-wide pyarrow confinement threads.

The counterpart of the JAX package's `io/io_thread.py`.  pyarrow's C++
runtime (readahead pools, compute registry, memory-pool thread caches)
is initialised lazily by whichever thread first touches it and
interacts badly with short-lived threads: scans issued from a churn of
fresh threads (server handler threads) can crash inside pyarrow after
a few queries.  So every pyarrow call in the process runs on a small
pool of PERSISTENT IO threads that never die, with the pyarrow imports
made on the pool.  Each confined generator keeps one pool thread for
its whole scan; distinct scans land on distinct threads round-robin.
Callers submit closures and block for the result: `confined_iter` is a
synchronous pull, one queue round-trip per batch.

The start lock is `analysis/lockcheck`'s `io.worker_start`, and a
submit marks its wait for the result (`io_thread.submit`), so a
lock-order run records any lock a caller holds across a confined call,
as in the JAX package.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterator

from datafusion_tpu_torch.analysis import lockcheck

__all__ = ["run_on_io_thread", "confined_iter"]

_POOL_SIZE = 4


class _IoWorker:
    """One persistent confinement thread with a task queue."""

    def __init__(self, name: str) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self._lock = lockcheck.make_lock("io.worker_start")
        self._name = name

    def _ensure_started(self) -> None:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()

    def _run(self) -> None:
        # Perform the pyarrow imports HERE so every piece of its lazy
        # native init (thread pools, compute registry, pandas shim)
        # belongs to a persistent thread.
        try:
            import pyarrow  # noqa: F401
            import pyarrow.compute  # noqa: F401
            import pyarrow.csv  # noqa: F401
            import pyarrow.parquet  # noqa: F401
        except Exception:  # noqa: BLE001 — pyarrow-less installs; native init can raise anything
            pass
        while True:
            fn, args, kwargs, done, out = self._q.get()
            try:
                out.append(fn(*args, **kwargs))
                out.append(None)
            except BaseException as e:  # noqa: BLE001 — re-raised in caller
                out.append(None)
                out.append(e)
            done.set()

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run fn(*args, **kwargs) on this worker, blocking for the
        result.  Re-entrant: calls made FROM the worker run inline (a
        confined generator may itself call confined helpers)."""
        if threading.current_thread() is self._thread:
            return fn(*args, **kwargs)
        self._ensure_started()
        done = threading.Event()
        out: list = []
        self._q.put((fn, args, kwargs, done, out))
        # a caller holding a lock would stall every contender for as
        # long as the confined call takes: lockcheck records it
        lockcheck.note_blocking("io_thread.submit")
        done.wait()
        if out[1] is not None:
            raise out[1]
        return out[0]

    def close_quietly(self, gen: Iterator) -> None:
        """Best-effort generator close on this worker.  Runs during
        cleanup — possibly from GC at interpreter shutdown, when the
        daemon thread may already be frozen — so it must never block
        forever or raise: bounded wait, and skipped entirely when the
        thread is not running."""
        t = self._thread
        if threading.current_thread() is t:
            gen.close()
            return
        if t is None or not t.is_alive():
            return
        done = threading.Event()
        out: list = []
        self._q.put((gen.close, (), {}, done, out))
        done.wait(timeout=5.0)


_POOL = [_IoWorker(f"df-tpu-io-{i}") for i in range(_POOL_SIZE)]
_rr = itertools.count()


def run_on_io_thread(fn: Callable, *args: Any, **kwargs: Any) -> Any:
    """One-shot pyarrow call on a confinement thread (round-robined so
    it doesn't queue behind an in-flight scan step on one worker)."""
    return _POOL[next(_rr) % _POOL_SIZE].submit(fn, *args, **kwargs)


def confined_iter(gen: Iterator) -> Iterator:
    """Iterate `gen` with every __next__ (and the final close) executed
    on one pool thread (per-generator affinity; scans never hop threads
    mid-stream).  One queue round-trip per batch — noise against a
    100k-row parse."""
    worker = _POOL[next(_rr) % _POOL_SIZE]
    _SENTINEL = object()

    def _step():
        return next(gen, _SENTINEL)

    try:
        while True:
            item = worker.submit(_step)
            if item is _SENTINEL:
                return
            yield item
    finally:
        worker.close_quietly(gen)
