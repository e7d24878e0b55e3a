"""The serving front door's event loop (the JAX package's
`utils/eventloop.py`: `ServerLoop` and `_Timer`).

One loop thread runs callbacks posted from any thread (`call_soon`,
woken through a local socket pair) and monotonic timers
(`call_later`), and hands blocking work to a bounded executor
(`defer`), whose result comes back as a callback on the loop thread.
The JAX package's connections and its socketserver facade wait for the
cluster slice (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import heapq
import itertools
import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from datafusion_tpu_torch.utils.metrics import METRICS


class _Timer:
    __slots__ = ("when", "fn", "cancelled")

    def __init__(self, when: float, fn: Callable[[], None]):
        self.when = when
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class ServerLoop:
    """One loop thread and one bounded executor."""

    def __init__(self, pool_size: int = 4, name: str = "df-torch-loop"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ)
        self._pending: deque = deque()
        self._timers: list[tuple[float, int, _Timer]] = []
        self._timer_seq = itertools.count()
        self._stop_evt = threading.Event()
        self._stopped = threading.Event()
        self._stopped.set()  # not running yet
        self._closed = False
        self._thread_id: Optional[int] = None
        self._pool_size = max(1, int(pool_size))
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- executor ------------------------------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self._pool_size, thread_name_prefix=f"{self.name}-pool")
        return self._executor

    def defer(self, fn: Callable, done: Callable) -> None:
        """Run `fn()` on the executor; deliver `done(result, exc)` back
        on the loop thread."""

        def _run():
            try:
                result, exc = fn(), None
            except BaseException as e:  # noqa: BLE001 — delivered to `done`
                result, exc = None, e
            self.call_soon(lambda: done(result, exc))

        self._pool().submit(_run)

    # -- cross-thread scheduling ---------------------------------------
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass  # full: a wakeup is pending already; closed: shutting down

    def call_soon(self, fn: Callable[[], None]) -> None:
        self._pending.append(fn)
        if threading.get_ident() != self._thread_id:
            self._wake()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> _Timer:
        t = _Timer(time.monotonic() + max(0.0, float(delay_s)), fn)
        self.call_soon(lambda: heapq.heappush(self._timers,
                                              (t.when, next(self._timer_seq), t)))
        return t

    # -- the loop ------------------------------------------------------
    def run(self) -> None:
        """Run the loop on the calling thread until `stop()`."""
        self._thread_id = threading.get_ident()
        self._stop_evt.clear()
        self._stopped.clear()
        try:
            while not self._stop_evt.is_set():
                self._run_pending()
                timeout = self._fire_timers()
                try:
                    events = self._sel.select(timeout)
                except OSError:
                    break  # the selector closed under us
                if events:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
        finally:
            self._thread_id = None
            self._stopped.set()

    def _run_pending(self) -> None:
        for _ in range(len(self._pending)):
            fn = self._pending.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — one callback must not stop the loop
                METRICS.add("eventloop.callback_errors")

    def _fire_timers(self) -> Optional[float]:
        now = time.monotonic()
        timeout: Optional[float] = None
        while self._timers:
            when, _, timer = self._timers[0]
            if timer.cancelled:
                heapq.heappop(self._timers)
                continue
            if when > now:
                timeout = min(when - now, 5.0)
                break
            heapq.heappop(self._timers)
            try:
                timer.fn()
            except Exception:  # noqa: BLE001 — one timer must not stop the loop
                METRICS.add("eventloop.callback_errors")
            now = time.monotonic()
        if self._pending:
            return 0.0  # callbacks queued meanwhile: do not park
        return timeout  # None: park until a wakeup

    # -- lifecycle -----------------------------------------------------
    def stop(self) -> None:
        self._stop_evt.set()
        self._wake()

    def wait_stopped(self, timeout: float = 10.0) -> bool:
        return self._stopped.wait(timeout)

    def close(self, wait: bool = False) -> None:
        """Release the wakeup pair and the selector, and shut the
        executor down (`wait`: until its running work has finished)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError, OSError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        self._sel.close()
        if self._executor is not None:
            self._executor.shutdown(wait=wait)
