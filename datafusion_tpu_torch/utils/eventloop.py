"""Selector event loop for the serving front door and the worker (the
JAX package's `utils/eventloop.py`, less its HTTP connection).

ONE selector thread owns every socket (accept, read, write readiness
via `selectors`), complete requests dispatch to a small bounded
executor, and a connection that waits costs a file descriptor, not a
thread.

- `ServerLoop`     the selector thread: readiness dispatch, monotonic
                   timers (`call_later`), cross-thread `call_soon` via a
                   socket-pair wakeup, listening sockets (`listen`), and
                   a bounded executor for blocking work (`defer`).
                   serve.py's front door runs on it with no socket.
- `Connection`     one non-blocking socket: buffered reads feed the
                   protocol, writes queue and flush on writability.
- `WireConnection` the length-prefixed CRC'd frames of
                   `parallel/wire.py`; messages dispatch strictly in
                   order per connection, a reply may come later and from
                   any thread (`reply`, `defer_reply`, `abort`).
- `LoopServer`     the socketserver-shaped facade the worker serves
                   through (`serve_forever`, `shutdown`, `server_close`,
                   `server_address`).

The fault sites of the blocking wire path run here too: inbound frames
pass ``wire.recv`` / ``wire.recv.payload``, outbound replies pass
``wire.send`` (testing/faults.py).  The JAX package's `HttpConnection`
serves only its debug HTTP plane, which waits for ROADMAP item 13.2.
"""

from __future__ import annotations

import heapq
import itertools
import os
import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS

_READ_CHUNK = 1 << 18


def default_pool_size() -> int:
    """Executor width for one server's blocking work (fragment
    execution): the CPU count clamped to [4, 16].  The pool is the
    compute concurrency cap; connections cost no threads."""
    return max(4, min(16, (os.cpu_count() or 4)))


class _Timer:
    __slots__ = ("when", "fn", "cancelled")

    def __init__(self, when: float, fn: Callable[[], None]):
        self.when = when
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class ServerLoop:
    """One selector thread and one bounded executor, shared by every
    connection of one server."""

    def __init__(self, pool_size: Optional[int] = 4, name: str = "df-torch-loop"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._pending: deque = deque()
        self._timers: list[tuple[float, int, _Timer]] = []
        self._timer_seq = itertools.count()
        self._stop_evt = threading.Event()
        self._stopped = threading.Event()
        self._stopped.set()  # not running yet
        self._closed = False
        self._thread_id: Optional[int] = None
        self._listeners: list[socket.socket] = []
        self._conns: set = set()
        self._pool_size = max(1, int(pool_size or default_pool_size()))
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

    def on_loop_thread(self) -> bool:
        return threading.get_ident() == self._thread_id

    # -- listeners -----------------------------------------------------
    def listen(self, host: str, port: int, conn_factory) -> socket.socket:
        """Bind and register a listening socket whose accepted
        connections are wrapped by ``conn_factory(loop, sock, addr)``."""
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            lsock.bind((host, int(port)))
        except OSError:
            lsock.close()
            raise
        lsock.listen(256)
        lsock.setblocking(False)
        self._sel.register(lsock, selectors.EVENT_READ, ("accept", conn_factory))
        self._listeners.append(lsock)
        return lsock

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
                for key, mask in events:
                    kind, payload = key.data
                    if kind == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except OSError:
                            pass
                    elif kind == "accept":
                        self._accept(key.fileobj, payload)
                    else:  # a Connection
                        payload.on_ready(mask)
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
        return timeout  # None: park until IO or a wakeup

    def _accept(self, lsock, conn_factory) -> None:
        for _ in range(64):  # drain the backlog without starving IO
            try:
                sock, addr = lsock.accept()
            except OSError:
                return
            try:
                conn = conn_factory(self, sock, addr)
            except Exception:  # noqa: BLE001 — a bad handshake must not stop accept
                METRICS.add("eventloop.accept_errors")
                sock.close()
                continue
            self._conns.add(conn)

    # -- lifecycle -----------------------------------------------------
    def stop(self) -> None:
        self._stop_evt.set()
        self._wake()

    def wait_stopped(self, timeout: float = 10.0) -> bool:
        return self._stopped.wait(timeout)

    def close(self, wait: bool = False) -> None:
        """Close the connections and listeners, release the wakeup pair
        and the selector, and shut the executor down (`wait`: until its
        running work has finished)."""
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns):
            conn.close()
        for lsock in self._listeners:
            try:
                self._sel.unregister(lsock)
            except (KeyError, ValueError, OSError):
                pass
            lsock.close()
        self._listeners.clear()
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError, OSError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        try:
            self._sel.close()
        except OSError:
            pass
        if self._executor is not None:
            self._executor.shutdown(wait=wait)


class Connection:
    """One non-blocking socket on a `ServerLoop`.  Subclasses implement
    `data_received(bytes)` and may override `eof_received()`."""

    def __init__(self, loop: ServerLoop, sock: socket.socket, addr):
        self.loop = loop
        self.sock = sock
        self.addr = addr
        self.closed = False
        self._out: deque = deque()
        self._mask = selectors.EVENT_READ
        sock.setblocking(False)
        loop._sel.register(sock, self._mask, ("conn", self))

    # -- loop callbacks ------------------------------------------------
    def on_ready(self, mask: int) -> None:
        if self.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush()
        if mask & selectors.EVENT_READ:
            self._read()

    def _read(self) -> None:
        while not self.closed:
            try:
                data = self.sock.recv(_READ_CHUNK)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self.close()
                return
            if not data:
                self.eof_received()
                return
            try:
                self.data_received(data)
            except (ConnectionError, OSError, ExecutionError):
                # an unparseable stream or an injected wire fault: this
                # connection is done, the server is not
                self.close()
                return
            except Exception:  # noqa: BLE001 — a bad frame must not stop the loop
                METRICS.add("eventloop.protocol_errors")
                self.close()
                return

    def eof_received(self) -> None:
        self.close()

    def data_received(self, data: bytes) -> None:  # pragma: no cover — interface
        raise NotImplementedError

    # -- writes --------------------------------------------------------
    def _write_now(self, chunks) -> None:
        if self.closed:
            return
        self._out.extend(memoryview(c).cast("B") for c in chunks)
        self._flush()

    def _flush(self) -> None:
        while self._out and not self.closed:
            head = self._out[0]
            try:
                n = self.sock.send(head)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.close()
                return
            if n < len(head):
                self._out[0] = head[n:]
                break
            self._out.popleft()
        self._set_writable(bool(self._out))

    def _set_writable(self, want: bool) -> None:
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        if mask != self._mask and not self.closed:
            self._mask = mask
            try:
                self.loop._sel.modify(self.sock, mask, ("conn", self))
            except (KeyError, ValueError, OSError):
                pass

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        if not self.loop.on_loop_thread() and not self.loop._stopped.is_set():
            self.loop.call_soon(self._close_now)
        else:
            self._close_now()

    def _close_now(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.loop._sel.unregister(self.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.loop._conns.discard(self)
        self.connection_closed()

    def connection_closed(self) -> None:
        """Hook: the connection is gone."""


class WireConnection(Connection):
    """Length-prefixed wire frames, strictly ordered per connection.

    ``on_message(conn, msg)`` runs on the loop thread for one decoded
    message at a time and must not block; it answers with
    ``conn.reply(msg, out, bw)`` (any thread, any time), runs blocking
    work with ``conn.defer_reply(msg, fn)``, or drops the connection
    with ``conn.abort()``.  The next queued message dispatches only
    after the previous one's reply is queued."""

    def __init__(self, loop, sock, addr, on_message):
        self._buf = bytearray()
        self._backlog: deque = deque()
        self._inflight = False
        self._on_message = on_message
        super().__init__(loop, sock, addr)

    def data_received(self, data: bytes) -> None:
        from datafusion_tpu_torch.parallel.wire import _LEN, MAX_FRAME, parse_frame

        self._buf.extend(data)
        while True:
            if len(self._buf) < _LEN.size:
                break
            (n,) = _LEN.unpack(self._buf[:_LEN.size])
            if n > MAX_FRAME:
                raise ExecutionError(f"frame of {n} bytes exceeds protocol limit")
            if len(self._buf) < _LEN.size + n:
                break
            faults.check("wire.recv")
            payload = self._buf[_LEN.size:_LEN.size + n]
            del self._buf[:_LEN.size + n]
            payload = faults.corrupt("wire.recv.payload", payload)
            self._backlog.append(parse_frame(payload))
        self._pump()

    def _pump(self) -> None:
        if self._inflight or not self._backlog or self.closed:
            return
        self._inflight = True
        msg = self._backlog.popleft()
        try:
            self._on_message(self, msg)
        except Exception:  # noqa: BLE001 — a broken handler must not stop the loop
            METRICS.add("eventloop.handler_errors")
            self.abort()

    def reply(self, msg: dict, out: dict, bw=None) -> None:
        """Answer `msg` (thread-safe); CRCs follow the request's
        wire-version handshake."""
        from datafusion_tpu_torch.parallel.wire import crc_for_peer, encode_frame

        try:
            faults.check("wire.send", type=out.get("type"))
            chunks = encode_frame(out, bw, crc=crc_for_peer(msg))
        except Exception:  # noqa: BLE001 — an injected send fault or an encode error
            self.abort()
            return
        if self.loop.on_loop_thread():
            self._reply_now(chunks)
        else:
            self.loop.call_soon(lambda: self._reply_now(chunks))

    def _reply_now(self, chunks) -> None:
        self._inflight = False
        self._write_now(chunks)
        self._pump()

    def abort(self) -> None:
        """Close without a response (the peer sees a mid-request EOF,
        as from a killed process)."""
        self.close()

    def defer_reply(self, msg: dict, fn) -> None:
        """Run ``fn() -> (out, bw)`` on the executor and reply with its
        result; an `InjectedConnectionAbort` (or any exception the
        handler did not turn into an error reply) aborts the
        connection."""

        def _done(result, exc):
            if exc is not None:
                if not isinstance(exc, faults.InjectedConnectionAbort):
                    METRICS.add("eventloop.handler_errors")
                self.abort()
                return
            out, bw = result
            self.reply(msg, out, bw)

        self.loop.defer(fn, _done)

    def connection_closed(self) -> None:
        self._backlog.clear()
        self._inflight = False


class LoopServer:
    """The socketserver lifecycle over a `ServerLoop`: construct (socket
    bound, address readable), `serve_forever()` on a caller thread,
    `shutdown()` from any thread (blocks until the loop exits),
    `server_close()` to release the sockets."""

    def __init__(self, loop: ServerLoop, lsock: socket.socket):
        self.loop = loop
        self._lsock = lsock
        self._started = False

    @property
    def server_address(self):
        try:
            return self._lsock.getsockname()
        except OSError:
            return ("0.0.0.0", 0)

    def serve_forever(self) -> None:
        self._started = True
        self.loop.run()

    def shutdown(self) -> None:
        self.loop.stop()
        if self._started:
            self.loop.wait_stopped()

    def server_close(self) -> None:
        if self._started and not self.loop._stopped.is_set():
            self.shutdown()
        self.loop.close()
