"""PyTorch/CUDA port: the selector event loop's connections
(`datafusion_tpu_torch.utils.eventloop`: `WireConnection`, `LoopServer`)
and the worker server riding them, with the cases of
tests/test_eventloop.py that touch them.

Frames round-trip in order on one connection, a parked reply answers
after its timer, a server shuts down without having served, a large
binary frame with CRCs round-trips, the frame bytes are the JAX
package's, hundreds of parked connections cost no threads, and a JAX
client and the port's server speak one protocol (a port worker answers
the JAX package's `WorkerHandle`).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest

from datafusion_tpu.parallel import wire as jax_wire

from datafusion_tpu_torch.parallel.wire import (
    BinWriter,
    dec_array,
    enc_array,
    encode_frame,
    recv_msg,
    send_msg,
)
from datafusion_tpu_torch.utils.eventloop import (
    LoopServer,
    ServerLoop,
    WireConnection,
    default_pool_size,
)


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _echo_server():
    loop = ServerLoop(name="test-echo")

    def on_message(conn, msg):
        if msg.get("type") == "park":
            loop.call_later(float(msg.get("delay_s", 0.05)),
                            lambda: conn.reply(msg, {"type": "parked_reply",
                                                     "n": msg.get("n")}))
            return
        if msg.get("type") == "sum":
            arr = dec_array(msg["payload"])
            bw = BinWriter()
            conn.reply(msg, {"type": "sum", "total": int(arr.sum()),
                             "echo": enc_array(arr, bw)}, bw)
            return
        conn.reply(msg, {"type": "echo", "n": msg.get("n")})

    lsock = loop.listen("127.0.0.1", 0, lambda lp, s, a: WireConnection(lp, s, a, on_message))
    return LoopServer(loop, lsock)


@pytest.fixture
def echo():
    server = _echo_server()
    _start(server)
    yield server.server_address[:2]
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("codec", ["port", "jax"])
def test_frame_roundtrip_and_ordering(echo, codec):
    """Pipelined frames on one connection answer in order, whichever
    package's codec the client speaks."""
    send, recv = ((send_msg, recv_msg) if codec == "port"
                  else (jax_wire.send_msg, jax_wire.recv_msg))
    with socket.create_connection(echo, timeout=5) as s:
        s.settimeout(5.0)
        for i in range(5):
            send(s, {"type": "echo", "n": i})
        for i in range(5):
            assert recv(s) == {"type": "echo", "n": i}


def test_parked_reply_after_timer(echo):
    with socket.create_connection(echo, timeout=5) as s:
        s.settimeout(5.0)
        send_msg(s, {"type": "park", "n": 7, "delay_s": 0.05})
        t0 = time.monotonic()
        out = recv_msg(s)
        assert out["type"] == "parked_reply" and out["n"] == 7
        assert time.monotonic() - t0 >= 0.04


def test_shutdown_without_serve_forever():
    server = _echo_server()
    server.shutdown()
    server.server_close()


def test_large_binary_frame_roundtrip(echo):
    a = np.arange(300_000, dtype=np.int64)
    with socket.create_connection(echo, timeout=10) as s:
        s.settimeout(10.0)
        bw = BinWriter()
        send_msg(s, {"type": "sum", "wire_version": 2, "payload": enc_array(a, bw)},
                 bw, crc=True)
        out = recv_msg(s)
    assert out["total"] == int(a.sum())
    np.testing.assert_array_equal(dec_array(out["echo"]), a)


def test_frame_bytes_are_the_jax_packages():
    msg = {"type": "x", "v": 1, "s": "über"}
    port = b"".join(bytes(memoryview(c).cast("B")) for c in encode_frame(msg))
    jax = b"".join(bytes(memoryview(c).cast("B")) for c in jax_wire.encode_frame(msg))
    assert port == jax


def test_parked_connections_cost_no_threads(echo):
    """Hundreds of connections parked on timers: the thread count grows
    by the executor pool at most, not by the connections."""
    before = threading.active_count()
    socks = []
    try:
        for i in range(200):
            s = socket.create_connection(echo, timeout=10)
            s.settimeout(30.0)
            send_msg(s, {"type": "park", "n": i, "delay_s": 0.5})
            socks.append(s)
        grown = threading.active_count() - before
        assert grown <= default_pool_size() + 2, grown
        for i, s in enumerate(socks):
            assert recv_msg(s) == {"type": "parked_reply", "n": i}
    finally:
        for s in socks:
            s.close()


def test_port_worker_answers_the_jax_handle():
    """The port's worker server on the loop: ping and status through
    the JAX package's `WorkerHandle`, then a `shutdown` request stops
    the loop."""
    from datafusion_tpu.parallel.coordinator import WorkerHandle as JaxHandle

    from datafusion_tpu_torch.parallel.worker import serve

    server = serve("127.0.0.1:0", device="cpu")
    t = _start(server)
    try:
        handle = JaxHandle(*server.server_address[:2])
        assert handle.probe()
        status = handle.status()
        assert status["device"] == "cpu" and "kernels" in status
        with pytest.raises(Exception, match="telemetry"):
            handle.request({"type": "telemetry"}, timeout=5.0)
        assert handle.request({"type": "shutdown"}, timeout=5.0)["type"] == "bye"
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        server.server_close()
