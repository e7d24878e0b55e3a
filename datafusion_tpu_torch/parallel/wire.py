"""Coordinator<->worker wire protocol (the JAX package's
`parallel/wire.py`, whole: numpy only).

In the port its frames are the records of the write-ahead log
(`utils/wal.py`), the ingest log's column blocks (`ingest/`) and the
messages between the coordinator and its workers (parallel/); a frame
`recv_msg` reads counts its bytes in ``wire.bytes_received``.

The reference planned HTTP + Arrow IPC between console and worker nodes
(`README.md:33`, worker image EXPOSE 8080 in
`scripts/docker/worker/Dockerfile`); here the transport is a
length-prefixed frame over TCP.  Control payloads (plan fragments)
keep their JSON wire format (`logicalplan.rs:609-648`'s contract);
bulk array payloads travel as RAW little-endian binary segments after
the JSON — base64-in-JSON cost +33% bytes plus an encode/parse pass on
the result-shipping path.

Frame layouts (after the 8-byte big-endian frame length):
- legacy:   UTF-8 JSON (first byte '{') — still accepted and still
  emitted for messages carrying no bulk arrays.
- binary:   0x01 | u32 json_len | JSON | raw segments back-to-back.
  The JSON's "_bins" key lists segment byte lengths in order; array
  nodes reference segments as {"dtype", "shape", "bin": i}.  Tiny
  arrays stay inline base64 — a segment's framing overhead outweighs
  its bytes below ~256 B.

Integrity: the JSON region fails loudly on corruption (it stops
parsing), but a bit-flip inside a RAW segment used to parse fine and
silently poison the merge.  Senders on wire version >= 2 add a CRC32
per segment (`"_crc32"` next to `"_bins"`); receivers verify every
listed CRC and surface a mismatch as `ProtocolError` — which subclasses
ConnectionError, so the coordinator's existing failover path replays
the fragment elsewhere.  The gate is a handshake, not a flag day:
requests advertise `"wire_version"`, and a worker only emits CRCs for
peers that advertised >= 2 (old peers ignore the unknown key anyway).
`DATAFUSION_TPU_WIRE_CRC=0` disables emission for A/B measurements.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import zlib
from typing import Optional

import numpy as np

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.testing import faults

import os


class ProtocolError(ConnectionError):
    """A frame arrived but cannot parse (corrupted stream, protocol
    mismatch).  Subclasses ConnectionError on purpose: the stream is
    unusable from here on, and the coordinator's failover handler keys
    on ConnectionError/OSError — a garbled peer should fail over, not
    crash the query."""


_LEN = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_TAG_BIN = 0x01
MAX_FRAME = 1 << 32
# arrays at or under this many bytes stay inline base64 (segment
# framing overhead outweighs the bytes); the env knob exists for
# protocol A/B measurements
INLINE_MAX = int(os.environ.get("DATAFUSION_TPU_WIRE_INLINE", 256))
# protocol version this build speaks: 2 = per-segment CRC32 supported.
# Requests advertise it ("wire_version"); responders emit CRCs only for
# peers that advertised >= 2.
WIRE_VERSION = 2
CRC_ENABLED = os.environ.get("DATAFUSION_TPU_WIRE_CRC", "1") not in ("0", "false")


def crc_for_peer(msg: dict) -> bool:
    """Should a response to `msg` carry segment CRCs?  (the
    wire-version handshake, receiver side)"""
    try:
        return CRC_ENABLED and int(msg.get("wire_version", 1)) >= 2
    except (TypeError, ValueError):
        return False


class BinWriter:
    """Collects bulk array segments for one outgoing message as
    zero-copy buffer views (the views pin their source arrays)."""

    __slots__ = ("chunks",)

    def __init__(self) -> None:
        self.chunks: list = []  # buffer-protocol objects


def encode_frame(obj: dict, bw: Optional[BinWriter] = None,
                 crc: bool = False) -> list:
    """One message -> the ordered wire chunks of one frame (length
    prefix first, then header+JSON, then the raw segments streaming
    straight from their source arrays — no intermediate frame buffer).
    Shared by the blocking `send_msg` and the selector event servers,
    whose non-blocking writers queue the chunks instead of sendall'ing
    them."""
    if bw is not None and bw.chunks:
        sizes = [memoryview(c).nbytes for c in bw.chunks]
        obj = dict(obj)
        obj["_bins"] = sizes
        if crc:
            obj["_crc32"] = [zlib.crc32(c) & 0xFFFFFFFF for c in bw.chunks]
        data = json.dumps(obj).encode("utf-8")
        frame_len = 1 + _U32.size + len(data) + sum(sizes)
        head = (_LEN.pack(frame_len) + bytes([_TAG_BIN])
                + _U32.pack(len(data)) + data)
        return [head, *bw.chunks]
    data = json.dumps(obj).encode("utf-8")
    return [_LEN.pack(len(data)) + data]


def frame_nbytes(chunks: list) -> int:
    """Total wire bytes of an `encode_frame` result."""
    return sum(memoryview(c).nbytes for c in chunks)


def send_msg(sock: socket.socket, obj: dict, bw: Optional[BinWriter] = None,
             crc: bool = False) -> int:
    """Send one frame; returns the total bytes written (callers like
    the shared-tier publisher account wire cost from this)."""
    faults.check("wire.send", type=obj.get("type"))
    # a sender holding an engine lock would stall its contenders for a
    # full network write — lockcheck records any lock held across this
    lockcheck.note_blocking("wire.send")
    chunks = encode_frame(obj, bw, crc)
    for c in chunks:
        sock.sendall(c)
    return frame_nbytes(chunks)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    # returns the bytearray itself (no bytes() copy): binary segments
    # become writable zero-copy views into the frame buffer
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))  # df-lint: ok(DF003) — helper under recv_msg's wire.recv site
        if not chunk:
            return None
        buf.extend(chunk)
    return buf


def _attach_bins(node, bins: list) -> None:
    """Resolve {"bin": i} array nodes to their binary segments (stored
    under "_buf" for dec_array)."""
    if isinstance(node, dict):
        if "bin" in node and "dtype" in node:
            node["_buf"] = bins[node["bin"]]
            return
        for v in node.values():
            _attach_bins(v, bins)
    elif isinstance(node, list):
        for v in node:
            _attach_bins(v, bins)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """One frame, or None on clean EOF."""
    faults.check("wire.recv")
    lockcheck.note_blocking("wire.recv")
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ExecutionError(f"frame of {n} bytes exceeds protocol limit")
    data = _recv_exact(sock, n)
    if data is None:
        # ConnectionError (not ExecutionError): a peer dying mid-frame
        # is a transport failure, and the coordinator's failover
        # handler keys on ConnectionError/OSError
        raise ConnectionError("connection closed mid-frame")
    data = faults.corrupt("wire.recv.payload", data)
    from datafusion_tpu_torch.utils.metrics import METRICS

    METRICS.add("wire.bytes_received", _LEN.size + n)
    return parse_frame(data)


def parse_frame(data) -> dict:
    """Decode one complete frame payload (everything AFTER the 8-byte
    length prefix) into a message dict, attaching binary segments as
    zero-copy views.  Pure — the caller owns socket reads and fault
    injection, so the selector event servers share the exact decode
    (CRC verification included) the blocking path runs."""
    try:
        if data[:1] == bytes([_TAG_BIN]):
            (json_len,) = _U32.unpack(data[1 : 1 + _U32.size])
            body_off = 1 + _U32.size
            obj = json.loads(data[body_off : body_off + json_len].decode("utf-8"))
            blob = memoryview(data)[body_off + json_len :]
            bins = []
            off = 0
            for size in obj.get("_bins", []):
                if not isinstance(size, int) or size < 0 or off + size > len(blob):
                    raise ValueError(f"bad binary segment length {size!r}")
                bins.append(blob[off : off + size])
                off += size
            crcs = obj.get("_crc32")
            if crcs is not None:
                # verify BEFORE segments attach to array nodes: a flipped
                # RAW byte must fail loudly, never poison a merge
                if not isinstance(crcs, list) or len(crcs) != len(bins):
                    raise ValueError(
                        f"CRC list shape mismatch ({crcs!r} for "
                        f"{len(bins)} segments)"
                    )
                for i, (want, seg) in enumerate(zip(crcs, bins)):
                    if zlib.crc32(seg) & 0xFFFFFFFF != want:
                        raise ValueError(
                            f"CRC32 mismatch in binary segment {i}"
                        )
            _attach_bins(obj, bins)
            return obj
        return json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError, struct.error) as e:
        # a frame that cannot parse means the stream is garbage
        # (corruption, desync, protocol mismatch) — every later frame
        # boundary is suspect too, so surface a connection-level error
        raise ProtocolError(f"unparseable frame ({len(data)} bytes): {e}") from e


def enc_array(a: np.ndarray, bw: Optional[BinWriter] = None) -> dict:
    a = np.ascontiguousarray(a)
    if bw is not None and a.nbytes > INLINE_MAX:
        idx = len(bw.chunks)
        bw.chunks.append(memoryview(a).cast("B"))  # zero-copy, pins `a`
        return {"dtype": a.dtype.str, "shape": list(a.shape), "bin": idx}
    return {
        "dtype": a.dtype.str,  # byte-order explicit ('<i8', '|b1', ...)
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def dec_array(o: dict) -> np.ndarray:
    if "bin" in o:
        # zero-copy: a writable view into the received frame buffer
        # (segments are disjoint, and the buffer lives as long as the
        # arrays reference it)
        return np.frombuffer(o["_buf"], dtype=np.dtype(o["dtype"])).reshape(
            o["shape"]
        )
    raw = base64.b64decode(o["data"])
    return (
        np.frombuffer(raw, dtype=np.dtype(o["dtype"]))
        .reshape(o["shape"])
        .copy()  # frombuffer is read-only; combiners mutate
    )
