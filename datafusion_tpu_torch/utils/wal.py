"""Segment-file write-ahead log (the JAX package's `utils/wal.py`).

The port writes the same bytes as the JAX package for the same records,
so either package recovers a log the other wrote.  In the port it backs
the ingest log (`ingest/`), the serving pin manifest (`atomic_write_json`,
serve.py) and the cluster control plane (`cluster/service.ClusterNode`),
whose rate-limited lease-deadline notes (`note_deadlines`) recovery
returns beside the events, with `deadline_cutoff_rev`.

The reference scaffolded etcd for durability and never enabled it
(`scripts/smoketest.sh:30-66` brings the container up, nothing writes
to it).  This module supplies the missing piece natively: `ClusterNode`
appends every replication event here *before* quorum-ack, writes
periodic compacted snapshots beside the log, and replays both at boot —
crash-only recovery in the FoundationDB style, with every disk
operation behind a deterministic fault site so seeded chaos plans can
exercise short writes, torn records, ENOSPC, and crash points.

On-disk layout (one directory per node — never share a WAL dir):

    wal-00000001.seg      append-only record segments, rotated at
    wal-00000002.seg      `DATAFUSION_TPU_WAL_SEGMENT_BYTES`
    snapshot-00000512.snap latest compacted snapshot (rev in the name)
    *.tmp                 in-flight snapshot writes (crash leftovers
                          are reaped on recovery)

Record format — one `parallel/wire.py` frame per record, with a
whole-record CRC spliced between the length prefix and the payload:

    u64 payload_len | u32 crc32(payload) | payload

`payload` is exactly the bytes `wire.encode_frame` emits after its
8-byte length prefix (JSON, or 0x01-tagged JSON + raw array segments
with per-segment CRCs), so recovery decodes through `wire.parse_frame`
— the same CRC-verified path replication frames take.  The outer CRC
is what detects a torn tail: recovery truncates each segment at the
last record whose length, CRC, and parse all check out.

Fsync policy (`DATAFUSION_TPU_WAL_SYNC`): `always` fsyncs after every
append batch (an acked write is on disk before the ack), `interval`
fsyncs at most every `DATAFUSION_TPU_WAL_SYNC_INTERVAL_S` seconds
(bounded loss window), `off` leaves flushing to the OS (crash-safe in
format only).  Snapshots are always written tmp -> fsync -> rename;
segments a snapshot covers are reaped only after the rename lands.

Locking: the log's internal mutex serializes appenders and is the one
place in the tree allowed to hold a lock across disk IO — this module
is the reviewed disk-IO boundary (the DF008 lint rule exempts it, the
way `parallel/wire.py` is the socket boundary for DF003).  Callers
must NOT hold cluster locks here; `note_blocking` is recorded before
acquisition so lockcheck flags any caller that does.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import weakref
import zlib
from typing import Callable, Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.parallel.wire import (
    BinWriter,
    MAX_FRAME,
    ProtocolError,
    encode_frame,
    parse_frame,
)
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.metrics import METRICS

_LEN = struct.Struct(">Q")
_U32 = struct.Struct(">I")

DEFAULT_SEGMENT_BYTES = 4 << 20
DEFAULT_SNAPSHOT_BYTES = 8 << 20
DEFAULT_SYNC_INTERVAL_S = 0.05
DEFAULT_DEADLINE_S = 1.0

# live logs, for the debug bundle's durability manifests
_ACTIVE: list = []


def wal_dir_from_env() -> Optional[str]:
    """The node's log directory (`DATAFUSION_TPU_WAL_DIR`), or None:
    durability off, the default."""
    return os.environ.get("DATAFUSION_TPU_WAL_DIR") or None


def active_manifests() -> list:
    """Manifests of every live log in this process (obs/httpd.py's
    debug bundle)."""
    out = []
    for ref in list(_ACTIVE):
        log = ref()
        if log is not None and not log.closed:
            out.append(log.manifest())
    return out


def atomic_write_json(path: str, doc: dict, *, site: str = "snapshot.write") -> None:
    """Write `doc` as JSON via tmp -> fsync -> rename so readers never
    observe a torn file (the pin manifest uses this; crash mid-write
    leaves the old manifest intact).  Goes through the same fault
    sites as snapshot writes so chaos plans cover it."""
    lockcheck.note_blocking("wal.manifest")  # callers must hold no lock
    faults.check(site, path=path)
    tmp = path + ".tmp"
    data = json.dumps(doc, indent=2).encode("utf-8")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, faults.corrupt(site, data))
        faults.check("wal.fsync", path=tmp)
        os.fsync(fd)
    finally:
        os.close(fd)
    faults.check("wal.rename", path=path)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[dict]:
    """Best-effort read of an `atomic_write_json` file: missing or
    corrupt (torn by a fault rule, partial disk) -> None, never raise —
    recovery treats a bad manifest as an empty one."""
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None


def _fsync_dir(dirpath: str) -> None:
    # make the rename itself durable; best-effort on filesystems that
    # refuse O_RDONLY directory fsync
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class WriteAheadLog:
    """One node's durable event log + snapshot store.

    `recover()` must run (once) before the first `append`; it scans the
    newest valid snapshot plus every segment record past it, truncates
    torn tails in place, and primes `last_rev` so appends dedup
    re-offered events.  All public methods are thread-safe.
    """

    def __init__(
        self,
        dirpath: str,
        *,
        sync: Optional[str] = None,
        segment_bytes: Optional[int] = None,
        snapshot_bytes: Optional[int] = None,
        deadline_interval_s: Optional[float] = None,
    ) -> None:
        self.dir = os.path.abspath(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        self.sync = sync or os.environ.get("DATAFUSION_TPU_WAL_SYNC", "always")
        if self.sync not in ("always", "interval", "off"):
            raise ValueError(f"bad WAL sync policy {self.sync!r}")
        self.sync_interval_s = float(
            os.environ.get("DATAFUSION_TPU_WAL_SYNC_INTERVAL_S",
                           DEFAULT_SYNC_INTERVAL_S))
        self.segment_bytes = int(
            segment_bytes
            or os.environ.get("DATAFUSION_TPU_WAL_SEGMENT_BYTES",
                              DEFAULT_SEGMENT_BYTES))
        self.snapshot_bytes = int(
            snapshot_bytes
            or os.environ.get("DATAFUSION_TPU_WAL_SNAPSHOT_BYTES",
                              DEFAULT_SNAPSHOT_BYTES))
        self.deadline_interval_s = float(
            deadline_interval_s
            if deadline_interval_s is not None
            else os.environ.get("DATAFUSION_TPU_WAL_DEADLINE_S",
                                DEFAULT_DEADLINE_S))
        # the internal mutex is the reviewed held-across-IO exception
        # (module docstring); deliberately NOT lockcheck-tracked as a
        # cluster lock would be — note_blocking before acquire (below)
        # is what catches callers holding engine locks into here.
        self._lock = threading.Lock()
        self._file = None  # open append handle of the live segment
        self._seq = 0  # live segment sequence number
        self._seg_sizes: dict = {}  # seq -> bytes on disk
        self._seg_max_rev: dict = {}  # seq -> highest event rev inside
        self._pending_sync = False
        self._last_fsync = time.monotonic()
        self._last_deadline_note = 0.0
        self.last_rev = 0  # highest event rev durably appended
        self.snapshot_rev = 0  # rev of the newest on-disk snapshot
        self.recovery: dict = {}  # stats from the last recover()
        self.closed = False
        self.appends = 0
        self.fsyncs = 0
        self.bytes_written = 0
        # coverage cutoff of the recovered deadline set: leases granted
        # at rev <= this but absent from the recovered deadlines were
        # expired (or gone) when the note was taken; recovery re-arms
        # them at zero, never at a fresh full TTL
        self.deadline_cutoff_rev = 0
        _ACTIVE[:] = [r for r in _ACTIVE if r() is not None]
        _ACTIVE.append(weakref.ref(self))

    # -- paths ---------------------------------------------------------

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal-{seq:08d}.seg")

    def _snap_path(self, rev: int) -> str:
        return os.path.join(self.dir, f"snapshot-{rev:08d}.snap")

    def _list(self, prefix: str, suffix: str) -> list:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if name.startswith(prefix) and name.endswith(suffix):
                try:
                    out.append((int(name[len(prefix):-len(suffix)]), name))
                except ValueError:
                    continue
        out.sort()
        return out

    # -- recovery ------------------------------------------------------

    def recover(self):
        """Scan snapshot + segments -> (snapshot_doc | None, events,
        deadlines).  Torn tails are truncated in place; events the
        snapshot already covers are skipped (revs are strictly
        increasing but NOT contiguous — entry revisions interleave
        event revisions, so coverage is by ordering, never by
        counting).  A tear in a NON-final segment means every later
        segment was written on top of lost history: their events are
        dropped rather than silently replayed over a hole."""
        t0 = time.perf_counter()
        lockcheck.note_blocking("wal.recover")
        with self._lock:
            snap_doc, snap_rev = self._load_snapshot()
            self.snapshot_rev = snap_rev
            events: list = []
            deadlines: dict = {}
            cutoff = snap_rev
            if snap_doc is not None:
                deadlines = dict(snap_doc.get("lease_deadlines") or {})
            torn = 0
            dropped = 0
            last = snap_rev
            segs = self._list("wal-", ".seg")
            gap = False
            for seq, name in segs:
                path = os.path.join(self.dir, name)
                records, good_size, was_torn = self._scan_segment(path)
                torn += was_torn
                self._seg_sizes[seq] = good_size
                max_rev = 0
                for rec in records:
                    if rec.get("kind") == "_deadlines":
                        if not gap:
                            deadlines = dict(rec.get("deadlines") or {})
                            cutoff = int(rec.get("last_rev") or 0)
                        continue
                    rev = int(rec.get("rev") or 0)
                    max_rev = max(max_rev, rev)
                    if gap or rev <= last:
                        if gap and rev > last:
                            dropped += 1
                        continue
                    events.append(rec)
                    last = rev
                self._seg_max_rev[seq] = max_rev
                if was_torn and seq != segs[-1][0]:
                    # a mid-log tear: later segments continue a history
                    # whose middle is gone — dropping them is the only
                    # replay that never skips over lost events
                    gap = True
            # clean up crash leftovers from interrupted snapshot writes
            for name in os.listdir(self.dir):
                if name.endswith(".tmp"):
                    try:
                        os.remove(os.path.join(self.dir, name))
                    except OSError:
                        pass
            self._seq = segs[-1][0] if segs else 0
            self.last_rev = last
            self.deadline_cutoff_rev = cutoff
            self.recovery = {
                "snapshot_rev": snap_rev,
                "replayed_events": len(events),
                "torn_tails": torn,
                "dropped_records": dropped,
                "recovered_rev": last,
                "recovery_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }
            METRICS.add("wal.recoveries")
            METRICS.add("wal.recovery_ms",
                        int(self.recovery["recovery_ms"]))
            if torn:
                METRICS.add("wal.torn_tails", torn)
            return snap_doc, events, deadlines

    def _load_snapshot(self):
        """Newest snapshot whose record verifies; invalid ones are
        skipped (an older valid snapshot still recovers the prefix)."""
        for rev, name in reversed(self._list("snapshot-", ".snap")):
            path = os.path.join(self.dir, name)
            try:
                with open(path, "rb") as f:
                    recs, _, torn = self._scan_stream(f)
            except OSError:
                continue
            if recs and not torn and recs[0].get("kind") == "_snapshot":
                return recs[0].get("snapshot"), rev
            METRICS.add("wal.bad_snapshots")
        return None, 0

    def _scan_segment(self, path: str):
        try:
            f = open(path, "r+b")
        except OSError:
            return [], 0, 0
        with f:
            records, good, torn = self._scan_stream(f)
            if torn:
                f.truncate(good)
        return records, good, torn

    def _scan_stream(self, f):
        """Read records until EOF or the first bad one -> (records,
        good_offset, torn).  `good_offset` is where a torn tail gets
        truncated; `torn` is 1 when truncation is needed."""
        records: list = []
        good = 0
        while True:
            head = f.read(_LEN.size + _U32.size)
            if not head:
                return records, good, 0
            if len(head) < _LEN.size + _U32.size:
                return records, good, 1
            (length,) = _LEN.unpack(head[:_LEN.size])
            (want_crc,) = _U32.unpack(head[_LEN.size:])
            if length == 0 or length > MAX_FRAME:
                return records, good, 1
            payload = f.read(length)
            if len(payload) < length:
                return records, good, 1
            if zlib.crc32(payload) & 0xFFFFFFFF != want_crc:
                return records, good, 1
            try:
                records.append(parse_frame(payload))
            except ProtocolError:
                return records, good, 1
            good += _LEN.size + _U32.size + length

    # -- append path ---------------------------------------------------

    def append(self, records) -> None:
        """Durably append `records` — an iterable of (obj, bw|None)
        pairs, obj a JSON-able event dict (result_put events carry
        their encoded value; raw array segments ride in the BinWriter).
        Events at or below `last_rev` are dropped (concurrent syncers
        re-offer overlapping tails).  Raises OSError on disk faults —
        the caller must NOT ack a write whose append raised."""
        lockcheck.note_blocking("wal.append")
        with self._lock:
            wrote = 0
            for obj, bw in records:
                rev = int(obj.get("rev") or 0)
                if rev and rev <= self.last_rev:
                    continue
                self._write_record(obj, bw)
                if rev:
                    self.last_rev = rev
                    self._seg_max_rev[self._seq] = rev
                wrote += 1
            if wrote:
                self.appends += wrote
                METRICS.add("wal.appends", wrote)
                self._maybe_fsync()

    def _write_record(self, obj, bw) -> None:
        chunks = encode_frame(obj, bw, crc=True)
        payload = bytearray(chunks[0][_LEN.size:])
        for seg in chunks[1:]:
            payload += memoryview(seg).cast("B")
        # ONE payload-site hook: `corrupt` applies short-write /
        # torn-record rules to the bytes (the outer CRC, computed on
        # the ORIGINAL bytes, then fails on recovery exactly as a real
        # torn write would) AND fires raise/delay/kill rules itself —
        # a separate `check` here would double-fire payload rules as
        # degraded errors
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        damaged = faults.corrupt("wal.write", bytes(payload),
                                 rev=obj.get("rev"), kind=obj.get("kind"))
        record = _LEN.pack(len(payload)) + _U32.pack(crc) + damaged
        f = self._live_segment(len(record))
        f.write(record)
        self._pending_sync = True
        self._seg_sizes[self._seq] = (
            self._seg_sizes.get(self._seq, 0) + len(record))
        self.bytes_written += len(record)
        METRICS.add("wal.bytes", len(record))

    def _live_segment(self, incoming: int):
        if (self._file is not None
                and self._seg_sizes.get(self._seq, 0) + incoming
                > self.segment_bytes):
            self._rotate()
        if self._file is None:
            if self._seq == 0:
                self._seq = 1
            self._file = open(self._seg_path(self._seq), "ab")
            self._seg_sizes.setdefault(self._seq, 0)
        return self._file

    def _rotate(self) -> None:
        self._sync_file()
        self._file.close()
        self._file = None
        self._seq += 1

    def _maybe_fsync(self) -> None:
        if self.sync == "off" or self._file is None:
            if self._file is not None:
                self._file.flush()
            return
        now = time.monotonic()
        if self.sync == "interval" and (
                now - self._last_fsync < self.sync_interval_s):
            self._file.flush()
            return
        self._sync_file()

    def _sync_file(self) -> None:
        if self._file is None or not self._pending_sync:
            return
        self._file.flush()
        if self.sync != "off":
            faults.check("wal.fsync", seq=self._seq)
            os.fsync(self._file.fileno())
            self.fsyncs += 1
            METRICS.add("wal.fsyncs")
        self._pending_sync = False
        self._last_fsync = time.monotonic()

    def flush(self) -> None:
        """Force an fsync of the live segment regardless of policy
        (clean shutdown; `off` still skips the fsync by contract)."""
        lockcheck.note_blocking("wal.flush")
        with self._lock:
            self._sync_file()

    # -- deadline notes ------------------------------------------------

    def note_deadlines(self, deadlines_fn: Callable[[], dict]) -> bool:
        """Rate-limited persistence of lease remaining-TTLs (recovery
        re-arms from these, never a fresh full TTL).  `deadlines_fn`
        is only invoked when a note is actually due.  Returns True if
        a note was written."""
        now = time.monotonic()
        if now - self._last_deadline_note < self.deadline_interval_s:
            return False
        deadlines = deadlines_fn()
        lockcheck.note_blocking("wal.append")
        with self._lock:
            if now - self._last_deadline_note < self.deadline_interval_s:
                return False
            self._last_deadline_note = now
            if not deadlines and self.last_rev == 0:
                return False
            self._write_record(
                {"kind": "_deadlines", "rev": 0,
                 "last_rev": self.last_rev, "deadlines": deadlines},
                None)
            self._maybe_fsync()
            return True

    # -- snapshots -----------------------------------------------------

    def write_snapshot(self, snap: dict, bw: Optional[BinWriter] = None) -> None:
        """Durably persist a compacted snapshot (tmp -> fsync ->
        rename), then reap every segment it fully covers and every
        older snapshot.  A crash at any point leaves either the old or
        the new snapshot fully intact."""
        rev = int(snap.get("rev") or 0)
        lockcheck.note_blocking("wal.snapshot")
        with self._lock:
            if rev <= self.snapshot_rev:
                return
            faults.check("snapshot.write", rev=rev)
            final = self._snap_path(rev)
            tmp = final + ".tmp"
            chunks = encode_frame({"kind": "_snapshot", "snapshot": snap},
                                  bw, crc=True)
            payload = bytearray(chunks[0][_LEN.size:])
            for seg in chunks[1:]:
                payload += memoryview(seg).cast("B")
            crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
            damaged = faults.corrupt("snapshot.write", bytes(payload))
            with open(tmp, "wb") as f:
                f.write(_LEN.pack(len(payload)) + _U32.pack(crc) + damaged)
                f.flush()
                faults.check("wal.fsync", path=tmp)
                os.fsync(f.fileno())
            faults.check("wal.rename", path=final)
            os.replace(tmp, final)
            _fsync_dir(self.dir)
            self.snapshot_rev = rev
            self.bytes_written += len(payload)
            METRICS.add("wal.snapshots")
            METRICS.add("wal.bytes", len(payload))
            # reap only AFTER the covering snapshot is renamed in place
            self._reap(rev)
            if rev > self.last_rev:
                self.last_rev = rev

    def _reap(self, snap_rev: int) -> None:
        for seq, name in self._list("wal-", ".seg"):
            covered = self._seg_max_rev.get(seq)
            if covered is None or covered > snap_rev or seq == self._seq:
                continue
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                continue
            self._seg_sizes.pop(seq, None)
            self._seg_max_rev.pop(seq, None)
            METRICS.add("wal.segments_reaped")
        for rev, name in self._list("snapshot-", ".snap"):
            if rev < snap_rev:
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    def should_snapshot(self) -> bool:
        """True when live segment bytes crossed the compaction
        threshold and there is new state to compact."""
        return (self.last_rev > self.snapshot_rev
                and sum(self._seg_sizes.values()) >= self.snapshot_bytes)

    # -- introspection -------------------------------------------------

    def manifest(self) -> dict:
        """Durability health block for `/debug/bundle` / status."""
        with self._lock:
            return {
                "dir": self.dir,
                "sync": self.sync,
                "segments": len(self._seg_sizes),
                "segment_bytes": sum(self._seg_sizes.values()),
                "bytes_written": self.bytes_written,
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "last_fsync_age_s": round(
                    time.monotonic() - self._last_fsync, 3),
                "last_rev": self.last_rev,
                "snapshot_rev": self.snapshot_rev,
                "recovery": dict(self.recovery),
            }

    def close(self) -> None:
        lockcheck.note_blocking("wal.close")
        with self._lock:
            if self._file is not None:
                try:
                    self._sync_file()
                finally:
                    self._file.close()
                    self._file = None
            self.closed = True
