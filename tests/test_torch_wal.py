"""PyTorch/CUDA port: the write-ahead log (`datafusion_tpu_torch/utils/wal.py`)
and its neighbours (`parallel/wire.py`, `testing/faults.py`,
`analysis/lockcheck.py`), against the JAX package's.

The cases of the JAX package's `tests/test_wal.py::TestWalUnit`, run on
the port's log: append/recover round trip with non-contiguous
revisions, revision dedup, torn-tail truncation in place, CRC damage,
a mid-log tear dropping the segments written over it, snapshot
compaction and reaping, the snapshot threshold, tmp leftovers, an
invalid newer snapshot, the sync policy check, the manifest and the
atomic JSON helpers.  Then what the port adds: the same records give
the same bytes in both packages, each package recovers a log the other
wrote, and the disk fault sites raise through the port's fault plan.

Left out, since their planes are not ported (ROADMAP queue 1, item
13.2): the lease-deadline notes (`test_deadline_note_*`; a note in a
JAX log is skipped on recovery, tested below), `TestNodeRecovery`,
`TestLeaseRearm`, `TestSnapshotResyncTruncation` and
`TestBundleWalBlock` (node, lease and standby recovery and the debug
bundle).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from datafusion_tpu.utils import wal as jax_wal

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.parallel import wire
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.wal import WriteAheadLog, atomic_write_json, read_json


def _ev(rev, key="k", value=1):
    return {"kind": "put", "rev": rev, "key": key, "value": value}


def _append(log, *revs):
    log.append([(_ev(r, key=f"k{r}", value=r), None) for r in revs])


# -- the log itself (tests/test_wal.py::TestWalUnit) -----------------


class TestWalUnit:
    def test_append_recover_roundtrip(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d)
        log.recover()
        _append(log, 1, 3, 7)
        log.close()
        log2 = WriteAheadLog(d)
        snap, events = log2.recover()
        assert snap is None
        assert [e["rev"] for e in events] == [1, 3, 7]
        assert [e["key"] for e in events] == ["k1", "k3", "k7"]
        assert log2.last_rev == 7
        assert log2.recovery["replayed_events"] == 3
        assert log2.recovery["torn_tails"] == 0

    def test_reoffered_tail_dedups(self, tmp_path):
        log = WriteAheadLog(str(tmp_path))
        log.recover()
        _append(log, 1, 2)
        _append(log, 1, 2, 3)
        log.close()
        log2 = WriteAheadLog(str(tmp_path))
        _, events = log2.recover()
        assert [e["rev"] for e in events] == [1, 2, 3]

    def test_torn_tail_truncated_in_place(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d)
        log.recover()
        _append(log, 1, 2)
        log.close()
        seg = os.path.join(d, "wal-00000001.seg")
        good = os.path.getsize(seg)
        with open(seg, "ab") as f:
            f.write(b"\x00" * 7)  # a crash mid-header
        log2 = WriteAheadLog(d)
        _, events = log2.recover()
        assert [e["rev"] for e in events] == [1, 2]
        assert log2.recovery["torn_tails"] == 1
        assert os.path.getsize(seg) == good
        _append(log2, 3)
        log2.close()
        log3 = WriteAheadLog(d)
        _, events = log3.recover()
        assert [e["rev"] for e in events] == [1, 2, 3]
        assert log3.recovery["torn_tails"] == 0

    def test_crc_damage_drops_the_record(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d)
        log.recover()
        _append(log, 1, 2)
        log.close()
        seg = os.path.join(d, "wal-00000001.seg")
        with open(seg, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        log2 = WriteAheadLog(d)
        _, events = log2.recover()
        assert [e["rev"] for e in events] == [1]
        assert log2.recovery["torn_tails"] == 1
        assert log2.last_rev == 1

    def test_mid_log_tear_drops_later_segments(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d, segment_bytes=1)
        log.recover()
        _append(log, 1)
        _append(log, 2)
        _append(log, 3)
        log.close()
        assert os.path.exists(os.path.join(d, "wal-00000003.seg"))
        seg2 = os.path.join(d, "wal-00000002.seg")
        with open(seg2, "r+b") as f:
            f.truncate(os.path.getsize(seg2) // 2)
        log2 = WriteAheadLog(d, segment_bytes=1)
        _, events = log2.recover()
        assert [e["rev"] for e in events] == [1]
        assert log2.last_rev == 1
        assert log2.recovery["dropped_records"] == 1
        assert log2.recovery["torn_tails"] == 1

    def test_snapshot_compacts_and_reaps(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d, segment_bytes=1)
        log.recover()
        _append(log, 1)
        _append(log, 2)
        _append(log, 3)
        log.write_snapshot({"rev": 2, "kv": {"compacted": True}})
        names = sorted(os.listdir(d))
        assert "wal-00000001.seg" not in names
        assert "wal-00000002.seg" not in names
        assert "wal-00000003.seg" in names
        assert "snapshot-00000002.snap" in names
        log.write_snapshot({"rev": 3, "kv": {"compacted": 2}})
        assert "snapshot-00000002.snap" not in sorted(os.listdir(d))
        log.write_snapshot({"rev": 2, "kv": {}})  # a stale offer: no-op
        assert log.snapshot_rev == 3
        log.close()
        log2 = WriteAheadLog(d)
        snap, events = log2.recover()
        assert snap == {"rev": 3, "kv": {"compacted": 2}}
        assert events == []
        assert log2.last_rev == 3 and log2.snapshot_rev == 3

    def test_should_snapshot_threshold(self, tmp_path):
        log = WriteAheadLog(str(tmp_path), snapshot_bytes=1)
        log.recover()
        assert not log.should_snapshot()
        _append(log, 1)
        assert log.should_snapshot()
        log.write_snapshot({"rev": 1})
        assert not log.should_snapshot()
        log.close()

    def test_tmp_leftovers_reaped_on_recovery(self, tmp_path):
        leftover = os.path.join(str(tmp_path), "snapshot-00000009.snap.tmp")
        with open(leftover, "wb") as f:
            f.write(b"half-written")
        log = WriteAheadLog(str(tmp_path))
        log.recover()
        assert not os.path.exists(leftover)
        log.close()

    def test_invalid_newer_snapshot_falls_back_to_older(self, tmp_path):
        d = str(tmp_path)
        log = WriteAheadLog(d)
        log.recover()
        _append(log, 1)
        log.write_snapshot({"rev": 1, "kv": {"good": True}})
        log.close()
        with open(os.path.join(d, "snapshot-00000009.snap"), "wb") as f:
            f.write(b"\xde\xad\xbe\xef not a snapshot")
        log2 = WriteAheadLog(d)
        snap, _ = log2.recover()
        assert snap == {"rev": 1, "kv": {"good": True}}
        assert log2.snapshot_rev == 1

    def test_a_jax_deadline_note_is_skipped_on_recovery(self, tmp_path):
        # the JAX cluster's lease-deadline notes (revision 0) are not
        # ported; the port recovers a log that holds one and skips it
        d = str(tmp_path)
        log = jax_wal.WriteAheadLog(d, deadline_interval_s=0.0)
        log.recover()
        _append(log, 1, 2, 3)
        assert log.note_deadlines(lambda: {"L1": 5.0}) is True
        _append(log, 4)
        log.close()
        log2 = WriteAheadLog(d)
        snap, events = log2.recover()
        assert snap is None
        assert [e["rev"] for e in events] == [1, 2, 3, 4]
        assert log2.last_rev == 4 and log2.recovery["torn_tails"] == 0
        log2.close()

    def test_bad_sync_policy_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            WriteAheadLog(str(tmp_path), sync="eventually")

    def test_manifest_shape(self, tmp_path):
        log = WriteAheadLog(str(tmp_path))
        log.recover()
        _append(log, 1)
        m = log.manifest()
        assert m["last_rev"] == 1 and m["snapshot_rev"] == 0
        assert m["segments"] == 1
        assert m["appends"] == 1 and m["bytes_written"] > 0
        assert m["sync"] == "always" and m["recovery"]["recovered_rev"] == 0
        assert m["fsyncs"] == 1  # `always`: one fsync before the append returned
        log.close()

    def test_atomic_json_roundtrip_and_corrupt_read(self, tmp_path):
        path = str(tmp_path / "manifest.json")
        atomic_write_json(path, {"pins": ["t"]})
        assert read_json(path) == {"pins": ["t"]}
        assert not os.path.exists(path + ".tmp")
        with open(path, "wb") as f:
            f.write(b"{torn")
        assert read_json(path) is None


# -- the same bytes, either package recovers the other's log ---------


def _records():
    """Records with a raw array segment, a validity segment, inline
    arrays and strings: the shapes an ingest-log append carries."""
    rng = np.random.default_rng(3)
    out = []
    for rev in (1, 2, 5):
        bw = wire.BinWriter()
        big = rng.normal(size=400)
        doc = {"kind": "append", "rev": rev, "table": "t", "client": "", "rows": 400,
               "cols": [{"name": "x", "a": wire.enc_array(big, bw),
                         "v": wire.enc_array((big > 0).astype(np.uint8), bw)},
                        {"name": "s", "s": ["a", None, "b"]},
                        {"name": "i", "a": wire.enc_array(np.arange(3, dtype=np.int64), bw)}]}
        out.append((doc, bw))
    return out


def _segment_bytes(d):
    names = sorted(n for n in os.listdir(d) if n.endswith(".seg"))
    return [open(os.path.join(d, n), "rb").read() for n in names]


def test_same_records_same_bytes_as_the_jax_package(tmp_path):
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    plog, jlog = WriteAheadLog(pd), jax_wal.WriteAheadLog(jd)
    plog.recover()
    jlog.recover()
    plog.append(_records())
    jlog.append(_records())
    plog.write_snapshot({"rev": 2, "views": [{"name": "mv", "sql": "SELECT 1"}]})
    jlog.write_snapshot({"rev": 2, "views": [{"name": "mv", "sql": "SELECT 1"}]})
    plog.close()
    jlog.close()
    assert _segment_bytes(pd) == _segment_bytes(jd)
    snap = "snapshot-00000002.snap"
    assert open(os.path.join(pd, snap), "rb").read() == open(os.path.join(jd, snap), "rb").read()


@pytest.mark.parametrize("writer,reader", [(jax_wal.WriteAheadLog, WriteAheadLog),
                                           (WriteAheadLog, jax_wal.WriteAheadLog)],
                         ids=["jax_writes_port_recovers", "port_writes_jax_recovers"])
def test_either_package_recovers_the_others_log(tmp_path, writer, reader):
    d = str(tmp_path)
    log = writer(d, segment_bytes=4096)
    log.recover()
    log.append(_records())
    log.close()
    with open(os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".seg"))[-1]),
              "ab") as f:
        f.write(b"\x00" * 5)  # a torn tail on top
    log2 = reader(d)
    events = log2.recover()[1]  # the JAX log also returns lease deadlines
    assert [e["rev"] for e in events] == [1, 2, 5]
    assert log2.recovery["torn_tails"] == 1
    rng = np.random.default_rng(3)  # _records()'s draws, in order
    for got in events:
        x = rng.normal(size=400)
        assert got["cols"][1]["s"] == ["a", None, "b"]
        assert np.array_equal(wire.dec_array(got["cols"][0]["a"]), x)
        assert np.array_equal(wire.dec_array(got["cols"][0]["v"]), (x > 0).astype(np.uint8))
        assert np.array_equal(wire.dec_array(got["cols"][2]["a"]), np.arange(3))
    log2.close()


# -- disk fault sites and the lock checker ---------------------------


@pytest.mark.parametrize("site,revs", [("wal.write", [1]), ("wal.fsync", [1, 2])])
def test_disk_fault_sites_raise_and_keep_the_log_recoverable(tmp_path, site, revs):
    d = str(tmp_path)
    log = WriteAheadLog(d)
    log.recover()
    _append(log, 1)
    plan = {"rules": [{"site": site, "op": "raise", "exc": "OSError",
                       "message": "ENOSPC"}]}
    with faults.scoped(plan):
        with pytest.raises(OSError, match="ENOSPC"):
            _append(log, 2)
    log.close()
    log2 = WriteAheadLog(d)
    _, events = log2.recover()
    # rev 1 was acknowledged and survives; rev 2 raised, never acked: a
    # failed write left nothing, a failed fsync may leave the record
    # (the log is a superset of the acknowledged appends)
    assert [e["rev"] for e in events] == revs
    log2.close()


def test_short_write_is_a_torn_record_on_recovery(tmp_path):
    d = str(tmp_path)
    log = WriteAheadLog(d)
    log.recover()
    _append(log, 1)
    with faults.scoped({"rules": [{"site": "wal.write", "op": "short", "offset": 3}]}):
        _append(log, 2)
    log.close()
    log2 = WriteAheadLog(d)
    _, events = log2.recover()
    assert [e["rev"] for e in events] == [1]
    assert log2.recovery["torn_tails"] == 1
    log2.close()


def test_atomic_json_fault_leaves_the_old_manifest(tmp_path):
    path = str(tmp_path / "pins.json")
    atomic_write_json(path, {"pins": ["a"]})
    with faults.scoped({"rules": [{"site": "wal.rename", "op": "raise", "exc": "OSError"}]}):
        with pytest.raises(OSError):
            atomic_write_json(path, {"pins": ["b"]})
    assert read_json(path) == {"pins": ["a"]}


def test_lockcheck_records_a_blocking_call_under_a_lock_and_a_cycle():
    reg = lockcheck.Registry()
    a, b = lockcheck.TrackedLock("a", reg), lockcheck.TrackedLock("b", reg)
    with a:
        with b:
            reg.note_blocking("wal.append")
    with b:
        with a:
            pass
    rep = reg.report()
    assert {(e["held"], e["acquired"]) for e in rep["edges"]} == {("a", "b"), ("b", "a")}
    assert rep["cycles"] and not reg.ok
    assert {(x["op"], x["held"]) for x in rep["blocking"]} == {("wal.append", "a"),
                                                               ("wal.append", "b")}


def test_wire_frame_roundtrip_and_crc_failure():
    bw = wire.BinWriter()
    arr = np.arange(1000, dtype=np.float64)
    chunks = wire.encode_frame({"x": wire.enc_array(arr, bw)}, bw, crc=True)
    payload = b"".join(bytes(memoryview(c).cast("B")) for c in chunks)[8:]
    got = wire.parse_frame(bytearray(payload))
    assert np.array_equal(wire.dec_array(got["x"]), arr)
    bad = bytearray(payload)
    bad[-1] ^= 0xFF
    with pytest.raises(wire.ProtocolError):
        wire.parse_frame(bad)
