"""PyTorch/CUDA port, slice 11: the device ledger's buffers, the phase
breakdown and `utils/profiling.trace` (`datafusion_tpu_torch/obs/
device.py`, `exec/batch.to_device`/`to_host`, `utils/profiling.py`).

- The ledger: a tensor registers and releases when it dies, a view or a
  second tensor on one storage counts once, the peak window leaves the
  process peak alone, `report_text` has the JAX package's sections, and
  `headroom()` and `pins_snapshot()` keep the definition
  `tests/test_torch_ledger.py` holds (pins plus allocated device bytes).
- The copy seams: `to_device` counts `h2d.bytes`, registers the tensor
  under its owner and attributes bytes to the ambient operator;
  `to_host` counts `d2h.bytes`; a batch group's concatenation registers
  under `fold`.
- Phases, exact against the JAX package: the same per-phase timer
  deltas through both packages' `phase_breakdown` and `phase_bar` give
  the same output (the two name some timers apart: the port's decode
  holds the aggregate's group-key encode, its compile the nvcc build).
- `profile_sync` is a contextvar scope: another thread does not see it.
- `utils/profiling.trace` writes a Chrome trace on the CPU.
"""

from __future__ import annotations

import gc
import json
import threading

import numpy as np
import pytest
import torch

from datafusion_tpu.obs import device as jax_device

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec.batch import to_device, to_host
from datafusion_tpu_torch.obs import device, stats, trace
from datafusion_tpu_torch.obs.device import DeviceLedger
from datafusion_tpu_torch.utils.metrics import METRICS

CPU = torch.device("cpu")


def _t(n, dtype=torch.float64):
    return torch.arange(n, dtype=dtype)


def test_register_and_release_on_death():
    led = DeviceLedger()
    t = _t(1000)
    led.adopt(t, "batch")
    assert (led.buffer_bytes(), led.entries) == (8000, 1)
    assert led.owners() == {"batch": {"bytes": 8000, "buffers": 1}}
    assert led.devices() == {"cpu": 8000}
    del t
    gc.collect()
    assert (led.buffer_bytes(), led.entries) == (0, 0)
    assert led.peak_bytes() == 8000


def test_a_view_and_a_shared_storage_count_once():
    led = DeviceLedger()
    t = _t(1000)
    view = t[10:500]
    led.adopt((t, [view, None], t.view(torch.int64)), "batch")
    assert (led.buffer_bytes(), led.entries) == (8000, 1)
    del t
    gc.collect()
    assert led.buffer_bytes() == 8000  # the view still holds the storage
    del view
    gc.collect()
    assert (led.buffer_bytes(), led.entries) == (0, 0)


def test_retag_and_latest_owner():
    led = DeviceLedger()
    t = _t(10)
    led.adopt(t, "batch")
    led.retag(t, "pin.t")
    assert set(led.owners()) == {"pin.t"}
    led.adopt(t[2:], "fold")
    assert set(led.owners()) == {"fold"}


def test_peak_window_preserves_process_peak():
    led = DeviceLedger()
    big = _t(10_000)
    led.adopt(big, "a")
    del big
    gc.collect()
    assert led.peak_bytes() == 80_000
    assert led.begin_peak_window() == 0
    small = _t(100)
    led.adopt(small, "b")
    assert led.window_peak_bytes() == 800
    assert led.peak_bytes() == 80_000


def test_report_text_sections():
    led = DeviceLedger()
    keep = [_t(2048), _t(16, torch.int32)]
    led.adopt(keep[0], "batch")
    led.adopt(keep[1], "group_ids")
    led.pin("table:t", nbytes=4096, owner="pin.t")
    lines = led.report_text().splitlines()
    assert lines[0] == "Device ledger: 2 buffer(s), live 16.1KiB, peak 16.1KiB"
    assert lines[1] == "  device cpu: 16.1KiB"
    assert lines[2:4] == ["  owner batch: 16.0KiB in 1 buffer(s)",
                          "  owner group_ids: 64B in 1 buffer(s)"]
    assert lines[4] == "  pinned table:t: 4.0KiB (owner pin.t, uses 0)"
    assert device._fmt_bytes(3 << 30) == jax_device._fmt_bytes(3 << 30) == "3.00GiB"
    for n in (0, 1023, 1024, 5 << 20):
        assert device._fmt_bytes(n) == jax_device._fmt_bytes(n)


def test_headroom_keeps_its_definition(monkeypatch):
    led = DeviceLedger()
    monkeypatch.setenv("DATAFUSION_TPU_HBM_BYTES", str(1 << 30))
    keep = _t(100_000)
    led.adopt(keep, "batch")  # registered buffers do not enter headroom
    led.pin("a", nbytes=1000, owner="pin.a")
    assert led.live_bytes() == 1000 + device.device_allocated_bytes()
    assert led.headroom() == (1 << 30) - 1000 - device.device_allocated_bytes()
    assert led.pins_snapshot() == {"a": {"owner": "pin.a", "bytes": 1000, "priority": 0,
                                         "uses": 0}}


# -------------------------------------------------- the copy seams


def test_to_device_counts_registers_and_attributes():
    before = METRICS.snapshot()["counts"]
    st = stats.OperatorStats()

    class Op:
        stats = st

    with trace.session() as tc:
        with stats.op_timer(Op()):
            t = to_device(np.arange(500, dtype=np.int64), CPU, owner="group_ids")
            back = to_host(t)
    trace.drain(tc.trace_id)
    after = METRICS.snapshot()["counts"]
    assert after["h2d.bytes"] - before.get("h2d.bytes", 0) == 4000
    assert after["device.h2d.transfers"] - before.get("device.h2d.transfers", 0) == 1
    assert after["d2h.bytes"] - before.get("d2h.bytes", 0) == 4000
    assert (st.h2d_bytes, st.d2h_bytes) == (4000, 4000)
    assert device.LEDGER.owners()["group_ids"]["bytes"] >= 4000
    assert np.array_equal(back, np.arange(500))


def test_fold_concatenation_registers_under_fold(monkeypatch):
    from datafusion_tpu_torch.datatypes import DataType, Field, Schema
    from datafusion_tpu_torch.exec.batch import make_host_batch
    from datafusion_tpu_torch.exec.datasource import MemoryDataSource

    schema = Schema([Field("k", DataType.INT64, False), Field("v", DataType.FLOAT64, False)])
    rng = np.random.default_rng(1)
    batches = [make_host_batch(schema, [rng.integers(0, 8, 1024), rng.random(1024)])
               for _ in range(4)]
    ctx = tdf.ExecutionContext(device="cpu", batch_size=1024)
    ctx.register_datasource("t", MemoryDataSource(schema, batches))
    seen = []
    real = device.LEDGER.adopt

    def spy(value, owner="anon"):
        seen.append(owner)
        return real(value, owner)

    monkeypatch.setattr(device.LEDGER, "adopt", spy)
    res = ctx.sql_collect("EXPLAIN ANALYZE SELECT k, SUM(v) FROM t GROUP BY k")
    assert res.result.num_rows == 8
    assert "fold" in seen and "group_ids" in seen and "batch" in seen
    assert res.hbm["peak_bytes"] >= res.hbm["live_bytes"] >= 0


# ----------------------------------------------------------- phases


def _feed(monkeypatch, phase_totals):
    """Make both packages' phase_snapshot return the same per-phase
    totals, each under its own timer names."""
    jax_cur = {"scan.parse": phase_totals["decode"] * 0.75,
               "h2d.encode": phase_totals["decode"] * 0.25,
               "h2d.dispatch": phase_totals["h2d"],
               "compile.xla": phase_totals["compile"],
               "device.dispatch": phase_totals["execute"],
               "d2h.wait": phase_totals["d2h"], "d2h.compact": 0.0}
    port_cur = {"scan.parse": jax_cur["scan.parse"], "agg.host_encode": jax_cur["h2d.encode"],
                "h2d.dispatch": jax_cur["h2d.dispatch"], "compile.nvcc": jax_cur["compile.xla"],
                "device.dispatch": jax_cur["device.dispatch"], "d2h.wait": jax_cur["d2h.wait"]}
    monkeypatch.setattr(jax_device, "phase_snapshot", lambda: dict(jax_cur))
    monkeypatch.setattr(device, "phase_snapshot", lambda: dict(port_cur))


@pytest.mark.parametrize("totals,wall", [
    ({"decode": 0.5, "h2d": 0.01, "compile": 0.0, "execute": 0.2, "d2h": 0.05}, 1.0),
    ({"decode": 0.0, "h2d": 0.0, "compile": 0.3, "execute": 0.4, "d2h": 0.001}, 0.5),
    ({"decode": 2.0, "h2d": 0.5, "compile": 0.0, "execute": 0.1, "d2h": 0.0}, 1.5),
    ({"decode": 0.0, "h2d": 0.0, "compile": 0.0, "execute": 0.0, "d2h": 0.0}, 0.1),
])
def test_phase_breakdown_and_bar_equal_the_jax_package(monkeypatch, totals, wall):
    _feed(monkeypatch, totals)
    got = device.phase_breakdown({}, wall)
    want = jax_device.phase_breakdown({}, wall)
    assert got == want
    assert device.phase_bar(got, wall) == jax_device.phase_bar(want, wall)
    assert device.phase_bar(got, wall, width=10) == jax_device.phase_bar(want, wall, width=10)
    assert device.phase_ms(got) == jax_device.phase_ms(want)
    assert device.PHASE_ORDER == jax_device.PHASE_ORDER


def test_profile_sync_is_scoped_to_its_context():
    assert not device.profile_sync_active()
    seen = {}
    with device.profile_sync():
        assert device.profile_sync_active()
        t = threading.Thread(target=lambda: seen.update(other=device.profile_sync_active()))
        t.start()
        t.join(timeout=10)
        with device.profile_sync():
            assert device.profile_sync_active()
        assert device.profile_sync_active()
    assert not device.profile_sync_active()
    assert seen == {"other": False}


# --------------------------------------------------- profiling.trace


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    from datafusion_tpu_torch.utils.profiling import annotate, trace as torch_trace

    a, b = torch.rand(256, 256), torch.rand(256, 256)
    with torch_trace(str(tmp_path / "prof")) as prof:
        with annotate("df.block"):
            (a @ b).sum()
    doc = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "df.block" in names
    assert any(n and "mm" in n for n in names)
    assert prof.key_averages()
