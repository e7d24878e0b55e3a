"""PyTorch/CUDA port: the device ledger's pins (`obs/device.py`)
against the JAX package's `DeviceLedger`.

One sequence of pin / pinned / unpin / evict_pins runs
through a fresh JAX-package ledger and a fresh port ledger, step by
step, under one `DATAFUSION_TPU_HBM_BYTES`.  After every step both hold
the same pins (fingerprint, owner, bytes, priority, uses: the
`pins_snapshot`), the same `pinned_bytes`, and evictions drop the same
pins in the same order and report the same bytes freed.  `headroom` is
held to the port's own definition (the capacity less the pins' bytes
and, where CUDA is initialized, the bytes its allocator holds): the
JAX ledger counts the device buffers it tracks instead.
"""

from __future__ import annotations

import numpy as np
import pytest

from datafusion_tpu.obs import device as jax_device

from datafusion_tpu_torch.obs import device as port_device
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.utils.metrics import METRICS


def _pair():
    """A fresh ledger of each package and the eviction hooks' logs."""
    logs = {"jax": [], "port": []}
    return jax_device.DeviceLedger(), port_device.DeviceLedger(), logs


def _apply(ledger, log, step):
    op, *args = step
    if op == "pin":
        fp, nbytes, owner, priority = args
        return ledger.pin(fp, nbytes=nbytes, owner=owner, priority=priority,
                          on_evict=lambda fp=fp: log.append(fp), artifact=("art", fp))
    if op == "pinned":
        return ledger.pinned(args[0])
    if op == "unpin":
        return ledger.unpin(args[0])
    if op == "evict":
        need, exclude = args
        return ledger.evict_pins(need, exclude=exclude)
    raise AssertionError(op)


def _sequence(seed: int):
    rng = np.random.default_rng(seed)
    fps = [f"table:t{i}" for i in range(6)] + [f"join:{i:04x}" for i in range(4)]
    steps = []
    for _ in range(80):
        r = rng.random()
        fp = fps[rng.integers(0, len(fps))]
        if r < 0.35:
            owner = "join.build" if fp.startswith("join") else f"pin.{fp[6:]}"
            steps.append(("pin", fp, int(rng.integers(1, 1 << 20)), owner,
                          int(rng.integers(0, 3))))
        elif r < 0.65:
            steps.append(("pinned", fp))
        elif r < 0.8:
            steps.append(("unpin", fp))
        else:
            exclude = [f for f in fps if rng.random() < 0.2]
            steps.append(("evict", int(rng.integers(1, 3 << 20)), exclude))
    return steps


@pytest.mark.parametrize("seed", range(6))
def test_pin_sequence_matches_jax_ledger(seed, monkeypatch):
    cap = 16 << 20
    monkeypatch.setenv("DATAFUSION_TPU_HBM_BYTES", str(cap))
    jl, pl, logs = _pair()
    for step in _sequence(seed):
        want = _apply(jl, logs["jax"], step)
        got = _apply(pl, logs["port"], step)
        if step[0] in ("evict", "unpin"):
            assert got == want, step
        elif step[0] == "pinned":
            assert (got is None) == (want is None) and got == want, step
        assert logs["port"] == logs["jax"], step
        assert pl.pins_snapshot() == jl.pins_snapshot(), step
        assert pl.pinned_bytes() == jl.pinned_bytes(), step
        assert pl.headroom() == cap - pl.pinned_bytes() - port_device.device_allocated_bytes()
    assert logs["port"], "the sequence evicted nothing"


def test_eviction_order_is_priority_then_recency(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_HBM_BYTES", str(1 << 30))
    jl, pl, logs = _pair()
    for ledger, key in ((jl, "jax"), (pl, "port")):
        for fp in ("a", "b", "c", "d"):
            _apply(ledger, logs[key], ("pin", fp, 100, "pin." + fp, 0))
        for fp in ("c", "c", "a", "b", "d", "d", "d"):
            ledger.pinned(fp)
        assert ledger.evict_pins(250, exclude=["b"]) == 300
    assert logs["port"] == logs["jax"] == ["a", "c", "d"]
    assert set(pl.pins_snapshot()) == set(jl.pins_snapshot()) == {"b"}


def test_headroom_unknown_without_capacity(monkeypatch):
    monkeypatch.delenv("DATAFUSION_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(port_device, "hbm_capacity_bytes", lambda: None)
    assert port_device.DeviceLedger().headroom() is None


def test_pins_count_and_record_their_evictions():
    ledger = port_device.DeviceLedger()
    before = METRICS.snapshot()["counts"].get("device.pin_evictions", 0)
    ledger.pin("table:x", nbytes=10, owner="pin.x")
    assert ledger.unpin("table:x") and not ledger.unpin("table:x")
    assert METRICS.snapshot()["counts"]["device.pin_evictions"] == before + 1
    kinds = [e["kind"] for e in recorder.events()]
    assert "device.pin" in kinds and "device.pin_evict" in kinds
