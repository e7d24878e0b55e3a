"""PyTorch/CUDA port: the meter's host gate (`datafusion_tpu_torch/exec/gate.py`),
the parts that run without a card.

The gate itself waits on a mapped host word through the CUDA driver, so
its passes run only on the card (`tests/test_torch_cuda.py`: the billed
host gap, each host-wait site, the watchdog).  Here: `host_wait` and
`gated_pass` outside a pass, a pass nested in another, the watchdog
opening a gate that stayed closed and leaving one the pass opened, a
forced open never moving the word back, and the retry seam taking no
gate on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
import time

import pytest
import torch

from datafusion_tpu_torch.exec import gate
from datafusion_tpu_torch.obs import attribution
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call


def _stub_gate(word=0):
    """A `Gate` over a plain 32-bit word, no driver behind it."""
    g = object.__new__(gate.Gate)
    g._word = ctypes.c_uint32(word)
    g.value = word
    g._lock = threading.Lock()
    g.thread = threading.get_ident()
    g.host = g.dptr = None
    return g


def test_host_wait_outside_a_pass_is_a_no_op():
    assert gate.active() is None
    with gate.host_wait():
        pass
    assert gate.active() is None


def test_a_nested_pass_runs_inside_the_outer_one(monkeypatch):
    outer = object()
    monkeypatch.setattr(gate._local, "active", outer, raising=False)
    with gate.gated_pass(torch.device("cpu")) as p:
        assert p is None and gate.active() is outer


@pytest.mark.parametrize("opened", [False, True], ids=["left_closed", "opened_by_the_pass"])
def test_watchdog_opens_only_a_gate_left_closed(monkeypatch, opened):
    monkeypatch.setattr(gate, "FORCE_OPEN_S", 0.01)
    g = _stub_gate()
    g.value = 1
    forced0 = METRICS.counts.get("meter.gate_forced", 0)
    gate._WATCHDOG.arm(g, 1)
    if opened:
        g.open()
    deadline = time.monotonic() + 5
    while g._word.value != 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.05)
    assert g._word.value == 1
    assert METRICS.counts.get("meter.gate_forced", 0) == forced0 + (0 if opened else 1)
    if not opened:  # the event names where the pass thread stood
        from datafusion_tpu_torch.obs import recorder

        ev = [e for e in recorder.events("meter.gate_forced") if e["attrs"]["value"] == 1]
        assert ev and "test_torch_gate.py" in ev[-1]["attrs"]["where"]


def test_a_forced_open_never_moves_the_word_back():
    g = _stub_gate(5)
    assert g.force(3) is False and g._word.value == 5
    assert g.force(6) is True and g._word.value == 6
    g.value = 0xFFFFFFFF
    g.open()
    assert g.force(2) is True and g._word.value == 2  # the word wraps


def test_the_retry_seam_takes_no_gate_on_the_cpu(monkeypatch):
    monkeypatch.setattr(gate, "GatedPass", None)  # would raise if taken
    with attribution.client_scope("cpu-tenant") as acc:
        out = device_call(lambda x: x + 1, torch.ones(3), _device=torch.device("cpu"))
    assert torch.equal(out, torch.full((3,), 2.0)) and acc[0] > 0
