"""PyTorch/CUDA port: the circuit breaker and the hedge tracker
(`datafusion_tpu_torch.utils.breaker` / `.hedge`) against the JAX
package's modules.

Each case drives both packages' objects with the same event sequence on
a fake clock (the breaker's injectable `now`) and compares every answer
and every state along the way: the breaker's `allow`, `denies`,
`record` and state, the hedge tracker's thresholds, budget decisions
and EWMAs.  Plus the registry (bounded, gauges, off by default), the
tracker's environment switch, and the distributed slice's modules,
which import neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest

from datafusion_tpu.utils import breaker as jax_breaker
from datafusion_tpu.utils import hedge as jax_hedge

from datafusion_tpu_torch.utils import breaker as port_breaker
from datafusion_tpu_torch.utils import hedge as port_hedge


def _breaker_trace(mod, events, **kw):
    now = [0.0]
    b = mod.CircuitBreaker("worker:h:1", now=lambda: now[0], **kw)
    out = []
    for ev in events:
        op = ev[0]
        if op == "advance":
            now[0] += ev[1]
            continue
        if op == "allow":
            out.append(("allow", b.allow(), b.state))
        elif op == "denies":
            out.append(("denies", b.denies(), b.state))
        else:
            b.record(ev[1])
            out.append(("record", ev[1], b.state))
    return out


def _random_events(seed, n=120):
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(n):
        r = rng.random()
        if r < 0.4:
            events.append(("record", bool(rng.random() < 0.45)))
        elif r < 0.7:
            events.append(("allow",))
        elif r < 0.85:
            events.append(("denies",))
        else:
            events.append(("advance", float(rng.choice([0.5, 2.0, 6.0]))))
    return events


BREAKER_CASES = [
    ("consecutive failures open", dict(failures=3, open_s=60.0),
     [("record", False)] * 2 + [("allow",), ("record", False), ("allow",), ("denies",)]),
    ("success resets the streak", dict(failures=3, window=100, ratio=1.1, open_s=60.0),
     [("record", False), ("record", False), ("record", True)] * 10 + [("allow",)]),
    ("ratio over a full window", dict(failures=100, window=10, ratio=0.5, open_s=60.0),
     [("record", i % 2 == 0) for i in range(10)] + [("allow",)]),
    ("half-open probe then close", dict(failures=1, open_s=5.0, half_open_probes=1),
     [("record", False), ("allow",), ("advance", 6.0), ("allow",), ("allow",),
      ("record", True), ("allow",)]),
    ("half-open probe failure reopens", dict(failures=1, open_s=5.0),
     [("record", False), ("advance", 6.0), ("allow",), ("record", False), ("allow",),
      ("advance", 6.0), ("allow",)]),
    ("late loser report dropped", dict(failures=1, open_s=60.0),
     [("record", False), ("record", True), ("allow",)]),
    ("cooled open closes by record", dict(failures=1, open_s=5.0),
     [("record", False), ("advance", 6.0), ("denies",), ("record", True), ("allow",)]),
    ("two concurrent probes", dict(failures=2, open_s=1.0, half_open_probes=2),
     [("record", False)] * 2 + [("advance", 2.0)] + [("allow",)] * 4),
] + [(f"random {seed}", dict(failures=3, window=8, ratio=0.5, open_s=4.0,
                             half_open_probes=2), _random_events(seed))
     for seed in range(4)]


@pytest.mark.parametrize("name,kw,events", BREAKER_CASES, ids=[c[0] for c in BREAKER_CASES])
def test_breaker_decisions_match_jax(name, kw, events):
    got = _breaker_trace(port_breaker, events, **kw)
    assert got == _breaker_trace(jax_breaker, events, **kw)
    assert got  # the sequence asked something


def test_breaker_registry_off_by_default_and_bounded(monkeypatch):
    monkeypatch.delenv("DATAFUSION_TPU_BREAKER", raising=False)
    assert port_breaker.breaker_for("worker:h:1") is None
    port_breaker.configure(True)
    try:
        port_breaker.reset()
        monkeypatch.setattr(port_breaker, "_REGISTRY_MAX", 4)
        incident = port_breaker.breaker_for("worker:h:0")
        assert incident is port_breaker.breaker_for("worker:h:0")
        for _ in range(incident.failures):
            incident.record(False)
        assert port_breaker.gauges()["breaker.worker:h:0.state"] == port_breaker.OPEN
        for i in range(1, 12):
            port_breaker.breaker_for(f"worker:h:{i}")
        assert len(port_breaker._REGISTRY) <= 4
        assert "worker:h:0" in port_breaker._REGISTRY  # live evidence survives
    finally:
        port_breaker.configure(None)
        port_breaker.reset()


def _hedge_trace(mod, events, **kw):
    h = mod.HedgeTracker(**kw)
    out = []
    for ev in events:
        op = ev[0]
        if op == "observe":
            h.observe(ev[1], ev[2])
        elif op == "dispatch":
            h.observe_dispatch()
        elif op == "threshold":
            out.append(("threshold", ev[1], h.threshold_s(ev[1])))
        elif op == "try":
            out.append(("try", h.try_hedge()))
        elif op == "refund":
            h.refund()
    out.append(("ewma", sorted(h.ewma.items())))
    out.append(("gauges", h.gauges()))
    return out


def _hedge_events(seed, n=150):
    rng = np.random.default_rng(seed)
    workers = ["a:1", "b:2", "c:3"]
    events = []
    for _ in range(n):
        r = rng.random()
        w = workers[rng.integers(0, 3)]
        if r < 0.45:
            events.append(("observe", w, float(rng.lognormal(-3.0, 1.0))))
        elif r < 0.6:
            events.append(("dispatch",))
        elif r < 0.8:
            events.append(("threshold", w))
        elif r < 0.95:
            events.append(("try",))
        else:
            events.append(("refund",))
    return events


HEDGE_CASES = [
    ("floor then history", dict(factor=2.0, floor_s=0.1, min_samples=2),
     [("threshold", "w"), ("observe", "w", 1.0), ("observe", "w", 1.0), ("threshold", "w")]),
    ("fleet backfills new workers", dict(factor=1.0, floor_s=0.001, min_samples=2),
     [("observe", "a", 0.5), ("observe", "b", 0.5), ("threshold", "never-seen")]),
    ("token budget", dict(ratio=0.5, burst=2.0),
     [("try",), ("try",), ("dispatch",), ("dispatch",), ("try",), ("try",)]),
    ("refund", dict(ratio=0.0, burst=2.0), [("try",), ("try",), ("refund",), ("try",)]),
    ("overflow bucket", dict(factor=1.0, floor_s=0.0, min_samples=1),
     [("observe", "w", 500.0), ("threshold", "w")]),
] + [(f"random {seed}", dict(factor=3.0, floor_s=0.01, min_samples=4, ratio=0.25,
                             burst=4.0), _hedge_events(seed)) for seed in range(4)]


@pytest.mark.parametrize("name,kw,events", HEDGE_CASES, ids=[c[0] for c in HEDGE_CASES])
def test_hedge_decisions_match_jax(name, kw, events, monkeypatch):
    monkeypatch.delenv("DATAFUSION_TPU_QOS", raising=False)
    assert _hedge_trace(port_hedge, events, **kw) == _hedge_trace(jax_hedge, events, **kw)


def test_hedge_from_env(monkeypatch):
    """The environment only switches hedging on; the tuning values are
    the port's module constants, the JAX package's defaults."""
    monkeypatch.delenv("DATAFUSION_TPU_HEDGE", raising=False)
    assert port_hedge.from_env() is None
    monkeypatch.setenv("DATAFUSION_TPU_HEDGE", "1")
    for knob in ("FACTOR", "FLOOR_S", "QUANTILE", "MIN_SAMPLES", "RATIO", "BURST"):
        monkeypatch.delenv(f"DATAFUSION_TPU_HEDGE_{knob}", raising=False)
    t, j = port_hedge.from_env(), jax_hedge.from_env()
    assert t is not None and j is not None
    keys = ("factor", "floor_s", "quantile", "min_samples", "ratio", "burst")
    assert [getattr(t, k) for k in keys] == [getattr(j, k) for k in keys]
    assert t.floor_s == port_hedge.HEDGE_FLOOR_S


def test_breaker_constants_match_jax_defaults(monkeypatch):
    for knob in ("FAILURES", "RATIO", "WINDOW", "OPEN_S", "PROBES"):
        monkeypatch.delenv(f"DATAFUSION_TPU_BREAKER_{knob}", raising=False)
    t, j = port_breaker.CircuitBreaker("w"), jax_breaker.CircuitBreaker("w")
    keys = ("failures", "ratio", "window", "open_s", "half_open_probes")
    assert [getattr(t, k) for k in keys] == [getattr(j, k) for k in keys]


SLICE_MODULES = ["parallel/__init__.py", "parallel/physical.py", "parallel/mesh.py",
                 "parallel/partition.py", "parallel/shuffle.py", "parallel/worker.py",
                 "parallel/coordinator.py", "worker.py", "utils/eventloop.py",
                 "utils/hedge.py", "utils/breaker.py"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_distributed_modules_are_the_ports_own(module):
    """The distributed slice's modules import neither jax nor the JAX
    package (a module of it without JAX code included)."""
    import pathlib
    import re

    path = pathlib.Path(__file__).resolve().parents[1] / "datafusion_tpu_torch" / module
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|datafusion_tpu)\b(?!_torch)", text,
                         re.MULTILINE)
