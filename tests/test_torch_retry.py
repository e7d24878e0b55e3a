"""PyTorch/CUDA port: transient-failure retry (`datafusion_tpu_torch.utils.retry`).

The cases of the JAX package's retry-budget tests
(`tests/test_resilience.py`, `tests/test_qos.py`'s tenant buckets), on
the port, each held against the JAX package where both decide the same
thing:

- the same `seed_backoff` jitter sequence;
- the same `TokenBucket`, `RetryBudget` and `TenantBuckets` spend, deny
  and refund sequence (numpy-seeded operation streams);
- `classify_transient`: a `TransientError` as it is, `ConnectionError`
  and `BrokenPipeError` mapped, and nothing torch or CUDA raises (a
  `RuntimeError`, `torch.cuda.OutOfMemoryError`, a failed build or
  launch, `ExecutionError`) ever transient;
- `device_call` replays a planted ``device.call`` fault, calling the
  same function again (the kernel, never its plain version), and raises
  a torch `RuntimeError` on its first attempt; a denied retry raises at
  once and counts, the tenant's own denial in its `retry_denied` meter;
  a backoff the query deadline cannot cover raises
  `QueryDeadlineError`.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from datafusion_tpu import errors as jerrors
from datafusion_tpu import qos as jqos
from datafusion_tpu.utils import retry as jretry

from datafusion_tpu_torch import errors as terrors
from datafusion_tpu_torch import qos as tqos
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs.attribution import METER, client_scope
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils import retry as tretry
from datafusion_tpu_torch.utils.deadline import Deadline, deadline_scope
from datafusion_tpu_torch.utils.metrics import METRICS


def _count(name: str) -> int:
    return METRICS.snapshot()["counts"].get(name, 0)


@pytest.fixture(autouse=True)
def _no_budget_fast_backoff(monkeypatch):
    monkeypatch.setattr(tretry, "_BASE_S", 0.001)
    monkeypatch.setattr(tretry, "_CAP_S", 0.002)
    tretry.set_retry_budget(None)
    yield
    tretry.set_retry_budget(None)
    faults.clear()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_same_seeded_backoff_sequence(seed):
    jretry.seed_backoff(seed)
    tretry.seed_backoff(seed)
    attempts = [1, 2, 3, 4, 5, 6, 9]
    want = [jretry.backoff_s(a, base=0.25, cap=5.0) for a in attempts]
    got = [tretry.backoff_s(a, base=0.25, cap=5.0) for a in attempts]
    assert got == want
    assert all(0.0 <= g <= min(5.0, 0.25 * 2 ** (a - 1)) for a, g in zip(attempts, got))


def _ops(seed: int, n: int = 60, clients=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    kinds = np.array(["earn", "spend", "refund"])
    return [(str(kinds[k]), clients[c]) for k, c in
            zip(rng.choice(3, n, p=[0.45, 0.45, 0.1]), rng.integers(0, len(clients), n))]


@pytest.mark.parametrize("seed,ratio,burst", [(1, 0.5, 2.0), (2, 0.2, 1.0), (3, 1.0, 4.0)])
def test_token_bucket_same_sequence(seed, ratio, burst):
    jb, tb = jretry.TokenBucket(ratio, burst), tretry.TokenBucket(ratio, burst)
    for op, _ in _ops(seed):
        want = getattr(jb, op)()
        assert getattr(tb, op)() == want
        assert tb.tokens == jb.tokens


@pytest.mark.parametrize("seed,shares", [(4, {"a": 1.0, "b": 7.0}), (5, None),
                                         (6, {"a": 3.0, "b": 1.0, "c": 1.0})])
def test_retry_budget_with_tenant_buckets_same_sequence(seed, shares):
    """The global bucket and the tenants' children spend, deny and
    refund alike: a child denial never touches the global bucket, a
    global denial refunds the child."""
    jtb = jqos.TenantBuckets(0.5, 4.0, shares)
    ttb = tqos.TenantBuckets(0.5, 4.0, shares)
    jb = jretry.RetryBudget(0.5, 4.0, tenant_buckets=jtb)
    tb = tretry.RetryBudget(0.5, 4.0, tenant_buckets=ttb)
    for op, client in _ops(seed):
        if op == "refund":
            jtb.refund(client)
            ttb.refund(client)
        elif op == "earn":
            jb.earn(client=client)
            tb.earn(client=client)
        else:
            assert tb.spend(client=client) == jb.spend(client=client)
        assert tb.tokens == jb.tokens
        assert tb.tenant_tokens(client) == jb.tenant_tokens(client)
    assert ttb.gauges("retry") == jtb.gauges("retry")


def test_child_denial_meters_the_tenant():
    tb = tqos.TenantBuckets(1.0, 8.0, {"a": 1.0, "b": 7.0})
    budget = tretry.RetryBudget(1.0, 8.0, tenant_buckets=tb)
    denied = METER.snapshot().get("a", {}).get("retry_denied", 0.0)
    for _ in range(5):
        budget.earn(client="a")
    assert budget.spend(client="a") is True
    assert budget.spend(client="a") is False
    assert budget.tokens == 5.0
    assert budget.spend(client="b") is True
    assert METER.snapshot()["a"]["retry_denied"] == denied + 1
    # the scope names the tenant when no client is passed
    with client_scope("b"):
        assert tb.tokens("b") == budget.tenant_tokens("b")
        budget.earn()
    assert tqos.tenant_buckets_from_env(0.25, 4.0) is None
    assert tretry.RetryBudget(0.25)._tenants is None


def test_token_bucket_never_over_grants_concurrently():
    bucket = tretry.TokenBucket(0.0, burst=8.0, initial=8.0)
    granted = []
    barrier = threading.Barrier(16)

    def spender():
        barrier.wait(timeout=10)
        granted.append(sum(bucket.spend() for _ in range(4)))

    threads = [threading.Thread(target=spender) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sum(granted) == 8


def test_classify_transient():
    t = terrors.DeviceTransientError("drop")
    assert terrors.classify_transient(t) is t
    for exc in (ConnectionResetError("reset"), BrokenPipeError("pipe")):
        got = terrors.classify_transient(exc)
        want = jerrors.classify_transient(exc)
        assert type(got).__name__ == type(want).__name__ == "WorkerUnavailableError"
    permanent = [
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        RuntimeError("UNAVAILABLE: socket closed"),  # a JAX status token
        torch.cuda.OutOfMemoryError("CUDA out of memory"),
        terrors.ExecutionError("nvcc failed for hash_agg.cu"),
        terrors.ExecutionError("grouped_reduce kernel launch failed: CUDA error 700"),
        terrors.QueryDeadlineError("late"),
        ValueError("shape"),
    ]
    for exc in permanent:
        assert terrors.classify_transient(exc) is None, exc
        assert not tretry.is_transient(exc)


def test_device_call_replays_a_planted_fault():
    """Two injected transient failures, then the pass: the SAME function
    runs once more for each replay (a kernel wrapper on the card launches
    its kernel again), the replays count, and their flight events name
    the error."""
    calls = []

    def kernel(x):
        calls.append(x)
        return x + 1

    retries = _count("device.transient_retries")
    launches = _count("device.launches.test")
    with faults.scoped({"seed": 3, "rules": [
            {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
             "count": 2}]}):
        assert tretry.device_call(kernel, 41, _tag="test") == 42
    assert calls == [41]  # the fault fires before the pass runs
    assert _count("device.transient_retries") == retries + 2
    assert _count("device.launches.test") == launches + 1
    events = [e for e in recorder.events("device.retry")][-2:]
    assert [e["attrs"]["attempt"] for e in events] == [1, 2]
    assert {e["attrs"]["error"] for e in events} == {"DeviceTransientError"}

    # a transient error raised by the pass itself replays the same pass
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise terrors.DeviceTransientError("dropped")
        return "ok"

    assert tretry.device_call(flaky) == "ok" and state["n"] == 2


def test_torch_runtime_error_raises_on_its_first_attempt():
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    retries = _count("device.transient_retries")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tretry.device_call(broken)
    assert calls == [1]

    def oom():
        calls.append(2)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        tretry.device_call(oom)
    assert calls == [1, 2] and _count("device.transient_retries") == retries


def test_attempts_are_bounded(monkeypatch):
    monkeypatch.setattr(tretry, "_ATTEMPTS", 3)
    with faults.scoped({"rules": [
            {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
             "count": 0}]}):
        with pytest.raises(terrors.DeviceTransientError):
            tretry.device_call(lambda: 1)
    assert faults.active() is None


def test_denied_retry_raises_promptly_and_counts(monkeypatch):
    # QoS on: the tenant's child bucket (one initial token, no refill)
    # grants the first retry, then denies; the global bucket is not asked
    monkeypatch.setenv("DATAFUSION_TPU_QOS", "1")
    tretry.set_retry_budget(tretry.RetryBudget(0.0, burst=8.0))
    exhausted = _count("device.retry_budget_exhausted")
    denied = METER.snapshot().get("B", {}).get("retry_denied", 0.0)
    with faults.scoped({"rules": [
            {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
             "count": 0}]}):
        with client_scope("B"), pytest.raises(terrors.DeviceTransientError):
            tretry.device_call(lambda: 1)
    assert _count("device.retry_budget_exhausted") == exhausted + 1
    assert METER.snapshot()["B"]["retry_denied"] == denied + 1
    assert recorder.events("device.retry_denied")[-1]["attrs"]["attempt"] == 2
    assert tretry.retry_budget().tokens == 0.0


def test_within_budget_retries_spend_it():
    tretry.set_retry_budget(tretry.RetryBudget(1.0, burst=4.0))
    spent = _count("retry.budget_spent")
    with faults.scoped({"rules": [
            {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
             "count": 2}]}):
        assert tretry.device_call(lambda: 41) == 41
    assert _count("retry.budget_spent") == spent + 2


def test_backoff_past_the_deadline_raises(monkeypatch):
    monkeypatch.setattr(tretry, "_BASE_S", 10.0)
    monkeypatch.setattr(tretry, "_CAP_S", 10.0)
    tretry.seed_backoff(1)
    with faults.scoped({"rules": [
            {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
             "count": 1}]}):
        with deadline_scope(Deadline.after(0.05)), pytest.raises(terrors.QueryDeadlineError):
            tretry.device_call(lambda: 1)
