"""The device pass seam and transient-failure retry (the JAX package's
`utils/retry.py`).

Every device pass of an operator (one batch group of the aggregate, the
pipeline or the TopK, a full sort's run, a join's build and probe) runs
through `device_call(fn, *args, _tag=..., _device=...)`, which

- counts `device.launches` and `device.launches.<tag>` with the JAX
  package's tags (`agg`, `agg.group`, `pipeline`, `pipeline.group`,
  `topk`, `topk.group`, `sort`, `join.build`, `join.probe`),
- times the pass into the `device.dispatch` stage timer (the "execute"
  phase of `obs/device.phase_breakdown`) and publishes that stage to the
  sampling profiler while `fn` runs,
- attributes the launch to the ambient operator (`obs/stats.record_launch`)
  and its time to this thread's charge scope (`obs/attribution.note_launch`:
  the client a served query runs for, or a megabatch's members by
  weight),
- consults the ``device.call`` fault site (`testing/faults.py`) before
  each attempt, and replays a pass that raised a transient error.

A pass queues CUDA work and returns before the card has done it, so
outside `obs/device.profile_sync()` and outside a charge scope the
timer measures the host's launch work only, and the seam adds no
synchronize and no event.  Inside `profile_sync`, a pass on a CUDA
device records a `torch.cuda.Event(enable_timing=True)` pair around
`fn`, waits on the second at the end of the pass and accrues the
elapsed device time instead, so EXPLAIN ANALYZE's "execute" is device
time.  Under a charge scope (a served query, `obs/attribution`), a pass
on the card records the pair and does not wait: the scope's exit,
after the query has read its result back, accrues the pair's device
time into the timer and the tenant's meter, so a tenant is billed the
card's time, not the host's.

**Retry.**  Classification is typed (`errors.classify_transient`): a
`TransientError` (``DeviceTransientError`` from the fault plan, an
ingest or cluster unavailability) or a `ConnectionError` replays;
everything else raises on its first attempt.  On CUDA that is every
runtime error: a torch or CUDA `RuntimeError` (most CUDA errors are
sticky: the context is unusable after them), `torch.cuda.OutOfMemoryError`,
a failed `nvcc` build and a failed kernel launch (`ExecutionError`).  A
replay calls the same `fn` on the same tensors, so it launches the same
kernel; it never falls back to a plain version.  Backoff is capped
exponential with full jitter (`backoff_s`, seedable with
`seed_backoff`), and a backoff the ambient query deadline
(`utils.deadline`) cannot cover raises `QueryDeadlineError` instead of
sleeping.  Metrics: ``device.transient_retries``,
``device.retry_budget_exhausted``; flight events ``device.retry`` and
``device.retry_denied``.

**Retry budget** (default off): `RetryBudget` is a process-global token
bucket capping retries to a ratio of first attempts (each first attempt
earns ``ratio`` tokens, each retry spends one, a spend on an empty
bucket is denied and the failure surfaces at once).  Under QoS
(``DATAFUSION_TPU_QOS=1``, qos.py) it grows per-tenant child buckets
(`qos.TenantBuckets`): a spend must pass the tenant's child first, and a
child denial never touches the global bucket (``tenant.<id>.retry_denied``
meter, ``retry.tenant_denied`` flight event).  Metrics:
``retry.first_attempts``, ``retry.budget_spent``, ``retry.budget_denied``,
``retry.tenant_denied``.

Constants: 4 attempts a pass, backoff base 0.25 s and cap 5.0 s.  A
budget is installed with `set_retry_budget(RetryBudget(ratio, burst))`
(the burst defaults to max(2, 10*ratio)).  The coordinator's fragment
reassignments spend the same budget (parallel/coordinator.py); its
hedge budget and circuit breakers are `utils/hedge.py` and
`utils/breaker.py`, switched on by the environment through `_env_bool`.
"""

from __future__ import annotations

import os
import random
import threading
import time

from datafusion_tpu_torch.errors import QueryDeadlineError, classify_transient
from datafusion_tpu_torch.obs import recorder
from datafusion_tpu_torch.obs.attribution import note_launch
from datafusion_tpu_torch.obs.device import profile_sync_active
from datafusion_tpu_torch.obs.stats import record_launch, record_retry
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils.deadline import current_deadline
from datafusion_tpu_torch.utils.metrics import (
    CLIENT_SCOPES,
    METRICS,
    stage_enter,
    stage_exit,
)


def _env_bool(name: str, default: bool = False) -> bool:
    """One truthy-env idiom for every resilience switch (breakers,
    hedging, the coordinator's local fallback)."""
    v = os.environ.get(name)
    if not v:
        return default
    return v.lower() in ("1", "true", "yes", "on")


_ATTEMPTS = 4
_BASE_S = 0.25
_CAP_S = 5.0

# module-level stream so tests can seed it (`seed_backoff`); full
# jitter means the sequence is what a deterministic test pins down
_RNG = random.Random()


def seed_backoff(seed: int) -> None:
    """Make the jitter stream deterministic (tests, fault replays)."""
    global _RNG
    _RNG = random.Random(seed)


def backoff_s(attempt: int, base: "float | None" = None,
              cap: "float | None" = None) -> float:
    """Sleep length before retry `attempt` (1-based): full jitter over a
    capped exponential, uniform in [0, min(cap, base * 2^(a-1))]."""
    base = _BASE_S if base is None else base
    cap = _CAP_S if cap is None else cap
    ceiling = min(cap, base * (2.0 ** (attempt - 1)))
    return _RNG.uniform(0.0, ceiling)


class TokenBucket:
    """Ratio/burst token bucket (the retry budget and its per-tenant
    children).  Internally locked: unlocked read-modify-writes would let
    concurrent spenders all pass the check on one remaining token."""

    __slots__ = ("ratio", "burst", "_tokens", "_lock")

    def __init__(self, ratio: float, burst: float, initial: float = 1.0):
        from datafusion_tpu_torch.analysis import lockcheck

        self.ratio = max(0.0, float(ratio))
        self.burst = float(burst)
        self._tokens = min(self.burst, float(initial))
        self._lock = lockcheck.make_lock("utils.token_bucket")

    def earn(self) -> None:
        """One unit of real traffic: accrue `ratio` tokens (capped)."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def spend(self) -> bool:
        """Consume one token; False = bucket empty, don't."""
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def refund(self) -> None:
        """Return a spent token (the spender never acted on it)."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + 1.0)

    @property
    def tokens(self) -> float:
        return self._tokens


class RetryBudget:
    """A `TokenBucket` bounding retries to a ratio of first attempts,
    with per-tenant child buckets under QoS (module docstring)."""

    def __init__(self, ratio: float, burst: "float | None" = None,
                 tenant_buckets=None):
        ratio = max(0.0, float(ratio))
        self._bucket = TokenBucket(
            ratio, float(burst) if burst is not None else max(2.0, 10.0 * ratio))
        if tenant_buckets is None:
            from datafusion_tpu_torch import qos

            tenant_buckets = qos.tenant_buckets_from_env(self._bucket.ratio,
                                                         self._bucket.burst)
        self._tenants = tenant_buckets

    @property
    def ratio(self) -> float:
        return self._bucket.ratio

    @property
    def burst(self) -> float:
        return self._bucket.burst

    @staticmethod
    def _resolve_client(client: "str | None") -> "str | None":
        """The tenant a budget operation bills: `client`, or this
        thread's published charge scope's."""
        if client is not None:
            return client
        from datafusion_tpu_torch import qos
        from datafusion_tpu_torch.obs.attribution import current_scope

        return qos.scope_client(current_scope())

    def earn(self, client: "str | None" = None) -> None:
        """One first attempt: accrue `ratio` tokens in the global bucket
        and, under QoS, in the tenant's child."""
        self._bucket.earn()
        if self._tenants is not None:
            client = self._resolve_client(client)
            if client is not None:
                self._tenants.earn(client)
        METRICS.add("retry.first_attempts")

    def spend(self, client: "str | None" = None) -> bool:
        """One retry wants to happen: True = granted (token consumed),
        False = denied."""
        if self._tenants is not None:
            client = self._resolve_client(client)
            if client is not None:
                if not self._tenants.spend(client):
                    # the tenant's own budget is spent: deny without
                    # touching the global bucket (the isolation contract)
                    METRICS.add("retry.budget_denied")
                    METRICS.add("retry.tenant_denied")
                    from datafusion_tpu_torch.obs.attribution import METER

                    METER.charge(client, "retry_denied", 1.0)
                    recorder.record("retry.tenant_denied", client=client)
                    return False
                if not self._bucket.spend():
                    # global denial: the child token was never acted on
                    self._tenants.refund(client)
                    METRICS.add("retry.budget_denied")
                    return False
                METRICS.add("retry.budget_spent")
                return True
        if not self._bucket.spend():
            METRICS.add("retry.budget_denied")
            return False
        METRICS.add("retry.budget_spent")
        return True

    @property
    def tokens(self) -> float:
        return self._bucket.tokens

    def tenant_tokens(self, client: str) -> "float | None":
        """`client`'s child-bucket balance (None when QoS is off)."""
        if self._tenants is None:
            return None
        return self._tenants.tokens(client)


_BUDGET: "RetryBudget | None" = None


def retry_budget() -> "RetryBudget | None":
    """The process-global budget (None = unbudgeted, the default)."""
    return _BUDGET


def set_retry_budget(budget: "RetryBudget | None") -> None:
    """Install or clear the process-global budget (tests, embedders)."""
    global _BUDGET
    _BUDGET = budget


def is_transient(err: Exception) -> bool:
    """Typed transient test (the public name callers know)."""
    return classify_transient(err) is not None


def _pass(fn, args, kwargs, tag, device):
    """One attempt of a device pass: run `fn`, time it, count it.
    Returns (result, seconds, events).  On a CUDA device inside
    `profile_sync`, `seconds` is the pass's device time (an event pair
    waited on here); on one under a charge scope (a served query),
    `events` is an event pair not waited on, whose device time the
    scope's exit folds into the timer and the meter
    (`obs/attribution.note_launch`), and `seconds` is 0; otherwise
    `seconds` is the host's wall around `fn`."""
    events = None
    sync = False
    if device is not None and device.type == "cuda":
        sync = profile_sync_active()
        if sync or threading.get_ident() in CLIENT_SCOPES:
            import torch

            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
    tok = stage_enter("device.dispatch")
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
        if events is not None:
            events[1].record()
            if sync:
                events[1].synchronize()
    finally:
        stage_exit(tok)
    if events is None:
        wall = time.perf_counter() - t0
    elif sync:
        wall, events = events[0].elapsed_time(events[1]) / 1e3, None
    else:
        wall = 0.0
    if tag is None:
        METRICS.tally("device.dispatch", wall, ("device.launches", 1))
    else:
        METRICS.tally("device.dispatch", wall, ("device.launches", 1),
                      (f"device.launches.{tag}", 1))
    record_launch()
    return out, wall, events


def device_call(fn, /, *args, _tag=None, _device=None, **kwargs):
    """Run one device pass `fn(*args, **kwargs)` on `_device`, replaying
    it on a transient failure (module docstring), and return its
    result."""
    attempt = 0
    budget = _BUDGET
    if budget is not None:
        budget.earn()
    while True:
        try:
            faults.check("device.call", attempt=attempt)
            out, wall, events = _pass(fn, args, kwargs, _tag, _device)
            # the pass charges this thread's scope: one dict read when
            # nothing is served
            note_launch(wall, events)
            return out
        except Exception as e:  # noqa: BLE001 — classified, most re-raise
            transient = classify_transient(e)
            if transient is None:
                raise
            attempt += 1
            if attempt >= _ATTEMPTS:
                raise
            if budget is not None and not budget.spend():
                # denied: under a correlated fault burst the budget turns
                # would-be retries into prompt failures
                METRICS.add("device.retry_budget_exhausted")
                recorder.record("device.retry_denied", attempt=attempt,
                                error=type(transient).__name__)
                raise
            delay = backoff_s(attempt)
            deadline = current_deadline()
            if deadline is not None and deadline.remaining() < delay:
                raise QueryDeadlineError(
                    f"transient device failure, but the query deadline "
                    f"({deadline.remaining():.3f}s left) cannot cover the "
                    f"{delay:.3f}s retry backoff") from transient
            METRICS.add("device.transient_retries")
            record_retry()
            recorder.record("device.retry", attempt=attempt,
                            error=type(transient).__name__,
                            backoff_s=round(delay, 4))
            time.sleep(delay)
