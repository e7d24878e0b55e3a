"""Per-target circuit breakers for the distributed data plane (the JAX
package's `utils/breaker.py`, whole).

A crash failure is cheap to handle: the connect refuses, failover
replays the fragment elsewhere, done.  A *gray* failure — the target
is alive enough to accept connections but too sick to answer inside
its deadline — is the expensive kind: every request routed at it pays
the full timeout before learning what the last ten requests already
learned.  A circuit breaker is that memory: per-target outcome
history folded into a three-state machine, consulted *before* the
next request is routed.

    closed ──(consecutive failures, or failure ratio over the
              outcome window)──▶ open
    open ──(cool-down lapses)──▶ half-open
    half-open ──(a bounded number of concurrent probe requests;
                 first success)──▶ closed
    half-open ──(probe failure)──▶ open  (cool-down re-arms)

Call sites pair ``allow()`` (route this request at the target?) with
``record(ok)`` (how it went).  ``allow()`` in the open state is a
fast refusal — the caller picks a different worker / cluster endpoint
or serves degraded (shared cache: local-only) instead of queueing on
a sick target.  In the half-open state it admits at most
``half_open_probes`` in-flight probes so a thundering herd cannot
re-wedge a barely-recovered target; ``denies()`` is the pure peek for
callers that only want to *order* candidates (the cluster client's
failover sweep) without reserving a probe slot.

Targets are named strings (``worker:host:port`` in the port, whose
coordinator is the only caller; the JAX package's cluster client and
shared tier name theirs too); the process-global registry keeps one
breaker per name so every consumer of a target shares its evidence.  State
transitions count ``breaker.opened/closed/half_opens`` and emit
flight-recorder events; every breaker renders a
``breaker.<name>.state`` gauge (0=closed, 1=half-open, 2=open) into
the Prometheus scrapes.

Default **off** (`DATAFUSION_TPU_BREAKER=1` arms it): with breakers
disabled, ``breaker_for`` returns None and every call site degenerates
to a None test — existing paths are byte-identical.

Constants (the JAX package's env defaults; `CircuitBreaker(...)` takes
each as an argument): open on 5 consecutive failures or a failure ratio
of 0.5 over a full window of 20 outcomes, a cool-down of 10 s, one
concurrent half-open probe.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import _env_bool

CLOSED = 0
HALF_OPEN = 1
OPEN = 2

_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

BREAKER_FAILURES = 5
BREAKER_RATIO = 0.5
BREAKER_WINDOW = 20
BREAKER_OPEN_S = 10.0
BREAKER_PROBES = 1


class CircuitBreaker:
    """One target's breaker.  Thread-safe; `now` is injectable so
    cool-down tests run without sleeping."""

    def __init__(self, name: str,
                 failures: int = BREAKER_FAILURES,
                 ratio: float = BREAKER_RATIO,
                 window: int = BREAKER_WINDOW,
                 open_s: float = BREAKER_OPEN_S,
                 half_open_probes: int = BREAKER_PROBES,
                 now=time.monotonic):
        from datafusion_tpu_torch.analysis import lockcheck

        self.name = name
        self.failures = int(failures)
        self.ratio = float(ratio)
        self.window = int(window)
        self.open_s = float(open_s)
        self.half_open_probes = int(half_open_probes)
        self._now = now
        # one shared lock NAME for every breaker: the lockcheck graph
        # tracks lock ORDER by name, and breakers never nest in each
        # other or hold their lock across a blocking call
        self._lock = lockcheck.make_lock("utils.breaker")
        self._state = CLOSED
        self._consecutive = 0
        self._outcomes: deque = deque(maxlen=max(self.window, 1))
        self._opened_at = 0.0
        self._probes_inflight = 0

    # -- introspection --
    @property
    def state(self) -> str:
        return _STATE_NAMES[self._state]

    @property
    def state_code(self) -> int:
        return self._state

    def __repr__(self):
        return f"CircuitBreaker({self.name}, {self.state})"

    # -- transitions (lock held) --
    def _flight(self, kind: str) -> None:
        from datafusion_tpu_torch.obs import recorder

        recorder.record(kind, target=self.name)

    def _to_open(self) -> None:
        reopening = self._state == HALF_OPEN
        self._state = OPEN
        self._opened_at = self._now()
        self._consecutive = 0
        self._outcomes.clear()
        self._probes_inflight = 0
        METRICS.add("breaker.reopened" if reopening else "breaker.opened")
        self._flight("breaker.open")

    def _to_half_open(self) -> None:
        self._state = HALF_OPEN
        self._probes_inflight = 0
        METRICS.add("breaker.half_opens")
        self._flight("breaker.half_open")

    def _to_closed(self) -> None:
        self._state = CLOSED
        self._consecutive = 0
        self._outcomes.clear()
        self._probes_inflight = 0
        METRICS.add("breaker.closed")
        self._flight("breaker.close")

    # -- the call-site pair --
    def allow(self) -> bool:
        """May a request be routed at this target now?  Open: fast
        refusal until the cool-down lapses.  Half-open: reserves one of
        the bounded probe slots (released by the paired `record`)."""
        with self._lock:
            if self._state == OPEN:
                if self._now() - self._opened_at < self.open_s:
                    METRICS.add("breaker.denials")
                    return False
                self._to_half_open()
            if self._state == HALF_OPEN:
                if self._probes_inflight >= self.half_open_probes:
                    METRICS.add("breaker.denials")
                    return False
                self._probes_inflight += 1
            return True

    def denies(self) -> bool:
        """Pure peek: would `allow()` refuse outright?  Never reserves
        a probe slot — for candidate ORDERING (skip open targets while
        alternatives exist), not admission."""
        with self._lock:
            return (self._state == OPEN
                    and self._now() - self._opened_at < self.open_s)

    def record(self, ok: bool) -> None:
        """Fold one request outcome in.  A request that started before
        a state change may report late (a hedge loser finishing after
        the breaker opened); open-state reports inside the cool-down
        are dropped and half-open accounting is clamped, so late
        evidence can skew a probe verdict at worst — never corrupt the
        counters.  An outcome against a COOLED open breaker counts as
        the probe (peek-style consumers like the cluster sweep use
        `denies()` without ever reserving via `allow()` — without this
        transition their breakers could never close)."""
        with self._lock:
            if self._state == OPEN:
                if self._now() - self._opened_at < self.open_s:
                    return
                self._to_half_open()
            if self._state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if ok:
                    self._to_closed()
                else:
                    self._to_open()
                return
            self._outcomes.append(ok)
            if ok:
                self._consecutive = 0
                return
            self._consecutive += 1
            window_full = len(self._outcomes) == self._outcomes.maxlen
            failed = sum(1 for o in self._outcomes if not o)
            if self._consecutive >= self.failures or (
                    window_full
                    and failed / len(self._outcomes) >= self.ratio):
                self._to_open()


# -- process-global registry ------------------------------------------
_REGISTRY: dict[str, CircuitBreaker] = {}
_ENABLED_OVERRIDE: Optional[bool] = None
# bound against worker churn: ephemeral-port workers mint a fresh
# `worker:host:port` breaker per restart, and an unbounded registry
# would grow memory AND one `breaker.<name>.state` scrape line per
# dead target forever (same rationale as shared_cache's
# _PUBLISHED_KEYS_MAX)
_REGISTRY_MAX = 512


def _evict_one() -> None:
    """Make room for a new breaker: drop the oldest CLOSED one (open/
    half-open breakers hold live failure evidence); if every breaker
    is mid-incident (pathological), drop the oldest outright.  Racy-
    tolerant: a concurrent eviction at worst drops one extra entry."""
    for key, b in list(_REGISTRY.items()):
        if b.state_code == CLOSED:
            _REGISTRY.pop(key, None)
            return
    for key in _REGISTRY:
        _REGISTRY.pop(key, None)
        return


def enabled() -> bool:
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    return _env_bool("DATAFUSION_TPU_BREAKER")


def configure(enabled: Optional[bool] = None) -> None:
    """Test/embedding override of the env switch (None = back to env)."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = enabled


def breaker_for(name: str) -> Optional[CircuitBreaker]:
    """The named target's breaker — None when breakers are disabled
    (the call-site contract: one None test, nothing else changes)."""
    if not enabled():
        return None
    b = _REGISTRY.get(name)
    if b is None:
        if len(_REGISTRY) >= _REGISTRY_MAX:
            _evict_one()
        # setdefault keeps a racing creator's breaker (and its evidence)
        b = _REGISTRY.setdefault(name, CircuitBreaker(name))
    return b


def gauges() -> dict:
    """``breaker.<name>.state`` per registered breaker (0=closed,
    1=half-open, 2=open) — folded into every `metrics_text` scrape so
    an open circuit (degraded mode) is visible from the outside.
    Iterates a `.copy()` (atomic under the GIL): a dispatch thread may
    mint a new worker's breaker mid-scrape."""
    return {f"breaker.{name}.state": b.state_code
            for name, b in sorted(_REGISTRY.copy().items())}


def reset() -> None:
    """Drop every registered breaker (tests)."""
    _REGISTRY.clear()
