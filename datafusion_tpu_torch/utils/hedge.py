"""Hedged-dispatch policy: when to speculatively re-send a fragment (the
JAX package's `utils/hedge.py`, whole, with its own copy of the log2
`LatencyHistogram` of the JAX package's `obs/aggregate.py`, whose fleet
aggregation waits for ROADMAP item 13.2).

Tail latency in a scatter-gather engine is set by the *slowest*
replica, not the median — one alive-but-slow worker (gray failure:
heartbeats renew, fragments crawl) stalls every query that routes a
fragment at it.  Hedging is the standard counter-measure (the
"tail at scale" defense): when a dispatched fragment has outrun what
its peers routinely achieve, send a duplicate to a different live
worker and take whichever valid response lands first.  Duplicates are
safe by construction here — fragments carry idempotent
``(query_id, shard)`` ids, workers serve replays from the fragment
cache, and the coordinator's merge loops drop duplicate responses.

`HedgeTracker` is the coordinator's evidence and throttle:

- **per-worker latency**: an EWMA and a mergeable log2
  `LatencyHistogram` per worker, fed by
  every successful dispatch, plus a fleet-wide histogram;
- **the hedge threshold**: ``max(floor, quantile(p) * factor)`` from
  the dispatched worker's own history (what *it* routinely achieves),
  falling back to the fleet histogram below ``min_samples``, and to
  the bare floor with no history at all;
- **a hedge budget**: a `utils/retry.TokenBucket` accruing ``ratio``
  tokens per primary dispatch and spending one per hedge, so hedges
  stay a bounded fraction of real traffic — a fleet-wide slowdown
  (overload, not one straggler) must not double its own load.

The observe/threshold path is deliberately **lock-free** (dict stores
and GIL-atomic bucket increments): it runs inside the dispatch path
beside spans and metrics.

Default **off** (`DATAFUSION_TPU_HEDGE=1` arms it; `from_env()`
returns None otherwise, and a None policy leaves the dispatch path
byte-identical).

Constants (the JAX package's env defaults; `HedgeTracker(...)` takes
each as an argument): threshold = quantile 0.95 of the history times
3.0, floor 0.25 s, 4 samples required per tier, 0.25 hedge tokens per
dispatch, a bucket cap of 4.0.
"""

from __future__ import annotations

import math
from typing import Optional

from datafusion_tpu_torch.utils.retry import TokenBucket, _env_bool

_BASE_S = 1e-6
_BUCKETS = 28

HEDGE_FACTOR = 3.0
HEDGE_FLOOR_S = 0.25
HEDGE_QUANTILE = 0.95
HEDGE_MIN_SAMPLES = 4
HEDGE_RATIO = 0.25
HEDGE_BURST = 4.0


class LatencyHistogram:
    """Mergeable log2 histogram with quantile estimation: latencies in
    [1 us, ~137 s) over 28 buckets, the last one open."""

    __slots__ = ("buckets", "count", "sum_s", "base", "nbuckets")

    def __init__(self, base: float = _BASE_S, nbuckets: int = _BUCKETS):
        self.base = float(base)
        self.nbuckets = int(nbuckets)
        self.buckets = [0] * self.nbuckets
        self.count = 0
        self.sum_s = 0.0

    def _index(self, value: float) -> int:
        if value <= self.base:
            return 0
        return min(int(math.log2(value / self.base)) + 1, self.nbuckets - 1)

    def _upper(self, i: int) -> float:
        if i >= self.nbuckets - 1:
            return math.inf
        return self.base * (2.0 ** i)

    def observe(self, seconds: float) -> None:
        self.buckets[self._index(seconds)] += 1
        self.count += 1
        self.sum_s += seconds

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the q-quantile (the true
        latency is <= this); None when empty.  A quantile in the open
        bucket reports a lower bound: the largest finite edge or the
        mean, whichever is larger."""
        if self.count <= 0:
            return None
        rank = max(math.ceil(q * self.count), 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= rank:
                ub = self._upper(i)
                if math.isinf(ub):
                    break
                return ub
        return max(self._upper(self.nbuckets - 2), self.sum_s / self.count)


class HedgeTracker:
    """Per-coordinator hedging evidence + budget (see module doc)."""

    def __init__(self, factor: float = HEDGE_FACTOR,
                 floor_s: float = HEDGE_FLOOR_S,
                 quantile: float = HEDGE_QUANTILE,
                 min_samples: int = HEDGE_MIN_SAMPLES,
                 ratio: float = HEDGE_RATIO, burst: float = HEDGE_BURST,
                 tenant_buckets=None):
        self.factor = float(factor)
        self.floor_s = float(floor_s)
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.ratio = float(ratio)
        self.burst = max(1.0, float(burst))
        # per-worker histograms + EWMAs and the fleet-wide histogram.
        # Written lock-free from dispatch threads (dict store, list
        # increment); a racing first-observe may drop one sample
        self._hists: dict[str, LatencyHistogram] = {}
        self.ewma: dict[str, float] = {}
        self._fleet = LatencyHistogram()
        # one initial token: the very first straggler can hedge
        self._bucket = TokenBucket(self.ratio, self.burst, initial=1.0)
        # multi-tenant QoS (datafusion_tpu/qos): per-tenant child
        # buckets drawing on the global one — a spend passes the
        # requesting tenant's child FIRST, and a child denial never
        # drains the global reserve.  None (QoS off) = byte-identical
        if tenant_buckets is None:
            from datafusion_tpu_torch import qos

            tenant_buckets = qos.tenant_buckets_from_env(
                self.ratio, self.burst
            )
        self._tenants = tenant_buckets

    # -- evidence (lock-free: rides the dispatch path) --
    def observe(self, target: str, seconds: float) -> None:
        """One successful fragment round trip against `target`."""
        h = self._hists.get(target)
        if h is None:
            h = self._hists.setdefault(target, LatencyHistogram())
        h.observe(seconds)
        self._fleet.observe(seconds)
        prev = self.ewma.get(target)
        self.ewma[target] = seconds if prev is None \
            else 0.8 * prev + 0.2 * seconds

    def observe_dispatch(self, client: "str | None" = None) -> None:
        """One primary dispatch: accrue hedge credit (ratio tokens) —
        globally and, under QoS, in the dispatching tenant's child."""
        self._bucket.earn()
        if self._tenants is not None and client is not None:
            self._tenants.earn(client)

    def threshold_s(self, target: str) -> float:
        """How long `target`'s in-flight fragment may run before a
        hedge fires: its own history's quantile x factor, the fleet's
        below min_samples, the bare floor with no history."""
        h = self._hists.get(target)
        if h is None or h.count < self.min_samples:
            h = self._fleet
        if h.count < self.min_samples:
            return self.floor_s
        q = h.quantile(self.quantile)
        if q is None:
            return self.floor_s
        return max(self.floor_s, q * self.factor)

    def try_hedge(self, client: "str | None" = None) -> bool:
        """Spend one hedge token; False = budget exhausted, don't
        hedge.  Under QoS the requesting tenant's child bucket is
        spent FIRST: a tenant that burned its own hedge budget is
        denied without the global bucket being consulted or drained
        (``tenant.<id>.hedge_denied`` meter, ``hedge.tenant_denied``
        flight event), so its storm cannot spend the fleet's
        speculative-recovery reserve."""
        if self._tenants is not None and client is not None:
            if not self._tenants.spend(client):
                from datafusion_tpu_torch.obs import recorder
                from datafusion_tpu_torch.obs.attribution import METER
                from datafusion_tpu_torch.utils.metrics import METRICS

                METRICS.add("hedge.tenant_denied")
                METER.charge(client, "hedge_denied", 1.0)
                recorder.record("hedge.tenant_denied", client=client)
                return False
            if not self._bucket.spend():
                # global denial: the child token was never acted on
                self._tenants.refund(client)
                return False
            return True
        return self._bucket.spend()

    def refund(self, client: "str | None" = None) -> None:
        """Return a spent token (the hedge was approved but never
        launched — e.g. no alternative worker existed)."""
        self._bucket.refund()
        if self._tenants is not None and client is not None:
            self._tenants.refund(client)

    # -- introspection --
    def gauges(self) -> dict:
        out = {"hedge.tokens": round(self._bucket.tokens, 3)}
        if self._tenants is not None:
            out.update(self._tenants.gauges("hedge"))
        # .copy(): dispatch threads insert new workers mid-scrape
        for target, v in sorted(self.ewma.copy().items()):
            out[f"hedge.ewma_s.{target}"] = round(v, 6)
        return out


def from_env() -> Optional[HedgeTracker]:
    """A tracker at the module's constants when `DATAFUSION_TPU_HEDGE`
    arms hedging, else None (the default) — a None policy is the
    byte-identical dispatch path."""
    if not _env_bool("DATAFUSION_TPU_HEDGE"):
        return None
    return HedgeTracker()
