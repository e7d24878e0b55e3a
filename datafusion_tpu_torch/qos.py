"""Multi-tenant QoS enforcement (the JAX package's `qos.py`).

Metering (obs/attribution.py) apportions every cost a served query
incurs back to its ``client_id``.  This module is the policy the
enforcement seams share:

- **Weighted fair-share ordering** (`FairSharePolicy.order`): the
  serving front door's batching window drains each tenant's backlog in
  proportion to its share.  Virtual-time WFQ over the meters: a
  tenant's i-th queued query is stamped ``(attained + (i+1) * unit) /
  share``, so the tenant that has had the least normalized service goes
  first and a share-3 tenant drains 3 queries per share-1 query under
  contention.  Deadline urgency breaks ties within a tenant only.
- **Over-quota shedding** (`FairSharePolicy.shed_victim`): when the
  admission queue is full, the tenant furthest over its share sheds
  first: its newest, least urgent queued query, or the incoming one when
  the submitter itself is furthest over, with the ``quota`` reason.
  `admitted + shed == submitted` is untouched: the victim goes through
  the server's one exactly-once shed.
- **Per-tenant isolation budgets** (`TenantBuckets`): the retry budget
  (`utils/retry.RetryBudget`) grows per-tenant child buckets; a spend
  must pass the tenant's child first, and a child denial never touches
  the global bucket.
- **Elastic capacity signal** (`scale_hint`): an SLO burn rate and the
  tail explainer's queue_wait share folded into +1 / 0 / -1.

Everything is off by default: with ``DATAFUSION_TPU_QOS`` unset (or
``0``) and no ``Server(shares=...)``, `policy_from_config` returns None,
and a None policy is the FIFO admission of the serving front door.
Shares come from ``DATAFUSION_TPU_QOS_SHARES`` (``"tenantA=3,tenantB=1"``)
or ``Server(shares={...})``; an unlisted tenant weighs
`default_share()` (1.0) unless `FairSharePolicy(default=...)` says
otherwise.

`scope_client` and `TenantBuckets` also bill the coordinator's fragment
dispatch (parallel/coordinator.py): its reassignment retries and its
hedges spend the dispatching tenant's child buckets.  Not ported yet:
`debug_snapshot` and the ``/debug/qos`` document (they read the SLO
watchdog) and the coordinator's pin-aware placement (it reads the
cluster's lease advertisements), all ROADMAP item 13.2.
"""

from __future__ import annotations

import os
from typing import Optional

from datafusion_tpu_torch.utils.metrics import METRICS

# a queued query with no cost history yet still advances its tenant's
# virtual time by one nominal service unit; the serving path passes
# the live service EWMA instead once it has one
_NOMINAL_COST_S = 1e-3

# per-tenant child-bucket cardinality cap: same contract as the meter's
# _MAX_CLIENTS — the long tail folds into one overflow bucket instead
# of growing the table without bound
_MAX_TENANT_BUCKETS = 64
_OVERFLOW = "~overflow"


def enabled() -> bool:
    """The master opt-in: ``DATAFUSION_TPU_QOS=1``.  Unset/0 keeps
    every enforcement seam byte-identical to the pre-QoS paths."""
    v = os.environ.get("DATAFUSION_TPU_QOS")
    if not v:
        return False
    return v.lower() in ("1", "true", "yes", "on")


def default_share() -> float:
    return 1.0


def parse_shares(spec: Optional[str]) -> dict[str, float]:
    """``"a=3,b=1"`` -> ``{"a": 3.0, "b": 1.0}``.  Zero/negative
    weights are clamped to a tiny positive share (a zero divisor would
    make the tenant unschedulable rather than deprioritized)."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        cid, _, w = part.partition("=")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            continue
        out[cid.strip()] = max(weight, 1e-6)
    return out


def shares_from_env() -> dict[str, float]:
    return parse_shares(os.environ.get("DATAFUSION_TPU_QOS_SHARES"))


def scope_client(scope) -> Optional[str]:
    """The tenant a published charge scope bills: the solo client, or
    a shared (megabatched) scope's dominant-weight member — the budget
    tables need ONE accountable identity per spend, and the heaviest
    member is the one whose storm a megabatch would be carrying."""
    if scope is None:
        return None
    if scope[0] == "solo":
        return scope[1]
    members = scope[1]
    if not members:
        return None
    return max(members, key=lambda m: m[1])[0]


class FairSharePolicy:
    """Weighted fair queueing keyed by the attribution meters.

    Stateless between calls except for the share table: attained cost
    is read fresh from `obs.attribution.METER` at every ordering /
    shed decision, so the policy follows the meters the scrape and
    heartbeat planes already publish instead of keeping a second
    accounting."""

    def __init__(self, shares: Optional[dict] = None,
                 default: Optional[float] = None):
        self.shares = {
            str(cid): max(float(w), 1e-6)
            for cid, w in (shares or {}).items()
        }
        self.default_share = max(
            float(default if default is not None else default_share()),
            1e-6,
        )

    def share(self, client: str) -> float:
        return self.shares.get(client, self.default_share)

    # -- attained service (the WFQ clock) -----------------------------
    @staticmethod
    def attained_costs() -> dict[str, float]:
        """Per-tenant attained service, in seconds: the metered device
        seconds (on the card, the device time of the tenant's passes;
        on the CPU, the host's wall around them) plus a nominal floor
        per query (so an all-cached or CPU-trivial workload still
        advances its tenant's clock)."""
        from datafusion_tpu_torch.obs.attribution import METER

        out: dict[str, float] = {}
        for cid, costs in METER.snapshot().items():
            out[cid] = (costs.get("device_seconds", 0.0)
                        + _NOMINAL_COST_S * costs.get("queries", 0.0)
                        + costs.get("hedge_duplicate_seconds", 0.0))
        return out

    def normalized(self, client: str,
                   attained: Optional[dict] = None) -> float:
        """`client`'s attained service divided by its share — the
        virtual time WFQ schedules on."""
        att = self.attained_costs() if attained is None else attained
        return att.get(client, 0.0) / self.share(client)

    @staticmethod
    def _urgency(ticket) -> float:
        """Within-tenant tiebreak: remaining deadline budget (smaller
        = more urgent); deadline-free queries sort last."""
        d = getattr(ticket, "deadline", None)
        if d is None:
            return float("inf")
        try:
            return d.remaining()
        except Exception:  # noqa: BLE001 — a broken deadline must not break ordering
            return float("inf")

    def order(self, tickets: list, unit_cost_s: Optional[float] = None,
              attained: Optional[dict] = None) -> list:
        """One batching window's drain order under weighted fair
        queueing.  Each tenant's backlog is sorted by deadline urgency
        (then arrival), then its i-th query is stamped with the virtual
        finish time ``(attained + (i+1) * unit_cost) / share``; the
        global order is ascending virtual time, arrival-stable.  A
        share-w tenant therefore drains w queries per unit-share query
        while both have backlog — proportional service, not strict
        priority."""
        if len(tickets) < 2:
            return list(tickets)
        att = self.attained_costs() if attained is None else attained
        unit = unit_cost_s if unit_cost_s else _NOMINAL_COST_S
        by_tenant: dict[str, list] = {}
        for seq, t in enumerate(tickets):
            by_tenant.setdefault(t.client_id, []).append((seq, t))
        keyed = []
        for cid, items in by_tenant.items():
            share = self.share(cid)
            base = att.get(cid, 0.0) / share
            items.sort(key=lambda st: (self._urgency(st[1]), st[0]))
            for i, (seq, t) in enumerate(items):
                keyed.append((base + (i + 1) * unit / share, seq, t))
        keyed.sort(key=lambda k: (k[0], k[1]))
        return [t for _, _, t in keyed]

    def shed_victim(self, queued: list, incoming_client: str):
        """Under queue-full pressure, who sheds?  Returns
        ``(ticket, incoming_is_victim)``: the most-over-quota tenant's
        newest / least-urgent queued ticket, or ``(None, True)`` when
        the *incoming* tenant is itself the furthest over its share —
        then the new arrival sheds with the ``quota`` reason and
        nothing queued is disturbed."""
        att = self.attained_costs()
        worst_cid, worst_norm = incoming_client, self.normalized(
            incoming_client, att)
        by_tenant: dict[str, list] = {}
        for t in queued:
            by_tenant.setdefault(t.client_id, []).append(t)
        for cid in by_tenant:
            norm = self.normalized(cid, att)
            if norm > worst_norm:
                worst_cid, worst_norm = cid, norm
        if worst_cid == incoming_client or worst_cid not in by_tenant:
            return None, True
        victims = by_tenant[worst_cid]
        # least urgent first among the over-quota tenant's backlog:
        # latest deadline, then newest arrival
        victims.sort(key=lambda t: (-self._urgency(t),
                                    -getattr(t, "entry_mono", 0.0)))
        return victims[0], False

    # -- introspection ------------------------------------------------
    def snapshot(self) -> dict:
        att = self.attained_costs()
        return {
            "enabled": True,
            "default_share": self.default_share,
            "shares": dict(sorted(self.shares.items())),
            "attained": {
                cid: {
                    "cost_s": round(v, 6),
                    "share": self.share(cid),
                    "normalized": round(v / self.share(cid), 6),
                }
                for cid, v in sorted(att.items())
            },
        }


def policy_from_config(shares=None) -> Optional[FairSharePolicy]:
    """The serving front door's policy hook: a `FairSharePolicy` when
    QoS is armed (env) or shares were configured explicitly on the
    `Server`; None otherwise — and a None policy IS the byte-identical
    FIFO path."""
    if shares is None and not enabled():
        return None
    if isinstance(shares, str):
        shares = parse_shares(shares)
    merged = dict(shares_from_env())
    merged.update(shares or {})
    return FairSharePolicy(merged)


class TenantBuckets:
    """Per-tenant child token buckets drawing on one global parent
    (`utils/retry.TokenBucket` consumers: the retry budget and the
    hedge budget).  Each tenant earns credit only from its OWN traffic
    and holds a burst capped at its share of the parent's, so a single
    client's storm exhausts its child long before it could drain the
    global bucket — and a child denial never touches the parent.
    Cardinality-capped like the meter: past ``_MAX_TENANT_BUCKETS``
    tenants, the long tail shares one overflow child."""

    def __init__(self, ratio: float, parent_burst: float,
                 shares: Optional[dict] = None):
        from datafusion_tpu_torch.analysis import lockcheck

        self.ratio = max(0.0, float(ratio))
        self.parent_burst = max(1.0, float(parent_burst))
        self.shares = {
            str(cid): max(float(w), 1e-6)
            for cid, w in (shares or {}).items()
        }
        self._buckets: dict = {}
        self._lock = lockcheck.make_lock("qos.tenant_buckets")

    def _burst_for(self, client: str) -> float:
        if self.shares:
            total = sum(self.shares.values())
            sh = self.shares.get(client, default_share())
            return max(1.0, self.parent_burst * sh / max(total, sh))
        # shareless: every tenant may hold at most half the global
        # burst, so no single client can pre-bank the whole reserve
        return max(1.0, self.parent_burst / 2.0)

    def _bucket(self, client: str):
        b = self._buckets.get(client)
        if b is not None:
            return b
        from datafusion_tpu_torch.utils.retry import TokenBucket

        with self._lock:
            b = self._buckets.get(client)
            if b is None:
                if (len(self._buckets) >= _MAX_TENANT_BUCKETS
                        and client != _OVERFLOW):
                    # long-tail fold: the overflow child is created
                    # HERE, not via recursion — the lock is not
                    # reentrant
                    METRICS.add("qos.tenant_bucket_overflow")
                    b = self._buckets.get(_OVERFLOW)
                    if b is None:
                        b = TokenBucket(self.ratio,
                                        self._burst_for(_OVERFLOW),
                                        initial=1.0)
                        self._buckets[_OVERFLOW] = b
                    return b
                b = TokenBucket(self.ratio, self._burst_for(client),
                                initial=1.0)
                self._buckets[client] = b
        return b

    def earn(self, client: str) -> None:
        self._bucket(client).earn()

    def spend(self, client: str) -> bool:
        """Consume one of `client`'s child tokens; False = the tenant's
        own budget is exhausted (the global bucket is NOT consulted and
        NOT touched — that's the isolation contract)."""
        return self._bucket(client).spend()

    def refund(self, client: str) -> None:
        self._bucket(client).refund()

    def tokens(self, client: str) -> float:
        return self._bucket(client).tokens

    def gauges(self, prefix: str) -> dict:
        out = {}
        for cid, b in sorted(self._buckets.copy().items()):
            out[f"{prefix}.tenant_tokens.{cid}"] = round(b.tokens, 3)
        return out


def tenant_buckets_from_env(ratio: float,
                            parent_burst: float) -> Optional[TenantBuckets]:
    """Child buckets for a global budget, or None when QoS is off —
    the byte-identical process-global path."""
    if not enabled():
        return None
    return TenantBuckets(ratio, parent_burst, shares_from_env())


# -- elastic capacity ----------------------------------------------------
_SCALE_BURN_UP = 1.0       # an SLO burning at >= 1x is out of budget
_SCALE_QUEUE_SHARE = 0.5   # ... and queueing dominating the tail
_SCALE_BURN_DOWN = 0.1     # every SLO under 10% of budget: headroom


def scale_hint(max_burn_rate: Optional[float],
               queue_wait_share: Optional[float]) -> int:
    """Fold SLO burn and tail shape into one capacity signal:

    +1  scale up — an objective is burning through its budget AND the
        tail explainer says queue_wait dominates (the fleet is
        saturated; more replicas would absorb the backlog),
     0  steady — burning but not queue-bound (scaling would not help;
        look at the dominant segment instead), or no evidence yet,
    -1  scale down — every objective far under budget and the queue
        share negligible: capacity is going idle."""
    if max_burn_rate is None:
        return 0
    q = queue_wait_share or 0.0
    if max_burn_rate >= _SCALE_BURN_UP and q >= _SCALE_QUEUE_SHARE:
        return 1
    if max_burn_rate <= _SCALE_BURN_DOWN and q < _SCALE_QUEUE_SHARE:
        return -1
    return 0
