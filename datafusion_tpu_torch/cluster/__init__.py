"""Cluster control plane: shared membership, lease KV, cache coherence,
replicated with primary/standby failover (the JAX package's `cluster/`).

The port speaks the JAX package's protocol: the same message types over
the same `parallel/wire.py` frames (JSON, with result snapshots as CRC'd
RAW binary segments), the same write-ahead log records, and the same
``DATAFUSION_TPU_CLUSTER*`` settings, so either package's client talks
to either package's service and either recovers a node log the other
wrote.  The service is host-only: nothing here touches a device.

A `ClusterStateService` holds a lease-based KV that three concerns
share:

- ``workers/<addr>``        worker membership.  A worker registers its
  address under a TTL lease and refreshes it from a heartbeat thread
  (`cluster/agent.py`); a lease that lapses drops the key and bumps the
  membership *epoch*.  Coordinators follow it through a `MembershipView`
  (long-poll watches, `cluster/membership.py`).
- ``cache/invalidate/*``    the fleet-wide fragment-cache invalidation.
  Events append to a revision-numbered log that workers read with their
  next lease refresh (one round trip renews the lease and returns the
  pending events).
- ``cache/result/*``        a shared result tier keyed by the plan
  fingerprint (`cache/fingerprint.py`): coordinators get warm hits from
  each other's queries (`cluster/shared_cache.py` plugs it into
  `CacheStore` as a read-through, write-behind tier).

**HA** (`cluster/service.py`): a standby (``--standby-of``) tails the
primary's event log (log shipping, with full-state snapshots to catch
up), promotes itself on primary silence through a lease-based election,
and re-arms every replicated lease with its shipped remaining deadline.
A monotonically increasing **term** fences a deposed primary.  With a
write quorum W > 1 a mutation is acknowledged only once W replicas hold
it.  Clients take a comma-separated endpoint list and fail over
(redirect on ``not_primary``, capped-backoff sweeps).

**Durability** (`utils/wal.py`): with ``DATAFUSION_TPU_WAL_DIR`` set,
every replication event is logged before the quorum ack, with periodic
compacted snapshots; recovery replays snapshot and log (terms,
revisions, KV, grants, and lease deadlines re-armed from their
persisted remaining TTL, never a fresh one).

Deployment shapes: in-process (`ClusterState` / `ClusterNode` and
`LocalClusterClient`) or standalone TCP services
(``python -m datafusion_tpu_torch.cluster --bind host:port
[--standby-of host:port] [--peers h1:p1,h2:p2]``) that workers
(``python -m datafusion_tpu_torch.worker --cluster ...``) and
coordinators (``DistributedContext(cluster=...)``) dial with
`ClusterClient`.

Settings (all off by default: no thread or socket):

    DATAFUSION_TPU_CLUSTER            service address(es), comma-
                                      separated host:port list; set on
                                      coordinators and workers
    DATAFUSION_TPU_CLUSTER_TTL_S      worker lease TTL (default 10)
    DATAFUSION_TPU_CLUSTER_ELECTION_S standby promotes after this much
                                      primary silence (default TTL/2;
                                      rank-staggered in replica sets)
    DATAFUSION_TPU_CLUSTER_QUORUM     write quorum W (default 1 = async
                                      replication; a 3-replica set
                                      wants 2)
    DATAFUSION_TPU_CLUSTER_CACHE_BYTES  shared result tier byte budget
                                      (default 256 MiB)
    DATAFUSION_TPU_SERVER_THREADS     event-loop executor width per
                                      server
    DATAFUSION_TPU_WAL_DIR            durable WAL and snapshot directory
                                      (one per node)
    DATAFUSION_TPU_WAL_SYNC           fsync policy: always (default) |
                                      interval | off
    DATAFUSION_TPU_WAL_SYNC_INTERVAL_S  interval-policy fsync cadence
    DATAFUSION_TPU_WAL_SEGMENT_BYTES  segment rotation size (4 MiB)
    DATAFUSION_TPU_WAL_SNAPSHOT_BYTES log bytes that trigger a
                                      compacting snapshot (8 MiB)
    DATAFUSION_TPU_SERVE_PIN_MANIFEST serving pin-manifest path

Fault sites (`testing/faults.py`): ``cluster.request`` (service
partition), ``cluster.lease.refresh`` (lease expiry), ``cluster.watch``
(stale membership view), ``cluster.replicate`` (log-shipping failure),
``cluster.election`` (promotion abort), ``cluster.snapshot`` (catch-up
snapshot failure), and the log's disk sites (`utils/wal.py`).
"""

from __future__ import annotations

import os
from typing import Optional

from datafusion_tpu_torch.cluster.client import (  # noqa: F401 — subsystem API
    ClusterClient,
    LocalClusterClient,
)
from datafusion_tpu_torch.cluster.service import (  # noqa: F401
    ClusterNode,
    ClusterState,
    ClusterStateService,
    serve,
)

DEFAULT_LEASE_TTL_S = 10.0
DEFAULT_CACHE_BYTES = 256 << 20


def cluster_address() -> Optional[str]:
    """The env-configured service address (possibly a comma-separated
    endpoint list), or None (cluster mode off)."""
    return os.environ.get("DATAFUSION_TPU_CLUSTER") or None


def lease_ttl_s() -> float:
    env = os.environ.get("DATAFUSION_TPU_CLUSTER_TTL_S", "")
    return float(env) if env else DEFAULT_LEASE_TTL_S


def write_quorum() -> int:
    """Replicas (primary included) that must hold a mutation before it
    is acknowledged.  1 (the default) is async replication: acks never
    wait on a replica, and the loss window is
    whatever `cluster.replication_lag_revisions` measures.  W > 1
    closes that window: a SIGKILL'd primary cannot lose a write any
    client saw acknowledged, because W-1 other replicas already held
    it — and the election reaches at least one of them."""
    env = os.environ.get("DATAFUSION_TPU_CLUSTER_QUORUM", "")
    return max(1, int(env)) if env else 1


def election_timeout_s() -> float:
    """How long a standby tolerates primary silence before promoting
    itself.  Defaults to half the lease TTL so a takeover (plus the
    lease re-arm it performs) completes within one TTL of the kill —
    the acceptance bar for 'coordinators never notice'."""
    env = os.environ.get("DATAFUSION_TPU_CLUSTER_ELECTION_S", "")
    if env:
        return float(env)
    return max(0.5, lease_ttl_s() / 2.0)


def connect(target):
    """A client for `target`: a "host:port[,host:port...]" string dials
    the TCP service fleet (failover order = list order), a
    `ClusterState`/`ClusterNode` (or list of them) wraps in-process, an
    existing client passes through — so every cluster-aware constructor
    takes one `cluster=` argument regardless of deployment shape."""
    if isinstance(target, (ClusterClient, LocalClusterClient)):
        return target
    if isinstance(target, (ClusterState, ClusterNode)):
        return LocalClusterClient(target)
    if isinstance(target, (list, tuple)) and target and all(
        isinstance(t, (ClusterState, ClusterNode)) for t in target
    ):
        return LocalClusterClient(list(target))
    if isinstance(target, str):
        return ClusterClient(target)
    raise TypeError(f"cannot connect to cluster target {target!r}")
