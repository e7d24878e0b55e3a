"""Error types for the PyTorch/CUDA port of datafusion-tpu.

Mirrors the reference's error taxonomy (`src/execution/error.rs:26-35`:
IoError / ParserError / General / InvalidColumn / NotImplemented /
ExecutionError) as a Python exception hierarchy.
"""

from __future__ import annotations


class DataFusionError(Exception):
    """Base class for all engine errors (reference `error.rs:26`)."""


class IoError(DataFusionError):
    """I/O failure reading a data source."""


class ParserError(DataFusionError):
    """SQL tokenizer/parser failure (reference `error.rs:28`)."""


class PlanError(DataFusionError):
    """Query-planning failure (the reference folds these into General)."""


class InvalidColumnError(DataFusionError):
    """Reference to a column that does not exist (reference `error.rs:31`)."""


class NotSupportedError(DataFusionError):
    """Feature recognized but not supported (reference `error.rs:32`)."""


class ExecutionError(DataFusionError):
    """Runtime failure while executing a plan (reference `error.rs:34`)."""


class PlanVerificationError(NotSupportedError, PlanError):
    """The static plan verifier (analysis/verify.py) rejected a plan
    before execution.  Deliberately NOT transient: replaying an invalid
    plan cannot make it type-check, so retry/failover layers must fail
    fast instead of burning their budget.  Subclasses BOTH PlanError
    (most rejections are genuine plan bugs — unknown columns, dtype
    mismatches) and NotSupportedError (the rest are shapes the engine
    deliberately refuses — Utf8 casts, computed GROUP BY keys) so
    pre-existing handlers for either taxonomy keep working.
    `diagnostics` carries the source-anchored findings."""

    def __init__(self, message: str, diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


class TransientError(DataFusionError):
    """A failure that is expected to succeed on replay (retry taxonomy
    root).  Recovery layers decide *by type*: anything under this class
    is retryable, everything else re-raises immediately — no substring
    matching in the retry hot path."""


class DeviceTransientError(TransientError):
    """A device dispatch failed for transport/session reasons (dropped
    tunnel request, remote compile service hiccup).  Dispatches are
    functionally pure, so the call simply replays."""


class WorkerUnavailableError(TransientError):
    """A worker endpoint is (currently) unreachable; its fragment can
    be reassigned or retried after re-admission."""


class QueryDeadlineError(ExecutionError):
    """The caller's per-query time budget is exhausted.  Deliberately
    NOT transient: retrying cannot create time."""


class QueryShedError(ExecutionError):
    """The serving front door (datafusion_tpu/serve.py) refused to
    admit a query — queue at depth, deadline infeasible, or no HBM
    headroom even after eviction.  Deliberately NOT transient at this
    layer: shedding IS the backpressure signal, and an in-process
    retry loop would defeat it.  `reason` is one of "queue",
    "deadline", "hbm", "shutdown"."""

    def __init__(self, message: str, reason: str = "queue"):
        super().__init__(message)
        self.reason = reason


class ClusterNotPrimaryError(TransientError, ExecutionError):
    """A cluster-service replica refused the request because it is not
    the primary.  Transient by construction — retrying against another
    endpoint (or the same one after an election) is expected to
    succeed, and the multi-endpoint `ClusterClient` does exactly that.
    Also an `ExecutionError` so the existing swallow-and-degrade
    handlers around cluster calls (membership polls, shared-tier loads,
    heartbeat refreshes) keep catching it when failover is exhausted.
    `primary` carries the rejecting replica's best hint for who IS
    primary (an address string, or None)."""

    def __init__(self, message: str, primary=None):
        super().__init__(message)
        self.primary = primary


class ClusterQuorumError(TransientError, ExecutionError):
    """The primary applied a mutation but could not collect the
    configured write-quorum of replica acknowledgements, so the write
    is NOT acknowledged durable.  Transient by construction: replicas
    rejoin (or an election resolves), and the client's failover sweep
    retries — the mutation is idempotent against the log (replays land
    on the already-applied revision).  `acks` / `quorum` carry the
    observed count and the bar it missed."""

    def __init__(self, message: str, acks: int = 0, quorum: int = 0):
        super().__init__(message)
        self.acks = int(acks)
        self.quorum = int(quorum)


class IngestError(ExecutionError):
    """A streaming append or materialized-view operation failed
    permanently (schema mismatch, unknown table/view, ineligible
    shape).  Deliberately NOT transient: replaying a malformed append
    cannot make it well-formed."""


class IngestUnavailableError(TransientError, IngestError):
    """The ingest log could not durably record an append — the write
    was NOT acknowledged and nothing was applied (the ingest twin of
    the cluster's `wal_unavailable` refusal).  Transient by
    construction: the caller retries when the log recovers, and the
    WAL's revision dedup makes replays idempotent."""


class StaleTermError(ExecutionError):
    """A write carried a leadership term older than the service's
    current term — the writer is a deposed primary and must not mutate
    the KV (the split-brain fence).  Deliberately NOT transient:
    replaying the same stale write cannot make its term current; the
    writer has to step down and resync first."""


def classify_transient(err: BaseException) -> "TransientError | None":
    """Wrap a raw exception into the typed transient taxonomy, or return
    None for a permanent failure.  Called once at the dispatch boundary
    where an error first surfaces (utils/retry.device_call); retry loops
    downstream test `isinstance(e, TransientError)` only.

    A `TransientError` is returned as it is, and a `ConnectionError`
    (`BrokenPipeError` included) maps to `WorkerUnavailableError`.
    Nothing else is transient on CUDA: a torch or CUDA `RuntimeError`
    (most CUDA errors are sticky, the context is unusable after them),
    `torch.cuda.OutOfMemoryError`, a failed nvcc build or kernel launch
    (`ExecutionError`) raise on their first attempt.  The JAX package's
    status-token scan of XLA runtime errors has no counterpart here."""
    if isinstance(err, TransientError):
        return err
    if isinstance(err, (ConnectionError, BrokenPipeError)):
        return WorkerUnavailableError(str(err))
    return None
