"""Feedback-driven planning: cost statistics and adaptive decisions
(the JAX package's `cost/`).

The engine's measurement seams feed one process-wide `CostStore`, and
the planner reads it back at the next lowering:

=====================  ==============================================
decision               driven by
=====================  ==============================================
aggregate capacity     the group count observed per (table, GROUP BY
(``agg.capacity``)     columns): the accumulator presizes to it, and
                       a chunk whose encoded groups miss the estimate
                       by `replan_ratio()` aborts the presize before
                       any launch (``plan.replans``)
join build side        learned table row counts: an inner join whose
(``join.build_side``)  left input is under half its right swaps, so the
/ order                smaller side builds; a star's dimension joins
(``join.order``)       reorder smallest build first (cost/optimizer.py)
grouped-reduce window  route history: the largest capacity sent to the
(``agg.window``)       grouped-reduce kernel rather than sort-merge,
                       within [0, 2 x agg_max_groups()]
                       (cost/advisor.py)
megabatch window       observed arrival spacing against a server's
(``serve.window_ms``)  default batching window
=====================  ==============================================

Every decision is recorded chosen-vs-default with the observation that
drove it (`CostStore.note_decision`), rendered by EXPLAIN ANALYZE
("Cost decisions") and the console's ``\\cost``.

``DATAFUSION_TPU_COST=0`` turns every decision off: lowering is the
static engine's.  Observation still flows.  ``DATAFUSION_TPU_COST_DIR``
names a directory to persist the store in (``cost_store.json``, the JAX
package's format); unset, it lives in memory.

Route history lives under the port's own engine key, `CUDA_KEY`, with
the port's route names (``agg:grouped_reduce``, ``agg:sortmerge``,
``sort:radix``).  The JAX package's records under `PALLAS_KEY` load and
persist with the rest, and no port decision reads them: Pallas timings
from a TPU never steer a Hopper route.  The JAX package's
``scan.chunk`` sizing and the aggregate's host-split placement are not
ported: the port probes the link (`exec/batch.link_rate_mbps`), and on
the H100's link neither route pays (ROADMAP item 6).  The sort has one
route at every size (the radix kernel), so there is no sort window.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from datafusion_tpu_torch.cost.store import CostStore

# engine-global (not per-table) record keys: the JAX package's Pallas
# route history, the port's kernel route history, the serving loop
PALLAS_KEY = "__pallas__"
CUDA_KEY = "__cuda__"
SERVE_KEY = "__serve__"

# folded into an in-memory table's key: `DataSource.data_identity` is a
# per-process counter, so without it a later process that registers
# other data under the same name in the same order would read this
# process's persisted statistics
_PROCESS_NONCE = os.urandom(8).hex()

_STORE: Optional[CostStore] = None
_STORE_LOCK = threading.Lock()  # creation only, never on observe


def enabled() -> bool:
    """Are cost-driven planner decisions on?  (Default yes;
    ``DATAFUSION_TPU_COST=0`` restores static planning.)"""
    return os.environ.get("DATAFUSION_TPU_COST", "1") != "0"


def store_path() -> Optional[str]:
    d = os.environ.get("DATAFUSION_TPU_COST_DIR")
    return os.path.join(d, "cost_store.json") if d else None


def store() -> CostStore:
    """The process-wide cost store (created on first use; loads the
    persisted file when ``DATAFUSION_TPU_COST_DIR`` is set)."""
    global _STORE
    s = _STORE
    if s is None:
        with _STORE_LOCK:
            s = _STORE
            if s is None:
                s = _STORE = CostStore(store_path())
    return s


def reset_store() -> None:
    """Drop the process store (tests, a restart); the next `store()`
    reads the persisted file again."""
    global _STORE
    with _STORE_LOCK:
        _STORE = None


def replan_ratio() -> float:
    """Estimate-vs-actual cardinality ratio beyond which a presized
    aggregate aborts and re-derives its capacity from actuals."""
    return 8.0


def _registered_source(ds):
    """The source a serving pin wraps (serve.PinnedSource and its
    projections delegate to the registered source)."""
    from datafusion_tpu_torch.serve import PinnedSource, _PinnedProjection

    if isinstance(ds, _PinnedProjection):
        ds = ds.parent
    if isinstance(ds, PinnedSource):
        ds = ds.inner
    return ds


def table_key(ctx, name: str) -> str:
    """Identity of table `name`'s current data:

    - an appendable table folds its append serial in (``@d<n>``), so
      every delta retires the old cardinality;
    - a file-backed table keys by the file's (path, mtime, size) digest
      (``@s<12 hex>``), the JAX package's key for the same file: a
      rewritten file reads fresh entries, the same file after a restart
      keeps its statistics, and either package reads the other's;
    - an in-memory table keys by its source's data identity and a
      per-process nonce (``@m<12 hex>``, `DataSource.data_identity`):
      the entries persist with the rest, a `reset_store()` in the same
      process reads them back, and no later process ever matches them
      (its data is gone with the process).  The JAX package keys it
      by the context's catalog version instead (``@c<n>``), which two
      contexts of one process that register different data under one
      name share; the port does not inherit that, as its join build
      pins do not (join/relation.py)."""
    from datafusion_tpu_torch.cache import canonical_json, digest
    from datafusion_tpu_torch.ingest import AppendableSource

    ds = ctx.datasources.get(name)
    parts = [name]
    if ds is not None:
        src = _registered_source(ds)
        if isinstance(src, AppendableSource):
            parts.append(f"d{int(src.data_version)}")
        path = getattr(src, "path", None)
        if path is not None:
            try:
                st = os.stat(path)
                sv = [[path, st.st_mtime_ns, st.st_size]]
            except OSError:
                sv = [[path, "missing", 0]]
            parts.append("s" + digest(canonical_json(sv))[:12])
        else:
            parts.append("m" + digest(repr((_PROCESS_NONCE,
                                            src.data_identity)))[:12])
    return "@".join(parts)


def flush(force: bool = False) -> None:
    """Persist the process store if one exists and is dirty (the query
    completion and shutdown seam; a cheap no-op otherwise)."""
    s = _STORE
    if s is not None:
        s.flush(force=force)
