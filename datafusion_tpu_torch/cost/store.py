"""CostStore: the engine's accumulated cost observations (the JAX
package's `cost/store.py`, whole, and its file format).

One flat table of records keyed by ``(table key, operator shape)``.
The table key embeds the backing source's identity (a file's path,
modification time and size; an appendable table's append serial; an
in-memory table's data identity, see `cost.table_key`), so a
rewritten file or an append retires stale entries by reading and
writing a different key.  The shape is a short string like ``"scan"``,
``"agg:g=l_linestatus,l_returnflag"`` or ``"join-build"``.

The observe path takes no lock: observations arrive from scan
generators, aggregate finalizers, the join build and the serving loop,
some inside other subsystems' critical sections.  Every record is
published as a fresh dict assigned into the store's dict (atomic under
the interpreter lock); two threads observing one key at once may lose a
sample, which EWMA statistics tolerate.

Persistence is one atomic JSON file (`utils/wal.atomic_write_json`:
tmp, fsync, rename), written from cold seams (query completion, a
server's stop) and throttled to one write per `save_interval_s`,
pruned to the newest-touched `_MAX_ENTRIES`.  The format is the JAX
package's (``{"version": 1, "saved": ..., "entries": {...}}``), so
either package loads the other's ``cost_store.json``.  Loading is
crash-only: a missing, torn or foreign file degrades to an empty store.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

from datafusion_tpu_torch.utils.metrics import METRICS

# EWMA weight for a new sample: heavy enough that a table whose
# cardinality shifted converges within a few queries, light enough
# that one anomalous partial scan doesn't whipsaw the planner
_ALPHA = 0.4

# store format serial: a loader seeing a different value drops the
# file (observations are advisory — re-learning beats mis-reading)
SCHEMA_VERSION = 1

# persisted entry budget: newest-touched entries win (a long-lived
# server seeing parameterized workloads mints bounded state)
_MAX_ENTRIES = 4096


def _key(table_key: str, shape: str) -> str:
    return f"{table_key}\t{shape}"


class CostStore:
    """Accumulated per-(table, operator-shape) cost observations."""

    def __init__(self, path: Optional[str] = None):
        # key -> record dict; records are REPLACED, never mutated in
        # place (lock-free publish: readers always see a full record)
        self._obs: dict[str, dict] = {}
        self._path = path
        self._dirty = False
        self._last_save = 0.0
        self.save_interval_s = 2.0
        # recent planner decisions / replans for the debug surfaces
        # (deque appends are GIL-atomic — no lock on the record path)
        self.decisions: deque = deque(maxlen=128)
        self.replans: deque = deque(maxlen=64)
        # monotone serial stamped into decision records: lets EXPLAIN
        # ANALYZE slice out the decisions made during ITS planning
        # window (read serial, plan, collect records with seq > mark)
        self.decision_serial = 0
        if path:
            self._load(path)

    # -- observe / lookup (hot path, lock-free) ------------------------
    def observe(self, table_key: str, shape: str, **fields) -> None:
        """Fold one observation into the record for (table, shape).

        Every numeric field keeps three views: an EWMA (the planner's
        estimate), the last sample (freshest truth, e.g. serving row
        weights) and the max (monotone bound — a LIMIT-abandoned scan
        must not shrink a table's learned row count)."""
        k = _key(table_key, shape)
        prev = self._obs.get(k)
        rec = {} if prev is None else dict(prev)
        rec["n"] = rec.get("n", 0) + 1
        rec["ts"] = time.time()
        for name, v in fields.items():
            v = float(v)
            old = rec.get(name)
            rec[name] = v if old is None else old + _ALPHA * (v - old)
            rec[name + "_last"] = v
            m = rec.get(name + "_max")
            rec[name + "_max"] = v if m is None else max(m, v)
        self._obs[k] = rec
        self._dirty = True

    def lookup(self, table_key: str, shape: str) -> Optional[dict]:
        return self._obs.get(_key(table_key, shape))

    def value(self, table_key: str, shape: str, field: str,
              default=None):
        rec = self._obs.get(_key(table_key, shape))
        if rec is None:
            return default
        v = rec.get(field)
        return default if v is None else v

    def note_decision(self, decision: str, chosen, default, reason: str,
                      table: Optional[str] = None) -> dict:
        """Record a planner decision (for EXPLAIN ANALYZE / \\cost /
        /debug/cost).  Returns the record so callers can also attach
        it to the relation they decided about."""
        self.decision_serial += 1
        rec = {
            "seq": self.decision_serial,
            "decision": decision,
            "chosen": chosen,
            "default": default,
            "reason": reason,
            "ts": time.time(),
        }
        if table is not None:
            rec["table"] = table
        self.decisions.append(rec)
        METRICS.add("cost.decisions")
        return rec

    def note_replan(self, what: str, estimate, actual, action: str) -> dict:
        rec = {
            "what": what,
            "estimate": estimate,
            "actual": actual,
            "action": action,
            "ts": time.time(),
        }
        self.replans.append(rec)
        return rec

    # -- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        """Debug view: entries grouped per table, plus the recent
        decision / replan logs."""
        tables: dict[str, dict] = {}
        for k, rec in list(self._obs.items()):
            tkey, _, shape = k.partition("\t")
            tables.setdefault(tkey, {})[shape] = dict(rec)
        return {
            "path": self._path,
            "entries": len(self._obs),
            "tables": tables,
            "decisions": list(self.decisions),
            "replans": list(self.replans),
        }

    def __len__(self) -> int:
        return len(self._obs)

    # -- persistence (cold path only) -----------------------------------
    def flush(self, force: bool = False) -> bool:
        """Persist if dirty (throttled; `force` bypasses the throttle).
        Called from query-completion and shutdown seams — never from
        the observe path."""
        if self._path is None or not self._dirty:
            return False
        now = time.monotonic()
        if not force and now - self._last_save < self.save_interval_s:
            return False
        self._last_save = now
        self._dirty = False
        entries = self._obs
        if len(entries) > _MAX_ENTRIES:
            keep = sorted(
                entries.items(), key=lambda kv: kv[1].get("ts", 0.0)
            )[-_MAX_ENTRIES:]
            entries = dict(keep)
        payload = {
            "version": SCHEMA_VERSION,
            "saved": time.time(),
            "entries": entries,
        }
        try:
            from datafusion_tpu_torch.utils.wal import atomic_write_json

            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            atomic_write_json(self._path, payload)
            METRICS.add("cost.store.saves")
            return True
        except OSError:
            # persistence is advisory: a full/readonly disk must not
            # fail the query that happened to trigger the flush
            METRICS.add("cost.store.save_errors")
            return False

    def _load(self, path: str) -> None:
        """Crash-only load: anything unreadable — missing file, torn
        write, wrong version, not-a-dict — degrades to empty."""
        import json

        try:
            with open(path, "r", encoding="utf-8") as f:
                payload = json.load(f)
            if (
                not isinstance(payload, dict)
                or payload.get("version") != SCHEMA_VERSION
                or not isinstance(payload.get("entries"), dict)
            ):
                raise ValueError("malformed cost store")
            entries = {}
            for k, rec in payload["entries"].items():
                if isinstance(k, str) and isinstance(rec, dict):
                    entries[k] = rec
            self._obs = entries
            METRICS.add("cost.store.loads")
        except FileNotFoundError:
            pass
        except (OSError, ValueError):
            METRICS.add("cost.store.corrupt")
            self._obs = {}
