"""Canonical, cross-process plan and fragment fingerprints (the JAX
package's `cache/fingerprint.py`).

A fingerprint identifies "the same work": the logical plan in its JSON
wire form (`plan/logical.py`), canonicalized with sorted keys so dict
construction order never leaks into the digest, plus everything that
changes the *answer* without changing the plan text: the catalog
version of every table the plan scans, its source's data version and
data identity (exec/datasource.py: a file's path, size and
modification time; an in-memory source's identity), the device, the
batch size and the functions version (`ExecutionContext.
query_fingerprint`).  The same plan and versions digest to the same
value in both packages.

The digest is sha256 (stable across processes and platforms, unlike
`hash()`), truncated to 32 hex chars — long enough that collisions are
a non-concern at cache scale, short enough to read in logs and spans.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

_SEP = b"\x1f"  # unit separator between digest parts


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace, unicode kept."""
    return json.dumps(
        obj, sort_keys=True, separators=(",", ":"), ensure_ascii=False,
        default=str,
    )


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else canonical_json(p).encode("utf-8"))
        h.update(_SEP)
    return h.hexdigest()[:32]


def plan_fingerprint(plan, catalog_versions: Optional[dict] = None,
                     extra: Optional[dict] = None) -> str:
    """Fingerprint of a logical plan under a catalog state.

    `catalog_versions` maps table name -> version for the tables the
    plan reads; `extra` carries execution-environment facts that change
    results or their representation (device, batch size, UDF registry
    version).
    """
    return digest({
        "plan": plan.to_json(),
        "catalog": catalog_versions or {},
        "extra": extra or {},
    })


def source_version(meta) -> list:
    """Best-effort version of a datasource meta's backing files:
    (path, mtime_ns, size) triples, recursively for partitioned metas.
    An unstattable path records as missing: the fingerprint still
    forms, and stops matching once the file appears."""
    out: list = []

    def walk(m):
        if not isinstance(m, dict):
            return
        for body in m.values():
            if isinstance(body, list):  # {"Partitioned": [child metas]}
                for child in body:
                    walk(child)
                continue
            if not isinstance(body, dict):
                continue
            path = body.get("filename")
            if path is None:
                # an in-memory growing source versions by append count
                dv = body.get("data_version")
                if dv is not None:
                    out.append(["mem:" + str(body.get("name") or ""),
                                int(dv), int(body.get("rows") or 0)])
                continue
            try:
                st = os.stat(path)
                out.append([path, st.st_mtime_ns, st.st_size])
            except OSError:
                out.append([path, "missing", 0])

    walk(meta)
    return out


def fragment_fingerprint(frag, with_source_version: bool = True) -> str:
    """Fingerprint of one fragment's work (the worker fragment cache's
    key, parallel/worker.py): its plan wire JSON, datasource meta and
    shard/num_shards, and NOT its `query_id`, so a replayed dispatch
    after a failover and a repeat of the same query both land on one
    entry.  `with_source_version` folds the backing files' (mtime,
    size) in, so a rewritten partition misses."""
    return digest({
        "plan": frag.plan,
        "datasource": frag.datasource_meta,
        "shard": frag.shard,
        "num_shards": frag.num_shards,
        "src": source_version(frag.datasource_meta) if with_source_version else None,
    })
