"""Canonical, cross-process plan fingerprints (the JAX package's
`cache/fingerprint.py`, its plan half: the fragment fingerprints wait
for the worker fragment cache, ROADMAP queue 1 item 12).

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
