"""Hash-partitioned shuffle exchange for distributed joins (the JAX
package's `parallel/shuffle.py`: numpy on the host in both packages, so
a block either package's worker writes joins in the other's reduce).

A distributed equi-join cannot run where the data sits: matching rows
of the two inputs live on different workers.  The exchange re-keys
both sides — every map task (one side, one partition fragment) splits
its output rows into `num_parts` **shuffle blocks** by the
deterministic key hash `join.core.partition_of`, so rows with equal
join keys land in the same partition no matter which worker produced
them.  The reduce task for partition `p` then merges every block
tagged `p` from both sides and runs the ordinary host join
(`join.core.HashIndex`) over co-located rows.

Blocks ride the engine's existing CRC'd RAW wire segments
(`wire.enc_array` binary frames) and carry a **fingerprint** —
`digest(map-task identity, side, partitioning, partition)` — that
makes the exchange idempotent: a replayed or hedged map task after a
worker failover re-produces byte-equal blocks under the same
fingerprints, and `merge_side` drops duplicates before any row is
joined twice (`shuffle.dedup_drops`).  Utf8 columns ship as compact
``{"codes", "values"}`` pairs (same contract as the row-returning
fragment path) and are hashed by string *content*, so worker-local
dictionary codes never cross a process boundary.

Empty blocks are still real blocks: they carry the column dtypes, so a
reduce task can always infer its input layout even when a partition
received no rows from one side.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from datafusion_tpu_torch.cache.fingerprint import digest
from datafusion_tpu_torch.exec.batch import StringDictionary
from datafusion_tpu_torch.join.core import HashIndex, gather_joined, partition_of
from datafusion_tpu_torch.parallel.wire import BinWriter, dec_array, enc_array
from datafusion_tpu_torch.utils.metrics import METRICS

_DEFAULT_FACTOR = 2  # partitions per worker: >1 so failover rebalances


def shuffle_parts(num_workers: int) -> int:
    """Partition count for the exchange: 2x the worker count (multiple
    partitions per worker keep the reduce work spreadable when a worker
    dies mid-shuffle)."""
    return max(2, _DEFAULT_FACTOR * max(1, num_workers))


def compact_utf8(codes: np.ndarray, values: Sequence[str]) -> dict:
    """Codes + the value table trimmed to only the referenced strings
    (the row-fragment shipping idiom): a block holding 50 rows of a
    high-cardinality column must not drag the global dictionary."""
    codes = np.asarray(codes, dtype=np.int32)
    if len(values) == 0 or len(codes) == 0:
        return {"codes": codes, "values": []}
    uniq, inv = np.unique(codes, return_inverse=True)
    return {
        "codes": inv.astype(np.int32),
        "values": [values[u] for u in uniq],
    }


def _is_utf8(col) -> bool:
    return isinstance(col, dict)


def partition_ids(
    columns: Sequence,
    validity: Sequence[Optional[np.ndarray]],
    key_idx: Sequence[int],
    num_parts: int,
) -> np.ndarray:
    """Partition id per row from the key columns.  Utf8 keys (compact
    ``{"codes","values"}`` form) hash by content through a
    `StringDictionary` so every worker agrees on the placement of a
    given string."""
    key_cols, key_valids, key_dicts = [], [], []
    for k in key_idx:
        c = columns[k]
        if _is_utf8(c):
            d = StringDictionary()
            key_cols.append(
                d.merge_codes(np.asarray(c["codes"], np.int32), c["values"])
            )
            key_dicts.append(d)
        else:
            key_cols.append(np.asarray(c))
            key_dicts.append(None)
        key_valids.append(
            None if validity[k] is None else np.asarray(validity[k])
        )
    return partition_of(key_cols, key_valids, num_parts, dicts=key_dicts)


def split_blocks(
    raw: dict,
    key_idx: Sequence[int],
    num_parts: int,
    fingerprint_parts: Sequence,
) -> list[dict]:
    """One map task: a rows payload (``{"num_rows", "columns",
    "validity"}``, columns host numpy or compact Utf8) -> exactly
    `num_parts` blocks.  `fingerprint_parts` identifies the map task
    (fragment fingerprint, side, partitioning); each block's
    fingerprint extends it with the partition id, so a replay of this
    task mints identical fingerprints."""
    n = int(raw["num_rows"])
    columns, validity = raw["columns"], raw["validity"]
    if n:
        pids = partition_ids(columns, validity, key_idx, num_parts)
        order = np.argsort(pids, kind="stable")
        bounds = np.searchsorted(
            pids[order], np.arange(num_parts + 1, dtype=np.int64)
        )
    else:
        order = np.empty(0, np.int64)
        bounds = np.zeros(num_parts + 1, np.int64)
    blocks = []
    for p in range(num_parts):
        rows = order[bounds[p]:bounds[p + 1]]
        cols = []
        for c in columns:
            if _is_utf8(c):
                cols.append(
                    compact_utf8(np.asarray(c["codes"], np.int32)[rows],
                                 c["values"])
                )
            else:
                cols.append(np.ascontiguousarray(np.asarray(c)[rows]))
        blocks.append({
            "partition": p,
            "num_rows": int(len(rows)),
            "fingerprint": digest(list(fingerprint_parts), p),
            "columns": cols,
            "validity": [
                None if v is None else np.asarray(v)[rows] for v in validity
            ],
        })
    METRICS.add("shuffle.map_blocks", num_parts)
    METRICS.add("shuffle.map_rows", n)
    return blocks


# -- wire form ------------------------------------------------------------


def encode_block(block: dict, bw: Optional[BinWriter]) -> dict:
    """Host block -> wire dict; bulk arrays ride the frame's CRC'd
    binary segments via `bw` (inline base64 when bw is None — the
    coordinator-local degraded path)."""
    return {
        "partition": block["partition"],
        "num_rows": block["num_rows"],
        "fingerprint": block["fingerprint"],
        "columns": [
            {"codes": enc_array(c["codes"], bw), "values": c["values"]}
            if _is_utf8(c)
            else enc_array(c, bw)
            for c in block["columns"]
        ],
        "validity": [
            None if v is None else enc_array(v, bw)
            for v in block["validity"]
        ],
    }


def decode_block(obj: dict) -> dict:
    """Wire dict -> host block (zero-copy views into the received
    frame where the arrays rode binary segments)."""
    return {
        "partition": int(obj["partition"]),
        "num_rows": int(obj["num_rows"]),
        "fingerprint": obj.get("fingerprint"),
        "columns": [
            {"codes": dec_array(c["codes"]), "values": c["values"]}
            if "values" in c
            else dec_array(c)
            for c in obj["columns"]
        ],
        "validity": [
            None if v is None else dec_array(v) for v in obj["validity"]
        ],
    }


# -- reduce side ----------------------------------------------------------


def merge_side(blocks: Sequence[dict]):
    """Merge one side's blocks for one partition into host columns:
    (columns, validity, dicts, total_rows).  Duplicate fingerprints
    (failover replays, hedge losers, re-delivered responses) drop
    idempotently BEFORE any row is counted.  Utf8 columns re-encode
    into one fresh merged `StringDictionary` per column."""
    seen: set = set()
    keep = []
    for b in blocks:
        fp = b.get("fingerprint")
        if fp is not None and fp in seen:
            METRICS.add("shuffle.dedup_drops")
            continue
        if fp is not None:
            seen.add(fp)
        keep.append(b)
    if not keep:
        raise ValueError("shuffle partition received no blocks for a side")
    ncols = len(keep[0]["columns"])
    dicts = [
        StringDictionary() if _is_utf8(keep[0]["columns"][i]) else None
        for i in range(ncols)
    ]
    col_parts: list[list] = [[] for _ in range(ncols)]
    val_parts: list[list] = [[] for _ in range(ncols)]
    any_valid = [False] * ncols
    for b in keep:
        for i in range(ncols):
            c = b["columns"][i]
            if dicts[i] is not None:
                col_parts[i].append(
                    dicts[i].merge_codes(np.asarray(c["codes"], np.int32),
                                         c["values"])
                )
            else:
                col_parts[i].append(np.asarray(c))
            v = b["validity"][i]
            val_parts[i].append(v)
            if v is not None:
                any_valid[i] = True
    total = sum(int(b["num_rows"]) for b in keep)
    columns = [np.concatenate(parts) for parts in col_parts]
    validity = []
    for i in range(ncols):
        if not any_valid[i]:
            validity.append(None)
            continue
        validity.append(np.concatenate([
            np.ones(int(b["num_rows"]), bool) if v is None else np.asarray(v)
            for b, v in zip(keep, val_parts[i])
        ]))
    return columns, validity, dicts, total


def reduce_join(left_blocks, right_blocks, on, join_type: str) -> dict:
    """The partition-local join a reduce worker runs over merged
    blocks: `HashIndex` over the right (build) side's keys, CSR probe
    with the left side — the exact core the single-host fallback join
    uses, so distributed and local results cannot drift.  Returns a
    rows payload (Utf8 compact-coded) ready for `_encode_response`-
    style shipping."""
    with METRICS.timer("shuffle.reduce"):
        lcols, lvalids, ldicts, _ln = merge_side(left_blocks)
        rcols, rvalids, rdicts, _rn = merge_side(right_blocks)
        index = HashIndex(
            [rcols[r] for _, r in on],
            [rvalids[r] for _, r in on],
            [rdicts[r] for _, r in on],
        )
        lidx, ridx = index.probe(
            [lcols[l] for l, _ in on],
            [lvalids[l] for l, _ in on],
            [ldicts[l] for l, _ in on],
            join_type,
        )
        out_cols, out_valids = gather_joined(
            lcols, lvalids, rcols, rvalids, lidx, ridx, join_type
        )
    out_dicts = ldicts + rdicts
    wire_cols = []
    for c, d in zip(out_cols, out_dicts):
        if d is not None:
            wire_cols.append(compact_utf8(c, d.values))
        else:
            wire_cols.append(c)
    METRICS.add("shuffle.reduce_rows", int(len(lidx)))
    return {
        "type": "rows",
        "num_rows": int(len(lidx)),
        "columns": wire_cols,
        "validity": out_valids,
    }
