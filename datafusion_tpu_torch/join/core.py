"""Host-side equi-join core: build index, CSR probe, partition hash.

The JAX package's `join/core.py`, carried over as it is (it holds no
JAX code).  Everything here is pure numpy over host columns (strings stay
dictionary-coded — Utf8 keys compare through per-dictionary lookup
tables, never by materializing python strings per row).  `HashIndex`
serves the host join path (join/relation.py); the partition hash is the
one the JAX package's shuffle exchange places rows by, kept byte for
byte so a distributed port can agree with it (ROADMAP queue 1,
distributed execution).

SQL NULL semantics throughout: a NULL key matches nothing — not even
another NULL — and a LEFT OUTER probe row whose key is NULL still
emits (with the right side NULL).  Float NaN keys fall out the same
way for free: `np.unique` sorts NaN to the end and `NaN == NaN` is
false, so a NaN probe never resolves to a build code.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np

# -- deterministic partition hash (shuffle exchange) ----------------------
# splitmix64 finalizer: every worker and the coordinator must place a
# given key row in the same partition, across processes and platforms,
# so the mix is fixed-width uint64 arithmetic with hard-coded constants
# (never python hash(), which is salted per process).
_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(33))) * _MIX1
        h = (h ^ (h >> np.uint64(33))) * _MIX2
        return h ^ (h >> np.uint64(33))


def _crc_lut(dictionary) -> np.ndarray:
    """uint64 CRC of every dictionary string — hashing CONTENT, not
    codes, because each worker's append-ordered codes for the same
    string differ."""
    cache = dictionary.cmp_cache
    key = ("join.crc", None)
    hit = cache.get(key)
    if hit is not None and hit[0] == dictionary.version:
        return hit[1]
    lut = np.fromiter(
        (zlib.crc32(v.encode("utf-8")) for v in dictionary.values),
        dtype=np.uint64, count=dictionary.version,
    )
    cache[key] = (dictionary.version, lut)
    return lut


def _hash_image(col: np.ndarray, dictionary=None) -> np.ndarray:
    """uint64 image of a key column under which equal SQL values have
    equal images everywhere: strings by content CRC, floats by bits
    after canonicalizing -0.0/NaN, ints/bools widened to int64."""
    if dictionary is not None:
        lut = _crc_lut(dictionary)
        if len(lut) == 0:
            return np.zeros(len(col), np.uint64)
        return lut[np.clip(col.astype(np.int64), 0, len(lut) - 1)]
    if col.dtype.kind == "f":
        f = col.astype(np.float64, copy=True)
        with np.errstate(invalid="ignore"):
            f[f == 0.0] = 0.0  # -0.0 == 0.0 must hash together
            f[np.isnan(f)] = np.nan  # one canonical NaN payload
        return f.view(np.uint64)
    return col.astype(np.int64).view(np.uint64)


def partition_of(
    key_cols: Sequence[np.ndarray],
    key_valids: Sequence[Optional[np.ndarray]],
    num_parts: int,
    dicts: Optional[Sequence] = None,
) -> np.ndarray:
    """Partition id in [0, num_parts) per row, identical on every node.
    NULL-key rows hash as a fixed sentinel — they land in one
    deterministic partition, where the reduce join gives them SQL
    semantics (match nothing / emit NULL-extended)."""
    n = len(key_cols[0]) if key_cols else 0
    h = np.zeros(n, np.uint64)
    for k, col in enumerate(key_cols):
        img = _hash_image(np.asarray(col), None if dicts is None else dicts[k])
        v = key_valids[k] if key_valids is not None else None
        if v is not None:
            img = np.where(v, img, _GOLDEN)
        with np.errstate(over="ignore"):
            h = _mix64(h ^ (img + _GOLDEN))
    return (h % np.uint64(num_parts)).astype(np.int64)


# -- build index ----------------------------------------------------------


def _codes_of(uniq: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Map values into positions in the sorted unique array `uniq`;
    -1 = absent (never matches)."""
    n = len(vals)
    if len(uniq) == 0:
        return np.full(n, -1, np.int64)
    pos = np.searchsorted(uniq, vals)
    pos = np.minimum(pos, len(uniq) - 1)
    with np.errstate(invalid="ignore"):
        ok = uniq[pos] == vals
    return np.where(ok, pos, -1).astype(np.int64)


def _combine(codes: list[np.ndarray], radices: list[int]) -> np.ndarray:
    """Joint key id from per-column codes (-1 anywhere -> -1).  Mixed
    radix when the product fits int64; otherwise pairwise re-unique
    (unbounded column counts/cardinalities stay correct)."""
    if len(codes) == 1:
        return codes[0]
    total = 1
    for r in radices:
        total *= r + 1
    bad = np.zeros(len(codes[0]), bool)
    if total < (1 << 62):
        joint = np.zeros(len(codes[0]), np.int64)
        for c, r in zip(codes, radices):
            bad |= c < 0
            joint = joint * np.int64(r + 1) + np.maximum(c, 0)
        joint[bad] = -1
        return joint
    joint = np.maximum(codes[0], 0)
    bad |= codes[0] < 0
    for c in codes[1:]:
        bad |= c < 0
        pair = np.stack([joint, np.maximum(c, 0)], axis=1)
        _, inv = np.unique(pair, axis=0, return_inverse=True)
        joint = inv.astype(np.int64)
    joint[bad] = -1
    return joint


class HashIndex:
    """Equi-join index over the build side's key columns.

    Per key column the LIVE (non-NULL) build values sort into a unique
    table; every build row gets a mixed-radix joint code, and the live
    rows sort by that code into a CSR the probe expands with two
    `searchsorted`s per batch.  Utf8 keys store the unique table as
    decoded strings and map each probe dictionary through a cached
    per-version lookup table, so cross-dictionary joins (every
    distributed join) compare content, not codes.
    """

    __slots__ = ("_uniqs", "_dicts", "_ids_sorted", "_rows", "n_rows",
                 "unique_keys", "_luts")

    def __init__(self, key_cols, key_valids, key_dicts=None):
        k = len(key_cols)
        n = len(key_cols[0]) if k else 0
        self.n_rows = n
        self._dicts = list(key_dicts) if key_dicts is not None else [None] * k
        live = np.ones(n, bool)
        for v in key_valids:
            if v is not None:
                live &= v
        self._uniqs = []
        codes = []
        for c, col in enumerate(key_cols):
            col = np.asarray(col)
            d = self._dicts[c]
            if d is not None:
                vals = np.asarray(d.values, dtype=object)
                col = (
                    vals[np.clip(col.astype(np.int64), 0, max(len(vals) - 1, 0))]
                    if len(vals)
                    else np.full(n, "", dtype=object)
                )
            uniq = np.unique(col[live]) if live.any() else col[:0]
            self._uniqs.append(uniq)
            codes.append(_codes_of(uniq, col))
        joint = _combine(codes, [len(u) for u in self._uniqs]) if k else (
            np.full(n, -1, np.int64)
        )
        joint = np.where(live, joint, -1)
        rows = np.nonzero(joint >= 0)[0]
        order = np.argsort(joint[rows], kind="stable")
        self._rows = rows[order].astype(np.int64)
        self._ids_sorted = joint[rows][order]
        self.unique_keys = bool(
            len(self._ids_sorted) < 2
            or (self._ids_sorted[1:] != self._ids_sorted[:-1]).all()
        )
        self._luts: dict = {}

    def _probe_codes(self, c: int, col: np.ndarray, probe_dict) -> np.ndarray:
        uniq = self._uniqs[c]
        if self._dicts[c] is None and probe_dict is None:
            return _codes_of(uniq, np.asarray(col))
        # Utf8 key: map probe codes -> build unique positions through a
        # per-(column, dictionary-version) lookup table
        d = probe_dict
        key = (c, id(d))
        hit = self._luts.get(key)
        if hit is None or hit[0] != d.version:
            vals = np.asarray(d.values, dtype=object)
            lut = _codes_of(uniq, vals) if len(vals) else np.empty(0, np.int64)
            self._luts[key] = hit = (d.version, lut)
        lut = hit[1]
        if len(lut) == 0:
            return np.full(len(col), -1, np.int64)
        return lut[np.clip(np.asarray(col).astype(np.int64), 0, len(lut) - 1)]

    def probe(self, key_cols, key_valids, key_dicts=None,
              join_type: str = "inner"):
        """(lidx, ridx) row-pair indices joining probe rows against the
        build rows; LEFT OUTER emits unmatched probe rows with
        ridx == -1.  Output is sorted by (lidx, ridx) — deterministic
        regardless of batch internals."""
        k = len(key_cols)
        n = len(key_cols[0]) if k else 0
        codes = []
        for c in range(k):
            cc = self._probe_codes(
                c, key_cols[c], None if key_dicts is None else key_dicts[c]
            )
            v = key_valids[c] if key_valids is not None else None
            if v is not None:
                cc = np.where(v, cc, -1)
            codes.append(cc)
        ids = _combine(codes, [len(u) for u in self._uniqs]) if k else (
            np.full(n, -1, np.int64)
        )
        start = np.searchsorted(self._ids_sorted, ids, "left")
        end = np.searchsorted(self._ids_sorted, ids, "right")
        # ids == -1 never matches: the sorted build ids are all >= 0
        start = np.where(ids < 0, 0, start)
        end = np.where(ids < 0, 0, end)
        counts = end - start
        tot = int(counts.sum())
        lidx = np.repeat(np.arange(n, dtype=np.int64), counts)
        if tot:
            cum = np.cumsum(counts)
            offs = np.arange(tot, dtype=np.int64) - np.repeat(cum - counts, counts)
            ridx = self._rows[np.repeat(start, counts) + offs]
        else:
            ridx = np.empty(0, np.int64)
        if join_type == "left":
            miss = np.nonzero(counts == 0)[0].astype(np.int64)
            if len(miss):
                lidx = np.concatenate([lidx, miss])
                ridx = np.concatenate([ridx, np.full(len(miss), -1, np.int64)])
                perm = np.lexsort((ridx, lidx))
                lidx, ridx = lidx[perm], ridx[perm]
        return lidx, ridx


def gather_joined(
    probe_cols, probe_valids, build_cols, build_valids, lidx, ridx,
    join_type: str = "inner",
):
    """Assemble output columns from a (lidx, ridx) pairing: probe
    columns gather by lidx; build columns gather by ridx with validity
    cleared where ridx == -1 (LEFT OUTER misses)."""
    out_cols = [np.asarray(c)[lidx] for c in probe_cols]
    out_valids = [None if v is None else v[lidx] for v in probe_valids]
    matched = ridx >= 0
    safe = np.maximum(ridx, 0)
    for c, v in zip(build_cols, build_valids):
        c = np.asarray(c)
        if len(c) == 0:
            # zero-row build (LEFT OUTER over an empty table): nothing
            # to gather; emit typed zeros, validity clears them to NULL
            c = np.zeros(1, c.dtype)
        out_cols.append(c[safe])
        if join_type == "inner" and v is None:
            out_valids.append(None)
        elif v is None:
            out_valids.append(matched.copy())
        else:
            out_valids.append(matched & v[safe])
    return out_cols, out_valids
