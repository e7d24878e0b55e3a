"""ORDER BY / LIMIT operators.

The counterpart of the JAX package's `exec/sort.py`, on its full-sort
path (run sort + host merge):

- **Run sort**: the child's live rows collect on the host into runs of
  up to `DATAFUSION_TPU_SORT_RUN_ROWS` rows (2^24 by default, so one
  run in practice); each run's transformed keys cross to the device as
  int64 operands and the hand-written radix-sort kernel
  (`exec/cuda/sort_kernel.py`) returns the stable permutation, which
  comes back to the host.  There is no run-size window: the JAX
  package's 2^18-row bitonic window was the TPU's VMEM.
- **Host merge**: runs merge on the host with a vectorized
  structured-array `searchsorted` merge, re-ranking strings under the
  final dictionaries.

Key transforms:
- Every ORDER BY key lowers to a (dead, value) operand pair: `dead` is
  1 for NULL keys (nulls sort last, as a *separate* leading key — a
  value sentinel would collide with real extremes), and dead rows'
  values are zeroed so they compare equal among themselves.  An
  all-live run drops the dead operand (a constant key reorders
  nothing).
- DESC integer keys sort by their bitwise complement (-int64.min
  overflows); DESC floats by their negation.
- Float keys sort by an int64 image that orders as the JAX package's
  `lax.sort` does on the CPU: -0.0, +0.0 and every subnormal tie, and
  every NaN, of either sign, sorts after +inf (lax.sort canonicalizes
  zeros and NaNs before its total-order compare, and XLA's CPU compare
  reads subnormals as zero).  So every operand is int64 and every run
  goes through the kernel.
- Utf8 keys sort by host-computed rank tables
  (`StringDictionary.sort_ranks`).

`LimitRelation` over anything but a Sort stops pulling batches once it
has its rows.  Not ported (ROADMAP queue 1): the streaming TopK, which
`ORDER BY ... LIMIT k` with 0 < k <= TOPK_MAX takes in the JAX package
(raises NotSupportedError here), and the host-routed run sort and the
permutation cache, which exist there for the TPU's slow link and the
wire codec.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    bucket_capacity,
    make_host_batch,
    to_device,
    to_host,
)
from datafusion_tpu_torch.exec.cuda import sort_kernel
from datafusion_tpu_torch.exec.materialize import compact_batch
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.plan.expr import Column, SortExpr

# LIMIT at or below this rides the streaming TopK in the JAX package;
# above it the query is effectively a full sort and takes the run path.
TOPK_MAX = 65536

_SIGN_MASK = np.int64(0x7FFF_FFFF_FFFF_FFFF)
_F64_TINY = np.finfo(np.float64).tiny  # the smallest normal f64


def f64_sort_image(values: np.ndarray) -> np.ndarray:
    """int64 image of f64 keys whose ascending order is lax.sort's on
    the CPU: zeros of both signs and subnormals tie, and every NaN sorts
    after +inf, NaNs tied.  Canonicalize those to +0.0 and one NaN,
    then map the bits to their total order (negative floats: flip the
    magnitude bits)."""
    k = np.asarray(values, np.float64)
    k = np.where(np.abs(k) < _F64_TINY, 0.0, k)
    k = np.where(np.isnan(k), np.nan, k)
    b = np.ascontiguousarray(k).view(np.int64)
    return b ^ ((b >> 63) & _SIGN_MASK)


def _np_sort_key(
    values: np.ndarray,
    validity: Optional[np.ndarray],
    kind: str,
    asc: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side transformed key: an int64 (dead, value) operand pair,
    ascending, nulls last via the dead flag."""
    n = len(values)
    dead = np.zeros(n, bool) if validity is None else ~validity
    if kind == "f":
        k = values.astype(np.float64)
        if not asc:
            k = -k
        k = f64_sort_image(np.where(dead, 0.0, k))
    else:
        k = values.astype(np.int64)
        if not asc:
            k = ~k  # complement, not negation: -int64.min overflows
        k = np.where(dead, np.int64(0), k)
    return dead.astype(np.int64), k


class _KeyPlan:
    """How one ORDER BY key lowers onto a column: which column, its
    transform kind and direction."""

    __slots__ = ("index", "kind", "asc")

    def __init__(self, index: int, kind: str, asc: bool):
        self.index = index
        self.kind = kind  # "f" | "i" | "u64" | "str"
        self.asc = asc


class SortRelation(Relation):
    """Full sort, optionally with a fused selection and column
    projection: a `[Limit](Sort(Projection(Selection(x))))` chain
    collapses (exec/fused.rewrite_sort) to ONE SortRelation whose
    host-evaluable `predicate` folds into the selection mask and whose
    `output_cols` picks/reorders the output columns."""

    def __init__(
        self,
        child: Relation,
        sort_expr: list[SortExpr],
        out_schema: Schema,
        device,
        limit: Optional[int] = None,
        predicate=None,
        output_cols: Optional[list[int]] = None,
    ):
        if limit is not None and 0 < limit <= TOPK_MAX:
            raise NotSupportedError(
                f"ORDER BY ... LIMIT {limit} takes the streaming TopK "
                f"(0 < k <= {TOPK_MAX}), which is not ported yet "
                "(ROADMAP queue 1: TopK)"
            )
        self.child = child
        self.sort_expr = sort_expr
        self._schema = out_schema
        self.limit = limit
        self.device = device
        self.predicate = predicate
        self._out_cols = (
            list(output_cols)
            if output_cols is not None
            else list(range(len(child.schema)))
        )
        for se in sort_expr:
            if not isinstance(se.expr, Column):
                raise NotSupportedError(
                    f"ORDER BY supports column references, got {se.expr!r}"
                )
        in_schema = child.schema
        self._key_plans: list[_KeyPlan] = []
        for se in sort_expr:
            idx = se.expr.index
            f = in_schema.field(idx)
            if f.data_type == DataType.UTF8:
                self._key_plans.append(_KeyPlan(idx, "str", se.asc))
                continue
            kind = f.data_type.np_dtype.kind
            if kind == "O":
                raise NotSupportedError("struct columns cannot be ORDER BY keys")
            if kind == "u" and f.data_type.width == 64:
                kind = "u64"
            elif kind in ("b", "i", "u"):
                kind = "i"
            else:
                kind = "f"
            self._key_plans.append(_KeyPlan(idx, kind, se.asc))

    @property
    def schema(self) -> Schema:
        return self._schema

    # -- fused selection (predicate folded into the sort pass) --
    def _pred_np_mask(self, batch) -> np.ndarray:
        """This query's fused predicate over one batch as a numpy bool
        mask (cached on the batch, pinned by relation — the predicate
        carries per-query literals).  Predicates reach here only when
        host-evaluable (exec/fused.rewrite_sort's condition)."""
        hit = batch.cache.get("sort_pred_mask")
        if hit is not None and hit[0] is self:
            return hit[1]
        from datafusion_tpu_torch.exec.hostfn import host_pred_mask

        pm = host_pred_mask(self.predicate, batch, {})
        batch.cache["sort_pred_mask"] = (self, pm)
        return pm

    def _pred_batch(self, batch) -> RecordBatch:
        """The batch with the fused predicate folded into its selection
        mask (compact_batch then drops the rows it fails)."""
        if self.predicate is None:
            return batch
        pm = self._pred_np_mask(batch)
        m = pm if batch.mask is None else (to_host(batch.mask) & pm)
        return RecordBatch(
            batch.schema, list(batch.data), list(batch.validity),
            list(batch.dicts), num_rows=batch.num_rows, mask=m,
        )

    def _empty_result(self, in_schema, dicts) -> RecordBatch:
        cols = [
            np.empty(0, dtype=in_schema.field(i).data_type.np_dtype)
            for i in self._out_cols
        ]
        return make_host_batch(
            self._schema, cols, [None] * len(cols),
            [dicts[i] for i in self._out_cols],
        )

    # -- run sort + host merge --
    def _host_keys(self, columns, validity, dicts) -> list[np.ndarray]:
        """[dead0, value0, dead1, value1, ...] int64 operands, key 0
        most significant."""
        keys = []
        for kp in self._key_plans:
            idx = kp.index
            vals = columns[idx]
            if kp.kind == "str":
                d = dicts[idx]
                vals = d.sort_ranks()[vals] if d is not None else vals
                kind = "i"
            elif kp.kind == "u64":
                vals = (
                    np.ascontiguousarray(vals.astype(np.uint64))
                    ^ np.uint64(1 << 63)
                ).view(np.int64)
                kind = "i"
            else:
                kind = kp.kind
            dead, k = _np_sort_key(vals, validity[idx], kind, kp.asc)
            keys.append(dead)
            keys.append(k)
        return keys

    def _sorted_run(self, keys: list[np.ndarray]) -> np.ndarray:
        """Sort one run on the device; returns its permutation (int32,
        host).  A dead flag that is 0 on every row of the run is a
        constant key and does not cross to the device."""
        ops = [
            k for j, k in enumerate(keys)
            if j % 2 == 1 or bool(k.any())
        ]
        dev_ops = [to_device(o, self.device) for o in ops]
        return to_host(sort_kernel.argsort_multi(dev_ops))

    @staticmethod
    def _merge_runs(run_keys: list[list[np.ndarray]], run_perms: list[np.ndarray]):
        """Merge sorted runs on host: vectorized two-way merges via
        structured-array searchsorted (lexicographic on all keys)."""

        def to_struct(keys):
            dt = np.dtype([(f"f{i}", k.dtype) for i, k in enumerate(keys)])
            arr = np.empty(len(keys[0]), dt)
            for i, k in enumerate(keys):
                arr[f"f{i}"] = k
            return arr

        items = [
            (to_struct(k), p) for k, p in zip(run_keys, run_perms)
        ]
        while len(items) > 1:
            merged = []
            for i in range(0, len(items) - 1, 2):
                (ka, pa), (kb, pb) = items[i], items[i + 1]
                # position of each b-element among a (stable: a first)
                posb = np.searchsorted(ka, kb, side="left")
                out_len = len(ka) + len(kb)
                idxb = posb + np.arange(len(kb))
                keys = np.empty(out_len, dtype=ka.dtype)
                perms = np.empty((out_len,) + pa.shape[1:], dtype=pa.dtype)
                bmask = np.zeros(out_len, dtype=bool)
                bmask[idxb] = True
                keys[bmask] = kb
                keys[~bmask] = ka
                perms[bmask] = pb
                perms[~bmask] = pa
                merged.append((keys, perms))
            if len(items) % 2:
                merged.append(items[-1])
            items = merged
        return items[0][1]

    def batches(self) -> Iterator[RecordBatch]:
        # full sort: collect per-run host columns, device-sort each run,
        # merge the runs' keys on host
        in_schema = self.child.schema
        run_cols, run_valids, run_perms = [], [], []
        dicts = [None] * len(in_schema)
        total = 0
        pending_cols = None
        pending_valids = None
        pending_n = 0
        run_rows = None

        def flush_run():
            nonlocal pending_cols, pending_valids, pending_n
            if pending_n == 0:
                return
            cols = [np.concatenate(c) for c in pending_cols]
            valids = [
                None if all(v is None for v in vs) else np.concatenate(
                    [
                        np.ones(len(c), bool) if v is None else v
                        for v, c in zip(vs, cs)
                    ]
                )
                for vs, cs in zip(pending_valids, pending_cols)
            ]
            run_perms.append(self._sorted_run(self._host_keys(cols, valids, dicts)))
            run_cols.append(cols)
            run_valids.append(valids)
            pending_cols = None
            pending_valids = None
            pending_n = 0

        for batch in self.child.batches():
            for i, d in enumerate(batch.dicts):
                if d is not None:
                    dicts[i] = d
            # fused selection: the predicate folds into the compaction
            # mask
            cols, valids, _, n = compact_batch(self._pred_batch(batch))
            if n == 0:
                continue
            if run_rows is None:
                # run size: everything up to SORT_RUN_ROWS sorts in ONE
                # kernel call, so the host merge engages only on scans
                # too large for a single sort
                run_rows = max(
                    bucket_capacity(batch.capacity),
                    int(os.environ.get(
                        "DATAFUSION_TPU_SORT_RUN_ROWS", str(1 << 24)
                    )),
                )
            if pending_cols is None:
                pending_cols = [[] for _ in cols]
                pending_valids = [[] for _ in cols]
            for i, c in enumerate(cols):
                pending_cols[i].append(c[:n])
                pending_valids[i].append(
                    None if valids[i] is None else valids[i][:n]
                )
            pending_n += n
            total += n
            if pending_n >= run_rows:
                flush_run()
        flush_run()

        if total == 0:
            yield self._empty_result(in_schema, dicts)
            return

        take = total if self.limit is None else min(self.limit, total)
        out_dicts = [dicts[i] for i in self._out_cols]
        if len(run_cols) == 1:
            perm = run_perms[0][:take]
            out_cols = [run_cols[0][i][perm] for i in self._out_cols]
            out_valid = [
                None if run_valids[0][i] is None else run_valids[0][i][perm]
                for i in self._out_cols
            ]
            yield make_host_batch(self._schema, out_cols, out_valid, out_dicts)
            return

        # multi-run: recompute each run's sorted key arrays under the
        # FINAL dictionaries (a dictionary that grew mid-scan changes
        # rank values, but within-run order is rank-version-invariant —
        # ranks are order-isomorphic to the string values), then merge
        run_keys = []
        for ri in range(len(run_cols)):
            perm = run_perms[ri]
            sorted_cols = [c[perm] for c in run_cols[ri]]
            sorted_valids = [
                None if v is None else v[perm] for v in run_valids[ri]
            ]
            run_keys.append(self._host_keys(sorted_cols, sorted_valids, dicts))
        merged = self._merge_runs(
            run_keys,
            [
                np.stack([np.full(len(p), ri), np.arange(len(p))], axis=1)
                for ri, p in enumerate(run_perms)
            ],
        )[:take]
        runs = merged[:, 0]
        rows = merged[:, 1]
        out_cols = []
        out_valid = []
        for i in self._out_cols:
            parts = np.empty(take, dtype=run_cols[0][i].dtype)
            vparts = np.ones(take, dtype=bool)
            any_valid = any(rv[i] is not None for rv in run_valids)
            for ri in range(len(run_cols)):
                m = runs == ri
                if not m.any():
                    continue
                sel = run_perms[ri][rows[m]]
                parts[m] = run_cols[ri][i][sel]
                if run_valids[ri][i] is not None:
                    vparts[m] = run_valids[ri][i][sel]
            out_cols.append(parts)
            out_valid.append(vparts if any_valid else None)
        yield make_host_batch(self._schema, out_cols, out_valid, out_dicts)


class LimitRelation(Relation):
    """Row-limit: stops pulling child batches as soon as enough rows
    are materialized (reference `Limit` plan, `logicalplan.rs:310-315`)."""

    def __init__(self, child: Relation, limit: int, out_schema: Schema):
        self.child = child
        self.limit = limit
        self._schema = out_schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[RecordBatch]:
        remaining = self.limit
        if remaining <= 0:
            return
        # no one-ahead iteration here: the early return below exists to
        # avoid pulling any batch past the limit
        for batch in self.child.batches():
            cols, valids, dicts, n = compact_batch(batch)
            if n == 0:
                continue
            take = min(n, remaining)
            remaining -= take
            yield make_host_batch(
                batch.schema,
                [c[:take] for c in cols],
                [None if v is None else v[:take] for v in valids],
                dicts,
            )
            if remaining <= 0:
                return
