"""ORDER BY / LIMIT operators.

The counterpart of the JAX package's `exec/sort.py`, on its full-sort
path (run sort + host merge):

- **Run sort**: the child's live rows collect on the host into runs of
  up to `DATAFUSION_TPU_SORT_RUN_ROWS` rows (2^24 by default, so one
  run in practice); each run's transformed keys cross to the device as
  int64 operands through the wire codec and the hand-written radix-sort
  kernel (`exec/cuda/sort_kernel.py`) returns the stable permutation,
  which comes back as ceil(bits/8) byte planes in one packed copy.
  There is no run-size window: the JAX package's 2^18-row bitonic
  window was the TPU's VMEM.  A run key seen twice stores its
  permutation (`_sorted_run`), so a third run of the relation over the
  same in-memory batches skips the keys, the sort and the copy back.
  Not ported: the JAX package's host-routed run sort (`_host_run_sort`),
  which pays only where the permutation's copy back costs more than a
  host lexsort (about 150 ns a row a key): a link slower than about 27
  MB/s, some 1,300 times slower than the one `chip_smoke.py` measures
  on an NVIDIA H100 80GB HBM3 at 700 W (ROADMAP item 6).
- **Host merge**: runs merge on the host with a vectorized
  structured-array `searchsorted` merge, re-ranking strings under the
  final dictionaries.

Key transforms:
- Every ORDER BY key lowers to a value operand, led by a `dead`
  operand, 1 for NULL keys, once a NULL has been seen in that key
  (nulls sort last, as a *separate* leading key — a value sentinel
  would collide with real extremes); dead rows' values are zeroed so
  they compare equal among themselves.  One rule (`_null_keys`) picks
  the dead operands for the full sort's run and the TopK's state: a
  key with no NULL so far has none (a constant key reorders nothing).
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

**Streaming TopK** (`ORDER BY ... LIMIT k`, 0 < k <= TOPK_MAX): the
device holds a state of at most k rows, their key operands and their
global row ids.  Per batch group (the batch-group fold: up to
`exec/fused.fuse_group_max()` batches; one with DATAFUSION_TPU_FUSE=0),
the live rows' key operands of every batch of the group are built as
above, on the device, in scan order, and follow the state's; one radix
argsort of the concatenation keeps the first k.  The sort is stable,
the state comes first and the rows keep scan order, so
ties keep ascending row order, as the JAX package's `lax.top_k` keeps
them; `torch.topk` does not, and the port never calls it.  Payload
columns never cross: the host keeps the rows of the batches that still
hold survivors (it pulls the k row ids once per group) and gathers the
output from them, bit-exact.  A Utf8 key's ranks change when its
dictionary grows, and a key's first NULL adds its dead operand, so the
state's key operands are rebuilt from the kept rows where a group
brings either.  A batch's key operands are built on the device
(`_device_ops`) from its key columns' device inputs, which a warm
in-memory batch already holds; the fused predicate's mask crosses
bit-packed and joins the upstream mask there.

`LimitRelation` over anything but a Sort stops pulling batches once it
has its rows.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    bucket_capacity,
    device_inputs,
    device_pull,
    dict_versions,
    has_link,
    make_host_batch,
    put_compressed,
    subset_view,
    to_device,
    to_host,
)
from datafusion_tpu_torch.exec.cuda import sort_kernel
from datafusion_tpu_torch.exec.fused import fuse_group_max, fusion_enabled
from datafusion_tpu_torch.exec.materialize import _fetch_mask, compact_batch
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.obs.stats import iter_stats, op_timer
from datafusion_tpu_torch.plan.expr import Column, SortExpr
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call

# LIMIT at or below this rides the streaming TopK in the JAX package;
# above it the query is effectively a full sort and takes the run path.
TOPK_MAX = 65536

_SIGN_MASK = np.int64(0x7FFF_FFFF_FFFF_FFFF)
_F64_TINY = np.finfo(np.float64).tiny  # the smallest normal f64
_F32_TINY = np.finfo(np.float32).tiny
_SIGN_MASK_T = int(_SIGN_MASK)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _f64_bits(x: torch.Tensor) -> torch.Tensor:
    """The int64 bit view of a float64 tensor."""
    return x.contiguous().view(torch.int64)


def f64_sort_image(values: np.ndarray) -> np.ndarray:
    """int64 image of f64 keys whose ascending order is lax.sort's on
    the CPU: zeros of both signs and subnormals tie, and every NaN sorts
    after +inf, NaNs tied.  Canonicalize those to +0.0 and one NaN,
    then map the bits to their total order (negative floats: flip the
    magnitude bits)."""
    k = np.asarray(values, np.float64)
    k = np.where(np.abs(k) < _F64_TINY, 0.0, k)
    return f64_total_image(np.where(np.isnan(k), np.nan, k))


def f64_total_image(values: np.ndarray) -> np.ndarray:
    """int64 image of f64 keys in IEEE total order: -0.0 before +0.0
    and subnormals kept, as the JAX package's single-key TopK orders its
    float scores (bit images under `lax.top_k`), magnitude bits of
    negative floats flipped.  NaN rows are the caller's to place."""
    b = np.ascontiguousarray(values, np.float64).view(np.int64)
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
        # a TopK over ONE float key orders as the JAX package's
        # single-key TopK does: IEEE total order (-0.0 before +0.0,
        # subnormals kept), every NaN after every number in either
        # direction, NULLs last; every other key orders as the full
        # sort (but for f32 subnormals under several keys, _host_keys)
        # the full sort's run permutations, stored after second-chance
        # admission (`_sorted_run`) and keyed by the run's source batch
        # identities: FIFO-bounded, so multi-run sorts and cold re-scans
        # never accumulate
        self._run_ops_cache: OrderedDict = OrderedDict()
        self._run_ops_cache_max = 4
        self._run_seen: OrderedDict = OrderedDict()
        # the TopK's codec memory
        self._wire_hints: dict = {}
        self._topk = limit is not None and 0 < limit <= TOPK_MAX
        self._total_float = (
            self._topk and len(self._key_plans) == 1 and self._key_plans[0].kind == "f"
        )

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        keys = ", ".join(f"#{se.expr.index} {'ASC' if se.asc else 'DESC'}"
                         for se in self.sort_expr)
        # the chain this operator absorbed (exec/fused.rewrite_sort)
        fused = ""
        if self.predicate is not None:
            fused += "+filter"
        if self._out_cols != list(range(len(self.child.schema))):
            fused += "+project"
        if self._topk:
            return f"TopK{fused}[{keys}, limit={self.limit}]"
        return f"Sort{fused}[{keys}]"

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
        m = pm if batch.mask is None else (_fetch_mask(batch) & pm)
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
    def _null_keys(self, validity) -> tuple[bool, ...]:
        """For each ORDER BY key, whether these rows hold a NULL in it:
        the keys that need a dead operand."""
        return tuple(
            validity[kp.index] is not None and not validity[kp.index].all()
            for kp in self._key_plans
        )

    def _host_keys(self, columns, validity, dicts, dead=None, ranks=None) -> list[np.ndarray]:
        """int64 operands, key 0 most significant: each key's dead flag
        where `dead` (a bool a key, None: every key) asks for it, then
        its value image.  A key left without its flag must hold no NULL
        in these rows.  A Utf8 key's codes map through `ranks[column]`
        where given, else through its dictionary's ranks now."""
        keys = []
        for j, kp in enumerate(self._key_plans):
            idx = kp.index
            vals = columns[idx]
            if kp.kind == "str":
                d = dicts[idx]
                if ranks is not None and idx in ranks:
                    vals = ranks[idx][vals]
                elif d is not None:
                    vals = d.sort_ranks()[vals]
                kind = "i"
            elif kp.kind == "u64":
                vals = (
                    np.ascontiguousarray(vals.astype(np.uint64))
                    ^ np.uint64(1 << 63)
                ).view(np.int64)
                kind = "i"
            else:
                kind = kp.kind
            if kind == "f" and self._total_float:
                d, k = self._total_float_key(vals, validity[idx], kp.asc)
            else:
                if kind == "f" and self._topk and vals.dtype == np.float32:
                    # the JAX package's multi-key TopK widens f32 keys on
                    # the CPU with subnormals read as zero
                    vals = np.where(np.abs(vals) < _F32_TINY, np.float32(0), vals)
                d, k = _np_sort_key(vals, validity[idx], kind, kp.asc)
            if dead is None or dead[j]:
                keys.append(d)
            keys.append(k)
        return keys

    @staticmethod
    def _total_float_key(values, validity, asc: bool) -> tuple[np.ndarray, np.ndarray]:
        """(dead, value) operands of a single float TopK key.  Every NaN
        takes int64's maximum, after every number's image in either
        direction (the largest, +inf ASC or -inf DESC, is 0x7FF0 << 48),
        so NaNs tie and need no operand of their own."""
        v = values.astype(np.float64)
        dead = np.zeros(len(v), bool) if validity is None else ~validity
        img = f64_total_image(v)
        if not asc:
            img = ~img
        img = np.where(np.isnan(v), np.iinfo(np.int64).max, img)
        return dead.astype(np.int64), np.where(dead, np.int64(0), img)

    def _sorted_run(self, keys: list[np.ndarray], cache_key=None, pin=None) -> np.ndarray:
        """Sort one run on the device; returns its permutation (int32,
        host).

        Second-chance admission: a run key (`cache_key`) must be seen
        twice before its permutation is stored in `_run_ops_cache`
        (`pin` holds the source batches alive), so one-shot file scans,
        whose batch objects are fresh every scan, store nothing; a
        third run of the same relation then skips the keys, the sort
        and the copy back (`sort.perm_cache_hits`).  Only where a copy
        crosses a link (`batch.has_link`): on the CPU the copy back is
        free.  On a CUDA device the run's wall, copy to copy, is the
        radix route's evidence in the cost store
        (`cost/advisor.observe_sort_route`)."""
        n = len(keys[0])
        admit = False
        if cache_key is not None and has_link(self.device):
            if cache_key in self._run_seen:
                admit = True
            else:
                self._run_seen[cache_key] = True
                while len(self._run_seen) > 32:
                    self._run_seen.popitem(last=False)
        t0 = time.perf_counter()
        dev_ops = put_compressed(keys, self.device, owner="sort.keys")
        perm = device_call(_sort_planes, dev_ops, _tag="sort", _device=self.device)
        if self.device.type == "cuda":
            from datafusion_tpu_torch import cost as _cost
            from datafusion_tpu_torch.cost import advisor

            advisor.observe_sort_route(_cost.store(), "radix", n, time.perf_counter() - t0)
        if admit:
            self._run_ops_cache[cache_key] = (perm, pin)
            while len(self._run_ops_cache) > self._run_ops_cache_max:
                self._run_ops_cache.popitem(last=False)
        return perm

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
        if self.limit is not None and 0 < self.limit <= TOPK_MAX:
            yield from self._topk_batches()
            return
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

        run_src: list = []

        def flush_run():
            nonlocal pending_cols, pending_valids, pending_n, run_src
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
            # a cacheable run: unmasked source batches (their live rows
            # are their content), keyed on their identities, the Utf8
            # keys' dictionary versions, the row count and the fused
            # predicate (its repr carries this query's literals)
            cache_key = None
            if run_src and all(b.mask is None for b in run_src):
                versions = tuple(
                    dicts[kp.index].version
                    if kp.kind == "str" and dicts[kp.index] is not None else -1
                    for kp in self._key_plans
                )
                cache_key = (tuple(id(b) for b in run_src), versions, pending_n,
                             None if self.predicate is None else repr(self.predicate))
            hit = None if cache_key is None else self._run_ops_cache.get(cache_key)
            with METRICS.timer("execute.sort"), op_timer(self):
                if hit is not None:
                    METRICS.add("sort.perm_cache_hits")
                    perm = hit[0]
                else:
                    perm = self._sorted_run(
                        self._host_keys(cols, valids, dicts, self._null_keys(valids)),
                        cache_key, tuple(run_src))
            run_perms.append(perm)
            run_cols.append(cols)
            run_valids.append(valids)
            pending_cols = None
            pending_valids = None
            pending_n = 0
            run_src = []

        for batch in iter_stats(self.child):
            for i, d in enumerate(batch.dicts):
                if d is not None:
                    dicts[i] = d
            # fused selection: the predicate folds into the compaction
            # mask (run_src keeps the original batches)
            cols, valids, _, n = compact_batch(self._pred_batch(batch))
            if n == 0:
                continue
            run_src.append(batch)
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


    # -- the TopK's key operands built on the device --
    def _pred_device_mask(self, batch) -> torch.Tensor:
        """The fused predicate over one batch as a bool tensor on the
        device: the host-evaluated mask crosses bit-packed through the
        wire codec, cached on the batch and pinned by relation (the
        predicate carries this query's literals)."""
        hit = batch.cache.get("sort_pred_dev_mask")
        if hit is not None and hit[0] is self:
            return hit[1]
        m = put_compressed([self._pred_np_mask(batch)], self.device, owner="sort.keys")[0]
        batch.cache["sort_pred_dev_mask"] = (self, m)
        return m

    def _device_ops(self, batch, dead, ranks) -> list:
        """The batch's live rows' int64 key operands, built on the device
        from its key columns' device inputs (`device_inputs`, cached on
        the batch, so a warm in-memory batch copies nothing): the same
        operands `_host_keys` builds on the host from the compacted rows.
        The live rows are the row bound, the upstream mask and the fused
        predicate (`_pred_device_mask`), joined on the device; `dead`
        picks the keys that carry their NULL operand and `ranks[column]`
        is a Utf8 key's rank table (a tensor on the device)."""
        dev = self.device
        kcols = sorted({kp.index for kp in self._key_plans})
        sub = {c: i for i, c in enumerate(kcols)}
        data, validity, mask = device_inputs(subset_view(batch, kcols), dev, self._wire_hints)
        live = torch.arange(batch.capacity, device=dev) < batch.num_rows
        if mask is not None:
            live &= mask[: batch.capacity]
        if self.predicate is not None:
            live &= self._pred_device_mask(batch)
        rows = torch.nonzero(live).squeeze(1)
        ops = []
        for j, kp in enumerate(self._key_plans):
            v = data[sub[kp.index]].index_select(0, rows)
            valid = validity[sub[kp.index]]
            dead_op = (torch.zeros(v.shape[0], dtype=torch.bool, device=dev) if valid is None
                       else ~valid.index_select(0, rows))
            ops.extend(self._device_key(kp, v, dead_op, ranks, dead[j]))
        return ops

    def _device_key(self, kp, v, dead_op, ranks, with_dead: bool) -> list:
        """One key's operands from its live values `v` on the device: its
        dead flag where asked, then its value image, as `_host_keys`."""
        if kp.kind == "str":
            r = ranks.get(kp.index)
            v = v if r is None else r[v.to(torch.int64)]
            kind = "i"
        elif kp.kind == "u64":
            # the uint64's int64 bit view with its sign bit flipped:
            # order-preserving and lossless
            v = v.to(torch.int64) ^ _I64_MIN
            kind = "i"
        else:
            kind = kp.kind
        if kind == "f" and self._total_float:
            img = _f64_bits(v.to(torch.float64))
            img = img ^ ((img >> 63) & _SIGN_MASK_T)
            if not kp.asc:
                img = ~img
            k = torch.where(torch.isnan(v), _I64_MAX, img)
        elif kind == "f":
            if self._topk and v.dtype == torch.float32:
                # the JAX package's multi-key TopK widens f32 keys on
                # the CPU with subnormals read as zero
                v = torch.where(v.abs() < _F32_TINY, torch.zeros((), dtype=v.dtype, device=v.device), v)
            k = v.to(torch.float64)
            if not kp.asc:
                k = -k
            k = torch.where(dead_op, 0.0, k)
            # `f64_sort_image`: zeros of both signs and subnormals read
            # +0.0, every NaN the canonical NaN, then the total order
            k = torch.where(k.abs() < _F64_TINY, 0.0, k)
            k = torch.where(torch.isnan(k), float("nan"), k)
            b = _f64_bits(k)
            k = b ^ ((b >> 63) & _SIGN_MASK_T)
        else:
            k = v.to(torch.int64)
            if not kp.asc:
                k = ~k  # complement, not negation: -int64.min overflows
        k = torch.where(dead_op, 0, k)
        return [dead_op.to(torch.int64), k] if with_dead else [k]

    # -- streaming TopK --
    def _topk_batches(self) -> Iterator[RecordBatch]:
        """The TopK's one output batch: this query's first `limit` rows
        of the scan's state (`_topk_scan`), or of the state the serving
        megabatch kept for several queries at once
        (`run_topk_megabatch`), gathered from the held batches."""
        injected = self.__dict__.pop("_injected_topk", None)
        held, rows, dicts = injected if injected is not None else self._topk_scan(self.limit)
        in_schema = self.child.schema
        if rows is None:
            yield self._empty_result(in_schema, dicts)
            return
        cols, valids = self._gather(held, rows[:self.limit], len(in_schema))
        yield make_host_batch(
            self._schema, [cols[i] for i in self._out_cols],
            [valids[i] for i in self._out_cols], [dicts[i] for i in self._out_cols],
        )

    def _topk_scan(self, k: int, tag: Optional[str] = None):
        """The streaming TopK's scan at capacity `k`: returns (held
        batches, the state's global row ids in order or None for no
        rows, the dictionaries).  `_merges` counts its sorts; each is a
        device pass tagged `tag` (by default `topk`, `topk.group` for a
        group of several batches)."""
        self._merges = 0
        dev = self.device
        in_schema = self.child.schema
        dicts = [None] * len(in_schema)
        str_keys = [kp.index for kp in self._key_plans if kp.kind == "str"]
        needed = {kp.index for kp in self._key_plans} | set(self._out_cols)
        # the batches that hold survivors: row base -> (columns,
        # validity) of their live rows, only the columns needed
        held: dict[int, tuple] = {}
        state_ops = state_ids = None
        rows = np.empty(0, np.int64)  # the state's global row ids, in order
        versions = None
        dead = (False,) * len(self._key_plans)  # keys with a dead operand
        base = 0
        group_max = fuse_group_max() if fusion_enabled() else 1
        # the group's batches: (columns, validity) of their live rows,
        # only the columns needed, their row count and their dictionary
        # versions (`batch.dict_versions`)
        group: list = []
        # the Utf8 keys' rank tables on the device for this scan only, by
        # (column, dictionary version): a later run may read another
        # dictionary of the same length
        rank_dev: dict = {}

        def merge():
            """One radix argsort of the state and the group's live rows
            (in scan order, so ties keep ascending row order), one read
            of the k row ids, then the held batches pruned.  Each batch's
            key operands are built and copied on their own (its arrays
            stay cache-sized on the host) and concatenate on the device."""
            nonlocal state_ops, state_ids, rows, versions, dead, base
            n = sum(g[2] for g in group)
            # one prefix of each Utf8 key's dictionary for the whole
            # merge: the largest version pinned on the group's batches,
            # which holds every code of the group and of the state (a
            # reader on the prefetch threads may append meanwhile, and
            # ranks read at two moments would rank one string twice)
            now = tuple(max(g[3][i] or 0 for g in group) for i in str_keys)
            ranks = {i: dicts[i].sort_ranks(v) for i, v in zip(str_keys, now)
                     if dicts[i] is not None}
            seen = dead
            for _, bvalids, _, _, _ in group:
                seen = tuple(a or b for a, b in zip(seen, self._null_keys(bvalids)))
            if state_ops is not None and (now != versions or seen != dead):
                # a grown dictionary re-ranks its strings, a key's first
                # NULL adds its dead operand: rebuild the state's
                # operands from its rows
                scols, svalids = self._gather(held, rows, len(in_schema))
                state_ops = [to_device(o, dev, owner="sort.keys") for o in
                             self._host_keys(scols, svalids, dicts, seen, ranks)]
            versions, dead = now, seen
            ranks_dev = {}
            for i, v in zip(str_keys, now):
                if i in ranks:
                    if (i, v) not in rank_dev:
                        rank_dev[(i, v)] = to_device(ranks[i].astype(np.int64), dev,
                                                     owner="sort.keys")
                    ranks_dev[i] = rank_dev[(i, v)]
            parts = [self._device_ops(b, dead, ranks_dev) for _, _, _, _, b in group]
            if state_ops is not None:
                parts.insert(0, state_ops)
            if len(group) > 1:
                METRICS.add("fused.groups")
                METRICS.add("fused.group_batches", len(group))
            state_ops, state_ids = device_call(
                _topk_pass, parts, state_ids, base, n, k,
                _tag=tag or ("topk.group" if len(group) > 1 else "topk"), _device=dev)
            self._merges += 1
            for bcols, bvalids, bn, _, _ in group:
                held[base] = (bcols, bvalids)
                base += bn
            group.clear()
            rows = to_host(state_ids)
            owners = set(self._owner(held, rows).tolist())  # df-lint: ok(DF001) — a numpy array from to_host above
            for b in [b for b in held if b not in owners]:
                del held[b]

        for batch in iter_stats(self.child):
            for i, d in enumerate(batch.dicts):
                if d is not None:
                    dicts[i] = d
            cols, valids, _, n = compact_batch(self._pred_batch(batch))
            if n == 0:
                continue
            group.append(([c if i in needed else None for i, c in enumerate(cols)],
                          [v if i in needed else None for i, v in enumerate(valids)], n,
                          dict_versions(batch), batch))
            if len(group) >= group_max:
                with METRICS.timer("execute.sort"), op_timer(self):
                    merge()
        if group:
            with METRICS.timer("execute.sort"), op_timer(self):
                merge()
        return held, (None if state_ids is None else rows), dicts

    @staticmethod
    def _owner(held: dict, rows: np.ndarray) -> np.ndarray:
        """The row base of the held batch each global row id lies in."""
        bases = np.fromiter(sorted(held), np.int64, len(held))
        return bases[np.searchsorted(bases, rows, side="right") - 1]

    def _gather(self, held: dict, rows: np.ndarray, ncols: int):
        """The columns and validity of global rows `rows`, in order,
        gathered from the held batches (a column none holds is None)."""
        owner = self._owner(held, rows)
        first = held[int(owner[0])] if len(rows) else next(iter(held.values()))
        cols, valids = [], []
        for i in range(ncols):
            if first[0][i] is None:
                cols.append(None)
                valids.append(None)
                continue
            out = np.empty(len(rows), first[0][i].dtype)
            any_valid = any(h[1][i] is not None for h in held.values())
            vout = np.ones(len(rows), bool) if any_valid else None
            for b in np.unique(owner).tolist():  # df-lint: ok(DF001) — a numpy array, not a tensor
                m = owner == b
                local = rows[m] - b
                bcols, bvalids = held[b]
                out[m] = bcols[i][local]
                if vout is not None and bvalids[i] is not None:
                    vout[m] = bvalids[i][local]
            cols.append(out)
            valids.append(vout)
        return cols, valids


def _plane_count(cap: int) -> int:
    """Byte planes a permutation of a `cap`-row run crosses in."""
    return max(1, ((cap - 1).bit_length() + 7) >> 3)


def _sort_planes(dev_ops) -> np.ndarray:
    """One radix argsort of a run's int64 operands on the device; the
    permutation crosses back as ceil(bits/8) byte planes (a 6M-row run
    needs 23 bits: 3 planes, not int32's 4 bytes) in ONE packed copy
    (`device_pull`), and the host reassembles it."""
    perm = sort_kernel.argsort_multi(list(dev_ops))
    n = int(perm.shape[0])
    planes = [((perm >> (8 * i)) & 0xFF).to(torch.uint8)
              for i in range(_plane_count(bucket_capacity(n)))]
    host = device_pull(planes)
    METRICS.add("sort.perm_plane_bytes", sum(p.nbytes for p in host))
    out = host[0].astype(np.int32)
    for i in range(1, len(host)):
        out |= host[i].astype(np.int32) << np.int32(8 * i)
    return out


def _topk_pass(parts, state_ids, base: int, n: int, k: int):
    """One TopK merge on the device: the state's key operands and each
    batch's of the group (`parts`, the state first) concatenated, one
    radix argsort, the first `k`.  Returns the new state's operands and
    global row ids; the new rows' ids are base .. base + n - 1."""
    dev = parts[0][0].device
    ops = [p[0] if len(parts) == 1 else torch.cat(p) for p in zip(*parts)]
    ids = torch.arange(base, base + n, dtype=torch.int64, device=dev)
    if state_ids is not None:
        ids = torch.cat([state_ids, ids])
    LEDGER.adopt((ops, ids), "fold")
    keep = sort_kernel.argsort_multi(ops)[:k]
    return [o.index_select(0, keep) for o in ops], ids.index_select(0, keep)


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

    def op_label(self) -> str:
        return f"Limit[{self.limit}]"

    def batches(self) -> Iterator[RecordBatch]:
        remaining = self.limit
        if remaining <= 0:
            return
        # no one-ahead iteration here: the early return below exists to
        # avoid pulling any batch past the limit
        for batch in iter_stats(self.child):
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


def run_topk_megabatch(rels: list) -> None:
    """ONE scan, N TopK queries that differ only in their LIMIT: the
    serving megabatch's TopK lane (the JAX package's
    `run_topk_megabatch`).  Preconditions (serve.py `_mega_key`): the
    relations sort one table by the same keys, with no fused predicate
    and the same output columns.

    One state of the largest member's k is kept (`_topk_scan`): one
    radix-sort merge per batch group for all N.  The state orders rows
    by (key, row) with ties in ascending row order, so each query's
    first k rows of it are exactly its solo answer.  Each relation gets
    the held batches and the row ids as `_injected_topk`; its
    `batches()` then gathers its own prefix."""
    leader = max(rels, key=lambda r: r.limit)
    held, rows, dicts = leader._topk_scan(leader.limit, tag="topk.mega")
    METRICS.add("serve.megabatch_launches", leader._merges)
    METRICS.add("serve.megabatch_queries", len(rels))
    for r in rels:
        r._injected_topk = (held, rows, dicts)
