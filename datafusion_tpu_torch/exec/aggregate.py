"""Grouped aggregation on the device.

The counterpart of the JAX package's `exec/aggregate.py`:

- **Filter fusion**: an aggregate directly over a Selection evaluates
  the predicate inside the aggregate operator, so TPC-H Q1's filter and
  eight aggregates are one pass over each batch.
- **Group-key encoding (host)**: a persistent `GroupKeyEncoder` maps
  each row's key tuple to a dense, append-only group id (numpy, the
  JAX package's encoder unchanged).  Dense ids are stable across
  batches, so device accumulators grow by identity padding.
- **Slot deduplication**: aggregates lower to accumulator *slots*
  shared across functions — SUM(x) and AVG(x) share one sum slot and
  one count slot; COUNT(*) rides the per-group row count, and a count
  whose argument has no validity aliases the row count.  TPC-H Q1's 8
  aggregates touch 5 sum slots.
- **Accumulation (device)**: per batch, the used columns cross to the
  device; per *batch group* (the batch-group fold, `exec/fused.py`: up
  to `fuse_group_max()` batches with one structure and one set of
  dictionary tables) the batches concatenate along rows, and the
  predicate and slot arguments evaluate once over the group as torch
  ops (`fused_group`).  The slots then take one of two routes by group
  capacity G (the JAX core's `_kernel`, less its dense one-hot route
  for G <= 64, which the grouped-reduce kernel serves on Hopper):
  - G <= `agg_max_groups()` (8192): each slot is one launch of the
    hand-written grouped-reduce kernel (`exec/cuda/hash_agg.py`) over
    the group's rows;
  - above it, sort-merge (`_sortmerge_update`): the dense state
    (implicit keys 0..G-1) and the group's rows are argsorted by group
    id in one launch of the hand-written radix sort
    (`exec/cuda/sort_kernel.py`), runs of equal ids reduce by segmented
    scans, and each group's total is read back into the dense layout.
  Both routes keep one state layout, so a scan that grows past 8192
  groups switches route and keeps its state.  DATAFUSION_TPU_FUSE=0
  updates once per batch.
- **Prefetch** (`exec/prefetch.py`, over a CSV scan on a CUDA device): one thread
  pulls batches, a second encodes group ids, builds the aux tables and
  copies the used columns, while the consumer dispatches.
- **Cross-query megabatch** (serve.py's aggregate lane,
  `run_aggregate_megabatch`): N queries whose cores agree but for their
  literals (`_AggregateCore.mega_key`) scan one table once.  Per batch
  group each query's predicate gives its live mask, the ids are shared,
  a slot's values are evaluated once per distinct set of the literal
  values they read, and each slot makes ONE launch of the grouped
  reduce's query axis (`hash_agg.grouped_reduce_multi`) for all N
  (`_AggregateCore.multi_fused_group`); above `agg_max_groups()` each
  query's sort-merge update runs in turn over the shared scan.  Each
  query's state is bit-identical to its solo run's.
- **Finalization**: one device-to-host copy of the state; AVG =
  SUM/COUNT on the host; groups observed only in filtered-out rows
  (count 0) are dropped.

- **Materialized views** (ingest/): a view owns one relation's state
  and folds each appended delta through `_batch_groups` and
  `fused_group` (one pass), growing it with `_grow_state` past its
  capacity; its reads inject the state (`_injected_state`).

Not ported yet (ROADMAP queue 1): host-split placement and cost
presizing.

Accumulator dtypes: integer SUM accumulates in 64-bit; COUNT is Int64
internally, UInt64 in the output (planner contract); MIN/MAX keep the
argument dtype.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import ExecutionError, NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    StringDictionary,
    bucket_capacity,
    device_inputs,
    dict_versions,
    host_array,
    make_host_batch,
    param_tensors,
    pin_dict_versions,
    subset_view,
    to_device,
    to_host,
)
from datafusion_tpu_torch.exec.cuda import agg_max_groups, hash_agg, sort_kernel
from datafusion_tpu_torch.exec.expression import Env, ExprCompiler, compute_aux_values
from datafusion_tpu_torch.exec.fused import fuse_group_max, fusion_enabled, iter_groups
from datafusion_tpu_torch.exec.prefetch import pipeline_enabled, staged_pipeline
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.obs.stats import iter_stats, op_timer
from datafusion_tpu_torch.plan.expr import AggregateFunction, Column, Expr
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call


_SCAN_OPS = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def group_capacity(n: int) -> int:
    """Accumulator capacity: next power of two, floor 8."""
    cap = 8
    while cap < n:
        cap <<= 1
    return cap


def _row_bytes_view(a: np.ndarray) -> np.ndarray:
    """(N, K) int64 -> (N,) opaque-bytes view with a consistent total
    order (memcmp), used for cross-batch key identity."""
    a = np.ascontiguousarray(a)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


class GroupKeyEncoder:
    """Host-side dense encoder of group-key tuples -> stable group ids.

    Vectorized: the known key set lives in a sorted row-view array
    matched with `searchsorted`; no per-key Python dict operations, so
    encoding stays numpy-speed at 10^6 groups.
    """

    # radix-LUT fast path bound: product of per-component radices must
    # keep the id lookup table at most this many entries (16 MB int32)
    _LUT_MAX = 1 << 22

    def __init__(self, num_keys: int):
        self.num_keys = num_keys
        k = max(2 * num_keys, 1)
        self._arr = np.empty((0, k), dtype=np.int64)  # key rows by group id
        self._sorted_rows = _row_bytes_view(self._arr)  # sorted row view
        self._sorted_ids = np.empty(0, dtype=np.int64)
        # radix-LUT fast path (small non-negative key spaces: dictionary
        # codes, low-cardinality ints): encode = one gather instead of a
        # per-batch sort.  Disabled permanently on the first batch whose
        # key space can't be packed small (negatives / wide ranges).
        self._fast = True
        self._radix: Optional[list[int]] = None
        self._lut: Optional[np.ndarray] = None

    @property
    def num_groups(self) -> int:
        return len(self._arr)

    @staticmethod
    def _to_int_image(c: np.ndarray) -> np.ndarray:
        """Lossless integer image of a key column.  Floats are *bit-cast*
        (a value cast would merge 1.5 and 1.7); -0.0 normalizes to 0.0
        and NaNs to one canonical NaN so SQL equality groups them.
        Integer columns keep their native width (packing upcasts)."""
        if c.dtype.kind == "f":
            c = c.astype(np.float64)
            c = np.where(c == 0.0, 0.0, c)  # -0.0 == 0.0
            c = np.where(np.isnan(c), np.float64(np.nan), c)
            return c.view(np.int64)
        if c.dtype.kind == "b":
            return c.astype(np.int8)
        return c

    def encode(
        self,
        key_cols: list[np.ndarray],
        key_valids: list,
    ) -> np.ndarray:
        """key_cols: per-key numpy arrays (dict codes for strings);
        key_valids: per-key bool validity arrays or None.  Returns int32
        group ids per row.  NULL keys form their own group (SQL
        semantics): each key contributes (value-with-nulls-zeroed,
        isnull flag) to the group tuple.
        """
        if key_cols and len(key_cols[0]) == 0:
            return np.empty(0, dtype=np.int32)  # _pack can't reduce empty
        # components: (value, isnull) per key.  None stands for an
        # all-zero component (no nulls) — the fast path skips it and the
        # general path materializes zeros.  Values keep their native
        # integer width here; packing/stacking upcasts as needed.
        comps: list[Optional[np.ndarray]] = []
        n = len(key_cols[0]) if key_cols else 0
        for c, v in zip(key_cols, key_valids):
            c = self._to_int_image(np.asarray(c))
            if v is None:
                comps.append(c)
                comps.append(None)
            else:
                v = np.asarray(v)
                comps.append(np.where(v, c, 0))
                comps.append(~v)
        if self._fast:
            ids = self._encode_fast(comps, n)
            if ids is not None:
                return ids
            # the key space just outgrew the LUT: fall through to the
            # general path for this and every later batch (ids assigned
            # so far stay valid — _arr is shared between both paths)
            self._rebuild_sorted()
        rows = [
            np.zeros(n, dtype=np.int64) if c is None else c.astype(np.int64)
            for c in comps
        ]
        stacked = np.stack(rows, axis=1)  # (n, 2K)
        # Fast path: pack the key tuple into one int64 (mixed radix), so
        # per-batch uniquing is a single 1-D sort; the pack is per-batch
        # only — cross-batch identity goes through the row-bytes view.
        packed = self._pack(stacked)
        if packed is not None:
            _, first, inv = np.unique(packed, return_index=True, return_inverse=True)
        else:
            _, first, inv = np.unique(
                _row_bytes_view(stacked), return_index=True, return_inverse=True
            )
        urows = stacked[first]  # (U, 2K), per-batch unique keys
        uview = _row_bytes_view(urows)
        order = np.argsort(uview)  # row-bytes order for searchsorted
        sview = uview[order]
        pos = np.searchsorted(self._sorted_rows, sview)
        found = np.zeros(len(sview), dtype=bool)
        in_range = pos < len(self._sorted_rows)
        found[in_range] = self._sorted_rows[pos[in_range]] == sview[in_range]

        lut_sorted = np.empty(len(sview), dtype=np.int64)
        lut_sorted[found] = self._sorted_ids[pos[found]]
        n_new = int((~found).sum())
        if n_new:
            new_ids = np.arange(
                self.num_groups, self.num_groups + n_new, dtype=np.int64
            )
            lut_sorted[~found] = new_ids
            self._arr = np.concatenate([self._arr, urows[order][~found]])
            ins = pos[~found]  # insertion points into the old sorted view
            self._sorted_rows = np.insert(self._sorted_rows, ins, sview[~found])
            self._sorted_ids = np.insert(self._sorted_ids, ins, new_ids)

        lut = np.empty(len(uview), dtype=np.int64)
        lut[order] = lut_sorted
        return lut[inv].astype(np.int32)

    @staticmethod
    def _pack(stacked: np.ndarray) -> Optional[np.ndarray]:
        """Mixed-radix pack of (n, 2K) int64 key parts into (n,) int64;
        None when the combined range could overflow 63 bits."""
        mins = stacked.min(axis=0).tolist()
        maxs = stacked.max(axis=0).tolist()
        # ranges in Python ints: a single int64 column can span > 2^63,
        # which would wrap (and slip past the bail-out) in int64 math
        ranges = [int(mx) - int(mn) + 1 for mn, mx in zip(mins, maxs)]
        total = 1
        for r in ranges:
            total *= r
            if total > (1 << 62):
                return None
        # total <= 2^62 implies every range (and every shifted value)
        # fits comfortably in int64
        packed = np.zeros(stacked.shape[0], dtype=np.int64)
        for k in range(stacked.shape[1]):
            packed = packed * np.int64(ranges[k]) + (stacked[:, k] - np.int64(mins[k]))
        return packed

    def _encode_fast(self, comps, n: int) -> Optional[np.ndarray]:
        """Radix-LUT encode: pack each key tuple into a small int64 with
        FIXED per-component radices (stable across batches, unlike
        `_pack`'s per-batch ranges) and look ids up in a dense table —
        one gather per batch instead of a sort.  Returns None —
        permanently disabling the path — when the key space has
        negatives or would need a LUT past _LUT_MAX."""
        maxs = []
        for c in comps:
            if c is None:
                maxs.append(0)
                continue
            if c.dtype.kind == "b":
                maxs.append(1)
                continue
            lo, hi = int(c.min()), int(c.max())
            if lo < 0:
                self._fast = False
                return None
            maxs.append(hi)
        if self._radix is None or any(
            mx >= r for mx, r in zip(maxs, self._radix)
        ):
            # (re)choose radices: next power of two above the observed
            # max, doubled for growth headroom (string dictionaries keep
            # appending codes); rebuild the LUT from the known groups
            radix = []
            for k, mx in enumerate(maxs):
                seen = mx
                if len(self._arr):
                    seen = max(seen, int(self._arr[:, k].max()))
                if seen == 0:
                    radix.append(1)
                    continue
                r = 1
                while r <= seen:
                    r <<= 1
                radix.append(r * 2)
            total = 1
            for r in radix:
                total *= r
                if total > self._LUT_MAX:
                    self._fast = False
                    return None
            self._radix = radix
            self._lut = np.full(total, -1, dtype=np.int32)
            if len(self._arr):
                self._lut[self._pack_rows(self._arr)] = np.arange(
                    len(self._arr), dtype=np.int32
                )
        packed = self._pack_comps(comps, n)
        ids = self._lut[packed]
        if (ids < 0).any():
            new_packed = np.unique(packed[ids < 0])
            self._lut[new_packed] = np.arange(
                self.num_groups, self.num_groups + len(new_packed), dtype=np.int32
            )
            self._arr = np.concatenate([self._arr, self._unpack_fixed(new_packed)])
            ids = self._lut[packed]
        return ids.astype(np.int32, copy=False)

    def _pack_comps(self, comps, n: int) -> np.ndarray:
        """Horner pack of per-component arrays (None = zeros) with the
        fixed radices; int64 throughout (ranges proven < _LUT_MAX)."""
        packed = np.zeros(n, dtype=np.int64)
        for c, r in zip(comps, self._radix):
            if r == 1:
                continue  # radix 1 => component is globally all-zero
            packed *= np.int64(r)
            if c is not None:
                if c.dtype != np.int64:
                    c = c.astype(np.int64)
                packed += c
        return packed

    def _pack_rows(self, rows2d: np.ndarray) -> np.ndarray:
        packed = np.zeros(rows2d.shape[0], dtype=np.int64)
        for k, r in enumerate(self._radix):
            packed = packed * np.int64(r) + rows2d[:, k]
        return packed

    def _unpack_fixed(self, packed: np.ndarray) -> np.ndarray:
        out = np.empty((len(packed), len(self._radix)), dtype=np.int64)
        rest = packed.copy()
        for k in range(len(self._radix) - 1, -1, -1):
            out[:, k] = rest % self._radix[k]
            rest //= self._radix[k]
        return out

    def _rebuild_sorted(self):
        """Reconstruct the general path's sorted row view from `_arr`
        after the fast path retires (its inserts never ran)."""
        view = _row_bytes_view(self._arr)
        order = np.argsort(view, kind="stable")
        self._sorted_rows = view[order]
        self._sorted_ids = order.astype(np.int64)

    def key_column(self, k: int):
        """(values, validity) of key position k across all groups, in
        group-id order; validity None when no group has a NULL key."""
        vals = self._arr[:, 2 * k].copy()
        isnull = self._arr[:, 2 * k + 1] != 0
        return vals, (None if not isnull.any() else ~isnull)


class _Slot:
    """One deduplicated accumulator column.

    kind: "sum" (also serves AVG), "cnt" (non-null count of one arg),
    "min"/"max", "smin"/"smax" (Utf8 via dictionary ranks).
    """

    __slots__ = ("kind", "arg", "fn", "acc_dtype", "arg_index")

    def __init__(self, kind, arg, fn, acc_dtype, arg_index=None):
        self.kind = kind
        self.arg = arg
        self.fn = fn
        self.acc_dtype = acc_dtype
        self.arg_index = arg_index  # column index for string slots

    @property
    def is_string(self) -> bool:
        return self.kind in ("smin", "smax")


class AggregateSpec:
    """One aggregate function, resolved to its accumulator slots."""

    def __init__(self, expr: AggregateFunction, input_schema: Schema):
        self.name = expr.name.lower()
        if self.name not in ("sum", "count", "min", "max", "avg"):
            raise NotSupportedError(f"unknown aggregate {expr.name!r}")
        if len(expr.args) != 1:
            raise ExecutionError(f"{expr.name} takes one argument")
        self.arg = expr.args[0]
        self.return_type = expr.return_type
        self.count_star = self.name == "count" and expr.count_star
        self.arg_type = self.arg.get_type(input_schema)
        # MIN/MAX over Utf8: the accumulator is the best dictionary
        # *code* per group; comparison rides per-version rank tables
        # (codes are append-ordered, ranks are lexicographic)
        self.is_string = self.arg_type == DataType.UTF8 and self.name in ("min", "max")
        if self.is_string and not isinstance(self.arg, Column):
            raise NotSupportedError(
                f"{expr.name} over a computed Utf8 expression is not supported"
            )
        if self.name in ("sum", "avg") and self.arg_type == DataType.UTF8:
            raise NotSupportedError(f"{expr.name} over Utf8 is not supported")
        # slot references, filled by AggregateRelation._build_slots
        self.sum_slot: Optional[int] = None
        self.cnt_slot: Optional[int] = None  # None => per-group row count
        self.minmax_slot: Optional[int] = None

    @property
    def sum_dtype(self) -> np.dtype:
        npd = self.arg_type.np_dtype
        if self.arg_type.is_signed_integer:
            return np.dtype(np.int64)
        if self.arg_type.is_unsigned_integer:
            return np.dtype(np.uint64)
        return npd


def _min_identity(dtype: np.dtype):
    if dtype.kind == "f":
        return np.asarray(np.inf, dtype)
    if dtype.kind in "iu":
        return np.asarray(np.iinfo(dtype).max, dtype)
    if dtype.kind == "b":
        return np.asarray(True, dtype)
    raise ExecutionError(f"MIN unsupported for {dtype}")


def _max_identity(dtype: np.dtype):
    if dtype.kind == "f":
        return np.asarray(-np.inf, dtype)
    if dtype.kind in "iu":
        return np.asarray(np.iinfo(dtype).min, dtype)
    if dtype.kind == "b":
        return np.asarray(False, dtype)
    raise ExecutionError(f"MAX unsupported for {dtype}")


# Unsigned accumulators: the grouped reduce takes no unsigned dtype, so
# a slot holds a signed image that orders as the unsigned values do.
# UInt8 to UInt32 widen by value; UInt64 is an int64 bit view whose
# MIN/MAX run on the sign-flipped image (`_flips`) and whose SUM wraps
# mod 2^64 bit for bit as the JAX package's uint64 sum does.
_IMAGE_DTYPE = {
    np.dtype(np.uint8): torch.int16,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64,
}


def _torch_acc_dtype(np_dtype: np.dtype) -> torch.dtype:
    img = _IMAGE_DTYPE.get(np.dtype(np_dtype))
    if img is not None:
        return img
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _flips(sl) -> bool:
    """True for a UInt64 MIN/MAX slot: it reduces x ^ 2^63."""
    return sl.kind in ("min", "max") and sl.acc_dtype == np.uint64


def _host_acc(sl, acc: np.ndarray) -> np.ndarray:
    """A pulled accumulator back in the slot's numpy dtype (the JAX
    package's), so identities and outputs compare as they do there."""
    if _flips(sl):
        acc = acc ^ np.int64(-(1 << 63))
    return host_array(acc, sl.acc_dtype)


class _AggregateCore:
    """The shareable part of an aggregation: specs, slots (with their
    compiled argument closures) and the predicate closure.  Cached
    process-wide by plan fingerprint (exec/kernels.py), so a fresh
    operator tree for an identical GROUP BY reuses the built core."""

    def __init__(self, in_schema, group_expr, aggr_expr, predicate, functions,
                 param_slots=None, mega_key=None):
        for g in group_expr:
            if not isinstance(g, Column):
                raise NotSupportedError(f"GROUP BY supports column references, got {g!r}")
            if in_schema.field(g.index).data_type.np_dtype.kind == "O":
                raise NotSupportedError("struct columns cannot be GROUP BY keys")
        self.key_cols = [g.index for g in group_expr]
        self.specs = []
        for a in aggr_expr:
            if not isinstance(a, AggregateFunction):
                raise ExecutionError(f"non-aggregate expression {a!r} in aggr_expr")
            self.specs.append(AggregateSpec(a, in_schema))

        compiler = ExprCompiler(in_schema, functions, param_slots)
        self._pred_fn = compiler.compile(predicate) if predicate is not None else None
        self.slots = self._build_slots(compiler)
        self.aux_specs = compiler.aux_specs
        # ship only the columns the kernel reads (group keys travel as
        # dense ids); Env's col_map translates schema indices to subset
        # positions
        used: set[int] = set()
        if predicate is not None:
            predicate.collect_columns(used)
        for a in aggr_expr:
            a.collect_columns(used)
        self.used_cols = sorted(used)
        self.col_map = {c: i for i, c in enumerate(self.used_cols)}
        self.acc_dtypes = [_torch_acc_dtype(sl.acc_dtype) for sl in self.slots]
        # the runtime parameters each slot's argument reads, and the
        # signature cores share when they differ at most in their
        # predicate's string literals (the serving megabatch's key)
        from datafusion_tpu_torch.exec.kernels import param_slots_of

        self.slot_params = [param_slots_of(sl.arg, param_slots or {}) for sl in self.slots]
        self.mega_key = mega_key

    @staticmethod
    def param_exprs(predicate, aggr_expr):
        """Exprs compiled into the core, in slot order."""
        return ([] if predicate is None else [predicate]) + list(aggr_expr)

    @staticmethod
    def build(in_schema, group_expr, aggr_expr, predicate, functions):
        from datafusion_tpu_torch.exec.kernels import (
            cached_kernel,
            functions_fingerprint,
            parameterize_exprs,
            schema_fingerprint,
            wildcard_strings,
        )

        elig = _AggregateCore.param_exprs(predicate, aggr_expr)
        fps, slot_by_id, _ = parameterize_exprs(elig)
        n_pred = 0 if predicate is None else 1
        key = (
            "aggregate",
            schema_fingerprint(in_schema),
            tuple(group_expr),
            fps[n_pred:],
            fps[0] if n_pred else None,
            functions_fingerprint(functions),
        )
        mega_key = key[:4] + (wildcard_strings(key[4]),) + key[5:]
        return cached_kernel(
            key,
            lambda: _AggregateCore(
                in_schema, group_expr, aggr_expr, predicate, functions,
                slot_by_id, mega_key,
            ),
        )

    def _build_slots(self, compiler: ExprCompiler) -> list[_Slot]:
        """Deduplicate aggregates into accumulator slots.  SUM(x) and
        AVG(x) share one sum slot; their validity counts (and any
        COUNT(x)) share one cnt slot per distinct argument; COUNT(*)
        rides the per-group row count (slot None).  A cnt slot whose
        argument carries no validity aliases the row count (see
        _kernel_update)."""
        slots: list[_Slot] = []
        index: dict[tuple, int] = {}

        def get(kind, arg, acc_dtype, arg_index=None):
            key = (kind, arg)
            hit = index.get(key)
            if hit is not None:
                return hit
            index[key] = len(slots)
            slots.append(_Slot(kind, arg, compiler.compile(arg), acc_dtype, arg_index))
            return index[key]

        for s in self.specs:
            if s.is_string:
                kind = "smin" if s.name == "min" else "smax"
                s.minmax_slot = get(kind, s.arg, np.dtype(np.int32), s.arg.index)
            elif s.name in ("sum", "avg"):
                s.sum_slot = get("sum", s.arg, s.sum_dtype)
                s.cnt_slot = get("cnt", s.arg, np.dtype(np.int64))
            elif s.name == "count":
                # COUNT(*) counts rows; COUNT(x) counts non-null x
                s.cnt_slot = None if s.count_star else get(
                    "cnt", s.arg, np.dtype(np.int64)
                )
            else:
                s.minmax_slot = get(
                    s.name, s.arg, np.dtype(s.arg_type.np_dtype)
                )
        return slots

    # -- accumulator state: (counts, tuple(per-slot accumulators)) --
    def _slot_identity(self, sl: _Slot):
        if sl.kind == "smin" or sl.kind == "smax":
            return np.asarray(-1, np.int32)
        if sl.kind in ("sum", "cnt"):
            return np.asarray(0, sl.acc_dtype)
        if sl.kind == "min":
            return _min_identity(sl.acc_dtype)
        return _max_identity(sl.acc_dtype)

    def _device_identity(self, sl: _Slot):
        """The slot's identity as its device accumulator holds it."""
        v = self._slot_identity(sl).item()
        if _flips(sl):
            v = (v ^ (1 << 63)) - (1 << 64 if v < 1 << 63 else 0)
        return v

    def _init_state(self, capacity: int, device: torch.device):
        accs = tuple(
            torch.full((capacity,), self._device_identity(sl), dtype=dt,
                       device=device)
            for sl, dt in zip(self.slots, self.acc_dtypes)
        )
        return torch.zeros(capacity, dtype=torch.int64, device=device), accs

    def _grow_state(self, state, new_capacity: int):
        """Dense group ids are stable: growth is identity padding."""
        counts, accs = state
        pad = new_capacity - counts.shape[0]

        def grow(a, fill):
            return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                            device=a.device)])

        new_accs = tuple(
            grow(acc, self._device_identity(sl))
            for sl, acc in zip(self.slots, accs)
        )
        return grow(counts, 0), new_accs

    def fused_group(self, entries, state, aux, str_aux, params):
        """Fold a batch group into the state in one pass (the JAX core's
        `_fused_group`): `multi_fused_group` for this one query.
        `entries` are per-batch (cols, valids, num_rows, mask|None, ids)
        with one `exec/fused.entry_signature`; `aux` and `str_aux` are
        the group's shared tables.

        The entries concatenate along rows: every column, validity and
        id, and each entry's live mask (`arange(capacity) < num_rows`,
        ANDed with its own mask).  The predicate and the slot arguments
        then evaluate once over the group, and the slots take the route
        of the state's capacity G: one grouped-reduce launch per slot
        for G <= `agg_max_groups()`, else one sort-merge combine (one
        radix sort over G + the group's rows, one host read).  A group
        of one entry is the per-batch update: nothing concatenates."""
        return self.multi_fused_group(entries, [state], str_aux,
                                      [(self._pred_fn, aux, params, None)])[0]

    def _group_rows(self, entries, device):
        """A batch group's (cols, valids, live, ids): its entries
        concatenated along rows, each with its live mask; one entry is
        taken as it is."""
        if len(entries) == 1:
            cols, valids, num_rows, base_mask, ids = entries[0]
            return cols, valids, self._live_rows(cols, num_rows, base_mask, ids, device), ids
        cols = tuple(torch.cat(c) for c in zip(*(e[0] for e in entries)))
        valids = tuple(None if v[0] is None else torch.cat(v)
                       for v in zip(*(e[1] for e in entries)))
        live = torch.cat([self._live_rows(c, n, m, i, device) for c, _, n, m, i in entries])
        return LEDGER.adopt((cols, valids, live, torch.cat([e[4] for e in entries])), "fold")

    @staticmethod
    def _masked(pred_fn, env, live):
        """`live` ANDed with the predicate (a NULL drops the row)."""
        if pred_fn is None:
            return live
        capacity = live.shape[0]
        pv, pvalid = pred_fn(env)
        pv = pv.expand(capacity)
        if pvalid is not None:
            pv = pv & pvalid.expand(capacity)
        return live & pv

    def multi_fused_group(self, entries, states, str_aux, members):
        """Fold one batch group into N queries' states at once: the
        serving megabatch (the JAX core's `_multi_fused_group`).
        `members` holds one (pred_fn, aux, params, values) per query:
        its predicate closure (its own core's: cores of one `mega_key`
        differ at most in the strings a predicate compares against),
        its aux tables, its runtime parameters as tensors and as numpy
        values (read only when there are several queries).  The entries
        concatenate once; each query's predicate gives its live mask
        over the shared ids.  Up to `agg_max_groups()` every slot is one
        launch of the grouped reduce's query axis for all N queries
        (`_kernel_update`); above it each query's sort-merge update runs
        in turn.  Each query's new state is bit-identical to its own
        `fused_group` on the same entries."""
        counts0 = states[0][0]
        device = counts0.device
        cols, valids, live, ids = self._group_rows(entries, device)
        capacity = live.shape[0]
        envs = [Env(cols, valids, aux, device, self.col_map, params)
                for _, aux, params, _ in members]
        masks = [self._masked(m[0], env, live) for m, env in zip(members, envs)]
        if counts0.shape[0] <= agg_max_groups():
            return self._kernel_update(envs, capacity, masks, ids, states, str_aux,
                                       [m[3] for m in members])
        return [self._sortmerge_update(env, capacity, mask, ids, st[0], st[1], str_aux)
                for env, mask, st in zip(envs, masks, states)]

    def _slot_values(self, sl, v, valid, acc_dtype, str_aux_i, capacity):
        """One slot's per-row kernel values: a NULL row carries the
        identity (a rank sentinel for a string); rows a live mask drops
        are never read by the kernel, so they need no mask here."""
        v = v.expand(capacity)
        if valid is not None:
            valid = valid.expand(capacity)
        if sl.is_string:
            ranks, _ = str_aux_i
            cap = ranks.shape[0]
            out = torch.index_select(ranks, 0, v.to(torch.int32).clamp(0, cap - 1))
            ident = self._rank_sentinel(sl.kind)
        elif sl.kind == "sum":
            out = v if valid is None else torch.where(valid, v, 0)
            return out.to(acc_dtype).contiguous()
        elif sl.kind == "cnt":
            return valid.to(torch.int64).contiguous()
        else:
            out = v.to(acc_dtype)
            if _flips(sl):
                out = torch.bitwise_xor(out, -(1 << 63))
            ident = self._device_identity(sl)
        return (out if valid is None else torch.where(valid, out, ident)).contiguous()

    def _kernel_update(self, envs, capacity, masks, ids, states, str_aux, values):
        """Every slot through the grouped-reduce kernel (the JAX core's
        `_pallas_update`, and its `_multi_fused_group` for N queries):
        the row count and every slot not aliased to it in ONE launch of
        the kernel's query axis each, query q's rows live where
        `masks[q]` holds.  A solo query is the call with one of each.
        `values[q]` are query q's parameter values: with several
        queries, a slot's values are evaluated once per distinct tuple
        of the parameter values its argument reads (once, when it reads
        none) and shared by the queries of that tuple."""
        G = states[0][0].shape[0]
        single = len(envs) == 1
        live = masks[0] if single else torch.stack(masks)

        def red(vals, kind):
            """One launch for every query; its result per query."""
            if single:
                return (hash_agg.grouped_reduce(ids, vals, live, G, kind),)
            return hash_agg.grouped_reduce_multi(ids, vals, live, G, kind).unbind(0)

        d_counts = red(torch.ones(capacity, dtype=torch.int64, device=ids.device), "sum")
        new_counts = [st[0] + d_counts[q] for q, st in enumerate(states)]
        new_accs = [[] for _ in states]
        for i, (sl, acc_dtype) in enumerate(zip(self.slots, self.acc_dtypes)):
            by_values: dict = {}
            per_query = []
            for q, env in enumerate(envs):
                vk = () if single else tuple(
                    np.asarray(values[q][j]).tobytes() for j in self.slot_params[i])
                hit = by_values.get(vk)
                if hit is None:
                    hit = by_values[vk] = sl.fn(env)
                per_query.append(hit)
            aliased = sl.kind == "cnt" and per_query[0][1] is None
            if aliased:
                for q, st in enumerate(states):
                    new_accs[q].append(st[1][i] + d_counts[q])
                continue
            cols = {}
            for v, valid in per_query:
                if id(v) not in cols:
                    cols[id(v)] = self._slot_values(sl, v, valid, acc_dtype,
                                                    str_aux[i] if sl.is_string else None,
                                                    capacity)
            if len(cols) == 1:
                vals = next(iter(cols.values()))
            else:
                vals = torch.stack([cols[id(v)] for v, _ in per_query])
            if sl.is_string:
                kind = "min" if sl.kind == "smin" else "max"
            elif sl.kind in ("sum", "cnt"):
                kind = "sum"
            else:
                kind = sl.kind
            r = red(vals, kind)
            for q, st in enumerate(states):
                acc = st[1][i]
                if sl.is_string:
                    new_accs[q].append(self._string_combine(sl.kind, acc, r[q], str_aux[i]))
                elif kind == "sum":
                    new_accs[q].append(acc + r[q])
                elif sl.kind == "min":
                    new_accs[q].append(torch.minimum(acc, r[q]))
                else:
                    new_accs[q].append(torch.maximum(acc, r[q]))
        return [(c, tuple(a)) for c, a in zip(new_counts, new_accs)]

    @staticmethod
    def _live_rows(cols, num_rows, base_mask, ids, device):
        """One batch's live mask: its first `num_rows` rows, ANDed with
        its selection mask."""
        capacity = cols[0].shape[0] if cols else ids.shape[0]
        mask = torch.arange(capacity, dtype=torch.int32, device=device) < num_rows
        if base_mask is not None:
            mask = mask & base_mask
        return mask

    def _slot_inputs(self, env, capacity, mask):
        """(value, ok-mask) per slot, masking padding/filtered/null
        rows.  `ok is mask` when the argument has no validity — the
        sort-merge contributions use that identity to alias the row
        count."""
        out = []
        for sl in self.slots:
            v, valid = sl.fn(env)
            v = v.expand(capacity)
            if valid is None:
                ok = mask
            else:
                ok = mask & valid.expand(capacity)
            out.append((v, ok))
        return out

    # -- string MIN/MAX rank arithmetic (codes are stable across
    # batches; ranks are valid only within one dictionary version) --
    @staticmethod
    def _rank_sentinel(kind) -> int:
        """Identity element in rank space: +inf-like for smin (any real
        rank beats it under minimum), -1 for smax."""
        return 2**31 - 1 if kind == "smin" else -1

    @classmethod
    def _codes_to_ranks(cls, kind, codes, str_aux_k):
        """Best-code accumulator -> rank space (-1 = empty -> sentinel)."""
        ranks, _ = str_aux_k
        cap = ranks.shape[0]
        return torch.where(
            codes >= 0,
            torch.index_select(ranks, 0, codes.clamp(0, cap - 1)),
            cls._rank_sentinel(kind),
        )

    @classmethod
    def _ranks_to_codes(cls, kind, best, str_aux_k):
        """Winning rank -> stable code (-1 when the group is empty)."""
        _, order = str_aux_k
        cap = order.shape[0]
        alive = best != cls._rank_sentinel(kind)
        return torch.where(
            alive, torch.index_select(order, 0, best.clamp(0, cap - 1)), -1
        ).to(torch.int32)

    @classmethod
    def _string_combine(cls, kind, acc, batch_best_rank, str_aux_k):
        """Merge a per-group best-rank candidate into a best-code
        accumulator."""
        old_rank = cls._codes_to_ranks(kind, acc, str_aux_k)
        if kind == "smin":
            best = torch.minimum(batch_best_rank, old_rank)
        else:
            best = torch.maximum(batch_best_rank, old_rank)
        return cls._ranks_to_codes(kind, best, str_aux_k)

    # -- the sort-merge route, for capacities above agg_max_groups() --
    @staticmethod
    def _seg_scan(vals, start, op, span=None):
        """Segmented inclusive scan (the JAX core's `_seg_scan`, an
        `associative_scan`): `start` marks segment heads, and each row
        ends holding `op` ("add", "min" or "max") over its segment up to
        itself, so a segment's last row holds its reduction.  `vals` is
        (n,) or (n, k), k columns scanned together.

        Hillis-Steele doubling as torch ops: the step of distance d
        combines row i - d into row i unless a head lies between them.
        Which rows combine is fixed by n and the heads, so f64 results
        are bit-identical from run to run (no atomics).  `span`, at
        least the longest segment, stops the doubling once every row
        has seen its head; the steps it skips would change nothing."""
        fn = _SCAN_OPS[op]
        flags = start
        d = 1
        while d < (vals.shape[0] if span is None else span):
            f = flags[d:] if vals.dim() == 1 else flags[d:, None]
            vals = torch.cat([vals[:d], torch.where(f, vals[d:], fn(vals[:-d], vals[d:]))])
            flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
            d *= 2
        return vals

    def _sm_contribs(self, env, capacity, mask, ids, str_aux, num_groups):
        """Per-batch contribution columns of the sort-merge combine (the
        JAX core's `_sm_contribs`): (batch keys, [row count, one per
        non-aliased slot...], payload_of).  A dead row keys as
        `num_groups`: it still sorts after every live id, and keeps the
        keys within the digits the state's ids need, so the radix sort
        runs no pass for the high digits (int64.max, the JAX package's
        sentinel, would make all 8 vary)."""
        inputs = self._slot_inputs(env, capacity, mask)
        batch_keys = torch.where(mask, ids.to(torch.int64), num_groups)
        contribs = [mask.to(torch.int64)]  # row count
        payload_of: dict[int, int] = {}
        for i, (sl, (v, ok), acc_dtype) in enumerate(
                zip(self.slots, inputs, self.acc_dtypes)):
            if sl.kind == "cnt" and ok is mask:
                continue  # aliases the row count payload
            if sl.is_string:
                # lexicographic ranks under the batch's dictionary version
                ranks, _ = str_aux[i]
                cap = ranks.shape[0]
                r = torch.index_select(ranks, 0, v.to(torch.int32).clamp(0, cap - 1))
                contrib = torch.where(ok, r, self._rank_sentinel(sl.kind))
            elif sl.kind == "sum":
                contrib = torch.where(ok, v, 0).to(acc_dtype)
            elif sl.kind == "cnt":
                contrib = ok.to(torch.int64)
            else:
                img = v.to(acc_dtype)
                if _flips(sl):
                    img = torch.bitwise_xor(img, -(1 << 63))
                contrib = torch.where(ok, img, self._device_identity(sl))
            payload_of[i] = len(contribs)
            contribs.append(contrib)
        return batch_keys, contribs, payload_of

    def _sortmerge_update(self, env, capacity, mask, ids, counts, accs,
                          str_aux=()):
        """High-cardinality route (G > agg_max_groups()): the grouped
        reduce would keep a partial per (block, group) and read the rows
        once per tile of groups, so instead every batch merges into the
        dense state by one sort (the JAX core's `_sortmerge_update`)."""
        batch_keys, contribs, payload_of = self._sm_contribs(
            env, capacity, mask, ids, str_aux, counts.shape[0]
        )
        return self._sm_combine(counts, accs, batch_keys, contribs, payload_of, str_aux)

    def _sm_combine(self, counts, accs, batch_keys, contribs, payload_of,
                    str_aux=()):
        """Merge contributions into the dense state (the JAX core's
        `_sm_combine`).

        Keys are arange(G) followed by the batch keys, and the payloads
        are in the same order, state codes turned into ranks on entry.
        One stable radix argsort (`sort_kernel.argsort_i64`) groups each
        id's rows with its state row first, so the state rows are the
        segment heads.  Every id in [0, G) appears, so `searchsorted`
        finds each group's rows without a second sort; one host read
        brings the longest segment (the scans' doubling steps) and the
        end of the live rows (dead rows key as G and are never
        gathered).  Integer sums and counts reduce exactly as cumsum
        differences; float sums, MIN and MAX by `_seg_scan`.  Payloads
        of one (op, dtype) are gathered and scanned as one (n, k)
        tensor."""
        G = counts.shape[0]
        groups = torch.arange(G, dtype=torch.int64, device=counts.device)
        keys = torch.cat([groups, batch_keys])
        perm = sort_kernel.argsort_i64(keys)
        skeys = torch.index_select(keys, 0, perm)
        left = torch.searchsorted(skeys, groups)
        right = torch.searchsorted(skeys, groups, right=True)
        span, live_end = torch.stack([(right - left).max(), right[-1]]).tolist()
        perm = perm[:live_end]
        heads = perm < G

        # payload columns: row count first, then one per non-aliased slot
        payloads = [(counts, "add")]
        for i, (sl, acc) in enumerate(zip(self.slots, accs)):
            if i not in payload_of:
                continue
            if sl.is_string:
                payloads.append((self._codes_to_ranks(sl.kind, acc, str_aux[i]),
                                 "min" if sl.kind == "smin" else "max"))
            else:
                payloads.append((acc, "add" if sl.kind in ("sum", "cnt") else sl.kind))
        by_op: dict[tuple, list[int]] = {}
        for p, (state, op) in enumerate(payloads):
            by_op.setdefault((op, state.dtype), []).append(p)
        reduced = [None] * len(payloads)
        for (op, dtype), ps in by_op.items():
            cols = torch.cat([torch.stack([payloads[p][0] for p in ps], 1),
                              torch.stack([contribs[p] for p in ps], 1)])
            svals = torch.index_select(cols, 0, perm)
            if op == "add" and not dtype.is_floating_point:
                # integer sums wrap mod 2^64 exactly, in any order
                cs = torch.cat([svals.new_zeros((1, len(ps))), torch.cumsum(svals, 0)])
                out = torch.index_select(cs, 0, right) - torch.index_select(cs, 0, left)
            else:
                out = torch.index_select(self._seg_scan(svals, heads, op, span), 0,
                                         right - 1)
            for j, p in enumerate(ps):
                reduced[p] = out[:, j]

        new_counts = reduced[0]
        new_accs = []
        for i, (sl, acc) in enumerate(zip(self.slots, accs)):
            p = payload_of.get(i)
            if p is None:  # cnt aliased to the row count
                new_accs.append(acc + (new_counts - counts))
            elif sl.is_string:
                new_accs.append(self._ranks_to_codes(sl.kind, reduced[p], str_aux[i]))
            else:
                new_accs.append(reduced[p])
        return new_counts, tuple(new_accs)


def _pull_parts(parts) -> list:
    """Tensors on the host in ONE device-to-host copy: every tensor is
    viewed as bytes and concatenated on the device first."""
    blob = to_host(torch.cat([p.contiguous().view(-1).view(torch.uint8) for p in parts]))
    host = []
    off = 0
    for p in parts:
        np_dtype = torch.empty(0, dtype=p.dtype).numpy().dtype
        nbytes = p.numel() * np_dtype.itemsize
        host.append(blob[off:off + nbytes].view(np_dtype))
        off += nbytes
    return host


class _HostState:
    """An accumulator state already pulled to the host: the live
    prefix's counts and per-slot arrays."""

    __slots__ = ("counts", "accs")

    def __init__(self, counts, accs):
        self.counts = counts
        self.accs = list(accs)


class AggregateRelation(Relation):
    """Executes [Selection +] Aggregate over a child relation; emits a
    single result batch.

    Group expressions must be column references over the child schema
    (the planner produces exactly that shape).  The core — specs,
    slots, predicate closure — is shared process-wide across relations
    with the same plan fingerprint.
    """

    def __init__(
        self,
        child: Relation,
        group_expr: list[Expr],
        aggr_expr: list[Expr],
        out_schema: Schema,
        device: torch.device,
        predicate: Optional[Expr] = None,
        functions=None,
    ):
        self.child = child
        self._schema = out_schema
        self.device = device
        self.predicate = predicate
        self.core = _AggregateCore.build(
            child.schema, list(group_expr), list(aggr_expr), predicate,
            functions,
        )
        # THIS query's literal values for the shared core's parameter
        # slots (identical fingerprints guarantee identical slot order)
        from datafusion_tpu_torch.exec.kernels import parameterize_exprs

        self._param_values = parameterize_exprs(
            _AggregateCore.param_exprs(predicate, list(aggr_expr))
        )[2]
        self.key_cols = self.core.key_cols
        self.specs = self.core.specs
        self.slots = self.core.slots
        self._aux_cache: dict = {}
        self.encoder = GroupKeyEncoder(len(self.key_cols))
        self._key_dicts: dict[int, StringDictionary] = {}
        self._str_dicts: dict[int, StringDictionary] = {}
        self._str_aux_cache: dict = {}
        # serializes the encoder's mutation: the prefetch thread and,
        # over a served table, every relation sharing its encoder
        # (`adopt_shared`) encode through it
        self._ids_lock = threading.Lock()

    def adopt_shared(self, entry: dict) -> None:
        """Take a served table's cross-query state (serve.py,
        `PinnedSource.shared_state_for`): its encoder and lock, which
        key the ids cached on the table's batches, so ids encoded and
        copied by any earlier query replay for this one, and its caches
        of aux and string-rank tables."""
        self.encoder = entry["encoder"]
        self._ids_lock = entry["lock"]
        self._aux_cache = entry["aux"]
        self._str_aux_cache = entry["str_aux"]

    def _compute_str_aux(self, batch: RecordBatch):
        """(ranks, rank->code) tensor pair per string min/max slot,
        padded to a bucketed capacity, cached per dictionary version
        (the one pinned on the batch, `batch.dict_versions`)."""
        out = []
        for k, sl in enumerate(self.slots):
            if not sl.is_string:
                out.append(None)
                continue
            d = batch.dicts[sl.arg_index]
            if d is None:
                raise ExecutionError(
                    f"column {sl.arg_index} has no dictionary for {sl.kind}"
                )
            self._str_dicts[k] = d
            version = dict_versions(batch)[sl.arg_index]
            key = (k, version)
            hit = self._str_aux_cache.get(key)
            if hit is None:
                ranks = d.sort_ranks(version).astype(np.int32)
                order = np.argsort(ranks).astype(np.int32)  # rank -> code
                cap = bucket_capacity(max(len(ranks), 1))
                pr = np.zeros(cap, np.int32)
                pr[: len(ranks)] = ranks
                po = np.zeros(cap, np.int32)
                po[: len(order)] = order
                hit = (to_device(pr, self.device), to_device(po, self.device))
                self._str_aux_cache[key] = hit
            out.append(hit)
        return tuple(out)

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        return (f"Aggregate[keys={len(self.key_cols)}, slots={len(self.slots)}"
                + (", filtered" if self.predicate is not None else "") + "]")

    @staticmethod
    def _pick_capacity(n_groups: int, current: int) -> int:
        """Accumulator capacity for `n_groups` encoded groups: the next
        power of two, never shrinking.  The JAX package jumps 4x past 64
        groups because each capacity compiles a new sort-merge kernel;
        eager torch compiles nothing per capacity, and the sort-merge
        route's work grows with G, so growth stays tight and Q1 (4
        groups) keeps a capacity of 8."""
        return max(group_capacity(max(n_groups, 1)), current)

    def accumulate(self):
        """Run the scan, returning the device accumulator state.

        Prepared batches (group ids, aux tables, device inputs) buffer
        into a chunk of up to `fuse_group_max()` batches; the capacity is
        picked once the whole chunk is encoded, so every id fits and the
        route is chosen once per chunk, and each batch group of the chunk
        (`exec/fused.iter_groups`) folds in one `fused_group` pass.  With
        DATAFUSION_TPU_FUSE=0 the chunk is one batch: one update per
        batch.  Over a CSV scan on a CUDA device the host prep runs
        ahead on the prefetch threads (`exec/prefetch.staged_pipeline`).
        A state the serving megabatch computed for this relation
        (`run_aggregate_megabatch`), or a materialized view's resident
        state (ingest/, `MaterializedView.read`), is returned without a
        scan."""
        injected = self.__dict__.pop("_injected_state", None)
        if injected is not None:
            return injected
        core = self.core
        device = self.device
        params = param_tensors(self._param_values, device)
        batches = iter_stats(self.child)
        if pipeline_enabled(device, self.child):
            batches = staged_pipeline(batches, self._stage, pull=pin_dict_versions)
        state = None
        for capacity, entries, (aux, str_aux) in self._batch_groups(batches, self._aux):
            if state is None:
                state = core._init_state(capacity, device)
            elif capacity > state[0].shape[0]:
                state = core._grow_state(state, capacity)
            with METRICS.timer("execute.aggregate"), op_timer(self):
                if len(entries) > 1:
                    METRICS.add("fused.groups")
                    METRICS.add("fused.group_batches", len(entries))
                state = device_call(core.fused_group, entries, state, aux, str_aux, params,
                                    _tag="agg.group" if len(entries) > 1 else "agg",
                                    _device=device)
            if self._op_stats is not None:
                self.stats.attrs["fused_batches"] = (
                    self.stats.attrs.get("fused_batches", 0) + len(entries))
        if state is None:
            state = core._init_state(group_capacity(1), device)
        return state

    def _batch_groups(self, batches, tables):
        """The scan as (capacity, entries, shared tables) per batch group:
        each batch's group ids, `tables(batch)` and the copies of its used
        columns buffer into a chunk of up to `fuse_group_max()` batches;
        once a chunk is encoded the capacity is picked for all of it, so
        every id fits, and the chunk splits into batch groups
        (`exec/fused.iter_groups`)."""
        chunk_max = fuse_group_max() if fusion_enabled() else 1
        capacity = 0
        chunk: list = []

        def groups():
            nonlocal capacity
            # sized from the group count recorded when the chunk's last
            # batch was encoded: the encoder itself may already be
            # batches ahead on the prefetch thread
            capacity = self._pick_capacity(chunk[-1][1], capacity)
            entries = [e for e, _, _ in chunk]
            shareds = [sh for _, _, sh in chunk]
            out = [(capacity, [entries[i] for i in idxs], shared)
                   for idxs, shared in iter_groups(entries, shareds)]
            chunk.clear()
            return out

        for batch in batches:
            for idx in self.key_cols:
                if batch.dicts[idx] is not None:
                    self._key_dicts[idx] = batch.dicts[idx]
            ids, n_groups = self._group_ids(batch)
            shared = tables(batch)
            data, validity, mask = device_inputs(
                subset_view(batch, self.core.used_cols), self.device
            )
            chunk.append(((data, validity, batch.num_rows, mask, ids), n_groups, shared))
            if len(chunk) >= chunk_max:
                yield from groups()
        if chunk:
            yield from groups()

    def _aux(self, batch: RecordBatch):
        """(aux, str_aux) of one batch: the tables the prefetch stage
        pinned on it from this relation's caches, else built here."""
        hit = batch.cache.get("staged_aux")
        if hit is not None and hit[0] is self._aux_cache and hit[1] is self._str_aux_cache:
            return hit[2]
        return self._tables(batch)

    def _tables(self, batch: RecordBatch):
        aux = tuple(compute_aux_values(self.core.aux_specs, batch, self._aux_cache,
                                       self.device))
        return aux, self._compute_str_aux(batch)

    def _stage(self, batch: RecordBatch) -> None:
        """The host prep of one batch on the prefetch thread: the
        group-id encode and its copy, the aux and string-rank tables
        (pinned on the batch under this relation's encoder, as the
        group ids are) and the used columns' copies."""
        self._group_ids(batch)
        batch.cache["staged_aux"] = (self._aux_cache, self._str_aux_cache,
                                     self._tables(batch))
        device_inputs(subset_view(batch, self.core.used_cols), self.device)

    def _group_ids(self, batch: RecordBatch):
        """Dense group ids for one batch as an int32 tensor on the
        device, and the number of groups the encoder knew right after
        encoding it.  Cached on the batch (keyed by this relation's
        encoder) so a re-scanned in-memory batch skips the encode and
        the copy when a relation with the same encoder scans it again.
        The encode runs under `_ids_lock` and counts in the
        `agg.host_encode` timer."""
        hit = batch.cache.get("group_ids")
        if hit is not None and hit[0] is self.encoder:
            return hit[1], hit[2]
        with self._ids_lock:
            return self._group_ids_locked(batch)

    def _group_ids_locked(self, batch: RecordBatch):
        hit = batch.cache.get("group_ids")
        if hit is not None and hit[0] is self.encoder:
            return hit[1], hit[2]
        if self.key_cols:
            # a key column on the device (a join's gathered payload)
            # crosses to the host for the encoder
            key_cols = [
                to_host(batch.data[idx], batch.schema.field(idx).data_type.np_dtype)
                for idx in self.key_cols
            ]
            key_valids = [
                None if batch.validity[idx] is None else to_host(batch.validity[idx])
                for idx in self.key_cols
            ]
            with METRICS.timer("agg.host_encode"):
                ids_np = self.encoder.encode(key_cols, key_valids)
        else:
            ids_np = np.zeros(batch.capacity, dtype=np.int32)
        ids = to_device(ids_np, self.device, owner="group_ids")
        n_groups = self.encoder.num_groups
        # one slot per batch: another query's encoder overwrites it, so
        # a long-lived batch holds at most one ids tensor
        batch.cache["group_ids"] = (self.encoder, ids, n_groups)
        return ids, n_groups

    @staticmethod
    def _numeric_output(s: AggregateSpec, sums, cnts, live_counts):
        """(values, validity) for a SUM/AVG/COUNT spec from its summed
        and counted per-group arrays."""
        if s.name in ("sum", "avg"):
            if s.name == "sum":
                vals = sums.astype(s.return_type.np_dtype)
            else:
                vals = (sums.astype(np.float64) / np.maximum(cnts, 1)).astype(
                    s.return_type.np_dtype
                )
            valid = cnts > 0
        else:  # count
            raw = live_counts if cnts is None else cnts
            vals = raw.astype(s.return_type.np_dtype)
            valid = None
        if valid is not None and bool(np.asarray(valid).all()):
            valid = None
        return vals, valid

    @classmethod
    def _spec_output(cls, s: AggregateSpec, slot_host, live_counts, str_dicts):
        """(values, validity, dict) for one aggregate spec from pulled
        per-slot live-group arrays."""
        if s.is_string:
            codes = slot_host[s.minmax_slot].astype(np.int32)
            valid = codes >= 0
            return (
                np.where(valid, codes, 0).astype(np.int32),
                None if bool(valid.all()) else valid,
                str_dicts.get(s.minmax_slot),
            )
        if s.name in ("sum", "avg", "count"):
            sums = None if s.sum_slot is None else slot_host[s.sum_slot]
            cnts = None if s.cnt_slot is None else slot_host[s.cnt_slot]
            vals, valid = cls._numeric_output(s, sums, cnts, live_counts)
            return vals, valid, None
        if s.name == "min":
            raw = slot_host[s.minmax_slot]
            vals = raw.astype(s.return_type.np_dtype)
            valid = raw != _min_identity(np.dtype(raw.dtype))
        else:
            raw = slot_host[s.minmax_slot]
            vals = raw.astype(s.return_type.np_dtype)
            valid = raw != _max_identity(np.dtype(raw.dtype))
        if bool(np.asarray(valid).all()):
            valid = None
        return vals, valid, None

    def _key_outputs(self, live):
        """Group-key output columns for the live groups, in key order."""
        out_cols, out_valid, out_dicts = [], [], []
        in_schema = self.child.schema
        for k, idx in enumerate(self.key_cols):
            keys, kvalid = self.encoder.key_column(k)
            keys = keys[live]
            f = in_schema.field(idx)
            npd = np.dtype(f.data_type.np_dtype)
            if npd.kind == "f":
                # float keys were bit-cast into the encoder; bit-cast back
                out_cols.append(keys.view(np.float64).astype(npd))
            else:
                out_cols.append(keys.astype(npd))
            out_valid.append(None if kvalid is None else kvalid[live])
            out_dicts.append(self._key_dicts.get(idx))
        return out_cols, out_valid, out_dicts

    def _state_cut(self, state) -> int:
        """Rows of the state that can hold a group: its live prefix."""
        n_groups = self.encoder.num_groups if self.key_cols else 1
        return min(group_capacity(n_groups), state[0].shape[0])

    def _pull_state(self, state):
        """The state's live prefix on the host, in ONE device-to-host
        copy (`_pull_parts`).  Returns (counts, per-slot host arrays); a
        state the serving megabatch already pulled passes through."""
        if isinstance(state, _HostState):
            return state.counts, state.accs
        counts, accs = state
        cut = self._state_cut(state)
        host = _pull_parts([counts[:cut]] + [a[:cut] for a in accs])
        return host[0], host[1:]

    def finalize(self, state) -> RecordBatch:
        counts, accs = self._pull_state(state)
        accs = [_host_acc(sl, a) for sl, a in zip(self.slots, accs)]
        n_groups = self.encoder.num_groups if self.key_cols else 1
        if self.key_cols:
            live = np.nonzero(counts[:n_groups] > 0)[0]
        else:
            # global aggregate: always exactly one output row
            live = np.array([0], dtype=np.int64)

        out_cols, out_valid, out_dicts = self._key_outputs(live)
        slot_host = [a[live] for a in accs]
        live_counts = counts[live]
        for s in self.specs:
            vals, valid, d = self._spec_output(
                s, slot_host, live_counts, self._str_dicts
            )
            out_cols.append(vals)
            out_valid.append(valid)
            out_dicts.append(d)

        return make_host_batch(self._schema, out_cols, out_valid, out_dicts)

    def batches(self) -> Iterator[RecordBatch]:
        yield self.finalize(self.accumulate())


def run_aggregate_megabatch(rels: list) -> None:
    """ONE scan, N aggregate queries: the serving megabatch's aggregate
    lane (the loop of the JAX package's `Server._run_megabatch`).

    Preconditions (serve.py `_mega_key`): the relations' cores share one
    `mega_key`, the relations scan one table and share one encoder (a
    served table's, `AggregateRelation.adopt_shared`).  The scan is the
    leader's `accumulate`, with the same chunks, capacities and batch
    groups: each group folds into every query's state in one
    `multi_fused_group` (one query-axis launch per slot).  A group's
    boundaries follow every query's aux tables together; cores of one
    `mega_key` build theirs over the same columns, so the boundaries
    are each query's own.  Each relation gets its state as
    `_injected_state`, which its `accumulate` returns, and the leader's
    key dictionaries.  Every query's state is pulled to the host in one
    copy, so its finalize is host work only."""
    leader = rels[0]
    core = leader.core
    device = leader.device
    members = [(r.core._pred_fn, param_tensors(r._param_values, device), r._param_values)
               for r in rels]

    def tables(batch):
        """Every query's aux tables (built once per cache: queries of one
        core share theirs) and the string-rank tables, which depend on
        the slots alone."""
        by_cache: dict = {}
        for r in rels:
            if id(r._aux_cache) not in by_cache:
                by_cache[id(r._aux_cache)] = r._aux(batch)
        per = [by_cache[id(r._aux_cache)] for r in rels]
        return tuple(aux for aux, _ in per), per[0][1]

    states = None
    for capacity, entries, (auxes, str_aux) in leader._batch_groups(iter_stats(leader.child),
                                                                     tables):
        if states is None:
            states = [r.core._init_state(capacity, device) for r in rels]
        elif capacity > states[0][0].shape[0]:
            states = [r.core._grow_state(st, capacity) for r, st in zip(rels, states)]
        with METRICS.timer("execute.aggregate"), op_timer(leader):
            states = device_call(
                core.multi_fused_group, entries, states, str_aux,
                [(pred, aux, params, values) for (pred, params, values), aux in zip(members, auxes)],
                _tag="serve.megabatch", _device=device)
        METRICS.add("serve.megabatch_launches")
        METRICS.add("serve.megabatch_batches", len(entries))
    if states is None:
        states = [r.core._init_state(group_capacity(1), device) for r in rels]
    METRICS.add("serve.megabatch_queries", len(rels))
    # every query's live prefix crosses to the host in ONE copy, so each
    # query's finalize is host work only
    cuts = [r._state_cut(st) for r, st in zip(rels, states)]
    pulled = _pull_parts([p for (counts, accs), cut in zip(states, cuts)
                          for p in [counts[:cut], *(a[:cut] for a in accs)]])
    per = 1 + len(core.slots)
    for i, r in enumerate(rels):
        if r is not leader:
            r._key_dicts.update(leader._key_dicts)
            r._str_dicts.update(leader._str_dicts)
        host = pulled[i * per:(i + 1) * per]
        r._injected_state = _HostState(host[0], host[1:])
