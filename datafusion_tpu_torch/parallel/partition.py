"""Partitioned query execution over a shard mesh (the JAX package's
`parallel/partition.py`).

- a table is a list of partition files (`PartitionedDataSource`);
  partitions assign round-robin to the mesh's shard slots
  (parallel/mesh.py); partition readers share string dictionaries, so
  a code means the same string on every shard;
- each round, every shard takes its next batch, and the round's update
  is a partial aggregate per device;
- the partials combine along the device axis: SUM and COUNT add, MIN and
  MAX meet, Utf8 MIN/MAX meet in lexicographic-rank space.

**The per-shard update on the H100.**  The JAX package runs it as a
`shard_map` of its single-device kernel, one device per shard, and
combines with `psum` / `pmin` / `pmax`.  Here the slots that share a
device accumulate into ONE state of G groups: a round's batches on
that device (in shard order) fold in one `_AggregateCore.fused_group`
pass with their dense ids as they are, their rows concatenated.  That
pass takes the aggregate's normal route by G, the window a single
context has: up to `agg_window()` (`agg_max_groups()`, 8192, unless the
cost store learned another) each aggregate column is ONE launch of the
grouped-reduce kernel for the whole round; above it the sort-merge
route (one radix-sort launch a round).  Slots on different CUDA devices
update on their own devices, and the device states combine on the
first slot's device in device order (a fixed order: the f64 bits repeat
run to run); on one device there is nothing to combine.

**Warm rounds.**  A round's prepared inputs (each shard's device
columns and group ids, the aux and string-rank tables) are cached per
round after the round has been seen twice (second-chance admission:
file scans, whose batch objects are new every run, cache nothing);
consecutive warm rounds of one shape fold into ONE pass
(``mesh.fused_round_launches``, ``mesh.fused_rounds``), the JAX
package's multi-round fold.  ``DATAFUSION_TPU_FUSE=0`` dispatches every
round alone.  As in the batch-group fold (exec/fused.py), a folded pass
sums a group's rows of every round at once, where the JAX package loops
its per-round update: the f64 sums associate otherwise than round by
round (within rtol 1e-9), and repeat their bits from one folded run to
the next.

Non-aggregate plans: a filter/project over a partitioned table runs
one `_PipelineCore.run_group` pass per round per device
(`PartitionedPipelineRelation`); other shapes scan the partitions
serially.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import ExecutionError, PlanError
from datafusion_tpu_torch.exec.aggregate import AggregateRelation, group_capacity
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    device_inputs,
    dict_versions,
    param_tensors,
    subset_view,
)
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.exec.datasource import CsvDataSource, DataSource, ParquetDataSource
from datafusion_tpu_torch.exec.expression import compute_aux_values
from datafusion_tpu_torch.exec.fused import (
    entry_signature,
    fuse_group_max,
    fusion_enabled,
    shared_signature,
)
from datafusion_tpu_torch.exec.relation import DataSourceRelation, PipelineRelation, Relation
from datafusion_tpu_torch.obs.stats import iter_stats, op_timer
from datafusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from datafusion_tpu_torch.parallel.physical import PlanFragment
from datafusion_tpu_torch.plan.expr import Expr
from datafusion_tpu_torch.plan.logical import Aggregate, LogicalPlan, Selection, TableScan
from datafusion_tpu_torch.utils.deadline import Deadline, current_deadline, deadline_scope
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call


def _share_dictionaries(partitions: Sequence[DataSource]) -> None:
    """Make string codes globally consistent across partitions.

    File-backed sources share one set of reader dictionaries (codes are
    assigned lazily, append-only, host-side).  In-memory sources already
    hold encoded batches, so their codes are *remapped* into partition
    0's dictionaries via `StringDictionary.merge_codes`, and the device
    copies and ids cached on a remapped batch are dropped.  Anything
    else is rejected: silently inconsistent codes would mis-group rows.
    """
    if len(partitions) <= 1:
        return
    readers = [getattr(p, "_reader", None) for p in partitions]
    if all(r is not None for r in readers):
        shared = readers[0].dicts
        for r in readers[1:]:
            if len(r.dicts) != len(shared):
                raise ExecutionError("partition schemas disagree")
            r.dicts = shared
        return
    if all(hasattr(p, "_batches") for p in partitions):
        shared_dicts: dict[int, object] = {}
        for b in partitions[0]._batches:
            for i, d in enumerate(b.dicts):
                if d is not None:
                    shared_dicts[i] = d
        for p in partitions[1:]:
            for b in p._batches:
                for i, d in enumerate(b.dicts):
                    if d is None:
                        continue
                    shared = shared_dicts.setdefault(i, d)
                    if shared is d:
                        continue
                    b.data[i] = shared.merge_codes(np.asarray(b.data[i]), d.values)
                    b.dicts[i] = shared
                    # device copies and ids derived from the old codes
                    b.cache.clear()
        return
    raise ExecutionError(
        "cannot make string dictionaries consistent across mixed partition "
        f"source types {sorted({type(p).__name__ for p in partitions})}"
    )


class PartitionedDataSource(DataSource):
    """A table stored as N partitions with a common schema."""

    def __init__(self, partitions: Sequence[DataSource]):
        if not partitions:
            raise ExecutionError("PartitionedDataSource needs >= 1 partition")
        s0 = partitions[0].schema
        for p in partitions[1:]:
            if p.schema.names() != s0.names():
                raise ExecutionError("partition schemas disagree")
        self.partitions = list(partitions)
        _share_dictionaries(self.partitions)

    @property
    def schema(self) -> Schema:
        return self.partitions[0].schema

    def batches(self) -> Iterator[RecordBatch]:
        # serial union scan (the non-aggregate fallback path)
        for p in self.partitions:
            yield from p.batches()

    def estimated_bytes(self) -> int:
        return sum(p.estimated_bytes() for p in self.partitions)

    def with_projection(self, projection: Sequence[int]) -> "PartitionedDataSource":
        return PartitionedDataSource([p.with_projection(projection) for p in self.partitions])

    def to_meta(self) -> dict:
        return {"Partitioned": [p.to_meta() for p in self.partitions]}


def _round_robin(parts: Sequence, n_shards: int) -> list[list]:
    assignment: list[list] = [[] for _ in range(n_shards)]
    for i, p in enumerate(parts):
        assignment[i % n_shards].append(p)
    return assignment


class _ShardFeed:
    """Chained batch iterator over one shard's assigned partitions."""

    def __init__(self, relations: list[Relation]):
        self._iters = [iter(iter_stats(r)) for r in relations]
        self._pos = 0

    def next_batch(self) -> Optional[RecordBatch]:
        while self._pos < len(self._iters):
            batch = next(self._iters[self._pos], None)
            if batch is not None:
                return batch
            self._pos += 1
        return None


def _device_groups(mesh: Mesh) -> list[tuple[torch.device, list[int]]]:
    """The mesh's slots grouped by device, in order of first slot: each
    (device, [shard indices on it, ascending])."""
    groups: dict[str, tuple[torch.device, list[int]]] = {}
    for s, d in enumerate(mesh.devices):
        groups.setdefault(str(d), (d, []))[1].append(s)
    return list(groups.values())


def _round_entries(batches, used_cols, device):
    """Device inputs of one device's batches in a round, as fold
    entries (cols, valids, num_rows, mask): a used column with validity
    in any of them carries a validity plane in all of them (all-valid
    where a batch has none), so the entries concatenate."""
    views = [device_inputs(subset_view(b, used_cols), device) for b in batches]
    n_cols = len(used_cols)
    has_valid = [any(v[1][j] is not None for v in views) for j in range(n_cols)]
    entries = []
    for b, (data, validity, mask) in zip(batches, views):
        if any(has_valid[j] and validity[j] is None for j in range(n_cols)):
            cap = data[0].shape[0] if data else b.capacity
            validity = tuple(
                torch.ones(cap, dtype=torch.bool, device=device)
                if has_valid[j] and validity[j] is None else validity[j]
                for j in range(n_cols)
            )
        entries.append((data, validity, b.num_rows, mask))
    return entries


class PartitionedPipelineRelation(PipelineRelation):
    """[Selection +] [Projection] over partitioned input on a mesh: each
    round, every shard's next batch goes through ONE `run_group` pass
    per device (the batches concatenated along rows), and each input
    batch gets its own output batch, in shard order.  Column
    passthroughs stay the input arrays (exact)."""

    def __init__(self, children: list[Relation], predicate: Optional[Expr],
                 projections: Optional[list[Expr]], out_schema: Schema, mesh: Mesh,
                 functions=None, function_metas=None):
        super().__init__(children[0], predicate, projections, out_schema,
                         mesh.devices[0], functions=functions,
                         function_metas=function_metas)
        if self.core.host_proj:
            raise PlanError("host-evaluated projections take the serial union scan")
        self.children = children
        self.mesh = mesh
        self.n_shards = mesh.size
        self._aux_caches: dict[str, dict] = {}

    def op_label(self) -> str:
        return f"MeshPipeline[shards={self.n_shards}, partitions={len(self.children)}]"

    def op_children(self) -> list[Relation]:
        return list(self.children)

    def batches(self) -> Iterator[RecordBatch]:
        core = self.core
        feeds = [_ShardFeed(rels) for rels in _round_robin(self.children, self.n_shards)]
        groups = _device_groups(self.mesh)
        params = {str(d): param_tensors(self._params, d) for d, _ in groups}
        # the ambient per-query deadline bounds every round
        deadline = current_deadline()
        while True:
            if deadline is not None:
                deadline.check("partitioned pipeline round")
            round_batches = [f.next_batch() for f in feeds]
            if all(b is None for b in round_batches):
                return
            if not core.needs_kernel:
                for b in round_batches:
                    if b is not None:
                        yield self._output(b, [], [], b.mask)
                continue
            live = [b for b in round_batches if b is not None]
            outs: dict[int, tuple] = {}
            for dev, shards in groups:
                batches = [(s, round_batches[s]) for s in shards
                           if round_batches[s] is not None]
                if not batches:
                    continue
                cache = self._aux_caches.setdefault(str(dev), {})
                aux = tuple(compute_aux_values(core.aux_specs, live[-1], cache, dev))
                entries = _round_entries([b for _, b in batches], core.used_cols, dev)
                with METRICS.timer("execute.partitioned_pipeline"), op_timer(self):
                    res = device_call(core.run_group, entries, aux, params[str(dev)], dev,
                                      _tag="mesh.pipeline", _device=dev)
                for (s, _), r in zip(batches, res):
                    outs[s] = r
            for s, b in enumerate(round_batches):
                if b is not None:
                    cols, valids, mask = outs[s]
                    yield self._output(b, cols, valids, mask)


class PartitionedAggregateRelation(AggregateRelation):
    """[Selection +] Aggregate over partitioned input on a mesh: one
    partial state a device (module docstring), combined in device order
    on the first slot's device."""

    def __init__(self, children: list[Relation], group_expr: list[Expr],
                 aggr_expr: list[Expr], out_schema: Schema, mesh: Mesh,
                 predicate: Optional[Expr] = None, functions=None):
        super().__init__(children[0], group_expr, aggr_expr, out_schema,
                         mesh.devices[0], predicate=predicate, functions=functions)
        self.children = children
        self.mesh = mesh
        self.n_shards = mesh.size
        self._groups = _device_groups(mesh)
        # warm round cache (prepared device inputs per round, FIFO) and
        # its second-chance admission: a round key must be seen twice
        self._round_cache: OrderedDict = OrderedDict()
        self._round_cache_max = 64
        self._round_seen: OrderedDict = OrderedDict()
        self._dev_aux: dict[str, tuple[dict, dict]] = {}

    def op_label(self) -> str:
        return (f"MeshAggregate[shards={self.n_shards}, "
                f"partitions={len(self.children)}, keys={len(self.key_cols)}]")

    def op_children(self) -> list[Relation]:
        return list(self.children)

    # -- one round's inputs --------------------------------------------
    def _tables_on(self, batch: RecordBatch, device: torch.device):
        """(aux, str_aux) for `batch` on `device`: the relation's own
        caches on the combine device, per-device caches elsewhere."""
        if device == self.device:
            return self._tables(batch)
        aux_cache, str_cache = self._dev_aux.setdefault(str(device), ({}, {}))
        aux = tuple(compute_aux_values(self.core.aux_specs, batch, aux_cache, device))
        str_aux = []
        for k, pair in enumerate(self._compute_str_aux(batch)):
            if pair is None:
                str_aux.append(None)
                continue
            key = (k, dict_versions(batch)[self.slots[k].arg_index])
            hit = str_cache.get(key)
            if hit is None:
                hit = str_cache[key] = tuple(t.to(device) for t in pair)
            str_aux.append(hit)
        return aux, tuple(str_aux)

    def _prepare_round(self, round_batches):
        """Per device: (device, [(shard position, entry)], aux, str_aux),
        an entry being (cols, valids, num_rows, mask, ids) with the
        shard's dense ids."""
        live = [b for b in round_batches if b is not None]
        ids = {}
        for s, b in enumerate(round_batches):
            if b is None:
                continue
            for idx in self.key_cols:
                if b.dicts[idx] is not None:
                    self._key_dicts[idx] = b.dicts[idx]
            ids[s] = self._group_ids(b)[0]
        prepared = []
        for dev, shards in self._groups:
            present = [(pos, s) for pos, s in enumerate(shards)
                       if round_batches[s] is not None]
            if not present:
                continue
            # aux and rank tables from the round's newest batch: the
            # dictionaries are shared and append-only, so its tables
            # cover every code of the round
            aux, str_aux = self._tables_on(live[-1], dev)
            entries = _round_entries([round_batches[s] for _, s in present],
                                     self.core.used_cols, dev)
            items = [(pos, e + (ids[s].to(dev),))
                     for (pos, s), e in zip(present, entries)]
            prepared.append((dev, items, aux, str_aux))
        return prepared

    @staticmethod
    def _signature(prepared, group_cap) -> tuple:
        """What consecutive warm rounds must share to fold into one
        pass: per device, the shard positions, the entries' structure
        and the identity of the aux and string-rank tables."""
        return (tuple((str(dev), tuple(pos for pos, _ in items),
                       entry_signature([e for _, e in items]),
                       shared_signature((aux, str_aux)))
                      for dev, items, aux, str_aux in prepared), group_cap)

    # -- state -----------------------------------------------------------
    def _dispatch(self, states, rounds, tag):
        """Fold `rounds` (prepared rounds of one signature) into the
        states: per device, one `fused_group` pass over every round's
        entries, its slots' rows together into the device's one state."""
        params = {}
        for dev, _shards in self._groups:
            key = str(dev)
            entries = []
            shared = None
            for prepared in rounds:
                for dev_p, items, aux, str_aux in prepared:
                    if str(dev_p) == key:
                        shared = (aux, str_aux)
                        entries.extend(e for _, e in items)
            if not entries:
                continue
            if key not in params:
                params[key] = param_tensors(self._param_values, dev)
            with METRICS.timer("execute.partitioned_aggregate"), op_timer(self):
                states[key] = device_call(
                    self.core.fused_group, entries, states[key], shared[0], shared[1],
                    params[key], _tag=tag, _device=dev)
        return states

    def _combine(self, states, str_aux):
        """The devices' states reduced in device order on the first
        slot's device; one device's state is the answer as it is."""
        dev0 = self.device
        parts = [states[str(dev)] for dev, _ in self._groups]
        if len(parts) == 1:
            return parts[0]
        counts = parts[0][0]
        for c, _ in parts[1:]:
            counts = counts + c.to(dev0)
        accs = []
        for i, sl in enumerate(self.slots):
            col = [a[i].to(dev0) for _, a in parts]
            if sl.is_string:
                # codes are shared across partitions: meet in rank space
                ranks = [self.core._codes_to_ranks(sl.kind, c, str_aux[i]) for c in col]
                best = ranks[0]
                op = torch.minimum if sl.kind == "smin" else torch.maximum
                for r in ranks[1:]:
                    best = op(best, r)
                accs.append(self.core._ranks_to_codes(sl.kind, best, str_aux[i]))
                continue
            op = (torch.add if sl.kind in ("sum", "cnt")
                  else torch.minimum if sl.kind == "min" else torch.maximum)
            acc = col[0]
            for r in col[1:]:
                acc = op(acc, r)
            accs.append(acc)
        return counts, tuple(accs)

    # -- the partitioned scan loop --------------------------------------
    def accumulate(self):
        feeds = [_ShardFeed(rels) for rels in _round_robin(self.children, self.n_shards)]
        deadline = current_deadline()
        fused_mode = fusion_enabled()
        round_fuse_max = fuse_group_max()
        states = None
        group_cap = 0
        last_str_aux = None
        buf: list = []
        buf_sig = None

        def flush():
            nonlocal states
            if not buf:
                return
            if len(buf) == 1:
                states = self._dispatch(states, buf, "mesh.stacked")
            else:
                METRICS.add("mesh.fused_round_launches")
                METRICS.add("mesh.fused_rounds", len(buf))
                states = self._dispatch(states, buf, "mesh.multi")
            buf.clear()

        while True:
            if deadline is not None:
                deadline.check("partitioned aggregate round")
            round_batches = [f.next_batch() for f in feeds]
            if all(b is None for b in round_batches):
                flush()
                break
            round_key = (
                tuple(-1 if b is None else id(b) for b in round_batches),
                tuple(dict_versions(b) for b in round_batches if b is not None),
            )
            hit = self._round_cache.get(round_key)
            if hit is not None:
                METRICS.add("mesh.round_cache_hits")
                prepared = hit[1]
            else:
                flush()  # a cold round ahead: drain the warm buffer
                prepared = self._prepare_round(round_batches)
                if round_key in self._round_seen:
                    # the entry pins the round's batches, so their id()s
                    # in the key stay theirs
                    self._round_cache[round_key] = (tuple(round_batches), prepared)
                    while len(self._round_cache) > self._round_cache_max:
                        self._round_cache.popitem(last=False)
                else:
                    self._round_seen[round_key] = True
                    while len(self._round_seen) > 4 * self._round_cache_max:
                        self._round_seen.popitem(last=False)
            last_str_aux = prepared[-1][3]
            needed = self._pick_capacity(
                self.encoder.num_groups if self.key_cols else 1, group_cap)
            if states is None:
                group_cap = needed
                states = {str(dev): self.core._init_state(group_cap, dev)
                          for dev, _ in self._groups}
            elif needed > group_cap:
                flush()  # the state is about to change shape
                states = {k: self.core._grow_state(st, needed) for k, st in states.items()}
                group_cap = needed
            if hit is None or not fused_mode:
                buf.append(prepared)
                flush()
                continue
            sig = self._signature(prepared, group_cap)
            if buf and (sig != buf_sig or len(buf) >= round_fuse_max):
                flush()
            buf_sig = sig
            buf.append(prepared)

        if states is None:
            return self.core._init_state(group_capacity(1), self.device)
        with METRICS.timer("execute.collective_combine"):
            # codes are append-only, so the last round's rank tables
            # cover every code any earlier round accumulated
            return self._combine(states, self._on_combine_device(last_str_aux))

    def _on_combine_device(self, str_aux):
        return tuple(None if p is None else tuple(t.to(self.device) for t in p)
                     for p in str_aux)


class DeadlineBoundRelation(Relation):
    """Bounds a relation's whole iteration with a per-query deadline:
    anchored at first pull, checked before every batch, and ambient
    (`deadline_scope`) around each child pull, so `device_call` backoffs
    and the mesh round loops honor it too."""

    def __init__(self, inner: Relation, seconds: float):
        self.inner = inner
        self.seconds = seconds

    @property
    def schema(self) -> Schema:
        return self.inner.schema

    def op_label(self) -> str:
        return f"Deadline[{self.seconds}s]"

    def op_children(self) -> list[Relation]:
        return [self.inner]

    def batches(self) -> Iterator[RecordBatch]:
        deadline = Deadline.after(self.seconds)
        it = iter(iter_stats(self.inner))
        while True:
            deadline.check("partitioned query")
            # the scope is set per pull: a contextvar set inside a
            # generator would leak into the consumer
            with deadline_scope(deadline):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


class PartitionedContext(ExecutionContext):
    """ExecutionContext that executes over a shard mesh.

    Aggregates over partitioned tables run the partial-aggregate and
    shard-combine path; every plan fragment round-trips through the
    JSON wire format first (`PlanFragment`), the bytes a coordinator
    ships.  `mesh` (parallel/mesh.Mesh) or `n_devices` pick the shard
    slots; with neither, every visible CUDA device (`make_mesh()`), and
    without CUDA it raises, as `ExecutionContext()` does.  The
    context's own device is the first slot's.

    `query_deadline_s` (or env DATAFUSION_TPU_QUERY_DEADLINE_S) bounds
    every query's iteration end to end, mesh rounds and device retries
    included.
    """

    def __init__(self, mesh: Optional[Mesh] = None, n_devices: Optional[int] = None,
                 batch_size: int = 131072, query_deadline_s: Optional[float] = None,
                 result_cache=None):
        import os

        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        super().__init__(device=self.mesh.devices[0], batch_size=batch_size,
                         result_cache=result_cache)
        self.last_fragments: list[PlanFragment] = []
        if query_deadline_s is None:
            env = os.environ.get("DATAFUSION_TPU_QUERY_DEADLINE_S")
            # "0" means off (the documented default), not a 0s budget
            query_deadline_s = (float(env) or None) if env else None
        self.query_deadline_s = query_deadline_s
        self._executing = False

    def register_partitioned_csv(self, name: str, paths: Sequence[str], schema: Schema,
                                 has_header: bool = True) -> None:
        self.register_datasource(name, PartitionedDataSource(
            [CsvDataSource(p, schema, has_header, self.batch_size) for p in paths]))

    def register_partitioned_parquet(self, name: str, paths: Sequence[str],
                                     schema: Optional[Schema] = None) -> None:
        self.register_datasource(name, PartitionedDataSource(
            [ParquetDataSource(p, schema, self.batch_size) for p in paths]))

    def _lower(self, plan: LogicalPlan) -> Relation:
        # wrap only the ROOT: child plans lower through `_lower` too, and
        # nested wrappers would hand every subtree a fresh budget
        if self.query_deadline_s is None or self._executing:
            return self._lower_unbounded(plan)
        self._executing = True
        try:
            rel = self._lower_unbounded(plan)
        finally:
            self._executing = False
        return DeadlineBoundRelation(rel, self.query_deadline_s)

    def _partition_children(self, plan: LogicalPlan, scan: TableScan):
        """The scan's partitions as relations, rebuilt from their wire
        meta (the path a remote worker takes); non-serializable sources
        (in memory) run the original partition objects."""
        ds = self.datasources[scan.table_name]
        if scan.projection is not None:
            ds = ds.with_projection(scan.projection)
        try:
            self.last_fragments = self._ship_fragments(plan, ds)
            parts = [f.build_datasource(self.batch_size) for f in self.last_fragments]
            _share_dictionaries(parts)
        except PlanError:
            self.last_fragments = []
            parts = ds.partitions
        return [DataSourceRelation(p) for p in parts]

    def _lower_unbounded(self, plan: LogicalPlan) -> Relation:
        agg, pred, scan = _match_partitioned_aggregate(plan, self.datasources)
        if agg is not None:
            return PartitionedAggregateRelation(
                self._partition_children(plan, scan), agg.group_expr, agg.aggr_expr,
                agg.schema, self.mesh, predicate=pred, functions=self._torch_functions(),
            )
        pipe = _match_partitioned_pipeline(plan, self.datasources, self.functions)
        if pipe is not None:
            pred, projections, scan, out_schema = pipe
            return PartitionedPipelineRelation(
                self._partition_children(plan, scan), pred, projections, out_schema,
                self.mesh, functions=self._torch_functions(), function_metas=self.functions,
            )
        return super()._lower(plan)

    def _ship_fragments(self, plan: LogicalPlan,
                        ds: PartitionedDataSource) -> list[PlanFragment]:
        n = len(ds.partitions)
        frags = []
        for i, part in enumerate(ds.partitions):
            frag = PlanFragment(i, n, plan.to_json(), part.to_meta())
            # serialize -> deserialize: the round trip a coordinator ->
            # worker hop performs
            frags.append(PlanFragment.from_json_str(frag.to_json_str()))
        return frags


def _match_partitioned_pipeline(plan: LogicalPlan, datasources: dict, metas):
    """Match [Projection](Selection)(TableScan) over a partitioned table;
    (predicate, projections, scan, out_schema) or None.  Plans whose
    expressions need host evaluation take the serial union scan."""
    from datafusion_tpu_torch.exec.hostfn import contains_host_fn
    from datafusion_tpu_torch.plan.logical import Projection

    projections = None
    out_schema = plan.schema
    node = plan
    if isinstance(node, Projection):
        projections = node.expr
        node = node.input
    pred = None
    if isinstance(node, Selection):
        pred = node.expr
        node = node.input
    if not isinstance(node, TableScan):
        return None
    if projections is None and pred is None:
        return None  # bare scan: nothing to parallelize
    ds = datasources.get(node.table_name)
    if not isinstance(ds, PartitionedDataSource):
        return None
    checked = ([] if pred is None else [pred]) + list(projections or [])
    if any(contains_host_fn(e, metas or {}) for e in checked):
        return None
    return pred, projections, node, out_schema


def _match_partitioned_aggregate(plan: LogicalPlan, datasources: dict):
    """Match Aggregate[(Selection)](TableScan over a partitioned table);
    (aggregate, predicate, scan) or (None, None, None)."""
    if not isinstance(plan, Aggregate):
        return None, None, None
    inner = plan.input
    pred = None
    if isinstance(inner, Selection):
        pred = inner.expr
        inner = inner.input
    if not isinstance(inner, TableScan):
        return None, None, None
    ds = datasources.get(inner.table_name)
    if not isinstance(ds, PartitionedDataSource):
        return None, None, None
    return plan, pred, inner
