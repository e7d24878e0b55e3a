"""Relation protocol, the scan adapter and the pipeline operator.

The counterpart of the JAX package's `exec/relation.py`: a volcano-
style pull iterator of RecordBatches.  A scan -> filter -> project
fragment runs as one `PipelineRelation`: per batch group (up to
`exec/fused.pipeline_group_max()` batches of one structure and one set
of dictionary tables, concatenated along rows; one batch with
DATAFUSION_TPU_FUSE=0), one pass of torch ops on the device evaluates
the predicate into a selection mask that rides each batch (rows are not
gathered) and computes the projected expressions beside it; each input
batch gets its own output batch, views of the group's outputs.  Over a
CSV scan on a CUDA device the batches' host prep runs ahead on the
prefetch threads (`exec/prefetch.py`).  Only the columns those expressions read cross
to the device; column projections pass through on the host untouched,
Utf8 columns with their dictionaries; the mask and the computed
columns come back when `collect` pulls them.

The serving megabatch's pipeline lane (`run_pipeline_megabatch`): N
relations over one core and one table scan once, and each batch group
runs all N queries' predicates and projections in one pass
(`_PipelineCore.run_group_multi`); each relation then replays its own
output batches.

Relations that raise NotSupportedError here: a `PipelineRelation`
whose predicate calls a host-only function (`host_fn` UDF).
"""

from __future__ import annotations

import time

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    StringDictionary,
    device_inputs,
    dict_versions,
    param_tensors,
    pin_dict_versions,
    subset_view,
)
from datafusion_tpu_torch.exec.expression import Env, ExprCompiler, compute_aux_values
from datafusion_tpu_torch.exec.fused import (
    entry_signature,
    fusion_enabled,
    pipeline_group_max,
    shared_signature,
)
from datafusion_tpu_torch.exec.prefetch import pipeline_enabled, staged_pipeline
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.obs.stats import OperatorStats, iter_stats, op_timer
from datafusion_tpu_torch.plan.expr import Column, Expr
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call


class Relation:
    """Pull-based iterator of RecordBatches (reference `Relation` trait).

    Every relation doubles as a physical plan node for observability:
    it lazily owns an `OperatorStats` (`.stats`, filled only on
    instrumented runs: EXPLAIN ANALYZE, DATAFUSION_TPU_TRACE=1), names
    itself (`op_name`, `op_label`, the JAX package's labels) and exposes
    its operator children (`op_children`) so EXPLAIN ANALYZE can walk
    the executed tree.
    """

    _op_stats = None

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[RecordBatch]:
        raise NotImplementedError

    @property
    def stats(self):
        st = self._op_stats
        if st is None:
            st = self._op_stats = OperatorStats()
        return st

    def op_name(self) -> str:
        name = type(self).__name__
        for junk in ("Relation", "Exec", "_"):
            name = name.replace(junk, "")
        return name or type(self).__name__

    def op_label(self) -> str:
        """One-line description for the EXPLAIN ANALYZE tree."""
        return self.op_name()

    def op_children(self) -> list["Relation"]:
        c = getattr(self, "child", None)
        return [c] if isinstance(c, Relation) else []


class DataSourceRelation(Relation):
    """Adapts a DataSource into a Relation (reference `relation.rs:34-54`).

    With `cost_key` (the lowering passes `cost.table_key` of the scanned
    table) every scan, an abandoned one included, teaches the cost store
    the table's rows and host bytes (``scan`` record; its ``rows_max``
    keeps a partial scan from shrinking the learned count): the
    statistics the build-side swap and the megabatch's member weights
    read.  With `table_name` it also lands in the scan histograms
    (obs/aggregate.observe_scan: the source's produce time and host
    bytes, once a scan)."""

    def __init__(self, datasource, cost_key: Optional[str] = None,
                 table_name: Optional[str] = None):
        self.datasource = datasource
        self._cost_key = cost_key
        self.table_name = table_name

    @property
    def schema(self) -> Schema:
        return self.datasource.schema

    def op_label(self) -> str:
        src = type(self.datasource).__name__.replace("DataSource", "")
        path = getattr(self.datasource, "path", None)
        return f"Scan[{src}{f': {path}' if path else ''}]"

    def batches(self) -> Iterator[RecordBatch]:
        if self._cost_key is None and self.table_name is None:
            return self.datasource.batches()
        return self._observed(self.datasource.batches())

    def _observed(self, it) -> Iterator[RecordBatch]:
        rows = nbytes = 0
        produce_s = 0.0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    produce_s += time.perf_counter() - t0
                rows += batch.num_rows
                for arr in batch.data:
                    if isinstance(arr, np.ndarray):
                        nbytes += arr.nbytes
                for v in batch.validity:
                    if isinstance(v, np.ndarray):
                        nbytes += v.nbytes
                yield batch
        finally:
            # once a scan, an abandoned one (a bare LIMIT) included
            if self.table_name is not None:
                from datafusion_tpu_torch.obs.aggregate import observe_scan

                observe_scan(self.table_name, produce_s, nbytes)
            if rows and self._cost_key is not None:
                from datafusion_tpu_torch import cost as _cost

                _cost.store().observe(self._cost_key, "scan", rows=rows, nbytes=nbytes)


class _EmptyRelationExec(Relation):
    """One conceptual row, zero columns (for table-less SELECTs)."""

    _CAP = 8

    @property
    def schema(self) -> Schema:
        return Schema([])

    def batches(self) -> Iterator[RecordBatch]:
        yield RecordBatch(
            Schema([]), [], [], [], num_rows=1, mask=np.ones(self._CAP, dtype=bool)
        )


class _PipelineCore:
    """The shareable part of a pipeline: the predicate and projection
    closures, which columns they read, and where each output comes
    from.  Cached process-wide by plan fingerprint (exec/kernels.py),
    so a fresh operator tree for the same query shape reuses it."""

    def __init__(self, in_schema, predicate, projections, functions, metas,
                 param_slots=None):
        from datafusion_tpu_torch.exec.hostfn import contains_host_fn

        compiler = ExprCompiler(in_schema, functions, param_slots)
        if predicate is not None and contains_host_fn(predicate, metas):
            raise NotSupportedError(
                "host-only functions are not supported in WHERE predicates"
            )
        self.pred_fn = compiler.compile(predicate) if predicate is not None else None
        # a projection that calls a host-only function evaluates with
        # numpy against the input batch (PipelineRelation._assemble);
        # a bare column passes through on the host; the rest compile
        self.host_proj: set[int] = set()
        self.identity_proj: dict[int, int] = {}
        self.proj_fns: Optional[list] = None
        if projections is not None:
            self.proj_fns = []
            for j, e in enumerate(projections):
                if contains_host_fn(e, metas):
                    self.host_proj.add(j)
                    self.proj_fns.append(None)
                elif isinstance(e, Column):
                    # an out-of-range column raises InvalidColumnError
                    # here, at lowering, as in the JAX package (an
                    # unverified plan can name one)
                    in_schema.field(e.index)
                    self.identity_proj[j] = e.index
                    self.proj_fns.append(None)
                else:
                    self.proj_fns.append(compiler.compile(e))
        self.aux_specs = compiler.aux_specs
        # no predicate and nothing to compute => the batch never
        # touches the device (a pure column selection)
        self.needs_kernel = self.pred_fn is not None or (
            self.proj_fns is not None and any(f is not None for f in self.proj_fns)
        )
        # ship only the columns the device pass reads; Env's col_map
        # translates schema indices to subset positions
        used: set[int] = set()
        if predicate is not None:
            predicate.collect_columns(used)
        for j, e in enumerate(projections or []):
            if self.proj_fns[j] is not None:
                e.collect_columns(used)
        if self.needs_kernel and not used and len(in_schema):
            used.add(0)  # a constant predicate: one column carries capacity
        self.used_cols = sorted(used)
        self.col_map = {c: i for i, c in enumerate(self.used_cols)}
        # the wire codec's per-column memory across batches
        # (batch.put_compressed): the core outlives its relations
        self.wire_hints: dict = {}

    @staticmethod
    def param_exprs(predicate, projections, metas):
        """The exprs that compile into the core, in slot order.  A
        host-evaluated projection keeps its literals on the relation."""
        from datafusion_tpu_torch.exec.hostfn import contains_host_fn

        elig = [] if predicate is None else [predicate]
        elig.extend(e for e in projections or [] if not contains_host_fn(e, metas))
        return elig

    @staticmethod
    def build(in_schema, predicate, projections, functions, metas):
        from datafusion_tpu_torch.exec.hostfn import contains_host_fn
        from datafusion_tpu_torch.exec.kernels import (
            cached_kernel,
            functions_fingerprint,
            parameterize_exprs,
            schema_fingerprint,
        )

        elig = _PipelineCore.param_exprs(predicate, projections, metas)
        fps, slot_by_id, _ = parameterize_exprs(elig)
        fp_of = dict(zip((id(e) for e in elig), fps))
        proj_key = None
        if projections is not None:
            proj_key = tuple(
                ("host", parameterize_exprs([e])[0][0])
                if contains_host_fn(e, metas) else fp_of[id(e)]
                for e in projections
            )
        key = (
            "pipeline",
            schema_fingerprint(in_schema),
            None if predicate is None else fp_of[id(predicate)],
            proj_key,
            functions_fingerprint(functions),
            tuple(sorted(n for n, m in metas.items() if m.host_fn)),
        )
        return cached_kernel(
            key,
            lambda: _PipelineCore(
                in_schema, predicate, projections, functions, metas, slot_by_id
            ),
        )

    def run_group(self, entries, aux, params, device):
        """One device pass over a batch group: `entries` are per-batch
        (cols, valids, num_rows, mask|None) with one
        `exec/fused.entry_signature`, concatenated along rows with each
        one's live mask (`arange(capacity) < num_rows`, ANDed with its
        mask); the predicate and the projections evaluate once over the
        group.  Returns per-batch (computed columns, their validity,
        selection mask): views of the group's outputs at each batch's
        rows and capacity.  A group of one entry concatenates nothing."""
        return self.run_group_multi(entries, aux, [params], device)[0]

    def run_group_multi(self, entries, aux, params_list, device):
        """`run_group` for N queries of this core at once (the serving
        megabatch): the group's entries concatenate once, then each
        query's predicate and projections evaluate under its own
        parameters.  Returns, per query, what `run_group` returns."""
        caps = [self._capacity(c, m) for c, _, _, m in entries]
        live = [torch.arange(cap, dtype=torch.int32, device=device) < n
                for cap, (_, _, n, _) in zip(caps, entries)]
        live = [lv if m is None else lv & m for lv, (_, _, _, m) in zip(live, entries)]
        if len(entries) == 1:
            cols, valids = entries[0][0], entries[0][1]
            base = live[0]
        else:
            cols = tuple(torch.cat(c) for c in zip(*(e[0] for e in entries)))
            valids = tuple(None if v[0] is None else torch.cat(v)
                           for v in zip(*(e[1] for e in entries)))
            base = torch.cat(live)
            LEDGER.adopt((cols, valids, base), "fold")
        capacity = base.shape[0]
        out = []
        for params in params_list:
            env = Env(cols, valids, aux, device, self.col_map, params)
            mask = base
            if self.pred_fn is not None:
                pv, pvalid = self.pred_fn(env)
                pv = pv.expand(capacity)
                if pvalid is not None:
                    # SQL: a NULL predicate drops the row
                    pv = pv & pvalid.expand(capacity)
                mask = mask & pv
            out_cols, out_valids = [], []
            for f in self.proj_fns or []:
                if f is None:
                    continue
                v, valid = f(env)
                out_cols.append(_full(v, capacity))
                out_valids.append(None if valid is None else _full(valid, capacity))
            if len(entries) == 1:
                out.append([(out_cols, out_valids, mask)])
                continue
            split = [torch.split(c, caps) for c in out_cols]
            split_valids = [None if v is None else torch.split(v, caps) for v in out_valids]
            out.append([([c[j] for c in split],
                         [None if v is None else v[j] for v in split_valids],
                         m)
                        for j, m in enumerate(torch.split(mask, caps))])
        return out

    @staticmethod
    def _capacity(cols, base_mask) -> int:
        if cols:
            return cols[0].shape[0]
        if base_mask is not None:
            return base_mask.shape[0]  # a zero-column EmptyRelation batch
        return 1


def _full(t: torch.Tensor, capacity: int) -> torch.Tensor:
    """`t` as a column of `capacity` rows (a literal's 0-dim result
    broadcasts into its own storage)."""
    if t.dim() == 1 and t.shape[0] == capacity:
        return t
    return t.expand(capacity).contiguous()


class PipelineRelation(Relation):
    """[filter +] [projection] over a child relation, one device pass
    per batch group.  The core is shared process-wide by plan fingerprint
    (`_PipelineCore.build`); each relation carries its own literal
    values and host-evaluated projections."""

    def __init__(
        self,
        child: Relation,
        predicate: Optional[Expr],
        projections: Optional[list[Expr]],
        out_schema: Optional[Schema],
        device: torch.device,
        functions: Optional[dict[str, Callable]] = None,
        function_metas=None,
    ):
        self.child = child
        self.predicate = predicate
        self.projections = projections
        self._schema = out_schema if out_schema is not None else child.schema
        self.device = device
        self._metas = function_metas or {}
        self.core = _PipelineCore.build(
            child.schema, predicate, projections, functions, self._metas
        )
        from datafusion_tpu_torch.exec.kernels import parameterize_exprs

        # THIS query's literal values for the shared core's parameter
        # slots (identical fingerprints guarantee identical slot order)
        self._params = parameterize_exprs(
            _PipelineCore.param_exprs(predicate, projections, self._metas)
        )[2]
        self._host_dicts: dict[int, StringDictionary] = {}
        self._aux_cache: dict = {}

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        parts = []
        if self.predicate is not None:
            parts.append("filter")
        if self.projections is not None:
            parts.append("project")
        return f"Pipeline[{'+'.join(parts) or 'pass'}]"

    def batches(self) -> Iterator[RecordBatch]:
        injected = self.__dict__.pop("_injected_batches", None)
        if injected is not None:
            yield from injected  # the serving megabatch ran this query
            return
        core = self.core
        dev = self.device
        batches = iter_stats(self.child)
        if not core.needs_kernel:
            yield from self._passthrough(batches)
            return
        if pipeline_enabled(dev, self.child):
            batches = staged_pipeline(batches, self._stage, pull=pin_dict_versions)
        params = param_tensors(self._params, dev)
        for group in self._batch_groups(batches):
            # one device pass, then one output batch per input batch,
            # with its boundaries, `num_rows` and mask
            with METRICS.timer("execute.pipeline"), op_timer(self):
                if len(group) > 1:
                    METRICS.add("fused.groups")
                    METRICS.add("fused.group_batches", len(group))
                outs = device_call(
                    core.run_group, [e for _, e, _ in group], group[0][2], params, dev,
                    _tag="pipeline.group" if len(group) > 1 else "pipeline", _device=dev)
            for (batch, _, _), (cols, valids, mask) in zip(group, outs):
                yield self._output(batch, cols, valids, mask)

    def _batch_groups(self, batches):
        """The scan's batch groups: runs of up to `pipeline_group_max()`
        batches of one entry and aux-table signature, each a list of
        (batch, entry, aux) with the copies of its used columns."""
        group_max = pipeline_group_max() if fusion_enabled() else 1
        group: list = []
        sig = None
        for batch in batches:
            aux = self._aux(batch)
            with METRICS.timer("execute.pipeline"), op_timer(self):
                # the columns and the selection mask cross in one copy
                data, validity, mask_in = device_inputs(
                    subset_view(batch, self.core.used_cols), self.device,
                    self.core.wire_hints,
                )
            entry = (data, validity, batch.num_rows, mask_in)
            entry_sig = (entry_signature(entry), shared_signature(aux))
            if group and (entry_sig != sig or len(group) >= group_max):
                yield group
                group = []
            sig = entry_sig
            group.append((batch, entry, aux))
        if group:
            yield group

    def _passthrough(self, batches) -> Iterator[RecordBatch]:
        """A pure column selection: no device pass.  It yields one stable
        output batch per child batch, so a re-scanned in-memory source
        hands the operators above it the same batch objects (and with
        them the device copies cached on them); pinned by relation when
        host projections carry this query's literals, else by core."""
        pin = self if self.core.host_proj else self.core
        for batch in batches:
            hit = batch.cache.get("pipeline_out")
            if hit is not None and hit[0] is pin:
                yield hit[1]
                continue
            out = self._output(batch, [], [], batch.mask)
            batch.cache["pipeline_out"] = (pin, out)
            yield out

    def _output(self, batch, cols, valids, mask) -> RecordBatch:
        """The output batch of one input batch; the dictionary versions
        pinned on the input carry over to the columns that pass through
        (`batch.pin_dict_versions`)."""
        if self.core.proj_fns is None:
            # filter only: the input columns, untouched
            out_cols, out_valids, dicts = batch.data, batch.validity, batch.dicts
            versions = dict_versions(batch)
        else:
            out_cols, out_valids, dicts = self._assemble(batch, cols, valids)
            pinned = dict_versions(batch)
            versions = [
                pinned[self.core.identity_proj[j]] if j in self.core.identity_proj
                else None if d is None else d.version
                for j, d in enumerate(dicts)
            ]
        out = RecordBatch(
            self._schema, list(out_cols), list(out_valids), list(dicts),
            num_rows=batch.num_rows, mask=mask,
        )
        pin_dict_versions(out, versions)
        return out

    def _aux(self, batch):
        """The batch's aux tables: the ones the prefetch stage pinned on
        it for this relation, else built here."""
        hit = batch.cache.get("staged_aux")
        if hit is not None and hit[0] is self:
            return hit[1]
        return self._tables(batch)

    def _tables(self, batch):
        return tuple(compute_aux_values(self.core.aux_specs, batch, self._aux_cache,
                                        self.device))

    def _stage(self, batch) -> None:
        """The host prep of one batch on the prefetch thread: its aux
        tables (pinned on the batch for this relation) and the copies
        of the columns the pass reads."""
        batch.cache["staged_aux"] = (self, self._tables(batch))
        device_inputs(subset_view(batch, self.core.used_cols), self.device,
                      self.core.wire_hints)

    def _assemble(self, batch, dev_cols, dev_valids):
        """Interleave the column passthroughs (the input arrays, exact),
        the host-evaluated projections and the device pass's computed
        columns, in projection order."""
        from datafusion_tpu_torch.exec.hostfn import eval_host_expr

        core = self.core
        cols, valids, dicts = [], [], []
        dev_i = 0
        for j, e in enumerate(self.projections):
            src = core.identity_proj.get(j)
            if src is not None:
                cols.append(batch.data[src])
                valids.append(batch.validity[src])
                dicts.append(batch.dicts[src])
                continue
            if j not in core.host_proj:
                cols.append(dev_cols[dev_i])
                valids.append(dev_valids[dev_i])
                dicts.append(None)
                dev_i += 1
                continue
            v, valid = eval_host_expr(e, batch, self._metas)
            d = None
            if self._schema.field(j).data_type == DataType.UTF8:
                d = self._host_dicts.get(j)
                if d is None:
                    d = self._host_dicts[j] = StringDictionary()
                v = d.encode(list(np.broadcast_to(np.asarray(v, dtype=object),
                                                  (batch.capacity,))))
            elif isinstance(v, tuple):
                # struct results materialize as their Display form
                # "f1, f2" (golden test_sql_udf_udt.csv); literal
                # arguments arrive as 0-d scalars, so broadcast first
                parts = np.broadcast_arrays(
                    *[np.asarray(x) for x in v], np.empty(batch.capacity)
                )[:-1]
                v = np.asarray(
                    [", ".join(str(x) for x in tup) for tup in zip(*parts)],
                    dtype=object,
                )
            cols.append(np.broadcast_to(np.asarray(v), (batch.capacity,)))
            valids.append(
                None if valid is None
                else np.broadcast_to(valid, (batch.capacity,))
            )
            dicts.append(d)
        return cols, valids, dicts


def run_pipeline_megabatch(rels: list) -> None:
    """ONE scan, N filter/project queries: the serving megabatch's
    pipeline lane (the JAX package's `run_pipeline_megabatch`).
    Preconditions (serve.py `_mega_key`): the relations share one core
    (their literals are parameters) and scan one table, and the core
    has device work.  The batch groups are a solo scan's; each runs
    every query in one `run_group_multi` over inputs copied once.  Each
    relation gets its output batches as `_injected_batches`, which its
    `batches()` replays."""
    leader = rels[0]
    dev = leader.device
    params_list = [param_tensors(r._params, dev) for r in rels]
    outs: list[list] = [[] for _ in rels]
    for group in leader._batch_groups(iter_stats(leader.child)):
        with METRICS.timer("execute.pipeline"), op_timer(leader):
            METRICS.add("fused.groups")
            METRICS.add("fused.group_batches", len(group))
            per_query = device_call(
                leader.core.run_group_multi, [e for _, e, _ in group], group[0][2],
                params_list, dev, _tag="pipeline.mega", _device=dev)
        for r, out, res in zip(rels, outs, per_query):
            for (batch, _, _), (cols, valids, mask) in zip(group, res):
                out.append(r._output(batch, cols, valids, mask))
        METRICS.add("serve.megabatch_launches")
        METRICS.add("serve.megabatch_batches", len(group))
    METRICS.add("serve.megabatch_queries", len(rels))
    for r, out in zip(rels, outs):
        r._injected_batches = out
