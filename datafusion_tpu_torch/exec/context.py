"""ExecutionContext: the API hub (reference `src/execution/context.rs`).

The counterpart of the JAX package's `exec/context.py`.  `ctx.sql(text)`
parses, plans and optimizes (projection push-down), then maps the plan
onto operators:

    TableScan                        -> DataSourceRelation
    EmptyRelation                    -> one zero-column row
    Selection(x), Projection(x),
    Projection(Selection(x))         -> PipelineRelation
    Aggregate(Selection(x))          -> AggregateRelation with the
                                        predicate evaluated inside it
    Aggregate(x)                     -> AggregateRelation
    Join(l, r)                       -> HashJoinRelation
    [Limit](Sort(x))                 -> SortRelation (the streaming TopK
                                        for LIMIT k, 0 < k <= TOPK_MAX)
    Limit(x)                         -> LimitRelation

With fusion on (the default; `DATAFUSION_TPU_FUSE=0` turns it off) whole
chains collapse first (exec/fused.py): an Aggregate over a deeper
filter/project chain into ONE AggregateRelation, a deeper chain into
ONE PipelineRelation, and a [Limit](Sort) over a filter and
column-projection chain into ONE SortRelation that filters, sorts and
projects.

Statements: SELECT lowers and runs lazily; CREATE EXTERNAL TABLE (CSV,
NDJSON, Parquet) registers a table and returns a `DdlResult`; EXPLAIN
returns an `ExplainResult` (the plan's text) and EXPLAIN VERIFY an
`ExplainVerifyResult` (the verifier's report), neither executing;
EXPLAIN ANALYZE runs the query and returns an
`obs/explain.ExplainAnalyzeResult` (rows, the annotated operator tree,
phases, spans); CREATE MATERIALIZED VIEW registers a continuously
maintained view through `ingest()` (ingest/) and returns a `DdlResult`.
`sql_collect` materializes a SELECT.  `table(name)` gives a DataFrame
(dataframe.py).

Catalog versions and the result cache (the JAX package's
`exec/context.py` seam): every (re)registration of a table bumps its
catalog version and drops the cached results tagged with it, and every
UDF registration bumps the functions version.  `query_fingerprint`
folds the plan's wire JSON, each scanned table's catalog version, its
source's `data_version` and `data_identity` (a file's size and
modification time; an appendable table's append count), the device, the
batch size and the functions version into one digest.  `execute` is the
root-level cache seam: with a result cache (`result_cache=None` takes
`cache.make_store("result")`, on unless `DATAFUSION_TPU_CACHE=0`; False
turns it off; or a `cache.CacheStore`) a plan whose fingerprint is cached
replays its host batches (`cache/result.CachedResultRelation`, no source
and no device touched); a miss lowers as usual and its complete
materialization (`exec/materialize.collect_columns`) fills the entry.
A lowering nested in `execute` on the same thread (`in_execute`) never
replays.  `stats_history` keeps each fingerprint's runs (rows, wall
seconds, hit or miss; operators on traced runs), `last_fingerprint` the
latest.

Every plan `execute` lowers passes the static verifier first
(analysis/verify.py, `DATAFUSION_TPU_VERIFY`, default on): an unknown
column, a mistyped expression, a computed GROUP BY or ORDER BY key
raises `PlanVerificationError` before any operator is built.

What raises NotSupportedError: a `host_fn` UDF in a WHERE predicate
and any plan node not listed above (ROADMAP queue 1).

Every plan `execute` lowers counts `queries_admitted`
(utils/metrics.py).  `serve()` starts the serving front door over the
context (serve.py); a plan it lowers with `build_pins` pins each join's
build side in the device ledger under `_build_key` (join/relation.py).
Without a server nothing pins.

Device selection: `device=None` means `cuda:0`, and the context raises
ExecutionError when no CUDA device is available — it never carries on
quietly on the CPU.  `device="cpu"` is how a caller (the tests) asks
for the CPU.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Optional, Union

import torch

from datafusion_tpu_torch.analysis import verify as _averify
from datafusion_tpu_torch.datatypes import DataType, Field, Schema
from datafusion_tpu_torch.errors import ExecutionError, NotSupportedError, PlanError
from datafusion_tpu_torch.exec import fused
from datafusion_tpu_torch.exec.aggregate import AggregateRelation
from datafusion_tpu_torch.exec.datasource import (
    CsvDataSource,
    DataSource,
    NdJsonDataSource,
    ParquetDataSource,
)
from datafusion_tpu_torch.exec.materialize import ResultTable, collect
from datafusion_tpu_torch.exec.hostfn import contains_host_fn
from datafusion_tpu_torch.exec.relation import (
    DataSourceRelation,
    PipelineRelation,
    Relation,
    _EmptyRelationExec,
)
from datafusion_tpu_torch.exec.sort import LimitRelation, SortRelation
from datafusion_tpu_torch.join.relation import HashJoinRelation
from datafusion_tpu_torch.plan.expr import FunctionMeta, FunctionType
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    EmptyRelation,
    Join,
    Limit,
    LogicalPlan,
    Projection,
    Selection,
    Sort,
    TableScan,
    scan_tables,
)
from datafusion_tpu_torch.sql import ast
from datafusion_tpu_torch.sql.optimizer import push_down_projection
from datafusion_tpu_torch.sql.parser import parse_sql
from datafusion_tpu_torch.sql.planner import SqlToRel, convert_data_type
from datafusion_tpu_torch.utils.metrics import METRICS


class DdlResult:
    """Outcome of a DDL statement (CREATE EXTERNAL TABLE)."""

    def __init__(self, message: str):
        self.message = message

    def __repr__(self):
        return self.message


class ExplainResult:
    """`EXPLAIN <stmt>`: the optimized logical plan (not executed)."""

    def __init__(self, plan: LogicalPlan):
        self.plan = plan

    def __repr__(self):
        return repr(self.plan)


class _ContextSchemaProvider:
    """Adapter exposing the context's catalog to the planner."""

    def __init__(self, ctx: "ExecutionContext"):
        self.ctx = ctx

    def get_table_meta(self, name: str) -> Optional[Schema]:
        ds = self.ctx.datasources.get(name)
        return ds.schema if ds is not None else None

    def get_function_meta(self, name: str) -> Optional[FunctionMeta]:
        return self.ctx.functions.get(name.lower())


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutionError(
                f"no CUDA device available for {dev}; pass device='cpu' "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ExecutionError(f"no {dev} device available")
    elif dev.type != "cpu":
        raise ExecutionError(f"unsupported device {dev}")
    return dev


# the `build_pins` of the plan `execute` lowers on this thread
_LOWERING = threading.local()


class ExecutionContext:
    """Register datasources, run SQL, pull columnar results.

    `device`: None (`cuda:0`), a CUDA device, or "cpu".
    `result_cache`: None (the environment's default store, on unless
    `DATAFUSION_TPU_CACHE=0`), False (off), or a `cache.CacheStore`.
    """

    def __init__(self, device=None, batch_size: int = 131072,
                 result_cache=None):
        self.datasources: dict[str, DataSource] = {}
        self.functions: dict[str, FunctionMeta] = {}
        self.batch_size = batch_size
        self.device = _resolve_device(device)
        # catalog versioning: every (re)registration of a table name
        # bumps a context-wide serial, which the result-cache fingerprint
        # folds in for every table a plan scans
        self._catalog_versions: dict[str, int] = {}
        self._catalog_serial = 0
        self._functions_version = 0
        if result_cache is None:
            from datafusion_tpu_torch import cache as _cache

            result_cache = _cache.make_store("result")
        elif result_cache is False:
            result_cache = None
        self._result_cache = result_cache
        self._stats_history: dict[str, list[dict]] = {}
        self._history_cap = 32  # runs kept per fingerprint
        self._history_fingerprints = 128  # distinct fingerprints kept
        self.last_fingerprint: Optional[str] = None
        # per-thread root guard: a lowering nested in `execute` (a view
        # building its operator tree) must not meet the cache seam
        self._execute_tls = threading.local()
        # builtin math functions are ordinary catalog entries
        from datafusion_tpu_torch.exec.expression import BUILTIN_FUNCTIONS

        for fname, fn in BUILTIN_FUNCTIONS.items():
            self.register_udf(fname, [DataType.FLOAT64], DataType.FLOAT64, fn)

    # -- catalog --
    def register_datasource(self, name: str, ds: DataSource) -> None:
        """Register (or re-register) a table.  Re-registering a name
        bumps its catalog version: cached results that scanned the old
        table stop matching (fingerprint) and are dropped (tag)."""
        self._catalog_serial += 1
        self._catalog_versions[name] = self._catalog_serial
        if self._result_cache is not None:
            self._result_cache.invalidate_tag(name)
        self.datasources[name] = ds

    def catalog_version(self, name: str) -> int:
        """Monotonic version of a registered table (0 = never seen)."""
        return self._catalog_versions.get(name, 0)

    def register_csv(
        self, name: str, path: str, schema: Schema, has_header: bool = True
    ) -> None:
        """Register a CSV file, read by the native parser
        (datafusion_tpu_torch/native) in batches of `batch_size` rows."""
        self.register_datasource(
            name, CsvDataSource(path, schema, has_header, self.batch_size)
        )

    def register_parquet(self, name: str, path: str, schema: Optional[Schema] = None):
        """Register a Parquet file (through pyarrow, io/readers.py); with
        no `schema` the file's metadata gives it."""
        self.register_datasource(name, ParquetDataSource(path, schema, self.batch_size))

    def register_ndjson(self, name: str, path: str, schema: Schema) -> None:
        """Register a newline-delimited JSON file (io/readers.py)."""
        self.register_datasource(name, NdJsonDataSource(path, schema, self.batch_size))

    def register_udf(
        self,
        name: str,
        arg_types: list[DataType],
        return_type: DataType,
        torch_fn: Optional[Callable] = None,
        host_fn: Optional[Callable] = None,
    ) -> None:
        """Register a scalar UDF.  `torch_fn` maps tensors to a tensor
        and runs on the batch's device.  `host_fn` (numpy in/out) is
        for functions with no tensor form (string or struct producers);
        a projection that calls one evaluates on the host against the
        pipeline's input batch, and a predicate that calls one raises
        NotSupportedError."""
        if torch_fn is None and host_fn is None:
            raise ExecutionError(f"UDF {name!r} needs a torch_fn or a host_fn")
        # a (re)registered UDF changes what identical SQL text computes
        self._functions_version += 1
        self.functions[name.lower()] = FunctionMeta(
            name.lower(),
            [Field(f"arg{i}", t, True) for i, t in enumerate(arg_types)],
            return_type,
            FunctionType.Scalar,
            torch_fn,
            host_fn,
        )

    def _torch_functions(self) -> dict[str, Callable]:
        return {name: fm.torch_fn for name, fm in self.functions.items() if fm.torch_fn}

    def table(self, name: str):
        """A DataFrame over a registered datasource (the programmatic
        twin of `FROM name`)."""
        from datafusion_tpu_torch.dataframe import DataFrame

        ds = self.datasources.get(name)
        if ds is None:
            raise ExecutionError(f"No datasource registered as {name!r}")
        return DataFrame(self, TableScan("default", name, ds.schema))

    # -- entry points --
    def sql(self, sql_text: str) -> Union[Relation, DdlResult, ExplainResult]:
        """Parse, plan, optimize, build the operator tree (lazy — no
        data is read until batches are pulled).  DDL registers its table
        and EXPLAIN renders its plan at once."""
        with METRICS.timer("parse"):
            stmt = parse_sql(sql_text)
        if isinstance(stmt, ast.SqlCreateExternalTable):
            return self._execute_ddl(stmt)
        if isinstance(stmt, ast.SqlCreateMaterializedView):
            view = self.ingest().create_view(stmt.name, stmt.query_sql)
            return DdlResult(
                f"Registered materialized view {stmt.name} "
                f"({'incremental' if view.incremental else 'recompute'})")
        if isinstance(stmt, ast.SqlExplain):
            plan = self._plan(stmt.stmt)
            if stmt.analyze:
                # runs the query under a trace session and annotates the
                # operator tree with what it measured (obs/explain.py)
                from datafusion_tpu_torch.obs.explain import explain_analyze

                return explain_analyze(self, plan)
            if stmt.verify:
                # type-checks the plan WITHOUT executing it
                with METRICS.timer("verify"):
                    report = _averify.verify_plan(plan, functions=self.functions)
                return _averify.ExplainVerifyResult(plan, report)
            return ExplainResult(plan)
        return self.execute(self._plan(stmt))

    def metrics_text(self) -> str:
        """The engine's counters, stage timings and gauges
        (utils/metrics.METRICS) in the Prometheus text exposition format
        (obs/export.prometheus_text)."""
        from datafusion_tpu_torch.obs.export import prometheus_text

        return prometheus_text()

    def sql_collect(self, sql_text: str) -> Union[ResultTable, DdlResult, ExplainResult]:
        """`sql`, with a SELECT's rows materialized on the host."""
        out = self.sql(sql_text)
        if isinstance(out, Relation):
            with METRICS.timer("collect"):
                return collect(out)
        return out

    def _plan(self, stmt: ast.SqlNode) -> LogicalPlan:
        with METRICS.timer("plan"):
            plan = SqlToRel(_ContextSchemaProvider(self)).sql_to_rel(stmt)
        with METRICS.timer("optimize"):
            return push_down_projection(plan)

    def _execute_ddl(self, stmt: ast.SqlCreateExternalTable) -> DdlResult:
        if stmt.columns:
            schema = Schema([
                Field(c.name, convert_data_type(c.data_type), c.allow_null)
                for c in stmt.columns
            ])
        elif stmt.file_type == ast.FileType.Parquet:
            schema = None  # inferred from file metadata
        else:
            raise PlanError(
                f"CREATE EXTERNAL TABLE ... STORED AS {stmt.file_type.value} "
                "requires an explicit column list"
            )
        if stmt.file_type == ast.FileType.CSV:
            self.register_csv(stmt.name, stmt.location, schema, stmt.header_row)
        elif stmt.file_type == ast.FileType.NdJson:
            self.register_ndjson(stmt.name, stmt.location, schema)
        else:
            self.register_parquet(stmt.name, stmt.location, schema)
        return DdlResult(f"Registered table {stmt.name}")

    def serve(self, **kwargs):
        """A started serving front door over this context
        (`serve.Server`: admission, pinned tables, megabatching); stop it
        with `stop()` or use it as a context manager."""
        from datafusion_tpu_torch.serve import Server

        return Server(self, **kwargs).start()

    def ingest(self, wal_dir: Optional[str] = None):
        """This context's streaming-ingest state (ingest/: appendable
        tables, materialized views, the durable ingest log), created on
        first use.  `wal_dir` (or ``DATAFUSION_TPU_INGEST_WAL_DIR``)
        turns durability on; pass it on the FIRST call, later calls
        return the existing instance."""
        ing = getattr(self, "_ingest", None)
        if ing is None:
            import os

            from datafusion_tpu_torch.ingest import IngestContext

            if wal_dir is None:
                wal_dir = os.environ.get("DATAFUSION_TPU_INGEST_WAL_DIR") or None
            ing = self._ingest = IngestContext(self, wal_dir=wal_dir)
        return ing

    # -- result caching (cache/) --
    def query_fingerprint(self, plan: LogicalPlan) -> str:
        """Canonical identity of `plan`'s result under this context's
        catalog state: the plan's wire JSON, each scanned table's
        catalog version, its source's data version and data identity
        (an externally rewritten file or a grown table must not serve
        stale rows), the device, the batch size and the functions
        version."""
        from datafusion_tpu_torch.cache import plan_fingerprint

        versions: dict[str, list] = {}
        for t in scan_tables(plan):
            entry: list = [self.catalog_version(t)]
            ds = self.datasources.get(t)
            if ds is not None:
                dv = getattr(ds, "data_version", None)
                if dv is not None:
                    entry.append(["data", int(dv)])
                entry.append(repr(ds.data_identity))
            versions[t] = entry
        return plan_fingerprint(plan, versions, extra={
            "device": str(self.device),
            "batch_size": self.batch_size,
            "functions_v": self._functions_version,
        })

    @property
    def result_cache(self):
        """The context's result CacheStore (None when caching is off)."""
        return self._result_cache

    def _record_history(self, fingerprint: str, summary: dict,
                        root: Optional[Relation] = None) -> None:
        entry = {"fingerprint": fingerprint, "ts": time.time(), **summary}
        if root is not None:
            from datafusion_tpu_torch.obs import trace as obs_trace

            if obs_trace.enabled():
                from datafusion_tpu_torch.obs.stats import collect_tree

                entry["operators"] = [
                    {"op": rel.op_label(), "depth": depth, **rel.stats.snapshot()}
                    for depth, rel in collect_tree(root)
                ]
        hist = self._stats_history.setdefault(fingerprint, [])
        hist.append(entry)
        del hist[: -self._history_cap]
        # bound the distinct fingerprints too (parameterized SQL mints
        # one per literal): drop the oldest-inserted beyond the cap
        while len(self._stats_history) > self._history_fingerprints:
            try:
                self._stats_history.pop(next(iter(self._stats_history)), None)
            except (StopIteration, RuntimeError):
                break

    def stats_history(self, fingerprint: Optional[str] = None):
        """Per-query run history keyed by plan fingerprint: each entry
        records rows, wall seconds and whether it was a cache hit, and on
        traced runs (EXPLAIN ANALYZE, DATAFUSION_TPU_TRACE=1) the
        operators' stats.  With a fingerprint, that query's runs (oldest
        first); without, the whole mapping."""
        if fingerprint is not None:
            return list(self._stats_history.get(fingerprint, ()))
        return {k: list(v) for k, v in self._stats_history.items()}

    def execute(self, plan: LogicalPlan, build_pins: Optional[set] = None,
                verified: bool = False) -> Relation:
        """Map a logical plan onto operators (reference `context.rs:103`).
        Counts `queries_admitted` once per plan.  The plan passes the
        static verifier first (`_verify`) unless `verified` says its
        caller ran it (the serving path verifies at submit).  With
        `build_pins` (a set; the serving path passes one) each join of
        the plan pins its build under `_build_key` and the key is added
        to the set, so the caller can release the pins; without it
        nothing pins.

        The result-cache seam (module docstring): a cached fingerprint
        replays (`CachedResultRelation`, no verify: the miss that filled
        it verified this exact plan); a miss lowers with a capture hook
        attached.  A call nested in another on this thread lowers
        straight through."""
        tls = self._execute_tls
        if getattr(tls, "in_execute", False):
            return self._lower_with(plan, build_pins)
        tls.in_execute = True
        try:
            METRICS.add("queries_admitted")
            store = self._result_cache
            fp = None
            if store is not None:
                try:
                    fp = self.last_fingerprint = self.query_fingerprint(plan)
                except (NotImplementedError, PlanError):
                    fp = None  # a plan with no wire form runs uncached
            if fp is not None:
                from datafusion_tpu_torch.cache.result import CachedResultRelation

                entry = store.get(fp)
                if entry is not None:
                    return CachedResultRelation(
                        plan.schema, entry, fp,
                        on_complete=lambda s: self._record_history(fp, s),
                        batch_size=self.batch_size,
                    )
            if not verified:
                self._verify(plan)
            rel = self._lower_with(plan, build_pins)
            if fp is not None:
                from datafusion_tpu_torch.cache.result import attach_result_capture

                attach_result_capture(
                    rel, store, fp, tags=scan_tables(plan),
                    on_complete=lambda s: self._record_history(fp, s, root=rel),
                )
            return rel
        finally:
            tls.in_execute = False

    def _lower_with(self, plan: LogicalPlan, build_pins: Optional[set]) -> Relation:
        """`_lower` with this thread's join-build pin set."""
        prev = getattr(_LOWERING, "build_pins", None)
        _LOWERING.build_pins = build_pins
        try:
            return self._lower(plan)
        finally:
            _LOWERING.build_pins = prev

    def _verify(self, plan: LogicalPlan) -> None:
        """Static verification of a plan before it is lowered
        (DATAFUSION_TPU_VERIFY=0 skips it); raises
        PlanVerificationError."""
        if not _averify.verify_enabled():
            return
        with METRICS.timer("verify"):
            _averify.check_plan(plan, functions=self.functions)

    def _build_key(self, plan: Join) -> Optional[str]:
        """The fingerprint a join's build side pins under: its plan, the
        data identity of every table it scans (`DataSource.data_identity`:
        never the name alone), the join keys, the device and the dense
        window (which decides the artifact's route).  None when the
        plan has no wire form (no pin)."""
        from datafusion_tpu_torch.join.relation import _dense_max_slots

        try:
            body = plan.right.to_json()
        except NotImplementedError:
            return None
        tables = []
        for t in scan_tables(plan.right):
            ds = self.datasources.get(t)
            tables.append([t, None if ds is None else repr(ds.data_identity)])
        udfs = sorted((n, id(fm.torch_fn), id(fm.host_fn))
                      for n, fm in self.functions.items())
        text = json.dumps([body, tables, [list(p) for p in plan.on], str(self.device),
                           _dense_max_slots(), repr(udfs)],
                          sort_keys=True, default=repr)
        return "join:" + hashlib.sha256(text.encode()).hexdigest()[:32]

    def _lower(self, plan: LogicalPlan) -> Relation:
        fns = self._torch_functions()
        if fused.fusion_enabled():
            rel = self._execute_fused(plan, fns)
            if rel is not None:
                return rel
        if isinstance(plan, TableScan):
            ds = self.datasources.get(plan.table_name)
            if ds is None:
                raise ExecutionError(f"No datasource registered as {plan.table_name!r}")
            if plan.projection is not None:
                ds = ds.with_projection(plan.projection)
            return DataSourceRelation(ds)
        if isinstance(plan, EmptyRelation):
            return _EmptyRelationExec()
        if isinstance(plan, Selection):
            return PipelineRelation(
                self._lower(plan.input), plan.expr, None, plan.schema,
                self.device, functions=fns,
            )
        if isinstance(plan, Projection):
            # Projection(Selection(x)): one pipeline filters and projects
            if isinstance(plan.input, Selection):
                child = self._lower(plan.input.input)
                pred = plan.input.expr
            else:
                child = self._lower(plan.input)
                pred = None
            return PipelineRelation(
                child, pred, plan.expr, plan.schema, self.device,
                functions=fns, function_metas=self.functions,
            )
        if isinstance(plan, Aggregate):
            # Aggregate(Selection(x)): the predicate runs inside the
            # aggregate operator
            if isinstance(plan.input, Selection):
                child = self._lower(plan.input.input)
                pred = plan.input.expr
            else:
                child = self._lower(plan.input)
                pred = None
            return AggregateRelation(
                child, plan.group_expr, plan.aggr_expr, plan.schema,
                self.device, predicate=pred, functions=fns,
            )
        if isinstance(plan, Sort):
            return SortRelation(
                self._lower(plan.input), plan.expr, plan.schema, self.device
            )
        if isinstance(plan, Limit):
            if isinstance(plan.input, Sort):
                # the sort slices its permutation directly, or keeps a
                # top-k state
                return SortRelation(
                    self._lower(plan.input.input), plan.input.expr,
                    plan.schema, self.device, limit=plan.limit,
                )
            return LimitRelation(self._lower(plan.input), plan.limit, plan.schema)
        if isinstance(plan, Join):
            pins = getattr(_LOWERING, "build_pins", None)
            key = None if pins is None else self._build_key(plan)
            if key is not None:
                pins.add(key)
            return HashJoinRelation(
                self._lower(plan.left), self._lower(plan.right),
                plan.on, plan.join_type, plan.schema, self.device,
                build_key=key,
            )
        raise NotSupportedError(
            f"plan node {type(plan).__name__} is not ported yet (ROADMAP queue 1)"
        )

    def _execute_fused(self, plan: LogicalPlan, fns) -> Optional[Relation]:
        """Collapse a whole chain into ONE operator (exec/fused.py): an
        Aggregate over a filter/project chain, a filter/project chain
        deeper than Projection(Selection(x)), or a [Limit](Sort) over a
        filter and column-projection chain.  Returns None when the plan
        is not such a chain; the caller then lowers node by node."""
        if isinstance(plan, Aggregate):
            hit = fused.rewrite_aggregate(plan)
            if hit is None:
                return None
            base, group_expr, aggr_expr, pred = hit
            checked = ([] if pred is None else [pred]) + [
                a.args[0] for a in aggr_expr if a.args
            ]
            if any(contains_host_fn(e, self.functions) for e in checked):
                return None
            try:
                rel = AggregateRelation(
                    self._lower(base), group_expr, aggr_expr, plan.schema,
                    self.device, predicate=pred, functions=fns,
                )
            except (NotSupportedError, PlanError):
                return None  # an inlined shape the aggregate can't take
            rel._fused_chain = "filter+project+aggregate"  # EXPLAIN ANALYZE's marker
            return rel

        if isinstance(plan, (Selection, Projection)):
            flat = fused.flatten_chain(plan)
            if flat is None:
                return None
            base, pred, proj, n = flat
            # single nodes and Projection(Selection(x)) lower to the
            # same PipelineRelation node by node
            if n <= 1 or (n == 2 and isinstance(plan, Projection)
                          and isinstance(plan.input, Selection)):
                return None
            if pred is not None and contains_host_fn(pred, self.functions):
                return None
            rel = PipelineRelation(
                self._lower(base), pred, proj, plan.schema, self.device,
                functions=fns, function_metas=self.functions,
            )
            rel._fused_chain = f"{n}-node chain"
            return rel

        limit = None
        sort = plan
        if isinstance(plan, Limit) and isinstance(plan.input, Sort):
            limit, sort = plan.limit, plan.input
        if not isinstance(sort, Sort):
            return None
        hit = fused.rewrite_sort(sort, limit)
        if hit is None:
            return None
        base, keys, pred, out_cols = hit
        rel = SortRelation(
            self._lower(base), keys, plan.schema, self.device, limit=limit,
            predicate=pred, output_cols=out_cols,
        )
        rel._fused_chain = "filter+project+sort"
        return rel
