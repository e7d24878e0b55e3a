"""PyTorch/CUDA port: the partitioned mesh context
(`datafusion_tpu_torch.parallel.partition`) against the JAX package's.

The same CSV partitions (the generator of tests/test_partitioned.py,
numpy-seeded) or the same in-memory partitions run through the JAX
package's `PartitionedContext` on the 8 virtual CPU devices conftest
sets up, and through the port's on a mesh of CPU shard slots
(`make_mesh(devices=["cpu"] * n)`).  Ints, strings, NULLs and row order
(after sorting both by their keys) match exactly, floats within rtol
1e-9.  Cases: grouped and global aggregates, a WHERE fused into the
partials, string predicates over shared dictionaries, fewer and more
slots than partitions, filter/project, a `host_fn` projection on the
serial path, sort with LIMIT, Utf8 MIN/MAX, in-memory partitions whose
dictionaries remap, the pack overflow, the dictionary merge that drops
device copies, a state past the grouped reduce's window (sort-merge),
slots of one device sharing one state (the grouped reduce), the states
of two devices combining, warm rounds folding into one pass, and `DATAFUSION_TPU_FUSE=0`
restoring one dispatch a round.  `PlanFragment.to_json_str()` is byte
for byte the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.datasource import CsvDataSource as JaxCsv
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.parallel import PartitionedContext as JaxPartitionedContext
from datafusion_tpu.parallel import PlanFragment as JaxPlanFragment
from datafusion_tpu.parallel import make_mesh as jax_make_mesh

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec.datasource import CsvDataSource, MemoryDataSource
from datafusion_tpu_torch.parallel import (
    PartitionedContext,
    PartitionedDataSource,
    PhysicalPlan,
    PlanFragment,
    make_mesh,
)
from datafusion_tpu_torch.utils.metrics import METRICS

REGIONS = ["north", "south", "east", "west", "centre"]
SQL_GROUPED = ("SELECT region, SUM(qty), COUNT(qty), MIN(price), MAX(price), AVG(price) "
               "FROM sales GROUP BY region")


def _schema(mod):
    T = mod.DataType
    return mod.Schema([mod.Field("region", T.UTF8, False), mod.Field("qty", T.INT64, True),
                       mod.Field("price", T.FLOAT64, False)])


def _write_partitions(tmp_path, n_parts=5, rows_per_part=200, seed=7):
    rng = np.random.default_rng(seed)
    paths = []
    for p in range(n_parts):
        path = tmp_path / f"part{p}.csv"
        lines = ["region,qty,price"]
        for _i in range(rows_per_part):
            region = REGIONS[rng.integers(len(REGIONS))]
            qty = "" if rng.random() < 0.05 else str(int(rng.integers(-50, 500)))
            lines.append(f"{region},{qty},{rng.random() * 100:.4f}")
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    return _write_partitions(tmp_path_factory.mktemp("torch_parts"))


def _contexts(paths, n_slots=8):
    jctx = JaxPartitionedContext(mesh=jax_make_mesh(n_slots), batch_size=64,
                                 result_cache=False)
    jctx.register_partitioned_csv("sales", paths, _schema(jdf))
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * n_slots), batch_size=64,
                              result_cache=False)
    tctx.register_partitioned_csv("sales", paths, _schema(tdf))
    return jctx, tctx


def _same(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        if math.isnan(w) or math.isnan(g):
            return math.isnan(w) and math.isnan(g)
        return math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return g == w and type(g) is type(w)


def assert_same_rows(got, want, key_cols=None, ordered=False):
    """Port rows == JAX rows: ints, strings and NULLs exactly, floats
    within rtol 1e-9; sorted by the first `key_cols` columns (all when
    None) unless `ordered`."""
    g_rows, w_rows = got.to_rows(), want.to_rows()
    if not ordered:
        def key(r):
            return repr(r if key_cols is None else r[:key_cols])
        g_rows, w_rows = sorted(g_rows, key=key), sorted(w_rows, key=key)
    assert len(g_rows) == len(w_rows), (len(g_rows), len(w_rows))
    for g, w in zip(g_rows, w_rows):
        assert len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)), (g, w)
    return g_rows


def _both(jctx, tctx, sql):
    return tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql))


AGG_CASES = [
    (SQL_GROUPED, 1),
    ("SELECT SUM(price), COUNT(price), MIN(qty), MAX(qty) FROM sales", 0),
    ("SELECT region, COUNT(price), SUM(price) FROM sales WHERE qty > 100 GROUP BY region", 1),
    ("SELECT COUNT(price) FROM sales WHERE region = 'north'", 0),
    ("SELECT region, MIN(region), MAX(region), COUNT(1) FROM sales "
     "WHERE region <> 'east' GROUP BY region", 1),
    ("SELECT qty, COUNT(1), SUM(price) FROM sales GROUP BY qty", 1),
]


@pytest.mark.parametrize("n_slots", [8, 2])
@pytest.mark.parametrize("sql,keys", AGG_CASES)
def test_aggregate_matches_jax(parts, sql, keys, n_slots):
    """Grouped and global aggregates, a fused WHERE, a string predicate
    over the shared dictionaries, Utf8 MIN/MAX: 8 slots (more than the 5
    partitions) and 2 (fewer)."""
    jctx, tctx = _contexts(parts, n_slots)
    got, want = _both(jctx, tctx, sql)
    assert type(tctx.sql(sql)).__name__ == "PartitionedAggregateRelation"
    assert_same_rows(got, want, key_cols=keys or None)


def test_more_slots_than_partitions(parts):
    jctx, tctx = _contexts(parts[:3], 8)
    got, want = _both(jctx, tctx, SQL_GROUPED)
    assert_same_rows(got, want, key_cols=1)


PIPE_CASES = [
    "SELECT region, price * 2.0, qty FROM sales WHERE price > 30.0 AND qty > 100",
    "SELECT region, qty, price FROM sales WHERE qty > 250",
    "SELECT region, price FROM sales WHERE region = 'north'",
    "SELECT price, qty FROM sales WHERE price < 20.0",
]


@pytest.mark.parametrize("sql", PIPE_CASES)
def test_filter_project_matches_jax(parts, sql):
    """Filter/project: one pass a round on the mesh, as many rows as
    the JAX package's mesh pipeline."""
    jctx, tctx = _contexts(parts)
    METRICS.reset()
    got, want = _both(jctx, tctx, sql)
    assert METRICS.snapshot()["timings_s"].get("execute.partitioned_pipeline", 0) > 0
    assert_same_rows(got, want)


def test_host_fn_projection_falls_back_to_serial(parts):
    jctx, tctx = _contexts(parts)

    def tag(x):
        return np.asarray([f"p{v:.0f}" for v in x], dtype=object)

    jctx.register_udf("tagit", [jdf.DataType.FLOAT64], jdf.DataType.UTF8, host_fn=tag)
    tctx.register_udf("tagit", [tdf.DataType.FLOAT64], tdf.DataType.UTF8, host_fn=tag)
    METRICS.reset()
    got, want = _both(jctx, tctx, "SELECT region, tagit(price) FROM sales WHERE qty > 400")
    assert METRICS.snapshot()["timings_s"].get("execute.partitioned_pipeline", 0) == 0
    assert_same_rows(got, want)


def test_sort_limit_over_partitions(parts):
    jctx, tctx = _contexts(parts)
    got, want = _both(jctx, tctx, "SELECT price, region FROM sales ORDER BY price DESC LIMIT 5")
    assert_same_rows(got, want, ordered=True)


def test_fragments_byte_equal_to_jax(parts):
    """The fragments each context ships (and round-trips) are the JAX
    package's bytes, and a fragment of either package parses in the
    other."""
    jctx, tctx = _contexts(parts)
    jctx.sql_collect(SQL_GROUPED)
    tdf.collect(tctx.sql(SQL_GROUPED))
    assert len(tctx.last_fragments) == len(parts)
    for tf, jf in zip(tctx.last_fragments, jctx.last_fragments):
        assert tf.to_json_str() == jf.to_json_str()
        assert PlanFragment.from_json_str(jf.to_json_str()).to_json_str() == jf.to_json_str()
        assert JaxPlanFragment.from_json_str(tf.to_json_str()).to_json_str() == tf.to_json_str()
        assert tf.table_names() == jf.table_names() == ["sales"]
        assert tf.logical_plan().schema.names() == jf.logical_plan().schema.names()


def test_physical_plan_json_matches_jax():
    from datafusion_tpu.parallel import PhysicalPlan as JaxPhysicalPlan
    from datafusion_tpu.plan.logical import EmptyRelation as JaxEmpty

    from datafusion_tpu_torch.plan.logical import EmptyRelation

    for kw in ({"kind": "interactive"},
               {"kind": "write", "filename": "/tmp/out.csv", "file_format": "csv"},
               {"kind": "show", "count": 10}):
        tp = PhysicalPlan(plan=EmptyRelation(tdf.Schema([])), **kw)
        jp = JaxPhysicalPlan(plan=JaxEmpty(jdf.Schema([])), **kw)
        assert tp.to_json() == jp.to_json()
        rt = PhysicalPlan.from_json(jp.to_json())
        assert (rt.kind, rt.filename, rt.count) == (jp.kind, jp.filename, jp.count)


# ------------------------------------------------------- in-memory partitions


class _Api:
    """One package's batch and source constructors, by the same names."""

    def __init__(self, mod, batch, datasource):
        self.__name__ = mod.__name__
        self.DataType, self.Field, self.Schema = mod.DataType, mod.Field, mod.Schema
        self.ExecutionContext = mod.ExecutionContext
        self.StringDictionary = batch.StringDictionary
        self.make_host_batch = batch.make_host_batch
        self.MemoryDataSource = datasource.MemoryDataSource


def _apis():
    import datafusion_tpu.exec.batch as jb
    import datafusion_tpu.exec.datasource as jd

    import datafusion_tpu_torch.exec.batch as tb
    import datafusion_tpu_torch.exec.datasource as td

    return _Api(jdf, jb, jd), _Api(tdf, tb, td)


JAPI, TAPI = _apis()


def _mem_part(mod, schema, strings, ints):
    mod = JAPI if mod is jdf else TAPI
    d = mod.StringDictionary()
    batch = mod.make_host_batch(schema, [d.encode(strings), np.asarray(ints, np.int64)],
                                [None, None], [d, None])
    return mod.MemoryDataSource(schema, [batch])


def _two_schemas():
    return [m.Schema([m.Field("region", m.DataType.UTF8, False),
                      m.Field("qty", m.DataType.INT64, False)]) for m in (jdf, tdf)]


def test_memory_partitions_remap_string_codes():
    """p0 assigns north=0, south=1; p1 south=0, north=1: the codes remap
    into one dictionary at registration, in both packages."""
    js, ts = _two_schemas()
    sql = "SELECT region, SUM(qty) FROM t GROUP BY region"
    jctx = JaxPartitionedContext(mesh=jax_make_mesh(2), result_cache=False)
    jctx.register_datasource("t", _jax_pds([
        _mem_part(jdf, js, ["north", "north", "south"], [1, 2, 300]),
        _mem_part(jdf, js, ["south", "north"], [4, 1000])]))
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * 2), result_cache=False)
    tctx.register_datasource("t", PartitionedDataSource([
        _mem_part(tdf, ts, ["north", "north", "south"], [1, 2, 300]),
        _mem_part(tdf, ts, ["south", "north"], [4, 1000])]))
    got, want = _both(jctx, tctx, sql)
    assert sorted(got.to_rows()) == sorted(want.to_rows()) == [("north", 1003), ("south", 304)]


def _jax_pds(parts):
    from datafusion_tpu.parallel.partition import PartitionedDataSource as JaxPDS

    return JaxPDS(parts)


def test_merge_codes_invalidates_device_cache():
    """A query before the partitioned registration leaves device copies
    of the pre-merge codes; the merge must drop them."""
    js, ts = _two_schemas()
    got = {}
    for mod, schema, ctx_cls, mesh, pds in (
            (jdf, js, JaxPartitionedContext, lambda: jax_make_mesh(2), _jax_pds),
            (tdf, ts, PartitionedContext, lambda: make_mesh(devices=["cpu"] * 2),
             PartitionedDataSource)):
        p0 = _mem_part(mod, schema, ["a", "b"], [1, 1])
        p1 = _mem_part(mod, schema, ["b", "a"], [1, 1])  # opposite code order
        single = mod.ExecutionContext(device="cpu", result_cache=False)
        single.register_datasource("t0", p1)
        before = single.sql_collect("SELECT SUM(qty) FROM t0 WHERE region = 'b'").to_rows()
        pctx = ctx_cls(mesh=mesh(), result_cache=False)
        pctx.register_datasource("t", pds([p0, p1]))
        after = pctx.sql_collect("SELECT SUM(qty) FROM t WHERE region = 'b'").to_rows()
        got[mod.__name__] = (before, after)
    assert got["datafusion_tpu_torch"] == got["datafusion_tpu"] == ([(1,)], [(2,)])


def _utf8_parts(mod, seed=23, n_parts=4, rows=300):
    mod = JAPI if mod is jdf else TAPI
    schema = mod.Schema([mod.Field("k", mod.DataType.INT64, False),
                         mod.Field("name", mod.DataType.UTF8, True)])
    rng = np.random.default_rng(seed)
    parts = []
    for _p in range(n_parts):
        d = mod.StringDictionary()
        names = [f"name_{int(i):03d}" for i in rng.integers(0, 200, rows)]
        valid = rng.random(rows) > 0.1
        cols = [rng.integers(0, 5, rows).astype(np.int64), d.encode(names)]
        parts.append(mod.MemoryDataSource(
            schema, [mod.make_host_batch(schema, cols, [None, valid], [None, d])]))
    return parts


def test_utf8_minmax_over_mesh():
    """MIN/MAX(Utf8) meet in rank space across the shard axis (codes are
    shared after registration)."""
    sql = "SELECT k, MIN(name), MAX(name), COUNT(name) FROM t GROUP BY k"
    jctx = JaxPartitionedContext(mesh=jax_make_mesh(4), result_cache=False)
    jctx.register_datasource("t", _jax_pds(_utf8_parts(jdf)))
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * 4), result_cache=False)
    tctx.register_datasource("t", PartitionedDataSource(_utf8_parts(tdf)))
    got, want = _both(jctx, tctx, sql)
    assert_same_rows(got, want, key_cols=1)


def test_pack_overflow_keeps_groups_distinct():
    """The mixed-radix pack bails (not wraps) when an int64 key spans
    more than 63 bits, in both encoders."""
    from datafusion_tpu.exec.aggregate import GroupKeyEncoder as JaxEncoder

    from datafusion_tpu_torch.exec.aggregate import GroupKeyEncoder

    k0 = np.asarray([-(2**62), 2**62, -(2**62), 2**62], dtype=np.int64)
    k1 = np.asarray([0, 0, 1, 1], dtype=np.int64)
    ids = GroupKeyEncoder(2).encode([k0, k1], [None, None])
    assert len(set(ids.tolist())) == 4
    assert ids.tolist() == JaxEncoder(2).encode([k0, k1], [None, None]).tolist()


def _kv_parts(mod, seed, n_parts, n_batches, rows, groups=6):
    mod = JAPI if mod is jdf else TAPI
    schema = mod.Schema([mod.Field("k", mod.DataType.INT64, False),
                         mod.Field("v", mod.DataType.FLOAT64, False)])
    rng = np.random.default_rng(seed)
    return [
        mod.MemoryDataSource(schema, [
            mod.make_host_batch(schema, [rng.integers(0, groups, rows).astype(np.int64),
                                         rng.uniform(0, 10, rows)])
            for _ in range(n_batches)
        ])
        for _p in range(n_parts)
    ]


def _record_routes(monkeypatch):
    """The state length of every grouped-reduce update and of every
    sort-merge update the aggregate core makes."""
    from datafusion_tpu_torch.exec.aggregate import _AggregateCore

    seen = {"kernel": [], "sortmerge": []}
    kernel_update = _AggregateCore._kernel_update
    sortmerge_update = _AggregateCore._sortmerge_update

    def on_kernel(self, envs, capacity, masks, ids, states, *a, **kw):
        seen["kernel"].append(states[0][0].shape[0])
        return kernel_update(self, envs, capacity, masks, ids, states, *a, **kw)

    def on_sortmerge(self, env, capacity, mask, ids, counts, *a, **kw):
        seen["sortmerge"].append(counts.shape[0])
        return sortmerge_update(self, env, capacity, mask, ids, counts, *a, **kw)

    monkeypatch.setattr(_AggregateCore, "_kernel_update", on_kernel)
    monkeypatch.setattr(_AggregateCore, "_sortmerge_update", on_sortmerge)
    return seen


def _kv_contexts(seed, n_slots, groups):
    jctx = JaxPartitionedContext(mesh=jax_make_mesh(n_slots), result_cache=False)
    jctx.register_datasource("t", _jax_pds(_kv_parts(jdf, seed, 4, 2, 2048, groups=groups)))
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * n_slots), result_cache=False)
    tctx.register_datasource("t", PartitionedDataSource(_kv_parts(tdf, seed, 4, 2, 2048,
                                                                  groups=groups)))
    return jctx, tctx


def test_state_past_the_grouped_reduce_window(monkeypatch):
    """The second round's groups grow the state past agg_max_groups()
    (8192): that round takes the sort-merge route and the answer agrees
    with the JAX mesh."""
    sql = "SELECT k, SUM(v), MIN(v), COUNT(1) FROM t GROUP BY k"
    jctx, tctx = _kv_contexts(5, 4, 30000)
    monkeypatch.setenv("DATAFUSION_TPU_COST", "0")
    seen = _record_routes(monkeypatch)
    got, want = _both(jctx, tctx, sql)
    assert_same_rows(got, want, key_cols=1)
    assert seen["sortmerge"] and min(seen["sortmerge"]) > 8192


def test_slots_on_one_device_share_one_state(monkeypatch):
    """4 slots of one device and 3000 groups: the device holds ONE state
    of G = 4096 groups, not one a slot, so every round stays on the
    grouped reduce, as a single context's aggregate would."""
    sql = "SELECT k, SUM(v), MIN(v), COUNT(1) FROM t GROUP BY k"
    jctx, tctx = _kv_contexts(5, 4, 3000)
    monkeypatch.setenv("DATAFUSION_TPU_COST", "0")
    seen = _record_routes(monkeypatch)
    got, want = _both(jctx, tctx, sql)
    assert_same_rows(got, want, key_cols=1)
    assert seen["kernel"] and set(seen["kernel"]) == {4096}
    assert not seen["sortmerge"]


@pytest.mark.parametrize("sql,keys", AGG_CASES[:2] + AGG_CASES[4:5])
def test_states_of_two_devices_combine(parts, sql, keys):
    """Slots on two devices ("cpu" and "cpu:0" name two on the CPU):
    each device folds its slots into its own state, and the states
    combine in device order on the first slot's device (SUM and COUNT
    add, MIN and MAX meet, Utf8 MIN/MAX in rank space)."""
    jctx, _ = _contexts(parts, n_slots=4)
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu", "cpu:0"] * 2), batch_size=64,
                              result_cache=False)
    tctx.register_partitioned_csv("sales", parts, _schema(tdf))
    got, want = _both(jctx, tctx, sql)
    assert_same_rows(got, want, key_cols=keys)
    again = tdf.collect(tctx.sql(sql))
    assert sorted(map(repr, again.to_rows())) == sorted(map(repr, got.to_rows()))


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in METRICS.counts.items()}


def test_warm_rounds_fold_into_one_launch():
    """Consecutive warm rounds (round cache hits) of one shape fold into
    ONE pass, with the per-round answers (f64 within rtol 1e-9, and bit
    for bit from one folded run to the next); the JAX package's
    launch-count contract (tests/test_partitioned.py) holds for the
    port's passes."""
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * 4), result_cache=False)
    tctx.register_datasource("t", PartitionedDataSource(_kv_parts(tdf, 11, 4, 3, 512)))
    jctx = JaxPartitionedContext(mesh=jax_make_mesh(4), result_cache=False)
    jctx.register_datasource("t", _jax_pds(_kv_parts(jdf, 11, 4, 3, 512)))
    sql = "SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k"
    rel = tctx.sql(sql)
    want = tdf.collect(rel)
    assert_same_rows(want, jax_collect(jctx.sql(sql)), key_cols=1)
    assert_same_rows(tdf.collect(rel), want, key_cols=1)  # admit the rounds
    before = dict(METRICS.counts)
    got = tdf.collect(rel)  # warm: the multi-round fold
    delta = _delta(before)
    # the fold sums a group's rows of every round in one pass: the f64
    # additions associate otherwise than round by round
    assert_same_rows(got, want, key_cols=1)
    again = tdf.collect(rel)  # the same path twice: the same bits
    assert sorted(again.to_rows()) == sorted(got.to_rows())
    assert delta.get("mesh.round_cache_hits", 0) >= 3
    assert delta.get("mesh.fused_rounds", 0) >= 3
    assert delta.get("mesh.fused_round_launches", 0) == 1
    assert delta.get("device.launches.mesh.stacked", 0) == 0


def test_fuse_off_restores_per_round_dispatch(monkeypatch):
    """DATAFUSION_TPU_FUSE=0: warm rounds dispatch one pass each, same
    answers."""
    tctx = PartitionedContext(mesh=make_mesh(devices=["cpu"] * 2), result_cache=False)
    tctx.register_datasource("t", PartitionedDataSource(_kv_parts(tdf, 12, 2, 2, 256)))
    rel = tctx.sql("SELECT k, SUM(v) FROM t GROUP BY k")
    want = sorted(tdf.collect(rel).to_rows())
    assert sorted(tdf.collect(rel).to_rows()) == want
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", "0")
    before = dict(METRICS.counts)
    assert sorted(tdf.collect(rel).to_rows()) == want
    delta = _delta(before)
    assert delta.get("mesh.fused_round_launches", 0) == 0
    assert delta.get("device.launches.mesh.stacked", 0) == 2


def test_mesh_needs_a_device_or_slots():
    """`make_mesh()` means the visible CUDA devices: without CUDA it
    raises, as `ExecutionContext()` does, and past the visible count
    too; named slots may repeat a device."""
    import torch

    from datafusion_tpu_torch.errors import ExecutionError

    if not torch.cuda.is_available():
        with pytest.raises(ExecutionError, match="CUDA"):
            make_mesh()
        with pytest.raises(ExecutionError, match="CUDA"):
            PartitionedContext()
    with pytest.raises(ExecutionError, match="requested mesh of 3"):
        make_mesh(3, devices=["cpu", "cpu"])
    assert make_mesh(devices=["cpu"] * 3).size == 3


def test_memory_source_has_no_wire_form():
    from datafusion_tpu_torch.errors import PlanError

    (part,) = _kv_parts(tdf, 1, 1, 1, 8)
    with pytest.raises(PlanError):
        part.to_meta()
    csv = CsvDataSource("x.csv", tdf.Schema([tdf.Field("a", tdf.DataType.INT64, False)]))
    jcsv = JaxCsv("x.csv", jdf.Schema([jdf.Field("a", jdf.DataType.INT64, False)]))
    assert csv.to_meta() == jcsv.to_meta()
    assert isinstance(part, MemoryDataSource)
