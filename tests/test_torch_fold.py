"""PyTorch/CUDA port, slice 8: the batch-group fold, against the JAX
package.

The same SQL on the same numpy-seeded tables (and CSV files) runs
through `datafusion_tpu`, with fusion on at its default group, and
through `datafusion_tpu_torch` at fold sizes 1, 2 and 256
(DATAFUSION_TPU_FUSE_GROUP), both with `device="cpu"`, so the port's
kernels run their plain versions.  The port folds a batch group in one
pass (`_AggregateCore.fused_group`, one TopK merge, `_PipelineCore.
run_group`); each case counts those passes.

Cases: the aggregate on both routes (the grouped reduce, and sort-merge
forced with DATAFUSION_TPU_PALLAS_AGG_GROUPS=0) with NULL keys and
arguments; a WHERE that empties whole batches; a string MIN/MAX over a
CSV whose dictionary grows mid-scan, where the group splits at each
growth; the TopK with ties across batches, NaN and NULL keys and k
above one batch's live rows; the pipeline, whose output batches keep
the boundaries, `num_rows` and masks of DATAFUSION_TPU_FUSE=0.  The
signature helpers of `exec/fused.py` on their own.

Tolerances: ints, strings, NULLs and order exactly; f64 within rtol
1e-9 (the fold sums a group's rows in another order than the JAX
package's `lax.scan`).  The fold's f64 results are bit-identical over
two runs, and DATAFUSION_TPU_FUSE=0 gives the per-batch path's state
byte for byte.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import datafusion_tpu as jdf

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import fused
from datafusion_tpu_torch.exec.aggregate import _AggregateCore
from datafusion_tpu_torch.exec.batch import (
    device_inputs,
    param_tensors,
    subset_view,
    to_host,
)
from datafusion_tpu_torch.exec.cuda import sort_kernel
from datafusion_tpu_torch.exec.relation import _PipelineCore

from test_torch_pipeline import T, assert_same, contexts, jax_collect, jax_table

ROUTE_ENV = "DATAFUSION_TPU_PALLAS_AGG_GROUPS"
FOLD_ENV = "DATAFUSION_TPU_FUSE_GROUP"
FOLDS = ["1", "2", "256"]
AGG_SQL = ("SELECT k, SUM(v), AVG(v), MIN(v), MAX(i), COUNT(v), COUNT(1), MIN(s), "
           "MAX(s) FROM t GROUP BY k")


@pytest.fixture
def passes(monkeypatch):
    """Entries of each `fused_group` pass of the aggregate."""
    seen = []
    real = _AggregateCore.fused_group

    def spy(self, entries, *a):
        seen.append(len(entries))
        return real(self, entries, *a)

    monkeypatch.setattr(_AggregateCore, "fused_group", spy)
    return seen


def _split(n_batches, fold):
    """Entries per pass when `n_batches` batches fold `fold` at a time."""
    return [min(fold, n_batches - lo) for lo in range(0, n_batches, fold)]


def agg_table(n=20_000, groups=300, seed=31, batch_rows=2048):
    """int64 key k and f64 v with NULLs in every batch, int64 i, Utf8 s."""
    rng = np.random.default_rng(seed)
    words = np.array(["ash", "birch", "cedar", "oak", "elm", "fir", "yew"], dtype=object)
    cols = [rng.integers(0, groups, n), rng.normal(size=n) * 100, rng.integers(-50, 50, n),
            words[rng.integers(0, 7, n)], np.arange(n)]
    validity = [rng.random(n) > 0.03, rng.random(n) > 0.1, None, None, None]
    return jax_table([("k", T.INT64, True), ("v", T.FLOAT64, True), ("i", T.INT64, False),
                      ("s", T.UTF8, False), ("tag", T.INT64, False)],
                     cols, validity, batch_rows)


def run_port_and_jax(monkeypatch, src, sql, fold, route=None, batch_size=131072):
    """The JAX package's rows (fusion at its default), then the port's
    at fold size `fold` on the route `route` forces."""
    jctx, tctx = contexts(src, batch_size=batch_size)
    want = jax_collect(jctx.sql(sql))
    monkeypatch.setenv(FOLD_ENV, fold)
    if route is not None:
        monkeypatch.setenv(ROUTE_ENV, route)
    return want, tdf.collect(tctx.sql(sql)), tctx


# ------------------------------------------------------------ aggregate


@pytest.mark.parametrize("route", [None, "0"], ids=["grouped-reduce", "sort-merge"])
@pytest.mark.parametrize("fold", FOLDS)
def test_aggregate_matches_the_jax_package(monkeypatch, passes, route, fold):
    want, got, _ = run_port_and_jax(monkeypatch, agg_table(), AGG_SQL, fold, route)
    rows = assert_same(got, want, ordered=False)
    assert any(r[0] is None for r in rows) and len(rows) == 301
    assert passes == _split(10, int(fold))


@pytest.mark.parametrize("route", [None, "0"], ids=["grouped-reduce", "sort-merge"])
@pytest.mark.parametrize("fold", FOLDS)
def test_where_that_empties_whole_batches(monkeypatch, passes, route, fold):
    sql = ("SELECT k, SUM(v), MIN(i), COUNT(1), MAX(s) FROM t "
           "WHERE tag < 3000 OR tag >= 15000 GROUP BY k")
    want, got, _ = run_port_and_jax(monkeypatch, agg_table(), sql, fold, route)
    assert_same(got, want, ordered=False)
    assert passes == _split(10, int(fold))  # empty batches still fold


@pytest.mark.parametrize("route", [None, "0"], ids=["grouped-reduce", "sort-merge"])
def test_fold_f64_bit_identical_over_two_runs(monkeypatch, passes, route):
    if route is not None:
        monkeypatch.setenv(ROUTE_ENV, route)
    _, tctx = contexts(agg_table(seed=32))
    first, second = (tdf.collect(tctx.sql(AGG_SQL)) for _ in range(2))
    for i in (1, 2, 3):
        a, b = (np.asarray(t.columns[i]).view(np.int64) for t in (first, second))
        assert np.array_equal(a, b)
    assert passes == [10, 10]


def _per_batch_state(rel):
    """The aggregate's state as the per-batch path makes it: one update
    of one batch at a time, the capacity picked after each encode."""
    core, dev = rel.core, rel.device
    params = param_tensors(rel._param_values, dev)
    state, capacity = None, 0
    for batch in rel.child.batches():
        ids, n_groups = rel._group_ids(batch)
        aux, str_aux = rel._aux(batch)
        data, validity, mask = device_inputs(subset_view(batch, core.used_cols), dev)
        needed = rel._pick_capacity(n_groups, capacity)
        if state is None:
            state = core._init_state(needed, dev)
        elif needed > capacity:
            state = core._grow_state(state, needed)
        capacity = needed
        state = core.fused_group([(data, validity, batch.num_rows, mask, ids)], state,
                                 aux, str_aux, params)
    return state


@pytest.mark.parametrize("route", [None, "256"], ids=["grouped-reduce", "crossing"])
def test_fuse_off_is_the_per_batch_path_byte_for_byte(monkeypatch, route):
    if route is not None:
        monkeypatch.setenv(ROUTE_ENV, route)
    _, tctx = contexts(agg_table(groups=2000, seed=33))
    want = _per_batch_state(tctx.sql(AGG_SQL))
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", "0")
    got = tctx.sql(AGG_SQL).accumulate()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                                  b.contiguous().view(torch.uint8))


def _growing_csv(path, seed=41, batch_rows=1024):
    """A CSV whose Utf8 column brings new strings in batches 0, 1, 3 and
    5 of 6: the reader's dictionary grows mid-scan.  Returns the
    dictionary's version after each batch."""
    rng = np.random.default_rng(seed)
    new_at = {0: 10, 1: 5, 3: 5, 5: 2}
    words, versions, lines = [], [], ["k,s,v"]
    for b in range(6):
        fresh = [f"w{len(words) + j:02d}" for j in range(new_at.get(b, 0))]
        words += fresh
        versions.append(len(words))
        picks = fresh + [words[j] for j in rng.integers(0, len(words),
                                                         batch_rows - len(fresh))]
        for s in picks:
            lines.append(f"{rng.integers(0, 40)},{s},{rng.normal() * 10:.6f}")
    path.write_text("\n".join(lines) + "\n")
    return versions


def _groups_of(versions):
    """Entries per pass: a new pass wherever the dictionary grew."""
    runs = [1]
    for a, b in zip(versions, versions[1:]):
        if a == b:
            runs[-1] += 1
        else:
            runs.append(1)
    return runs


def _csv_contexts(path, batch_size=1024):
    jschema = jdf.Schema([jdf.Field("k", T.INT64, False), jdf.Field("s", T.UTF8, False),
                          jdf.Field("v", T.FLOAT64, False)])
    tschema = tdf.Schema([tdf.Field("k", tdf.DataType.INT64, False),
                          tdf.Field("s", tdf.DataType.UTF8, False),
                          tdf.Field("v", tdf.DataType.FLOAT64, False)])
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch_size)
    jctx.register_csv("t", str(path), jschema, has_header=True)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch_size)
    tctx.register_csv("t", str(path), tschema, has_header=True)
    return jctx, tctx


@pytest.mark.parametrize("route", [None, "0"], ids=["grouped-reduce", "sort-merge"])
def test_string_min_max_over_a_growing_dictionary_splits_the_group(
        tmp_path, monkeypatch, passes, route):
    versions = _growing_csv(tmp_path / "grow.csv")
    if route is not None:
        monkeypatch.setenv(ROUTE_ENV, route)
    jctx, tctx = _csv_contexts(tmp_path / "grow.csv")
    sql = "SELECT k, MIN(s), MAX(s), SUM(v), COUNT(1) FROM t WHERE s > 'w03' GROUP BY k"
    rows = assert_same(tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql)),
                       ordered=False)
    assert len(rows) == 40 and max(r[2] for r in rows) == "w21"
    assert passes == _groups_of(versions) == [1, 2, 2, 1]


# ------------------------------------------------------------ TopK


@pytest.fixture
def merges(monkeypatch):
    """Keys of each TopK merge."""
    seen = []
    real = sort_kernel.argsort_multi

    def counted(ops):
        seen.append(ops[0].shape[0])
        return real(ops)

    monkeypatch.setattr(sort_kernel, "argsort_multi", counted)
    return seen


def topk_table(n=12_000, seed=51, batch_rows=1024):
    """An f64 key with heavy ties across batches, NaN and NULLs; a
    16-value int key; a unique tag."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-5, 5, n).astype(np.float64) / 2
    f[rng.random(n) < 0.02] = np.nan
    cols = [f, rng.integers(0, 16, n), np.arange(n)]
    validity = [rng.random(n) > 0.05, None, None]
    return jax_table([("f", T.FLOAT64, True), ("g", T.INT64, False),
                      ("tag", T.INT64, False)], cols, validity, batch_rows)


@pytest.mark.parametrize("sql,live_batches,tail", [
    ("SELECT f, g, tag FROM t ORDER BY f DESC LIMIT 3000", 12, False),
    ("SELECT f, g, tag FROM t ORDER BY f LIMIT 3000", 12, False),
    # NaN after every number, then NULLs
    ("SELECT f, g, tag FROM t ORDER BY f DESC LIMIT 11900", 12, True),
    ("SELECT f, g, tag FROM t ORDER BY g DESC, f LIMIT 2500", 12, True),
    # k above one batch's live rows; the batches of tags 4096-8191 hold none
    ("SELECT f, g, tag FROM t WHERE tag < 4096 OR tag >= 8192 ORDER BY g, f DESC "
     "LIMIT 1500", 8, True),
])
@pytest.mark.parametrize("fold", FOLDS)
def test_topk_matches_the_jax_package(monkeypatch, merges, sql, live_batches, tail, fold):
    want, got, _ = run_port_and_jax(monkeypatch, topk_table(), sql, fold)
    rows = assert_same(got, want, ordered=True)
    if tail:
        assert any(r[0] is None for r in rows) and any(r[0] != r[0] for r in rows)
    folds = _split(live_batches, int(fold))
    assert len(merges) == len(folds)
    # the first merge sorts its group's live rows; every later one the
    # k-row state and its group's rows
    assert merges[0] <= folds[0] * 1024


# ------------------------------------------------------------ pipeline


@pytest.fixture
def pipeline_passes(monkeypatch):
    seen = []
    real = _PipelineCore.run_group

    def spy(self, entries, *a):
        seen.append(len(entries))
        return real(self, entries, *a)

    monkeypatch.setattr(_PipelineCore, "run_group", spy)
    return seen


def _output_batches(tctx, sql):
    return [(b.num_rows, b.capacity, to_host(b.mask),
             [to_host(c) for c in b.data],
             [None if v is None else to_host(v) for v in b.validity])
            for b in tctx.sql(sql).batches()]


@pytest.mark.parametrize("sql", [
    "SELECT i, v * 2 + 1, s FROM t WHERE v > 0",
    "SELECT k, v - i, tag FROM t WHERE s > 'cedar' AND k IS NOT NULL",
    "SELECT v / 3, i * i FROM t",
])
@pytest.mark.parametrize("group", [None, "2", "3"])
def test_pipeline_outputs_keep_their_batches(monkeypatch, pipeline_passes, sql, group):
    src = agg_table(n=17_000)  # 9 batches, the last one short
    jctx, tctx = contexts(src)
    want = jax_collect(jctx.sql(sql))
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", "0")
    per_batch = _output_batches(tctx, sql)
    assert pipeline_passes == [1] * 9
    monkeypatch.delenv("DATAFUSION_TPU_FUSE")
    pipeline_passes.clear()
    if group is not None:
        monkeypatch.setenv("DATAFUSION_TPU_FUSE_PIPELINE", group)
    folded = _output_batches(tctx, sql)
    assert pipeline_passes == _split(9, 16 if group is None else int(group))
    assert len(folded) == len(per_batch) == 9
    for (n, cap, mask, cols, valids), (n0, cap0, mask0, cols0, valids0) in zip(
            folded, per_batch):
        assert (n, cap) == (n0, cap0) and np.array_equal(mask, mask0)
        for a, b in zip(cols, cols0):
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
        for a, b in zip(valids, valids0):
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert_same(tdf.collect(tctx.sql(sql)), want)


# ------------------------------------------------------------ signatures


def test_signature_splits_on_structure_dtype_and_shared_identity():
    i32 = torch.zeros(5, dtype=torch.int32)
    f64 = torch.zeros(7, dtype=torch.float64)
    valid = torch.ones(7, dtype=torch.bool)
    aux_a, aux_b = torch.zeros(4), torch.zeros(4)
    entries = [
        ((f64,), (None,), 7, None, i32),
        ((torch.zeros(3, dtype=torch.float64),), (None,), 2, None, i32[:3]),  # rows differ
        ((f64,), (valid,), 7, None, i32),  # a validity appears
        ((f64,), (valid,), 7, None, i32),
        ((f64.float(),), (valid,), 7, None, i32),  # a dtype changes
        ((f64.float(),), (valid,), 7, None, i32),  # the shared table changes
    ]
    shareds = [(aux_a,)] * 5 + [(aux_b,)]
    groups = list(fused.iter_groups(entries, shareds))
    assert [idx for idx, _ in groups] == [[0, 1], [2, 3], [4], [5]]
    assert groups[-1][1] == (aux_b,)
    assert fused.shared_signature(((aux_a, None), aux_b)) == ((id(aux_a), None), id(aux_b))
    assert list(fused.iter_groups([], [])) == []


def test_knobs(monkeypatch):
    assert fused.fuse_group_max() == 256
    monkeypatch.setenv(FOLD_ENV, "0")
    assert fused.fuse_group_max() == 1
    assert fused.pipeline_group_max() == 16
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_BATCHES", "5")
    assert fused.pipeline_group_max() == 5
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_PIPELINE", "3")
    assert fused.pipeline_group_max() == 3
