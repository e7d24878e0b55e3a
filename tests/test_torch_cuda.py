"""PyTorch/CUDA port: the tests that need the card.

Marked `cuda`; each skips where `torch.cuda.is_available()` is false,
so on a CPU-only machine they collect and skip.  This file imports
neither jax nor the JAX package, so it also runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
tensors: the grouped reduce's ints exactly and f64 within rtol 1e-12
(the plain version's atomics sum in another order), from G = 1 to a G
past one tile and with every row dead, the join build
(row, count and its duplicate flag against `count.max() > 1`) and the
radix argsort exactly, each bit-identical when run twice.  The
engine on cuda:0 is held against the engine on the CPU: a GROUP BY
(rtol 1e-9), a join chain and full sorts (rows and order exactly), and
the sort-merge route above `agg_max_groups()` (its state: ints exactly,
f64 within rtol 1e-12, f64 bit-identical when run twice, one radix-sort
launch a batch group).  The kernels also run at the batch-group fold's
shapes (a group's rows in one launch), and the fold launches the grouped
reduce once per slot per group (DATAFUSION_TPU_FUSE=0: per batch).  A
materialized Q1 view folds each delta on the card as through the plain
versions on the CPU, and an append into a pinned table sends the next
served query only the delta.  Tenancy and cost: the grouped reduce at
G = 16,384 (the widest window the cost store can learn), a served
two-tenant round whose metered device seconds sum to its launch wall,
and a `device.call` fault replayed around a real launch.  Distributed:
the partitioned aggregate on a mesh of 8 slots of cuda:0 against the
same mesh of CPU slots (5 grouped-reduce launches a round, folded warm
runs bit-identical), and a worker process on cuda:0 answering a
coordinator, its `status` counting the grouped reduces it launched.  Every context
here passes `result_cache=False`, so a repeated query runs and launches
again, and every case starts from an empty cost store.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import cuda as port_cuda
from datafusion_tpu_torch.exec.cuda import hash_agg, hash_build, sort_kernel
from datafusion_tpu_torch.exec.fused import fuse_group_max

pytestmark = pytest.mark.cuda

CASES = [("sum", torch.int64), ("sum", torch.float64), ("min", torch.float64),
         ("max", torch.float64), ("min", torch.int64), ("max", torch.int64),
         ("min", torch.int32), ("max", torch.int32)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _cold_cost_store():
    """Each case plans from an empty cost store (cost/): route history
    and group counts one case teaches would otherwise move another's
    grouped-reduce window or presize its accumulator, and several cases
    count launches per route."""
    from datafusion_tpu_torch import cost

    cost.reset_store()
    yield
    cost.reset_store()


def _inputs(kind, dtype, n, g, dev, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ids = torch.randint(-2, g + 2, (n,), generator=gen, device=dev, dtype=torch.int32)
    live = torch.rand(n, generator=gen, device=dev) > 0.1
    if dtype.is_floating_point:
        lo = 0.0 if kind == "sum" else -1e3
        vals = torch.rand(n, generator=gen, device=dev, dtype=dtype) * (1e3 - lo) + lo
        vals[torch.rand(n, generator=gen, device=dev) < 1e-3] = float("nan")
    else:
        info = torch.iinfo(dtype)
        vals = torch.randint(info.min, info.max, (n,), generator=gen, device=dev,
                             dtype=dtype)
    return ids, vals, live


# G = 1, 31 and 33 (not a multiple of 32; per-lane partials), 200 (a
# partial per warp, most steps with a group that several lanes hit),
# config 2's 4096 and the largest default capacity 8192 at N = 524,288,
# 25,827 f64 groups, one warp's partial filling the shared memory the
# kernel is granted to within a few bytes, and 32,768 f64 groups, past it
# (tiles of one warp)
@pytest.mark.parametrize("n,g", [(1, 4), (1000, 8), (131072, 8), (70001, 4096),
                                 (524288, 4096), (524288, 8192), (1000, 1),
                                 (70001, 31), (70001, 33), (70001, 200),
                                 (70001, 25827), (70001, 32768)])
@pytest.mark.parametrize("kind,dtype", CASES)
def test_kernel_matches_plain_version(dev, kind, dtype, n, g):
    ids, vals, live = _inputs(kind, dtype, n, g, dev)
    before = hash_agg.LAUNCHES
    got = hash_agg.grouped_reduce(ids, vals, live, g, kind)
    assert hash_agg.LAUNCHES == before + 1
    want = hash_agg.grouped_reduce_torch(ids, vals, live, g, kind)
    if dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True)
        again = hash_agg.grouped_reduce(ids, vals, live, g, kind)
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    else:
        assert torch.equal(got, want)


# the batch-group fold's shapes: Q1's 46 batches of 131,072 rows and
# config 2's 8 of 524,288 in one launch
@pytest.mark.parametrize("n,g", [(46 * 131_072, 8), (46 * 131_072, 4096),
                                 (8 * 524_288, 16)])
@pytest.mark.parametrize("kind,dtype", CASES)
def test_kernel_matches_plain_version_at_a_batch_group(dev, kind, dtype, n, g):
    ids, vals, live = _inputs(kind, dtype, n, g, dev, seed=n + g)
    got = hash_agg.grouped_reduce(ids, vals, live, g, kind)
    want = hash_agg.grouped_reduce_torch(ids, vals, live, g, kind)
    if dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True)
        again = hash_agg.grouped_reduce(ids, vals, live, g, kind)
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    else:
        assert torch.equal(got, want)


# the widened grouped-reduce window (cost/advisor.agg_window: up to
# 2 x agg_max_groups()) sends capacities up to 16,384 to the kernel
@pytest.mark.parametrize("kind,dtype", [("sum", torch.float64), ("min", torch.float64),
                                        ("max", torch.float64), ("sum", torch.int64)])
def test_kernel_matches_plain_version_at_the_widened_window(dev, kind, dtype):
    g = 2 * port_cuda.agg_max_groups()
    ids, vals, live = _inputs(kind, dtype, 524_288, g, dev, seed=g)
    before = hash_agg.LAUNCHES
    got = hash_agg.grouped_reduce(ids, vals, live, g, kind)
    assert hash_agg.LAUNCHES == before + 1 and got.shape == (16_384,)
    want = hash_agg.grouped_reduce_torch(ids, vals, live, g, kind)
    if dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True)
        again = hash_agg.grouped_reduce(ids, vals, live, g, kind)
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind,dtype", CASES)
def test_kernel_all_dead_rows_hold_identity(dev, kind, dtype):
    ids, vals, live = _inputs(kind, dtype, 70001, 4096, dev)
    live.zero_()
    got = hash_agg.grouped_reduce(ids, vals, live, 4096, kind)
    want = hash_agg.grouped_reduce_torch(ids, vals, live, 4096, kind)
    assert torch.equal(got, want)


def test_kernel_rejects_non_contiguous_input(dev):
    ids, vals, live = _inputs("sum", torch.float64, 64, 8, dev)
    with pytest.raises(tdf.ExecutionError):
        hash_agg.grouped_reduce(ids[::2], vals[::2].clone(), live[::2].clone(), 8, "sum")


def test_engine_on_card_matches_engine_on_cpu(dev):
    rng = np.random.default_rng(1)
    n = 50_000
    d = tdf.StringDictionary()
    codes = d.encode([f"s{i:02d}" for i in rng.integers(0, 30, n)])
    schema = tdf.Schema([
        tdf.Field("k", tdf.DataType.INT64, False),
        tdf.Field("v", tdf.DataType.FLOAT64, True),
        tdf.Field("s", tdf.DataType.UTF8, False),
    ])
    cols = [rng.integers(0, 300, n).astype(np.int64), rng.uniform(0, 1e3, n), codes]
    valid = rng.random(n) > 0.05
    batches = [
        tdf.make_host_batch(schema, [c[i:i + 8192] for c in cols],
                            [None, valid[i:i + 8192], None], [None, None, d])
        for i in range(0, n, 8192)
    ]
    sql = ("SELECT k, SUM(v), AVG(v), MIN(s), MAX(s), COUNT(v), COUNT(1) FROM t "
           "WHERE s >= 's05' AND v < 900 GROUP BY k")
    rows = {}
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        rows[str(device)] = sorted(tdf.collect(ctx.sql(sql)).to_rows())
        launched = port_cuda.launch_counts()["hash_agg"]
        assert (launched > 0) == (str(device) != "cpu")
    got, want = rows[str(dev)], rows["cpu"]
    assert len(got) == len(want) == 300
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert np.isclose(gv, wv, rtol=1e-9, atol=0.0), (g, w)
            else:
                assert gv == wv, (g, w)


# ------------------------------------------------------------ join build


# the nation and customer builds of Q5, the orders build of Q5 and Q12
# (N = S = 1,500,000), many rows into few slots, a sparse 2^26-slot
# table (the dense window) and an all-dead build
@pytest.mark.parametrize("n,slots,live_share", [
    (1, 1, 0.9), (25, 25, 0.9), (150_000, 150_000, 0.9),
    (1_500_000, 1_500_000, 0.9), (1_000_000, 4096, 0.9), (1000, 1 << 26, 0.9),
    (10_000, 10_000, 0.0),
])
def test_build_kernel_matches_plain_version(dev, n, slots, live_share):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pos = torch.randint(-3, slots + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    live = torch.rand(n, generator=gen, device=dev) < live_share
    before = hash_build.LAUNCHES
    got = hash_build.build_slot_table(pos, live, slots)
    assert hash_build.LAUNCHES == before + 1
    want = hash_build.build_slot_table_torch(pos, live, slots)
    again = hash_build.build_slot_table(pos, live, slots)
    for g, w, a in zip(got[:2], want, again[:2]):  # exact
        assert torch.equal(g, w) and torch.equal(g, a)
    assert got[2] is again[2] is bool(want[1].max() > 1)


@pytest.mark.parametrize("n", [25, 150_000, 1_500_000])
def test_build_kernel_duplicate_flag_on_unique_and_one_duplicate_key(dev, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pos = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    row, count, dup = hash_build.build_slot_table(pos, live, n)
    want_row, want_count = hash_build.build_slot_table_torch(pos, live, n)
    assert dup is False and torch.equal(row, want_row) and torch.equal(count, want_count)
    pos[n // 3] = pos[n - 1]
    row, count, dup = hash_build.build_slot_table(pos, live, n)
    want_row, want_count = hash_build.build_slot_table_torch(pos, live, n)
    assert dup is True and torch.equal(row, want_row) and torch.equal(count, want_count)


def test_build_kernel_rejects_non_contiguous_input(dev):
    pos = torch.zeros(16, dtype=torch.int32, device=dev)
    live = torch.ones(16, dtype=torch.bool, device=dev)
    with pytest.raises(tdf.ExecutionError):
        hash_build.build_slot_table(pos[::2], live[::2], 4)


# ------------------------------------------------------------ sort


def _f64_image(x):
    x = torch.where(x.abs() < torch.finfo(torch.float64).tiny, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFF_FFFF_FFFF_FFFF)


# around one tile of a pass (sort_kernel.TILE = 3840 rows), up to the
# SF-1 lineitem; "constant" has every digit constant (no pass at all)
@pytest.mark.parametrize("n", [1, 2, 3, 1000, sort_kernel.TILE - 1, sort_kernel.TILE,
                               sort_kernel.TILE + 1, 4097, 1 << 18, 1_000_000,
                               6_000_000])
@pytest.mark.parametrize("keys", ["ties", "full", "f64", "constant", "constant,ties",
                                  "ties,full,wide"])
def test_argsort_kernel_matches_plain_version(dev, n, keys):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    full = (torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev) * 2
            + torch.randint(0, 2, (n,), generator=gen, device=dev))
    full[0] = torch.iinfo(torch.int64).min
    f = torch.randn(n, generator=gen, device=dev, dtype=torch.float64).round(decimals=1)
    special = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0, float("inf"),
                            -float("inf")], dtype=torch.float64, device=dev)
    pick = torch.rand(n, generator=gen, device=dev) < 0.2
    f[pick] = special[torch.randint(0, 6, (n,), generator=gen, device=dev)[pick]]
    pool = {
        "ties": torch.randint(0, 7, (n,), generator=gen, device=dev),
        "full": full,
        "f64": _f64_image(f),
        "constant": torch.full((n,), -3, dtype=torch.int64, device=dev),
        "wide": torch.randint(0, 1 << 40, (n,), generator=gen, device=dev),
    }
    ops = [pool[k] for k in keys.split(",")]
    before = sort_kernel.LAUNCHES
    got = sort_kernel.argsort_multi(ops)
    assert sort_kernel.LAUNCHES == before + 1
    want = sort_kernel.argsort_multi_torch(ops)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got, sort_kernel.argsort_multi(ops))


# the sort-merge aggregate at a batch group: arange(G), then the group's
# ids with dead rows keyed G; config 2 at 100,000 groups (8 batches of
# 524,288) and Q3 at SF-1 (46 batches of 131,072, 80 % dead)
@pytest.mark.parametrize("groups,rows,used,live_share", [
    (131_072, 8 * 524_288, 100_000, 1.0), (1 << 21, 46 * 131_072, 1_470_000, 0.2)])
def test_argsort_kernel_matches_plain_version_at_a_batch_group(dev, groups, rows, used,
                                                               live_share):
    gen = torch.Generator(device=dev)
    gen.manual_seed(groups)
    ids = torch.randint(0, used, (rows,), generator=gen, device=dev)
    live = torch.rand(rows, generator=gen, device=dev) < live_share
    keys = torch.cat([torch.arange(groups, device=dev), torch.where(live, ids, groups)])
    got = sort_kernel.argsort_i64(keys)
    want = sort_kernel.argsort_multi_torch([keys])
    assert got.numel() == groups + rows and torch.equal(got, want)


def test_argsort_kernel_rejects_non_contiguous_input(dev):
    keys = torch.arange(16, device=dev)
    with pytest.raises(tdf.ExecutionError):
        sort_kernel.argsort_multi([keys[::2]])


# ------------------------------------------------------------ engine


def _star(n=40_000, seed=2):
    """fact -> dim (dense, unique keys 0..999 with dangling 1000..1049)
    -> grp (dense), and a Utf8 label on the last table."""
    rng = np.random.default_rng(seed)
    I, F, U = tdf.DataType.INT64, tdf.DataType.FLOAT64, tdf.DataType.UTF8
    fs = tdf.Schema([tdf.Field("k", I, False), tdf.Field("seq", I, False),
                     tdf.Field("x", F, False)])
    ds = tdf.Schema([tdf.Field("dk", I, False), tdf.Field("g", I, False)])
    gs = tdf.Schema([tdf.Field("gk", I, False), tdf.Field("label", U, False)])
    fact = [rng.integers(0, 1050, n), np.arange(n), rng.uniform(0, 1e3, n)]
    d = tdf.StringDictionary()
    labels = d.encode([f"g{i:02d}" for i in range(30)])
    tables = {
        "fact": (fs, [tdf.make_host_batch(fs, [c[i:i + 8192] for c in fact])
                      for i in range(0, n, 8192)]),
        "dim": (ds, [tdf.make_host_batch(ds, [np.arange(1000), rng.integers(0, 40, 1000)])]),
        "grp": (gs, [tdf.make_host_batch(gs, [np.arange(30), labels], None, [None, d])]),
    }
    return tables


@pytest.mark.parametrize("sql,ordered", [
    ("SELECT label, SUM(x), COUNT(1) FROM fact JOIN dim ON fact.k = dim.dk "
     "JOIN grp ON dim.g = grp.gk GROUP BY label", False),
    ("SELECT seq, label, x FROM fact JOIN dim ON fact.k = dim.dk "
     "LEFT JOIN grp ON dim.g = grp.gk WHERE x > 500 ORDER BY label DESC, seq", True),
    ("SELECT k, x, seq FROM fact WHERE x < 900 ORDER BY k, x DESC", True),
])
def test_engine_on_card_matches_engine_on_cpu_for_joins_and_sorts(dev, sql, ordered):
    tables = _star()
    rows = {}
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        for name, (schema, batches) in tables.items():
            ctx.register_datasource(name, tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        got = tdf.collect(ctx.sql(sql)).to_rows()
        rows[str(device)] = got if ordered else sorted(got)
        counts = port_cuda.launch_counts()
        on_card = str(device) != "cpu"
        if "JOIN" in sql:
            assert (counts["hash_build"] == 2) == on_card
        if ordered:
            assert (counts["sort_kernel"] >= 1) == on_card
    got, want = rows[str(dev)], rows["cpu"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float) and not ordered:
                assert np.isclose(gv, wv, rtol=1e-9, atol=0.0), (g, w)
            else:
                assert gv == wv, (g, w)


@pytest.mark.parametrize("base,dense", [((1 << 64) - 5000, True),
                                         ((1 << 63) - 2500, False)])
def test_uint64_join_key_on_card_matches_the_cpu(dev, base, dense):
    """A unique UInt64 build key in one half of its range builds on the
    card (one launch of the build kernel); keys that straddle 2^63 read
    as a range near 2^64 and take the host index (no launch)."""
    from datafusion_tpu_torch.join.relation import HashJoinRelation

    rng = np.random.default_rng(9)
    D = tdf.DataType
    ls = tdf.Schema([tdf.Field("k", D.UINT64, False), tdf.Field("v", D.INT64, False)])
    rs = tdf.Schema([tdf.Field("rk", D.UINT64, False), tdf.Field("w", D.INT64, False)])
    keys = np.array([base + i for i in range(5000)], np.uint64)
    probe = keys[rng.integers(0, 5000, 40_000)]
    probe[::7] = np.uint64(12345)  # misses the build
    seq = np.arange(len(probe))
    tables = {
        "l": (ls, [tdf.make_host_batch(ls, [probe[i:i + 8192], seq[i:i + 8192]])
                   for i in range(0, len(probe), 8192)]),
        "r": (rs, [tdf.make_host_batch(rs, [keys, rng.integers(0, 1000, 5000)])]),
    }
    sql = "SELECT v, k, w FROM l JOIN r ON l.k = r.rk"
    rows = {}
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        for name, (schema, batches) in tables.items():
            ctx.register_datasource(name, tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        rel = ctx.sql(sql)
        rows[str(device)] = sorted(tdf.collect(rel).to_rows())
        on_card = str(device) != "cpu"
        assert port_cuda.launch_counts()["hash_build"] == (1 if dense and on_card else 0)
        while not isinstance(rel, HashJoinRelation):
            rel = rel.child
        assert rel._artifact.dense is dense
    assert rows[str(dev)] == rows["cpu"] and len(rows["cpu"]) > 30_000


# ------------------------------------------- slice 6: pipeline, TopK, unsigned


def _slice6_table(n=60_000, seed=6):
    """int64 i, f64 f (NULLs, NaN, +-0.0), Utf8 tag, the four unsigned
    widths (UInt64 at and above 2^63), in batches of 16,384 rows."""
    rng = np.random.default_rng(seed)
    D = tdf.DataType
    schema = tdf.Schema([
        tdf.Field("i", D.INT64, False), tdf.Field("f", D.FLOAT64, True),
        tdf.Field("tag", D.UTF8, False), tdf.Field("a", D.UINT8, False),
        tdf.Field("b", D.UINT16, False), tdf.Field("c", D.UINT32, False),
        tdf.Field("d", D.UINT64, False), tdf.Field("seq", D.INT64, False)])
    f = rng.normal(size=n).round(2)
    f[rng.random(n) < 0.01] = np.nan
    f[rng.random(n) < 0.01] = -0.0
    d = tdf.StringDictionary()
    words = [f"w{i:03d}" for i in range(300)]
    cols = [rng.integers(-1000, 1000, n), f, None,
            rng.integers(0, 256, n).astype(np.uint8),
            rng.integers(0, 1 << 16, n).astype(np.uint16),
            rng.integers(0, 1 << 32, n).astype(np.uint32),
            rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False),
            np.arange(n)]
    tag = np.array(words, dtype=object)[rng.integers(0, 300, n)]
    valid = rng.random(n) > 0.05
    batches = []
    for lo in range(0, n, 16384):
        sl = slice(lo, lo + 16384)
        part = [c[sl] if c is not None else d.encode(list(tag[sl])) for c in cols]
        batches.append(tdf.make_host_batch(
            schema, part, [None, valid[sl], None, None, None, None, None, None],
            [None, None, d, None, None, None, None, None]))
    return schema, batches


SLICE6 = [
    # pipeline
    ("SELECT i, f + 1, tag FROM t WHERE i > 3 AND f < 0.5", False, ()),
    ("SELECT tag, i * 2, f / 3 FROM t WHERE tag > 'w150' OR f IS NULL", False, ()),
    ("SELECT 1 + 2", False, ()),
    # TopK: one launch of the radix sort per batch group
    ("SELECT seq, f FROM t ORDER BY f DESC LIMIT 100", True, ("sort_kernel",)),
    ("SELECT seq, tag, i FROM t ORDER BY tag, i DESC LIMIT 1000", True, ("sort_kernel",)),
    ("SELECT seq, d FROM t WHERE c > 100 ORDER BY d LIMIT 37", True, ("sort_kernel",)),
    # unsigned
    ("SELECT a + a, b * b, c - 1, d + d, d / 3, d % 7, CAST(d AS DOUBLE) FROM t "
     "WHERE d > 9223372036854775808", False, ()),
    ("SELECT i, MIN(a), MAX(b), SUM(c), MIN(d), MAX(d), SUM(d) FROM t "
     "WHERE c < 4000000000 GROUP BY i", False, ("hash_agg",)),
]


@pytest.mark.parametrize("sql,ordered,needs", SLICE6)
def test_slice6_queries_on_card_match_the_cpu(dev, sql, ordered, needs):
    schema, batches = _slice6_table()
    rows = {}
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False, batch_size=16384)
        ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        got = tdf.collect(ctx.sql(sql)).to_rows()
        counts = port_cuda.launch_counts()
        for name in needs:
            assert (counts[name] > 0) == (str(device) != "cpu")
        if "LIMIT" in sql and str(device) != "cpu":
            assert counts["sort_kernel"] == -(-len(batches) // fuse_group_max())
        rows[str(device)] = got if ordered else sorted(got, key=repr)
    got, want = rows[str(dev)], rows["cpu"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert (np.isnan(gv) and np.isnan(wv)) or np.isclose(
                    gv, wv, rtol=1e-9, atol=0.0), (g, w)
            else:
                assert gv == wv, (g, w)


def test_csv_scan_on_card_matches_the_cpu(dev):
    import os

    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("city", D.UTF8, False),
                         tdf.Field("lat", D.FLOAT64, False),
                         tdf.Field("lng", D.FLOAT64, False)])
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "test", "data", "uk_cities.csv")
    sql = "SELECT city, lat, lng, lat + lng FROM cities WHERE lat > 51.0 AND lat < 53"
    out = []
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        ctx.register_csv("cities", path, schema, has_header=False)
        out.append(tdf.collect(ctx.sql(sql)).to_rows())
    assert out[0] == out[1] and len(out[0]) == 18


def _rows_match(got, want):
    """Rows equal: ints and strings exactly, floats within rtol 1e-9."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0), (g, w)
            else:
                assert x == y, (g, w)


def test_csv_scans_on_card_stage_by_default_and_match_the_cpu(dev, tmp_path, monkeypatch):
    """Over a CSV scan on the card the aggregate and the pipeline run
    their host prep on the prefetch threads by default
    (`prefetch.pipeline_enabled`), while the reader grows its dictionary
    in every batch; an aggregate with a string compare and a string MIN,
    and a TopK on a Utf8 key over a computed projection, give the CPU's
    rows and order."""
    import threading

    from datafusion_tpu_torch.exec.aggregate import AggregateRelation
    from datafusion_tpu_torch.exec.relation import PipelineRelation

    rng = np.random.default_rng(5)
    letters = np.array(list("abcdefghij"))
    words, lines = [], ["k,s,v"]
    for _ in range(8):
        words += ["".join(rng.choice(letters, 3)) for _ in range(40)]
        for _ in range(2048):
            lines.append(f"{rng.integers(0, 50)},{words[rng.integers(0, len(words))]},"
                         f"{rng.normal() * 10:.6f}")
    path = tmp_path / "grow.csv"
    path.write_text("\n".join(lines) + "\n")
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", D.INT64, False), tdf.Field("s", D.UTF8, False),
                         tdf.Field("v", D.FLOAT64, False)])
    staged = []
    for cls in (AggregateRelation, PipelineRelation):
        def spy(self, batch, real=cls._stage):
            staged.append(threading.current_thread().name)
            return real(self, batch)
        monkeypatch.setattr(cls, "_stage", spy)
    monkeypatch.delenv("DATAFUSION_TPU_PREFETCH", raising=False)
    for sql, ordered in (
            ("SELECT k, SUM(v), MIN(s), COUNT(1) FROM t WHERE s > 'cde' GROUP BY k", False),
            ("SELECT s, k, v * 2 FROM t WHERE v > -5.0 ORDER BY s DESC, k LIMIT 300", True)):
        out = []
        for device in ("cpu", dev):
            ctx = tdf.ExecutionContext(device=device, result_cache=False, batch_size=2048)
            ctx.register_csv("t", str(path), schema, has_header=True)
            rows = tdf.collect(ctx.sql(sql)).to_rows()
            out.append(rows if ordered else sorted(rows))
        _rows_match(out[1], out[0])
        assert len(out[0]) > 40
    assert staged and set(staged) == {"df-torch-prefetch"}


# ------------------------------------------------------------ sort-merge route

HIGH_CARD_SQL = ("SELECT k, SUM(v), AVG(v), MIN(i), MAX(i), MIN(v), MAX(u), COUNT(1) "
                 "FROM t GROUP BY k")


def _high_card_table(groups, n=400_000, seed=7, batch_rows=1 << 17):
    """int64 key over `groups` values, f64 v (with NULLs), int64 i and
    UInt64 u around 2^63."""
    rng = np.random.default_rng(seed)
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", D.INT64, False), tdf.Field("v", D.FLOAT64, True),
                         tdf.Field("i", D.INT64, False), tdf.Field("u", D.UINT64, False)])
    cols = [rng.integers(0, groups, n), rng.uniform(0, 1e3, n),
            rng.integers(-(10**12), 10**12, n),
            (np.uint64(1 << 63) + rng.integers(-(1 << 40), 1 << 40, n).astype(np.uint64))]
    valid = rng.random(n) > 0.05
    return schema, [tdf.make_host_batch(schema, [c[lo:lo + batch_rows] for c in cols],
                                        [None, valid[lo:lo + batch_rows], None, None])
                    for lo in range(0, n, batch_rows)]


def _accumulated_state(device, schema, batches):
    """The aggregate's state after the scan, on the host, and the
    launches it made."""
    ctx = tdf.ExecutionContext(device=device, result_cache=False)
    ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
    rel = ctx.sql(HIGH_CARD_SQL)
    port_cuda.reset_launch_counts()
    counts, accs = rel.accumulate()
    torch.cuda.synchronize()
    return counts.cpu(), [a.cpu() for a in accs], port_cuda.launch_counts()


@pytest.mark.parametrize("groups", [20_000, 131_072])
def test_sortmerge_update_on_card_matches_the_cpu(dev, groups):
    schema, batches = _high_card_table(groups)
    cpu_counts, cpu_accs, _ = _accumulated_state("cpu", schema, batches)
    counts, accs, launches = _accumulated_state(dev, schema, batches)
    assert counts.shape[0] > port_cuda.agg_max_groups()
    # the scan is one batch group above 8192 groups: one radix sort, no
    # grouped reduce
    assert launches["sort_kernel"] == 1 and launches["hash_agg"] == 0
    assert torch.equal(counts, cpu_counts)
    for got, want in zip(accs, cpu_accs):
        if want.dtype.is_floating_point:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True)
        else:
            assert torch.equal(got, want)


def test_sortmerge_one_batch_a_fold_sorts_once_a_batch(dev, monkeypatch):
    schema, batches = _high_card_table(20_000)
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "1")
    cpu_counts, _, _ = _accumulated_state("cpu", schema, batches)
    counts, _, launches = _accumulated_state(dev, schema, batches)
    assert launches["sort_kernel"] == len(batches) and launches["hash_agg"] == 0
    assert torch.equal(counts, cpu_counts)


@pytest.mark.parametrize("fuse,slot_launches", [(None, 5), ("0", 5 * 8)])
def test_grouped_reduce_launches_once_a_slot_a_group(dev, monkeypatch, fuse, slot_launches):
    """Config 2's SELECT list over 8 batches: the fold launches the
    grouped reduce once per slot (the row count and 4 slots) for the
    scan, DATAFUSION_TPU_FUSE=0 once per slot per batch; the rows match
    the CPU's and the fold's f64 sums are bit-identical over two runs
    with the prefetch threads on."""
    rng = np.random.default_rng(12)
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", D.INT64, False), tdf.Field("v1", D.FLOAT64, False),
                         tdf.Field("v2", D.FLOAT64, False), tdf.Field("v3", D.INT64, False)])
    n = 8 * 65_536
    cols = [rng.integers(0, 4096, n), rng.uniform(0, 1e3, n), rng.uniform(-1, 1, n),
            rng.integers(-(10**9), 10**9, n)]
    batches = [tdf.make_host_batch(schema, [c[lo:lo + 65_536] for c in cols])
               for lo in range(0, n, 65_536)]
    sql = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t GROUP BY k"
    if fuse is not None:
        monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    out = {}
    for device in ("cpu", dev, dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        table = tdf.collect(ctx.sql(sql))
        if str(device) != "cpu":
            assert port_cuda.launch_counts()["hash_agg"] == slot_launches
            if str(device) in out:
                for i in (1, 2):
                    assert np.array_equal(np.asarray(table.columns[i]).view(np.int64),
                                          np.asarray(out[str(device)].columns[i])
                                          .view(np.int64))
        out[str(device)] = table
    got, want = (sorted(out[k].to_rows()) for k in (str(dev), "cpu"))
    assert len(got) == len(want) == 4096
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert np.isclose(gv, wv, rtol=1e-9, atol=0.0), (g, w)
            else:
                assert gv == wv, (g, w)


def test_sortmerge_f64_sums_bit_identical_on_rerun(dev):
    schema, batches = _high_card_table(131_072, seed=8)
    _, first, _ = _accumulated_state(dev, schema, batches)
    _, second, _ = _accumulated_state(dev, schema, batches)
    for a, b in zip(first, second):
        if a.dtype == torch.float64:
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
        else:
            assert torch.equal(a, b)


def test_high_cardinality_query_launches_the_sort_kernel(dev):
    schema, batches = _high_card_table(100_000, seed=9)
    rows = {}
    for device in ("cpu", dev):
        ctx = tdf.ExecutionContext(device=device, result_cache=False)
        ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        rows[str(device)] = sorted(tdf.collect(ctx.sql(HIGH_CARD_SQL)).to_rows(), key=repr)
        sorts = port_cuda.launch_counts()["sort_kernel"]
        assert sorts == (1 if str(device) != "cpu" else 0)  # one batch group
    got, want = rows[str(dev)], rows["cpu"]
    assert len(got) == len(want) > 90_000
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert np.isclose(gv, wv, rtol=1e-9, atol=0.0), (g, w)
            else:
                assert gv == wv, (g, w)


# ------------------------------------ slice 9: the query axis and serving


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int64 if a.element_size() == 8 else torch.int32),
                           b.view(torch.int64 if b.element_size() == 8 else torch.int32))
    return torch.equal(a, b)


# Q1's group (46 x 131,072 rows, G = 8), config 2's (8 x 524,288 rows,
# G = 16 and 4096), a G past one tile of shared memory, and small shapes
@pytest.mark.parametrize("n,g,q", [(46 * 131_072, 8, 16), (8 * 524_288, 4096, 4),
                                   (8 * 524_288, 16, 4), (70001, 32768, 3),
                                   (1000, 8, 1), (70001, 200, 5)])
@pytest.mark.parametrize("kind,dtype", CASES)
@pytest.mark.parametrize("shared", [True, False])
def test_query_axis_matches_solo_launches_bit_for_bit(dev, kind, dtype, n, g, q, shared):
    """Each query of one query-axis launch equals its own solo launch
    bit for bit, and its plain version (ints exactly, f64 within rtol
    1e-12)."""
    ids, vals, _ = _inputs(kind, dtype, n, g, dev, seed=n + g + q)
    gen = torch.Generator(device=dev)
    gen.manual_seed(q)
    live = torch.rand((q, n), generator=gen, device=dev) > 0.2
    if not shared:
        vals = torch.stack([vals.roll(j) for j in range(q)])
    before = (hash_agg.LAUNCHES, hash_agg.MULTI_LAUNCHES)
    got = hash_agg.grouped_reduce_multi(ids, vals, live, g, kind)
    # one launch; it counts as a query-axis launch when it serves several
    assert (hash_agg.LAUNCHES, hash_agg.MULTI_LAUNCHES) == (before[0] + 1,
                                                           before[1] + (q > 1))
    want = hash_agg.grouped_reduce_multi_torch(ids, vals, live, g, kind)
    for j in range(q):
        solo = hash_agg.grouped_reduce(ids, vals if shared else vals[j].contiguous(),
                                       live[j].contiguous(), g, kind)
        assert _bits_equal(got[j], solo), j
    if dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want)


def test_query_axis_wider_than_one_launch(dev, monkeypatch):
    monkeypatch.setattr(hash_agg, "MAX_QUERIES", 4)
    ids, vals, _ = _inputs("sum", torch.float64, 100_000, 64, dev)
    live = torch.rand((10, 100_000), device=dev) > 0.5
    before = hash_agg.MULTI_LAUNCHES
    got = hash_agg.grouped_reduce_multi(ids, vals, live, 64, "sum")
    assert hash_agg.MULTI_LAUNCHES == before + 3
    for j in range(10):
        assert _bits_equal(got[j], hash_agg.grouped_reduce(ids, vals, live[j].contiguous(),
                                                           64, "sum"))


def _serve_table(rows=200_000, batch_rows=1 << 15, seed=11):
    rng = np.random.default_rng(seed)
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", D.UTF8, False), tdf.Field("v", D.FLOAT64, False),
                         tdf.Field("d", D.UTF8, False)])
    dk, dd = tdf.StringDictionary(), tdf.StringDictionary()
    days = [f"2020-01-{i:02d}" for i in range(1, 29)]
    for s in days:
        dd.add(s)
    batches = []
    for lo in range(0, rows, batch_rows):
        n = min(batch_rows, rows - lo)
        batches.append(tdf.make_host_batch(schema, [
            dk.encode([f"g{j}" for j in rng.integers(0, 40, n)]),
            rng.uniform(0, 1e3, n), rng.integers(0, 28, n).astype(np.int32)],
            None, [dk, None, dd]))
    return schema, batches, days


def test_served_megabatch_on_card_equals_solo_bit_for_bit(dev):
    """Distinct string cutoffs megabatch on the card: one query-axis
    launch per slot per batch group, each answer its solo answer bit
    for bit, and a warm round copies nothing to the device."""
    from datafusion_tpu_torch.utils.metrics import METRICS

    schema, batches, days = _serve_table()
    ctx = tdf.ExecutionContext(device=dev, result_cache=False)
    ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
    sqls = [f"SELECT k, SUM(v), MIN(v), COUNT(1) FROM t WHERE d <= '{days[3 * i]}' GROUP BY k"
            for i in range(8)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    srv = ctx.serve(workers=1, window_s=0.2, megabatch_max=16)
    try:
        for round_ in range(2):
            h2d = METRICS.snapshot()["counts"].get("h2d.bytes", 0)
            port_cuda.reset_launch_counts()
            tickets = [srv.submit(s) for s in sqls]
            got = [t.result(timeout=120) for t in tickets]
            if round_ == 1:
                assert METRICS.snapshot()["counts"].get("h2d.bytes", 0) == h2d
                assert hash_agg.MULTI_LAUNCHES == 3  # rows, SUM, MIN: one batch group
            for g_, w in zip(got, solo):
                order_g = np.argsort(np.asarray(g_.columns[0]).astype(str))
                order_w = np.argsort(np.asarray(w.columns[0]).astype(str))
                for cg, cw in zip(g_.columns, w.columns):
                    assert np.asarray(cg)[order_g].tobytes() == np.asarray(cw)[order_w].tobytes()
    finally:
        srv.stop()
    assert srv.admitted + srv.shed == srv.submitted


def test_repeated_join_launches_the_build_kernel_once(dev):
    from datafusion_tpu_torch.utils.metrics import METRICS

    rng = np.random.default_rng(12)
    D = tdf.DataType
    ls = tdf.Schema([tdf.Field("k", D.INT64, False), tdf.Field("v", D.INT64, False)])
    rs = tdf.Schema([tdf.Field("rk", D.INT64, False), tdf.Field("w", D.INT64, False)])
    keys = rng.permutation(100_000).astype(np.int64)
    probe = rng.integers(0, 100_000, 300_000).astype(np.int64)
    ctx = tdf.ExecutionContext(device=dev, result_cache=False)
    ctx.register_datasource("l", tdf.MemoryDataSource(ls, [tdf.make_host_batch(
        ls, [probe, np.arange(300_000)])]))
    ctx.register_datasource("r", tdf.MemoryDataSource(rs, [tdf.make_host_batch(
        rs, [keys, np.arange(100_000)])]))
    sql = "SELECT SUM(w), COUNT(1) FROM l JOIN r ON l.k = r.rk"
    reuse0 = METRICS.snapshot()["counts"].get("join.build.reuse", 0)
    port_cuda.reset_launch_counts()
    srv = ctx.serve(workers=1, window_s=0.001)  # the serving path pins builds
    try:
        rows = [srv.submit(sql).result(timeout=120).to_rows() for _ in range(4)]
    finally:
        srv.stop()
    assert port_cuda.launch_counts()["hash_build"] == 1
    assert METRICS.snapshot()["counts"].get("join.build.reuse", 0) - reuse0 == 3
    inv = np.empty(100_000, np.int64)
    inv[keys] = np.arange(100_000)
    assert all(r == [(int(inv[probe].sum()), 300_000)] for r in rows)


def test_console_on_the_card_runs_ddl_and_a_group_by(dev, tmp_path):
    """`python -m datafusion_tpu_torch.cli --device cuda` on the card: a
    CREATE EXTERNAL TABLE over CSV and a GROUP BY, the same text as the
    console on the CPU, with the grouped reduce launched."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv = tmp_path / "t.csv"
    rng = np.random.default_rng(3)
    keys, vals = rng.integers(0, 7, 5000), rng.integers(-50, 50, 5000)
    csv.write_text("k,v\n" + "".join(f"{k},{v}\n" for k, v in zip(keys, vals)))
    script = tmp_path / "s.sql"
    script.write_text(
        f"CREATE EXTERNAL TABLE t (k BIGINT, v BIGINT) STORED AS CSV WITH HEADER ROW "
        f"LOCATION '{csv}';\n"
        "SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k;\n"
    )
    out = {}
    for device in ("cuda", "cpu"):
        proc = subprocess.run(
            [sys.executable, "-m", "datafusion_tpu_torch.cli", "--device", device,
             "--script", str(script)],
            capture_output=True, text=True, timeout=600, cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo, HOME=str(tmp_path)),
        )
        assert proc.returncode == 0, proc.stderr
        assert "Error" not in proc.stdout, proc.stdout
        out[device] = sorted(line for line in proc.stdout.splitlines()
                             if "\t" in line)
    want = sorted(f"{k}\t{int(vals[keys == k].sum())}\t{int((keys == k).sum())}"
                  for k in np.unique(keys))
    assert out["cuda"] == out["cpu"] == want

    from datafusion_tpu_torch.cli import Console, make_context
    import io

    port_cuda.reset_launch_counts()
    text = io.StringIO()
    console = Console(make_context("cuda"), out=text)
    for stmt in script.read_text().split(";")[:2]:
        console.execute(stmt)
    assert port_cuda.launch_counts()["hash_agg"] > 0
    assert sorted(line for line in text.getvalue().splitlines() if "\t" in line) == want


# ---------------------------------------- per-query observability (slice 11)

Q1_SQL = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity), SUM(l_extendedprice), "
          "SUM(l_extendedprice * (1 - l_discount)), AVG(l_quantity), AVG(l_discount), "
          "COUNT(1) FROM lineitem WHERE l_shipdate <= '1998-09-02' "
          "GROUP BY l_returnflag, l_linestatus")


def _q1_lineitem(n=120_000, batch_rows=16_384, seed=42):
    """A small Q1 lineitem (benchmarks/data.py's distributions)."""
    rng = np.random.default_rng(seed)
    n_dates = 2526
    ship = rng.integers(0, n_dates, n)
    flag = np.where(ship < n_dates // 2, rng.integers(0, 2, n) * 2, 1)
    status = (ship >= n_dates * 5 // 8).astype(np.int64)
    d_flag, d_status, d_ship = tdf.StringDictionary(), tdf.StringDictionary(), \
        tdf.StringDictionary()
    dates = [str(np.datetime64("1992-01-02") + np.timedelta64(i, "D")) for i in range(n_dates)]
    cols = [d_flag.encode(list(np.array(["A", "N", "R"])[flag])),
            d_status.encode(list(np.array(["F", "O"])[status])),
            np.floor(rng.uniform(1, 51, n)), np.round(rng.uniform(900.0, 104950.0, n), 2),
            rng.integers(0, 11, n) / 100.0, d_ship.encode([dates[i] for i in ship])]
    U, F = tdf.DataType.UTF8, tdf.DataType.FLOAT64
    schema = tdf.Schema([tdf.Field("l_returnflag", U, False),
                         tdf.Field("l_linestatus", U, False),
                         tdf.Field("l_quantity", F, False),
                         tdf.Field("l_extendedprice", F, False),
                         tdf.Field("l_discount", F, False), tdf.Field("l_shipdate", U, False)])
    dicts = [d_flag, d_status, None, None, None, d_ship]
    return schema, [tdf.make_host_batch(schema, [c[i:i + batch_rows] for c in cols], None, dicts)
                    for i in range(0, n, batch_rows)]


def _q1_context(device):
    schema, batches = _q1_lineitem()
    ctx = tdf.ExecutionContext(device=device, result_cache=False)
    ctx.register_datasource("lineitem", tdf.MemoryDataSource(schema, batches))
    return ctx


def test_explain_analyze_q1_on_the_card(dev):
    """EXPLAIN ANALYZE on cuda:0: the rows of the CPU port, the fold's
    grouped-reduce launches, and an "execute" phase timed by CUDA events
    above 0 and within the wall."""
    from datafusion_tpu_torch.obs.explain import ExplainAnalyzeResult

    want = sorted(tdf.collect(_q1_context("cpu").sql(Q1_SQL)).to_rows())
    ctx = _q1_context(dev)
    port_cuda.reset_launch_counts()
    res = ctx.sql("EXPLAIN ANALYZE " + Q1_SQL)
    assert isinstance(res, ExplainAnalyzeResult)
    assert port_cuda.launch_counts()["hash_agg"] == 5  # the row count and 4 sums
    got = sorted(res.result.to_rows())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            assert np.isclose(gv, wv, rtol=1e-9, atol=0.0) if isinstance(wv, float) \
                else gv == wv, (g, w)
    assert 0 < res.phases["execute"] <= res.wall_s
    assert res.counters["device.launches"] == 1
    assert res.root.stats.execute_s > 0 and res.root.stats.attrs["launches"] == 1
    assert res.hbm["peak_bytes"] > 0
    report = res.report()
    assert "execute" in report.splitlines()[1] and "HBM: peak" in report


def test_profile_sync_adds_no_synchronize_outside_its_scope(dev, monkeypatch):
    """Outside profile_sync (a plain query) the pass and copy seams make
    no CUDA event, call no `torch.cuda.synchronize` and sync no stream;
    EXPLAIN ANALYZE (inside it) records an event pair a pass."""
    calls = {"synchronize": 0, "event": 0, "stream": 0}
    real_sync, real_event, real_stream = (torch.cuda.synchronize, torch.cuda.Event,
                                          torch.cuda.current_stream)

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    ctx = _q1_context(dev)
    monkeypatch.setattr(torch.cuda, "synchronize", counted("synchronize", real_sync))
    monkeypatch.setattr(torch.cuda, "Event", counted("event", real_event))
    monkeypatch.setattr(torch.cuda, "current_stream", counted("stream", real_stream))
    tdf.collect(ctx.sql(Q1_SQL))
    tdf.collect(ctx.sql("SELECT l_quantity * 2 FROM lineitem WHERE l_discount > 0.05"))
    assert calls == {"synchronize": 0, "event": 0, "stream": 0}
    res = ctx.sql("EXPLAIN ANALYZE " + Q1_SQL)
    assert calls["event"] == 2 * res.counters["device.launches"] > 0
    assert calls["synchronize"] == 0


def test_route_evidence_is_one_event_pair_a_pass_of_the_card(dev, monkeypatch):
    """The learned window's evidence is device time: each aggregate pass
    of `MIN_ROUTE_ROWS` rows or more records one CUDA event pair and
    nothing synchronizes; finalize stores the pairs' device time per row
    under the pass's route.  The 120,000-row Q1 of the test above makes
    one pass under that, and no pair."""
    import time

    from datafusion_tpu_torch import cost
    from datafusion_tpu_torch.cost.advisor import MIN_ROUTE_ROWS
    from datafusion_tpu_torch.utils.metrics import METRICS

    n = 3 * MIN_ROUTE_ROWS
    schema, batches = _q1_lineitem(n=n, batch_rows=MIN_ROUTE_ROWS)
    ctx = tdf.ExecutionContext(device=dev, result_cache=False)
    ctx.register_datasource("lineitem", tdf.MemoryDataSource(schema, batches))
    calls = {"synchronize": 0, "event": 0}
    real_sync, real_event = torch.cuda.synchronize, torch.cuda.Event

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(torch.cuda, "synchronize", counted("synchronize", real_sync))
    monkeypatch.setattr(torch.cuda, "Event", counted("event", real_event))
    counts0 = dict(METRICS.counts)
    t0 = time.perf_counter()
    tdf.collect(ctx.sql(Q1_SQL))
    wall = time.perf_counter() - t0
    passes = sum(METRICS.counts.get(f"device.launches.{t}", 0) - counts0.get(
        f"device.launches.{t}", 0) for t in ("agg", "agg.group"))
    assert passes >= 1 and calls == {"synchronize": 0, "event": 2 * passes}
    rec = cost.store().lookup(cost.CUDA_KEY, "agg:grouped_reduce")
    assert rec["n"] == 1 and 0 < rec["exec_s_last"] < wall
    assert rec["s_per_row_last"] == pytest.approx(rec["exec_s_last"] / n, rel=1e-12)


def test_ledger_live_bytes_return_after_the_query_dies(dev):
    import gc

    from datafusion_tpu_torch.obs.device import LEDGER

    gc.collect()
    start = LEDGER.buffer_bytes()
    ctx = _q1_context(dev)
    res = ctx.sql("EXPLAIN ANALYZE " + Q1_SQL)
    assert LEDGER.buffer_bytes() > start  # the batches' device copies
    assert res.hbm["peak_bytes"] >= res.hbm["live_bytes"] > 0
    del ctx, res
    gc.collect()
    assert LEDGER.buffer_bytes() == start


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_f32_sum_on_the_card_within_the_bound(dev, monkeypatch, fuse):
    """scripts/port_f32_sum.py's bound ((10 * sqrt(n) + 1) * u * sum|x|
    a group, u = eps / 2) on the card's grouped reduce, with the fold and
    without; the same check fails in every group when the first batch's
    values are lost."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                    "scripts"))
    import port_f32_sum as f32

    monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    keys, vals, valid = f32.table(400_000, 8)
    want = f32.oracle(keys, vals, valid)
    got = f32.ratios(f32.run_port(dev, keys, vals, valid), want)
    assert got["sum_ratio"] <= 1.0 and got["avg_ratio"] <= 1.0, got
    lost = f32.ratios(f32.run_port(dev, keys, f32.lose_first_batch(vals), valid), want)
    assert lost["min_sum_ratio"] > 1.0, lost


# ------------------------------------- the freshness plane (slice 12)


def _view_deltas(n_deltas=4, rows=2000, seed=17):
    """config_ingest's deltas (benchmarks/suite.py): Q1's columns, the
    shipdate an existing one."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_deltas):
        out.append({
            "l_returnflag": [["A", "N", "R"][i] for i in rng.integers(0, 3, rows)],
            "l_linestatus": [["F", "O"][i] for i in rng.integers(0, 2, rows)],
            "l_quantity": rng.uniform(1, 50, rows).round(2),
            "l_extendedprice": rng.uniform(900, 105000, rows).round(2),
            "l_discount": rng.uniform(0, 0.1, rows).round(2),
            "l_shipdate": ["1995-06-15"] * rows,
        })
    return out


def test_view_folded_on_the_card_matches_the_plain_versions_on_the_cpu(dev):
    """Q1 as a materialized view over a small lineitem, folded delta by
    delta on cuda:0 (one pass a delta, one grouped-reduce launch per slot
    not aliased to the row count) and through the kernels' plain versions
    on the CPU: keys and counts exactly, floats within rtol 1e-9, at
    every cut; on the card the view also matches its own rescan."""
    views = {}
    ings = {}
    for device in ("cpu", dev):
        ctx = _q1_context(device)
        ings[device] = (ctx, ctx.ingest())
        views[device] = ings[device][1].create_view("q1", Q1_SQL)
        assert views[device].incremental
    for delta in _view_deltas():
        port_cuda.reset_launch_counts()
        ings[dev][1].append("lineitem", delta)
        # the row count and 4 sums (AVG(l_quantity) shares SUM(l_quantity)'s
        # slot; the counts alias the row count): one launch each
        assert port_cuda.launch_counts()["hash_agg"] == 5
        ings["cpu"][1].append("lineitem", delta)
        got = sorted(ings[dev][1].read_view("q1").to_rows())
        want = sorted(ings["cpu"][1].read_view("q1").to_rows())
        rescan = sorted(tdf.collect(ings[dev][0].sql(Q1_SQL)).to_rows())
        for rows in (want, rescan):
            assert len(got) == len(rows)
            for g, w in zip(got, rows):
                assert g[:2] == w[:2] and g[-1] == w[-1]
                assert np.allclose(g[2:-1], w[2:-1], rtol=1e-9, atol=0.0)
    assert views[dev].maintain_launches == 1 + len(_view_deltas())


def test_append_into_a_pinned_table_copies_only_the_delta_on_the_card(dev):
    """A served Q1 over a pinned lineitem on cuda:0; after `Server.append`
    the next served Q1 copies the delta's used columns and its group ids,
    nothing of the table, and equals the rescan."""
    from datafusion_tpu_torch.utils.metrics import METRICS

    ctx = _q1_context(dev)
    delta = _view_deltas(1)[0]
    with ctx.serve(workers=1, window_s=0.001) as srv:
        srv.submit(Q1_SQL).result(timeout=600)
        srv.submit(Q1_SQL.replace("1998-09-02", "1998-09-01")).result(timeout=600)
        srv.append("lineitem", delta)
        batch = ctx.datasources["lineitem"]._resident[-1]
        h2d0 = METRICS.snapshot()["counts"].get("h2d.bytes", 0)
        t = srv.submit(Q1_SQL)
        got = sorted(t.result(timeout=600).to_rows())
        used = t._rel.core.used_cols
        want_bytes = sum(batch.data[c].nbytes for c in used) + 4 * batch.capacity
        assert METRICS.snapshot()["counts"].get("h2d.bytes", 0) - h2d0 == want_bytes
    want = sorted(tdf.collect(ctx.sql(Q1_SQL)).to_rows())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[-1] == w[-1]
        assert np.allclose(g[2:-1], w[2:-1], rtol=1e-9, atol=0.0)


def test_served_two_tenant_round_conserves_metering_on_the_card(dev):
    """Two tenants with shares on cuda:0: every launch runs under a
    client's or a megabatch's scope and is charged its device time (a
    CUDA event pair), so the tenants' device seconds sum to the round's
    `device.dispatch` timer, which the same pairs fed; every answer is
    its solo answer bit for bit, and `admitted + shed == submitted`."""
    from datafusion_tpu_torch.obs.attribution import METER
    from datafusion_tpu_torch.utils.metrics import METRICS

    schema, batches, days = _serve_table()
    ctx = tdf.ExecutionContext(device=dev, result_cache=False)
    ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
    sqls = [f"SELECT k, SUM(v), MIN(v), COUNT(1) FROM t WHERE d <= '{days[2 * i]}' GROUP BY k"
            for i in range(12)]
    solo = [tdf.collect(ctx.sql(s)) for s in sqls]
    before = {c: METER.snapshot().get(c, {}).get("device_seconds", 0.0) for c in "AB"}
    disp0 = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0)
    with ctx.serve(shares={"A": 3, "B": 1}, workers=2, window_s=0.01,
                   megabatch_max=16) as srv:
        tickets = [srv.submit(s, client_id="A" if i % 3 == 0 else "B")
                   for i, s in enumerate(sqls)]
        got = [t.result(timeout=120) for t in tickets]
    assert srv.admitted + srv.shed == srv.submitted == len(sqls)
    launch_wall = METRICS.snapshot()["timings_s"]["device.dispatch"] - disp0
    metered = sum(METER.snapshot()[c]["device_seconds"] - before[c] for c in "AB")
    assert launch_wall > 0 and metered == pytest.approx(launch_wall, rel=1e-6)
    for g_, w in zip(got, solo):
        order_g = np.argsort(np.asarray(g_.columns[0]).astype(str))
        order_w = np.argsort(np.asarray(w.columns[0]).astype(str))
        for cg, cw in zip(g_.columns, w.columns):
            assert np.asarray(cg)[order_g].tobytes() == np.asarray(cw)[order_w].tobytes()


def test_device_call_fault_replays_a_real_launch(dev):
    """A planted `device.call` fault around a grouped-reduce launch: the
    pass replays and launches the kernel (never its plain version), with
    the plain version's answer; a failed launch raises on its first
    attempt."""
    from datafusion_tpu_torch.errors import ExecutionError
    from datafusion_tpu_torch.testing import faults
    from datafusion_tpu_torch.utils import retry
    from datafusion_tpu_torch.utils.metrics import METRICS

    ids, vals, live = _inputs("sum", torch.float64, 131_072, 8, dev)
    # no NaN: each of the 8 groups sums about 9,800 live rows, and one
    # NaN among them would make every answer NaN and the check vacuous
    vals = torch.nan_to_num(vals, nan=0.5)
    retries0 = METRICS.snapshot()["counts"].get("device.transient_retries", 0)
    before = hash_agg.LAUNCHES
    with faults.scoped({"rules": [{"site": "device.call", "op": "raise",
                                   "exc": "DeviceTransientError", "count": 2}]}):
        got = retry.device_call(hash_agg.grouped_reduce, ids, vals, live, 8, "sum",
                                _tag="test", _device=dev)
    assert hash_agg.LAUNCHES == before + 1
    assert METRICS.snapshot()["counts"]["device.transient_retries"] == retries0 + 2
    want = hash_agg.grouped_reduce_torch(ids, vals, live, 8, "sum")
    assert torch.isfinite(want).all() and (want > 0).all()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    # a launch the kernel refuses (strided values) raises on its first
    # attempt: nothing replays, nothing launches
    strided = torch.stack([vals, vals], 1)[:, 0]
    with pytest.raises(ExecutionError, match="contiguous"):
        retry.device_call(hash_agg.grouped_reduce, ids, strided, live, 8, "sum",
                          _device=dev)
    assert hash_agg.LAUNCHES == before + 1
    assert METRICS.snapshot()["counts"]["device.transient_retries"] == retries0 + 2


def _mesh_parts(seed=100, n_parts=8, rows=40_000, groups=1000, batch=16_384):
    """config 5's shape in miniature: 8 in-memory partitions of config
    2's columns (k, v1, v2, v3)."""
    T = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("v1", T.INT64, False),
                         tdf.Field("v2", T.FLOAT64, False), tdf.Field("v3", T.FLOAT64, False)])
    parts = []
    for p in range(n_parts):
        rng = np.random.default_rng(seed + p)
        cols = [rng.integers(0, groups, rows).astype(np.int64),
                rng.integers(0, 100, rows).astype(np.int64),
                rng.normal(size=rows), rng.uniform(-1e3, 1e3, rows)]
        parts.append(tdf.MemoryDataSource(schema, [
            tdf.make_host_batch(schema, [c[lo:lo + batch] for c in cols])
            for lo in range(0, rows, batch)]))
    return parts


def test_partitioned_mesh_on_one_card_matches_the_cpu(dev):
    """The partitioned aggregate on a mesh of 8 slots of cuda:0 (the
    slots fold into one state of 1024 groups, one grouped-reduce launch
    an aggregate column a round) against the same mesh of CPU slots: ints exactly, f64 within rtol
    1e-9; two warm folded runs repeat their f64 bits."""
    from datafusion_tpu_torch.parallel import (
        PartitionedContext,
        PartitionedDataSource,
        make_mesh,
    )

    sql = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t GROUP BY k"
    out = {}
    for name, slots in (("cuda", [dev] * 8), ("cpu", ["cpu"] * 8)):
        ctx = PartitionedContext(mesh=make_mesh(devices=slots), result_cache=False)
        ctx.register_datasource("t", PartitionedDataSource(_mesh_parts()))
        rel = ctx.sql(sql)
        port_cuda.reset_launch_counts()
        out[name] = tdf.collect(rel)
        if name == "cuda":
            # 3 rounds (3 batches a partition), 5 launches a round: the
            # row count, SUM(v1), SUM(v2), MIN(v3), MAX(v3)
            assert port_cuda.launch_counts()["hash_agg"] == 3 * 5
            tdf.collect(rel)  # admits the rounds
            warm = [tdf.collect(rel) for _ in range(2)]
            for a, b in zip(warm[0].columns, warm[1].columns):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    got, want = out["cuda"], out["cpu"]
    og = np.argsort(np.asarray(got.columns[0]))
    ow = np.argsort(np.asarray(want.columns[0]))
    for cg, cw in zip(got.columns, want.columns):
        cg, cw = np.asarray(cg)[og], np.asarray(cw)[ow]
        if cw.dtype.kind == "f":
            np.testing.assert_allclose(cg, cw, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(cg, cw)


def test_worker_process_on_the_card(dev, tmp_path):
    """`python -m datafusion_tpu_torch.worker` with no --device serves on
    cuda:0: a fragment's rows against a CPU context's, and its `status`
    shows the grouped-reduce launches made inside the worker process."""
    import os
    import subprocess
    import sys

    from datafusion_tpu_torch.parallel import DistributedContext, PartitionedDataSource

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(3)
    paths = []
    for p in range(2):
        path = tmp_path / f"p{p}.csv"
        k = rng.integers(0, 16, 5000)
        x = rng.uniform(0, 1, 5000).round(6)
        path.write_text("k,x\n" + "".join(f"{a},{b}\n" for a, b in zip(k, x)))
        paths.append(str(path))
    T = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("x", T.FLOAT64, False)])
    proc = subprocess.Popen([sys.executable, "-m", "datafusion_tpu_torch.worker",
                             "--bind", "127.0.0.1:0"], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, line
        host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
        ctx = DistributedContext([(host, int(port))], result_cache=False)
        ctx.register_datasource("t", PartitionedDataSource(
            [tdf.CsvDataSource(p, schema) for p in paths]))
        sql = "SELECT k, SUM(x), COUNT(1) FROM t GROUP BY k"
        got = sorted(tdf.collect(ctx.sql(sql)).to_rows())
        local = tdf.ExecutionContext(device="cpu", result_cache=False)
        local.register_datasource("t", PartitionedDataSource(
            [tdf.CsvDataSource(p, schema) for p in paths]))
        want = sorted(tdf.collect(local.sql(sql)).to_rows())
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-9)
        (status,) = ctx.worker_status().values()
        assert status["device"] == "cuda:0"
        # two fragments, 2 launches each: the row count and SUM(x)
        assert status["kernels"]["hash_agg"] == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
