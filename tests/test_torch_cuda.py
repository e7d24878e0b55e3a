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
(rtol 1e-9), a join chain and full sorts (rows and order exactly).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import cuda as port_cuda
from datafusion_tpu_torch.exec.cuda import hash_agg, hash_build, sort_kernel

pytestmark = pytest.mark.cuda

CASES = [("sum", torch.int64), ("sum", torch.float64), ("min", torch.float64),
         ("max", torch.float64), ("min", torch.int64), ("max", torch.int64),
         ("min", torch.int32), ("max", torch.int32)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


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
        ctx = tdf.ExecutionContext(device=device)
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
        ctx = tdf.ExecutionContext(device=device)
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
        ctx = tdf.ExecutionContext(device=device)
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
    # TopK: one launch of the radix sort per batch
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
        ctx = tdf.ExecutionContext(device=device, batch_size=16384)
        ctx.register_datasource("t", tdf.MemoryDataSource(schema, batches))
        port_cuda.reset_launch_counts()
        got = tdf.collect(ctx.sql(sql)).to_rows()
        counts = port_cuda.launch_counts()
        for name in needs:
            assert (counts[name] > 0) == (str(device) != "cpu")
        if "LIMIT" in sql and str(device) != "cpu":
            assert counts["sort_kernel"] == len(batches)
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
        ctx = tdf.ExecutionContext(device=device)
        ctx.register_csv("cities", path, schema, has_header=False)
        out.append(tdf.collect(ctx.sql(sql)).to_rows())
    assert out[0] == out[1] and len(out[0]) == 18
