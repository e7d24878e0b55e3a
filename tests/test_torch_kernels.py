"""PyTorch/CUDA port: the kernels' plain versions and wrappers, on the
CPU.

`grouped_reduce_torch` (datafusion_tpu_torch/exec/cuda/hash_agg.py) is
held against the JAX package's Pallas kernel run through the Pallas
interpreter (as tests/test_kernels.py runs it) and against that
module's numpy oracle, on the same numpy inputs: every (kind, dtype)
the aggregate sends, with dead rows, out-of-range ids, empty groups
and NaN.  Ints match exactly; floats within rtol 1e-12 (the sums are
taken in another order in each version).

The join build's plain version `build_slot_table_torch`
(exec/cuda/hash_build.py) and the sort's `argsort_multi_torch`
(exec/cuda/sort_kernel.py) are held the same way against the Pallas
`build_slot_table` and `argsort_multi` in interpret mode and against
`build_slot_table_numpy` and `argsort_numpy`, at n <= 2,048 as the JAX
package's own tests run them; both exactly.

The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py); here the grouped reduce's
launch geometry, the join build's duplicate report and the radix sort's
choice of passes are checked.  A numpy model of the grouped reduce's
order of f64 additions (per-lane partials at a small G, else peer sets
per 32-row step in their lane-order tree; warp partials; the fold
across chunks) is held against the oracle and the Pallas kernel within
rtol 1e-12, and a numpy model of one onesweep pass (per-warp stable
rank, warp offsets, tile prefixes in tile order) against
`argsort_numpy` on both sides of the tile boundary, since that
arithmetic decides where every row lands.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from datafusion_tpu.exec.pallas import hash_agg as pallas_hash_agg
from datafusion_tpu.exec.pallas import hash_build as pallas_hash_build
from datafusion_tpu.exec.pallas import sort_kernel as pallas_sort
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec import cuda as port_cuda
from datafusion_tpu_torch.exec.cuda import hash_agg, hash_build, sort_kernel

# every (kind, dtype) the aggregate's kernel route sends: row counts and
# sums over int64 and f64, min/max over f64, int64 and int32 (the
# string-rank slots)
CASES = [
    ("sum", np.int64),
    ("sum", np.float64),
    ("min", np.float64),
    ("max", np.float64),
    ("min", np.int64),
    ("max", np.int64),
    ("min", np.int32),
    ("max", np.int32),
]


def _inputs(kind, dtype, n, g, seed):
    rng = np.random.default_rng(seed)
    # ids from -3 to g + 3: a few rows fall outside [0, g); the top
    # quarter of the groups is never hit, so those stay empty
    ids = rng.integers(-3, (3 * g) // 4 + 3, n).astype(np.int32)
    ids[rng.random(n) < 0.02] = g + 2
    live = rng.random(n) > 0.15
    if np.dtype(dtype).kind == "f":
        # positive sums: no cancellation, so rtol bounds the order error
        lo = 1.0 if kind == "sum" else -1e3
        vals = rng.uniform(lo, 1e3, n).astype(dtype)
        vals[rng.random(n) < 0.001] = np.nan
    else:
        info = np.iinfo(dtype)
        lo, hi = (info.min // 4, info.max // 4) if kind == "sum" else (info.min, info.max)
        vals = rng.integers(lo, hi, n, dtype=dtype)
    return ids, vals, live


def _assert_same(got, want, dtype, msg):
    if np.dtype(dtype).kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("g", [4, 900])
@pytest.mark.parametrize("kind,dtype", CASES)
def test_plain_version_matches_pallas_kernel_and_oracle(kind, dtype, g):
    ids, vals, live = _inputs(kind, dtype, 6000, g, seed=7)
    want = pallas_hash_agg.grouped_reduce_numpy(ids, vals, live, g, kind)
    pallas = np.asarray(jax.jit(
        lambda i, v, l: pallas_hash_agg.grouped_reduce(
            i, v, l, g, kind, interpret=True
        )
    )(ids, vals, live))
    got = hash_agg.grouped_reduce_torch(
        torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(live),
        g, kind,
    ).numpy()
    assert got.dtype == np.dtype(dtype)
    _assert_same(got, want, dtype, f"{kind}/{np.dtype(dtype)} vs oracle")
    _assert_same(got, pallas, dtype, f"{kind}/{np.dtype(dtype)} vs pallas")
    # the top quarter of the groups saw no row: they hold the identity
    ident = pallas_hash_agg._identity(kind, dtype)
    assert (got[g - g // 4 + 3:] == ident).all()


def test_int64_sum_wraps_like_numpy():
    ids = np.zeros(4, np.int32)
    vals = np.full(4, 2**62, np.int64)
    live = np.ones(4, bool)
    want = pallas_hash_agg.grouped_reduce_numpy(ids, vals, live, 8, "sum")
    got = hash_agg.grouped_reduce_torch(
        torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(live),
        8, "sum",
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_route_without_launching():
    ids, vals, live = _inputs("sum", np.float64, 500, 16, seed=3)
    before = hash_agg.LAUNCHES
    args = (torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(live))
    got = hash_agg.grouped_reduce(*args, 16, "sum")
    assert hash_agg.LAUNCHES == before
    assert port_cuda.launch_counts()["hash_agg"] == before
    torch.testing.assert_close(
        got, hash_agg.grouped_reduce_torch(*args, 16, "sum"), rtol=0, atol=0
    )


def test_other_devices_raise_instead_of_falling_back():
    t = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ExecutionError):
        hash_agg.grouped_reduce(
            t, torch.empty(8, dtype=torch.float64, device="meta"),
            torch.empty(8, dtype=torch.bool, device="meta"), 4, "sum",
        )


@pytest.mark.parametrize("bad", ["kind", "ids_dtype", "live_dtype", "length", "groups"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ids = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros(8, dtype=torch.float64)
    live = torch.ones(8, dtype=torch.bool)
    kind, g = "sum", 4
    if bad == "kind":
        kind = "mean"
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "live_dtype":
        live = live.to(torch.uint8)
    elif bad == "length":
        vals = vals[:7]
    else:
        g = 0
    with pytest.raises(ValueError):
        hash_agg.grouped_reduce(ids, vals, live, g, kind)


# the H100's SM count and the shared memory per block the kernel is
# granted: the opt-in limit, 232,448 bytes, as it has no static shared memory
H100 = (132, 232448)


def _partial_bytes(warps, tile_g, lane_parts, itemsize):
    """Shared memory of a block's partials: per owning warp, a value per
    group and lane with lane_parts, else a value and a tag byte per
    group."""
    return warps * tile_g * (32 * itemsize if lane_parts else itemsize + 1)


@pytest.mark.parametrize(
    "n,g", [(0, 8), (1, 8), (255, 4), (131072, 8), (131072, 4096),
            (524288, 16), (524288, 8192), (6_000_000, 4), (6_000_000, 8192)],
)
def test_launch_geometry_reads_every_row_once(n, g):
    """Replays the partials' row partition (csrc/hash_agg.cu): block c,
    warp w reads rows [c*chunk_rows + w*per_warp, ... + per_warp)
    clipped to n, in 32-row steps, once per group tile.  Every row must
    be read by exactly one warp, the warps' partials must fit shared
    memory, and G <= 8192 at 8-byte types must be one tile."""
    sms, smem = H100
    for itemsize in (1, 2, 4, 8):
        warps, tile_g, lane_parts, blocks, chunk_rows, lanes = hash_agg.geometry(
            n, g, itemsize, sms, smem)
        assert 1 <= warps <= hash_agg.MAX_WARPS
        assert _partial_bytes(warps, tile_g, lane_parts, itemsize) <= smem
        # per-lane partials wherever all of a block's warps can hold them
        assert lane_parts == (32 * g * itemsize * hash_agg.MAX_WARPS <= smem)
        assert tile_g == g  # one tile: each row is read once
        assert 1 <= blocks <= sms
        assert chunk_rows % (warps * 32) == 0 and blocks * chunk_rows >= n
        assert (blocks - 1) * chunk_rows < max(n, 1)
        assert lanes & (lanes - 1) == 0 and lanes <= 32
        assert lanes == 1 or lanes * g <= blocks * hash_agg.MAX_WARPS * 32
        per_warp = chunk_rows // warps
        starts = (np.arange(blocks)[:, None] * chunk_rows
                  + np.arange(warps)[None, :] * per_warp)
        ends = np.minimum(n, starts + per_warp)
        assert int(np.maximum(ends - starts, 0).sum()) == n
        order = np.argsort(starts.ravel())
        s, e = starts.ravel()[order], ends.ravel()[order]
        live = s < e
        assert (s[live][1:] == e[live][:-1]).all()  # contiguous, no overlap
        # the same shapes always give the same partition (run-to-run bits)
        assert hash_agg.geometry(n, g, itemsize, sms, smem) == (
            warps, tile_g, lane_parts, blocks, chunk_rows, lanes)


@pytest.mark.parametrize("g,itemsize", [(25827, 8), (25828, 8), (32768, 8),
                                        (100_000, 4)])
def test_launch_geometry_tiles_past_shared_memory(g, itemsize):
    """A G past one warp's shared memory takes tiles of one warp that
    cover [0, G) without overlap."""
    sms, smem = H100
    warps, tile_g, lane_parts, _, _, _ = hash_agg.geometry(70_001, g, itemsize, sms, smem)
    tiles = -(-g // tile_g)
    assert not lane_parts
    assert _partial_bytes(warps, tile_g, lane_parts, itemsize) <= smem
    assert (tiles == 1) == (g * (itemsize + 1) <= smem)
    assert warps == 1 or tiles == 1
    assert (tiles - 1) * tile_g < g <= tiles * tile_g


def _tree(members):
    """A peer set's value: the balanced tree over ranks of `fold_peers`
    (level d: rank k, k a multiple of 2d, takes rank k + d)."""
    v = list(members)
    d = 1
    while d < len(v):
        for k in range(0, len(v) - d, 2 * d):
            v[k] = v[k] + v[k + d]
        d *= 2
    return v[0]


def _shuffle_tree(x):
    """The shuffle-down tree over axis 0 (a power of two long): lane s
    adds lane s + delta for delta = len / 2, ..., 1; lane 0's value."""
    x = x.copy()
    delta = len(x) // 2
    while delta:
        x[:delta] = x[:delta] + x[delta:2 * delta]
        delta //= 2
    return x[0]


def _reduce_model(ids, vals, live, g):
    """The kernel's order of f64 additions, in numpy.  Per block and
    owning warp, in step order: with lane_parts each lane adds its rows
    to its own partial, then per group each lane adds its warps'
    partials in warp order and the lanes are folded by the shuffle-down
    tree; otherwise each 32-row step's peer sets are reduced by `_tree`
    in lane order and committed to the warp's partial, and the block's
    warp partials are added in warp order.  Then per group, fold lane s
    adds chunks s, s + lanes, ... in chunk order from 0.0 and the lanes
    are folded by the shuffle-down tree."""
    n = len(ids)
    warps, tile_g, lane_parts, blocks, chunk_rows, lanes = hash_agg.geometry(
        n, g, 8, *H100)
    per_warp = chunk_rows // warps
    scratch = np.zeros((blocks, g))
    for g0 in range(0, g, tile_g):
        tg = min(tile_g, g - g0)
        for b in range(blocks):
            part = np.zeros((warps, tg, 32) if lane_parts else (warps, tg))
            for w in range(warps):
                r0 = b * chunk_rows + w * per_warp
                r1 = min(n, r0 + per_warp)
                for base in range(r0, r1, 32):
                    rows = np.arange(base, min(base + 32, r1))
                    hit = live[rows] & (ids[rows] >= g0) & (ids[rows] - g0 < tg)
                    gid = np.where(hit, ids[rows] - g0, -1)
                    if lane_parts:
                        lane = rows - base
                        part[w, gid[hit], lane[hit]] = (part[w, gid[hit], lane[hit]]
                                                        + vals[rows][hit])
                        continue
                    for key in np.unique(gid[gid >= 0]):
                        part[w, key] = part[w, key] + _tree(vals[rows][gid == key])
            acc = part[0].copy()
            for w in range(1, warps):
                acc = acc + part[w]
            scratch[b, g0:g0 + tg] = _shuffle_tree(acc.T) if lane_parts else acc
    lane_acc = np.zeros((lanes, g))
    for s in range(lanes):
        for c in range(s, blocks, lanes):
            lane_acc[s] = lane_acc[s] + scratch[c]
    return _shuffle_tree(lane_acc)


# one block's batch of rows: 8 warps of ITEMS 32-row steps
_BLOCK_ROWS = hash_agg.MAX_WARPS * 32 * hash_agg.ITEMS


@pytest.mark.parametrize("g", [1, 8, 33, 4096])
@pytest.mark.parametrize("n", [1, 31, 32, 33, _BLOCK_ROWS - 1, _BLOCK_ROWS + 1])
def test_reduce_order_model_matches_oracle_and_pallas(n, g):
    ids, vals, live = _inputs("sum", np.float64, n, g, seed=n + g)
    ids[: min(n, 40)] = 0  # a run of equal ids: peer sets of a whole step
    got = _reduce_model(ids, vals, live, g)
    want = pallas_hash_agg.grouped_reduce_numpy(ids, vals, live, g, "sum")
    pallas = np.asarray(jax.jit(
        lambda i, v, l: pallas_hash_agg.grouped_reduce(i, v, l, g, "sum", interpret=True)
    )(ids, vals, live))
    np.testing.assert_allclose(got, want, rtol=1e-12, err_msg="model vs oracle")
    np.testing.assert_allclose(got, pallas, rtol=1e-12, err_msg="model vs pallas")
    again = _reduce_model(ids, vals, live, g)
    assert np.array_equal(got.view(np.int64), again.view(np.int64))


def test_agg_max_groups_keeps_the_jax_packages_knob(monkeypatch):
    assert port_cuda.agg_max_groups() == 8192
    monkeypatch.setenv("DATAFUSION_TPU_PALLAS_AGG_GROUPS", "1024")
    assert port_cuda.agg_max_groups() == 1024


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    path = port_cuda._lib_path("hash_agg")
    assert path.parent == port_cuda.BUILD_DIR
    src = tmp_path / "hash_agg.cu"
    src.write_bytes((port_cuda.CSRC / "hash_agg.cu").read_bytes() + b"\n// edit\n")
    monkeypatch.setattr(port_cuda, "CSRC", tmp_path)
    assert port_cuda._lib_path("hash_agg") != path


def test_launch_counts_cover_every_kernel_source():
    assert set(port_cuda.launch_counts()) == set(port_cuda.SOURCES)
    for name in port_cuda.SOURCES:
        assert (port_cuda.CSRC / f"{name}.cu").exists()


# ------------------------------------------------------------ join build


def _build_inputs(n, slots, seed):
    """pos with duplicate slots, values outside [0, slots) on both
    sides and dead rows (the join computes pos for dead rows too)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-4, slots + 4, n).astype(np.int32)
    dup = rng.random(n) < 0.3
    pos[dup] = pos[dup] // 2
    live = rng.random(n) > 0.1
    return pos, live


@pytest.mark.parametrize("n,slots", [(1, 1), (25, 25), (700, 1500), (2048, 512)])
def test_build_plain_version_matches_pallas_kernel_and_oracle(n, slots):
    pos, live = _build_inputs(n, slots, seed=n)
    want_row, want_cnt = pallas_hash_build.build_slot_table_numpy(pos, live, slots)
    p_row, p_cnt = jax.jit(
        lambda p, l: pallas_hash_build.build_slot_table(p, l, slots, interpret=True)
    )(pos, live)
    row, cnt = hash_build.build_slot_table_torch(
        torch.from_numpy(pos), torch.from_numpy(live), slots)
    assert row.dtype == cnt.dtype == torch.int32
    for got, want, what in ((row, want_row, "row"), (cnt, want_cnt, "count")):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{what} vs oracle")
    np.testing.assert_array_equal(row.numpy(), np.asarray(p_row), err_msg="row vs pallas")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(p_cnt), err_msg="count vs pallas")
    if n > 100:
        assert cnt.max() > 1 and (row == -1).any()  # duplicates and empty slots


def test_build_cpu_tensor_takes_plain_route_without_launching():
    pos, live = _build_inputs(300, 200, seed=1)
    args = (torch.from_numpy(pos), torch.from_numpy(live))
    before = hash_build.LAUNCHES
    row, count, dup = hash_build.build_slot_table(*args, 200)
    assert hash_build.LAUNCHES == before
    want_row, want_count = hash_build.build_slot_table_torch(*args, 200)
    assert torch.equal(row, want_row) and torch.equal(count, want_count)
    assert dup is True  # 300 rows into 200 slots


@pytest.mark.parametrize("case", ["unique", "duplicate", "duplicate_dead",
                                  "duplicate_out_of_range"])
def test_build_reports_duplicates_as_count_does(case):
    # a duplicate counts only among live rows inside [0, slots)
    pos = np.arange(300, dtype=np.int32)
    live = np.ones(300, bool)
    if case != "unique":
        pos[7] = pos[200]
    if case == "duplicate_dead":
        live[7] = False
    elif case == "duplicate_out_of_range":
        pos[7] = pos[8] = 300
    args = (torch.from_numpy(pos), torch.from_numpy(live), 300)
    before = hash_build.LAUNCHES
    row, count, dup = hash_build.build_slot_table(*args)
    assert hash_build.LAUNCHES == before
    want_row, want_count = hash_build.build_slot_table_torch(*args)
    assert torch.equal(row, want_row) and torch.equal(count, want_count)
    assert dup is bool(want_count.max() > 1)
    assert dup is (case == "duplicate")


@pytest.mark.parametrize("bad", ["pos_dtype", "live_dtype", "length", "slots", "device"])
def test_build_wrapper_rejects_what_the_kernel_does_not_take(bad):
    pos = torch.zeros(8, dtype=torch.int32)
    live = torch.ones(8, dtype=torch.bool)
    slots = 4
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "live_dtype":
        live = live.to(torch.uint8)
    elif bad == "length":
        live = live[:7]
    elif bad == "slots":
        slots = 0
    else:
        with pytest.raises(ExecutionError):
            hash_build.build_slot_table(pos.to("meta"), live.to("meta"), slots)
        return
    with pytest.raises(ValueError):
        hash_build.build_slot_table(pos, live, slots)


# ------------------------------------------------------------ sort


def _sort_keys(n, nkeys, seed):
    """Tie-heavy keys, a full-range key with int64.min and int64.max,
    and a wide key, as many as asked for."""
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    full = rng.integers(i64.min, i64.max, n, dtype=np.int64)
    full[: min(n, 3)] = [i64.max, i64.min, 0][: min(n, 3)]
    keys = [rng.integers(0, 6, n).astype(np.int64), full,
            rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)]
    return keys[:nkeys]


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 17, 1000, 2048])
def test_argsort_plain_version_matches_pallas_kernel_and_oracle(n, nkeys):
    ops = _sort_keys(n, nkeys, seed=n * 10 + nkeys)
    want = pallas_sort.argsort_numpy(ops)
    pallas = np.asarray(jax.jit(
        lambda *o: pallas_sort.argsort_multi(list(o), interpret=True))(*ops))
    got = sort_kernel.argsort_multi_torch([torch.from_numpy(o) for o in ops])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_argsort_i64_is_stable_under_heavy_ties():
    keys = np.random.default_rng(11).integers(0, 3, 2048).astype(np.int64)
    got = sort_kernel.argsort_i64(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_sort.argsort_i64(keys, interpret=True)))


def test_argsort_cpu_tensor_takes_plain_route_without_launching():
    ops = [torch.from_numpy(o) for o in _sort_keys(500, 2, seed=5)]
    before = sort_kernel.LAUNCHES
    got = sort_kernel.argsort_multi(ops)
    assert sort_kernel.LAUNCHES == before
    assert torch.equal(got, sort_kernel.argsort_multi_torch(ops))


@pytest.mark.parametrize("bad", ["empty", "dtype", "length", "ndim", "device"])
def test_argsort_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(8, dtype=torch.int64)
    ops = [a, a.clone()]
    if bad == "empty":
        ops = []
    elif bad == "dtype":
        ops[1] = ops[1].to(torch.int32)
    elif bad == "length":
        ops[1] = ops[1][:7]
    elif bad == "ndim":
        ops[1] = ops[1].reshape(2, 4)
    else:
        with pytest.raises(ExecutionError):
            sort_kernel.argsort_multi([a.to("meta")])
        return
    with pytest.raises(ValueError):
        sort_kernel.argsort_multi(ops)


def _digit_histograms(u):
    """The histogram kernel's counts for one sign-flipped key: row b
    counts byte b of every key into 256 buckets."""
    return np.stack([
        np.bincount(((u >> np.uint64(8 * b)) & np.uint64(255)).astype(np.int64),
                    minlength=sort_kernel.RADIX)
        for b in range(sort_kernel.DIGITS)
    ])


def _onesweep_pass(keys, idx, shift, digit_hist):
    """One pass of `pass_kernel` in numpy: each tile ranks its rows per
    warp (item by item, lanes in order, as __match_any_sync does), the
    per-warp counts are scanned in warp order, and the tile's global
    offset for each digit is the digit's start over all rows plus the
    counts of the tiles before it (the look-back, in tile order).
    Returns (keys, idx) scattered to their global slots."""
    n = len(keys)
    tile, warp_rows = sort_kernel.TILE, 32 * sort_kernel.ITEMS
    warps = sort_kernel.THREADS // 32
    digit = ((keys >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    global_start = np.cumsum(digit_hist) - digit_hist
    before_tile = np.zeros(sort_kernel.RADIX, np.int64)
    dst = np.full(n, -1, np.int64)
    for t0 in range(0, n, tile):
        wcount = np.zeros((warps, sort_kernel.RADIX), np.int64)
        rank = {}
        for w in range(warps):
            for j in range(sort_kernel.ITEMS):
                lo = t0 + w * warp_rows + 32 * j
                rows = np.arange(lo, min(lo + 32, n))
                if len(rows) == 0:
                    continue
                d = digit[rows]
                earlier = (d[None, :] == d[:, None]) & np.tri(len(d), k=-1, dtype=bool)
                for r, dd, e in zip(rows, d, earlier.sum(axis=1)):
                    rank[r] = wcount[w, dd] + e
                wcount[w] += np.bincount(d, minlength=sort_kernel.RADIX)
        warp_offset = np.cumsum(wcount, axis=0) - wcount
        for r, k in rank.items():
            w = (r - t0) // warp_rows
            dst[r] = global_start[digit[r]] + before_tile[digit[r]] + \
                warp_offset[w, digit[r]] + k
        before_tile += wcount.sum(axis=0)
    assert np.array_equal(np.sort(dst), np.arange(n))  # a permutation
    out_keys, out_idx = np.empty_like(keys), np.empty_like(idx)
    out_keys[dst], out_idx[dst] = keys, idx
    return out_keys, out_idx


def _radix_model(ops):
    """The kernel's algorithm in numpy: one histogram per key, then per
    key, last key first, gather through the running permutation, flip
    the sign bit and run `_onesweep_pass` for each 8-bit digit
    `digit_mask` keeps."""
    n = len(ops[0])
    perm = np.arange(n)
    hists = [_digit_histograms(op.view(np.uint64) ^ np.uint64(1 << 63)) for op in ops]
    for op, hist in zip(reversed(ops), reversed(hists)):
        mask = sort_kernel.digit_mask(hist.max(axis=1), n)
        if mask == 0:
            continue
        keys = op.view(np.uint64)[perm] ^ np.uint64(1 << 63)
        for b in range(sort_kernel.DIGITS):
            if mask >> b & 1:
                keys, perm = _onesweep_pass(keys, perm, 8 * b, hist[b])
    return perm


@pytest.mark.parametrize("case", ["ties", "full", "constant", "one_digit",
                                  "negative", "three_keys"])
def test_radix_passes_skip_only_digits_that_never_vary(case):
    rng = np.random.default_rng(21)
    n = 3000
    ops = {
        "ties": [rng.integers(0, 7, n)],
        "full": _sort_keys(n, 2, seed=2)[1:],
        "constant": [np.full(n, -5), rng.integers(0, 9, n)],
        "one_digit": [rng.integers(0, 256, n) << 40],
        "negative": [rng.integers(-20, 3, n)],
        "three_keys": _sort_keys(n, 3, seed=3),
    }[case]
    ops = [np.asarray(o, np.int64) for o in ops]
    np.testing.assert_array_equal(_radix_model(ops), pallas_sort.argsort_numpy(ops))


@pytest.mark.parametrize("nkeys", [1, 3])
@pytest.mark.parametrize("n", [1, sort_kernel.TILE - 1, sort_kernel.TILE,
                               sort_kernel.TILE + 1, 3 * sort_kernel.TILE + 7])
def test_onesweep_pass_model_across_tile_boundaries(n, nkeys):
    # tie-heavy, full-range (int64.min and .max) and wide keys, so some
    # digits repeat across tiles and warps and some are skipped
    ops = _sort_keys(n, nkeys, seed=n + nkeys)
    np.testing.assert_array_equal(_radix_model(ops), pallas_sort.argsort_numpy(ops))


def test_digit_mask():
    def mask(*u):
        u = np.asarray(u, np.uint64)
        return sort_kernel.digit_mask(_digit_histograms(u).max(axis=1), len(u))

    assert mask(5, 5) == 0  # every key equal
    assert mask(0, 0xF) == 1
    assert mask(0, 0x10) == 1  # bit 4 lies in digit 0 of 8 bits
    assert mask(0, 0xFFFF_FFFF_FFFF_FFFF) == 0xFF  # every digit differs
    assert mask(0, 1 << 63) == 1 << 7
