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
launch geometry and the radix sort's choice of passes are checked,
since that Python decides which rows each block reads and which digits
are sorted.
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


@pytest.mark.parametrize(
    "n,g", [(0, 8), (1, 8), (255, 4), (131072, 8), (131072, 4096),
            (524288, 16), (524288, 8192), (6_000_000, 4), (6_000_000, 8192)],
)
def test_launch_geometry_reads_every_row_once(n, g):
    """Replays pass 1's row partition (csrc/hash_agg.cu): chunk c, warp
    w reads rows [c*chunk_rows + w*per_warp, ... + per_warp) clipped to
    n, in 32-row steps.  Every row must be read by exactly one warp of
    each group tile, and the tiles must cover [0, g)."""
    tile_g, chunks, chunk_rows = hash_agg.geometry(n, g)
    assert chunk_rows % 256 == 0 and chunks * chunk_rows >= n
    assert (chunks - 1) * chunk_rows < max(n, 1)
    assert tile_g % 32 == 0 and tile_g <= hash_agg.TILE_G
    assert -(-g // tile_g) * tile_g >= g
    per_warp = chunk_rows // 8
    assert per_warp % 32 == 0
    starts = np.arange(chunks)[:, None] * chunk_rows + np.arange(8)[None, :] * per_warp
    ends = np.minimum(n, starts + per_warp)
    lengths = np.maximum(ends - starts, 0)
    assert int(lengths.sum()) == n
    order = np.argsort(starts.ravel())
    s, e = starts.ravel()[order], ends.ravel()[order]
    live = s < e
    assert (s[live][1:] == e[live][:-1]).all()  # contiguous, no overlap
    # the same shapes always give the same partition (run-to-run bits)
    assert hash_agg.geometry(n, g) == (tile_g, chunks, chunk_rows)


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
    got = hash_build.build_slot_table(*args, 200)
    assert hash_build.LAUNCHES == before
    want = hash_build.build_slot_table_torch(*args, 200)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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


def _radix_model(ops):
    """The kernel's algorithm in numpy: per key, last key first, gather
    through the running permutation, flip the sign bit and run a stable
    4-bit pass for each digit `digit_mask` keeps."""
    n = len(ops[0])
    perm = np.arange(n)
    for op in reversed(ops):
        u = op.view(np.uint64) ^ np.uint64(1 << 63)
        mask = sort_kernel.digit_mask(int(np.bitwise_and.reduce(u)),
                                      int(np.bitwise_or.reduce(u)))
        if mask == 0:
            continue
        keys = u[perm]
        for d in range(sort_kernel.DIGITS):
            if mask >> d & 1:
                order = np.argsort((keys >> np.uint64(4 * d)) & np.uint64(15),
                                   kind="stable")
                keys, perm = keys[order], perm[order]
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
        "one_digit": [rng.integers(0, 16, n) << 36],
        "negative": [rng.integers(-20, 3, n)],
        "three_keys": _sort_keys(n, 3, seed=3),
    }[case]
    ops = [np.asarray(o, np.int64) for o in ops]
    np.testing.assert_array_equal(_radix_model(ops), pallas_sort.argsort_numpy(ops))


def test_digit_mask():
    assert sort_kernel.digit_mask(5, 5) == 0  # every key equal
    assert sort_kernel.digit_mask(0, 0xF) == 1
    assert sort_kernel.digit_mask(0, 0x10) == 2
    assert sort_kernel.digit_mask(-1, 0) == 0xFFFF  # all ones AND, zero OR
    assert sort_kernel.digit_mask(0, 1 << 63) == 1 << 15
