"""PyTorch/CUDA port: the grouped-reduce kernel's plain version and
wrapper, on the CPU.

`grouped_reduce_torch` (datafusion_tpu_torch/exec/cuda/hash_agg.py) is
held against the JAX package's Pallas kernel run through the Pallas
interpreter (as tests/test_kernels.py runs it) and against that
module's numpy oracle, on the same numpy inputs: every (kind, dtype)
the aggregate sends, with dead rows, out-of-range ids, empty groups
and NaN.  Ints match exactly; floats within rtol 1e-12 (the sums are
taken in another order in each version).

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py
and chip_smoke.py); here its launch geometry is checked, since that
Python decides which rows each block reads.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from datafusion_tpu.exec.pallas import hash_agg as pallas_hash_agg
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec import cuda as port_cuda
from datafusion_tpu_torch.exec.cuda import hash_agg

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
