"""PyTorch/CUDA port: the grouped reduce's query axis
(`hash_agg.grouped_reduce_multi`), on the CPU.

Its plain version, `grouped_reduce_multi_torch` (one reduction over
the offset ids q * G + id), against Q calls of the plain solo version
`grouped_reduce_torch` (ints and f64 exactly: both add each group's
rows in row order on the CPU) and against the Pallas module's numpy
oracle `grouped_reduce_numpy` per query (ints exactly, f64 within rtol
1e-12, the kernels' tolerance; f32 sums, which the oracle adds in f64,
within 1e-5 and 1e-3 absolute), with values shared by every query or
one column per query, dead rows, out-of-range ids, NaN for min and max,
and a call wider than one launch.  The wrapper takes the plain route
for CPU tensors and launches nothing; what it does not take, it
refuses.  The kernel itself runs in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from datafusion_tpu.exec.pallas import hash_agg as pallas_hash_agg

from datafusion_tpu_torch.exec.cuda import hash_agg

CASES = [("sum", np.int64), ("sum", np.float64), ("min", np.float64),
         ("max", np.float64), ("min", np.int64), ("max", np.int32),
         ("sum", np.float32)]


def _inputs(kind, dtype, n, g, q, shared, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, g + 2, n).astype(np.int32)
    live = rng.random((q, n)) > 0.3
    shape = (n,) if shared else (q, n)
    if np.dtype(dtype).kind == "f":
        vals = rng.uniform(-1e3, 1e3, shape).astype(dtype)
        if kind != "sum":
            vals[rng.random(shape) < 0.01] = np.nan
    else:
        vals = rng.integers(-10**6, 10**6, shape).astype(dtype)
    return ids, vals, live


@pytest.mark.parametrize("kind,dtype", CASES)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n,g,q", [(1000, 8, 1), (5000, 16, 4), (3000, 300, 16)])
def test_plain_query_axis_matches_solo_calls_and_oracle(kind, dtype, shared, n, g, q):
    ids, vals, live = _inputs(kind, dtype, n, g, q, shared)
    got = hash_agg.grouped_reduce_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                                        torch.from_numpy(live), g, kind)
    assert tuple(got.shape) == (q, g) and got.dtype == torch.from_numpy(vals).dtype
    for j in range(q):
        v = vals if shared else vals[j]
        solo = hash_agg.grouped_reduce_torch(torch.from_numpy(ids), torch.from_numpy(v),
                                             torch.from_numpy(live[j]), g, kind)
        # one reduction over offset ids adds each group's rows in row
        # order, as each solo call does
        assert np.array_equal(got[j].numpy(), solo.numpy(), equal_nan=True)
        want = pallas_hash_agg.grouped_reduce_numpy(ids, v, live[j], g, kind)
        if dtype == np.float64:
            np.testing.assert_allclose(got[j].numpy(), want, rtol=1e-12, equal_nan=True)
        elif dtype == np.float32:
            # f32 sums in f32, the oracle in f64: a group's sum may
            # cancel to far below its terms (|terms| up to 1e3)
            np.testing.assert_allclose(got[j].numpy(), want, rtol=1e-5, atol=1e-3)
        else:
            assert np.array_equal(got[j].numpy(), want)


def test_wider_than_one_launch_splits(monkeypatch):
    monkeypatch.setattr(hash_agg, "MAX_QUERIES", 3)
    ids, vals, live = _inputs("sum", np.float64, 2000, 32, 8, False)
    got = hash_agg.grouped_reduce_multi_torch(torch.from_numpy(ids), torch.from_numpy(vals),
                                              torch.from_numpy(live), 32, "sum")
    for j in range(8):
        solo = hash_agg.grouped_reduce_torch(torch.from_numpy(ids), torch.from_numpy(vals[j]),
                                             torch.from_numpy(live[j]), 32, "sum")
        assert np.array_equal(got[j].numpy(), solo.numpy())


def test_cpu_tensor_takes_plain_route_without_launching():
    ids, vals, live = _inputs("sum", np.int64, 500, 8, 3, True)
    before = (hash_agg.LAUNCHES, hash_agg.MULTI_LAUNCHES)
    hash_agg.grouped_reduce_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                                  torch.from_numpy(live), 8, "sum")
    assert (hash_agg.LAUNCHES, hash_agg.MULTI_LAUNCHES) == before


@pytest.mark.parametrize("bad", ["kind", "groups", "ids_dtype", "live_dtype", "live_1d",
                                 "rows", "queries", "vals_3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ids = torch.zeros(10, dtype=torch.int32)
    vals = torch.zeros(10, dtype=torch.float64)
    live = torch.ones(2, 10, dtype=torch.bool)
    kind, g = "sum", 4
    if bad == "kind":
        kind = "mean"
    elif bad == "groups":
        g = 0
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "live_dtype":
        live = live.to(torch.int8)
    elif bad == "live_1d":
        live = live[0]
    elif bad == "rows":
        vals = torch.zeros(11, dtype=torch.float64)
    elif bad == "queries":
        vals = torch.zeros(3, 10, dtype=torch.float64)
    else:
        vals = torch.zeros(2, 2, 10, dtype=torch.float64)
    with pytest.raises(ValueError):
        hash_agg.grouped_reduce_multi(ids, vals, live, g, kind)


def test_other_devices_raise_instead_of_falling_back():
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.zeros(4, dtype=torch.float64, device="meta")
    live = torch.ones(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(Exception) as ei:
        hash_agg.grouped_reduce_multi(ids, vals, live, 4, "sum")
    assert "cuda or cpu" in str(ei.value)
