"""PyTorch/CUDA port: the tests that need the card.

Marked `cuda`; each skips where `torch.cuda.is_available()` is false,
so on a CPU-only machine they collect and skip.  This file imports
neither jax nor the JAX package, so it also runs on a machine with the
card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same
tensors (ints exactly, f64 within rtol 1e-12, the plain version's
atomics sum in another order), and the engine on cuda:0 against the
engine on the CPU (rtol 1e-9).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import cuda as port_cuda
from datafusion_tpu_torch.exec.cuda import hash_agg

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


@pytest.mark.parametrize("n,g", [(1, 4), (1000, 8), (131072, 8), (70001, 4096)])
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
