"""PyTorch/CUDA port: float32 SUM and AVG held to a stated bound.

Both packages accumulate an f32 SUM in f32, each in its own order: the
port's batch-group fold sums a whole group of batches in one grouped
reduce (`DATAFUSION_TPU_FUSE=0`: one a batch), the JAX package scans
its batches.  The bound is `scripts/port_f32_sum.py`'s: for a group of
n rows, with eps = 2^-23 (f32 epsilon) and u = eps / 2,

    |SUM_f32 - SUM_f64| <= (10 * sqrt(n) + 1) * u * sum|x|,

Higham and Mary's probabilistic bound at lambda = 10 (a miss below
1e-15 at a million rows) plus the result's rounding to f32; AVG (SUM /
n, divided in f64) errs by at most that over n.  The worst case, n *
eps * sum|x|, would pass a sum that lost a whole batch at the card's
sizes; this one does not, and the planted-fault tests below show it at
every size the tests and the script use.  This holds the port, with the
fold and under `DATAFUSION_TPU_FUSE=0`, and the JAX package, to that
bound against an f64 numpy oracle on the same seeded rows
(`scripts/port_f32_sum.py` measures the same at 1,000,000 rows; PERF.md
states what it read).  It adds a check and loosens none:
`tests/test_torch_port.py` keeps f32 columns out of its rtol 1e-9 SUMs.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import port_f32_sum as f32  # noqa: E402


@pytest.mark.parametrize("fuse", ["1", "0"])
@pytest.mark.parametrize("rows,groups", [(60_000, 8), (20_000, 1), (30_000, 300)])
def test_port_f32_sum_and_avg_within_the_bound(monkeypatch, fuse, rows, groups):
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    keys, vals, valid = f32.table(rows, groups)
    got = f32.ratios(f32.run_port("cpu", keys, vals, valid), f32.oracle(keys, vals, valid))
    assert got["sum_ratio"] <= 1.0 and got["avg_ratio"] <= 1.0, got


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_jax_package_f32_sum_within_the_same_bound(monkeypatch, fuse):
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    keys, vals, valid = f32.table(60_000, 8)
    got = f32.ratios(f32.run_jax(keys, vals, valid), f32.oracle(keys, vals, valid))
    assert got["sum_ratio"] <= 1.0 and got["avg_ratio"] <= 1.0, got


def test_the_bound_catches_a_lost_batch_and_a_nan():
    """The check has teeth: a SUM that misses one batch of a group, or
    reads NaN, breaks the bound."""
    import numpy as np

    keys, vals, valid = f32.table(20_000, 1)
    want = f32.oracle(keys, vals, valid)
    n = want[0][1]
    kept = valid.copy()
    kept[-f32.BATCH:] = False
    lost = float(vals[kept].astype(np.float32).sum(dtype=np.float32))
    assert f32.ratios([(0, lost, lost / n, n)], want)["sum_ratio"] > 1.0
    assert f32.ratios([(0, float("nan"), 0.0, n)], want)["sum_ratio"] > 1.0


def _lost_sums(keys, vals, valid):
    """Each group's f32 SUM and AVG with the first batch's values zeroed
    (COUNT unchanged), summed by numpy in f32."""
    import numpy as np

    lost = f32.lose_first_batch(vals)
    rows = []
    for k in np.unique(keys):
        m = (keys == k) & valid
        s = float(lost[m].sum(dtype=np.float32))
        rows.append((int(k), s, s / int(m.sum()), int(m.sum())))
    return rows


@pytest.mark.parametrize("rows,groups", [(20_000, 1), (60_000, 8), (30_000, 300),
                                         (400_000, 8), (1_000_000, 8)])
def test_a_lost_batch_breaks_the_bound_in_every_group(rows, groups):
    """At the sizes of these tests, the card test (400,000 rows) and the
    script (1,000,000 rows), a SUM one batch short breaks the bound in
    every group, not just in the largest."""
    keys, vals, valid = f32.table(rows, groups)
    got = f32.ratios(_lost_sums(keys, vals, valid), f32.oracle(keys, vals, valid))
    assert got["min_sum_ratio"] > 1.0, got


@pytest.mark.parametrize("fuse", ["1", "0"])
@pytest.mark.parametrize("rows,groups", [(60_000, 8), (400_000, 8)])
def test_a_planted_lost_batch_through_the_port_breaks_the_bound(monkeypatch, fuse,
                                                                 rows, groups):
    """The planted fault run through the port's own grouped reduce: the
    check that passes the right sums fails this one in every group."""
    monkeypatch.setenv("DATAFUSION_TPU_FUSE", fuse)
    keys, vals, valid = f32.table(rows, groups)
    got = f32.ratios(f32.run_port("cpu", keys, f32.lose_first_batch(vals), valid),
                     f32.oracle(keys, vals, valid))
    assert got["min_sum_ratio"] > 1.0, got
