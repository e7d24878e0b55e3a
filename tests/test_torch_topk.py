"""PyTorch/CUDA port, slice 6: the streaming TopK (`ORDER BY ... LIMIT
k`, 0 < k <= TOPK_MAX), against the JAX package.

The same SQL on the same numpy-seeded tables runs through both packages
with `device="cpu"`.  Rows and their order match exactly: every table
carries a unique `tag` column, so a tie broken differently, or a -0.0
placed on the other side of a +0.0, shows as a different tag.  The
port's TopK merges each batch group (up to DATAFUSION_TPU_FUSE_GROUP
batches, 256 by default; one batch a merge at 1) into a state of k
rows through the radix argsort (`sort_kernel.argsort_multi`, its plain
version on the CPU); `torch.topk`, whose tie order differs from
`lax.top_k`'s, is never called.

Cases, after tests/test_sort.py and
tests/test_kernels.py::TestSortSemantics: stability under heavy ties,
NaN of both signs, +-0.0 and +-inf, NULL keys (last), Utf8 keys whose
dictionary grows mid-scan, multi-key keys with directions, int64 and
UInt64 extremes, a fused predicate, k greater than the rows, k =
65,536 (the TopK) and 65,537 (the full sort), and an empty input.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec.cuda import sort_kernel
from datafusion_tpu_torch.exec.sort import TOPK_MAX, SortRelation

from test_torch_pipeline import T, assert_same, contexts, jax_collect, jax_table

NEG_NAN = struct.unpack("<d", struct.pack("<Q", 0xFFF8000000000000))[0]


@pytest.fixture
def merges(monkeypatch):
    """Counts argsort calls, and fails any torch.topk call."""
    calls = []
    real = sort_kernel.argsort_multi

    def counted(ops):
        calls.append(ops[0].shape[0])
        return real(ops)

    def no_topk(*a, **k):
        raise AssertionError("torch.topk called")

    monkeypatch.setattr(sort_kernel, "argsort_multi", counted)
    monkeypatch.setattr(torch, "topk", no_topk)
    monkeypatch.setattr(torch.Tensor, "topk", no_topk)
    return calls


def run(src, sql, batch_size=131072):
    jctx, tctx = contexts(src, batch_size=batch_size)
    rel = tctx.sql(sql)
    got = tdf.collect(rel)
    return assert_same(got, jax_collect(jctx.sql(sql)), ordered=True), rel


def _mixed(n=6000, seed=47, batch_rows=2048, nulls=False):
    rng = np.random.default_rng(seed)
    words = np.array(["ash", "birch", "cedar", "oak", "elm", "fir"], dtype=object)
    cols = [words[rng.integers(0, 6, n)], rng.normal(size=n).round(1),
            rng.integers(-40, 40, n), np.arange(n)]
    validity = None
    if nulls:
        validity = [rng.random(n) > 0.1, rng.random(n) > 0.1, rng.random(n) > 0.1, None]
    return jax_table([("s", T.UTF8, nulls), ("f", T.FLOAT64, nulls),
                      ("i", T.INT64, nulls), ("tag", T.INT64, False)],
                     cols, validity, batch_rows)


@pytest.mark.parametrize("order", ["i", "i DESC", "f", "f DESC", "s", "s DESC",
                                   "s, f DESC, i", "i DESC, s, f"])
@pytest.mark.parametrize("k", [1, 7, 100, 1000])
def test_keys_directions_and_k(merges, order, k):
    rows, rel = run(_mixed(), f"SELECT s, f, i, tag FROM t ORDER BY {order} LIMIT {k}")
    assert isinstance(rel, SortRelation) and len(rows) == k
    assert len(merges) == 1  # the scan's 3 batches fold into one merge


@pytest.mark.parametrize("order", ["i", "i DESC", "f", "f DESC", "s", "s DESC",
                                   "s, f DESC, i", "i DESC, s, f"])
@pytest.mark.parametrize("k", [1, 7, 100, 1000])
def test_keys_directions_and_k_one_batch_a_merge(merges, monkeypatch, order, k):
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "1")
    rows, rel = run(_mixed(), f"SELECT s, f, i, tag FROM t ORDER BY {order} LIMIT {k}")
    assert isinstance(rel, SortRelation) and len(rows) == k
    assert len(merges) == 3  # one merge per batch of 2048 rows


@pytest.mark.parametrize("order", ["i", "f DESC", "s", "s DESC, i"])
def test_null_keys_sort_last(merges, order):
    rows, _ = run(_mixed(nulls=True), f"SELECT s, f, i, tag FROM t ORDER BY {order} "
                                      "LIMIT 5900")
    col = "sfi".index(order.split(",")[0].split()[0])
    nulls = [r[col] is None for r in rows]
    assert any(nulls) and nulls == sorted(nulls)


@pytest.mark.parametrize("order,width", [
    # operands of the one merge of the scan: a key's dead flag, since
    # the group holds a NULL in i (batch 2) and in f (batch 4)
    ("f DESC", [2]),
    ("x", [1]),
    ("i, f", [4]),
    ("x DESC, i", [3]),
])
def test_key_operands_follow_the_nulls_seen(monkeypatch, order, width):
    """A key crosses as its value image alone until a batch group brings
    its first NULL; the state's operands are then rebuilt with the key's
    dead flag, and the rows still match.  NaN shares the value image."""
    _key_operands(monkeypatch, order, width)


@pytest.mark.parametrize("fuse_group,order,width", [
    # operands a merge: one value image a key, and a key's dead flag
    # from the first group that holds a NULL in it (i: batch 2, f: 4)
    ("1", "f DESC", [1, 1, 1, 1, 2, 2]),
    ("1", "x", [1] * 6),
    ("1", "i, f", [2, 2, 3, 3, 4, 4]),
    ("1", "x DESC, i", [2, 2, 3, 3, 3, 3]),
    ("2", "f DESC", [1, 1, 2]),
    ("2", "x", [1, 1, 1]),
    ("2", "i, f", [2, 3, 4]),
    ("2", "x DESC, i", [2, 3, 3]),
])
def test_key_operands_rebuild_where_a_group_starts(monkeypatch, fuse_group, order, width):
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", fuse_group)
    _key_operands(monkeypatch, order, width)


def _key_operands(monkeypatch, order, width):
    n, b = 6 * 1024, 1024
    rng = np.random.default_rng(5)
    f = rng.normal(size=n).round(1)
    f[rng.random(n) < 0.05] = np.nan
    i = rng.integers(-20, 20, n)
    fv = np.ones(n, bool)
    fv[4 * b:5 * b] = rng.random(b) > 0.3
    iv = np.ones(n, bool)
    iv[2 * b:3 * b] = rng.random(b) > 0.3
    src = jax_table([("f", T.FLOAT64, True), ("i", T.INT64, True),
                     ("x", T.FLOAT32, False), ("tag", T.INT64, False)],
                    [f, i, rng.normal(size=n).astype(np.float32), np.arange(n)],
                    [fv, iv, None, None], batch_rows=b)
    widths = []
    real = sort_kernel.argsort_multi

    def counted(ops):
        widths.append(len(ops))
        return real(ops)

    monkeypatch.setattr(sort_kernel, "argsort_multi", counted)
    rows, _ = run(src, f"SELECT f, i, x, tag FROM t ORDER BY {order} LIMIT 6000")
    assert widths == width and len(rows) == 6000


def test_stability_under_heavy_ties(merges):
    """16 distinct keys over 30,000 rows: ties keep ascending row order
    across every merge of the state with a batch."""
    n = 30_000
    rng = np.random.default_rng(43)
    src = jax_table([("a", T.INT64, False), ("tag", T.INT64, False)],
                    [rng.integers(0, 16, n), np.arange(n)], batch_rows=4096)
    for k in (1000, 4097):
        rows, _ = run(src, f"SELECT a, tag FROM t ORDER BY a DESC LIMIT {k}")
        last = {}
        for key, tag in rows:
            assert last.get(key, -1) < tag, f"unstable at key {key}"
            last[key] = tag


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("direction", ["", " DESC"])
def test_nan_signed_zero_subnormal_and_inf(merges, direction, dtype):
    """One float key takes the JAX package's single-key order (IEEE
    total order: -0.0 before +0.0, subnormals kept, NaN after every
    number in both directions); under a second key it takes the full
    sort's (zeros and subnormals tie)."""
    tiny = 5e-324 if dtype == "f64" else 1e-45
    vals = np.array([1.5, np.nan, -0.0, 0.0, -np.inf, np.inf, -1.5, NEG_NAN,
                     0.0, -0.0, tiny, np.nan, NEG_NAN, 2.5, -tiny, -np.inf] * 40)
    typ, npd = (T.FLOAT64, np.float64) if dtype == "f64" else (T.FLOAT32, np.float32)
    src = jax_table([("a", typ, False), ("b", T.INT64, False), ("tag", T.INT64, False)],
                    [vals.astype(npd), np.zeros(len(vals), np.int64), np.arange(len(vals))],
                    batch_rows=100)
    for k in (3, 50, 300, len(vals)):
        run(src, f"SELECT a, tag FROM t ORDER BY a{direction} LIMIT {k}")
        run(src, f"SELECT a, tag FROM t ORDER BY a{direction}, b LIMIT {k}")


def test_utf8_keys_with_a_dictionary_that_grows(merges):
    """Every batch brings new strings, so the ranks of the state's keys
    change between merges."""
    n = 5000
    rng = np.random.default_rng(8)
    words = np.array([f"w{i:05d}" for i in rng.permutation(4000)], dtype=object)
    src = jax_table([("s", T.UTF8, False), ("tag", T.INT64, False)],
                    [words[np.minimum(np.arange(n) // 2 + rng.integers(0, 50, n), 3999)],
                     np.arange(n)], batch_rows=512)
    for order in ("s", "s DESC"):
        run(src, f"SELECT s, tag FROM t ORDER BY {order} LIMIT 37")


def test_small_and_narrow_key_types(merges):
    rng = np.random.default_rng(5)
    n = 3000
    src = jax_table([("f", T.FLOAT32, False), ("b", T.BOOLEAN, False),
                     ("i", T.INT32, False), ("u", T.UINT16, False), ("tag", T.INT64, False)],
                    [rng.normal(size=n).astype(np.float32).round(1), rng.random(n) > 0.5,
                     rng.integers(-5, 5, n).astype(np.int32),
                     rng.integers(0, 9, n).astype(np.uint16), np.arange(n)])
    run(src, "SELECT f, b, i, u, tag FROM t ORDER BY b DESC, f, i DESC LIMIT 333")
    run(src, "SELECT u, tag FROM t ORDER BY u DESC LIMIT 50")


def test_int64_and_uint64_extremes(merges):
    i64 = np.iinfo(np.int64)
    ivals = np.array([0, i64.max, i64.min, -1, i64.max, i64.min + 1, 1, i64.min] * 3)
    uvals = np.array([0, 2**64 - 1, 2**63, 2**63 - 1, 1, 2**64 - 2, 2**63 + 1, 7] * 3,
                     dtype=np.uint64)
    src = jax_table([("a", T.INT64, False), ("u", T.UINT64, False), ("tag", T.INT64, False)],
                    [ivals, uvals, np.arange(len(ivals))], batch_rows=5)
    for order in ("a", "a DESC", "u", "u DESC", "u DESC, a"):
        run(src, f"SELECT a, u, tag FROM t ORDER BY {order} LIMIT 6")


def test_fused_predicate_and_projection(merges):
    rows, _ = run(_mixed(nulls=True), "SELECT tag, f FROM t WHERE f > 0.5 AND i < 10 "
                                      "ORDER BY f DESC, tag LIMIT 40")
    assert rows and all(r[1] > 0.5 for r in rows)


def test_topk_over_a_computed_projection(merges):
    run(_mixed(), "SELECT i * 2, s, tag FROM t WHERE f < 0 ORDER BY s DESC LIMIT 25")


def test_k_above_the_rows_returns_all_sorted(merges):
    rows, _ = run(_mixed(300), "SELECT i, tag FROM t ORDER BY i DESC LIMIT 1000")
    assert len(rows) == 300


@pytest.mark.parametrize("k", [TOPK_MAX, TOPK_MAX + 1])
def test_k_at_and_past_topk_max(merges, k):
    n = TOPK_MAX + 3000
    rng = np.random.default_rng(9)
    src = jax_table([("a", T.INT64, False), ("tag", T.INT64, False)],
                    [rng.integers(0, 500, n), np.arange(n)], batch_rows=16384)
    rows, _ = run(src, f"SELECT a, tag FROM t ORDER BY a DESC LIMIT {k}")
    assert len(rows) == k
    # the TopK merges once per batch; the full sort sorts one run
    assert len(merges) == 1  # the TopK's 5 batches fold into one merge


def test_empty_input_and_no_survivors(merges):
    empty = jax_table([("a", T.INT64, False), ("tag", T.INT64, False)],
                      [np.zeros(0, np.int64), np.zeros(0, np.int64)])
    assert run(empty, "SELECT a, tag FROM t ORDER BY a LIMIT 5")[0] == []
    assert run(_mixed(), "SELECT tag FROM t WHERE f > 100 ORDER BY tag LIMIT 5")[0] == []
    assert merges == []


def test_state_keeps_only_batches_that_hold_survivors(monkeypatch):
    """The host holds O(k + batch) rows at one batch a merge: after a
    scan whose top rows all sit in the last batch, only that batch is
    held."""
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "1")
    assert max(_held_sizes()) <= 2


def test_held_batches_are_pruned_per_group(monkeypatch):
    """At 4 batches a merge the host holds at most one group besides the
    batches of the survivors, and after the last merge only the batch
    of the survivors."""
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "4")
    sizes = _held_sizes()
    assert max(sizes) <= 5 and sizes[-1] == 1


def _held_sizes():
    n = 20_000
    src = jax_table([("a", T.INT64, False), ("tag", T.INT64, False)],
                    [np.arange(n), np.arange(n)], batch_rows=1000)
    _, tctx = contexts(src)
    rel = tctx.sql("SELECT a, tag FROM t ORDER BY a DESC LIMIT 10")
    held_sizes = []
    real = SortRelation._owner

    def spy(held, rows):
        held_sizes.append(len(held))
        return real(held, rows)

    SortRelation._owner = staticmethod(spy)
    try:
        rows = tdf.collect(rel).to_rows()
    finally:
        SortRelation._owner = staticmethod(real)
    assert [r[0] for r in rows] == list(range(n - 1, n - 11, -1))
    return held_sizes
