"""PyTorch/CUDA port, slice 6: unsigned columns, against the JAX package.

torch has no arithmetic, compare or reduction on uint16/32/64, so the
port keeps unsigned columns in a signed device dtype: UInt8 stays
uint8, UInt16 widens to int32, UInt32 to int64, and UInt64 is an int64
bit view that compares, divides and takes MIN/MAX on its sign-flipped
image and converts to float correctly rounded.  Every case here runs
the same SQL through both packages with `device="cpu"` over a table
whose UInt64 column holds values at and above 2^63 and whose narrower
columns hold their type's extremes, with NULLs.

Where the JAX package gives an answer, the port gives the same one:
+, - and * wrap at the column's width, x / 0 is the type's maximum,
x % 0 is x, UInt64 compares and divides as unsigned, CAST to a signed
type wraps, CAST(UInt64 AS DOUBLE) rounds to nearest; SUM wraps mod
2^64 and returns the column's type; a group's MIN at the type's
maximum, or MAX at 0, reads as NULL in both (the accumulators'
identity).  Where it raises, the port raises the same error: an
unsigned column against a negative literal or a signed column has no
common type (PlanError, from the planner both packages share).
"""

from __future__ import annotations

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.obs.device import LEDGER

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.join.relation import HashJoinRelation

from test_torch_pipeline import T, assert_same, carry, contexts, jax_collect, jax_table


def unsigned_table(n=3000, seed=11, batch_rows=1024):
    rng = np.random.default_rng(seed)

    def col(dtype, extremes):
        info = np.iinfo(dtype)
        v = rng.integers(0, info.max, n, dtype=dtype, endpoint=True)
        v[: len(extremes)] = np.asarray(extremes, dtype)
        return v

    u64_ext = [0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1, 7]
    cols = [col(np.uint8, [0, 1, 127, 128, 254, 255]),
            col(np.uint16, [0, 1, 32767, 32768, 65534, 65535]),
            col(np.uint32, [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]),
            col(np.uint64, u64_ext),
            rng.integers(0, 5, n), np.arange(n)]
    # small values for MIN/MAX groups that are not at the extremes
    cols[3][len(u64_ext):: 3] = rng.integers(0, 1000, len(cols[3][len(u64_ext)::3]))
    validity = [rng.random(n) > 0.05, None, rng.random(n) > 0.05, rng.random(n) > 0.05,
                None, None]
    return jax_table([("a", T.UINT8, True), ("b", T.UINT16, False), ("c", T.UINT32, True),
                      ("d", T.UINT64, True), ("k", T.INT64, False), ("tag", T.INT64, False)],
                     cols, validity, batch_rows)


SQL = [
    # arithmetic wraps at the column's width
    "SELECT a + a, b + b, c + c, d + d, tag FROM t",
    "SELECT a * 3, b * b, c * c, d * d, tag FROM t",
    "SELECT a - 1, b - 7, c - 1, d - 9223372036854775809, tag FROM t",
    # division and remainder, by zero too
    "SELECT a / 0, b / 0, c / 0, d / 0, a % 0, d % 0, tag FROM t",
    "SELECT d / 3, d % 3, d / 9223372036854775808, d % 18446744073709551615, tag FROM t",
    "SELECT d / d, d % d, c / 7, c % 7, b / 9, a % 5, tag FROM t",
    # compares, in projections and predicates
    "SELECT d > 9223372036854775807, d < 5, d = 18446744073709551615, c >= 2147483648, "
    "tag FROM t",
    "SELECT d, tag FROM t WHERE d > 9223372036854775808",
    "SELECT a, b, tag FROM t WHERE a > 127 AND b < 32768",
    "SELECT c, d, tag FROM t WHERE c <= 2147483648 OR d >= 18446744073709551614",
    # casts
    "SELECT CAST(d AS DOUBLE), CAST(d AS BIGINT), CAST(c AS INT), CAST(a AS TINYINT), "
    "CAST(b AS SMALLINT), tag FROM t",
    "SELECT d + 0.5, sqrt(d), c * 1.5, CAST(b AS DOUBLE) / 3, tag FROM t",
    # aggregates: global, grouped, with a predicate
    "SELECT MIN(a), MAX(a), SUM(a), MIN(b), MAX(b), SUM(b), MIN(c), MAX(c), SUM(c), "
    "MIN(d), MAX(d), SUM(d), AVG(d), AVG(a), COUNT(d) FROM t",
    "SELECT k, MIN(a), MAX(b), SUM(c), MIN(d), MAX(d), SUM(d), COUNT(c) FROM t GROUP BY k",
    "SELECT k, COUNT(1), SUM(a) FROM t WHERE c > 5 AND d < 9223372036854775808 GROUP BY k",
    "SELECT a, COUNT(1), MAX(d) FROM t WHERE b > 100 GROUP BY a",
    "SELECT k, MIN(d + 1), MAX(c * 2) FROM t GROUP BY k",
    # keys: GROUP BY, ORDER BY, TopK
    "SELECT d, COUNT(1) FROM t WHERE d > 18446744073709551613 GROUP BY d",
    "SELECT d, tag FROM t ORDER BY d DESC, tag",
    "SELECT d, c, tag FROM t ORDER BY d DESC LIMIT 20",
    "SELECT c, a, tag FROM t ORDER BY c, a DESC LIMIT 50",
]


@pytest.mark.parametrize("sql", SQL)
def test_unsigned_queries_match_jax_package(sql):
    jctx, tctx = contexts(unsigned_table())
    ordered = "ORDER BY" in sql
    assert_same(tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql)), ordered)


@pytest.mark.parametrize("sql", [
    "SELECT c % -3 FROM t",
    "SELECT d > -1 FROM t",
    "SELECT c + k FROM t",
    "SELECT d - k FROM t",
    "SELECT a FROM t WHERE b < -2",
])
def test_unsigned_against_signed_raises_as_jax_package(sql):
    jctx, tctx = contexts(unsigned_table(10))
    with pytest.raises(jdf.PlanError) as want:
        jax_collect(jctx.sql(sql))
    with pytest.raises(tdf.PlanError) as got:
        tdf.collect(tctx.sql(sql))
    assert str(got.value) == str(want.value)


def test_unsigned_join_keys_match():
    """A UInt32 key and a UInt64 key in the upper half (2^64-1-i) join
    on the device (dense build), as in the JAX package; a UInt64 key
    whose values straddle 2^63 reads as a range near 2^64 and takes the
    host index."""
    left = unsigned_table(2000, seed=3)
    rng = np.random.default_rng(4)
    straddle = np.array([(1 << 63) - 100 + i for i in range(200)], np.uint64)
    right = jax_table([("c2", T.UINT32, False), ("d2", T.UINT64, False),
                       ("e2", T.UINT64, False), ("w", T.INT64, False)],
                      [np.arange(200, dtype=np.uint32) * 7,
                       np.array([2**64 - 1 - i for i in range(200)], np.uint64),
                       straddle, rng.integers(0, 100, 200)])
    for dense, sql in ((True, "SELECT tag, w, c2, d FROM t JOIN r ON t.c = r.c2"),
                       (True, "SELECT tag, w, d2, c FROM t JOIN r ON t.d = r.d2"),
                       (False, "SELECT tag, w, e2, c FROM t JOIN r ON t.d = r.e2")):
        LEDGER.clear()  # the JAX package pins builds by table name
        jctx, tctx = contexts(left)
        jctx.register_datasource("r", right)
        tctx.register_datasource("r", carry(right))
        rel = tctx.sql(sql)
        got = tdf.collect(rel)
        assert_same(got, jax_collect(jctx.sql(sql)), ordered=False)
        assert got.num_rows > 0 and _join(rel)._artifact.dense is dense


def _join(rel):
    while not isinstance(rel, HashJoinRelation):
        rel = rel.child
    return rel
