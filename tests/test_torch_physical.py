"""The `PhysicalPlan` executor: `ExecutionContext.execute_physical`
(Interactive, Write, Show) and `ResultTable.to_csv` / `pretty`.

The same plan goes through both packages on the CPU: planned by the
JAX package, carried to the port as its JSON (`PhysicalPlan.to_json` /
`from_json`).  Write must leave the same bytes on disk, Show the same
rows and the same `pretty` text, Interactive the same relation's rows.
The table holds NULLs, Utf8, Float64 and unsigned columns (UInt32, and
UInt64 above 2^63); the plans filter, project and sort, so every value
is exact and the bytes compare.
"""

from __future__ import annotations

import numpy as np
import pytest

from datafusion_tpu.parallel.physical import PhysicalPlan as JaxPhysicalPlan
from datafusion_tpu.sql.parser import parse_sql as jax_parse_sql

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.errors import NotSupportedError
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.parallel.physical import PhysicalPlan

from test_torch_pipeline import T, contexts, jax_collect, jax_table

SQL = [
    "SELECT k, v, u, c, i FROM t WHERE i % 3 <> 1 ORDER BY i",
    "SELECT k, v * 2, u, c + 1 FROM t ORDER BY i DESC LIMIT 40",
    "SELECT i, k FROM t WHERE v > 10.5 ORDER BY i",
]


def mixed_table(n=300, seed=3, batch_rows=128):
    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "beta", "gamma, with a comma", 'quote "q"', "ünïcode", ""])
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    u64[:4] = np.asarray([0, 2**63, 2**64 - 1, 2**63 - 1], np.uint64)
    v = np.round(rng.uniform(-1e4, 1e4, n), 3)
    v[:3] = [0.1, -0.0, 1e300]
    cols = [words[rng.integers(0, len(words), n)], v, u64,
            rng.integers(0, 2**32 - 1, n, dtype=np.uint32, endpoint=True), np.arange(n)]
    validity = [rng.random(n) > 0.1, rng.random(n) > 0.1, rng.random(n) > 0.1, None, None]
    return jax_table([("k", T.UTF8, True), ("v", T.FLOAT64, True), ("u", T.UINT64, True),
                      ("c", T.UINT32, False), ("i", T.INT64, False)],
                     cols, validity, batch_rows)


def _plans(jctx, sql, kind, **kw):
    jplan = JaxPhysicalPlan(kind, jctx._plan(jax_parse_sql(sql)), **kw)
    return jplan, PhysicalPlan.from_json(jplan.to_json())


@pytest.mark.parametrize("sql", SQL)
def test_write_leaves_the_jax_packages_bytes(sql, tmp_path):
    jctx, tctx = contexts(mixed_table())
    jpath, tpath = tmp_path / "jax.csv", tmp_path / "port.csv"
    jplan, tplan = _plans(jctx, sql, "write", filename=str(jpath), file_format="csv")
    tplan.filename = str(tpath)
    jn = jctx.execute_physical(jplan)
    tn = tctx.execute_physical(tplan)
    assert tn == jn > 0
    assert tpath.read_bytes() == jpath.read_bytes()
    body = tpath.read_bytes()
    assert b",," in body or b",\r\n" in body  # a NULL wrote an empty field


@pytest.mark.parametrize("sql", SQL)
def test_show_gives_the_same_rows_and_pretty_text(sql):
    jctx, tctx = contexts(mixed_table())
    jplan, tplan = _plans(jctx, sql, "show", count=25)
    jt = jctx.execute_physical(jplan)
    tt = tctx.execute_physical(tplan)
    assert tt.num_rows == jt.num_rows == 25
    assert tt.to_rows() == jt.to_rows()
    for max_rows in (50, 10, 0):
        assert tt.pretty(max_rows) == jt.pretty(max_rows)
    assert "NULL" in tt.pretty()


def test_interactive_returns_the_relation():
    jctx, tctx = contexts(mixed_table())
    jplan, tplan = _plans(jctx, SQL[0], "interactive")
    rel = tctx.execute_physical(tplan)
    assert isinstance(rel, Relation)
    assert tdf.collect(rel).to_rows() == jax_collect(jctx.execute_physical(jplan)).to_rows()


def test_to_csv_without_header_and_of_a_result(tmp_path):
    jctx, tctx = contexts(mixed_table())
    jt = jax_collect(jctx.sql(SQL[0]))
    tt = tdf.collect(tctx.sql(SQL[0]))
    for header in (True, False):
        jt.to_csv(str(tmp_path / "j.csv"), header=header)
        tt.to_csv(str(tmp_path / "t.csv"), header=header)
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert (tmp_path / "t.csv").read_text(encoding="utf-8").splitlines()[0] != "k,v,u,c,i"


def test_write_to_another_format_raises(tmp_path):
    jctx, tctx = contexts(mixed_table())
    _, tplan = _plans(jctx, SQL[0], "write", filename=str(tmp_path / "x.parquet"),
                      file_format="parquet")
    with pytest.raises(NotSupportedError, match="write format 'parquet' not supported"):
        tctx.execute_physical(tplan)
    assert not (tmp_path / "x.parquet").exists()


def test_pretty_of_an_empty_result_matches():
    jctx, tctx = contexts(mixed_table())
    sql = "SELECT k, i FROM t WHERE i < 0"
    assert tdf.collect(tctx.sql(sql)).pretty() == jax_collect(jctx.sql(sql)).pretty()
