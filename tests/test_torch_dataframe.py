"""PyTorch/CUDA port, slice 10: the DataFrame API
(`datafusion_tpu_torch/dataframe.py`) against the JAX package's.

The cases of the JAX package's `tests/test_dataframe.py`, each built
the same way in both packages over the same CSV, with the same rows
(floats within rtol 1e-9) and the same plan text; then TPC-H Q1 through
`ctx.table(...).filter(...).aggregate(...)` at a small scale against
the SQL Q1 of both packages.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import datafusion_tpu as jdf

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec.aggregate import AggregateRelation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")


def uk_schema(pkg):
    return pkg.Schema([pkg.Field("city", pkg.DataType.UTF8, False),
                       pkg.Field("lat", pkg.DataType.FLOAT64, False),
                       pkg.Field("lng", pkg.DataType.FLOAT64, False)])


def contexts():
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4096)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4096)
    for pkg, ctx in ((jdf, jctx), (tdf, tctx)):
        ctx.register_csv("uk_cities", os.path.join(DATA, "uk_cities.csv"), uk_schema(pkg),
                         has_header=False)
    return jctx, tctx


def same(got, want, ordered=True):
    g, w = got.to_rows(), want.to_rows()
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert np.isclose(x, y, rtol=1e-9, atol=0.0), (a, b)
            else:
                assert x == y, (a, b)


def select_filter(pkg, df):
    lit = pkg.lit
    return (df.filter(df.col("lat").gt(lit(51.0)).and_(df.col("lat").lt(lit(53.0))))
            .select("city", "lat", "lng", df.col("lat") + df.col("lng")))


def aggregate(pkg, df):
    f = pkg.f
    return df.aggregate([], [f.min(df.col("lat")), f.max(df.col("lat")), f.count(),
                             f.avg(df.col("lng"))])


def sort_limit(pkg, df):
    return df.select("city", "lat").sort(df.col("lat").sort(asc=False)).limit(3)


def explain_shape(pkg, df):
    return df.filter(df.col("lat").gt(pkg.lit(51.0))).select("city")


BUILDS = {
    "select_filter": (select_filter, "SELECT city, lat, lng, lat + lng FROM uk_cities "
                                     "WHERE lat > 51.0 AND lat < 53"),
    "aggregate": (aggregate, "SELECT MIN(lat), MAX(lat), COUNT(1), AVG(lng) FROM uk_cities"),
    "sort_limit": (sort_limit, "SELECT city, lat FROM uk_cities ORDER BY lat DESC LIMIT 3"),
    "explain_shape": (explain_shape, None),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_dataframe_matches_the_jax_dataframe_and_sql(case):
    build, sql = BUILDS[case]
    jctx, tctx = contexts()
    jdf_ = build(jdf, jctx.table("uk_cities"))
    tdf_ = build(tdf, tctx.table("uk_cities"))
    assert isinstance(tdf_, tdf.DataFrame)
    assert tdf_.explain() == jdf_.explain()
    assert tdf_.logical_plan().to_json_str() == jdf_.logical_plan().to_json_str()
    got = tdf_.collect()
    same(got, jdf_.collect())
    assert tdf_.to_pylist() == got.to_pylist()
    if sql is not None:
        same(got, tctx.sql_collect(sql))
    text = tdf_.explain()
    assert "Projection" in text or "Aggregate" in text or "Limit" in text


def test_grouped_aggregate(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("k,v\na,1\nb,2\na,3\nb,4\nb,5\n")
    out = {}
    for pkg in (jdf, tdf):
        schema = pkg.Schema([pkg.Field("k", pkg.DataType.UTF8, False),
                             pkg.Field("v", pkg.DataType.INT64, False)])
        c = (pkg.ExecutionContext(device="cpu", result_cache=False) if pkg is jdf
             else pkg.ExecutionContext(device="cpu", result_cache=False))
        c.register_csv("t", str(path), schema)
        df = c.table("t")
        got = df.aggregate(["k"], [pkg.f.sum(df.col("v")), pkg.f.count(df.col("v"))]).collect()
        out[pkg] = sorted(got.to_rows())
    assert out[tdf] == out[jdf] == [("a", 4, 2), ("b", 11, 3)]


def test_col_errors():
    _, tctx = contexts()
    with pytest.raises(tdf.DataFusionError):
        tctx.table("uk_cities").col("nope")
    with pytest.raises(tdf.ExecutionError):
        tctx.table("nope")
    with pytest.raises(tdf.PlanError):
        tctx.table("uk_cities").function("nosuch", 1)


def test_df_udf_udt_golden():
    """The DataFrame twin of the golden test_sql_udf_udt query, through
    the console's geo UDFs."""
    from datafusion_tpu_torch.cli import make_context

    c = make_context("cpu")
    c.register_csv("uk_cities", os.path.join(DATA, "uk_cities.csv"), uk_schema(tdf),
                   has_header=False)
    df = c.table("uk_cities")
    got = df.select(df.function("ST_Point", df.col("lat"), df.col("lng"))).collect()
    want = [line for line in open(os.path.join(DATA, "expected", "test_df_udf_udt.csv"),
                                  encoding="utf-8").read().splitlines() if line]
    assert [r[0] for r in got.to_rows()] == want


# ------------------------------------------------------------ Q1

Q1 = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity), SUM(l_extendedprice), "
      "SUM(l_extendedprice * (1 - l_discount)), "
      "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
      "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(1) "
      "FROM lineitem WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus")


def q1_dataframe(pkg, df):
    """TPC-H Q1 with the DataFrame API: the same eight aggregates."""
    f, lit, c = pkg.f, pkg.lit, df.col
    disc_price = c("l_extendedprice") * (lit(1.0) - c("l_discount"))
    charge = disc_price * (lit(1.0) + c("l_tax"))
    return (df.filter(c("l_shipdate").lt_eq(lit("1998-09-02")))
            .aggregate(["l_returnflag", "l_linestatus"],
                       [f.sum(c("l_quantity")), f.sum(c("l_extendedprice")),
                        f.sum(disc_price), f.sum(charge), f.avg(c("l_quantity")),
                        f.avg(c("l_extendedprice")), f.avg(c("l_discount")), f.count()]))


def lineitem_csv(path, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    base = np.datetime64("1992-01-02")
    ship = rng.integers(0, 2526, n)
    old = ship < 1263
    flag = np.where(old, rng.integers(0, 2, n) * 2, 1)
    with open(path, "w") as fh:
        fh.write("l_returnflag,l_linestatus,l_quantity,l_extendedprice,l_discount,l_tax,"
                 "l_shipdate\n")
        for i in range(n):
            fh.write(f"{'ANR'[flag[i]]},{'FO'[int(ship[i] >= 1578)]},"
                     f"{float(rng.integers(1, 51))!r},{float(round(rng.uniform(900, 104950), 2))!r},"
                     f"{float(rng.integers(0, 11) / 100)!r},{float(rng.integers(0, 9) / 100)!r},"
                     f"{base + np.timedelta64(int(ship[i]), 'D')}\n")


LINEITEM_DDL = ("CREATE EXTERNAL TABLE lineitem (l_returnflag VARCHAR, l_linestatus VARCHAR, "
                "l_quantity DOUBLE, l_extendedprice DOUBLE, l_discount DOUBLE, l_tax DOUBLE, "
                "l_shipdate VARCHAR) STORED AS CSV WITH HEADER ROW LOCATION '{}'")


def test_q1_through_the_dataframe_equals_sql_q1(tmp_path):
    path = tmp_path / "lineitem.csv"
    lineitem_csv(path)
    out = {}
    for pkg in (jdf, tdf):
        ctx = (pkg.ExecutionContext(device="cpu", result_cache=False, batch_size=512)
               if pkg is jdf else pkg.ExecutionContext(device="cpu", result_cache=False,
                                                        batch_size=512))
        ctx.sql(LINEITEM_DDL.format(path))
        frame = q1_dataframe(pkg, ctx.table("lineitem"))
        out[pkg] = (frame.collect(), ctx.sql_collect(Q1), frame)
    same(out[tdf][0], out[tdf][1], ordered=False)
    same(out[tdf][0], out[jdf][0], ordered=False)
    same(out[tdf][1], out[jdf][1], ordered=False)
    assert out[tdf][0].num_rows == 4
    # the DataFrame lowers to the SQL path's one aggregate operator
    from datafusion_tpu_torch.sql.optimizer import push_down_projection

    ctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=512)
    ctx.sql(LINEITEM_DDL.format(path))
    rel = ctx.execute(push_down_projection(out[tdf][2].logical_plan()))
    assert isinstance(rel, AggregateRelation)
