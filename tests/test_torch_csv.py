"""PyTorch/CUDA port, slice 6: the CSV scan, against the JAX package.

The port reads CSV with its own C++ parser
(`datafusion_tpu_torch/native/csv.cpp`, built on first use into
`build/native/<hash>/`, bound by `native/csv.py`), which follows the
JAX package's default reader.  Here its ctypes bridge is held against
the JAX package's default `CsvReader` (pyarrow) on the fixtures of
`test/data/`: values exactly, validity, and dictionary codes with their
dictionaries, with and without a projection; the edge cases where the
two could part are in `tests/test_torch_csv_semantics.py`.  A
malformed file raises IoError, and so does a build without a compiler
or one that fails.

Then the golden corpus of `test/data/expected/` runs through the port
on the CSV fixtures, with the exclusions and reasons of
tests/test_golden_corpus.py (the empty int8-vs-literal goldens, the
MIN/MAX(c_utf8) artifact) and its queries; the Parquet goldens run in
`tests/test_torch_parquet.py`, over the port's Parquet reader.  Last, the
reference's `examples/csv_sql.rs` query over `uk_cities.csv` (18 rows)
and bench config 1's SQL over a generated cities CSV give the JAX
package's rows.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.io.readers import CsvReader as JaxCsvReader

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import native
from datafusion_tpu_torch.native.csv import NativeCsvReader

from test_golden_corpus import (
    ALL_TYPES_SCHEMA,
    CAST_CASES,
    DATA,
    FILTER_CASES,
    NULL_TEST_SCHEMA,
    NUMERIC_OPS,
    NUMERICS_SCHEMA,
    UK_SCHEMA,
    _eq,
    _parse_field,
    _value,
    assert_rows_match,
    golden_lines,
)
from test_torch_pipeline import assert_same, jax_collect

FIXTURES = [
    ("uk_cities.csv", UK_SCHEMA, False),
    ("all_types_flat.csv", ALL_TYPES_SCHEMA, False),
    ("null_test.csv", NULL_TEST_SCHEMA, True),
    ("numerics.csv", NUMERICS_SCHEMA, True),
]


def port_schema(schema):
    return tdf.Schema.from_json(schema.to_json())


def _scan(reader):
    """Every batch's live rows: columns, validity (None = all valid)
    and the final dictionaries."""
    cols, valids, dicts = [], [], None
    for b in reader.batches():
        cols.append([np.asarray(c)[: b.num_rows] for c in b.data])
        valids.append([None if v is None else np.asarray(v)[: b.num_rows]
                       for v in b.validity])
        dicts = b.dicts
    ncols = len(reader.out_schema)
    out_c = [np.concatenate([c[i] for c in cols]) for i in range(ncols)]
    out_v = []
    for i in range(ncols):
        parts = [np.ones(len(c[i]), bool) if v[i] is None else v[i]
                 for c, v in zip(cols, valids)]
        v = np.concatenate(parts)
        out_v.append(None if v.all() else v)
    return out_c, out_v, [None if d is None else list(d.values) for d in dicts]


@pytest.mark.parametrize("batch_size", [7, 4096])
@pytest.mark.parametrize("name,schema,header", FIXTURES, ids=[f[0] for f in FIXTURES])
@pytest.mark.parametrize("projection", [None, "reversed"])
def test_reader_matches_jax_csv_reader(name, schema, header, batch_size, projection):
    path = os.path.join(DATA, name)
    proj = None if projection is None else list(range(len(schema)))[::-1][:3]
    want = _scan(JaxCsvReader(path, schema, header, batch_size, proj))
    got = _scan(NativeCsvReader(path, port_schema(schema), header, batch_size, proj))
    for gc, wc in zip(got[0], want[0]):
        assert gc.dtype == wc.dtype
        np.testing.assert_array_equal(gc, wc)
    for gv, wv in zip(got[1], want[1]):
        assert (gv is None) == (wv is None)
        if gv is not None:
            np.testing.assert_array_equal(gv, wv)
    assert got[2] == want[2]  # dictionary codes in first-seen order


def test_source_projection_and_rescan_keep_codes():
    path = os.path.join(DATA, "uk_cities.csv")
    src = tdf.CsvDataSource(path, port_schema(UK_SCHEMA), False, 10)
    proj = src.with_projection([2, 0])
    assert proj.schema.names() == ["lng", "city"]
    first = [b.data[1][: b.num_rows].copy() for b in proj.batches()]
    again = [b.data[1][: b.num_rows].copy() for b in proj.batches()]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert sum(len(a) for a in first) == 37


@pytest.mark.parametrize("text,why", [
    ("a,b\n1,2\n3\n", "fields"),
    ("a,b\n1,2\nx,4\n", "bad int"),
    ("a,b\n1,\"2\n", "unterminated"),
])
def test_malformed_file_raises_io_error(tmp_path, text, why):
    path = tmp_path / "bad.csv"
    path.write_text(text)
    schema = tdf.Schema([tdf.Field("a", tdf.DataType.INT64, True),
                         tdf.Field("b", tdf.DataType.INT64, True)])
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_csv("t", str(path), schema)
    with pytest.raises(tdf.IoError, match=why):
        tdf.collect(ctx.sql("SELECT a, b FROM t"))


def test_missing_file_raises_io_error(tmp_path):
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_csv("t", str(tmp_path / "absent.csv"), port_schema(UK_SCHEMA))
    with pytest.raises(tdf.IoError, match="cannot open"):
        tdf.collect(ctx.sql("SELECT city FROM t"))


def test_library_builds_into_a_directory_of_its_own(tmp_path):
    before = {p.name: p.stat().st_mtime for p in native.SOURCE.parent.iterdir()}
    path = native.build_library(tmp_path)
    assert path.exists() and path.parent.parent == tmp_path
    assert path.name == native.LIB_NAME
    assert native.build_library(tmp_path) == path  # built once
    # nothing is written into the source directory
    assert {p.name: p.stat().st_mtime for p in native.SOURCE.parent.iterdir()} == before


@pytest.mark.parametrize("cxx", ["no-such-compiler-here", "false"])
def test_build_without_a_working_compiler_raises_io_error(tmp_path, cxx):
    with pytest.raises(tdf.IoError):
        native.build_library(tmp_path / "x", cxx=cxx)
    assert not list((tmp_path).rglob("*.so"))


# -- the golden corpus, through the port --


@pytest.fixture(scope="module")
def ctx():
    c = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4096)
    c.register_csv("all_types", os.path.join(DATA, "all_types_flat.csv"),
                   port_schema(ALL_TYPES_SCHEMA), has_header=False)
    c.register_csv("null_test", os.path.join(DATA, "null_test.csv"),
                   port_schema(NULL_TEST_SCHEMA), has_header=True)
    c.register_csv("numerics", os.path.join(DATA, "numerics.csv"),
                   port_schema(NUMERICS_SCHEMA), has_header=True)
    c.register_csv("uk_cities", os.path.join(DATA, "uk_cities.csv"),
                   port_schema(UK_SCHEMA), has_header=False)
    return c


def q(ctx, sql):
    return tdf.collect(ctx.sql(sql))


@pytest.mark.parametrize("name,sql", FILTER_CASES + CAST_CASES,
                         ids=[c[0] for c in FILTER_CASES + CAST_CASES])
def test_filter_and_cast_goldens(ctx, name, sql):
    assert_rows_match(q(ctx, sql), name)


def test_query_all_types_golden(ctx):
    table = q(ctx, "SELECT c_bool, c_uint8, c_uint16, c_uint32, c_uint64, c_int8, "
                   "c_int16, c_int32, c_int64, c_float32, c_float64, c_utf8 "
                   "FROM all_types WHERE c_float64 < 0.1")
    assert_rows_match(table, "csv_query_all_types.csv", ncols=12)


@pytest.mark.parametrize("name,sql", [
    ("is_null_csv.csv", "SELECT c_int FROM null_test WHERE c_float IS NULL"),
    ("is_not_null_csv.csv", "SELECT c_int FROM null_test WHERE c_float IS NOT NULL"),
])
def test_null_goldens(ctx, name, sql):
    assert_rows_match(q(ctx, sql), name)


@pytest.mark.parametrize("name,op", NUMERIC_OPS, ids=[c[0] for c in NUMERIC_OPS])
def test_numerics_goldens(ctx, name, op):
    sql = (f"SELECT a {op} b, a {op} 2, a {op} 2.5, "
           f"a_f {op} b_f, a_f {op} 2, a_f {op} 2.5 FROM numerics")
    assert_rows_match(q(ctx, sql), name)


def test_csv_aggregate_goldens(ctx):
    # the final MIN/MAX(c_utf8) pair is excluded: the golden prints the
    # same string for both (a pre-rewrite artifact)
    table = q(ctx,
              "SELECT COUNT(1), COUNT(c_bool), "
              "MIN(c_bool), MAX(c_bool), MIN(c_uint8), MAX(c_uint8), "
              "MIN(c_uint16), MAX(c_uint16), MIN(c_uint32), MAX(c_uint32), "
              "MIN(c_uint64), MAX(c_uint64), MIN(c_int8), MAX(c_int8), "
              "MIN(c_int16), MAX(c_int16), MIN(c_int32), MAX(c_int32), "
              "MIN(c_int64), MAX(c_int64), MIN(c_float32), MAX(c_float32), "
              "MIN(c_float64), MAX(c_float64) FROM all_types")
    assert_rows_match(table, "csv_aggregate_all_types.csv", left_fields=24)
    table = q(ctx,
              "SELECT c_bool, MIN(c_uint8), MAX(c_uint8), "
              "MIN(c_uint16), MAX(c_uint16), MIN(c_uint32), MAX(c_uint32), "
              "MIN(c_uint64), MAX(c_uint64), MIN(c_int8), MAX(c_int8), "
              "MIN(c_int16), MAX(c_int16), MIN(c_int32), MAX(c_int32), "
              "MIN(c_int64), MAX(c_int64), MIN(c_float32), MAX(c_float32), "
              "MIN(c_float64), MAX(c_float64) FROM all_types GROUP BY c_bool")
    rows = sorted(table.to_rows(), key=lambda r: r[0])  # false, true
    want = golden_lines("csv_aggregate_by_c_bool.csv")
    assert len(rows) == len(want)
    for row, line in zip(rows, want):
        fields = [_parse_field(f) for f in line.split(",")[:21]]
        for g, w in zip([_value(v) for v in row], fields):
            assert _eq(g, w), f"{g!r} != {w!r} in {line[:80]!r}"
    assert_rows_match(
        q(ctx, "SELECT MIN(lat), MAX(lat), MIN(lng), MAX(lng) FROM uk_cities"),
        "test_sql_min_max.csv")


def test_uk_cities_and_cast_goldens(ctx):
    rows = q(ctx, "SELECT city, lat, lng FROM uk_cities WHERE lat > 52.0").to_rows()
    want = golden_lines("test_filter.csv")
    assert len(rows) == len(want)
    for (city, lat, lng), line in zip(rows, want):
        parts = line.split(",")  # city names hold commas
        assert _eq(float(lat), float(parts[-2])) and _eq(float(lng), float(parts[-1]))
        assert ",".join(parts[:-2]) == city
    table = q(ctx, "SELECT c_int, CAST(c_int AS SMALLINT), CAST(c_int AS INT), "
                   "CAST(c_int AS BIGINT), c_float, CAST(c_float AS FLOAT), "
                   "c_string, c_string FROM null_test WHERE c_float < 3.0")
    assert_rows_match(table, "test_cast.csv", left_fields=6)


def _geo_ctx():
    """The console's geo UDFs (datafusion_tpu/cli.py make_context) as
    host functions of the port."""
    from datafusion_tpu.cli import _fmt_float

    D = tdf.DataType
    c = tdf.ExecutionContext(device="cpu", result_cache=False)
    point_t = tdf.StructType([tdf.Field("x", D.FLOAT64, False),
                              tdf.Field("y", D.FLOAT64, False)])

    def st_point(x, y):
        return (np.asarray(x, np.float64), np.asarray(y, np.float64))

    def st_astext(pt):
        return np.asarray([f"POINT ({_fmt_float(a)} {_fmt_float(b)})" for a, b in zip(*pt)],
                          dtype=object)

    c.register_udf("ST_Point", [D.FLOAT64, D.FLOAT64], point_t, host_fn=st_point)
    c.register_udf("ST_AsText", [point_t], D.UTF8, host_fn=st_astext)
    c.register_csv("uk_cities", os.path.join(DATA, "uk_cities.csv"),
                   port_schema(UK_SCHEMA), has_header=False)
    return c


@pytest.mark.parametrize("name,sql", [
    ("test_simple_predicate.csv",
     "SELECT ST_AsText(ST_Point(lat, lng)) FROM uk_cities WHERE lat < 53.0"),
    ("test_chaining_functions.csv", "SELECT ST_AsText(ST_Point(lat, lng)) FROM uk_cities"),
    ("test_sql_udf_udt.csv", "SELECT ST_Point(lat, lng) FROM uk_cities"),
])
def test_geo_udf_goldens(name, sql):
    table = tdf.collect(_geo_ctx().sql(sql))
    assert [r[0] for r in table.to_rows()] == golden_lines(name)


@pytest.mark.parametrize("name,sql", [
    ("test_sqrt.csv", "SELECT c_int, sqrt(c_int) FROM t"),
    ("test_limit.csv", "SELECT c_int, sqrt(c_int) FROM t LIMIT 5"),
])
def test_sqrt_and_limit_goldens(name, sql):
    schema = tdf.Schema([tdf.Field("c_int", tdf.DataType.INT64, False)])
    c = tdf.ExecutionContext(device="cpu", result_cache=False)
    c.register_datasource("t", tdf.MemoryDataSource(
        schema, [tdf.make_host_batch(schema, [np.arange(1, 11, dtype=np.int64)])]))
    assert_rows_match(tdf.collect(c.sql(sql)), name)


# -- the reference's example and bench config 1, against the JAX package --


def _both_csv(path, schema, header, sql, batch_size):
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch_size)
    jctx.register_csv("cities", path, schema, has_header=header)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=batch_size)
    tctx.register_csv("cities", path, port_schema(schema), has_header=header)
    return assert_same(tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql)))


def test_reference_csv_sql_example_matches():
    rows = _both_csv(os.path.join(DATA, "uk_cities.csv"), UK_SCHEMA, False,
                     "SELECT city, lat, lng, lat + lng FROM cities "
                     "WHERE lat > 51.0 AND lat < 53", 131072)
    assert len(rows) == 18


def write_cities_csv(path, rows: int, seed: int = 7):
    """A cities CSV with benchmarks/data.py cities_csv's distributions
    (2,000 names, lat and lng uniform and rounded to 6 places); floats
    written in their shortest round-trip form."""
    rng = np.random.default_rng(seed)
    pool = np.array([f"city_{i:04d}" for i in range(2000)])
    city = pool[rng.integers(0, len(pool), rows)]
    lat = np.round(rng.uniform(49.9, 59.0, rows), 6)
    lng = np.round(rng.uniform(-7.6, 1.8, rows), 6)
    with open(path, "w") as f:
        f.write("city,lat,lng\n")
        f.write("\n".join(map("{},{!r},{!r}".format, city.tolist(), lat.tolist(),
                              lng.tolist())))
        f.write("\n")
    return city, lat, lng


def test_config1_sql_matches(tmp_path):
    path = str(tmp_path / "cities.csv")
    city, lat, _ = write_cities_csv(path, 30_000)
    schema = jdf.Schema([jdf.Field("city", jdf.DataType.UTF8, False),
                         jdf.Field("lat", jdf.DataType.FLOAT64, False),
                         jdf.Field("lng", jdf.DataType.FLOAT64, False)])
    rows = _both_csv(path, schema, True,
                     "SELECT city, lat, lng, lat + lng FROM cities "
                     "WHERE lat > 51.0 AND lat < 53.0", 1 << 12)
    keep = (lat > 51.0) & (lat < 53.0)
    assert len(rows) == int(keep.sum())
    assert [r[0] for r in rows] == city[keep].tolist()
