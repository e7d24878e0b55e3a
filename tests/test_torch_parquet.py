"""PyTorch/CUDA port, slice 20: Parquet through the port's own native
reader (`native/parquet.cpp` bound by `native/parquet.py`), against the
JAX package's pyarrow `ParquetReader`.

Each case reads one file with both readers and compares the
concatenated columns exactly: values bit for bit, validity, the codes
of Utf8 columns and the global dictionaries they index, in order, and
the inferred schemas (or the error each package raises).  The files:
the three fixtures of `test/data/`; files pyarrow writes here with a
column for every type `infer_parquet_schema` accepts, with and without
NULLs, as data page v1 and v2, UNCOMPRESSED and SNAPPY (the other
codecs: `tests/test_torch_parquet_codecs.py`), with the dictionary on
and off, in several row groups read at a batch size that
divides none of them; a high-cardinality Utf8 column and a
`benchmarks/data.py` lineitem at SF 0.05 (300,000 rows), both of which
fall back from dictionary to PLAIN pages partway through a chunk.  Q1,
`SELECT *` and a GROUP BY over that lineitem give the JAX package's rows
through `ctx.sql_collect` (floats within rtol 1e-9).

Then what only the port has: a projected scan never reads an
unprojected column chunk (one overwritten with garbage changes no
answer), a ZSTD file reads as the JAX package reads it and a corrupt
ZSTD page raises IoError naming the codec and the column, a BROTLI file
reads as the JAX package reads it and a corrupt BROTLI page raises
IoError naming the codec and the column, an LZO chunk raises IoError
naming the codec and the column, nested fields
raise ExecutionError as in the JAX package, `chip_smoke.py`'s Parquet
writer gives a file that pyarrow reads back as `lineitem_sf1`'s
columns, the fixtures equal their CSV twins but for the one cell that
differs, truncated and bit-flipped fixtures (hypothesis, in a
subprocess under an address-space limit) raise IoError or
ExecutionError or read, never crash, and the `io.read` fault site
reaches a Parquet and an NDJSON scan in both packages alike.  The
Parquet goldens of `tests/test_golden_corpus.py` run through the port
with that file's exclusions.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.io.readers import ParquetReader as JaxParquetReader
from datafusion_tpu.io.readers import infer_parquet_schema as jax_infer
from datafusion_tpu.testing import faults as jax_faults

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.io.readers import ParquetReader, infer_parquet_schema
from datafusion_tpu_torch.testing import faults as port_faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
ROWS, ROW_GROUP, BATCH = 3000, 1100, 700  # the batch divides no row group

Q1 = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity), SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), AVG(l_quantity), "
    "AVG(l_extendedprice), AVG(l_discount), COUNT(1) FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus"
)


def port_schema(schema):
    return tdf.Schema.from_json(schema.to_json())


def read_all(reader):
    """(values, validity) per column over every batch, and the
    dictionaries' strings."""
    batches = list(reader.batches())
    cols = []
    for i in range(len(reader.out_schema)):
        vals = [np.asarray(b.data[i])[:b.num_rows] for b in batches]
        valid = [np.ones(b.num_rows, bool) if b.validity[i] is None
                 else np.asarray(b.validity[i])[:b.num_rows] for b in batches]
        cols.append((np.concatenate(vals), np.concatenate(valid)))
    dicts = [None if d is None else list(d.values) for d in reader.dicts]
    return cols, dicts, [b.num_rows for b in batches]


def assert_same_read(path, schema=None, batch_size=BATCH, projection=None):
    """Both readers over `path`: the same schema, columns, validity and
    dictionaries.  Returns the port's batch sizes."""
    if schema is None:
        schema = jax_infer(path)
        assert infer_parquet_schema(path).to_json() == schema.to_json()
    want = read_all(JaxParquetReader(path, schema, batch_size, projection))
    reader = ParquetReader(path, port_schema(schema), batch_size, projection)
    got = read_all(reader)
    for f, (gv, gm), (wv, wm) in zip(reader.out_schema.fields, got[0], want[0]):
        assert gv.dtype == wv.dtype, (f.name, gv.dtype, wv.dtype)
        assert np.array_equal(gm, wm), f.name
        assert gv.tobytes() == wv.tobytes(), (f.name, gv[:8], wv[:8])
    assert got[1] == want[1]
    return got[2]


def test_reader_imports_no_pyarrow():
    code = ("import sys\nsys.modules['pyarrow'] = None\n"
            "import datafusion_tpu_torch.io.readers, datafusion_tpu_torch.native.parquet\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------ the fixtures

FIXTURES = ["uk_cities", "all_types_flat", "alltypes_plain"]
ALLTYPES_PLAIN_DDL = ("CREATE EXTERNAL TABLE t (id INT, bool_col BOOLEAN, int_col INT, "
                      "bigint_col BIGINT, float_col FLOAT, double_col DOUBLE, "
                      "string_col VARCHAR) STORED AS PARQUET LOCATION '{}'")


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("batch_size", [3, 131072])
def test_fixture_reads_equal_the_jax_reader(name, batch_size):
    path = os.path.join(DATA, f"{name}.parquet")
    if name == "alltypes_plain":  # its binary columns stop inference: declare them
        with pytest.raises(jdf.ExecutionError) as want:
            jax_infer(path)
        with pytest.raises(tdf.ExecutionError) as got:
            infer_parquet_schema(path)
        assert str(got.value) == str(want.value)
        ctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.sql(ALLTYPES_PLAIN_DDL.format(path))
        schema = ctx.datasources["t"].schema
        assert_same_read(path, schema, batch_size)
        # a timestamp (INT96) and dates read as Utf8 become ISO strings
        extra = jdf.Schema([jdf.Field("timestamp_col", jdf.DataType.UTF8),
                            jdf.Field("date_string_col", jdf.DataType.UTF8),
                            jdf.Field("tinyint_col", jdf.DataType.INT8)])
        assert_same_read(path, extra, batch_size)
        return
    assert_same_read(path, None, batch_size)
    assert_same_read(path, None, batch_size, projection=[len(jax_infer(path)) - 1, 0])


BLOCKED_PYARROW = r"""
import json, sys
sys.modules["pyarrow"] = None
sys.modules["pyarrow.parquet"] = None
import datafusion_tpu_torch as t
out = {}
for name, ddl, sql in json.loads(sys.argv[1]):
    ctx = t.ExecutionContext(device="cpu", result_cache=False)
    ctx.sql(ddl)
    out[name] = [list(r) for r in ctx.sql_collect(sql).to_rows()]
assert not any(m.split(".")[0] == "pyarrow" for m, v in sys.modules.items() if v)
print(json.dumps(out, default=bytes.decode))  # binary columns hold bytes
"""


def test_every_fixture_reads_with_pyarrow_blocked():
    """The three fixtures through CREATE EXTERNAL TABLE ... STORED AS
    PARQUET in a process where pyarrow cannot be imported (as on the
    card's machine), against the JAX package's rows for the same SQL."""
    import json

    cases = [
        ("uk_cities", f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION "
                      f"'{DATA}/uk_cities.parquet'", "SELECT city, lat, lng FROM t"),
        ("all_types_flat", f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION "
                           f"'{DATA}/all_types_flat.parquet'", "SELECT * FROM t"),
        ("alltypes_plain", ALLTYPES_PLAIN_DDL.format(f"{DATA}/alltypes_plain.parquet"),
         "SELECT * FROM t"),
    ]
    out = subprocess.run([sys.executable, "-c", BLOCKED_PYARROW, json.dumps(cases)],
                         cwd=REPO, capture_output=True, text=True, timeout=180,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name, ddl, sql in cases:
        ctx = jdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.sql(ddl)
        want = [list(r) for r in ctx.sql_collect(sql).to_rows()]
        if name == "alltypes_plain":  # bytes do not cross JSON: the JAX rows' strings
            want = [[v.decode() if isinstance(v, bytes) else v for v in r] for r in want]
        assert len(got[name]) == {"uk_cities": 37, "all_types_flat": 256,
                                  "alltypes_plain": 8}[name]
        _same_rows(got[name], want)


def _table_columns(ctx, sql):
    return [list(c) for c in zip(*ctx.sql_collect(sql).to_rows())]


@pytest.mark.parametrize("name", ["uk_cities", "all_types_flat"])
def test_fixtures_equal_their_csv_twins_but_the_pinned_cell(name):
    """What `chip_smoke.phase_parquet` checks on the card: the port's
    Parquet read against its native CSV read of the twin.  The one
    difference, `all_types_flat` row 129 of c_utf8, is the file's (pyarrow
    reads both files so too)."""
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.sql(f"CREATE EXTERNAL TABLE p STORED AS PARQUET LOCATION '{DATA}/{name}.parquet'")
    schema = ctx.datasources["p"].schema
    ctx.register_csv("c", os.path.join(DATA, f"{name}.csv"), schema, has_header=False)
    got, want = _table_columns(ctx, "SELECT * FROM p"), _table_columns(ctx, "SELECT * FROM c")
    diffs = [(f.name, i) for f, g, w in zip(schema.fields, got, want)
             for i, (a, b) in enumerate(zip(g, w)) if a != b]
    assert [len(c) for c in got] == [len(c) for c in want]
    if name == "uk_cities":
        assert diffs == [] and len(got[0]) == 37
        return
    assert diffs == [("c_utf8", 129)]
    j = schema.names().index("c_utf8")
    assert got[j][129] == "\x15" + want[j][129]
    import pyarrow.csv as pacsv

    arrow = pq.read_table(os.path.join(DATA, f"{name}.parquet"))
    twin = pacsv.read_csv(os.path.join(DATA, f"{name}.csv"),
                          read_options=pacsv.ReadOptions(column_names=arrow.column_names),
                          convert_options=pacsv.ConvertOptions(column_types=arrow.schema))
    assert arrow.column("c_utf8")[129].as_py() == "\x15" + twin.column("c_utf8")[129].as_py()


# ------------------------------------------------------------ the Parquet goldens

ALL_TYPES_COLUMNS = ("c_bool, c_uint8, c_uint16, c_uint32, c_uint64, c_int8, c_int16, "
                     "c_int32, c_int64, c_float32, c_float64, c_utf8")
MIN_MAX = ", ".join(f"MIN({c}), MAX({c})" for c in ALL_TYPES_COLUMNS.split(", ")[:-1])


@pytest.fixture(scope="module")
def golden_ctx():
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4096)
    ctx.register_parquet("all_types_pq", os.path.join(DATA, "all_types_flat.parquet"))
    return ctx


def test_parquet_query_all_types_golden(golden_ctx):
    """`tests/test_golden_corpus.py::test_parquet_query_all_types` through
    the port."""
    from test_golden_corpus import assert_rows_match

    table = golden_ctx.sql_collect(
        f"SELECT {ALL_TYPES_COLUMNS} FROM all_types_pq WHERE c_float64 < 0.1")
    assert_rows_match(table, "parquet_query_all_types.csv", ncols=12)


def test_parquet_aggregate_all_types_golden(golden_ctx):
    """`tests/test_golden_corpus.py::test_parquet_aggregate_all_types`
    through the port, with its exclusions (the MIN/MAX(c_utf8) pair and
    the overflowed SUM(c_int32), SUM(c_int64) of the reference)."""
    from test_golden_corpus import _eq, _parse_field, _value, assert_rows_match, golden_lines

    table = golden_ctx.sql_collect(
        f"SELECT COUNT(1), COUNT(c_bool), {MIN_MAX} FROM all_types_pq")
    assert_rows_match(table, "parquet_aggregate_all_types.csv", left_fields=24)
    sums = golden_ctx.sql_collect(
        "SELECT SUM(CAST(c_int8 AS BIGINT)), SUM(CAST(c_int16 AS BIGINT)), "
        "SUM(CAST(c_uint8 AS INT)), SUM(CAST(c_uint16 AS INT)), "
        "SUM(CAST(c_uint32 AS BIGINT)), SUM(c_uint64), SUM(c_float32), SUM(c_float64) "
        "FROM all_types_pq").to_rows()[0]
    tail = [_parse_field(f) for f in
            golden_lines("parquet_aggregate_all_types.csv")[0].split(",")[-10:]]
    want = [tail[0], tail[1], tail[4], tail[5], tail[6], tail[7], tail[8], tail[9]]
    for g, w in zip(sums, want):
        assert _eq(_value(g), w), (g, w)


# ------------------------------------------------------------ pyarrow-written files

def _type_columns(rng, n, nulls):
    """One column for every type infer_parquet_schema accepts."""
    strs = np.array(["alpha", "beta", "", "gamma delta", "ünïcödé", "x" * 40, "7"])
    days = rng.integers(-800, 30000, n)
    ms = rng.integers(-10**12, 4 * 10**12, n)
    cols = {
        "bool": pa.array(rng.integers(0, 2, n).astype(bool)),
        "int8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "int16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "int32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32)),
        "int64": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
        "uint8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "uint16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "uint32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
        "uint64": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64)),
        "float": pa.array(np.concatenate([[np.nan, -0.0, np.inf, -np.inf],
                                          rng.normal(size=n - 4)]).astype(np.float32)),
        "double": pa.array(np.concatenate([[np.nan, -0.0, np.inf, 5e-324],
                                           rng.normal(size=n - 4)])),
        "few_doubles": pa.array(rng.integers(0, 11, n) / 100.0),
        "string": pa.array(strs[rng.integers(0, len(strs), n)].tolist(), pa.string()),
        "large_string": pa.array([f"s{k}" for k in rng.integers(0, 500, n)], pa.large_string()),
        "date32": pa.array(days.astype(np.int32), pa.date32()),
        "date64": pa.array(days * 86_400_000, pa.date64()),
        "timestamp_ms": pa.array(ms, pa.timestamp("ms")),
        "timestamp_us": pa.array(ms * 1000 + rng.integers(0, 1000, n), pa.timestamp("us")),
        "timestamp_ns": pa.array(ms * 10**6 + rng.integers(0, 10**6, n), pa.timestamp("ns")),
        "timestamp_ms_utc": pa.array(ms, pa.timestamp("ms", tz="UTC")),
        "timestamp_us_utc": pa.array(ms * 1000, pa.timestamp("us", tz="UTC")),
    }
    if nulls:
        for k, a in cols.items():
            mask = rng.random(n) < 0.2
            cols[k] = pa.array(a.to_pylist(), a.type, mask=mask)
    return cols


VARIANTS = [(nulls, version, codec, dictionary)
            for nulls in (False, True) for version in ("1.0", "2.0")
            for codec in ("NONE", "SNAPPY") for dictionary in (True, False)]
TYPE_NAMES = list(_type_columns(np.random.default_rng(0), 8, False))


@pytest.fixture(scope="module")
def typed_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("typed")
    out = {}
    for i, (nulls, version, codec, dictionary) in enumerate(VARIANTS):
        rng = np.random.default_rng(100 + i)
        path = str(root / f"v{i}.parquet")
        pq.write_table(pa.table(_type_columns(rng, ROWS, nulls)), path,
                       data_page_version=version, compression=codec,
                       use_dictionary=dictionary, row_group_size=ROW_GROUP,
                       data_page_size=4096)
        out[(nulls, version, codec, dictionary)] = path
    return out


def _variant_id(v):
    nulls, version, codec, dictionary = v
    return (f"{'nulls' if nulls else 'dense'}-v{version[0]}-{codec.lower()}-"
            f"{'dict' if dictionary else 'plain'}")


@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_every_type_equals_the_jax_reader(typed_files, variant):
    path = typed_files[variant]
    sizes = assert_same_read(path)
    assert sum(sizes) == ROWS and max(sizes) <= BATCH
    # batches never span a row group
    edges = np.cumsum(sizes)
    for k in range(ROW_GROUP, ROWS, ROW_GROUP):
        assert k in edges
    md = pq.ParquetFile(path).metadata
    encodings = {e for rg in range(md.num_row_groups) for c in range(md.num_columns)
                 for e in md.row_group(rg).column(c).encodings}
    assert ("RLE_DICTIONARY" in encodings) == variant[3]


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_each_type_alone_equals_the_jax_reader(typed_files, name):
    """Each type projected alone, from the v2 SNAPPY dictionary file with
    NULLs (and, in the same test, the dense v1 PLAIN one)."""
    for variant in ((True, "2.0", "SNAPPY", True), (False, "1.0", "NONE", False)):
        path = typed_files[variant]
        schema = jax_infer(path)
        assert_same_read(path, schema, BATCH, projection=[schema.names().index(name)])


def test_high_cardinality_utf8_falls_back_to_plain(tmp_path):
    rng = np.random.default_rng(5)
    n = 40_000
    strs = [f"key-{k:07d}" for k in rng.integers(0, 30_000, n)]
    strs[:50] = ["key-0000001"] * 50  # a value the dictionary holds reappears in PLAIN pages
    path = str(tmp_path / "hc.parquet")
    pq.write_table(pa.table({"s": pa.array(strs), "v": pa.array(np.arange(n))}), path,
                   dictionary_pagesize_limit=16 * 1024, data_page_size=8 * 1024,
                   row_group_size=25_000)
    md = pq.ParquetFile(path).metadata
    enc = md.row_group(0).column(0).encodings
    assert "RLE_DICTIONARY" in enc and "PLAIN" in enc
    assert_same_read(path, None, 3333)


# ------------------------------------------------------------ lineitem at SF 0.05

@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    """benchmarks/data.py's lineitem at SF 0.05 (300,000 rows, written by
    its pyarrow writer into a temporary directory)."""
    sys.path.insert(0, REPO)
    from benchmarks import data as bdata

    before = bdata.BENCH_DIR
    bdata.BENCH_DIR = str(tmp_path_factory.mktemp("bench"))
    try:
        return bdata.lineitem_parquet(0.05)
    finally:
        bdata.BENCH_DIR = before


def test_lineitem_reads_equal_the_jax_reader(lineitem):
    md = pq.ParquetFile(lineitem).metadata
    price = md.schema.names.index("l_extendedprice")
    enc = md.row_group(0).column(price).encodings
    assert md.num_rows == 300_000 and "RLE_DICTIONARY" in enc and "PLAIN" in enc
    assert_same_read(lineitem, None, 131072)


def _same_rows(got, want):
    """Ints, strings and NULLs exactly, floats within rtol 1e-9, column
    by column."""
    assert len(got) == len(want)
    for g, w in zip(zip(*got), zip(*want)):
        if any(isinstance(v, float) for v in w):
            gv = np.array([np.nan if v is None else v for v in g], np.float64)
            wv = np.array([np.nan if v is None else v for v in w], np.float64)
            assert [v is None for v in g] == [v is None for v in w]
            assert np.allclose(gv, wv, rtol=1e-9, atol=0.0, equal_nan=True)
        else:
            assert list(g) == list(w)


LINEITEM_QUERIES = {
    "q1": Q1,
    "select_star": "SELECT * FROM lineitem",
    "group_by": ("SELECT l_linestatus, l_tax, COUNT(1), SUM(l_extendedprice), "
                 "MIN(l_shipdate), MAX(l_quantity) FROM lineitem WHERE l_discount > 0.04 "
                 "GROUP BY l_linestatus, l_tax"),
}


@pytest.mark.parametrize("query", sorted(LINEITEM_QUERIES))
def test_lineitem_queries_give_the_jax_packages_rows(lineitem, query):
    ddl = f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION '{lineitem}'"
    sql = LINEITEM_QUERIES[query]
    out = []
    for pkg in (jdf, tdf):
        ctx = pkg.ExecutionContext(device="cpu", result_cache=False)
        ctx.sql(ddl)
        rows = ctx.sql_collect(sql).to_rows()
        out.append(sorted(rows, key=lambda r: tuple(map(str, r))) if query != "select_star"
                   else rows)
    _same_rows(out[1], out[0])
    assert len(out[0]) == (300_000 if query == "select_star" else len(out[0]))


def test_projected_scan_never_reads_an_unprojected_chunk(lineitem, tmp_path):
    md = pq.ParquetFile(lineitem).metadata
    j = md.schema.names.index("l_extendedprice")
    blob = bytearray(open(lineitem, "rb").read())
    rng = np.random.default_rng(9)
    for rg in range(md.num_row_groups):
        c = md.row_group(rg).column(j)
        start = min(x for x in (c.dictionary_page_offset, c.data_page_offset) if x)
        blob[start:start + c.total_compressed_size] = rng.integers(
            0, 256, c.total_compressed_size, dtype=np.uint8).tobytes()
    path = str(tmp_path / "garbled.parquet")
    with open(path, "wb") as f:
        f.write(blob)
    sql = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity), COUNT(1) FROM lineitem "
           "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus")
    rows = []
    for p in (lineitem, path):
        ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
        ctx.sql(f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION '{p}'")
        rows.append(sorted(ctx.sql_collect(sql).to_rows()))
    assert rows[0] == rows[1]
    with pytest.raises(tdf.IoError, match="l_extendedprice"):
        ctx.sql_collect("SELECT SUM(l_extendedprice) FROM lineitem")


# ------------------------------------------------------------ what raises

def _patch_codec(path, old, new):
    """Rewrite column chunk codec `old` to `new` in the footer of a
    one-column, one-row-group file (the i32 field 4 of ColumnMetaData,
    one zigzag byte each; the byte is found by trying each candidate
    against pyarrow's reading of the footer)."""
    # pyarrow's names; it calls LZ4_RAW "LZ4" and LZ4 (Hadoop) "UNKNOWN"
    names = {1: "SNAPPY", 3: "LZO", 4: "BROTLI", 5: "UNKNOWN", 7: "LZ4"}
    blob = open(path, "rb").read()
    footer = len(blob) - 8 - int.from_bytes(blob[-8:-4], "little")
    pattern = bytes([0x15, old << 1])
    at = blob.find(pattern, footer)
    while at >= 0:
        patched = blob[:at + 1] + bytes([new << 1]) + blob[at + 2:]
        with open(path, "wb") as f:
            f.write(patched)
        try:
            col = pq.ParquetFile(path).metadata.row_group(0).column(0)
            if col.compression == names[new]:
                return
        except Exception:
            pass
        at = blob.find(pattern, at + 1)
    raise AssertionError(f"no codec {old} field in {path}")


def test_zstd_raises_io_error_naming_the_codec(tmp_path):
    """ZSTD reads now (the JAX package's rows); a ZSTD page that does not
    decode raises IoError naming the codec and the column."""
    path = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"a": pa.array(np.arange(100))}), path, compression="zstd",
                   use_dictionary=False)
    assert_same_read(path)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.sql(f"CREATE EXTERNAL TABLE z STORED AS PARQUET LOCATION '{path}'")
    assert ctx.sql_collect("SELECT a FROM z").to_rows() == [(i,) for i in range(100)]
    blob = bytearray(open(path, "rb").read())
    md = pq.ParquetFile(path).metadata.row_group(0).column(0)
    frame = blob.find(b"\x28\xb5\x2f\xfd", md.data_page_offset)
    assert 0 < frame < md.data_page_offset + md.total_compressed_size
    blob[frame] ^= 0xFF  # the frame's magic
    bad = str(tmp_path / "bad.parquet")
    with open(bad, "wb") as f:
        f.write(blob)
    ctx.sql(f"CREATE EXTERNAL TABLE bad STORED AS PARQUET LOCATION '{bad}'")
    with pytest.raises(tdf.IoError, match=r"column 'a'.*ZSTD"):
        ctx.sql_collect("SELECT a FROM bad")


@pytest.mark.parametrize("codec", ["BROTLI", "LZO"])
def test_brotli_and_lzo_raise_io_error_naming_the_codec(tmp_path, codec):
    """BROTLI reads (the decoder of `native/codecs.cpp`) with the JAX
    package's rows, and a BROTLI page that does not decode raises
    IoError naming the codec and the column; LZO, which pyarrow does not
    read either, raises IoError naming the codec and the column."""
    path = str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"a": pa.array(np.arange(100))}), path, compression="brotli")
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    if codec == "BROTLI":
        assert_same_read(path)
        ctx.sql(f"CREATE EXTERNAL TABLE b STORED AS PARQUET LOCATION '{path}'")
        assert ctx.sql_collect("SELECT a FROM b").to_rows() == [(i,) for i in range(100)]
        blob = bytearray(open(path, "rb").read())
        md = pq.ParquetFile(path).metadata.row_group(0).column(0)
        start = min(o for o in (md.dictionary_page_offset, md.data_page_offset) if o)
        end = start + md.total_compressed_size
        blob[end - 4:end] = b"\xff\xff\xff\xff"  # the last page's stream, cut short
        bad = str(tmp_path / "bad.parquet")
        with open(bad, "wb") as f:
            f.write(blob)
        ctx.sql(f"CREATE EXTERNAL TABLE bad STORED AS PARQUET LOCATION '{bad}'")
        with pytest.raises(tdf.IoError, match=r"column 'a'.*BROTLI"):
            ctx.sql_collect("SELECT a FROM bad")
        return
    _patch_codec(path, 4, 3)  # no writer here writes LZO: relabel the BROTLI chunk
    assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression == "LZO"
    ctx.sql(f"CREATE EXTERNAL TABLE b STORED AS PARQUET LOCATION '{path}'")
    with pytest.raises(tdf.IoError, match=rf"column 'a': compression codec {codec} is not"):
        ctx.sql_collect("SELECT a FROM b")


def test_nested_fields_raise_the_jax_packages_error_type(tmp_path):
    path = str(tmp_path / "nested.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2]), "s": pa.array([{"x": 1}, {"x": 2}]),
                             "l": pa.array([[1], [2, 3]])}), path)
    with pytest.raises(jdf.ExecutionError):
        jax_infer(path)
    with pytest.raises(tdf.ExecutionError, match="'s'"):
        infer_parquet_schema(path)
    # the flat field before them still reads
    schema = jdf.Schema([jdf.Field("a", jdf.DataType.INT64)])
    assert_same_read(path, schema)


def test_corrupt_and_truncated_files_raise_io_error(tmp_path):
    src = open(os.path.join(DATA, "uk_cities.parquet"), "rb").read()
    cases = {"empty": b"", "magic_only": b"PAR1", "truncated": src[:-3],
             "no_footer": src[:len(src) // 2] + src[-8:], "not_parquet": b"x" * 64}
    for name, blob in cases.items():
        path = str(tmp_path / f"{name}.parquet")
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(tdf.IoError, match="cannot open Parquet"):
            infer_parquet_schema(path)
    with pytest.raises(tdf.IoError, match="cannot open Parquet"):
        infer_parquet_schema(str(tmp_path / "missing.parquet"))


# ------------------------------------------------------------ chip_smoke's writer

@pytest.fixture(scope="module")
def smoke_lineitem(tmp_path_factory):
    """`chip_smoke.lineitem_sf1` cut to 1,200,000 rows (two row groups,
    the second short), written by `chip_smoke.write_lineitem_parquet`."""
    spec = importlib.util.spec_from_file_location("chip_smoke_parquet",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.SF1_ROWS = 1_200_000
    _, c, dates = cs.lineitem_sf1(tdf, 131072)
    path = str(tmp_path_factory.mktemp("smoke") / "li.parquet")
    cs.write_lineitem_parquet(path, c, dates)
    return cs, path, c, dates


def test_chip_smoke_writer_file_reads_back_as_lineitem_sf1(smoke_lineitem):
    _, path, c, dates = smoke_lineitem
    md = pq.ParquetFile(path).metadata
    assert md.num_row_groups == 2 and md.row_group(0).num_rows == 1_000_000
    for rg in range(2):
        for j in range(md.num_columns):
            col = md.row_group(rg).column(j)
            assert col.compression == "SNAPPY"
            want = "PLAIN" if col.path_in_schema == "l_extendedprice" else "RLE_DICTIONARY"
            assert want in col.encodings
    t = pq.read_table(path)
    assert t.column("l_returnflag").to_pylist() == list(np.array(list("ANR"))[c["flag"]])
    assert t.column("l_linestatus").to_pylist() == list(np.array(list("FO"))[c["status"]])
    assert t.column("l_shipdate").to_pylist() == list(np.array(dates)[c["ship"]])
    for name, key in (("l_quantity", "qty"), ("l_extendedprice", "price"),
                      ("l_discount", "disc"), ("l_tax", "tax")):
        assert t.column(name).to_numpy().tobytes() == c[key].tobytes()
    # the port reads it into lineitem_sf1's dictionaries and columns
    got = read_all(ParquetReader(path))
    assert got[1][0] == list("ANR") and got[1][1] == list("FO") and got[1][6] == dates
    for k, key in ((0, "flag"), (1, "status"), (6, "ship")):
        assert np.array_equal(got[0][k][0], c[key])
    for k, key in ((2, "qty"), (3, "price"), (4, "disc"), (5, "tax")):
        assert got[0][k][0].tobytes() == c[key].tobytes()


def _page_sizes(path):
    """(page type, uncompressed bytes) of every page, walking each column
    chunk's page headers (Thrift compact structs of i32 fields, as the
    writer emits them)."""
    blob = open(path, "rb").read()

    def varint(i):
        out, shift = 0, 0
        while True:
            b = blob[i]
            i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, i

    def struct(i):
        fields, fid = {}, 0
        while blob[i]:
            head = blob[i]
            fid, kind = fid + (head >> 4), head & 0x0F
            i += 1
            if kind == 5:
                v, i = varint(i)
                fields[fid] = (v >> 1) ^ -(v & 1)
            else:
                assert kind == 12
                fields[fid], i = struct(i)
        return fields, i + 1

    md = pq.ParquetFile(path).metadata
    out = []
    for rg in range(md.num_row_groups):
        for j in range(md.num_columns):
            col = md.row_group(rg).column(j)
            i = col.dictionary_page_offset or col.data_page_offset
            end = i + col.total_compressed_size
            while i < end:
                header, i = struct(i)
                out.append((header[1], header[2]))
                i += header[3]
    return out


def test_chip_smoke_writer_pages_hold_at_most_one_mebibyte(smoke_lineitem):
    cs, path, _, _ = smoke_lineitem
    pages = _page_sizes(path)
    data = [size for kind, size in pages if kind == 0]
    assert max(size for _, size in pages) <= cs.PARQUET_PAGE_BYTES
    # l_extendedprice's 1,000,000 doubles fill 8 pages of a row group
    assert sum(1 for kind, _ in pages if kind == 2) == 2 * 6
    assert len(data) > 2 * 7 and max(data) > cs.PARQUET_PAGE_BYTES - 64


# ------------------------------------------------------------ memory safety

FUZZ = r"""
import os, resource, sys, tempfile
from hypothesis import HealthCheck, given, settings, strategies as st
import datafusion_tpu_torch  # noqa: F401  (torch first: its mappings are not the reader's)
from datafusion_tpu_torch.errors import ExecutionError, IoError
from datafusion_tpu_torch.io.readers import ParquetReader, infer_parquet_schema

pages = int(open("/proc/self/statm").read().split()[0])
limit = pages * os.sysconf("SC_PAGE_SIZE") + (2 << 30)  # now + 2 GiB: a wild size fails
resource.setrlimit(resource.RLIMIT_AS, (limit, resource.getrlimit(resource.RLIMIT_AS)[1]))
DATA = sys.argv[1]
blobs = [open(os.path.join(DATA, f + ".parquet"), "rb").read()
         for f in ("uk_cities", "all_types_flat", "alltypes_plain")]
out = os.path.join(tempfile.mkdtemp(), "f.parquet")
seen = {"read": 0, "raised": 0}

@settings(max_examples=int(sys.argv[2]), deadline=None, database=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(st.integers(0, 2), st.lists(st.tuples(st.integers(0, 1 << 30), st.integers(0, 7)),
                                   max_size=6),
       st.lists(st.tuples(st.integers(1, 700), st.integers(0, 7)), max_size=4),
       st.one_of(st.none(), st.integers(0, 1 << 30)))
def probe(which, flips, tail_flips, cut):
    data = bytearray(blobs[which])
    for pos, bit in flips:
        data[pos % len(data)] ^= 1 << bit
    for back, bit in tail_flips:  # the footer and its length
        data[-min(back, len(data))] ^= 1 << bit
    if cut is not None:
        data = data[:cut % (len(data) + 1)]
    with open(out, "wb") as f:
        f.write(data)
    try:
        schema = infer_parquet_schema(out)
        for _ in ParquetReader(out, schema, batch_size=5).batches():
            pass
        seen["read"] += 1
    except (IoError, ExecutionError):
        seen["raised"] += 1

probe()
print(seen["read"], seen["raised"])
"""


def test_truncated_and_bit_flipped_fixtures_never_crash_the_reader(tmp_path):
    t0 = time.perf_counter()
    # run from a scratch directory: hypothesis keeps its caches in the cwd
    out = subprocess.run([sys.executable, "-c", FUZZ, DATA, "400"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, (out.returncode, out.stderr[-3000:])
    read, raised = map(int, out.stdout.split())
    assert read + raised >= 400 and raised > 0
    assert time.perf_counter() - t0 < 240


# ------------------------------------------------------------ the io.read fault site

def _scan_both(path_ddl):
    out = []
    for pkg, faults in ((jdf, jax_faults), (tdf, port_faults)):
        ctx = pkg.ExecutionContext(device="cpu", result_cache=False, batch_size=4)
        ctx.sql(path_ddl)
        out.append((pkg, faults, ctx))
    return out


FAULT_TABLES = {
    "parquet": f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION '{DATA}/uk_cities.parquet'",
    "ndjson": ("CREATE EXTERNAL TABLE t (a BIGINT, b VARCHAR, c DOUBLE) STORED AS NDJSON "
               f"LOCATION '{DATA}/example1.ndjson'"),
}


@pytest.mark.parametrize("fmt", sorted(FAULT_TABLES))
def test_io_read_faults_reach_the_scan_in_both_packages(fmt):
    raised, delays = [], []
    for pkg, faults, ctx in _scan_both(FAULT_TABLES[fmt]):
        batches = len(list(ctx.datasources["t"].batches()))
        plan = {"seed": 3, "rules": [{"site": "io.read", "op": "raise", "exc": "IoError",
                                      "message": "injected read fault",
                                      "after": min(2, batches),
                                      "where": {"format": fmt}}]}
        with faults.scoped(plan) as p:
            with pytest.raises(pkg.IoError, match="injected read fault"):
                ctx.sql_collect("SELECT * FROM t")
            raised.append(p.snapshot())
        plan = {"seed": 3, "rules": [{"site": "io.read", "op": "delay", "seconds": 0.02,
                                      "count": 0}]}
        with faults.scoped(plan) as p:
            t0 = time.perf_counter()
            rows = ctx.sql_collect("SELECT * FROM t").to_rows()
            delays.append((time.perf_counter() - t0, p.snapshot()[0]["fired"], batches,
                           len(rows)))
    assert raised[0] == raised[1] and raised[0][0]["fired"] == 1
    for took, fired, batches, _ in delays:
        assert fired == batches and took >= 0.02 * batches
    assert delays[0][1:] == delays[1][1:]
