"""The port's CSV reader against the JAX package's default one.

The JAX package reads CSV by default through pyarrow
(`datafusion_tpu/io/readers.py` CsvReader); the port reads it with its
own parser (`datafusion_tpu_torch/native/csv.cpp`, bound by
`native/csv.py`, under `io/readers.CsvReader`).  Every case writes one
small file and reads it with both: per batch the row count, each
column's values (floats bit for bit, NaN as NaN), its validity and the
size of each dictionary after the batch, then the final dictionaries;
or both raise (the port IoError, the JAX package IoError, or pyarrow's
KeyError for a header that lacks a schema column).

The corpus: every null spelling of pyarrow's default list, bare and
quoted, in every column type; blanks around values; integers by width
(signs, hex, ranges); the float grammar and Float32 rounded from the
text; boolean spellings; UTF-8 checks; LF, CRLF and bare-CR endings,
blank lines, quoting; headers matched by name.  Then files of many
blocks read at 1 and 4 threads (quoted fields and CRLFs across block
edges), SQL over NULL and NaN spellings, and the `io.read` fault site
and the `scan.rows` counter of a CSV scan.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.io.readers import CsvReader as JaxCsvReader
from datafusion_tpu.testing import faults as jax_faults

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import native
from datafusion_tpu_torch.io.readers import CsvReader
from datafusion_tpu_torch.testing import faults as port_faults
from datafusion_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import assert_same, jax_collect

TYPES = ["Boolean", "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32",
         "UInt64", "Float32", "Float64", "Utf8"]
VALID = {"Boolean": b"true", "Float32": b"1.5", "Float64": b"1.5", "Utf8": b"x"}
NULL_SPELLINGS = ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                  "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"]


def schemas(fields):
    """The JAX package's schema and the port's for [(name, type name)]."""
    js = jdf.Schema([jdf.Field(n, jdf.DataType.from_json(t), True) for n, t in fields])
    return js, tdf.Schema.from_json(js.to_json())


def read_all(reader):
    """Per batch: (rows, columns, validity, dictionary sizes after it);
    then the final dictionaries."""
    batches, dicts = [], []
    for b in reader.batches():
        n = b.num_rows
        batches.append((n, [np.asarray(c)[:n].copy() for c in b.data],
                        [None if v is None else np.asarray(v)[:n].copy() for v in b.validity],
                        [None if d is None else len(d.values) for d in b.dicts]))
        dicts = [None if d is None else list(d.values) for d in b.dicts]
    return batches, dicts


def outcome(make):
    try:
        return read_all(make()), None
    except Exception as e:  # noqa: BLE001 - the test compares what each raises
        return None, e


def assert_same_column(g, w):
    assert g.dtype == w.dtype
    if g.dtype.kind == "f":
        nan = np.isnan(w)
        assert np.array_equal(np.isnan(g), nan)
        bits = np.dtype(f"u{g.dtype.itemsize}")
        np.testing.assert_array_equal(g[~nan].view(bits), w[~nan].view(bits))
    else:
        np.testing.assert_array_equal(g, w)


def assert_same_read(got, want):
    (gb, gd), (wb, wd) = got, want
    assert [b[0] for b in gb] == [b[0] for b in wb]  # batch boundaries
    for (_, gc, gv, gs), (_, wc, wv, ws) in zip(gb, wb):
        assert gs == ws  # dictionary sizes batch by batch
        for g, w in zip(gc, wc):
            assert_same_column(g, w)
        for g, w in zip(gv, wv):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    assert gd == wd


def both(tmp_path, data: bytes, fields, header, batch_size=4, projection=None, **port_kw):
    """Read `data` with both packages; returns the port's read.  Both
    agree, or both raise."""
    path = str(tmp_path / "t.csv")
    with open(path, "wb") as f:
        f.write(data)
    js, ts = schemas(fields)
    want, want_exc = outcome(lambda: JaxCsvReader(path, js, header, batch_size, projection))
    got, got_exc = outcome(lambda: CsvReader(path, ts, header, batch_size, projection,
                                             **port_kw))
    if want_exc is not None:
        assert isinstance(want_exc, (jdf.IoError, KeyError)), repr(want_exc)
        assert isinstance(got_exc, tdf.IoError), (want_exc, got_exc, got)
        return None
    assert got_exc is None, (got_exc, want)
    assert_same_read(got, want)
    return got


def value_file(type_name, field: bytes) -> bytes:
    ok = VALID.get(type_name, b"7")
    return b"id,v\n1," + ok + b"\n2," + field + b"\n3," + ok + b"\n"


# ---------------------------------------------------------------- the corpus

@pytest.mark.parametrize("quoted", [False, True], ids=["bare", "quoted"])
@pytest.mark.parametrize("spelling", NULL_SPELLINGS)
@pytest.mark.parametrize("type_name", TYPES)
def test_null_spellings_are_null_in_every_type(tmp_path, type_name, spelling, quoted):
    field = spelling.encode()
    if quoted:
        field = b'"' + field + b'"'
    got = both(tmp_path, value_file(type_name, field), [("id", "Int64"), ("v", type_name)],
               True)
    (n, cols, valid, _), = got[0][:1]
    assert n == 3 and valid[1].tolist() == [True, False, True]
    if type_name == "Utf8":
        assert cols[1][1] == 0 and got[1][1] == ["x"]  # nothing added


VALUE_CASES = {
    "Float64": [b" 1.5 ", b"\t1.5\t", b"1.5\v", b"\v1.5", b"1.5\xa0", b'" 1.5 "', b"+1.5",
                b"0x10", b"1e5", b"1E5", b".5", b"5.", b"-.5", b"+.5", b"1.e5", b".e5",
                b"inf", b"-inf", b"Inf", b"INF", b"infinity", b"Infinity", b"-Infinity",
                b"+inf", b"infin", b"nan(1)", b"nan(a_b)", b"nan(a-b)", b"nan(", b"nan()",
                b"NAN", b"Nan", b"-NAN", b"+nan", b"snan", b"1e", b"e5", b"-", b"+", b".",
                b"++1", b"+-1", b"1e+", b"1.5e+3", b"1.5e-3", b"1e0005", b"1d5", b"1_0",
                b"0.1f", b" ", b"1 .5", b"1.5.5", b"00012", b"-0", b"1e400", b"-1e400",
                b"1e-400", b"4.9e-324", b"2.5e-324", b"12345678901234567890123",
                b"0.000000000000000000000000000001", b"1.7976931348623157e308",
                b"1.7976931348623159e308", b"0.30000000000000004", b"9007199254740993",
                b"123456789012345678.5e-3", b" NA", b"NA ", b'" NA"'],
    "Float32": [b"1.00000005960464477539062500001", b"3.4028235677973366e38",
                b"3.4028234663852886e38", b"3.4028236e38", b"3.5e38", b"1e39", b"-1e39",
                b"1e-46", b"1.4e-45", b"7.0064923216240854e-46", b"7.0064923216240862e-46",
                b"1.17549435e-38", b"0.1", b"16777217", b"16777217.0", b"0.333333333333333333",
                b"0x1p3", b" 2.5 ", b"NAN", b"infinity", b"1e10", b"1e-10", b"33554431e3"],
    "Int64": [b" 4 ", b"4 ", b"\t4", b"+3", b"-3", b"007", b"-0", b"1.0", b"1e3", b"0x10",
              b"0X10", b"0xff", b"-0x10", b"0x", b"0xG", b"0x-1", b"0x 1", b" 0x10",
              b"0x8000000000000000", b"0xFFFFFFFFFFFFFFFF", b"0x1FFFFFFFFFFFFFFFF",
              b"0x00000000000000001", b"00000000000000000000000000001",
              b"-00000000000000000000000000001", b"9223372036854775807",
              b"9223372036854775808", b"-9223372036854775808", b"-9223372036854775809",
              b"1 2", b"--1", b"-", b" ", b"\v4"],
    "Int8": [b"127", b"128", b"-128", b"-129", b"+1", b"0xff", b"0x80", b"0x100", b"0x0ff",
             b"-0x1"],
    "Int16": [b"32767", b"32768", b"-32768", b"-32769", b"0xffff", b"0x8000", b"0x10000"],
    "Int32": [b"2147483647", b"2147483648", b"-2147483648", b"-2147483649", b"0xffffffff",
              b"0x100000000"],
    "UInt8": [b"255", b"256", b"-0", b"-1", b"+1", b" 5 ", b"0xff", b"0x100", b"0x0ff",
              b"000255"],
    "UInt16": [b"65535", b"65536", b"0xffff", b"0x10000"],
    "UInt32": [b"4294967295", b"4294967296", b"0xffffffff"],
    "UInt64": [b"18446744073709551615", b"18446744073709551616", b"-0",
               b"0xFFFFFFFFFFFFFFFF", b"99999999999999999999"],
    "Boolean": [b"true", b"True", b"TRUE", b"false", b"False", b"FALSE", b"1", b"0",
                b" true ", b"true ", b"\ttrue", b"t", b"f", b"yes", b"tRue", b"01",
                b'" true"', b'"false"', b" NA"],
    "Utf8": [b" ", b'" "', b"\t", b"a ", b" a", b'" a "', b"\xff\xfe", b"\xc0\x80",
             b"\xed\xa0\x80", b"\xf4\x90\x80\x80", b"\xe2\x82\xac", b"\xe2\x82",
             "ü中\U0001f600".encode(), b'"a""b"', b'"ab"cd', b'ab"cd',
             b'"a"b"c"', b'"a,b"', b'"a\nb"', b'"a\r\nb"', b'"a\rb"', b'"N"A', b"None",
             b"NAN", b'""""', b"a\x00b"],
}


@pytest.mark.parametrize("type_name,field", [
    (t, f) for t, fields in VALUE_CASES.items() for f in fields],
    ids=[f"{t}-{f!r}" for t, fields in VALUE_CASES.items() for f in fields])
def test_values_convert_as_the_jax_reader_converts(tmp_path, type_name, field):
    both(tmp_path, value_file(type_name, field), [("id", "Int64"), ("v", type_name)], True)


# the Motivation's divergences of the parent tree, each with its answer
def test_nan_spellings_are_null_not_nan(tmp_path):
    got = both(tmp_path, b"v\n1.5\nNaN\nnan\n-NaN\n2.5\n", [("v", "Float64")], True,
               batch_size=8)
    (n, (col,), (valid,), _), = got[0]
    assert n == 5 and valid.tolist() == [True, False, False, False, True]
    assert col.tolist() == [1.5, 0.0, 0.0, 0.0, 2.5]


def test_float32_rounds_from_the_text(tmp_path):
    got = both(tmp_path, b"v\n1.00000005960464477539062500001\n3.4028235677973366e38\n",
               [("v", "Float32")], True)
    col = got[0][0][1][0]
    assert col[0] == np.float32(1.0000001) and np.isfinite(col[1])
    assert col[1] == np.finfo(np.float32).max


@pytest.mark.parametrize("type_name,field", [
    ("Int64", b"+3"), ("Float64", b"0x10"), ("Utf8", b"\xff\xfe"), ("Int8", b"128"),
    ("Int64", b"NULL"), ("Float64", b"#N/A"), ("Boolean", b"NA"), ("Float64", b" 1.5 "),
    ("Int64", b"4 "),
])
def test_motivation_values(tmp_path, type_name, field):
    got = both(tmp_path, value_file(type_name, field), [("id", "Int64"), ("v", type_name)],
               True)
    if field in (b"+3", b"0x10", b"\xff\xfe", b"128"):
        assert got is None  # both raise
    else:
        assert got is not None


S2 = [("a", "Utf8"), ("b", "Utf8")]
RECORD_CASES = {
    "bare_cr": b"a,b\rc,d\r",
    "bare_cr_no_final": b"a,b\rc,d",
    "crlf": b"a,b\r\nc,d\r\n",
    "lf": b"a,b\nc,d\n",
    "lf_then_cr": b"a,b\n\rc,d\n",
    "cr_crlf": b"a,b\r\r\nc,d",
    "mixed_endings": b"a,b\nc,d\r\ne,f\rg,h",
    "blank_lines": b"a,b\n\nc,d\n\n\n",
    "leading_blank_lines": b"\n\na,b\nc,d",
    "blank_crlf_lines": b"a,b\r\n\r\n\r\nc,d\r\n",
    "whitespace_line": b"a,b\n  \nc,d\n",
    "empty_fields": b"a,b\n,\nc,d\n",
    "quoted_lf": b'"a\nx",b\nc,d\n',
    "quoted_crlf": b'"a\r\nx",b\nc,d\n',
    "quoted_cr": b'"a\rx",b\rc,d\r',
    "doubled_quote": b'"a""q",b\n',
    "after_closing_quote": b'"ab"cd,e\n',
    "quote_inside_field": b'ab"cd,e\n',
    "quote_after_blank": b' "a",b\n',
    "blank_after_quote": b'"a" ,b\n',
    "quote_after_quote": b'"a"b"c",d\n',
    "quoted_empty": b'"",""\n',
    "quoted_delimiter": b'x,"a,b"\n',
    "only_quote_pair_line": b'a,b\n""\n',
    "bom": b"\xef\xbb\xbfa,b\nc,d\n",
    "short_row": b"a,b\nc\n",
    "long_row": b"a,b\nc,d,e\n",
    "trailing_comma": b"a,b,\n",
    "nul_byte": b"a,b\x00c\n",
    "nul_line": b"a,b\n\x00\n",
    "no_rows": b"\n",
    "empty_file": b"",
    "bom_only": b"\xef\xbb\xbf",
    "invalid_utf8_first": b"\xff,b\n",
}


@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_records_split_as_the_jax_reader_splits(tmp_path, name):
    both(tmp_path, RECORD_CASES[name], S2, False)


def test_bare_cr_endings_give_rows(tmp_path):
    got = both(tmp_path, b"a,b\r1,2\r3,4\r", [("a", "Int64"), ("b", "Int64")], True)
    assert [b[0] for b in got[0]] == [2]


IV = [("v", "Int64"), ("s", "Utf8")]
HEADER_CASES = {
    "by_name": (b"s,v\nx,2\ny,3\n", IV, None),
    "by_name_projected": (b"s,v\nx,2\ny,3\n", IV, [1]),
    "projection_reversed": (b"v,s\n2,x\n", IV, [1, 0]),
    "extra_header_column": (b"s,w,v\nx,9,2\n", IV, None),
    "ragged_against_header": (b"s,w,v\nx,2\n", IV, None),
    "missing_column": (b"s,w\nx,2\n", IV, None),
    "missing_unprojected_column": (b"s\nx\n", IV, [1]),
    "blank_lines_first": (b"\n\ns,v\nx,2\n", IV, None),
    "bom_then_blank_line": (b"\xef\xbb\xbf\ns,v\nx,2\n", IV, None),
    "crlf_header": (b"s,v\r\nx,2\r\n", IV, None),
    "cr_header": (b"s,v\rx,2\r", IV, None),
    "quoted_names": (b'"s","v"\nx,2\n', IV, None),
    "name_with_a_comma": (b'"a,b",v\nx,2\n', [("v", "Int64"), ("a,b", "Utf8")], None),
    "name_not_trimmed": (b's," v"\nx,2\n', IV, None),
    "duplicate_name": (b"s,v,s\nx,2,y\n", IV, None),
    "header_only": (b"s,v\n", IV, None),
    "header_only_crlf": (b"s,v\r\n", IV, None),
    "blank_file": (b"\n\n", IV, None),
    "empty_file": (b"", IV, None),
    "invalid_utf8_unprojected": (b"s,v\n\xff,2\n", IV, [0]),
}


@pytest.mark.parametrize("name", sorted(HEADER_CASES))
def test_header_matches_columns_by_name(tmp_path, name):
    data, fields, projection = HEADER_CASES[name]
    both(tmp_path, data, fields, True, projection=projection)


@pytest.mark.parametrize("projection", [None, [1], [1, 0]])
def test_swapped_header_columns_of_one_type(tmp_path, projection):
    """A header `b,a` over the schema (a, b) of one type: by name, never
    by position (the parent tree swapped them silently)."""
    got = both(tmp_path, b"b,a\n1,2\n3,4\n", [("a", "Int64"), ("b", "Int64")], True,
               projection=projection)
    cols = dict(zip(["a", "b"] if projection is None else
                    [["a", "b"][i] for i in projection], got[0][0][1]))
    assert list(cols.get("a", [2, 4])) == [2, 4]
    assert list(cols.get("b", [1, 3])) == [1, 3]


# ---------------------------------------------------------------- many blocks

def many_block_text(rows: int, seed: int, quoted_newlines: bool) -> bytes:
    """A CSV with an id, a name (Utf8: new names keep appearing, some
    quoted with delimiters, doubled quotes and, if asked, newlines), a
    value (Float64 with NULL and NaN spellings) and a flag; the row
    endings mix LF and CRLF, with blank lines between."""
    rng = np.random.default_rng(seed)
    out = [b"id,name,value,flag\r\n"]
    specials = [b'"with, comma"', b'"say ""hi"""', b'"tail"x']
    if quoted_newlines:
        specials += [b'"two\nlines"', b'"crlf\r\ninside"']
    for i in range(rows):
        r = rng.random()
        if r < 0.1:
            name = specials[int(rng.integers(len(specials)))]
        elif r < 0.15:
            name = b"NA"
        else:
            name = b"name_%d" % int(rng.integers(0, 1 + i // 4))
        v = rng.random()
        value = (b"NaN" if v < 0.03 else b"NULL" if v < 0.06 else b"#N/A" if v < 0.07
                 else b"%r" % float(np.round(rng.normal() * 100, 3)))
        flag = (b"true", b"false", b"", b"1", b"0")[int(rng.integers(5))]
        end = b"\r\n" if rng.random() < 0.5 else b"\n"
        out.append(b"%d,%s,%s,%s%s" % (i, name, value, flag, end))
        if rng.random() < 0.01:
            out.append(b"\n")
    return b"".join(out)


MANY_FIELDS = [("id", "Int64"), ("name", "Utf8"), ("value", "Float64"), ("flag", "Boolean")]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("projection", [None, [3, 1]])
def test_many_blocks_match_the_jax_reader(tmp_path, threads, projection):
    """About 600 KB in blocks of 4 KiB (one pyarrow block: pyarrow's
    reader cannot split quoted newlines): boundaries, values, validity,
    codes and dictionary order equal the JAX package's."""
    data = many_block_text(20_000, 11, quoted_newlines=True)
    assert 400_000 < len(data) < 1 << 20
    got = both(tmp_path, data, MANY_FIELDS, True, batch_size=1000, projection=projection,
               threads=threads, block_size=4096)
    assert [b[0] for b in got[0]] == [1000] * 20


@pytest.mark.parametrize("threads", [1, 4])
def test_many_pyarrow_blocks_match_the_jax_reader(tmp_path, threads):
    """About 2.3 MB: several blocks of the default 1 MiB in both
    readers; a batch size that divides no block."""
    data = many_block_text(80_000, 5, quoted_newlines=False)
    assert len(data) > 2 << 20
    got = both(tmp_path, data, MANY_FIELDS, True, batch_size=3000, threads=threads)
    assert sum(b[0] for b in got[0]) == 80_000


ROW = 16  # bytes of each row of crlf_edge_text


def crlf_edge_text(rows: int) -> bytes:
    header = b"id,s\r\n"
    body = b"".join(b"%06d,%s\r\n" % (i, b"abcdefg"[: ROW - 9]) for i in range(rows))
    assert len(body) == rows * ROW
    return header + body


@pytest.mark.parametrize("threads", [1, 4])
def test_crlf_split_at_block_edges(tmp_path, threads):
    """The first block ends between a row's CR and its LF: the reader
    fills a block to `block_size` bytes past the header, so a block
    size of 256 rows plus all of a row but its LF cuts there."""
    data = crlf_edge_text(5000)
    got = both(tmp_path, data, [("id", "Int64"), ("s", "Utf8")], True, batch_size=777,
               threads=threads, block_size=256 * ROW + ROW - 1)
    assert sum(b[0] for b in got[0]) == 5000
    assert np.array_equal(np.concatenate([b[1][0] for b in got[0]]), np.arange(5000))


@pytest.mark.parametrize("threads", [1, 3])
def test_quoted_field_longer_than_a_block(tmp_path, threads):
    long = b"x" * 10_000 + b"\n" + b"y" * 3000
    data = b"a,b\n1,\"" + long + b"\"\n2,short\n" + b"".join(
        b"%d,z%d\n" % (i, i % 7) for i in range(3, 2000))
    got = both(tmp_path, data, [("a", "Int64"), ("b", "Utf8")], True, batch_size=500,
               threads=threads, block_size=1024)
    assert got[1][1][0] == long.decode()


def test_reader_threads_default_to_the_cpu_count(tmp_path):
    path = tmp_path / "t.csv"
    path.write_bytes(b"a\n1\n")
    _, ts = schemas([("a", "Int64")])
    assert CsvReader(str(path), ts, True).threads == os.cpu_count()
    assert CsvReader(str(path), ts, True, threads=2).threads == 2
    assert CsvReader(str(path), ts, True, 1000).block_size == max(1 << 20, 64_000)


def test_the_port_builds_its_own_csv_parser():
    names = [p.name for p in native.SOURCES]
    assert "csv.cpp" in names and "datafusion_native.cpp" not in names
    assert native.SOURCE.parent.name == "native" and native.SOURCE.name == "csv.cpp"
    assert native.SOURCE.parent.parent.name == "datafusion_tpu_torch"


# ---------------------------------------------------------------- SQL and the scan

NAN_TEXT = b"k,v\na,1.5\na,NaN\nb,NULL\nb,2.5\na,nan\nb,-NaN\na,#N/A\nb,4\na,\nb,n/a\n"


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(v), SUM(v), AVG(v) FROM t",
    "SELECT k, COUNT(v), SUM(v), AVG(v), COUNT(1) FROM t GROUP BY k",
    "SELECT k FROM t WHERE v IS NULL",
    "SELECT k, v FROM t WHERE v IS NOT NULL",
])
def test_sql_over_null_and_nan_spellings(tmp_path, sql):
    path = str(tmp_path / "t.csv")
    with open(path, "wb") as f:
        f.write(NAN_TEXT)
    js, ts = schemas([("k", "Utf8"), ("v", "Float64")])
    jctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4)
    jctx.register_csv("t", path, js, has_header=True)
    tctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4)
    tctx.register_csv("t", path, ts, has_header=True)
    rows = assert_same(tdf.collect(tctx.sql(sql)), jax_collect(jctx.sql(sql)),
                       ordered="GROUP BY" not in sql)
    if sql.startswith("SELECT COUNT"):
        assert rows == [(3, 8.0, 8.0 / 3)]


def _csv_contexts(path, schema_pair):
    out = []
    for pkg, faults, schema in ((jdf, jax_faults, schema_pair[0]),
                                (tdf, port_faults, schema_pair[1])):
        ctx = pkg.ExecutionContext(device="cpu", result_cache=False, batch_size=4)
        ctx.register_csv("t", path, schema, has_header=False)
        out.append((pkg, faults, ctx))
    return out


def test_io_read_fault_reaches_a_csv_scan_in_both_packages():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "test", "data", "uk_cities.csv")
    pair = schemas([("city", "Utf8"), ("lat", "Float64"), ("lng", "Float64")])
    raised = []
    for pkg, faults, ctx in _csv_contexts(path, pair):
        batches = len(list(ctx.datasources["t"].batches()))
        assert batches == 10  # 37 rows in batches of 4
        plan = {"seed": 3, "rules": [{"site": "io.read", "op": "raise", "exc": "IoError",
                                      "message": "injected read fault", "after": 2,
                                      "where": {"format": "csv"}}]}
        with faults.scoped(plan) as p:
            with pytest.raises(pkg.IoError, match="injected read fault"):
                ctx.sql_collect("SELECT * FROM t")
            raised.append(p.snapshot())
        plan = {"seed": 3, "rules": [{"site": "io.read", "op": "delay", "seconds": 0.0,
                                      "count": 0}]}
        with faults.scoped(plan) as p:
            assert len(ctx.sql_collect("SELECT * FROM t").to_rows()) == 37
            assert p.snapshot()[0]["fired"] == batches
    assert raised[0] == raised[1] and raised[0][0]["fired"] == 1


def test_a_csv_scan_counts_scan_rows():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "test", "data", "uk_cities.csv")
    _, ts = schemas([("city", "Utf8"), ("lat", "Float64"), ("lng", "Float64")])
    before = METRICS.snapshot()["counts"].get("scan.rows", 0)
    src = tdf.CsvDataSource(path, ts, False, 10)
    assert sum(b.num_rows for b in src.batches()) == 37
    assert METRICS.snapshot()["counts"]["scan.rows"] - before == 37
