"""PyTorch/CUDA port: Parquet's DELTA_BINARY_PACKED and BYTE_STREAM_SPLIT
value encodings in the port's reader (`native/parquet.cpp`), against the
JAX package's pyarrow reader, on the CPU.

pyarrow writes every type the engine maps from INT32 and INT64 (signed
and unsigned ints of every width, DATE, TIMESTAMP in ms, us and ns with
and without a zone) in DELTA_BINARY_PACKED, and FLOAT, DOUBLE, INT32 and
INT64 in BYTE_STREAM_SPLIT, crossed with data page v1 and v2, with and
without NULLs, one page or many a chunk: both packages read the same
rows bit for bit.

A page writer here builds what pyarrow does not write: block sizes and
miniblock counts other than 128 / 4, garbage in the bit widths of the
last block's unused miniblocks, values that stop partway through a
miniblock, 32- and 64-bit wraparound (INT32_MIN next to INT32_MAX, the
same for INT64), NULLs, v1 and v2 pages, and a chunk that switches from
RLE_DICTIONARY pages to DELTA_BINARY_PACKED pages (parquet-mr v2's
dictionary fallback).  Each file reads to the values it was built from,
and as the JAX package reads it.  Malformed streams raise IoError naming
the column and the encoding; among them a last miniblock cut short of
its padding, which pyarrow refuses too.

DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY stay refused on Utf8
columns: the JAX package raises on them (it reads Utf8 columns with
`read_dictionary`), so the port raises IoError too.

`chip_smoke.py`'s writer in its "v2" layout (DATA_PAGE_V2 pages, a DATE
in DELTA_BINARY_PACKED, doubles in BYTE_STREAM_SPLIT) reads as pyarrow
and the JAX package read it.

Last, a mutation fuzz of these decoders and the BROTLI decoder under
AddressSanitizer and UndefinedBehaviorSanitizer: the reader's sources
built with `-fsanitize=address,undefined` and driven through their C
entry points (no torch in that process) over bit-flipped and cut pages.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.io.readers import ParquetReader
from test_torch_parquet import REPO, _type_columns, assert_same_read, read_all
from test_torch_parquet_codecs import _chip_smoke

DELTA, BSS = "DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT"
ROWS, GROUP = 3000, 1800
CS = _chip_smoke()


# ------------------------------------------------------------ pyarrow's files

def _encoded_columns(rng, nulls):
    """(columns, their encodings): the DELTA_BINARY_PACKED types and the
    BYTE_STREAM_SPLIT types."""
    cols = _type_columns(rng, ROWS, nulls)
    ms = rng.integers(-10**12, 4 * 10**12, ROWS)
    extra = {
        "timestamp_ns_utc": pa.array(ms * 10**6 + rng.integers(0, 10**6, ROWS),
                                     pa.timestamp("ns", tz="UTC")),
        "timestamp_ms_berlin": pa.array(ms, pa.timestamp("ms", tz="Europe/Berlin")),
        "bss_int32": pa.array(rng.integers(-2**31, 2**31, ROWS).astype(np.int32)),
        "bss_int64": pa.array(rng.integers(-2**63, 2**63 - 1, ROWS, dtype=np.int64)),
    }
    if nulls:
        extra = {k: pa.array(a.to_pylist(), a.type, mask=rng.random(ROWS) < 0.2)
                 for k, a in extra.items()}
    cols.update(extra)
    delta = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
             "date32", "date64", "timestamp_ms", "timestamp_us", "timestamp_ns",
             "timestamp_ms_utc", "timestamp_us_utc", "timestamp_ns_utc", "timestamp_ms_berlin"]
    bss = ["float", "double", "few_doubles", "bss_int32", "bss_int64"]
    return cols, {DELTA: delta, BSS: bss}


CASES = [(enc, version, nulls, pages) for enc in (DELTA, BSS) for version in ("1.0", "2.0")
         for nulls in (False, True) for pages in ("one", "many")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0].split('_')[0].lower()}-v"
                         f"{c[1][0]}-{'nulls' if c[2] else 'dense'}-{c[3]}")
def test_pyarrow_encoded_types_equal_the_jax_reader(tmp_path, case):
    encoding, version, nulls, pages = case
    cols, names = _encoded_columns(np.random.default_rng(CASES.index(case)), nulls)
    table = pa.table({k: cols[k] for k in names[encoding]})
    path = str(tmp_path / "e.parquet")
    pq.write_table(table, path, use_dictionary=False, data_page_version=version,
                   column_encoding={k: encoding for k in names[encoding]},
                   row_group_size=GROUP, data_page_size=1 << 20 if pages == "one" else 256)
    md = pq.ParquetFile(path).metadata
    for j in range(md.num_columns):
        assert encoding in md.row_group(0).column(j).encodings
    sizes = assert_same_read(path, None, 700)
    assert sum(sizes) == ROWS


@pytest.mark.parametrize("encoding", ["DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY"])
def test_delta_string_encodings_are_refused_by_both_packages(tmp_path, encoding):
    from test_torch_parquet import JaxParquetReader, jax_infer

    path = str(tmp_path / "s.parquet")
    pq.write_table(pa.table({"s": pa.array([f"v{i % 13}" for i in range(500)])}), path,
                   use_dictionary=False, column_encoding={"s": encoding})
    with pytest.raises(OSError, match="Not yet implemented"):
        read_all(JaxParquetReader(path, jax_infer(path), 100))
    with pytest.raises(tdf.IoError, match=rf"column 's'.*{encoding} is not supported"):
        read_all(ParquetReader(path))


# ------------------------------------------------------------ a page writer

def _zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def _pack(values, width):
    """Values of `width` bits, least significant bit first."""
    acc = 0
    for i, v in enumerate(values):
        acc |= v << (i * width)
    return acc.to_bytes((len(values) * width + 7) // 8, "little")


def delta_stream(values, bits, block=128, minis=4, garbage=0, pad_last=True, widths=None):
    """`values` as DELTA_BINARY_PACKED for a physical type of `bits` bits,
    value by value (no numpy): deltas wrap in `bits` bits; the last
    block's unused miniblocks get the bit width `garbage` and no bytes;
    `pad_last=False` cuts the last miniblock after its last value;
    `widths` overrides every used miniblock's bit width."""
    mod = 1 << bits

    def signed(x):
        x %= mod
        return x - mod if x >= mod >> 1 else x

    out = bytearray(CS._uvarint(block) + CS._uvarint(minis) + CS._uvarint(len(values)))
    out += CS._uvarint(_zigzag(signed(values[0]) if values else 0))
    deltas = [signed(values[i] - values[i - 1]) for i in range(1, len(values))]
    per = block // minis
    for lo in range(0, len(deltas), block):
        chunk = deltas[lo:lo + block]
        least = min(chunk)
        out += CS._uvarint(_zigzag(least))
        rel = [(d - least) % mod for d in chunk]
        head, bodies = [], []
        for m in range(minis):
            part = rel[m * per:(m + 1) * per]
            if not part:
                head.append(garbage)
                continue
            w = widths if widths is not None else max(x.bit_length() for x in part)
            head.append(w)
            last = lo + block >= len(deltas) and (m + 1) * per >= len(rel)
            bodies.append(_pack(part if last and not pad_last else
                                part + [0] * (per - len(part)), w))
        out += bytes(head) + b"".join(bodies)
    return bytes(out)


def _levels(valid, with_length):
    """Definition levels as one bit-packed run of the hybrid."""
    groups = -(-len(valid) // 8)
    run = CS._uvarint((groups << 1) | 1) + _pack(list(valid) + [0] * (groups * 8 - len(valid)), 1)
    return (len(run).to_bytes(4, "little") if with_length else b"") + run


def _data_page(version, encoding, values_bytes, valid):
    n = len(valid)
    nulls = n - sum(valid)
    if version == 1:
        levels = _levels(valid, True) if valid.optional else b""
        body = levels + values_bytes
        sub = (5, "struct", CS._tc_struct((1, "i32", n), (2, "i32", encoding), (3, "i32", 3),
                                          (4, "i32", 3)))
        ptype = 0
    else:
        levels = _levels(valid, False) if valid.optional else b""
        body = levels + values_bytes
        sub = (8, "struct", CS._tc_struct((1, "i32", n), (2, "i32", nulls), (3, "i32", n),
                                          (4, "i32", encoding), (5, "i32", len(levels)),
                                          (6, "i32", 0)))
        ptype = 3
    return CS._tc_struct((1, "i32", ptype), (2, "i32", len(body)), (3, "i32", len(body)),
                         sub) + body


class Valid(list):
    """A page's validity (1 a value, 0 a NULL), and whether the column
    is OPTIONAL."""

    def __init__(self, bits, optional):
        super().__init__(bits)
        self.optional = optional


def write_pages(path, physical, pages, optional=False, dictionary=None, converted=None):
    """One column "x" of `physical` type (INT32 1, INT64 2, FLOAT 4,
    DOUBLE 5) in one row group of the given data pages: (version,
    encoding, values bytes, validity list).  `dictionary`: PLAIN bytes
    and count of a dictionary page first.  UNCOMPRESSED, no statistics."""
    chunk = bytearray()
    if dictionary is not None:
        raw, count = dictionary
        chunk += CS._tc_struct((1, "i32", 2), (2, "i32", len(raw)), (3, "i32", len(raw)),
                               (7, "struct", CS._tc_struct((1, "i32", count),
                                                           (2, "i32", 0)))) + raw
    data_at = 4 + len(chunk)
    rows = 0
    for version, encoding, body, valid in pages:
        chunk += _data_page(version, encoding, body, Valid(valid, optional))
        rows += len(valid)
    meta = CS._tc_struct(
        (1, "i32", physical), (2, ("list", "i32"), [0, 3, 5, 8, 9]), (3, ("list", "bin"), [b"x"]),
        (4, "i32", 0), (5, "i64", rows), (6, "i64", len(chunk)), (7, "i64", len(chunk)),
        (9, "i64", data_at), (11, "i64", 4 if dictionary is not None else None))
    group = CS._tc_struct((1, ("list", "struct"), [CS._tc_struct((2, "i64", 4),
                                                                (3, "struct", meta))]),
                          (2, "i64", len(chunk)), (3, "i64", rows))
    schema = [CS._tc_struct((4, "bin", b"schema"), (5, "i32", 1)),
              CS._tc_struct((1, "i32", physical), (3, "i32", int(optional)), (4, "bin", b"x"),
                            (6, "i32", converted))]
    footer = CS._tc_struct((1, "i32", 1), (2, ("list", "struct"), schema), (3, "i64", rows),
                           (4, ("list", "struct"), [group]))
    with open(path, "wb") as f:
        f.write(b"PAR1" + chunk + footer + len(footer).to_bytes(4, "little") + b"PAR1")


def _port_values(path):
    (values, valid), = read_all(ParquetReader(path))[0]
    return values, valid


I32_MIN, I32_MAX, I64_MIN, I64_MAX = -2**31, 2**31 - 1, -2**63, 2**63 - 1


def _wrapping(bits, n, rng):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    v = [lo, hi, lo, 0, hi, hi, lo + 1, hi - 1, -1, 1] + rng.integers(lo, hi, n - 10,
                                                                       endpoint=True).tolist()
    return [int(x) for x in v]


SHAPES = {  # block, miniblocks, values
    "pyarrow_128x4": (128, 4, 1000),
    "one_miniblock_128": (128, 1, 300),
    "256x8_partial": (256, 8, 700),
    "1024x4": (1024, 4, 3000),
    "512x16_one_value": (512, 16, 1),
    "128x4_two_values": (128, 4, 2),
}


@pytest.mark.parametrize("bits", [32, 64], ids=["int32", "int64"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
def test_hand_built_delta_pages_read_their_values(tmp_path, bits, shape, version):
    """Odd block sizes, garbage widths in the last block, values that
    stop partway through a miniblock, wraparound at the physical width:
    the port reads the values the pages were built from, as pyarrow
    does."""
    block, minis, n = SHAPES[shape]
    rng = np.random.default_rng(block + minis + n + bits)
    values = _wrapping(bits, max(n, 10), rng)[:n]
    pages = [(version, 5, delta_stream(values[:n // 2 or 1], bits, block, minis, garbage=255),
              [1] * (n // 2 or 1))]
    if n > 1:
        pages.append((version, 5, delta_stream(values[n // 2:], bits, block, minis,
                                               garbage=77), [1] * (n - n // 2)))
    path = str(tmp_path / "d.parquet")
    write_pages(path, 1 if bits == 32 else 2, pages)
    got, _ = _port_values(path)
    assert got.tolist() == values
    assert_same_read(path)


@pytest.mark.parametrize("bits", [32, 64], ids=["int32", "int64"])
def test_full_width_deltas_wrap_in_the_physical_width(tmp_path, bits):
    """Every miniblock at the full bit width (32 for INT32, 64 for INT64):
    deltas between the extremes of the type wrap."""
    lo, hi = (I32_MIN, I32_MAX) if bits == 32 else (I64_MIN, I64_MAX)
    values = [lo, hi] * 100 + [hi, lo, 0]
    path = str(tmp_path / "w.parquet")
    write_pages(path, 1 if bits == 32 else 2,
                [(2, 5, delta_stream(values, bits, widths=bits), [1] * len(values))])
    assert _port_values(path)[0].tolist() == values
    assert_same_read(path)


@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
def test_delta_pages_of_an_optional_column_hold_only_the_values(tmp_path, version):
    rng = np.random.default_rng(5)
    valid = (rng.random(900) < 0.7).astype(int).tolist()
    values = [int(x) for x in rng.integers(-10**6, 10**6, sum(valid))]
    # two pages; each encodes its non-NULL values
    cut = 500
    k = sum(valid[:cut])
    pages = [(version, 5, delta_stream(values[:k], 64), valid[:cut]),
             (version, 5, delta_stream(values[k:], 64, block=256, minis=2), valid[cut:])]
    path = str(tmp_path / "o.parquet")
    write_pages(path, 2, pages, optional=True)
    got, got_valid = _port_values(path)
    assert got_valid.tolist() == [bool(v) for v in valid]
    assert got[got_valid].tolist() == values
    assert (got[~got_valid] == 0).all()
    assert_same_read(path)


def test_dictionary_pages_then_delta_pages_in_one_chunk(tmp_path):
    """parquet-mr v2's fallback: a dictionary page and RLE_DICTIONARY
    pages, then DELTA_BINARY_PACKED pages, in one INT32 DATE chunk."""
    rng = np.random.default_rng(9)
    dict_values = np.arange(18000, 18010, dtype=np.int32)
    idx = rng.integers(0, 10, 600)
    later = [int(x) for x in rng.integers(17000, 19000, 700)]
    pages = [(1, 8, bytes([4]) + CS._uvarint((75 << 1) | 1) + _pack(idx.tolist(), 4),
              [1] * 600),
             (2, 5, delta_stream(later[:300], 32, 256, 8), [1] * 300),
             (1, 5, delta_stream(later[300:], 32), [1] * 400)]
    path = str(tmp_path / "f.parquet")
    write_pages(path, 1, pages, dictionary=(dict_values.tobytes(), 10), converted=6)
    assert pq.ParquetFile(path).schema_arrow.field("x").type == pa.date32()
    md = pq.ParquetFile(path).metadata.row_group(0).column(0)
    assert md.has_dictionary_page
    want = np.concatenate([dict_values[idx], later]).astype("datetime64[D]").astype(str)
    got = read_all(ParquetReader(path))
    codes, strings = got[0][0][0], got[1][0]
    assert [strings[c] for c in codes] == want.tolist()
    assert_same_read(path)


def test_byte_stream_split_pages_read_their_values(tmp_path):
    rng = np.random.default_rng(2)
    for physical, dtype in ((4, "<f4"), (5, "<f8"), (1, "<i4"), (2, "<i8")):
        a = rng.normal(size=333).astype(dtype) if dtype[1] == "f" else \
            rng.integers(-2**30, 2**30, 333).astype(dtype)
        pages = [(v, 9, np.ascontiguousarray(part.view(np.uint8).reshape(len(part), -1).T)
                  .tobytes(), [1] * len(part)) for v, part in ((1, a[:200]), (2, a[200:]))]
        path = str(tmp_path / f"b{physical}.parquet")
        write_pages(path, physical, pages)
        assert _port_values(path)[0].tobytes() == a.tobytes()
        assert_same_read(path)


def _bad(values_bytes, physical=2, encoding=5, version=1, n=10):
    return physical, [(version, encoding, values_bytes, [1] * n)]


TEN = delta_stream(list(range(10)), 64)  # header: 128 in 2 bytes, then 4, 10, 0
SQUARES = [x * x * 1000 for x in range(10)]
BAD_DELTA = {  # name: (stream, message)
    "truncated_header": (TEN[:2], "truncated stream"),
    "block_not_of_128": (CS._uvarint(100) + TEN[2:], "block size 100 is not a multiple of 128"),
    "six_miniblocks": (TEN[:2] + b"\x06" + TEN[3:],
                       "6 miniblocks in a block of 128 do not hold a multiple of 32"),
    "count_mismatch": (delta_stream(list(range(9)), 64), "the header holds 9 values, the page 10"),
    "width_65": (delta_stream(list(range(10)), 64, widths=65), "bit width 65 past 64"),
    "truncated_miniblock": (delta_stream(SQUARES, 64)[:-9], "truncated miniblock"),
    "unpadded_last_miniblock": (delta_stream(SQUARES, 64, pad_last=False),
                                "truncated miniblock"),
    "no_block": (TEN[:5], "truncated stream"),
}


@pytest.mark.parametrize("name", sorted(BAD_DELTA))
def test_malformed_delta_streams_raise_io_error_naming_column_and_encoding(tmp_path, name):
    stream, message = BAD_DELTA[name]
    path = str(tmp_path / "bad.parquet")
    physical, pages = _bad(stream)
    write_pages(path, physical, pages)
    with pytest.raises(tdf.IoError, match=rf"column 'x'.*DELTA_BINARY_PACKED: {message}"):
        read_all(ParquetReader(path))
    with pytest.raises(OSError):  # the JAX package's pyarrow refuses it too
        pq.read_table(path)


def test_int32_delta_width_past_32_and_bss_section_size_raise(tmp_path):
    path = str(tmp_path / "w33.parquet")
    write_pages(path, 1, [(1, 5, delta_stream(list(range(10)), 32, widths=33), [1] * 10)])
    with pytest.raises(tdf.IoError, match=r"column 'x'.*DELTA_BINARY_PACKED: bit width 33 past 32"):
        read_all(ParquetReader(path))
    for cut in (1, -1):
        raw = np.arange(10, dtype="<f8").tobytes()
        path = str(tmp_path / "s.parquet")
        write_pages(path, 5, [(2, 9, raw[:-1] if cut == 1 else raw + b"\0", [1] * 10)])
        with pytest.raises(tdf.IoError, match=r"column 'x'.*BYTE_STREAM_SPLIT: a section of"):
            read_all(ParquetReader(path))


# ------------------------------------------------------------ chip_smoke's writer

def test_chip_smoke_v2_layout_reads_as_pyarrow_and_the_jax_package_read_it(tmp_path):
    """`write_lineitem_parquet(layout="v2")`: its vectorised DELTA and
    BYTE_STREAM_SPLIT encoders (several pages a chunk, a partial last
    block) against pyarrow, and the port against the JAX package."""
    cs = _chip_smoke()
    cs.PARQUET_PAGE_BYTES = 40_000
    rng = np.random.default_rng(11)
    n, dates = 70_001, [str(np.datetime64("1992-01-02") + np.timedelta64(i, "D"))
                        for i in range(2526)]
    cols = {"flag": rng.integers(0, 3, n), "status": rng.integers(0, 2, n),
            "qty": np.floor(rng.uniform(1, 51, n)),
            "price": np.round(rng.uniform(900.0, 104950.0, n), 2),
            "disc": rng.integers(0, 11, n) / 100.0, "tax": rng.integers(0, 9, n) / 100.0,
            "ship": rng.integers(0, len(dates), n)}
    cols["ship"][:3] = [0, len(dates) - 1, 0]  # the widest deltas
    path = str(tmp_path / "v2.parquet")
    cs.write_lineitem_parquet(path, cols, dates, layout="v2")
    f = pq.ParquetFile(path)
    chunk = f.metadata.row_group(0)
    assert chunk.column(3).total_uncompressed_size > 10 * cs.PARQUET_PAGE_BYTES  # many pages
    assert "DELTA_BINARY_PACKED" in chunk.column(6).encodings
    assert "BYTE_STREAM_SPLIT" in chunk.column(3).encodings
    t = f.read()
    assert t.column("l_shipdate").to_pylist() == [
        np.datetime64(dates[k]).astype(object) for k in cols["ship"]]
    for name, key in (("l_quantity", "qty"), ("l_extendedprice", "price"),
                      ("l_discount", "disc"), ("l_tax", "tax")):
        assert t.column(name).to_numpy().tobytes() == cols[key].tobytes()
    assert t.column("l_returnflag").to_pylist() == [("ANR")[k] for k in cols["flag"]]
    assert_same_read(path, None, 131072)


def test_committed_v2_fixture_holds_lineitem_sf1_rows_in_the_v2_encodings():
    """`tests/torch_data/parquet/lineitem_32768_v2_snappy.parquet`
    (`scripts/port_parquet_codec_fixtures.py`, pyarrow): the first rows
    of `chip_smoke.lineitem_sf1` in the v2 layout's encodings, read as
    the JAX package reads them."""
    spec = importlib.util.spec_from_file_location(
        "port_parquet_codec_fixtures", os.path.join(REPO, "scripts",
                                                    "port_parquet_codec_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    path = os.path.join(REPO, "tests", "torch_data", "parquet",
                        f"lineitem_{fx.V2_ROWS}_{fx.V2}.parquet")
    assert os.path.getsize(path) <= 800_000
    assert (fx.V2, fx.V2_ROWS) in CS.PARQUET_CODEC_FIXTURES
    f = pq.ParquetFile(path)
    assert f.metadata.num_row_groups == 2 and f.metadata.row_group(0).num_rows == fx.ROW_GROUP
    chunk = f.metadata.row_group(1)
    assert [DELTA in chunk.column(6).encodings, BSS in chunk.column(3).encodings,
            chunk.column(0).has_dictionary_page, chunk.column(0).compression] == \
        [True, True, True, "SNAPPY"]
    assert f.read().equals(fx.arrow_table_v2(*fx.lineitem_rows(fx.V2_ROWS)))
    assert_same_read(path, None, 131072)


def test_delta_encoder_of_chip_smoke_equals_the_page_writer_here():
    """chip_smoke's vectorised encoder and the value-by-value one here
    give the same bytes (one full page of dates, a partial last block)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 129, 1000, 4097):
        v = rng.integers(8000, 10600, n)
        assert CS._delta_binary_packed(v) == delta_stream([int(x) for x in v], 32)


# ------------------------------------------------------------ memory safety

ASAN_SOURCES = ("parquet.cpp", "codecs.cpp", "brotli_dictionary.cpp")

ASAN_FUZZ = r"""
import ctypes, random, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
for name, res, args in (
        ("dtf_pq_open", vp, [ctypes.c_char_p]), ("dtf_pq_error", ctypes.c_char_p, [vp]),
        ("dtf_pq_num_row_groups", i32, [vp]), ("dtf_pq_num_fields", i32, [vp]),
        ("dtf_pq_select", i32, [vp, i32, ctypes.POINTER(i32)]),
        ("dtf_pq_row_group_rows", i64, [vp, i32]),
        ("dtf_pq_read_row_group", i32, [vp, i32, ctypes.POINTER(vp), ctypes.POINTER(vp)]),
        ("dtf_pq_close", None, [vp]),
        ("dtf_pq_decompress", i32, [i32, ctypes.c_char_p, i64, vp, i64])):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = res, args
files, streams, rounds, out = sys.argv[2].split(","), sys.argv[3].split(","), int(sys.argv[4]), \
    sys.argv[5]
rng = random.Random(1)
seen = {"read": 0, "raised": 0, "decoded": 0, "refused": 0}

def read(blob):
    open(out, "wb").write(blob)
    h = lib.dtf_pq_open(out.encode())
    try:
        if lib.dtf_pq_error(h):
            return False
        k = lib.dtf_pq_num_fields(h)
        if lib.dtf_pq_select(h, k, (i32 * k)(*range(k))) != 0:
            return False
        for rg in range(lib.dtf_pq_num_row_groups(h)):
            rows = lib.dtf_pq_row_group_rows(h, rg)
            bufs = [np.zeros(max(rows, 1) * 8, np.uint8) for _ in range(2 * k)]
            ptrs = (vp * k)(*[b.ctypes.data for b in bufs[:k]])
            valid = (vp * k)(*[b.ctypes.data for b in bufs[k:]])
            if lib.dtf_pq_read_row_group(h, rg, ptrs, valid) != 0:
                return False
        return True
    finally:
        lib.dtf_pq_close(h)

def mutate(blob, lo, hi):
    b = bytearray(blob)
    for _ in range(rng.randint(1, 6)):
        b[rng.randrange(lo, hi)] ^= 1 << rng.randrange(8)
    if rng.random() < 0.3:
        cut = rng.randrange(lo, hi)
        b = b[:cut] + b[hi:] if rng.random() < 0.5 else b[:cut] + bytes(hi - cut) + b[hi:]
    return bytes(b)

for path in files:
    blob = open(path, "rb").read()
    body = len(blob) - 8 - int.from_bytes(blob[-8:-4], "little")  # the pages
    assert read(blob), path
    for _ in range(rounds):
        seen["read" if read(mutate(blob, 4, body)) else "raised"] += 1
for path in streams:
    raw_len, comp = open(path, "rb").read().split(b":", 1)
    size = int(raw_len)
    buf = ctypes.create_string_buffer(size + 1)
    assert lib.dtf_pq_decompress(4, comp, len(comp), buf, size) == 0, path
    for _ in range(rounds):
        bad = mutate(comp, 0, len(comp))
        cap = size if rng.random() < 0.8 else rng.randrange(0, 2 * size + 2)
        buf = ctypes.create_string_buffer(cap + 1)
        seen["decoded" if lib.dtf_pq_decompress(4, bad, len(bad), buf, cap) == 0
             else "refused"] += 1
print(seen["read"], seen["raised"], seen["decoded"], seen["refused"])
"""


def _sanitizer_runtime(name):
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = subprocess.run([gxx, f"-print-file-name={name}"], capture_output=True, text=True)
    path = out.stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


def test_mutated_pages_never_fault_under_address_and_ub_sanitizers(tmp_path):
    asan, ubsan = _sanitizer_runtime("libasan.so"), _sanitizer_runtime("libubsan.so")
    if asan is None or ubsan is None:
        pytest.skip("no g++ with the address and undefined-behaviour sanitizer runtimes")
    native = os.path.join(REPO, "datafusion_tpu_torch", "native")
    lib = str(tmp_path / "libpq_asan.so")
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer", "-shared",
                    "-fPIC", "-pthread", "-o", lib,
                    *[os.path.join(native, s) for s in ASAN_SOURCES]],
                   check=True, capture_output=True, timeout=300)
    rng = np.random.default_rng(4)
    cols, names = _encoded_columns(rng, True)
    files = []
    for encoding in (DELTA, BSS):
        for version in ("1.0", "2.0"):
            path = str(tmp_path / f"{encoding}{version}.parquet")
            pick = names[encoding][:6]
            pq.write_table(pa.table({k: cols[k].slice(0, 600) for k in pick}), path,
                           use_dictionary=False, data_page_version=version,
                           column_encoding={k: encoding for k in pick}, data_page_size=512)
            files.append(path)
    hand = str(tmp_path / "hand.parquet")
    values = _wrapping(64, 700, rng)
    write_pages(hand, 2, [(1, 5, delta_stream(values[:300], 64, 256, 8, garbage=200), [1] * 300),
                          (2, 5, delta_stream(values[300:], 64, 512, 16), [1] * 400)])
    files.append(hand)
    streams = []
    text = open(os.path.join(REPO, "README.md"), "rb").read()[:60_000]
    for q in (0, 5, 11):
        path = str(tmp_path / f"brotli{q}.bin")
        comp = pa.Codec("brotli", compression_level=q).compress(text, asbytes=True)
        open(path, "wb").write(str(len(text)).encode() + b":" + comp)
        streams.append(path)
    env = dict(os.environ, LD_PRELOAD=f"{asan} {ubsan}", ASAN_OPTIONS="detect_leaks=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    out = subprocess.run([sys.executable, "-c", ASAN_FUZZ, lib, ",".join(files),
                          ",".join(streams), "150", str(tmp_path / "m.parquet")],
                         capture_output=True, text=True, timeout=400, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "runtime error" not in out.stderr and "AddressSanitizer" not in out.stderr, \
        out.stderr[-4000:]
    read, raised, decoded, refused = map(int, out.stdout.split())
    assert read + raised == 150 * len(files) and raised > 0
    assert decoded + refused == 150 * len(streams) and refused > 0
