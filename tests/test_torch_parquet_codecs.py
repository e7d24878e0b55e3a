"""PyTorch/CUDA port: the Parquet page decompressors of
`native/codecs.cpp` (GZIP, ZSTD, LZ4_RAW, LZ4, BROTLI), on the CPU.

The decoders first, through the test entry `native.parquet.decompress`
(`dtf_pq_decompress`, used by no read), against the standard library's
`zlib` (levels 0 to 9; the default strategy, `Z_FILTERED`, `Z_FIXED`,
`Z_HUFFMAN_ONLY` and `Z_RLE`; gzip and zlib wrappers) and against
pyarrow's `Codec("zstd", level)` for levels 1, 3, 9, 19 and 22 and
`Codec("lz4_raw")`, on inputs that are random, all zeros (ZSTD RLE
blocks), incompressible (ZSTD raw blocks), larger than 128 KiB (frames
of several blocks), text, doubles and empty: each decodes bit for bit,
and an output size one byte off either way raises IoError.  Hand-built
inputs cover what the writers here do not emit: gzip members in a row,
zlib's preset dictionary, bad checksums and lengths, ZSTD frames
concatenated and with skippable frames, a content checksum (XXH64), a
dictionary ID, raw and RLE blocks, and Hadoop-framed LZ4 blocks with
parquet-cpp's fall back to one raw block.  BROTLI against pyarrow's
`Codec("brotli", level)` at every level from 0 to 11 on the same inputs,
and against this machine's libbrotlienc (ctypes) at every window size
from 10 to 24 bits in its generic, text and font modes (skipped where
the library cannot be loaded); hand-built streams with metadata and
uncompressed meta-blocks; faults (a large-window header, a cut stream,
nonzero padding) raise as pyarrow raises; the committed tables of
`brotli_dictionary.cpp` equal libbrotlicommon's.

Then files: pyarrow writes the typed columns of
`tests/test_torch_parquet.py` (with and without NULLs, data page v1
and v2, dictionary on and off) with GZIP, ZSTD, LZ4_RAW and BROTLI, ZSTD at
every level from 1 to 22, BROTLI at every level from 0 to 11, and the
SF 0.05 lineitem in each codec; an
LZ4_RAW file relabelled LZ4 (parquet-cpp's raw fall back) and
`chip_smoke.py`'s writer with Hadoop-framed LZ4 pages; every one reads
through the port to the JAX package's batches bit for bit.  The
committed fixtures `tests/torch_data/parquet/lineitem_65536_*.parquet`
(`scripts/port_parquet_codec_fixtures.py`) hold `chip_smoke.lineitem_sf1`'s
first 65,536 rows and read as the JAX package reads them.  A hypothesis
fuzz of truncated and bit-flipped compressed files runs in a subprocess
under an address-space limit and must give IoError or ExecutionError or
a read, never a crash.  `ldd` of the built library shows no zlib, zstd,
lz4 or brotli library.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from datafusion_tpu.io.readers import ParquetReader as JaxParquetReader

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.native import build_library
from datafusion_tpu_torch.native.parquet import decompress
from test_torch_parquet import (BATCH, REPO, ROW_GROUP, ROWS, _patch_codec, _type_columns,
                                assert_same_read, read_all)

GZIP, BROTLI, LZ4, ZSTD, LZ4_RAW = 2, 4, 5, 6, 7
FIXTURES = os.path.join(REPO, "tests", "torch_data", "parquet")


def _inputs():
    rng = np.random.default_rng(21)
    words = np.array([b"alpha", b"beta", b"gamma", b"delta", b"x" * 30, b"\x00\x01"])
    return {
        "empty": b"",
        "one": b"a",
        "zeros": bytes(300_000),
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "incompressible": rng.bytes(150_000),
        "text": b" ".join(words[rng.integers(0, len(words), 60_000)]),
        "doubles": (rng.integers(90_000, 10_495_000, 40_000) / 100.0).tobytes(),
        "smallints": rng.integers(0, 50, 100_000).astype(np.int32).tobytes(),
    }


INPUTS = _inputs()
STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
              "fixed": zlib.Z_FIXED, "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE}


def _deflate(raw, level, strategy, wbits):
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, 9, strategy)
    return c.compress(raw) + c.flush()


def _same_and_exact(codec, comp, raw):
    """`comp` decodes to `raw`; a size one off either way raises."""
    assert decompress(codec, comp, len(raw)) == raw
    with pytest.raises(tdf.IoError):
        decompress(codec, comp, len(raw) + 1)
    if raw:
        with pytest.raises(tdf.IoError):
            decompress(codec, comp, len(raw) - 1)


# ------------------------------------------------------------ GZIP

@pytest.mark.parametrize("wbits", [31, 15], ids=["gzip", "zlib"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_gzip_matches_zlib(name, wbits):
    raw = INPUTS[name]
    for level in range(10):
        for strategy in STRATEGIES.values():
            comp = _deflate(raw, level, strategy, wbits)
            assert decompress(GZIP, comp, len(raw)) == raw, (level, strategy)
    _same_and_exact(GZIP, _deflate(raw, 6, zlib.Z_DEFAULT_STRATEGY, wbits), raw)


def test_gzip_members_in_a_row_and_header_fields():
    a, b = INPUTS["text"][:5000], INPUTS["doubles"][:7000]
    two = _deflate(a, 9, 0, 31) + _deflate(b, 1, 0, 31)
    assert decompress(GZIP, two, len(a) + len(b)) == a + b
    # FEXTRA, FNAME, FCOMMENT and FHCRC before the deflate stream
    body = _deflate(a, 6, 0, -15)
    header = bytes([0x1F, 0x8B, 8, 4 | 8 | 16 | 2, 0, 0, 0, 0, 0, 3])
    header += (3).to_bytes(2, "little") + b"xyz" + b"name\0" + b"comment\0" + b"\0\0"
    trailer = zlib.crc32(a).to_bytes(4, "little") + len(a).to_bytes(4, "little")
    assert decompress(GZIP, header + body + trailer, len(a)) == a


@pytest.mark.parametrize("fault", ["crc", "isize", "adler", "preset_dictionary",
                                   "trailing_bytes", "truncated", "raw_deflate"])
def test_gzip_faults_raise(fault):
    raw = INPUTS["text"][:20000]
    gz, zl = bytearray(_deflate(raw, 6, 0, 31)), bytearray(_deflate(raw, 6, 0, 15))
    if fault == "crc":
        gz[-8] ^= 1
        comp, match = gz, "CRC-32"
    elif fault == "isize":
        gz[-4] ^= 1
        comp, match = gz, "ISIZE"
    elif fault == "adler":
        zl[-1] ^= 1
        comp, match = zl, "Adler-32"
    elif fault == "preset_dictionary":
        c = zlib.compressobj(6, zlib.DEFLATED, 15, 9, 0, zdict=b"alpha beta gamma")
        comp, match = c.compress(raw) + c.flush(), "dictionary"
    elif fault == "trailing_bytes":
        comp, match = zl + b"\0", "after the zlib stream"
    elif fault == "truncated":
        comp, match = gz[:len(gz) // 2], "truncated"
    else:
        comp, match = _deflate(raw, 6, 0, -15), "neither a gzip nor a zlib"
    with pytest.raises(tdf.IoError, match=match):
        decompress(GZIP, bytes(comp), len(raw))


# ------------------------------------------------------------ ZSTD

@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_zstd_matches_pyarrow(name, level):
    raw = INPUTS[name]
    _same_and_exact(ZSTD, pa.Codec("zstd", level).compress(raw, asbytes=True), raw)


def _xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64, the ZSTD content checksum (a reference in Python)."""
    m = (1 << 64) - 1
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
                          9650029242287828579, 2870177450012600261)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return rotl((acc + lane * p2) & m, 31) * p1 & m

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed, (seed - p1) & m]
        while i + 32 <= n:
            v = [rnd(v[k], int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little"))
                 for k in range(4)]
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for lane in v:
            h = ((h ^ rnd(0, lane)) * p1 + p4) & m
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * p5 & m), 11) * p1 & m
        i += 1
    h = (h ^ (h >> 33)) * p2 & m
    h = (h ^ (h >> 29)) * p3 & m
    return h ^ (h >> 32)


def _zstd_frame(blocks, content_size=None, checksum_of=None, dict_id=0):
    """A hand-built ZSTD frame of raw ("raw", bytes) and RLE ("rle",
    byte, count) blocks: single segment when the content size is given,
    else a window descriptor; a content checksum of `checksum_of`."""
    fhd = (4 if checksum_of is not None else 0) | (1 if dict_id else 0)
    out = bytearray((0xFD2FB528).to_bytes(4, "little"))
    if content_size is not None:
        out += bytes([fhd | 0x20 | (2 << 6)]) + (b"\x07" if dict_id else b"")
        out += content_size.to_bytes(4, "little")
    else:
        out += bytes([fhd, 0x50]) + (b"\x07" if dict_id else b"")  # a 1 MiB window
    for i, block in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        if block[0] == "raw":
            out += (last | len(block[1]) << 3).to_bytes(3, "little") + block[1]
        else:
            out += (last | 2 | block[2] << 3).to_bytes(3, "little") + bytes([block[1]])
    if checksum_of is not None:
        out += (_xxh64(checksum_of) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def test_zstd_raw_and_rle_blocks_and_checksum():
    want = b"head" + b"\x07" * 100_000 + b"tail"
    frame = _zstd_frame([("raw", b"head"), ("rle", 7, 100_000), ("raw", b"tail")],
                        content_size=len(want), checksum_of=want)
    _same_and_exact(ZSTD, frame, want)
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(tdf.IoError, match="checksum"):
        decompress(ZSTD, bytes(bad), len(want))
    with pytest.raises(tdf.IoError, match="content size"):
        decompress(ZSTD, _zstd_frame([("raw", b"ab")], content_size=3), 2)


def test_zstd_frames_in_a_row_and_skippable_frames():
    a, b = INPUTS["text"][:50_000], INPUTS["doubles"]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    page = (skippable + pa.Codec("zstd", 3).compress(a, asbytes=True) + skippable
            + _zstd_frame([("rle", 1, 10)]) + pa.Codec("zstd", 19).compress(b, asbytes=True))
    assert decompress(ZSTD, page, len(a) + 10 + len(b)) == a + b"\x01" * 10 + b


def test_zstd_checksummed_frames_of_another_compressor():
    """zstandard's frames, with a content checksum, with and without the
    content size, long-distance matching, and the Python XXH64 above
    against xxhash's."""
    zstandard = pytest.importorskip("zstandard")
    xxhash = pytest.importorskip("xxhash")
    for name, raw in INPUTS.items():
        assert _xxh64(raw) == xxhash.xxh64(raw).intdigest(), name
    raw = INPUTS["text"] + INPUTS["doubles"] + INPUTS["text"]
    for level in (-5, 1, 7, 19):
        for size in (True, False):
            params = zstandard.ZstdCompressionParameters.from_level(
                level, write_checksum=True, write_content_size=size,
                enable_ldm=level == 19)
            comp = zstandard.ZstdCompressor(compression_params=params).compress(raw)
            _same_and_exact(ZSTD, comp, raw)
            bad = bytearray(comp)
            bad[-2] ^= 0x10
            with pytest.raises(tdf.IoError, match="checksum"):
                decompress(ZSTD, bytes(bad), len(raw))


def test_zstd_dictionary_frames_raise():
    with pytest.raises(tdf.IoError, match="dictionary 7"):
        decompress(ZSTD, _zstd_frame([("raw", b"abc")], dict_id=7), 3)


# ------------------------------------------------------------ LZ4

@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lz4_raw_matches_pyarrow(name):
    raw = INPUTS[name]
    comp = pa.Codec("lz4_raw").compress(raw, asbytes=True)
    _same_and_exact(LZ4_RAW, comp, raw)
    # LZ4 (codec 5) reads an unframed block as parquet-cpp does
    assert decompress(LZ4, comp, len(raw)) == raw


def _hadoop(raw, cuts):
    """`raw` in Hadoop's LZ4 framing, one frame a slice between cuts."""
    out = b""
    for lo, hi in zip([0, *cuts], [*cuts, len(raw)]):
        block = pa.Codec("lz4_raw").compress(raw[lo:hi], asbytes=True)
        out += (hi - lo).to_bytes(4, "big") + len(block).to_bytes(4, "big") + block
    return out


@pytest.mark.parametrize("name", ["text", "doubles", "zeros", "one"])
def test_lz4_hadoop_frames(name):
    raw = INPUTS[name]
    for cuts in ([], [len(raw) // 3], [len(raw) // 4, len(raw) // 2, 3 * len(raw) // 4]):
        _same_and_exact(LZ4, _hadoop(raw, sorted(set(cuts) - {0})), raw)


def test_lz4_hadoop_framing_that_does_not_cover_the_page_falls_back_and_raises():
    raw = INPUTS["text"][:40_000]
    framed = _hadoop(raw, [10_000])
    with pytest.raises(tdf.IoError, match="LZ4"):  # neither framed nor one raw block
        decompress(LZ4, framed + b"\0", len(raw))
    with pytest.raises(tdf.IoError, match="offset"):
        decompress(LZ4_RAW, b"\x0f\x00\x00", 19)


# ------------------------------------------------------------ BROTLI

@pytest.mark.parametrize("level", range(12))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_brotli_matches_pyarrow(name, level):
    raw = INPUTS[name]
    comp = pa.Codec("brotli", compression_level=level).compress(raw, asbytes=True)
    _same_and_exact(BROTLI, comp, raw)


def _libbrotli(name):
    import ctypes

    try:
        return ctypes.CDLL(name)
    except OSError as e:
        pytest.skip(f"{name} cannot be loaded here ({e}): no reference encoder")


def _brotli_compress(raw, quality, lgwin, mode):
    """`raw` through libbrotlienc's BrotliEncoderCompress (mode 0
    generic, 1 text, 2 font)."""
    import ctypes

    enc = _libbrotli("libbrotlienc.so.1")
    enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
    enc.BrotliEncoderCompress.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_size_t, ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    cap = enc.BrotliEncoderMaxCompressedSize(len(raw)) or len(raw) + 1024
    out, size = ctypes.create_string_buffer(cap), ctypes.c_size_t(cap)
    assert enc.BrotliEncoderCompress(quality, lgwin, mode, len(raw), raw, ctypes.byref(size), out)
    return out.raw[:size.value]


def _window_input():
    """Text, random bytes, a long run and the text again at distances
    past the small windows (and past 2^16 for the large ones)."""
    text = open(os.path.join(REPO, "README.md"), "rb").read()[:90_000]
    rng = np.random.default_rng(31)
    return (text + rng.bytes(50_000) + text[::-1] + bytes(70_000) + text) * 3


@pytest.mark.parametrize("lgwin", range(10, 25))
def test_brotli_every_window_size_of_libbrotlienc(lgwin):
    raw = _window_input()
    for quality in (1, 4, 9, 11):
        for mode in (0, 1, 2):
            comp = _brotli_compress(raw, quality, lgwin, mode)
            assert decompress(BROTLI, comp, len(raw)) == raw, (quality, mode)


def test_committed_brotli_tables_equal_libbrotlicommons():
    """`brotli_dictionary.cpp` holds the dictionary that
    BrotliGetDictionary() gives (RFC 7932's length and SHA-256), and the
    script writes that file again byte for byte."""
    import hashlib

    _libbrotli("libbrotlicommon.so.1")
    spec = importlib.util.spec_from_file_location(
        "port_brotli_dictionary", os.path.join(REPO, "scripts", "port_brotli_dictionary.py"))
    bd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bd)
    data, transforms, lut = bd.extract()
    committed = bd.parse_dictionary()
    assert committed == data and len(committed) == 122_784
    assert hashlib.sha256(committed).hexdigest() == bd.SHA256
    assert len(transforms) == 121 and transforms[5] == (b"", 0, b" the ")
    with open(bd.OUT, encoding="ascii") as f:
        assert f.read() == bd.render(data, transforms, lut)


class _Bits:
    """A Brotli bit writer: fields least significant bit first."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value, width):
        self.acc |= value << self.n
        self.n += width
        return self

    def pad(self):
        self.n += -self.n % 8
        return self

    def raw(self, data):
        self.pad()
        for b in data:
            self.put(b, 8)
        return self

    def bytes(self):
        return self.pad().acc.to_bytes(self.n // 8, "little")


def _uncompressed_block(bits, data):
    """A meta-block of `data` stored uncompressed (MNIBBLES 4)."""
    return bits.put(0, 1).put(0, 2).put(len(data) - 1, 16).put(1, 1).raw(data)


def test_brotli_metadata_and_uncompressed_meta_blocks():
    """Hand-built streams pyarrow also reads: a metadata meta-block
    skipped, uncompressed meta-blocks, then an empty last meta-block;
    window bits of several sizes; bytes after the stream."""
    a, b = INPUTS["text"][:3000], INPUTS["random"][:500]
    for wbits in (16, 17, 10, 18, 24):
        bits = _Bits()
        if wbits == 16:
            bits.put(0, 1)
        elif wbits == 17:
            bits.put(1, 1).put(0, 3).put(0, 3)
        elif wbits < 16:
            bits.put(1, 1).put(0, 3).put(wbits - 8, 3)
        else:
            bits.put(1, 1).put(wbits - 17, 3)
        bits.put(0, 1).put(3, 2).put(0, 1).put(1, 2).put(4, 8).raw(b"meta!")  # 5 bytes skipped
        _uncompressed_block(bits, a)
        _uncompressed_block(bits, b)
        stream = bits.put(1, 1).put(1, 1).bytes()  # ISLAST, ISLASTEMPTY
        assert pa.Codec("brotli").decompress(stream, len(a + b), asbytes=True) == a + b
        _same_and_exact(BROTLI, stream, a + b)
        # bytes after the stream are not read, by pyarrow nor here
        assert pa.Codec("brotli").decompress(stream + b"xyz", len(a + b), asbytes=True) == a + b
        assert decompress(BROTLI, stream + b"xyz", len(a + b)) == a + b


BROTLI_FAULTS = {  # stream from a valid one, message
    "large_window": (lambda s: bytes([0x11]) + s[1:], "large-window"),
    "truncated": (lambda s: s[:len(s) // 2], "truncated"),
    "padding_bits": (lambda s: s[:-1] + bytes([s[-1] | 0x80]), "padding"),
    "empty": (lambda s: b"", "truncated"),
}


@pytest.mark.parametrize("fault", sorted(BROTLI_FAULTS))
def test_brotli_faults_raise(fault):
    raw = INPUTS["text"][:3000]
    bits = _Bits().put(0, 1)
    stream = _uncompressed_block(bits, raw).put(1, 1).put(1, 1).bytes()
    make, match = BROTLI_FAULTS[fault]
    bad = make(stream)
    with pytest.raises(tdf.IoError, match=match):
        decompress(BROTLI, bad, len(raw))
    with pytest.raises(OSError):  # pyarrow refuses it too
        assert pa.Codec("brotli").decompress(bad, len(raw), asbytes=True) == raw


def test_corrupt_brotli_pages_raise_io_error_naming_brotli_and_the_column(tmp_path):
    path = str(tmp_path / "b.parquet")
    words = INPUTS["text"][:50_000].decode("latin-1").split(" ")
    pq.write_table(pa.table({"col_b": pa.array(words, pa.string())}), path,
                   compression="brotli", use_dictionary=False)
    assert_same_read(path)
    md = pq.ParquetFile(path).metadata.row_group(0).column(0)
    blob = bytearray(open(path, "rb").read())
    end = md.data_page_offset + md.total_compressed_size
    named = 0
    for at in range(end - 200, end, 7):  # inside the last page's stream
        bad = bytearray(blob)
        bad[at] ^= 0x5A
        p = str(tmp_path / "bad.parquet")
        with open(p, "wb") as f:
            f.write(bad)
        try:
            read_all(tdf.io.readers.ParquetReader(p))
        except tdf.IoError as e:
            # a flipped literal decodes (Brotli has no checksum) and the
            # values' decoder may be the one to refuse the page
            assert "column 'col_b'" in str(e), str(e)
            named += "BROTLI" in str(e)
    assert named > 0


# ------------------------------------------------------------ files

CODECS = ["gzip", "zstd", "lz4_raw", "brotli"]
VARIANTS = [(nulls, version, dictionary) for nulls in (False, True)
            for version in ("1.0", "2.0") for dictionary in (True, False)]


def _variant_id(v):
    nulls, version, dictionary = v
    return f"{'nulls' if nulls else 'dense'}-v{version[0]}-{'dict' if dictionary else 'plain'}"


@pytest.fixture(scope="module")
def typed_tables():
    return {v: pa.table(_type_columns(np.random.default_rng(300 + i), ROWS, v[0]))
            for i, v in enumerate(VARIANTS)}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_every_type_every_codec_equals_the_jax_reader(typed_tables, tmp_path, variant, codec):
    _, version, dictionary = variant
    path = str(tmp_path / "t.parquet")
    pq.write_table(typed_tables[variant], path, data_page_version=version, compression=codec,
                   use_dictionary=dictionary, row_group_size=ROW_GROUP, data_page_size=4096)
    md = pq.ParquetFile(path).metadata
    want = {"gzip": "GZIP", "zstd": "ZSTD", "lz4_raw": "LZ4", "brotli": "BROTLI"}[codec]
    assert md.row_group(0).column(0).compression == want
    sizes = assert_same_read(path)
    assert sum(sizes) == ROWS and max(sizes) <= BATCH


@pytest.mark.parametrize("level", range(1, 23))
def test_zstd_every_level_equals_the_jax_reader(typed_tables, tmp_path, level):
    path = str(tmp_path / "z.parquet")
    pq.write_table(typed_tables[(True, "2.0", True)], path, compression="zstd",
                   compression_level=level, row_group_size=ROW_GROUP, data_page_size=16384)
    assert_same_read(path)


@pytest.mark.parametrize("level", range(12))
def test_brotli_every_level_equals_the_jax_reader(typed_tables, tmp_path, level):
    path = str(tmp_path / "b.parquet")
    pq.write_table(typed_tables[(True, "2.0", False)], path, compression="brotli",
                   compression_level=level, row_group_size=ROW_GROUP, data_page_size=16384)
    assert_same_read(path)


@pytest.fixture(scope="module")
def lineitem_table(tmp_path_factory):
    """benchmarks/data.py's lineitem at SF 0.05 (300,000 rows)."""
    sys.path.insert(0, REPO)
    from benchmarks import data as bdata

    before = bdata.BENCH_DIR
    bdata.BENCH_DIR = str(tmp_path_factory.mktemp("bench_codecs"))
    try:
        return pq.read_table(bdata.lineitem_parquet(0.05))
    finally:
        bdata.BENCH_DIR = before


@pytest.mark.parametrize("codec", CODECS)
def test_lineitem_every_codec_equals_the_jax_reader(lineitem_table, tmp_path, codec):
    path = str(tmp_path / "li.parquet")
    pq.write_table(lineitem_table, path, compression=codec, row_group_size=100_000)
    assert_same_read(path, None, 131072)


def test_lz4_raw_file_labelled_lz4_reads_as_one_raw_block(tmp_path):
    path = str(tmp_path / "l.parquet")
    pq.write_table(pa.table({"a": pa.array(np.arange(5000) % 77)}), path,
                   compression="lz4_raw", use_dictionary=False)
    _patch_codec(path, 7, 5)
    md = pq.ParquetFile(path).metadata.row_group(0).column(0)
    assert md.compression == "UNKNOWN"  # pyarrow's name of LZ4 (Hadoop)
    assert_same_read(path)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_codecs",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_writer_hadoop_lz4_and_gzip_files_equal_the_jax_reader(tmp_path):
    """`chip_smoke.write_parquet` with Hadoop-framed LZ4 pages (one frame
    a 64 KiB slice) and with its own GZIP pages: pyarrow and the port
    read the same batches."""
    cs = _chip_smoke()
    cs.PQ_COMPRESSORS[LZ4] = lambda raw: _hadoop(raw, list(range(1 << 16, len(raw), 1 << 16)))
    cs.PARQUET_PAGE_BYTES = 200_000
    rng = np.random.default_rng(8)
    n = 150_000
    columns = [
        ("s", cs.PQ_BYTE_ARRAY, "dict", rng.integers(0, 3, n), np.array([b"a", b"bb", b"ccc"],
                                                                         dtype=object)),
        ("p", cs.PQ_DOUBLE, "plain", np.round(rng.uniform(0, 1000, n), 2), None),
        ("q", cs.PQ_DOUBLE, "dict", rng.integers(0, 50, n), np.arange(50) / 4.0),
    ]
    for codec, name in ((LZ4, "UNKNOWN"), (cs.PQ_GZIP, "GZIP")):  # pyarrow's names
        path = str(tmp_path / f"w{codec}.parquet")
        cs.write_parquet(path, columns, rows_per_group=60_000, codec=codec)
        md = pq.ParquetFile(path).metadata
        assert md.num_row_groups == 3 and md.row_group(0).column(1).compression == name
        assert_same_read(path)


def test_committed_fixtures_hold_lineitem_sf1_rows_and_read_as_the_jax_reader():
    spec = importlib.util.spec_from_file_location(
        "port_parquet_codec_fixtures",
        os.path.join(REPO, "scripts", "port_parquet_codec_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    c, dates = fx.lineitem_rows()
    want = fx.arrow_table(c, dates)
    for codec in fx.CODECS:
        path = os.path.join(FIXTURES, f"lineitem_{fx.ROWS}_{codec}.parquet")
        assert os.path.getsize(path) <= 800_000
        md = pq.ParquetFile(path).metadata
        assert md.num_row_groups == 4 and md.row_group(0).num_rows == fx.ROW_GROUP
        assert pq.read_table(path).equals(want), codec
        assert_same_read(path, None, 131072)
        got = read_all(tdf.io.readers.ParquetReader(path))
        assert got[1][0] == list("ANR")[:len(got[1][0])]
        assert np.array_equal(got[0][3][0], c["price"])


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
names = sorted(os.listdir(DATA))
blobs = [open(os.path.join(DATA, f), "rb").read() for f in names]
out = os.path.join(tempfile.mkdtemp(), "f.parquet")
seen = {"read": 0, "raised": 0}

@settings(max_examples=int(sys.argv[2]), deadline=None, database=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(st.integers(0, len(blobs) - 1),
       st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(0, 7)), max_size=6),
       st.one_of(st.none(), st.floats(0.02, 1)))
def probe(which, flips, cut):
    data = bytearray(blobs[which])
    body = len(data) - 8 - int.from_bytes(data[-8:-4], "little")  # the pages, not the footer
    for pos, bit in flips:
        data[4 + int(pos * (body - 4))] ^= 1 << bit
    if cut is not None:
        keep = 4 + int(cut * (body - 4))
        data = data[:keep] + data[body:]  # pages cut short under an intact footer
    with open(out, "wb") as f:
        f.write(data)
    try:
        schema = infer_parquet_schema(out)
        for _ in ParquetReader(out, schema, batch_size=777).batches():
            pass
        seen["read"] += 1
    except (IoError, ExecutionError):
        seen["raised"] += 1

probe()
print(seen["read"], seen["raised"])
"""


def test_truncated_and_bit_flipped_compressed_pages_never_crash_the_reader(tmp_path):
    data = tmp_path / "files"
    data.mkdir()
    table = pa.table({k: v for k, v in
                      _type_columns(np.random.default_rng(77), 1500, True).items()
                      if k in ("int64", "double", "string", "timestamp_ms", "bool")})
    for codec in CODECS:
        for version in ("1.0", "2.0"):
            pq.write_table(table, str(data / f"{codec}{version}.parquet"), compression=codec,
                           data_page_version=version, row_group_size=700,
                           data_page_size=2048)
    t0 = time.perf_counter()
    # run from a scratch directory: hypothesis keeps its caches in the cwd
    out = subprocess.run([sys.executable, "-c", FUZZ, str(data), "400"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, (out.returncode, out.stderr[-3000:])
    read, raised = map(int, out.stdout.split())
    assert read + raised >= 400 and raised > 0
    assert time.perf_counter() - t0 < 240


def test_library_links_no_compression_library():
    if shutil.which("ldd") is None:
        pytest.skip("no ldd on this machine")
    out = subprocess.run(["ldd", str(build_library())], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    for name in ("libz.", "libzstd", "liblz4", "libbrotli", "libsnappy"):
        assert name not in out, out


def test_jax_reader_reads_every_codec_fixture_batch_for_batch():
    """The fixtures' batches, one per row group, in both packages."""
    for codec in CODECS:
        path = os.path.join(FIXTURES, f"lineitem_65536_{codec}.parquet")
        jax_sizes = [b.num_rows for b in JaxParquetReader(path, None, 131072).batches()]
        port_sizes = [b.num_rows for b in tdf.io.readers.ParquetReader(path).batches()]
        assert jax_sizes == port_sizes == [16_384] * 4
