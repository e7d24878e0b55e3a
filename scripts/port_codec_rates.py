"""Decode rates of the port's Parquet page decompressors on this host.

    python3 scripts/port_codec_rates.py [--repeats N]

GZIP: `chip_smoke.lineitem_sf1`'s first 1,000,000 `l_extendedprice`
values (8 MB of doubles, the pace-setting column of the GZIP SF-1 file)
compressed by the standard library's zlib as `chip_smoke._gzip` writes
a page (level 6, gzip wrapper), decoded by `native.parquet.decompress`
(the port's inflate) and by `zlib.decompress`, best of N, in MB/s of
output.  ZSTD, LZ4_RAW, GZIP, BROTLI and v2-layout (DELTA_BINARY_PACKED,
BYTE_STREAM_SPLIT) files: each committed fixture of
`tests/torch_data/parquet/` scanned whole by the port's reader, best of
N, in MB/s of the pages' uncompressed bytes (the footer's
`total_uncompressed_size` of every chunk).  With `--layout-rows N`:
`chip_smoke.lineitem_sf1`'s first N rows written by
`chip_smoke.write_lineitem_parquet` in its "v1" (SNAPPY) and "v2"
(DELTA_BINARY_PACKED dates, BYTE_STREAM_SPLIT doubles) layouts to a
temporary directory, each scanned whole at batches of 131,072, and
without l_shipdate (its last column), best of N, in ms: the difference
is what the date column costs, decoded and made strings.  Prints one
JSON line.  Runs on any host with a C++ compiler;
needs neither pyarrow nor a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GZIP = 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rates",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _best(fn, repeats):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--layout-rows", type=int, default=0)
    args = ap.parse_args(argv)

    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.io.readers import ParquetReader
    from datafusion_tpu_torch.native.parquet import decompress

    cs = _chip_smoke()
    cs.SF1_ROWS = 1_000_000
    _, cols, _ = cs.lineitem_sf1(tdf, 1 << 20)
    raw = cols["price"].astype("<f8").tobytes()
    comp = cs._gzip(raw)
    if decompress(GZIP, comp, len(raw)) != raw:
        raise AssertionError("inflate disagrees with zlib")
    port_s = _best(lambda: decompress(GZIP, comp, len(raw)), args.repeats)
    zlib_s = _best(lambda: zlib.decompress(comp, 31), args.repeats)
    out = {"gzip_l_extendedprice": {
        "bytes": len(raw), "ratio": len(raw) / len(comp),
        "port_mb_s": len(raw) / port_s / 1e6, "zlib_mb_s": len(raw) / zlib_s / 1e6}}

    fixtures = os.path.join(REPO, "tests", "torch_data", "parquet")
    for codec, rows in cs.PARQUET_CODEC_FIXTURES:
        path = os.path.join(fixtures, f"lineitem_{rows}_{codec}.parquet")
        ubytes = _uncompressed_bytes(path)
        scan_s = _best(lambda: sum(b.num_rows for b in ParquetReader(path).batches()),
                       args.repeats)
        out[f"scan_{codec}_fixture"] = {"file_bytes": os.path.getsize(path),
                                        "uncompressed_bytes": ubytes,
                                        "scan_ms": scan_s * 1e3,
                                        "mb_s": ubytes / scan_s / 1e6}
    if args.layout_rows:
        import tempfile

        cs.SF1_ROWS = args.layout_rows
        _, cols, dates = cs.lineitem_sf1(tdf, 1 << 20)
        with tempfile.TemporaryDirectory() as tmp:
            for layout in ("v1", "v2"):
                path = os.path.join(tmp, f"lineitem_{layout}.parquet")
                nbytes = cs.write_lineitem_parquet(path, cols, dates, layout=layout)
                scan_s, rest_s = (
                    _best(lambda p=path, cut=cut: sum(
                        b.num_rows for b in ParquetReader(p, batch_size=131072,
                                                          projection=cut).batches()),
                          args.repeats)
                    for cut in (None, range(6)))
                out[f"scan_lineitem_{layout}"] = {
                    "rows": args.layout_rows, "file_bytes": nbytes, "scan_ms": scan_s * 1e3,
                    "scan_without_l_shipdate_ms": rest_s * 1e3}
    print(json.dumps(out))
    return 0


def _uncompressed_bytes(path: str) -> int:
    """The sum of every column chunk's total_uncompressed_size: field 6 of
    each ColumnMetaData, at FileMetaData.row_groups (4) -> RowGroup.columns
    (1) -> ColumnChunk.meta_data (3), walking the footer's Thrift compact
    protocol."""
    blob = open(path, "rb").read()
    pos = len(blob) - 8 - int.from_bytes(blob[-8:-4], "little")
    total = 0

    def varint(i):
        out = shift = 0
        while True:
            out |= (blob[i] & 0x7F) << shift
            shift += 7
            i += 1
            if not blob[i - 1] & 0x80:
                return out, i

    def value(kind, i, ids):
        nonlocal total
        if kind in (4, 5, 6):  # i16, i32, i64
            v, i = varint(i)
            if ids == (4, 1, 3, 6):
                total += (v >> 1) ^ -(v & 1)
            return i
        if kind == 3:  # byte
            return i + 1
        if kind == 7:  # double
            return i + 8
        if kind == 8:  # binary
            n, i = varint(i)
            return i + n
        if kind in (9, 10):  # list, set: elements keep the field's path
            n, et = blob[i] >> 4, blob[i] & 0x0F
            i += 1
            if n == 15:
                n, i = varint(i)
            for _ in range(n):
                i = i + 1 if et in (1, 2) else value(et, i, ids)
            return i
        if kind == 12:  # struct
            fid = 0
            while blob[i]:
                delta, ft = blob[i] >> 4, blob[i] & 0x0F
                i += 1
                if delta:
                    fid += delta
                else:
                    v, i = varint(i)
                    fid = (v >> 1) ^ -(v & 1)
                i = i if ft in (1, 2) else value(ft, i, ids + (fid,))
            return i + 1
        raise ValueError(f"Thrift wire type {kind} in {path}")

    value(12, pos, ())
    return total


if __name__ == "__main__":
    sys.exit(main())
