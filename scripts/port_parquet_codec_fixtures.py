"""Write the Parquet fixtures `chip_smoke.py` reads on the card.

    python3 scripts/port_parquet_codec_fixtures.py [OUT_DIR]

Rows [0, 65,536) of `chip_smoke.lineitem_sf1`'s columns (seed 42; the
first of its 1,000,000-row chunks, so the same rows as the full SF-1
table), as 4 row groups of 16,384 rows written by pyarrow, one file each
in OUT_DIR (default `tests/torch_data/parquet/`):

- `lineitem_65536_<codec>.parquet` with `compression=` `"zstd"`,
  `"lz4_raw"`, `"gzip"` and `"brotli"`: l_returnflag, l_linestatus and
  l_shipdate strings, the other four doubles, as
  `chip_smoke.write_lineitem_parquet` writes them;
- `lineitem_32768_v2_snappy.parquet`, the encodings of that writer's
  "v2" layout from an independent writer: data page v2, l_shipdate a
  date32 in DELTA_BINARY_PACKED, the four doubles BYTE_STREAM_SPLIT,
  the two flags dictionary-coded, SNAPPY; rows [0, 32,768) only, in 2
  row groups, since BYTE_STREAM_SPLIT doubles under SNAPPY take about
  20 bytes a row (65,536 rows: 1,300,735 bytes).

The card's machine has no pyarrow and no ZSTD, LZ4 or Brotli
compressor, so the files are committed; this script needs pyarrow and
runs where it is installed.  pyarrow stores its Arrow schema in each
footer.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, ROW_GROUP = 65_536, 16_384
CODECS = ("zstd", "lz4_raw", "gzip", "brotli")
V2, V2_ROWS = "v2_snappy", 32_768


def lineitem_rows(rows: int = ROWS):
    """(columns, dates) of `chip_smoke.lineitem_sf1`'s first `rows` rows."""
    sys.path.insert(0, REPO)
    import datafusion_tpu_torch as tdf

    spec = importlib.util.spec_from_file_location("chip_smoke_fixtures",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.SF1_ROWS = 1_000_000  # one chunk: its rows are the full table's first
    _, c, dates = cs.lineitem_sf1(tdf, 1 << 20)
    return {k: v[:rows] for k, v in c.items()}, dates


def arrow_table(c, dates):
    import pyarrow as pa

    def strings(codes, values):
        return pa.array(np.array(values, dtype=object)[codes].tolist(), pa.string())

    return pa.table({
        "l_returnflag": strings(c["flag"], list("ANR")),
        "l_linestatus": strings(c["status"], list("FO")),
        "l_quantity": pa.array(c["qty"]),
        "l_extendedprice": pa.array(c["price"]),
        "l_discount": pa.array(c["disc"]),
        "l_tax": pa.array(c["tax"]),
        "l_shipdate": strings(c["ship"], dates),
    })


def arrow_table_v2(c, dates):
    """`arrow_table`'s columns with l_shipdate a date32."""
    import pyarrow as pa

    days = np.array(dates, dtype="datetime64[D]")[c["ship"]]
    return arrow_table(c, dates).set_column(6, "l_shipdate", pa.array(days, pa.date32()))


def write_v2(table, path):
    import pyarrow.parquet as pq

    doubles = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
    pq.write_table(table, path, compression="snappy", row_group_size=ROW_GROUP,
                   data_page_version="2.0", use_dictionary=["l_returnflag", "l_linestatus"],
                   column_encoding={"l_shipdate": "DELTA_BINARY_PACKED",
                                    **{k: "BYTE_STREAM_SPLIT" for k in doubles}})


def main(argv) -> int:
    import pyarrow.parquet as pq

    out = argv[1] if len(argv) > 1 else os.path.join(REPO, "tests", "torch_data", "parquet")
    os.makedirs(out, exist_ok=True)
    table = arrow_table(*lineitem_rows())
    for codec in CODECS:
        path = os.path.join(out, f"lineitem_{ROWS}_{codec}.parquet")
        pq.write_table(table, path, compression=codec, row_group_size=ROW_GROUP)
        print(f"{path}: {os.path.getsize(path)} bytes")
    path = os.path.join(out, f"lineitem_{V2_ROWS}_{V2}.parquet")
    write_v2(arrow_table_v2(*lineitem_rows(V2_ROWS)), path)
    print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
