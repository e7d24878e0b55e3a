"""Write the compressed Parquet fixtures `chip_smoke.py` reads on the card.

    python3 scripts/port_parquet_codec_fixtures.py [OUT_DIR]

Rows [0, 65,536) of `chip_smoke.lineitem_sf1`'s columns (seed 42; the
first of its 1,000,000-row chunks, so the same rows as the full SF-1
table), as 4 row groups of 16,384 rows written by pyarrow with
`compression="zstd"`, `"lz4_raw"` and `"gzip"`, one file each:
`lineitem_65536_<codec>.parquet` in OUT_DIR (default
`tests/torch_data/parquet/`).  The card's machine has neither pyarrow
nor a ZSTD or LZ4 compressor, so the files are committed; this script
needs pyarrow and runs where it is installed.  l_returnflag,
l_linestatus and l_shipdate are strings, the other four doubles, as
`chip_smoke.write_lineitem_parquet` writes them; pyarrow stores its
Arrow schema in each footer.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, ROW_GROUP = 65_536, 16_384
CODECS = ("zstd", "lz4_raw", "gzip")


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


def main(argv) -> int:
    import pyarrow.parquet as pq

    out = argv[1] if len(argv) > 1 else os.path.join(REPO, "tests", "torch_data", "parquet")
    os.makedirs(out, exist_ok=True)
    table = arrow_table(*lineitem_rows())
    for codec in CODECS:
        path = os.path.join(out, f"lineitem_{ROWS}_{codec}.parquet")
        pq.write_table(table, path, compression=codec, row_group_size=ROW_GROUP)
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
