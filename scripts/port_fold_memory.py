#!/usr/bin/env python3
"""Peak device memory of the batch-group fold against the per-batch path.

    python3 scripts/port_fold_memory.py [CHECKOUT]

In one process on cuda:0, with the checkout's own `chip_smoke.py`
tables: TPC-H Q1 and the SF-1 filter/project over the SF-1 lineitem,
then TPC-H Q3 over the SF-1 star schema.  Each query runs once cold,
then once warm with the fold (the default) and once warm under
DATAFUSION_TPU_FUSE=0 (one update a batch).  For each warm run:
`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()`
(`peak_mb`), the memory allocated when it starts (`start_mb`: the
tables' cached device copies) and its time on the host clock ending in
`torch.cuda.synchronize()`.  Both modes must return the same number of
rows.  Prints one `MEMORY {...}` line per query, beside the card's name
and power limit.

CHECKOUT is the root of a checkout that holds `chip_smoke.py` and
`datafusion_tpu_torch/` (default: this repository); its kernels build
there on first use.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("port_fold_memory: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod

    smi = cs.phase_build(cuda_mod, torch)
    ctx = tdf.ExecutionContext(result_cache=False)

    def warm(sql):
        start = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return table.num_rows, {"ms": ms, "start_mb": start,
                                "peak_mb": torch.cuda.max_memory_allocated() / 2**20}

    def measure(sql, label):
        tdf.collect(ctx.sql(sql))  # cold: device copies, kernel loads
        torch.cuda.synchronize()
        rows, fold = warm(sql)
        os.environ["DATAFUSION_TPU_FUSE"] = "0"
        try:
            rows0, per_batch = warm(sql)
        finally:
            del os.environ["DATAFUSION_TPU_FUSE"]
        if rows != rows0:
            raise AssertionError(f"{label}: {rows} rows with the fold, {rows0} without")
        print("MEMORY " + json.dumps({"query": label, "rows": rows, "fold": fold,
                                      "fuse_0": per_batch, "card": smi}), flush=True)

    src, _, _ = cs.lineitem_sf1(tdf, ctx.batch_size)
    ctx.register_datasource("lineitem", src)
    measure(cs.Q1, "tpch_q1_sf1")
    measure(cs.SF1_FILTER_PROJECT, "lineitem_filter_project_sf1")
    del src
    tables, _ = cs.star_sf1(tdf, ctx.batch_size)
    for name, table in tables.items():
        ctx.register_datasource(name, table)
    measure(cs.Q3, "tpch_q3_sf1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
