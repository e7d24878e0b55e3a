#!/usr/bin/env python3
"""The staged prefetch against the serial path on warm in-memory scans
and on a cold CSV scan, and the TopK's batch-group fold against one
merge a batch.

    python3 scripts/port_prefetch_ab.py [ROUNDS]

In one process on cuda:0, over `chip_smoke.py`'s tables (the SF-1
lineitem, config 2 at 16 groups, config 4's TopK table), each query
runs once to warm, then ROUNDS rounds (default 9) in which every
variant runs it once, in turn:

- `serial`: DATAFUSION_TPU_PREFETCH=0, no prefetch threads (the default
  over these in-memory tables);
- `staged`: DATAFUSION_TPU_PREFETCH=1, two threads (`staged_pipeline`;
  the default over a CSV scan);
- `one_thread`: DATAFUSION_TPU_PREFETCH=1 with one prefetch thread that
  pulls and stages (`staged_prefetch` with the stage, in place of
  `staged_pipeline`);
- `staged_switch_500us`: `staged` with the interpreter's thread switch
  interval at 0.5 ms instead of 5 ms (`sys.setswitchinterval`), which
  tests whether the threads wait on the interpreter lock;
- for the TopK queries, `fuse_0`: DATAFUSION_TPU_FUSE=0, one merge a
  batch, against `serial` (the fold; both without the threads).

Then bench config 1 (`chip_smoke.py`'s 2,000,000-row cities CSV,
written under `build/chip_smoke/`) runs cold, a new context that parses
the file each run, `serial` and `staged` in turn for ROUNDS rounds.

Prints one `AB {...}` line per query: each variant's median and its
runs, in ms on the host clock ending in `torch.cuda.synchronize()`,
beside the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    root = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_prefetch_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import aggregate, prefetch, relation
    from datafusion_tpu_torch.exec import cuda as cuda_mod

    smi = cs.phase_build(cuda_mod, torch)
    ctx = tdf.ExecutionContext(result_cache=False)
    switch = sys.getswitchinterval()

    def one_thread(batches, stage, depth=prefetch._DEPTH, pull=None):
        def both(b):
            if pull is not None:
                pull(b)
            stage(b)
        return prefetch.staged_prefetch(batches, both, depth)

    def variant(name):
        """Set the process up for variant `name`; returns the undo."""
        if name == "serial":
            os.environ["DATAFUSION_TPU_PREFETCH"] = "0"
            return lambda: os.environ.pop("DATAFUSION_TPU_PREFETCH")
        if name == "fuse_0":
            os.environ["DATAFUSION_TPU_FUSE"] = "0"
            return lambda: os.environ.pop("DATAFUSION_TPU_FUSE")
        os.environ["DATAFUSION_TPU_PREFETCH"] = "1"
        if name == "one_thread":
            aggregate.staged_pipeline = relation.staged_pipeline = one_thread

            def undo():
                os.environ.pop("DATAFUSION_TPU_PREFETCH")
                aggregate.staged_pipeline = relation.staged_pipeline = \
                    prefetch.staged_pipeline
            return undo
        if name == "staged_switch_500us":
            sys.setswitchinterval(0.0005)

            def undo():
                os.environ.pop("DATAFUSION_TPU_PREFETCH")
                sys.setswitchinterval(switch)
            return undo
        return lambda: os.environ.pop("DATAFUSION_TPU_PREFETCH")

    def run(sql, on):
        t0 = time.perf_counter()
        tdf.collect(on.sql(sql))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def ab(sql, label, variants, context=lambda: ctx):
        """`sql` once to warm, then ROUNDS rounds of every variant, each
        run on the context `context()` gives (a new one for a cold
        scan)."""
        run(sql, context())
        times = {v: [] for v in variants}
        for _ in range(rounds):
            for v in variants:
                undo = variant(v)
                try:
                    times[v].append(run(sql, context()))
                finally:
                    undo()
        print("AB " + json.dumps({
            "query": label, "rounds": rounds, "card": smi,
            "median_ms": {v: float(np.median(t)) for v, t in times.items()},
            "runs_ms": times}), flush=True)

    prefetch_variants = ("serial", "staged", "one_thread", "staged_switch_500us")
    src, _, _ = cs.lineitem_sf1(tdf, ctx.batch_size)
    ctx.register_datasource("lineitem", src)
    ab(cs.Q1, "tpch_q1_sf1", prefetch_variants)
    ab(cs.SF1_FILTER_PROJECT, "lineitem_filter_project_sf1", prefetch_variants)
    del src
    src, _ = cs.groupby_table(tdf, 16)
    ctx.register_datasource("t", src)
    ab(cs.CONFIG2, "config2_groupby_16", prefetch_variants)
    src, c = cs.topk_table(tdf)
    ctx.register_datasource("t", src)
    for label, sql, _, _ in cs.topk_cases(c):
        if label in ("topk_s_desc", "topk_a_desc_b", "topk_nan_null"):
            ab(sql, label, ("fuse_0", "serial"))
    del src, c
    out_dir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"cities_{cs.CONFIG1_ROWS}.csv")
    cs.write_cities_csv(path, cs.CONFIG1_ROWS)
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("city", D.UTF8, False), tdf.Field("lat", D.FLOAT64, False),
                         tdf.Field("lng", D.FLOAT64, False)])

    def fresh():
        cold = tdf.ExecutionContext(batch_size=1 << 19, result_cache=False)
        cold.register_csv("cities", path, schema, has_header=True)
        return cold

    ab(cs.CITIES_SQL, "config1_csv_scan_filter_cold", ("serial", "staged"), fresh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
