#!/usr/bin/env python3
"""What the observability seams cost a query with tracing off: TPC-H Q1
under DATAFUSION_TPU_FUSE=0 (one pass a batch, so every pass seam, copy
seam and operator seam runs once a batch) through two checkouts of the
port, interleaved in one process.

    python3 scripts/port_obs_overhead.py PARENT CHANGE [--device cpu]
        [--rows 1000000] [--batch 16384] [--rounds 21]

Each checkout's `chip_smoke.py` generates its lineitem (seed 42, cut to
`--rows`), and each checkout's modules are swapped into `sys.modules`
before its run (as `scripts/port_q1_ab.py interleave` does).  Round i
runs the checkouts in the given order, round i + 1 in reverse; each run
is one warm Q1 (ending in `torch.cuda.synchronize()` on a card).  Prints
one `OVERHEAD {...}` line: every run, each checkout's median and
quartiles, the per-round differences (CHANGE minus PARENT) and how many
rounds CHANGE was slower.  Without `--device` it runs on cuda:0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _tree_modules():
    return {n: m for n, m in sys.modules.items()
            if n == "chip_smoke" or n.split(".")[0] == "datafusion_tpu_torch"}


def _load(root, device, rows, batch):
    for name in _tree_modules():
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
        import datafusion_tpu_torch as tdf

        for mod in (cs, tdf):
            if not mod.__file__.startswith(root):
                raise RuntimeError(f"imported {mod.__file__}, not the one under {root}")
        cs.SF1_ROWS = rows
        ctx = tdf.ExecutionContext(device=device, batch_size=batch)
        src, _, _ = cs.lineitem_sf1(tdf, batch)
        ctx.register_datasource("lineitem", src)
        tdf.collect(ctx.sql(cs.Q1))  # cold: copies cached on the batches
        return _tree_modules(), ctx, tdf, cs.Q1
    finally:
        sys.path.remove(root)


def _quartiles(xs):
    import numpy as np

    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(q2), "q1": float(q1), "q3": float(q3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--device", default=None)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--rounds", type=int, default=21)
    args = ap.parse_args()
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("port_obs_overhead: no CUDA device available", file=sys.stderr)
        return 1
    os.environ["DATAFUSION_TPU_FUSE"] = "0"
    trees = []
    for label, root in (("parent", args.parent), ("change", args.change)):
        mods, ctx, tdf, sql = _load(os.path.abspath(root), args.device, args.rows, args.batch)
        trees.append((label, mods, ctx, tdf, sql))
    sync = torch.cuda.synchronize if args.device is None else (lambda: None)
    times = {label: [] for label, *_ in trees}
    for r in range(args.rounds):
        for label, mods, ctx, tdf, sql in (trees if r % 2 == 0 else trees[::-1]):
            sys.modules.update(mods)
            t0 = time.perf_counter()
            tdf.collect(ctx.sql(sql))
            sync()
            times[label].append((time.perf_counter() - t0) * 1e3)
    diffs = [c - p for p, c in zip(times["parent"], times["change"])]
    device = torch.cuda.get_device_name(0) if args.device is None else args.device
    print("OVERHEAD " + json.dumps({
        "query": "tpch_q1", "fuse": 0, "rows": args.rows, "batch": args.batch,
        "device": device, "ms": times,
        **{label: _quartiles(v) for label, v in times.items()},
        "round_diffs_ms": diffs, "rounds_change_slower": sum(d > 0 for d in diffs),
        "rounds": len(diffs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
