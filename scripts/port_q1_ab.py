#!/usr/bin/env python3
"""Warm p50 of TPC-H Q1 at SF-1 and of the config-2 GROUP BY (16
groups) through the PyTorch/CUDA port, for comparing two checkouts on
the same card.

    python3 scripts/port_q1_ab.py pairs PARENT CHANGE [--pairs 10] [--warm 15] [--out FILE]
    python3 scripts/port_q1_ab.py run CHECKOUT LABEL [--warm 15] [--profile]
    python3 scripts/port_q1_ab.py interleave LABEL=CHECKOUT ... [--rounds 60]

`pairs` runs `run` in a fresh process per turn, alternating the two
checkouts (parent, change, then change, parent, and so on), and prints
every turn's `AB {...}` line, then one `AB_SUMMARY {...}` line: the
median of each tree's per-process p50s, the per-pair differences
(change minus parent) and how many pairs had the change slower.
Turns that follow one another share the card, so a drift of the
host's load falls on both trees alike.

`run` builds the checkout's kernels, makes the data with the
checkout's own `chip_smoke.py` generators (lineitem at SF-1, seed 42;
config 2's table with 16 groups), runs each query once cold and
`--warm` times warm (each run ends in torch.cuda.synchronize()), and
prints `AB {...}` with the p50 and every warm run in ms.  The timing
loop is this script's, not the checkout's, so both trees are timed by
the same code.  `--profile` adds one more warm Q1 run under cProfile
and prints the host functions with the most time of their own, and the
cumulative time of the port's batch and materialization functions.

`interleave` loads every checkout into ONE process, each with its own
data, and alternates single warm runs between them (round i runs the
checkouts in the given order, round i+1 in reverse), so no process
boundary, heap or host-load drift sits between the compared runs.
Besides Q1 and config 2 it times a cold Q1 (`q1_cold`: new batch
objects around the same arrays each run, so every column is copied
again), the SF-1 filter/project over the same lineitem and config 4's
TopK `ORDER BY a DESC, b LIMIT 100` over 4,000,000 rows
(`chip_smoke.topk_table`).
Each checkout's modules are swapped into `sys.modules` before its run.
Prints one `INTERLEAVE {...}` line per query: every run, the median
and quartiles of each checkout, and, for each checkout after the
first, the per-round differences against the first and how many
rounds it was slower.

CHECKOUT is the root of a checkout that holds `chip_smoke.py` and
`datafusion_tpu_torch/`; its kernels build there on first use.
"""

import argparse
import json
import os
import subprocess
import sys
import time

TOPK_A_DESC_B = "SELECT a, b, x FROM t4 ORDER BY a DESC, b LIMIT 100"

# cumulative times reported by --profile: the functions a Q1 run goes
# through between the scan and the host result
PROFILED = ("collect_columns", "compact_batch", "device_inputs", "_group_ids",
            "batches", "to_host", "on_device", "to_device", "collect")


def _tree_modules():
    return {n: m for n, m in sys.modules.items()
            if n == "chip_smoke" or n.split(".")[0] == "datafusion_tpu_torch"}


def _load_tree(root, torch):
    """Import one checkout's `chip_smoke` and port package, build its
    kernels, register its tables and run each query once cold; returns
    (its modules, its context, its package)."""
    for name in _tree_modules():
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
        import datafusion_tpu_torch as tdf
        from datafusion_tpu_torch.exec import cuda as cuda_mod

        for mod in (cs, tdf):
            if not mod.__file__.startswith(root):
                raise RuntimeError(f"imported {mod.__file__}, not the one under {root}")
        cwd = os.getcwd()
        os.chdir(root)
        try:
            cuda_mod.build_all()
        finally:
            os.chdir(cwd)
        cs.log = lambda *a: None
        ctx = tdf.ExecutionContext(result_cache=False)
        src, _, _ = cs.lineitem_sf1(tdf, ctx.batch_size)
        ctx.register_datasource("lineitem", src)
        ctx.cold_lineitem = src
        src, _ = cs.groupby_table(tdf, 16)
        ctx.register_datasource("t", src)
        src, _ = cs.topk_table(tdf)
        ctx.register_datasource("t4", src)
        for sql in (cs.Q1, cs.CONFIG2, cs.SF1_FILTER_PROJECT, TOPK_A_DESC_B):
            tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        return _tree_modules(), ctx, tdf, cs
    finally:
        sys.path.remove(root)


def interleave(specs, rounds):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_q1_ab: no CUDA device available", file=sys.stderr)
        return 1
    trees = []
    for spec in specs:
        label, root = spec.split("=", 1)
        mods, ctx, tdf, cs = _load_tree(os.path.abspath(root), torch)
        trees.append((label, mods, ctx, tdf))
    queries = {"q1": cs.Q1, "q1_cold": cs.Q1, "config2_16": cs.CONFIG2,
               "filter_project_sf1": cs.SF1_FILTER_PROJECT, "topk_a_desc_b": TOPK_A_DESC_B}
    for qname, sql in queries.items():
        times = {label: [] for label, *_ in trees}
        for i in range(rounds):
            for label, mods, ctx, tdf in (trees if i % 2 == 0 else trees[::-1]):
                sys.modules.update(mods)
                run_ctx = _cold_context(tdf, mods, ctx) if qname == "q1_cold" else ctx
                t0 = time.perf_counter()
                tdf.collect(run_ctx.sql(sql))
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
        first = trees[0][0]
        out = {"query": qname, "rounds": rounds,
               "device": torch.cuda.get_device_name(0), "ms": times}
        for label, t in times.items():
            out[label] = {"median": _median(t),
                          "q25_q75": [float(q) for q in np.percentile(t, [25, 75])]}
            if label != first:
                diff = [b - a for a, b in zip(times[first], t)]
                out[label].update(diff_vs_first_median=_median(diff),
                                  rounds_slower=sum(d > 0 for d in diff))
        print("INTERLEAVE " + json.dumps(out), flush=True)
    return 0


def _cold_context(tdf, mods, ctx):
    """A context over new batch objects around the arrays of `ctx`'s
    lineitem: nothing is cached on them, so a run copies every column
    again."""
    record_batch = mods["datafusion_tpu_torch.exec.batch"].RecordBatch
    src = ctx.cold_lineitem
    cold = tdf.ExecutionContext(result_cache=False)
    cold.register_datasource("lineitem", tdf.MemoryDataSource(src.schema, [
        record_batch(b.schema, list(b.data), list(b.validity), list(b.dicts),
                     num_rows=b.num_rows)
        for b in src.batches()]))
    return cold


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _timed_runs(tdf, torch, ctx, sql, warm):
    t0 = time.perf_counter()
    tdf.collect(ctx.sql(sql))
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return cold, _median(times), times


def _profile_q1(tdf, torch, ctx, sql):
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(lambda: (tdf.collect(ctx.sql(sql)), torch.cuda.synchronize()))
    stats = pstats.Stats(prof).stats
    rows = sorted(
        ((f"{os.path.basename(fn)}:{name}", tt * 1e3, ct * 1e3, nc)
         for (fn, _, name), (_, nc, tt, ct, _) in stats.items()),
        key=lambda t: -t[1],
    )
    top = [{"fn": f[:70], "self_ms": s, "calls": n} for f, s, _, n in rows[:12]]
    cum = {f: c for f, _, c, _ in rows if f.split(":")[-1] in PROFILED}
    return {"top_self": top, "cumulative_ms": cum}


def run(root, label, warm, profile):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("port_q1_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod

    for mod in (cs, tdf):
        if not mod.__file__.startswith(root):
            raise RuntimeError(f"imported {mod.__file__}, not the one under {root}")
    cuda_mod.build_all()
    cs.log = lambda *a: None
    ctx = tdf.ExecutionContext(result_cache=False)
    src, _, _ = cs.lineitem_sf1(tdf, ctx.batch_size)
    ctx.register_datasource("lineitem", src)
    out = {"tree": label, "device": torch.cuda.get_device_name(0)}
    cold, p50, times = _timed_runs(tdf, torch, ctx, cs.Q1, warm)
    out.update(q1_cold_ms=cold, q1_p50_ms=p50, q1_warm_ms=times)
    if profile:
        out["q1_profile"] = _profile_q1(tdf, torch, ctx, cs.Q1)
    src, _ = cs.groupby_table(tdf, 16)
    ctx.register_datasource("t", src)
    cold, p50, times = _timed_runs(tdf, torch, ctx, cs.CONFIG2, warm)
    out.update(config2_16_cold_ms=cold, config2_16_p50_ms=p50, config2_16_warm_ms=times)
    print("AB " + json.dumps(out), flush=True)
    return 0


def pairs(parent, change, n_pairs, warm, out_path):
    results = {"parent": [], "change": []}
    sink = open(out_path, "w") if out_path else None
    for i in range(n_pairs):
        order = (("parent", parent), ("change", change))
        if i % 2:
            order = order[::-1]
        for label, root in order:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "run", root, label,
                 "--warm", str(warm)],
                capture_output=True, text=True,
            )
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")), None)
            if proc.returncode != 0 or line is None:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"turn {label} of pair {i} failed (rc {proc.returncode})")
            rec = json.loads(line[3:])
            rec["pair"], rec["process_s"] = i, time.perf_counter() - t0
            results[label].append(rec)
            print("AB " + json.dumps(rec), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
    summary = {}
    for metric in ("q1_p50_ms", "config2_16_p50_ms"):
        p = [r[metric] for r in results["parent"]]
        c = [r[metric] for r in results["change"]]
        diff = [b - a for a, b in zip(p, c)]
        summary[metric] = {
            "parent_median": _median(p), "change_median": _median(c),
            "parent_min": min(p), "parent_max": max(p),
            "change_min": min(c), "change_max": max(c),
            "pair_diff_median": _median(diff), "pair_diffs": diff,
            "pairs_change_slower": sum(d > 0 for d in diff), "pairs": len(diff),
        }
    print("AB_SUMMARY " + json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps({"summary": summary}) + "\n")
        sink.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("checkout")
    r.add_argument("label")
    r.add_argument("--warm", type=int, default=15)
    r.add_argument("--profile", action="store_true")
    p = sub.add_parser("pairs")
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--warm", type=int, default=15)
    p.add_argument("--out")
    il = sub.add_parser("interleave")
    il.add_argument("trees", nargs="+", help="LABEL=CHECKOUT, the reference first")
    il.add_argument("--rounds", type=int, default=60)
    a = ap.parse_args()
    if a.cmd == "interleave":
        return interleave(a.trees, a.rounds)
    if a.cmd == "run":
        return run(a.checkout, a.label, a.warm, a.profile)
    return pairs(a.parent, a.change, a.pairs, a.warm, a.out)


if __name__ == "__main__":
    sys.exit(main())
