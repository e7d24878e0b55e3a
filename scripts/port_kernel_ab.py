#!/usr/bin/env python3
"""The grouped reduce's times at the main path's shapes in two or more
checkouts, on the same card, in turns.

    python3 scripts/port_kernel_ab.py CHECKOUT [CHECKOUT ...] [--turns 2]
        [--phase kernel|query_axis]

Each turn runs every checkout once, each in a fresh process (the order
reverses from turn to turn: A B, B A, ...).  A process builds the
checkout's kernels from its own sources and runs the checkout's own
`chip_smoke.phase_kernel_timing` on cuda:0: `hash_agg.grouped_reduce`
at Q1's and config 2's shapes (a batch and a batch group, f64 sum), per
call (CUDA events) and on the device (`torch.profiler`), beside the
plain version and the library calls.  With `--phase query_axis` it runs
the checkout's `chip_smoke.phase_query_axis` instead (the query axis's
parity, then its shapes; shapes only one checkout has are summarised
for it alone).  Prints one `KERNEL_AB {...}` line
per process (checkout, turn, and per shape `ms` and `device_ms`), then
one `KERNEL_AB_SUMMARY {...}` line: per shape and checkout the median of
each over the turns, with the card's name and power limit.

CHECKOUT is the root of a checkout that holds `chip_smoke.py` and
`datafusion_tpu_torch/`; its kernels build there on first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _run(root: str, phase: str) -> int:
    """In this process: time the checkout at `root`."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.exec.cuda import hash_agg

    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    cuda_mod.load("hash_agg")
    dev = torch.device("cuda:0")
    if phase == "query_axis":
        _, entries = cs.phase_query_axis(torch, hash_agg, dev)
    else:
        entries = cs.phase_kernel_timing(torch, hash_agg, cuda_mod, dev)
    print("KERNEL_SHAPES " + json.dumps([
        {"shape": e["shape"], "ms": e["ms"], "device_ms": e["device_ms"]} for e in entries]),
        flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--phase", choices=("kernel", "query_axis"), default="kernel")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return _run(os.path.abspath(args.run), args.phase)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    rows = []
    for turn in range(args.turns):
        order = args.checkouts if turn % 2 == 0 else args.checkouts[::-1]
        for root in order:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), root,
                                   "--run", root, "--phase", args.phase],
                                  capture_output=True, text=True, timeout=1200)
            line = next((ln for ln in proc.stdout.splitlines()
                         if ln.startswith("KERNEL_SHAPES ")), None)
            if proc.returncode != 0 or line is None:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"port_kernel_ab: {root} failed ({proc.returncode})")
            shapes = json.loads(line[len("KERNEL_SHAPES "):])
            row = {"checkout": root, "turn": turn, "shapes": shapes, "card": smi}
            print("KERNEL_AB " + json.dumps(row), flush=True)
            rows.append(row)
    summary: dict = {}
    for row in rows:
        for e in row["shapes"]:
            per = summary.setdefault(e["shape"], {}).setdefault(row["checkout"], {
                "ms": [], "device_ms": []})
            per["ms"].append(e["ms"])
            per["device_ms"].append(e["device_ms"])

    def median(xs):
        xs = sorted(x for x in xs if x is not None)
        if not xs:
            return None
        mid = len(xs) // 2
        return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2

    print("KERNEL_AB_SUMMARY " + json.dumps({
        shape: {root: {k: median(v) for k, v in per.items()} for root, per in by.items()}
        for shape, by in summary.items()} | {"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
