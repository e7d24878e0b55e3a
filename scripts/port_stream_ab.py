#!/usr/bin/env python3
"""Tenant A's metered device time a query, alone and under tenant B's
cold scans, for each of several checkouts of the PyTorch/CUDA port on
one card (the stream round of `chip_smoke.phase_fleet`); or, with
`--round serve`, the served lanes of `chip_smoke.phase_serve`.

    python3 scripts/port_stream_ab.py [--round stream|serve] LABEL=CHECKOUT [...]

Each checkout runs in a process of its own, in the order given:
`chip_smoke.stream_round` (this tree's copy, so every checkout is
measured by the same code) over the SF-1 lineitem of
`chip_smoke.lineitem_sf1`, with the checkout's `datafusion_tpu_torch`
first on the import path.  A Server(shares={"A": 3, "B": 1},
workers=2) runs A's warm Q1 round over a resident copy of the table,
once alone and once while B sends cold Q1 scans back to back; where
both workers launch on one stream (before each serving worker had its
own), the event pair that meters an A pass also times B's copies and
kernels enqueued inside it.  Prints one `STREAM {...}` line per
checkout: A's metered ms a query alone and under B, their ratio, B's
ms a query, both tenants' metered seconds against the round's
`device.dispatch` and the profiler's device time, the streams the
served passes recorded their event pairs on (`pass_streams`), and the
card.  `--round serve` runs `chip_smoke.phase_serve` (this tree's copy,
with its own gates) in the same way and prints one `SERVE {...}` line
per lane and checkout: the aggregate lane's served q/s, p50 and p99
for 8 closed-loop clients over the resident table, the TopK and
pipeline lanes' p50 and wall, and their launches.  Name the checkouts
in an interleaved order (A, B, B, A) to compare two.  It gates nothing
of its own: the gates are `chip_smoke.py`'s.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(label: str, checkout: str, round_: str) -> int:
    sys.path.insert(0, os.path.abspath(checkout))
    import importlib.util

    import torch

    import datafusion_tpu_torch as tdf

    if not os.path.abspath(tdf.__file__).startswith(os.path.abspath(checkout)):
        raise SystemExit(f"{label}: imported {tdf.__file__}, not {checkout}'s package")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src, cols, dates = cs.lineitem_sf1(tdf, 131072)
    if round_ == "serve":
        from datafusion_tpu_torch.exec import cuda as cuda_mod
        from datafusion_tpu_torch.exec.cuda import hash_agg

        for rep in cs.phase_serve(tdf, cuda_mod, torch, hash_agg, src, cols, dates,
                                  cs.card()):
            print("SERVE " + json.dumps({"label": label, "checkout": checkout, **rep}),
                  flush=True)
        return 0
    out = cs.stream_round(tdf, torch, src, cols, dates)
    out = {"label": label, "checkout": checkout, **out, "card": cs.card()}
    print("STREAM " + json.dumps(out), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":
        return one(argv[1], argv[2], argv[3])
    round_ = "stream"
    if argv[:1] == ["--round"] and len(argv) > 1:
        round_, argv = argv[1], argv[2:]
    if round_ not in ("stream", "serve"):
        print(__doc__, file=sys.stderr)
        return 2
    if not argv or not all("=" in a for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("port_stream_ab: no CUDA device available", file=sys.stderr)
        return 1
    rc = 0
    for arg in argv:
        label, _, checkout = arg.partition("=")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", label,
                              checkout, round_], cwd=HERE)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
