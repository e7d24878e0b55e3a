#!/usr/bin/env python3
"""Does the cooperative grouped reduce's wait for full residency land in
a served pass's billed time?  (The meter's host gate, exec/gate.py.)

    python3 scripts/port_gate_residency.py [--rows N] [--groups G] [--turns T]

On one card: a served pass (one `device_call` under a charge scope, on a
serving worker's stream, so gated) that runs one grouped reduce
(`csrc/hash_agg.cu`, one cooperative launch: every block resident at
once) over N rows into G groups, metered alone; then the same pass
enqueued while another stream runs a blocker (a float32 matrix product
of about 10 ms that holds the SMs).  The cooperative launch cannot start
until the blocker's blocks drain, so if that wait lands in the pass's
event pair, its billed time under the blocker reads near the blocker's
remaining time rather than near the reduce alone.  Prints one `GATE
{...}` line a turn (billed ms alone and under the blocker, the
blocker's own ms, the reduce's kernel ms from CUDA events outside any
scope) and the card's name and power limit.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=6_029_312)  # Q1's 46 batches in one group
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_gate_residency: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from datafusion_tpu_torch.exec import streams
    from datafusion_tpu_torch.exec.cuda import hash_agg
    from datafusion_tpu_torch.obs import attribution
    from datafusion_tpu_torch.utils.metrics import METRICS
    from datafusion_tpu_torch.utils.retry import device_call

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ids = torch.randint(0, args.groups, (args.rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.rand(args.rows, generator=gen, device=dev, dtype=torch.float64)
    live = torch.ones(args.rows, dtype=torch.bool, device=dev)
    a = torch.rand(6144, 6144, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    blocker_stream = torch.cuda.Stream(device=dev)

    def reduce():
        return hash_agg.grouped_reduce(ids, vals, live, args.groups, "sum")

    def event_ms(fn, stream=None):
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            s0.record()
            fn()
            s1.record()
        torch.cuda.synchronize()
        return s0.elapsed_time(s1)

    out: dict = {}

    def served(blocked: bool):
        with streams.serving_scope(dev):
            reduce()
            torch.cuda.synchronize()
            if blocked:
                with torch.cuda.stream(blocker_stream):
                    a @ a
            with attribution.client_scope("gate-residency") as acc:
                device_call(reduce, _tag="residency", _device=dev)
            torch.cuda.synchronize()
        out["billed_ms"] = acc[0] * 1e3

    def run(blocked: bool) -> float:
        th = threading.Thread(target=served, args=(blocked,))
        th.start()
        th.join(timeout=120)
        if th.is_alive():
            raise SystemExit("a gated pass did not return")
        return out["billed_ms"]

    a @ a
    reduce()
    torch.cuda.synchronize()
    forced0 = METRICS.counts.get("meter.gate_forced", 0)
    for turn in range(args.turns):
        rep = {"turn": turn, "rows": args.rows, "groups": args.groups,
               "reduce_kernel_ms": event_ms(reduce),
               "blocker_ms": event_ms(lambda: a @ a, blocker_stream),
               "billed_ms_alone": run(False), "billed_ms_under_blocker": run(True),
               "gate_forced": METRICS.counts.get("meter.gate_forced", 0) - forced0}
        print("GATE " + json.dumps(rep), flush=True)
    print(_card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
