#!/usr/bin/env python3
"""Whether the TopK queries of `chip_smoke.py` slow down after the
high-cardinality join queries run in the same process.

    python3 scripts/port_phase_order.py [CHECKOUT]

In one process on cuda:0, with the checkout's own `chip_smoke.py`
phases: config 4's TopK phase twice, then TPC-H Q3 and Q10 at SF-1
(one warm run each, no profile), then the TopK phase three more times:
as it is, after `gc.collect()` and after `torch.cuda.empty_cache()`.
Prints one `TOPK {...}` line per pass: each query's warm p50 in ms, the
process's peak resident memory and the count of objects the garbage
collector tracks.

CHECKOUT is the root of a checkout that holds `chip_smoke.py` and
`datafusion_tpu_torch/` (default: this repository); its kernels build
there on first use.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod

    if not torch.cuda.is_available():
        print("port_phase_order: no CUDA device available", file=sys.stderr)
        return 1
    smi = cs.phase_build(cuda_mod, torch)
    ctx = tdf.ExecutionContext(result_cache=False)

    def topk(label):
        reps = cs.phase_topk(tdf, cuda_mod, torch, ctx, smi)
        print("TOPK " + json.dumps({
            "when": label, "p50": {r["query"]: r["p50_ms"] for r in reps},
            "maxrss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
            "gc_objects": len(gc.get_objects())}), flush=True)

    topk("first")
    topk("second")
    tables, cols = cs.star_sf1(tdf, ctx.batch_size)
    for name, src in tables.items():
        ctx.register_datasource(name, src)
    cs.WARM_RUNS = 1
    cs.query_profile = lambda *a, **k: None
    cs.phase_high_cardinality_joins(tdf, cuda_mod, torch, ctx, cols, smi)
    cs.WARM_RUNS = 3
    topk("after Q3 and Q10")
    gc.collect()
    topk("after gc.collect")
    torch.cuda.empty_cache()
    topk("after empty_cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
