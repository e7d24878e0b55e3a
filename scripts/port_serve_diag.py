#!/usr/bin/env python3
"""The served aggregate lane of `chip_smoke.phase_serve` for one
checkout of the PyTorch/CUDA port, with host timers around the serving
path's functions.

    python3 scripts/port_serve_diag.py LABEL CHECKOUT VARIANT

On cuda:0, over `chip_smoke.lineitem_sf1`, a Server(workers=2,
window_s=0.01, megabatch_max=16) serves 8 closed-loop clients x 4
Q1-shaped queries (32 l_shipdate cutoffs): two warm-up rounds, then 4
measured rounds.  VARIANT `base` runs the checkout as it is;
`onestream` launches every served pass on the default stream,
`noshared` makes `exec/streams.shared` a no-op and `nofunnel` the
per-query telemetry funnel (diagnosis only: each takes one piece out).
Prints one `DIAG {...}` line: each round's q/s, p50 and p99, their
medians, the mean ms a call of each timed function, and the card.
Run checkouts in an interleaved order (A, B, B, A) to compare them.
"""
import json, os, sys, threading, time
label, checkout, variant = sys.argv[1], sys.argv[2], sys.argv[3]
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.abspath(checkout))
import numpy as np
import torch
import datafusion_tpu_torch as tdf
assert os.path.abspath(tdf.__file__).startswith(os.path.abspath(checkout))
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
from datafusion_tpu_torch import serve as S
from datafusion_tpu_torch.exec import materialize as M, context as C, batch as B
from datafusion_tpu_torch.obs import attribution as A
from datafusion_tpu_torch.utils import retry as R
acc, lock = {}, threading.Lock()
def wrap(obj, name, label_):
    fn = getattr(obj, name, None)
    if fn is None:
        return
    def w(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            d = time.perf_counter() - t0
            with lock:
                c = acc.setdefault(label_, [0, 0.0]); c[0] += 1; c[1] += d
    setattr(obj, name, w)
if variant == "onestream":
    import contextlib
    S.Server._device_scope = lambda self: torch.cuda.device(self.ctx.device)
if variant == "nofunnel" and hasattr(M, "_query_telemetry"):
    M._query_telemetry = lambda *a, **k: None
for o, n, l in [(S.Server, "_materialize", "materialize"), (S.Server, "_run_megabatch", "run_megabatch"),
                (S.Server, "_fulfill", "fulfill"), (S.Server, "_finish_together", "finish_together"),
                (M, "_query_telemetry", "funnel"), (C.ExecutionContext, "execute", "execute"),
                (A, "_settle", "settle"), (B, "device_pull", "device_pull")]:
    wrap(o, n, l)
try:
    from datafusion_tpu_torch.exec import streams as ST
    import datafusion_tpu_torch.exec.batch as _b, datafusion_tpu_torch.exec.aggregate as _a, datafusion_tpu_torch.exec.expression as _e
    if variant == "noshared":
        for m in (_b, _a, _e):
            m.shared = lambda v: v
    else:
        for m in (_b, _a, _e):
            wrap(m, "shared", "shared")
except ImportError:
    pass
src, cols, dates = cs.lineitem_sf1(tdf, 131072)
ctx = tdf.ExecutionContext(result_cache=False)
ctx.register_datasource("lineitem", src)
cutoffs = [dates[dates.index("1998-09-02") - 7 * i] for i in range(32)]
sqls = [cs.Q1.replace("1998-09-02", c) for c in cutoffs]
per_client = [sqls[4 * i:4 * i + 4] for i in range(8)]
srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=16)
rounds = []
try:
    cs._serve_clients(srv, per_client)
    cs._serve_clients(srv, per_client)
    acc.clear()
    for _ in range(4):
        served, lat, wall = cs._serve_clients(srv, per_client)
        rounds.append({"qps": len(sqls) / wall, "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99))})
finally:
    srv.stop()
print("DIAG " + json.dumps({"label": label, "variant": variant, "rounds": rounds,
      "qps_median": float(np.median([r["qps"] for r in rounds])),
      "p50_median": float(np.median([r["p50_ms"] for r in rounds])),
      "timers_ms_per_call": {k: [c, round(t / c * 1e3, 4)] for k, (c, t) in sorted(acc.items())},
      "card": cs.card()}), flush=True)
