#!/usr/bin/env python3
"""`chip_smoke.py` with the learned grouped-reduce window's evidence
logged.

    python3 scripts/port_route_log.py

Runs `chip_smoke.main()` as it is, and prints a `ROUTE_OBS {...}` line
for every route observation the aggregate records
(`cost/advisor.observe_agg_route`: the route, the capacity, the passes'
device ms, the rows, s/row, the thread, whether a serving stream ran
it) with the window after it, and a `ROUTE_DIAG {...}` line with both
routes' history when a launch gate fails and at the end.  Its exit code
is the script's.
"""
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

from datafusion_tpu_torch import cost  # noqa: E402
from datafusion_tpu_torch.cost import advisor  # noqa: E402
from datafusion_tpu_torch.exec import streams  # noqa: E402

OBS: list = []
_observe = advisor.observe_agg_route
_expect = cs.expect_launches


def observe(store, route, cap, exec_s, rows):
    o = (round(time.time(), 3), route, cap, round(exec_s * 1e3, 4), rows,
         exec_s / rows if rows else None, threading.current_thread().name,
         streams.current() is not None)
    OBS.append(o)
    out = _observe(store, route, cap, exec_s, rows)
    print("ROUTE_OBS " + json.dumps({"o": o, "window": advisor.agg_window()}), flush=True)
    return out


def dump(tag):
    st = cost.store()
    print("ROUTE_DIAG " + json.dumps({
        "tag": tag, "window": advisor.agg_window(),
        "grouped_reduce": st.lookup(cost.CUDA_KEY, "agg:grouped_reduce"),
        "sortmerge": st.lookup(cost.CUDA_KEY, "agg:sortmerge"),
        "obs": OBS[-60:]}), flush=True)


def expect(rep, label, **want):
    try:
        return _expect(rep, label, **want)
    except AssertionError:
        dump("fail:" + label)
        raise


def main() -> int:
    os.chdir(HERE)
    advisor.observe_agg_route = observe
    cs.expect_launches = expect
    try:
        return cs.main()
    finally:
        dump("end")


if __name__ == "__main__":
    sys.exit(main())
