#!/usr/bin/env python3
"""The serving front door's batching window under two kinds of traffic,
the port's policy against the JAX package's, round after round.

    python3 scripts/port_serve_rounds.py [--rounds 4] [--rates 20,100] [--open-queries 64]

On cuda:0, over `chip_smoke.py`'s SF-1 lineitem (6,000,000 rows in
memory), each round serves, under each policy in turn (the order
alternates from round to round), on a `Server(workers=2,
window_s=0.01, megabatch_max=16)`:

- closed loop: `chip_smoke.py`'s aggregate lane, 8 clients that each
  submit 4 Q1-shaped queries (32 l_shipdate cutoffs), each once the
  last has answered;
- open loop at each rate of `--rates` (queries/s): `--open-queries`
  arrivals, exponential gaps (seed 7), submitted whether or not earlier
  ones have answered, a mix of lanes: 3 of 4 a Q1-shaped aggregate (one
  of the 32 cutoffs), 1 of 8 a TopK (`LIMIT` 10, 100 or 1000), 1 of 8 a
  filter/project (one of 8 `l_discount` literals).

The policies:

- `port`: `serve.Server` as it is.  The window closes when it holds
  `megabatch_max` tickets, after `window_s` without an arrival, or
  `2 * window_s` after it opened; an aggregate megabatch's members are
  fulfilled together once every one has materialized.
- `jax`: the JAX package's policy (`datafusion_tpu/serve.py`
  `_enqueue`, `_run_group`), in a subclass here: the window closes
  `window_s` after its first arrival or when it holds `megabatch_max`
  tickets, and every ticket is fulfilled as soon as its own result is
  materialized.

A warm-up round under each policy pins the table and encodes first.
Every answer is checked against its solo answer, bit for bit.  Each
run prints a `ROUND {...}` line: policy, traffic, queries, grouped-
reduce launches, megabatches, queries/s, p50 and p99 client latency in
ms (host clock, submit to result), and the card's name and power
limit; then one `SUMMARY {...}` line with the median of each over the
rounds, per policy and traffic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from functools import partial


def _jax_policy_server(Server):
    class JaxWindowServer(Server):
        """The JAX package's fixed window and per-ticket finishing."""

        def _enqueue(self, t):
            self._window.append(t)
            if len(self._window) >= max(self._megabatch_max, 1):
                if self._window_timer is not None:
                    self._window_timer.cancel()
                self._flush_window()
                return
            if self._window_timer is None:
                self._window_timer = self._loop.call_later(self._window_s,
                                                           self._flush_window)

        def _finish_together(self, tickets):
            for t in tickets[1:]:
                self._loop.defer(partial(self._finish, t), self._group_done)
            if tickets:
                self._finish(tickets[0])

    return JaxWindowServer


def _open_loop(srv, sqls, gaps, timeout=600.0):
    """Submit `sqls[i]` at the cumulative `gaps` offsets from now, without
    waiting for answers.  Returns ({index: table}, latencies in ms, wall s)."""
    results, lat, errors = {}, [], []
    lock = threading.Lock()
    waiters = []

    def wait(i, ticket, t0):
        try:
            table = ticket.result(timeout=timeout)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                results[i] = table
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    start = time.perf_counter()
    at = start
    for i, (sql, gap) in enumerate(zip(sqls, gaps)):
        at += gap
        pause = at - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        t0 = time.perf_counter()
        th = threading.Thread(target=wait, args=(i, srv.submit(sql), t0))
        th.start()
        waiters.append(th)
    for th in waiters:
        th.join(timeout + 60)
    wall = time.perf_counter() - start
    if errors:
        raise errors[0]
    return results, lat, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--rates", default="20,100")
    ap.add_argument("--open-queries", type=int, default=64)
    args = ap.parse_args()
    root = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_serve_rounds: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.serve import Server
    from datafusion_tpu_torch.utils.metrics import METRICS

    smi = cs.phase_build(cuda_mod, torch)
    policies = {"port": Server, "jax": _jax_policy_server(Server)}
    ctx = tdf.ExecutionContext(result_cache=False)
    src, _, dates = cs.lineitem_sf1(tdf, ctx.batch_size)
    ctx.register_datasource("lineitem", src)
    cutoffs = [dates[dates.index("1998-09-02") - 7 * i] for i in range(32)]
    agg = [cs.Q1.replace("1998-09-02", c) for c in cutoffs]
    topk = [cs.SERVE_TOPK.format(k) for k in (10, 100, 1000)]
    pipe = [cs.SERVE_PIPELINE.format(f"{0.01 * i:.2f}") for i in range(8)]
    per_client = [agg[4 * i:4 * i + 4] for i in range(8)]
    solo = {sql: tdf.collect(ctx.sql(sql)) for sql in agg + topk + pipe}
    rng = np.random.default_rng(7)
    mixes = {}
    for rate in (float(r) for r in args.rates.split(",")):
        lanes = rng.choice(3, size=args.open_queries, p=[0.75, 0.125, 0.125])
        sqls = [agg[rng.integers(32)] if lane == 0 else
                topk[rng.integers(3)] if lane == 1 else pipe[rng.integers(8)]
                for lane in lanes]
        mixes[f"open {rate:g}/s mixed"] = (sqls, rng.exponential(1.0 / rate, len(sqls)))

    def check(sql, table):
        key_cols = 2 if sql in agg else 1
        cs.assert_same_bits(table, solo[sql], sql[-24:], key_cols=key_cols,
                            ordered=sql not in agg)

    servers = {}
    for name, cls in policies.items():
        servers[name] = cls(ctx, workers=2, window_s=0.01, megabatch_max=16).start()
    out = []
    try:
        for name in policies:
            cs._serve_clients(servers[name], per_client)  # pins, encodes
        for r in range(args.rounds):
            order = list(policies) if r % 2 == 0 else list(policies)[::-1]
            for name in order:
                srv = servers[name]
                traffics = [("closed 8x4 aggregate", None)] + list(mixes.items())
                for traffic, plan in traffics:
                    c0 = METRICS.snapshot()["counts"]
                    cuda_mod.reset_launch_counts()
                    if plan is None:
                        got, lat, wall = cs._serve_clients(srv, per_client)
                        n = len(agg)
                        for sql, table in got.items():
                            check(sql, table)
                    else:
                        sqls, gaps = plan
                        got, lat, wall = _open_loop(srv, sqls, gaps)
                        n = len(sqls)
                        for i, table in got.items():
                            check(sqls[i], table)
                    c1 = METRICS.snapshot()["counts"]
                    row = {
                        "round": r, "policy": name, "traffic": traffic, "queries": n,
                        "grouped_reduce_launches": cuda_mod.launch_counts()["hash_agg"],
                        "megabatches": c1.get("serve.megabatches", 0)
                        - c0.get("serve.megabatches", 0),
                        "queries_per_s": n / wall,
                        "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)), "card": smi}
                    print("ROUND " + json.dumps(row), flush=True)
                    out.append(row)
    finally:
        for srv in servers.values():
            srv.stop()
    summary = {}
    for row in out:
        summary.setdefault(f"{row['policy']} | {row['traffic']}", []).append(row)
    print("SUMMARY " + json.dumps({
        key: {m: float(np.median([r[m] for r in rows]))
              for m in ("queries_per_s", "p50_ms", "p99_ms", "grouped_reduce_launches",
                        "megabatches")}
        for key, rows in summary.items()} | {"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
