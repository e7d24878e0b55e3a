#!/usr/bin/env python3
"""Float32 SUM and AVG against an f64 oracle, in the port and (where it
imports) the JAX package.

    python3 scripts/port_f32_sum.py [--device cpu] [--rows N] [--groups G]

Both packages accumulate an f32 SUM in f32, each in its own order (the
port's batch-group fold sums a group of batches in one grouped-reduce
call; under DATAFUSION_TPU_FUSE=0 one call a batch; the JAX package
scans its batches).  In any order, each of n summands passes through
at most n - 1 roundings at unit roundoff u = eps / 2 (eps = 2^-23,
f32's epsilon).  The worst case, (n - 1) * u * sum|x|, is too loose to
tell a lost batch from a right sum at a million rows.  The stated bound
is the probabilistic one of Higham and Mary ("A new approach to
probabilistic rounding error analysis", SIAM J. Sci. Comput. 41(5),
2019): with rounding errors independent and of mean zero, the error
stays within lambda * sqrt(n) * u * sum|x| with probability at least
1 - 2n * exp(-lambda^2 / 2).  With lambda = 10 (a miss below 1e-15 at a
million rows) and u * |S| more for rounding the result to f32, for
each group g of n_g rows

    |SUM_f32 - SUM_f64| <= (5 * sqrt(n_g) + 1/2) * eps * sum_g |x|,

and AVG = SUM / n_g errs by at most that bound over n_g (the division
is in f64).  The script runs `SELECT k, SUM(x), AVG(x), COUNT(x) FROM t
GROUP BY k` over N seeded rows (f32 values, G groups, NULLs in one row
of 16, batches of 4096) and prints one JSON line: per package and fold
mode, the largest error of a group divided by its bound (`sum_ratio`,
`avg_ratio`, each must stay <= 1) and the largest relative error.  It
also runs the port once more with a planted fault, the first batch's
values zeroed (COUNT unchanged, SUM one batch short), and prints the
smallest ratio of a group (`lost_batch_min_ratio`, which must exceed
1: the bound catches the fault in every group).
Without `--device` the port runs on cuda:0 (the card; the JAX package
is not run there), with `--device cpu` on the CPU beside the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)  # 2^-23
LAMBDA = 10.0
BATCH = 4096


def bound(n: int, abs_sum: float) -> float:
    """The stated bound of one group's f32 SUM error (module docstring):
    lambda * sqrt(n) * u * sum|x| plus u * sum|x| for the result's
    rounding, u = eps / 2."""
    return (LAMBDA * math.sqrt(n) + 1.0) * (EPS32 / 2) * abs_sum


def table(rows: int, groups: int, seed: int = 11):
    """(keys, f32 values, validity) of the measured table."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, rows).astype(np.int64)
    vals = (rng.normal(100.0, 400.0, rows) * rng.choice([1.0, 1e-3, 1e3], rows)).astype(np.float32)
    valid = rng.integers(0, 16, rows) != 0
    return keys, vals, valid


def lose_first_batch(vals):
    """The planted fault: the first batch's values zeroed, so COUNT is
    unchanged and SUM misses that batch."""
    out = vals.copy()
    out[:BATCH] = 0
    return out


def oracle(keys, vals, valid):
    """{key: (f64 sum, n, sum |x|)} over the valid rows."""
    out = {}
    for k in np.unique(keys):
        m = (keys == k) & valid
        v = vals[m].astype(np.float64)
        out[int(k)] = (float(v.sum()), int(m.sum()), float(np.abs(v).sum()))
    return out


def ratios(rows, want) -> dict:
    """The largest and the smallest error / bound of SUM over the
    groups, the largest of AVG, and the largest relative error of SUM."""
    def err(x):  # a NaN or an infinity is an error beyond any bound
        return x if math.isfinite(x) else math.inf

    sum_r = avg_r = rel = 0.0
    min_r = math.inf
    for k, s, a, c in rows:
        exact, n, abs_sum = want[int(k)]
        if c != n:
            raise AssertionError(f"group {k}: COUNT {c}, oracle {n}")
        b = bound(n, abs_sum)
        r = err(abs(float(s) - exact) / b)
        sum_r, min_r = max(sum_r, r), min(min_r, r)
        avg_r = max(avg_r, err(abs(float(a) - exact / n) / (b / n)))
        rel = max(rel, err(abs(float(s) - exact) / max(abs(exact), 1e-300)))
    return {"sum_ratio": sum_r, "min_sum_ratio": min_r, "avg_ratio": avg_r,
            "max_rel_err": rel}


SQL = "SELECT k, SUM(x), AVG(x), COUNT(x) FROM t GROUP BY k"


def run_port(device, keys, vals, valid):
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.datatypes import DataType, Field, Schema
    from datafusion_tpu_torch.exec.batch import make_host_batch
    from datafusion_tpu_torch.exec.datasource import MemoryDataSource

    schema = Schema([Field("k", DataType.INT64, False), Field("x", DataType.FLOAT32, True)])
    batches = [make_host_batch(schema, [keys[i:i + BATCH], vals[i:i + BATCH]],
                               [None, valid[i:i + BATCH]])
               for i in range(0, len(keys), BATCH)]
    ctx = tdf.ExecutionContext(device=device, batch_size=BATCH)
    ctx.register_datasource("t", MemoryDataSource(schema, batches))
    return ctx.sql_collect(SQL).to_rows()


def run_jax(keys, vals, valid):
    import datafusion_tpu as jdf
    from datafusion_tpu.exec.batch import make_host_batch
    from datafusion_tpu.exec.datasource import MemoryDataSource

    schema = jdf.Schema([jdf.Field("k", jdf.DataType.INT64, False),
                         jdf.Field("x", jdf.DataType.FLOAT32, True)])
    batches = [make_host_batch(schema, [keys[i:i + BATCH], vals[i:i + BATCH]],
                               [None, valid[i:i + BATCH]])
               for i in range(0, len(keys), BATCH)]
    ctx = jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=BATCH)
    ctx.register_datasource("t", MemoryDataSource(schema, batches))
    return ctx.sql_collect(SQL).to_rows()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--groups", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import torch

    keys, vals, valid = table(args.rows, args.groups)
    want = oracle(keys, vals, valid)
    out = {"rows": args.rows, "groups": args.groups, "eps": EPS32}
    if args.device is None:
        if not torch.cuda.is_available():
            print("port_f32_sum: no CUDA device available", file=sys.stderr)
            return 1
        out["device"] = torch.cuda.get_device_name(0)
    else:
        out["device"] = args.device
    for mode in ("1", "0"):
        os.environ["DATAFUSION_TPU_FUSE"] = mode
        out[f"port_fuse{mode}"] = ratios(run_port(args.device, keys, vals, valid), want)
        if args.device == "cpu":
            os.environ.setdefault("JAX_PLATFORMS", "cpu")
            out[f"jax_fuse{mode}"] = ratios(run_jax(keys, vals, valid), want)
    lost = run_port(args.device, keys, lose_first_batch(vals), valid)
    out["lost_batch_min_ratio"] = ratios(lost, want)["min_sum_ratio"]
    print(json.dumps(out))
    bad = [k for k, v in out.items() if isinstance(v, dict)
           and max(v["sum_ratio"], v["avg_ratio"]) > 1.0]
    return 1 if bad or not out["lost_batch_min_ratio"] > 1.0 else 0


if __name__ == "__main__":
    sys.exit(main())
