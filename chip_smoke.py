#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

No setup step: the CUDA kernels build from the checkout's sources on
first use.  Phases, each of which raises on failure:

1. Build and device: nvcc build seconds, the card's name and power
   limit.
2. The grouped-reduce kernel against its plain PyTorch version on the
   card, for every (kind, dtype) the aggregate sends, at N = 131,072,
   524,288 and 6,000,000 rows and G in {4, 8, 16, 4096, 8192} groups
   (Q1's batches have 131,072 rows and 8 group slots, config 2's
   524,288 rows and 16 or 4096 slots), with dead rows,
   out-of-range ids and NaNs.  Ints exactly, f64 within rtol 1e-12, and
   every f64 result bit-identical when run twice.  Then kernel, plain
   and library (`scatter_reduce_`) times at the main path's shapes.
3. TPC-H Q1 over lineitem at SF-1 (6,000,000 rows, generated with the
   distributions of benchmarks/data.py, seed 42) on cuda:0, checked
   against a numpy oracle: keys and counts exactly, floats within rtol
   1e-9.  p50 over 5 warm runs.
4. The GROUP BY of bench config 2 over 4,000,000 rows with 16 and with
   4096 groups, checked the same way.

The main path (phases 3 and 4) runs with the launch counters set to 0
just before each query and read just after; each query must have
launched the kernel.  The second-to-last lines are the `kernels` JSON
object and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or without the package beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

Q1 = (
    "SELECT l_returnflag, l_linestatus, "
    "SUM(l_quantity), SUM(l_extendedprice), "
    "SUM(l_extendedprice * (1 - l_discount)), "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(1) "
    "FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus"
)
CONFIG2 = "SELECT k, SUM(v1), AVG(v2), MIN(v3), MAX(v3), COUNT(1) FROM t GROUP BY k"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F64_OPS_PER_S = 34e12  # H100 SXM, FP64 outside the tensor cores (data sheet)
WARM_RUNS = 5
TIMED_LAUNCHES = 200
SF1_ROWS = 6_000_000
CONFIG2_ROWS = 4_000_000


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ phase 1


def phase_build(cuda_mod, torch):
    secs = cuda_mod.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"build: {secs:.2f} s (nvcc, sm_90a)")
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")
    return smi


# ------------------------------------------------------------ phase 2

CASES = [("sum", "int64"), ("sum", "float64"), ("min", "float64"),
         ("max", "float64"), ("min", "int64"), ("max", "int64"),
         ("min", "int32"), ("max", "int32")]


def _case_inputs(torch, kind, dtype, n, g, gen, dev):
    ids = torch.randint(-2, g + 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    live = torch.rand(n, generator=gen, device=dev) > 0.1
    td = getattr(torch, dtype)
    if td.is_floating_point:
        # positive sums: no cancellation, so rtol bounds the order error
        lo = 0.0 if kind == "sum" else -1e3
        vals = (torch.rand(n, generator=gen, device=dev, dtype=td) * (1e3 - lo) + lo)
        vals[torch.rand(n, generator=gen, device=dev) < 1e-5] = float("nan")
    else:
        info = torch.iinfo(td)
        vals = torch.randint(info.min, info.max, (n,), generator=gen,
                             device=dev, dtype=td)
    return ids, vals, live


def phase_kernel_parity(torch, hash_agg, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    max_abs_err = 0.0
    checked = 0
    for n in (131_072, 524_288, 6_000_000):
        for g in (4, 8, 16, 4096, 8192):
            for kind, dtype in CASES:
                ids, vals, live = _case_inputs(torch, kind, dtype, n, g, gen, dev)
                got = hash_agg.grouped_reduce(ids, vals, live, g, kind)
                torch.cuda.synchronize()
                want = hash_agg.grouped_reduce_torch(ids, vals, live, g, kind)
                label = f"{kind}/{dtype} N={n} G={g}"
                if vals.dtype.is_floating_point:
                    torch.testing.assert_close(got, want, rtol=1e-12, atol=0,
                                               equal_nan=True, msg=label)
                    fin = torch.isfinite(want)
                    if fin.any():
                        err = (got[fin] - want[fin]).abs().max().item()
                        max_abs_err = max(max_abs_err, err)
                    again = hash_agg.grouped_reduce(ids, vals, live, g, kind)
                    if not torch.equal(got.view(torch.int64), again.view(torch.int64)):
                        raise AssertionError(f"{label}: f64 result not bit-identical on rerun")
                else:
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label}: ints differ")
                checked += 1
    torch.cuda.synchronize()
    log(f"kernel parity: {checked} cases ok (ints exact, f64 rtol 1e-12, "
        f"f64 bitwise on rerun), max_abs_err {max_abs_err!r}")
    return max_abs_err


def _time_ms(torch, fn, reps=TIMED_LAUNCHES):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps=50):
    """Device time per call of the kernel's own CUDA kernels, from the
    profiler; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.device_time_total for e in prof.key_averages()
        if "partial_kernel" in e.key or "combine_kernel" in e.key
    )
    return us / reps / 1e3 if us > 0 else None


def phase_kernel_timing(torch, hash_agg, dev):
    """Kernel, plain and library times at the main path's shapes, f64
    sum (the slot Q1 and config 2 reduce most)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    out = []
    for n, g, where in ((131_072, 8, "Q1 batch"), (524_288, 16, "config 2, 16 groups"),
                        (524_288, 4096, "config 2, 4096 groups")):
        ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        live = torch.rand(n, generator=gen, device=dev) > 0.02
        vals = torch.where(live, torch.rand(n, generator=gen, device=dev,
                                            dtype=torch.float64) * 1e3, 0.0)
        ids64 = ids.long()
        kern = _time_ms(torch, lambda: hash_agg.grouped_reduce(ids, vals, live, g, "sum"))
        plain = _time_ms(torch, lambda: hash_agg.grouped_reduce_torch(ids, vals, live, g, "sum"))
        acc = torch.zeros(g, dtype=torch.float64, device=dev)
        lib = _time_ms(torch, lambda: acc.scatter_reduce_(0, ids64, vals, "sum"))
        try:
            dev_ms = _device_ms(torch, lambda: hash_agg.grouped_reduce(ids, vals, live, g, "sum"))
        except RuntimeError as e:  # the profiler is a measurement aid only
            log(f"profiler unavailable: {e}")
            dev_ms = None
        nbytes = n * (4 + 8 + 1) + g * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n / F64_OPS_PER_S * 1e3
        out.append({
            "shape": f"N={n} G={g} f64 sum ({where})",
            "ms": kern, "device_ms": dev_ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
    log("kernel_shapes: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 3


def lineitem_sf1(tdf, batch_rows):
    """lineitem at SF-1 with benchmarks/data.py's distributions and RNG
    sequence (seed 42, 1M-row chunks), as dictionary-coded batches."""
    rng = np.random.default_rng(42)
    n_dates = 2526
    base = np.datetime64("1992-01-02")
    dates = [str(base + np.timedelta64(i, "D")) for i in range(n_dates)]
    cols = {k: [] for k in ("flag", "status", "qty", "price", "disc", "tax", "ship")}
    for start in range(0, SF1_ROWS, 1_000_000):
        n = min(1_000_000, SF1_ROWS - start)
        ship = rng.integers(0, n_dates, n).astype(np.int64)
        old = ship < (n_dates // 2)
        cols["flag"].append(np.where(old, rng.integers(0, 2, n) * 2, np.int64(1)))
        cols["status"].append((ship >= (n_dates * 5 // 8)).astype(np.int64))
        cols["qty"].append(np.floor(rng.uniform(1, 51, n)))
        cols["price"].append(np.round(rng.uniform(900.0, 104950.0, n), 2))
        cols["disc"].append(rng.integers(0, 11, n) / 100.0)
        cols["tax"].append(rng.integers(0, 9, n) / 100.0)
        cols["ship"].append(ship)
    c = {k: np.concatenate(v) for k, v in cols.items()}
    for k in ("flag", "status", "ship"):
        c[k] = c[k].astype(np.int32)
    d_flag, d_status, d_ship = (tdf.StringDictionary() for _ in range(3))
    for s in ("A", "N", "R"):
        d_flag.add(s)
    for s in ("F", "O"):
        d_status.add(s)
    for s in dates:
        d_ship.add(s)
    U, F = tdf.DataType.UTF8, tdf.DataType.FLOAT64
    schema = tdf.Schema([
        tdf.Field("l_returnflag", U, False), tdf.Field("l_linestatus", U, False),
        tdf.Field("l_quantity", F, False), tdf.Field("l_extendedprice", F, False),
        tdf.Field("l_discount", F, False), tdf.Field("l_tax", F, False),
        tdf.Field("l_shipdate", U, False),
    ])
    order = ("flag", "status", "qty", "price", "disc", "tax", "ship")
    dicts = [d_flag, d_status, None, None, None, None, d_ship]
    batches = [
        tdf.make_host_batch(schema, [c[k][lo:lo + batch_rows] for k in order],
                            None, dicts)
        for lo in range(0, SF1_ROWS, batch_rows)
    ]
    return tdf.MemoryDataSource(schema, batches), c, dates


def q1_oracle(c, dates):
    keep = c["ship"] <= dates.index("1998-09-02")
    key = (c["flag"] * 2 + c["status"])[keep]
    qty, price = c["qty"][keep], c["price"][keep]
    disc, tax = c["disc"][keep], c["tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)

    def s(w):
        return np.bincount(key, weights=w, minlength=6)

    cnt = np.bincount(key, minlength=6)
    rows = []
    for k in np.nonzero(cnt)[0]:
        n = cnt[k]
        rows.append((
            "ANR"[k // 2], "FO"[k % 2], s(qty)[k], s(price)[k], s(disc_price)[k],
            s(charge)[k], s(qty)[k] / n, s(price)[k] / n, s(disc)[k] / n, int(n),
        ))
    return rows


def assert_rows(got_table, want_rows, label):
    got = sorted(got_table.to_rows(), key=lambda r: (str(r[0]), str(r[1])))
    want = sorted(want_rows, key=lambda r: (str(r[0]), str(r[1])))
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, oracle has {len(want)}")
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                if not np.isclose(gv, wv, rtol=1e-9, atol=0.0):
                    raise AssertionError(f"{label}: {g} != {w}")
            elif gv != wv:
                raise AssertionError(f"{label}: {g} != {w}")


def run_query(tdf, cuda_mod, torch, ctx, sql, label, rows):
    """One cold run with the launch counters reset just before and read
    just after, then WARM_RUNS timed runs.  Returns (result, report)."""
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    table = tdf.collect(ctx.sql(sql))
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    launches = cuda_mod.launch_counts()
    if launches["hash_agg"] <= 0:
        raise AssertionError(f"{label}: the grouped-reduce kernel was not launched")
    times = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    report = {
        "query": label, "rows": rows, "cold_ms": cold, "p50_ms": p50,
        "warm_ms": times, "rows_per_s": rows / (p50 / 1e3),
        "launches_per_query": launches["hash_agg"],
    }
    log(f"{label}: " + json.dumps(report))
    return table, report


def q1_profile(tdf, torch, ctx, p50_ms):
    """Device time by kernel over one warm Q1 under the profiler, the
    device's busy share of the profiled wall time and of the unprofiled
    p50 (None when the trace shows no device time), and the host time
    of the group-key encode alone (a fresh encoder over every batch, as
    each query does)."""
    from torch.profiler import ProfilerActivity, profile

    from datafusion_tpu_torch.exec.aggregate import GroupKeyEncoder

    batches = list(ctx.datasources["lineitem"].batches())
    enc = GroupKeyEncoder(2)
    t0 = time.perf_counter()
    for b in batches:
        enc.encode([b.data[0], b.data[1]], [None, None])
    encode_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tdf.collect(ctx.sql(Q1))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_time_total > 0 and e.device_type.name == "CUDA"),
        key=lambda t: -t[1],
    )
    busy = sum(t[1] for t in by_kernel)
    out = {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy or None,
        "device_busy_share": (busy / wall_ms) if busy else None,
        "device_busy_share_of_p50": (busy / p50_ms) if busy else None,
        "host_encode_ms": encode_ms,
        "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in by_kernel[:8]],
    }
    log("q1_profile: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 4


def groupby_table(tdf, groups, batch_rows=1 << 19):
    """Config 2's table with benchmarks/data.py groupby_batches' RNG
    sequence (seed 3)."""
    I, F = tdf.DataType.INT64, tdf.DataType.FLOAT64
    schema = tdf.Schema([tdf.Field("k", I, False), tdf.Field("v1", F, False),
                         tdf.Field("v2", F, False), tdf.Field("v3", I, False)])
    rng = np.random.default_rng(3)
    batches, parts = [], []
    for start in range(0, CONFIG2_ROWS, batch_rows):
        n = min(batch_rows, CONFIG2_ROWS - start)
        cols = [
            rng.integers(0, groups, n).astype(np.int64),
            rng.uniform(0.0, 1000.0, n),
            rng.uniform(-1.0, 1.0, n),
            rng.integers(-(10**9), 10**9, n).astype(np.int64),
        ]
        parts.append(cols)
        batches.append(tdf.make_host_batch(schema, cols, None, None))
    c = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    return tdf.MemoryDataSource(schema, batches), c


def config2_oracle(c, groups):
    k, v1, v2, v3 = c
    cnt = np.bincount(k, minlength=groups)
    s1 = np.bincount(k, weights=v1, minlength=groups)
    s2 = np.bincount(k, weights=v2, minlength=groups)
    mn = np.full(groups, np.iinfo(np.int64).max)
    mx = np.full(groups, np.iinfo(np.int64).min)
    np.minimum.at(mn, k, v3)
    np.maximum.at(mx, k, v3)
    return [(int(g), s1[g], s2[g] / cnt[g], int(mn[g]), int(mx[g]), int(cnt[g]))
            for g in np.nonzero(cnt)[0]]


# ------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.exec.cuda import hash_agg

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build(cuda_mod, torch)
    max_abs_err = phase_kernel_parity(torch, hash_agg, dev)
    shapes = phase_kernel_timing(torch, hash_agg, dev)

    ctx = tdf.ExecutionContext()  # cuda:0
    t0 = time.perf_counter()
    src, cols, dates = lineitem_sf1(tdf, ctx.batch_size)
    log(f"lineitem SF-1 generated in {time.perf_counter() - t0:.1f} s "
        f"({len(list(src.batches()))} batches of {ctx.batch_size} rows)")
    ctx.register_datasource("lineitem", src)
    table, q1 = run_query(tdf, cuda_mod, torch, ctx, Q1, "tpch_q1_sf1", SF1_ROWS)
    assert_rows(table, q1_oracle(cols, dates), "Q1")
    log(f"Q1 rows match the numpy oracle ({table.num_rows} groups)")
    try:
        q1_profile(tdf, torch, ctx, q1["p50_ms"])
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
    main_launches = q1["launches_per_query"]
    del src, cols

    for groups in (16, 4096):
        src, cols = groupby_table(tdf, groups)
        ctx.register_datasource("t", src)
        table, rep = run_query(tdf, cuda_mod, torch, ctx, CONFIG2,
                               f"config2_groupby_{groups}", CONFIG2_ROWS)
        assert_rows(table, config2_oracle(cols, groups), f"config 2 G={groups}")
        log(f"config 2 ({groups} groups) rows match the numpy oracle")
        main_launches += rep["launches_per_query"]
        del src, cols

    q1_shape = shapes[0]
    log(json.dumps({"kernels": [{
        "name": "hash_agg.grouped_reduce",
        "route": "cuda",
        "source": "datafusion_tpu_torch/csrc/hash_agg.cu",
        "replaces": "datafusion_tpu/exec/pallas/hash_agg.py:95",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": q1_shape["ms"],
        "plain_ms": q1_shape["plain_ms"],
        "bound_ms": q1_shape["bound_ms"],
        "bound_by": q1_shape["bound_by"],
        "library_ms": q1_shape["library_ms"],
        "device_ms": q1_shape["device_ms"],
        "shape": q1_shape["shape"],
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
