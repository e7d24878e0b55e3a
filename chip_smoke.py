#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

No setup step: the CUDA kernels build from the checkout's sources on
first use (one nvcc per source, all started together).  Phases, each of
which raises on failure:

1. Build and device: nvcc build seconds, the card's name and power
   limit.
2. Kernel parity on the card, each kernel against its plain PyTorch
   version:
   - the grouped reduce, for every (kind, dtype) the aggregate sends, at
     N = 131,072, 524,288 and 6,000,000 rows and G in {4, 8, 16, 4096,
     8192} groups, with dead rows, out-of-range ids and NaNs: ints
     exactly, f64 within rtol 1e-12, f64 bit-identical when run twice;
   - the join build at N = S = 25, 150,000 and 1,500,000 (the nation,
     customer and orders builds of Q5), 1,000 rows into a sparse 2^26-slot
     table and an all-dead build, with dead rows, out-of-range positions
     and duplicate slots: row and count exactly, the duplicate flag
     against `count.max() > 1`, and bit-identical when run twice;
   - the radix argsort at n in {1, 2, 3, 1000, 3839, 3840, 3841 (around
     one tile of a pass), 2^18, 1,000,000, 6,000,000}, 1 to 3 keys,
     tie-heavy keys, int64.min and int64.max, and the f64 images of
     +-NaN, +-0.0 and +-inf: exactly, and bit-identical when run twice.
   Then kernel, plain and library times at the main path's shapes
   (library: `scatter_reduce_`, alone and with the fill, mask and cast
   the kernel's function needs, and the grouped reduce's phases from a
   build with DF_AGG_PHASE_CLOCKS; the build's `torch.full`,
   `scatter_reduce_("amax")`, `torch.zeros`, `index_add_` and the
   flag's `count.max() > 1`; chained `torch.argsort(stable=True)`; the
   port never calls them), per call and on the device for the build and
   the sort, with the sort's passes per key (also at the sort-merge
   aggregate's shapes: G + 524,288 keys at G = 131,072, and Q3's
   2,097,152 + 131,072), and two builds off the main path: a sparse one
   the dense window admits, and one with duplicate keys, which the join
   then sends to the host index.  Then the aggregate's route timing: one
   update of config 2's SELECT list over one batch at G = 8192, 16,384,
   131,072 (524,288 rows) and 2,097,152 (131,072 rows) through the
   grouped reduce and through sort-merge, per call and on the device,
   the two states held against each other, and the sort-merge's
   compaction by `searchsorted` against a second sort.
3. TPC-H Q1 over lineitem at SF-1 (6,000,000 rows, generated with the
   distributions of benchmarks/data.py, seed 42) on cuda:0, checked
   against a numpy oracle: keys and counts exactly, floats within rtol
   1e-9.
4. The GROUP BY of bench config 2 over 4,000,000 rows with 16 and with
   4096 groups, checked the same way, each with its device and host
   profile; then above agg_max_groups(), through the sort-merge route
   (one radix-sort launch a batch, no grouped reduce): config 2's
   100,000 groups (with its profile, and its f64 columns bit-identical
   over two more warm runs) and the cache config's 10,000 groups over
   2,000,000 rows.
5. Joins over the TPC-H-lite star schema at SF-1 (benchmarks/data.py's
   cardinalities and distributions, vectorised from seed 19): Q5 and
   Q12 with ORDER BY l_shipmode, against numpy oracles that join by
   direct addressing.  Every join builds dense: Q5 must launch the
   build kernel 3 times (orders, customer, nation), Q12 once (orders)
   and the sort kernel.  Then Q12 once more through the host index
   (DATAFUSION_TPU_JOIN_DENSE_SLOTS=0 around that query only), cold and
   one warm run, against the same oracle.  Then TPC-H Q3 and Q10 over
   the same tables against np.bincount oracles: dense builds (2 and 3),
   then a GROUP BY of about 1,470,000 and 150,000 encoded groups through
   the sort-merge route, which must launch the sort kernel; Q3 with its
   profile.
6. Full sorts: bench config 4b (`ORDER BY a, b` over 1,000,000 rows)
   and a filtered two-key sort of the SF-1 lineitem, against
   np.lexsort, rows and order exactly; each must launch the sort
   kernel.
7. Bench config 1: a 2,000,000-row cities CSV (benchmarks/data.py's
   distributions, seed 7, written by this script under build/), scanned
   by the native CSV parser (built on first use with g++) in batches of
   2^19 rows, filtered and projected on cuda:0: one cold warm-up run,
   then three cold runs that each parse the file, against numpy over
   the generated columns, exactly.  Then the reference's own example
   over test/data/uk_cities.csv: 18 rows, equal to a parse of the file.
8. A filter and a computed projection over the SF-1 lineitem of phase 3
   against numpy: strings and floats of the input exactly, the product
   within rtol 1e-9; with its device and host profile.
9. The streaming TopK of bench config 4: sort_batches' distributions at
   4,000,000 rows in batches of 2^19, its four queries, a key of 16
   distinct values (LIMIT 1000) and an f64 key with -0.0, +0.0, NaN and
   NULLs, each against a stable np.lexsort, rows and order exactly;
   each launches the sort kernel once per batch.
10. UInt8 to UInt64 columns (UInt64 at and above 2^63) on the card: MIN,
   MAX and SUM under a WHERE, grouped, and a filter alone, against
   numpy.
Every query runs once cold and WARM_RUNS times warm (phase 7: cold
runs only).

The main path (phases 3 to 10) runs each query with the launch counters
set to 0 just before its cold run and read just after; each query must
have launched the kernels of its path.  The second-to-last lines are
the `kernels` JSON object and the nvidia-smi line; the last line is
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
WARM_RUNS = 3
TIMED_LAUNCHES = 200
SF1_ROWS = 6_000_000
CONFIG2_ROWS = 4_000_000
SORT4B_ROWS = 1_000_000
CONFIG1_ROWS = 2_000_000
TOPK_ROWS = 4_000_000
UNSIGNED_ROWS = 2_000_000
Q5 = ("SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
      "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
      "JOIN customer ON orders.o_custkey = customer.c_custkey "
      "JOIN nation ON customer.c_nationkey = nation.n_nationkey "
      "GROUP BY n_name")
Q12 = ("SELECT l_shipmode, COUNT(1) FROM lineitem "
       "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
       "WHERE l_quantity > 25 GROUP BY l_shipmode ORDER BY l_shipmode")
SORT4B = "SELECT a, b, x FROM t ORDER BY a, b"
LINEITEM_SORT = ("SELECT l_shipmode, l_orderkey, l_extendedprice FROM lineitem "
                 "WHERE l_quantity > 25 ORDER BY l_shipmode, l_orderkey DESC")


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


def _device_split(torch, fn, reps=50):
    """All the device work of one call of `fn` (kernels, memsets,
    copies) from the profiler: [name, ms, launches] per call for each
    distinct name; empty when the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [[e.key, e.device_time_total / reps / 1e3, e.count / reps]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]


def _device_ms(torch, fn, reps=50):
    """Device time per call of all the call's device work; None when
    the trace shows no device time."""
    split = _device_split(torch, fn, reps)
    return sum(ms for _, ms, _ in split) if split else None


# (N, G, where): the main path's shapes of the grouped reduce
AGG_SHAPES = ((131_072, 8, "Q1 batch"), (524_288, 16, "config 2, 16 groups"),
              (524_288, 4096, "config 2, 4096 groups"),
              (524_288, 8192, "8192 groups, the default capacity"))


def _agg_timing_inputs(torch, n, g, gen, dev):
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    live = torch.rand(n, generator=gen, device=dev) > 0.02
    vals = torch.where(live, torch.rand(n, generator=gen, device=dev,
                                        dtype=torch.float64) * 1e3, 0.0)
    return ids, vals, live


def phase_kernel_timing(torch, hash_agg, cuda_mod, dev):
    """Kernel, plain and library times at the main path's shapes, f64
    sum (the slot Q1 and config 2 reduce most): per call (CUDA events
    around back-to-back calls) and on the device (all the call's device
    work, from the profiler, split by kernel, names cut to 80 characters
    for the log, with launches per call).
    `library_*` is one preallocated `scatter_reduce_` over int64 ids
    computed beforehand, the dead rows included (the yardstick of
    earlier runs); `library_fair_*` the same function as the kernel in
    library calls: the identity fill, the `torch.where` over live,
    `ids.long()` and `scatter_reduce_`.  The port calls neither.
    `phase_split_us` splits a call by phase (mean and largest over the
    blocks) from the phase-clock build."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    clock_lib = _agg_clock_library(cuda_mod, hash_agg)
    out = []
    for n, g, where in AGG_SHAPES:
        ids, vals, live = _agg_timing_inputs(torch, n, g, gen, dev)
        ids64 = ids.long()
        acc = torch.zeros(g, dtype=torch.float64, device=dev)

        def kernel():
            return hash_agg.grouped_reduce(ids, vals, live, g, "sum")

        def library():
            return acc.scatter_reduce_(0, ids64, vals, "sum")

        def library_fair():
            res = torch.zeros(g, dtype=torch.float64, device=dev)
            return res.scatter_reduce_(0, ids.long(), torch.where(live, vals, 0.0), "sum")

        entry = {
            "shape": f"N={n} G={g} f64 sum ({where})",
            "ms": _time_ms(torch, kernel),
            "plain_ms": _time_ms(torch, lambda: hash_agg.grouped_reduce_torch(
                ids, vals, live, g, "sum")),
            "library_ms": _time_ms(torch, library),
            "library_fair_ms": _time_ms(torch, library_fair),
        }
        for key, fn in (("", kernel), ("library_", library),
                        ("library_fair_", library_fair)):
            try:
                split = _device_split(torch, fn)
            except RuntimeError as e:  # the profiler is a measurement aid only
                log(f"profiler unavailable: {e}")
                split = []
            entry[key + "device_ms"] = sum(ms for _, ms, _ in split) if split else None
            entry[key + "device_split"] = [[name[:80], ms, c] for name, ms, c in split]
            entry[key + "launches_per_call"] = sum(c for _, _, c in split)
        entry["phase_split_us"] = _agg_phase_split(torch, hash_agg, cuda_mod, clock_lib,
                                                   ids, vals, live, g)
        nbytes = n * (4 + 8 + 1) + g * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n / F64_OPS_PER_S * 1e3
        entry.update(bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     geometry=dict(zip(("warps", "tile_g", "lane_parts", "blocks",
                                        "chunk_rows", "fold_lanes"),
                                       hash_agg.geometry(n, g, 8, *hash_agg._limits(
                                           torch.cuda.current_device())))))
        out.append(entry)
    log("kernel_shapes: " + json.dumps(out))
    return out


# the kernel's phases (csrc/hash_agg.cu, DF_AGG_PHASE_CLOCKS); "barrier" runs
# from a block's last partial to its start of the fold, past the grid barrier
AGG_PHASES = ("clear", "rows", "combine", "barrier", "fold")


def _agg_clock_library(cuda_mod, hash_agg):
    """csrc/hash_agg.cu built once more with DF_AGG_PHASE_CLOCKS: the
    same kernel, recording the global timer at its phase boundaries.  A
    measurement build; the port never loads it."""
    import ctypes

    out = cuda_mod.BUILD_DIR / "libhash_agg_phase_clocks.so"
    cuda_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_mod._nvcc(), *cuda_mod.NVCC_FLAGS, "-DDF_AGG_PHASE_CLOCKS",
                    "-o", str(out), str(cuda_mod.CSRC / "hash_agg.cu")],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.df_grouped_reduce.restype = ctypes.c_int
    lib.df_grouped_reduce.argtypes = hash_agg._library().df_grouped_reduce.argtypes
    lib.df_grouped_reduce_phase_clocks.restype = ctypes.c_int
    lib.df_grouped_reduce_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _agg_phase_split(torch, hash_agg, cuda_mod, lib, ids, vals, live, g):
    """Per phase of one call (f64 sum, one launch), the mean and the
    largest time over the blocks, in us, and the call's span from the
    first block's start to the last block's end."""
    import ctypes

    n = ids.shape[0]
    geo = hash_agg.geometry(n, g, 8, *hash_agg._limits(torch.cuda.current_device()))
    warps, tile_g, lane_parts, blocks, chunk_rows, fold_lanes = geo
    buf = torch.empty(g * (1 + blocks), dtype=torch.float64, device=vals.device)
    for _ in range(3):
        rc = lib.df_grouped_reduce(
            5, 0, ids.data_ptr(), vals.data_ptr(), live.data_ptr(), n, g, tile_g, warps,
            lane_parts, blocks, chunk_rows, fold_lanes, buf.data_ptr(),
            cuda_mod.raw_stream(vals.device))
        if rc != 0:
            raise RuntimeError(f"phase-clock build: CUDA error {rc}")
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * (blocks * 6))()
    if lib.df_grouped_reduce_phase_clocks(clocks, blocks) != 0:
        raise RuntimeError("phase clocks: copy failed")
    t = np.array(clocks, dtype=np.float64).reshape(blocks, 6) / 1e3
    d = np.diff(t, axis=1)
    split = {name: [float(d[:, i].mean()), float(d[:, i].max())]
             for i, name in enumerate(AGG_PHASES)}
    split["span"] = float(t[:, 5].max() - t[:, 0].min())
    return split


def _f64_images(torch, x):
    """The total-order int64 image of f64 keys, as exec/sort.py makes it
    (zeros and subnormals tie, every NaN sorts last)."""
    x = torch.where(x.abs() < torch.finfo(torch.float64).tiny, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFF_FFFF_FFFF_FFFF)


def _sort_cases(torch, n, gen, dev):
    """Key sets for the sort parity phase: a key with every digit
    constant (no pass), tie-heavy keys, full-range keys with int64.min
    and int64.max, the f64 images of +-NaN, +-0.0 and +-inf, and 1 to 3
    keys."""
    i64 = torch.iinfo(torch.int64)
    ties = torch.randint(0, 7, (n,), generator=gen, device=dev)
    full = (torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev) * 2
            + torch.randint(0, 2, (n,), generator=gen, device=dev))
    if n >= 2:
        full[0], full[-1] = i64.max, i64.min
    special = torch.tensor([float("nan"), -float("nan"), 0.0, -0.0,
                            float("inf"), -float("inf"), 1.5, -1.5],
                           dtype=torch.float64, device=dev)
    f = torch.randn(n, generator=gen, device=dev, dtype=torch.float64).round(decimals=1)
    pick = torch.rand(n, generator=gen, device=dev) < 0.2
    f[pick] = special[torch.randint(0, 8, (n,), generator=gen, device=dev)[pick]]
    img = _f64_images(torch, f)
    wide = torch.randint(0, 1 << 40, (n,), generator=gen, device=dev)
    return {
        "constant": [torch.full((n,), -7, dtype=torch.int64, device=dev)],
        "ties": [ties], "full": [full], "f64": [img],
        "ties,f64": [ties, img], "f64,wide": [img, wide],
        "ties,full,wide": [ties, full, wide],
    }


# 3839 to 3841: around one tile of a pass (sort_kernel.TILE)
SORT_SIZES = (1, 2, 3, 1000, 3839, 3840, 3841, 1 << 18, 1_000_000, 6_000_000)
# (N, S, share of live rows): the nation, customer and orders builds, a
# sparse table at the dense window (2^26 slots) and an all-dead build
BUILD_SIZES = ((25, 25, 0.9), (150_000, 150_000, 0.9), (1_500_000, 1_500_000, 0.9),
               (1000, 1 << 26, 0.9), (10_000, 10_000, 0.0))


def phase_sort_parity(torch, sort_kernel, dev):
    """The radix sort against chained torch.sort(stable=True), exactly,
    and bit-identical over two runs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    checked = 0
    max_abs_err = 0
    for n in SORT_SIZES:
        for label, ops in _sort_cases(torch, n, gen, dev).items():
            got = sort_kernel.argsort_multi(ops)
            torch.cuda.synchronize()
            want = sort_kernel.argsort_multi_torch(ops)
            max_abs_err = max(max_abs_err, int((got.long() - want.long()).abs().max()))
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"sort n={n} keys={label}: permutation differs")
            if not torch.equal(got, sort_kernel.argsort_multi(ops)):
                raise AssertionError(f"sort n={n} keys={label}: not repeatable")
            checked += 1
    torch.cuda.synchronize()
    log(f"sort parity: {checked} cases exact and repeatable")
    return float(max_abs_err)


def _build_inputs(torch, n, slots, live_share, gen, dev):
    """pos with duplicate slots, out-of-range values on both sides and
    dead rows (the join computes pos for dead rows too)."""
    pos = torch.randint(-3, slots + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    dup = torch.rand(n, generator=gen, device=dev) < 0.3
    pos[dup] = pos[dup] // 2
    live = torch.rand(n, generator=gen, device=dev) < live_share
    return pos, live


def phase_build_parity(torch, hash_build, dev):
    """The build kernel against its plain version, exactly, with its
    duplicate flag against count.max() > 1, and bit-identical over two
    runs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    max_abs_err = 0
    for n, slots, live_share in BUILD_SIZES:
        label = f"build N={n} S={slots} live {live_share}"
        pos, live = _build_inputs(torch, n, slots, live_share, gen, dev)
        got = hash_build.build_slot_table(pos, live, slots)
        torch.cuda.synchronize()
        want = hash_build.build_slot_table_torch(pos, live, slots)
        again = hash_build.build_slot_table(pos, live, slots)
        for g, w, a, what in zip(got, want, again, ("row", "count")):
            max_abs_err = max(max_abs_err, int((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: {what} differs")
            if not torch.equal(g, a):
                raise AssertionError(f"{label}: {what} not repeatable")
        dup = got[2]
        if dup != bool(want[1].max() > 1) or again[2] != dup:
            raise AssertionError(f"{label}: duplicate flag {dup} differs")
        if n == slots and live_share > 0 and not dup:
            raise AssertionError(f"{label}: no duplicate slot in the case")
    torch.cuda.synchronize()
    log(f"build parity: (N, S, live share) in {BUILD_SIZES} exact and repeatable")
    return float(max_abs_err)


def _kernel_entry(shape, kern, plain, lib, dev_ms, nbytes):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"shape": shape, "ms": kern, "device_ms": dev_ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bytes_ms, "bound_by": "bytes"}


def _profiled(torch, fn):
    """All the device work of one call of `fn`, from the profiler."""
    try:
        return _device_ms(torch, fn)
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
        return None


def _sort_passes(ops):
    """Passes the radix sort runs for each key: its 8-bit digits that are
    not the same in every row."""
    return [sum(int(((op >> (8 * b)) & 255).unique().numel() > 1) for b in range(8))
            for op in ops]


def phase_new_kernel_timing(torch, hash_build, sort_kernel, dev):
    """Build and sort times at the main path's shapes, per call (CUDA
    events around back-to-back calls) and on the device (all the call's
    device work, from the profiler), for the kernel's wrapper and for
    its library calls alike.  The build's wrapper is the one the join
    calls: memsets, the kernel and the 4-byte copy of its duplicate flag.
    The build's bound is one read of pos and live and one write of row
    and count; the sort's one read of its int64 keys and one write of
    the int32 permutation (the operations are integer compares and
    adds, far below the card's rate).  The build's library time is the
    whole function in PyTorch calls (`torch.full(-1)`,
    `scatter_reduce_("amax")`, `torch.zeros`, `index_add_`, and
    `count.max() > 1` read on the host for the flag);
    `library_scatter_only_ms` is the earlier yardstick, one preallocated
    `scatter_reduce_` alone.  `build_routing` times two builds the dense
    window admits but the join does not keep: 1,000 unique keys spread
    over 2^26 slots, and a build of 6,000,000 rows into 1,500,000 slots
    (duplicates), each with the copy of its key and mask from the host
    that the join makes first."""
    from datafusion_tpu_torch.exec.batch import to_device

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    out = {}
    builds = []
    for n, where in ((1_500_000, "orders build of Q5 and Q12"),
                     (150_000, "customer build of Q5"), (25, "nation build of Q5")):
        # a unique build key per row, as the dense path requires
        pos = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        live = torch.ones(n, dtype=torch.bool, device=dev)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        slot_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
        pos64 = pos.long()

        def library():
            row = torch.full((n,), -1, dtype=torch.int32, device=dev)
            row.scatter_reduce_(0, pos64, rows, "amax")
            count = torch.zeros(n, dtype=torch.int32, device=dev)
            count.index_add_(0, pos64, ones)
            return row, count, bool(count.max() > 1)

        def kernel():
            return hash_build.build_slot_table(pos, live, n)

        kern = _time_ms(torch, kernel)
        plain = _time_ms(torch, lambda: hash_build.build_slot_table_torch(pos, live, n))
        lib = _time_ms(torch, library)
        scatter_only = _time_ms(
            torch, lambda: slot_row.scatter_reduce_(0, pos64, rows, "amax"))
        entry = _kernel_entry(f"N=S={n} ({where})", kern, plain, lib,
                              _profiled(torch, kernel), n * (4 + 1) + n * 8)
        entry.update(library_device_ms=_profiled(torch, library),
                     library_scatter_only_ms=scatter_only)
        builds.append(entry)
    out["hash_build"] = builds
    routing = []
    for n, slots, where in ((1000, 1 << 26, "1,000 unique keys over 2^26 slots"),
                            (6_000_000, 1_500_000, "6,000,000 rows into 1,500,000 slots")):
        rng = np.random.default_rng(n)
        pos_h = (rng.choice(slots, n, replace=False) if n < slots
                 else rng.integers(0, slots, n)).astype(np.int32)
        live_h = np.ones(n, bool)

        def detour():
            return hash_build.build_slot_table(to_device(pos_h, dev), to_device(live_h, dev),
                                               slots)

        routing.append({"shape": f"N={n} S={slots} ({where})",
                        "duplicate": detour()[2], "ms": _time_ms(torch, detour, reps=20),
                        "device_ms": _profiled(torch, detour),
                        "slot_table_bytes": slots * 4})
    out["build_routing"] = routing
    sorts = []
    a = _f64_images(torch, torch.rand(SORT4B_ROWS, generator=gen, device=dev,
                                      dtype=torch.float64) * 1e6)
    b = torch.randint(0, 1 << 40, (SORT4B_ROWS,), generator=gen, device=dev)
    n3 = 3_000_000
    mode = torch.randint(0, 7, (n3,), generator=gen, device=dev)
    okey = ~torch.randint(0, 1_500_000, (n3,), generator=gen, device=dev)
    # a TopK merge of config 4 (k = 100 state rows, then a batch of
    # 2^19): its keys hold no NULL, so each crosses as its image alone
    nk = 100 + (1 << 19)
    s_img = ~_f64_images(torch, torch.rand(nk, generator=gen, device=dev,
                                           dtype=torch.float64) * 1e6)
    b_k = torch.randint(0, 1 << 40, (nk,), generator=gen, device=dev)

    def sortmerge_keys(groups, rows, used, live_share):
        # arange(G), then a batch's ids, a dead row keyed as G
        ids = torch.randint(0, used, (rows,), generator=gen, device=dev)
        live = torch.rand(rows, generator=gen, device=dev) < live_share
        return torch.cat([torch.arange(groups, device=dev), torch.where(live, ids, groups)])

    for ops, where in (([a, b], "config 4b, f64 image + int64"),
                       ([mode, okey], "lineitem sort, shipmode + ~orderkey"),
                       ([s_img], "TopK merge, ORDER BY s DESC LIMIT 100"),
                       ([s_img, b_k], "TopK merge, ORDER BY a DESC, b LIMIT 100"),
                       ([sortmerge_keys(131_072, 1 << 19, 100_000, 1.0)],
                        "sort-merge, config 2 at 100,000 groups: G=131,072 + 524,288"),
                       ([sortmerge_keys(1 << 21, 1 << 17, 1_470_000, 0.2)],
                        "sort-merge, Q3 SF-1: G=2,097,152 + 131,072, 80 % dead")):
        n = ops[0].shape[0]
        kern = _time_ms(torch, lambda: sort_kernel.argsort_multi(ops), reps=20)
        plain = _time_ms(torch, lambda: sort_kernel.argsort_multi_torch(ops), reps=20)

        def library():
            perm = torch.argsort(ops[-1], stable=True)
            for op in reversed(ops[:-1]):
                perm = perm[torch.argsort(op[perm], stable=True)]
            return perm

        lib = _time_ms(torch, library, reps=20)
        dev_ms = _profiled(torch, lambda: sort_kernel.argsort_multi(ops))
        passes = _sort_passes(ops)
        entry = _kernel_entry(f"n={n}, {len(ops)} keys ({where})", kern, plain,
                              lib, dev_ms, n * (8 * len(ops) + 4))
        entry.update(library_device_ms=_profiled(torch, library), passes_per_key=passes,
                     kernel_launches_per_call=1 + sum(passes))
        sorts.append(entry)
    out["sort_kernel"] = sorts
    log("new_kernel_shapes: " + json.dumps(out))
    return out


# (G, rows): one batch of config 2 at the threshold, past it and at 100,000
# groups' capacity; and Q3 at SF-1 (every order encoded, batches of 2^17)
ROUTE_SHAPES = ((8192, 1 << 19), (16_384, 1 << 19), (131_072, 1 << 19), (1 << 21, 1 << 17))
AGG_GROUPS_ENV = "DATAFUSION_TPU_PALLAS_AGG_GROUPS"


def _route_update(tdf, dev, groups, rows):
    """One aggregate update of config 2's SELECT list over one batch of
    `rows` rows into a state of `groups` groups, as `accumulate` makes
    it; the route follows DATAFUSION_TPU_PALLAS_AGG_GROUPS at the call.
    Returns (update, the batch's sort-merge keys)."""
    import torch

    from datafusion_tpu_torch.exec.batch import device_inputs, param_tensors, subset_view
    from datafusion_tpu_torch.exec.expression import compute_aux_values

    src, _ = groupby_table(tdf, min(groups, 100_000), batch_rows=rows, rows=rows)
    ctx = tdf.ExecutionContext(batch_size=rows)
    ctx.register_datasource("t", src)
    rel = ctx.sql(CONFIG2)
    core = rel.core
    (batch,) = list(src.batches())
    ids = rel._group_ids(batch)
    data, validity, mask = device_inputs(subset_view(batch, core.used_cols), dev)
    aux = compute_aux_values(core.aux_specs, batch, {}, dev)
    str_aux = rel._compute_str_aux(batch)
    params = param_tensors(rel._param_values, dev)
    state = core._init_state(groups, dev)
    live = torch.arange(batch.capacity, device=dev) < batch.num_rows
    keys = torch.cat([torch.arange(groups, device=dev),
                      torch.where(live, ids.long(), groups)])

    def update():
        return core.update(data, validity, aux, batch.num_rows, mask, ids, state,
                           str_aux, params, dev)

    return update, keys


def phase_route_timing(tdf, torch, sort_kernel, dev):
    """The threshold's question: one update of config 2's SELECT list
    (the predicate-free argument evaluation, then every slot) through
    the grouped-reduce route (its kernel tiles the groups past 8192) and
    through the sort-merge route, per call (CUDA events around
    back-to-back calls, the route's host reads included) and on the
    device (the profiler), with the two states held against each other:
    ints exactly, f64 within rtol 1e-12 (and atol 1e-12 for sums that
    cancel).  Then the sort-merge's compaction two ways at the same
    keys: `searchsorted` of every group's last row (the port's) against
    a second radix sort of the segment ends (the JAX package's), each
    with its gather of one column."""
    out = []
    for groups, rows in ROUTE_SHAPES:
        update, keys = _route_update(tdf, dev, groups, rows)
        entry = {"groups": groups, "rows": rows, "sort_passes": _sort_passes([keys])}
        states = {}
        for route, threshold in (("grouped_reduce", 1 << 30), ("sort_merge", 0)):
            os.environ[AGG_GROUPS_ENV] = str(threshold)
            try:
                entry[route + "_ms"] = _time_ms(torch, update, reps=20)
                entry[route + "_device_ms"] = _profiled(torch, update)
                states[route] = update()
            finally:
                del os.environ[AGG_GROUPS_ENV]
        (c0, a0), (c1, a1) = states["grouped_reduce"], states["sort_merge"]
        if not torch.equal(c0, c1):
            raise AssertionError(f"route timing G={groups}: counts differ between routes")
        for x, y in zip(a0, a1):
            if x.dtype.is_floating_point:
                # v2 in [-1, 1] sums can cancel to near 0: their error is
                # bounded by eps * sum |v2| (< 1e-13 here), not by rtol
                torch.testing.assert_close(y, x, rtol=1e-12, atol=1e-12, equal_nan=True)
            elif not torch.equal(x, y):
                raise AssertionError(f"route timing G={groups}: ints differ between routes")
        perm = sort_kernel.argsort_i64(keys)
        skeys = keys[perm]
        col = torch.rand(keys.shape[0], dtype=torch.float64, device=dev)
        group_ids = torch.arange(groups, device=dev)

        def by_searchsorted():
            right = torch.searchsorted(skeys, group_ids, right=True)
            return col.index_select(0, right - 1)

        def by_second_sort():
            last = torch.cat([skeys[1:] != skeys[:-1], torch.ones(1, dtype=torch.bool,
                                                                   device=dev)])
            ends = torch.where(last & (skeys < groups), skeys, groups)
            return col.index_select(0, sort_kernel.argsort_i64(ends)[:groups])

        if not torch.equal(by_searchsorted(), by_second_sort()):
            raise AssertionError(f"route timing G={groups}: the compactions differ")
        entry.update(compaction_searchsorted_ms=_time_ms(torch, by_searchsorted, reps=20),
                     compaction_second_sort_ms=_time_ms(torch, by_second_sort, reps=20),
                     compaction_searchsorted_device_ms=_profiled(torch, by_searchsorted),
                     compaction_second_sort_device_ms=_profiled(torch, by_second_sort))
        out.append(entry)
    log("route_timing: " + json.dumps(out))
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


def run_query(tdf, cuda_mod, torch, ctx, sql, label, rows, needs=("hash_agg",),
              warm_runs=WARM_RUNS):
    """One cold run with the launch counters reset just before and read
    just after, then `warm_runs` timed runs.  Every kernel in `needs`
    must have launched in the cold run.  Returns (result, report,
    relation)."""
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    rel = ctx.sql(sql)
    table = tdf.collect(rel)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    launches = cuda_mod.launch_counts()
    for name in needs:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    times = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    report = {
        "query": label, "rows": rows, "cold_ms": cold, "p50_ms": p50,
        "warm_ms": times, "rows_per_s": rows / (p50 / 1e3),
        "launches": launches,
    }
    log(f"{label}: " + json.dumps(report))
    return table, report, rel


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


def groupby_table(tdf, groups, batch_rows=1 << 19, rows=CONFIG2_ROWS):
    """Config 2's table with benchmarks/data.py groupby_batches' RNG
    sequence (seed 3), `rows` rows."""
    I, F = tdf.DataType.INT64, tdf.DataType.FLOAT64
    schema = tdf.Schema([tdf.Field("k", I, False), tdf.Field("v1", F, False),
                         tdf.Field("v2", F, False), tdf.Field("v3", I, False)])
    rng = np.random.default_rng(3)
    batches, parts = [], []
    for start in range(0, rows, batch_rows):
        n = min(batch_rows, rows - start)
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


def config2_columns(c, groups):
    """Config 2's result by numpy, as columns in key order."""
    k, v1, v2, v3 = c
    cnt = np.bincount(k, minlength=groups)
    s1 = np.bincount(k, weights=v1, minlength=groups)
    s2 = np.bincount(k, weights=v2, minlength=groups)
    mn = np.full(groups, np.iinfo(np.int64).max)
    mx = np.full(groups, np.iinfo(np.int64).min)
    np.minimum.at(mn, k, v3)
    np.maximum.at(mx, k, v3)
    g = np.nonzero(cnt)[0]
    return [g, s1[g], s2[g] / cnt[g], mn[g], mx[g], cnt[g]]


def config2_oracle(c, groups):
    g, s1, a2, mn, mx, cnt = config2_columns(c, groups)
    return [(int(a), b, c_, int(d), int(e), int(f))
            for a, b, c_, d, e, f in zip(g, s1, a2, mn, mx, cnt)]


def assert_grouped(table, want, label):
    """A GROUP BY's rows against oracle columns in key order, vectorised:
    the first column (a unique key) orders the rows; keys, strings and
    ints exactly, floats within rtol 1e-9."""
    if table.num_rows != len(want[0]):
        raise AssertionError(f"{label}: {table.num_rows} rows, oracle has {len(want[0])}")
    got = [np.asarray(col) for col in table.columns]
    order = np.argsort(got[0], kind="stable")
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[order], np.asarray(w)
        ok = (np.allclose(g, w, rtol=1e-9, atol=0.0) if w.dtype.kind == "f"
              else np.array_equal(g, w))
        if not ok:
            raise AssertionError(f"{label}: column {i} differs from the oracle")


def query_profile(tdf, torch, ctx, sql, label, p50_ms, top=8):
    """Where one warm run of `sql` spends its time: device time by
    kernel from torch.profiler (None when the trace shows none) and its
    share of the unprofiled p50, then, in a second run under cProfile,
    the host functions with the most time of their own (numpy's and
    torch's builtins included)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    out = {"query": label}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tdf.collect(ctx.sql(sql))
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
             if e.device_time_total > 0 and e.device_type.name == "CUDA"),
            key=lambda t: -t[1],
        )
        busy = sum(t[1] for t in by_kernel)
        out["device_busy_ms"] = busy or None
        out["device_busy_share_of_p50"] = (busy / p50_ms) if busy else None
        out["top_device"] = [{"name": k[:60], "ms": ms, "count": c}
                             for k, ms, c in by_kernel[:top]]
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(lambda: (tdf.collect(ctx.sql(sql)), torch.cuda.synchronize()))
    out["wall_ms_cprofile"] = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(
        ((f"{os.path.basename(fn)}:{name}", tt * 1e3, nc)
         for (fn, _, name), (_, nc, tt, _, _) in stats.items()),
        key=lambda t: -t[1],
    )
    out["top_host_self"] = [{"fn": f[:70], "ms": ms, "calls": n} for f, ms, n in rows[:top]]
    log(f"profile_{label}: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 4b

CACHE_ROWS = 2_000_000  # benchmarks/suite.py's cache config (BENCH_CACHE_ROWS)


def phase_high_cardinality(tdf, cuda_mod, torch, ctx, smi):
    """Config 2's high_100k leg (100,000 groups over 4,000,000 rows) and
    the cache config's shape (10,000 groups over 2,000,000 rows), both
    above agg_max_groups(): every batch takes the sort-merge route, one
    radix-sort launch a batch and no grouped reduce.  Then two more warm
    runs of the 100,000-group query, whose f64 columns must be
    bit-identical."""
    reports = []
    for groups, rows, label in ((100_000, CONFIG2_ROWS, "config2_groupby_100000"),
                                (10_000, CACHE_ROWS, "cache_config_groupby_10000")):
        src, cols = groupby_table(tdf, groups, rows=rows)
        ctx.register_datasource("t", src)
        nb = len(list(src.batches()))
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, CONFIG2, label, rows,
                                  needs=("sort_kernel",))
        if rep["launches"]["sort_kernel"] != nb or rep["launches"]["hash_agg"] != 0:
            raise AssertionError(f"{label}: launches {rep['launches']}, want one sort a "
                                 f"batch ({nb}) and no grouped reduce")
        assert_grouped(table, config2_columns(cols, groups), label)
        log(f"{label}: rows match the numpy oracle ({table.num_rows} groups; {smi})")
        rep["card"] = smi
        if groups == 100_000:
            query_profile(tdf, torch, ctx, CONFIG2, label, rep["p50_ms"])
            again = [tdf.collect(ctx.sql(CONFIG2)) for _ in range(2)]
            for i in (1, 2):
                a, b = (np.asarray(t.columns[i]).view(np.int64) for t in again)
                if not (np.array_equal(a, b)
                        and np.array_equal(a, np.asarray(table.columns[i]).view(np.int64))):
                    raise AssertionError(f"{label}: f64 column {i} not bit-identical")
            log(f"{label}: f64 SUM and AVG bit-identical over the cold and two warm runs")
        reports.append(rep)
        del src, cols
    return reports


# ------------------------------------------------------------ phase 5


def star_sf1(tdf, batch_rows):
    """The TPC-H-lite star schema at SF-1 with the cardinalities and
    distributions of benchmarks/data.py tpch_join_csvs: nation 25,
    customer 150,000, orders 1,500,000 (about 2 % of o_custkey past the
    customer table, o_orderdate Utf8), lineitem 6,000,000.  Generated
    with vectorised numpy from seed 19, so not that function's per-row
    RNG sequence, and in memory instead of CSV files.  Returns
    ({table: MemoryDataSource}, {column: numpy array})."""
    rng = np.random.default_rng(19)
    n_nation, n_cust, n_orders = 25, 150_000, 1_500_000
    c = {
        "c_nationkey": rng.integers(0, n_nation, n_cust),
        "c_mktsegment": rng.integers(0, 5, n_cust),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cust), 2),
        "o_custkey": rng.integers(0, int(n_cust * 1.02), n_orders),
        "o_date": rng.integers(0, 12, n_orders) * 28 + rng.integers(0, 28, n_orders),
        "o_shippriority": rng.integers(0, 3, n_orders),
        "l_orderkey": rng.integers(0, n_orders, SF1_ROWS),
        "l_quantity": rng.integers(1, 51, SF1_ROWS),
        "l_extendedprice": np.round(rng.uniform(900, 105000, SF1_ROWS), 2),
        "l_discount": np.round(rng.uniform(0, 0.1, SF1_ROWS), 2),
        "l_shipmode": rng.integers(0, 7, SF1_ROWS),
    }
    d_name, d_date = tdf.StringDictionary(), tdf.StringDictionary()
    for i in range(n_nation):
        d_name.add(f"NATION_{i:02d}")
    for m in range(1, 13):
        for d in range(1, 29):
            d_date.add(f"1995-{m:02d}-{d:02d}")
    I, F, U = tdf.DataType.INT64, tdf.DataType.FLOAT64, tdf.DataType.UTF8

    def table(fields, cols, dicts=None):
        schema = tdf.Schema([tdf.Field(name, t, False) for name, t in fields])
        n = len(cols[0])
        return tdf.MemoryDataSource(schema, [
            tdf.make_host_batch(schema, [col[lo:lo + batch_rows] for col in cols],
                                None, dicts)
            for lo in range(0, n, batch_rows)
        ])

    tables = {
        "nation": table([("n_nationkey", I), ("n_name", U)],
                        [np.arange(n_nation), np.arange(n_nation, dtype=np.int32)],
                        [None, d_name]),
        "customer": table([("c_custkey", I), ("c_nationkey", I),
                           ("c_mktsegment", I), ("c_acctbal", F)],
                          [np.arange(n_cust), c["c_nationkey"], c["c_mktsegment"],
                           c["c_acctbal"]]),
        "orders": table([("o_orderkey", I), ("o_custkey", I), ("o_orderdate", U),
                         ("o_shippriority", I)],
                        [np.arange(n_orders), c["o_custkey"],
                         c["o_date"].astype(np.int32), c["o_shippriority"]],
                        [None, None, d_date, None]),
        "lineitem": table([("l_orderkey", I), ("l_quantity", I), ("l_extendedprice", F),
                           ("l_discount", F), ("l_shipmode", I)],
                          [c["l_orderkey"], c["l_quantity"], c["l_extendedprice"],
                           c["l_discount"], c["l_shipmode"]]),
    }
    return tables, c


def q5_oracle(c):
    """Q5 by direct addressing: o_orderkey and c_custkey are row
    numbers; a dangling o_custkey drops the row."""
    cust = c["o_custkey"][c["l_orderkey"]]
    ok = cust < len(c["c_nationkey"])
    nation = c["c_nationkey"][cust[ok]]
    rev = (c["l_extendedprice"] * (1 - c["l_discount"]))[ok]
    sums = np.bincount(nation, weights=rev, minlength=25)
    cnt = np.bincount(nation, minlength=25)
    return [(f"NATION_{i:02d}", sums[i]) for i in range(25) if cnt[i] > 0]


def q12_oracle(c):
    """Q12 with ORDER BY: every l_orderkey has its order."""
    cnt = np.bincount(c["l_shipmode"][c["l_quantity"] > 25], minlength=7)
    return [(m, int(cnt[m])) for m in range(7) if cnt[m] > 0]


def join_routes(rel):
    """Whether each join of an operator tree built densely, outermost
    first."""
    from datafusion_tpu_torch.join.relation import HashJoinRelation

    out, stack = [], [rel]
    while stack:
        r = stack.pop()
        if isinstance(r, HashJoinRelation):
            out.append(r._artifact.dense)
            stack.extend([r.right, r.left])
        elif getattr(r, "child", None) is not None:
            stack.append(r.child)
    return out


def phase_joins(tdf, cuda_mod, torch, ctx):
    t0 = time.perf_counter()
    tables, cols = star_sf1(tdf, ctx.batch_size)
    for name, src in tables.items():
        ctx.register_datasource(name, src)
    log(f"star schema SF-1 generated in {time.perf_counter() - t0:.1f} s")
    reports = []
    table, rep, rel = run_query(tdf, cuda_mod, torch, ctx, Q5, "tpch_q5_sf1", SF1_ROWS,
                                needs=("hash_agg", "hash_build"))
    assert_rows(table, q5_oracle(cols), "Q5")
    routes = join_routes(rel)
    if rep["launches"]["hash_build"] != 3 or routes != [True, True, True]:
        raise AssertionError(f"Q5: build launches {rep['launches']['hash_build']}, "
                             f"dense routes {routes} (want 3, every join dense)")
    log(f"Q5 rows match the numpy oracle ({table.num_rows} nations); "
        f"dense builds {routes} (nation, customer, orders)")
    query_profile(tdf, torch, ctx, Q5, "tpch_q5_sf1", rep["p50_ms"])
    reports.append(rep)
    table, rep, rel = run_query(tdf, cuda_mod, torch, ctx, Q12, "tpch_q12_order_by_sf1",
                                SF1_ROWS, needs=("hash_agg", "hash_build", "sort_kernel"))
    if table.to_rows() != q12_oracle(cols):
        raise AssertionError(f"Q12: {table.to_rows()} != {q12_oracle(cols)}")
    if rep["launches"]["hash_build"] != 1 or join_routes(rel) != [True]:
        raise AssertionError("Q12: the orders build should launch the kernel once, dense")
    log(f"Q12 rows and order match the numpy oracle ({table.num_rows} ship modes); "
        "orders build dense")
    query_profile(tdf, torch, ctx, Q12, "tpch_q12_order_by_sf1", rep["p50_ms"])
    reports.append(rep)
    # the host-index route, driven once: no dense build for this query
    os.environ["DATAFUSION_TPU_JOIN_DENSE_SLOTS"] = "0"
    try:
        table, host_rep, rel = run_query(tdf, cuda_mod, torch, ctx, Q12,
                                         "tpch_q12_host_index_sf1", SF1_ROWS,
                                         needs=("hash_agg", "sort_kernel"), warm_runs=1)
    finally:
        del os.environ["DATAFUSION_TPU_JOIN_DENSE_SLOTS"]
    if table.to_rows() != q12_oracle(cols):
        raise AssertionError(f"Q12 (host index): {table.to_rows()} != {q12_oracle(cols)}")
    if host_rep["launches"]["hash_build"] != 0 or join_routes(rel) != [False]:
        raise AssertionError("Q12 (host index): the orders build should take the host index")
    log("Q12 through the host index matches the numpy oracle")
    reports.append(host_rep)
    return reports, cols


# ------------------------------------------------------------ phase 5b

Q3 = ("SELECT o_orderkey, o_shippriority, "
      "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
      "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
      "JOIN customer ON orders.o_custkey = customer.c_custkey "
      "WHERE c_mktsegment = 1 "
      "GROUP BY o_orderkey, o_shippriority")
Q10 = ("SELECT c_custkey, n_name, "
       "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
       "JOIN orders ON lineitem.l_orderkey = orders.o_orderkey "
       "JOIN customer ON orders.o_custkey = customer.c_custkey "
       "JOIN nation ON customer.c_nationkey = nation.n_nationkey "
       "WHERE o_orderdate <= '1995-06-30' "
       "GROUP BY c_custkey, n_name")


def _revenue_by(key, keep, c, size):
    """(live keys, their revenue sums) by np.bincount over dense keys."""
    rev = (c["l_extendedprice"] * (1 - c["l_discount"]))[keep]
    cnt = np.bincount(key[keep], minlength=size)
    sums = np.bincount(key[keep], weights=rev, minlength=size)
    g = np.nonzero(cnt)[0]
    return g, sums[g]


def q3_columns(c):
    """Q3 by direct addressing: a dangling o_custkey drops the row; the
    groups are the orders of market segment 1's customers."""
    cust = c["o_custkey"][c["l_orderkey"]]
    ok = cust < len(c["c_mktsegment"])
    keep = ok & (c["c_mktsegment"][np.where(ok, cust, 0)] == 1)
    g, rev = _revenue_by(c["l_orderkey"], keep, c, len(c["o_custkey"]))
    return [g, c["o_shippriority"][g], rev]


def q10_columns(c):
    """Q10 by direct addressing: orders of the first half of 1995 (date
    codes below 6 * 28), grouped by customer (its nation follows)."""
    cust = c["o_custkey"][c["l_orderkey"]]
    n_cust = len(c["c_nationkey"])
    keep = (cust < n_cust) & (c["o_date"][c["l_orderkey"]] < 6 * 28)
    g, rev = _revenue_by(cust, keep, c, n_cust)
    names = np.array([f"NATION_{i:02d}" for i in range(25)], dtype=object)
    return [g, names[c["c_nationkey"][g]], rev]


def phase_high_cardinality_joins(tdf, cuda_mod, torch, ctx, cols, smi):
    """TPC-H Q3 and Q10 (benchmarks/suite.py config_joins) over phase 5's
    SF-1 star schema: dense builds, then a GROUP BY above
    agg_max_groups() through the sort-merge route.  Each WHERE runs in
    the aggregate, after the joins, so Q3 encodes every order that has
    lines and Q10 every customer with orders."""
    from datafusion_tpu_torch.exec.aggregate import group_capacity

    reports = []
    for sql, label, want, builds in ((Q3, "tpch_q3_sf1", q3_columns(cols), 2),
                                     (Q10, "tpch_q10_sf1", q10_columns(cols), 3)):
        table, rep, rel = run_query(tdf, cuda_mod, torch, ctx, sql, label, SF1_ROWS,
                                    needs=("sort_kernel", "hash_build"))
        assert_grouped(table, want, label)
        routes = join_routes(rel)
        if rep["launches"]["hash_build"] != builds or not all(routes):
            raise AssertionError(f"{label}: build launches {rep['launches']['hash_build']}, "
                                 f"dense routes {routes} (want {builds}, every join dense)")
        rep.update(card=smi, groups_out=table.num_rows,
                   groups_encoded=rel.encoder.num_groups,
                   capacity=group_capacity(rel.encoder.num_groups))
        log(f"{label}: rows match the numpy oracle ({table.num_rows} groups of "
            f"{rel.encoder.num_groups} encoded; {rep['launches']['sort_kernel']} sorts)")
        if label == "tpch_q3_sf1":
            query_profile(tdf, torch, ctx, sql, label, rep["p50_ms"])
        reports.append(rep)
    return reports


# ------------------------------------------------------------ phase 6


def sort4b_table(tdf, rows=SORT4B_ROWS):
    """Config 4b's table with benchmarks/data.py sort_batches' RNG
    sequence (seed 11), `rows` rows in batches of 2^19."""
    F, I = tdf.DataType.FLOAT64, tdf.DataType.INT64
    schema = tdf.Schema([tdf.Field("a", F, False), tdf.Field("b", I, False),
                         tdf.Field("x", F, False),
                         tdf.Field("s", tdf.DataType.FLOAT32, False)])
    rng = np.random.default_rng(11)
    batches, parts = [], []
    for start in range(0, rows, 1 << 19):
        n = min(1 << 19, rows - start)
        cols = [
            rng.uniform(0.0, 1e6, n),
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.uniform(0.0, 1.0, n),
            rng.uniform(0.0, 1e6, n).astype(np.float32),
        ]
        parts.append(cols)
        batches.append(tdf.make_host_batch(schema, cols, None, None))
    c = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    return tdf.MemoryDataSource(schema, batches), c


def assert_columns(table, want_cols, label):
    """Rows and order exactly: every output column equals the oracle's."""
    if table.num_rows != len(want_cols[0]):
        raise AssertionError(f"{label}: {table.num_rows} rows, oracle has "
                             f"{len(want_cols[0])}")
    for i, want in enumerate(want_cols):
        if not np.array_equal(np.asarray(table.columns[i]), want):
            raise AssertionError(f"{label}: column {i} differs from the oracle")


def phase_sorts(tdf, cuda_mod, torch, ctx, cols):
    reports = []
    src, c = sort4b_table(tdf)
    ctx.register_datasource("t", src)
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, SORT4B, "config4b_full_sort",
                              SORT4B_ROWS, needs=("sort_kernel",))
    order = np.lexsort((c[1], c[0]))
    assert_columns(table, [c[0][order], c[1][order], c[2][order]], "config 4b")
    log("config 4b rows and order match np.lexsort")
    query_profile(tdf, torch, ctx, SORT4B, "config4b_full_sort", rep["p50_ms"])
    reports.append(rep)
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, LINEITEM_SORT,
                              "lineitem_filtered_sort_sf1", SF1_ROWS,
                              needs=("sort_kernel",))
    sel = cols["l_quantity"] > 25
    mode, okey = cols["l_shipmode"][sel], cols["l_orderkey"][sel]
    order = np.lexsort((~okey, mode))  # DESC by complement; stable
    assert_columns(table, [mode[order], okey[order], cols["l_extendedprice"][sel][order]],
                   "lineitem sort")
    log(f"lineitem sort rows and order match np.lexsort ({table.num_rows} rows)")
    query_profile(tdf, torch, ctx, LINEITEM_SORT, "lineitem_filtered_sort_sf1", rep["p50_ms"])
    reports.append(rep)
    return reports


# ------------------------------------------------------------ phase 7


CITIES_SQL = ("SELECT city, lat, lng, lat + lng FROM cities "
              "WHERE lat > 51.0 AND lat < 53.0")
UK_SQL = "SELECT city, lat, lng, lat + lng FROM cities WHERE lat > 51.0 AND lat < 53"


def write_cities_csv(path, rows):
    """Bench config 1's CSV (benchmarks/data.py cities_csv: seed 7,
    2,000 city names, lat and lng uniform and rounded to 6 places, a
    header), floats in their shortest round-trip form.  Returns the
    columns."""
    rng = np.random.default_rng(7)
    pool = np.array([f"city_{i:04d}" for i in range(2000)])
    city = pool[rng.integers(0, len(pool), rows)]
    lat = np.round(rng.uniform(49.9, 59.0, rows), 6)
    lng = np.round(rng.uniform(-7.6, 1.8, rows), 6)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("city,lat,lng\n")
        for lo in range(0, rows, 1 << 18):
            sl = slice(lo, lo + (1 << 18))
            f.write("".join(map("{},{!r},{!r}\n".format, city[sl].tolist(),
                                lat[sl].tolist(), lng[sl].tolist())))
    os.replace(tmp, path)
    return city, lat, lng


def phase_csv(tdf, cuda_mod, torch, smi):
    """Bench config 1: the scan -> filter -> project of a 2,000,000-row
    CSV, cold (each run a new context that parses the file), then the
    reference example over test/data/uk_cities.csv."""
    import csv

    from datafusion_tpu_torch import native

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"cities_{CONFIG1_ROWS}.csv")
    t0 = time.perf_counter()
    city, lat, lng = write_cities_csv(path, CONFIG1_ROWS)
    log(f"cities CSV ({CONFIG1_ROWS} rows, {os.path.getsize(path)} bytes) written in "
        f"{time.perf_counter() - t0:.1f} s; native CSV library ready in {build_s:.2f} s")
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("city", D.UTF8, False), tdf.Field("lat", D.FLOAT64, False),
                         tdf.Field("lng", D.FLOAT64, False)])

    def cold():
        ctx = tdf.ExecutionContext(batch_size=1 << 19)
        ctx.register_csv("cities", path, schema, has_header=True)
        t = time.perf_counter()
        table = tdf.collect(ctx.sql(CITIES_SQL))
        torch.cuda.synchronize()
        return table, (time.perf_counter() - t) * 1e3

    cuda_mod.reset_launch_counts()
    table, warmup_ms = cold()
    launches = cuda_mod.launch_counts()
    keep = (lat > 51.0) & (lat < 53.0)
    want = [city[keep], lat[keep], lng[keep], lat[keep] + lng[keep]]
    for i, w in enumerate(want):
        if not np.array_equal(np.asarray(table.columns[i]), w):
            raise AssertionError(f"config 1: column {i} differs from the oracle")
    times = [cold()[1] for _ in range(3)]
    p50 = float(np.median(times))
    # the scan alone: the native parse and the batch assembly, no query
    reader = tdf.CsvDataSource(path, schema, True, 1 << 19)
    t0 = time.perf_counter()
    for _ in reader.batches():
        pass
    scan_ms = (time.perf_counter() - t0) * 1e3
    rep = {"query": "config1_csv_scan_filter", "rows": CONFIG1_ROWS, "card": smi,
           "rows_out": int(keep.sum()), "warmup_cold_ms": warmup_ms, "cold_ms": times,
           "p50_ms": p50, "rows_per_s": CONFIG1_ROWS / (p50 / 1e3), "scan_only_ms": scan_ms,
           "native_build_s": build_s, "launches": launches}
    log("config1_csv_scan_filter: " + json.dumps(rep))
    log(f"config 1 rows match the numpy oracle ({table.num_rows} rows)")
    # the reference's own example (examples/csv_sql.rs)
    uk = os.path.join(here, "test", "data", "uk_cities.csv")
    ctx = tdf.ExecutionContext()
    ctx.register_csv("cities", uk, schema, has_header=False)
    got = tdf.collect(ctx.sql(UK_SQL)).to_rows()
    with open(uk, newline="") as f:
        parsed = [(r[0], float(r[1]), float(r[2])) for r in csv.reader(f)]
    want = [(c, a, b, a + b) for c, a, b in parsed if 51.0 < a < 53]
    if got != want or len(got) != 18:
        raise AssertionError(f"uk_cities: {len(got)} rows differ from the file's parse")
    log("uk_cities example: 18 rows match a parse of the file")
    return rep


# ------------------------------------------------------------ phase 8


SF1_FILTER_PROJECT = ("SELECT l_returnflag, l_quantity, l_extendedprice * (1 - l_discount) "
                      "FROM lineitem WHERE l_shipdate <= '1998-09-02' AND l_discount > 0.05")


def phase_filter_project(tdf, cuda_mod, torch, ctx, cols, dates, smi):
    """A filter and a computed projection over the SF-1 lineitem of phase
    3, against numpy: strings and ints exactly, floats within rtol 1e-9."""
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, SF1_FILTER_PROJECT,
                              "lineitem_filter_project_sf1", SF1_ROWS, needs=())
    keep = (cols["ship"] <= dates.index("1998-09-02")) & (cols["disc"] > 0.05)
    flags = np.array(["A", "N", "R"], dtype=object)[cols["flag"][keep]]
    want = [flags, cols["qty"][keep], cols["price"][keep] * (1 - cols["disc"][keep])]
    if table.num_rows != int(keep.sum()):
        raise AssertionError(f"SF-1 filter/project: {table.num_rows} rows, oracle "
                             f"{int(keep.sum())}")
    got = [np.asarray(c) for c in table.columns]
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and np.allclose(got[2], want[2], rtol=1e-9, atol=0.0)):
        raise AssertionError("SF-1 filter/project: rows differ from the numpy oracle")
    log(f"SF-1 filter/project rows match the numpy oracle ({table.num_rows} rows; "
        f"{smi})")
    rep["card"] = smi
    query_profile(tdf, torch, ctx, SF1_FILTER_PROJECT, "lineitem_filter_project_sf1",
                  rep["p50_ms"])
    return rep


# ------------------------------------------------------------ phase 9


def topk_table(tdf):
    """Bench config 4's table (sort_batches' distributions, seed 11) at
    4,000,000 rows in batches of 2^19, with two key columns from a seed
    of their own: `g`, 16 distinct values, and `n`, a few hundred f64
    values (with -0.0 and +0.0), as many NaNs, and NULLs elsewhere."""
    src, c = sort4b_table(tdf, TOPK_ROWS)
    rng = np.random.default_rng(12)
    g = rng.integers(0, 16, TOPK_ROWS).astype(np.int64)
    pick = rng.random(TOPK_ROWS)
    n = np.where(pick < 1e-4, rng.normal(size=TOPK_ROWS).round(1), np.nan)
    n[(pick >= 1e-4) & (pick < 1.1e-4)] = -0.0
    valid = pick < 2e-4  # below 1e-4 a number (some +-0.0), then NaN, else NULL
    F, I = tdf.DataType.FLOAT64, tdf.DataType.INT64
    schema = tdf.Schema(src.schema.fields + [tdf.Field("g", I, False),
                                             tdf.Field("n", F, True)])
    batches, lo = [], 0
    for b in src.batches():
        hi = lo + b.num_rows
        batches.append(tdf.make_host_batch(
            schema, [col[:b.num_rows] for col in b.data] + [g[lo:hi], n[lo:hi]],
            [None] * 4 + [None, valid[lo:hi]]))
        lo = hi
    return tdf.MemoryDataSource(schema, batches), c + [g, n, valid]


def _total_order(x):
    """IEEE total order of f64 values (-0.0 before +0.0) as int64."""
    b = np.ascontiguousarray(x, np.float64).view(np.int64)
    return b ^ ((b >> 63) & np.int64(0x7FFF_FFFF_FFFF_FFFF))


def topk_cases(c):
    """(label, SQL, output columns, oracle order) of phase 9; each
    oracle is a stable np.lexsort, ties in ascending row order."""
    a, b, x, s, g, n, valid = c
    cls = np.where(~valid, 2, np.where(np.isnan(n), 1, 0))  # number, NaN, NULL
    img = np.where(cls == 0, _total_order(np.where(cls == 0, n, 0.0)), 0)
    return [
        ("topk_s_desc", "SELECT s, b, x FROM t ORDER BY s DESC LIMIT 100", (s, b, x),
         np.lexsort((-s,))[:100]),
        ("topk_a_desc", "SELECT a, b, x FROM t ORDER BY a DESC LIMIT 100", (a, b, x),
         np.lexsort((-a,))[:100]),
        ("topk_b_asc", "SELECT b, a, x FROM t ORDER BY b LIMIT 100", (b, a, x),
         np.lexsort((b,))[:100]),
        ("topk_a_desc_b", "SELECT a, b, x FROM t ORDER BY a DESC, b LIMIT 100", (a, b, x),
         np.lexsort((b, -a))[:100]),
        ("topk_ties_16", "SELECT g, b FROM t ORDER BY g DESC LIMIT 1000", (g, b),
         np.lexsort((-g,))[:1000]),
        ("topk_nan_null", "SELECT n, b FROM t ORDER BY n LIMIT 1000", (n, b),
         np.lexsort((img, cls))[:1000]),
    ]


def phase_topk(tdf, cuda_mod, torch, ctx, smi):
    t0 = time.perf_counter()
    src, c = topk_table(tdf)
    ctx.register_datasource("t", src)
    nb = len(list(src.batches()))
    log(f"TopK table ({TOPK_ROWS} rows, {nb} batches) generated in "
        f"{time.perf_counter() - t0:.1f} s")
    reports = []
    for label, sql, cols, order in topk_cases(c):
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, sql, label, TOPK_ROWS,
                                  needs=("sort_kernel",))
        if rep["launches"]["sort_kernel"] != nb:
            raise AssertionError(f"{label}: {rep['launches']['sort_kernel']} sort launches, "
                                 f"one per batch is {nb}")
        for i, col in enumerate(cols):
            got = np.asarray(table.columns[i])
            want = col[order]
            if label == "topk_nan_null" and i == 0:
                # NULL rows hold no value; the others match bit for bit
                live = c[6][order]
                ok = (np.array_equal(np.asarray(table.validity[i]), live)
                      and np.array_equal(got[live].view(np.int64),
                                         want[live].view(np.int64)))
            else:
                ok = np.array_equal(got, want)
            if table.num_rows != len(order) or not ok:
                raise AssertionError(f"{label}: rows or order differ from np.lexsort")
        rep["card"] = smi
        log(f"{label}: rows and order match a stable np.lexsort ({table.num_rows} rows)")
        if label == "topk_a_desc_b":
            query_profile(tdf, torch, ctx, sql, label, rep["p50_ms"])
        reports.append(rep)
    return reports


# ------------------------------------------------------------ phase 10


UNSIGNED_AGG = ("SELECT k, MIN(a), MAX(a), SUM(a), MIN(b), MAX(b), SUM(b), MIN(c), MAX(c), "
                "SUM(c), MIN(d), MAX(d), SUM(d), COUNT(1) FROM u "
                "WHERE d > 9223372036854775808 AND c < 4000000000 GROUP BY k")
UNSIGNED_FILTER = ("SELECT a, b, c, d FROM u "
                   "WHERE a > 100 AND b <= 60000 AND d >= 9223372036854775808")


def phase_unsigned(tdf, cuda_mod, torch, ctx, smi):
    """MIN, MAX and SUM over UInt8 to UInt64 columns (UInt64 at and above
    2^63) under a WHERE, and a filter alone, against numpy: SUM wraps
    mod 2^64 and returns the column's type, as the JAX package's does."""
    rng = np.random.default_rng(21)
    rows = UNSIGNED_ROWS
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", D.INT64, False), tdf.Field("a", D.UINT8, False),
                         tdf.Field("b", D.UINT16, False), tdf.Field("c", D.UINT32, False),
                         tdf.Field("d", D.UINT64, False)])
    cols = [rng.integers(0, 16, rows),
            rng.integers(0, 1 << 8, rows).astype(np.uint8),
            rng.integers(0, 1 << 16, rows).astype(np.uint16),
            rng.integers(0, 1 << 32, rows).astype(np.uint32),
            rng.integers(0, 1 << 64, rows, dtype=np.uint64)]
    batches = [tdf.make_host_batch(schema, [x[lo:lo + (1 << 19)] for x in cols])
               for lo in range(0, rows, 1 << 19)]
    ctx.register_datasource("u", tdf.MemoryDataSource(schema, batches))
    k, a, b, cc, d = cols
    keep = (d > np.uint64(1 << 63)) & (cc < 4_000_000_000)
    want = []
    for g in range(16):
        m = keep & (k == g)
        if not m.any():
            continue
        row = [g]
        for x in (a, b, cc, d):
            total = np.add.reduce(x[m].astype(np.uint64), dtype=np.uint64)
            row += [int(x[m].min()), int(x[m].max()), int(total.astype(x.dtype))]
        want.append(tuple(row + [int(m.sum())]))
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, UNSIGNED_AGG, "unsigned_aggregate",
                              rows)
    if sorted(table.to_rows()) != want:
        raise AssertionError("unsigned aggregate: rows differ from the numpy oracle")
    rep["card"] = smi
    reports = [rep]
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, UNSIGNED_FILTER, "unsigned_filter",
                              rows, needs=())
    m = (a > 100) & (b <= 60000) & (d >= np.uint64(1 << 63))
    for i, x in enumerate((a, b, cc, d)):
        got = np.asarray(table.columns[i])
        if got.dtype != x.dtype or not np.array_equal(got, x[m]):
            raise AssertionError(f"unsigned filter: column {i} differs from numpy")
    rep["card"] = smi
    reports.append(rep)
    log(f"unsigned MIN/MAX/SUM and filter match numpy ({table.num_rows} rows; {smi})")
    return reports


# ------------------------------------------------------------ main


def _kernel_line(name, source, replaces, launches, max_abs_err, entry):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": entry["ms"], "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
        "library_ms": entry["library_ms"], "device_ms": entry["device_ms"],
        "shape": entry["shape"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.exec.cuda import hash_agg, hash_build, sort_kernel

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build(cuda_mod, torch)
    agg_err = phase_kernel_parity(torch, hash_agg, dev)
    build_err = phase_build_parity(torch, hash_build, dev)
    sort_err = phase_sort_parity(torch, sort_kernel, dev)
    shapes = phase_kernel_timing(torch, hash_agg, cuda_mod, dev)
    new_shapes = phase_new_kernel_timing(torch, hash_build, sort_kernel, dev)
    phase_route_timing(tdf, torch, sort_kernel, dev)

    ctx = tdf.ExecutionContext()  # cuda:0
    t0 = time.perf_counter()
    src, cols, dates = lineitem_sf1(tdf, ctx.batch_size)
    log(f"lineitem SF-1 generated in {time.perf_counter() - t0:.1f} s "
        f"({len(list(src.batches()))} batches of {ctx.batch_size} rows)")
    ctx.register_datasource("lineitem", src)
    table, q1, _ = run_query(tdf, cuda_mod, torch, ctx, Q1, "tpch_q1_sf1", SF1_ROWS)
    assert_rows(table, q1_oracle(cols, dates), "Q1")
    log(f"Q1 rows match the numpy oracle ({table.num_rows} groups)")
    try:
        q1_profile(tdf, torch, ctx, q1["p50_ms"])
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
    reports = [q1, phase_filter_project(tdf, cuda_mod, torch, ctx, cols, dates, smi)]
    del src, cols

    for groups in (16, 4096):
        src, cols = groupby_table(tdf, groups)
        ctx.register_datasource("t", src)
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, CONFIG2,
                                  f"config2_groupby_{groups}", CONFIG2_ROWS)
        assert_rows(table, config2_oracle(cols, groups), f"config 2 G={groups}")
        log(f"config 2 ({groups} groups) rows match the numpy oracle")
        query_profile(tdf, torch, ctx, CONFIG2, f"config2_groupby_{groups}", rep["p50_ms"])
        reports.append(rep)
        del src, cols
    reports += phase_high_cardinality(tdf, cuda_mod, torch, ctx, smi)

    join_reports, star_cols = phase_joins(tdf, cuda_mod, torch, ctx)
    reports += join_reports
    reports += phase_high_cardinality_joins(tdf, cuda_mod, torch, ctx, star_cols, smi)
    reports += phase_sorts(tdf, cuda_mod, torch, ctx, star_cols)
    del star_cols
    reports.append(phase_csv(tdf, cuda_mod, torch, smi))
    reports += phase_topk(tdf, cuda_mod, torch, ctx, smi)
    reports += phase_unsigned(tdf, cuda_mod, torch, ctx, smi)

    def launched(name):
        return sum(r["launches"][name] for r in reports)

    log(json.dumps({"kernels": [
        _kernel_line("hash_agg.grouped_reduce", "datafusion_tpu_torch/csrc/hash_agg.cu",
                     "datafusion_tpu/exec/pallas/hash_agg.py:95", launched("hash_agg"),
                     agg_err, shapes[0]),
        _kernel_line("hash_build.build_slot_table",
                     "datafusion_tpu_torch/csrc/hash_build.cu",
                     "datafusion_tpu/exec/pallas/hash_build.py:70",
                     launched("hash_build"), build_err, new_shapes["hash_build"][0]),
        _kernel_line("sort_kernel.argsort_multi", "datafusion_tpu_torch/csrc/sort_kernel.cu",
                     "datafusion_tpu/exec/pallas/sort_kernel.py:89",
                     launched("sort_kernel"), sort_err, new_shapes["sort_kernel"][0]),
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
