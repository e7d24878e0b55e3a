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
   the sort, with the sort's passes per key, and two builds off the main
   path: a sparse one the dense window admits, and one with duplicate
   keys, which the join then sends to the host index.
3. TPC-H Q1 over lineitem at SF-1 (6,000,000 rows, generated with the
   distributions of benchmarks/data.py, seed 42) on cuda:0, checked
   against a numpy oracle: keys and counts exactly, floats within rtol
   1e-9.
4. The GROUP BY of bench config 2 over 4,000,000 rows with 16 and with
   4096 groups, checked the same way, each with its device and host
   profile.
5. Joins over the TPC-H-lite star schema at SF-1 (benchmarks/data.py's
   cardinalities and distributions, vectorised from seed 19): Q5 and
   Q12 with ORDER BY l_shipmode, against numpy oracles that join by
   direct addressing.  Every join builds dense: Q5 must launch the
   build kernel 3 times (orders, customer, nation), Q12 once (orders)
   and the sort kernel.  Then Q12 once more through the host index
   (DATAFUSION_TPU_JOIN_DENSE_SLOTS=0 around that query only), cold and
   one warm run, against the same oracle.
6. Full sorts: bench config 4b (`ORDER BY a, b` over 1,000,000 rows)
   and a filtered two-key sort of the SF-1 lineitem, against
   np.lexsort, rows and order exactly; each must launch the sort
   kernel.
Every query runs once cold and WARM_RUNS times warm.

The main path (phases 3 to 6) runs each query with the launch counters
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
    for ops, where in (([a, b], "config 4b, f64 image + int64"),
                       ([mode, okey], "lineitem sort, shipmode + ~orderkey")):
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


# ------------------------------------------------------------ phase 6


def sort4b_table(tdf):
    """Config 4b's table with benchmarks/data.py sort_batches' RNG
    sequence (seed 11), 1,000,000 rows in batches of 2^19."""
    F, I = tdf.DataType.FLOAT64, tdf.DataType.INT64
    schema = tdf.Schema([tdf.Field("a", F, False), tdf.Field("b", I, False),
                         tdf.Field("x", F, False),
                         tdf.Field("s", tdf.DataType.FLOAT32, False)])
    rng = np.random.default_rng(11)
    batches, parts = [], []
    for start in range(0, SORT4B_ROWS, 1 << 19):
        n = min(1 << 19, SORT4B_ROWS - start)
        cols = [
            rng.uniform(0.0, 1e6, n),
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.uniform(0.0, 1.0, n),
            rng.uniform(0.0, 1e6, n).astype(np.float32),
        ]
        parts.append(cols)
        batches.append(tdf.make_host_batch(schema, cols, None, None))
    c = [np.concatenate([p[i] for p in parts]) for i in range(3)]
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
    reports = [q1]
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

    join_reports, star_cols = phase_joins(tdf, cuda_mod, torch, ctx)
    reports += join_reports
    reports += phase_sorts(tdf, cuda_mod, torch, ctx, star_cols)

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
