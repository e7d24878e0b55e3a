#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

No setup step: the CUDA kernels build from the checkout's sources on
first use (one nvcc per source, all started together).  Phases, each of
which raises on failure:

1. Build and device: nvcc build seconds (and the native library's g++
   build beside it), the card's name and power limit.
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
   The grouped reduce also at the batch-group fold's shapes (Q1's 46
   batches of 131,072 rows in one call, config 2's 8 of 524,288), the
   radix argsort at the fold's sort-merge and TopK shapes (G + a group's
   rows; config 4's 4,000,000 rows), each against its plain version.
   Then kernel, plain and library times at the main path's shapes
   (the fold's shapes among them; library: `scatter_reduce_`, alone and
   with the fill, mask and cast
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
   (one radix-sort launch a batch group, no grouped reduce): config 2's
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
   each launches the sort kernel once per batch group.
10. UInt8 to UInt64 columns (UInt64 at and above 2^63) on the card: MIN,
   MAX and SUM under a WHERE, grouped, and a filter alone, against
   numpy.
11. Serving (datafusion_tpu_torch/serve.py).  First the grouped reduce's
   query axis (`grouped_reduce_multi`) against its plain version and
   against Q solo launches, bit for bit, at Q1's group shape (Q = 1, 8,
   16, 32; G = 64 at Q = 8), config 2's (G = 16 and 4096, Q = 4) and for
   MIN and MAX with NaN, with its times against Q solo launches and one
   `scatter_reduce_` over offset ids, its query tile, its passes and the
   bytes it reads (`query_axis_timing` lines; right after phase 2).
   Then, after phase 8, a Server(workers=2, window_s=0.01,
   megabatch_max=16) over the SF-1 lineitem: 8 closed-loop clients with
   4 Q1-shaped queries each (32 l_shipdate cutoffs; a warm-up round,
   then the measured one: no byte copied to the device, fewer
   grouped-reduce launches than queries, every answer its solo answer
   bit for bit and the numpy oracle within rtol 1e-9), the TopK lane
   (LIMIT 10, 100, 1000 at once: fewer sort launches than queries) and
   the pipeline lane (8 l_discount literals), each answer its solo
   answer exactly; eviction under a DATAFUSION_TPU_HBM_BYTES cap and an
   `hbm` shed.  After phase 5, Q12 served 4 times: one build launch, 3
   reuses of the pinned build.  Each lane prints a `serve:` line; the
   aggregate lane's carries the static verifier's host ms a query
   (`verify_ms_per_query`, run at submit on the client's thread).
12. The console (after phase 6): the reference's smoketest through
   `cli.main(["--script", ...])` against test/data/smoketest-expected.txt
   under the golden rule; Q1 at SF-1 through a console script over the
   phase-3 lineitem written as CSV (CREATE EXTERNAL TABLE, Q1 cold, Q1
   warm: 6 grouped-reduce launches a batch group); Q12 at SF-1 through
   a console script over the phase-5 orders and lineitem written as CSV
   (1 dense build launch, 1 sort launch); Q1 through the DataFrame API
   over the in-memory lineitem (SQL Q1's rows and launches, both p50s);
   EXPLAIN and EXPLAIN VERIFY of Q1, and a computed GROUP BY key that
   raises PlanVerificationError before any launch; an NDJSON table
   (test/data/example1.ndjson) grouped through the console against
   json.loads of the file.  `console_*` and `dataframe_q1` lines.
12b. Parquet through the port's own reader (after phase 12,
   `phase_parquet`; no pyarrow on the card's machine): the fixtures
   `uk_cities.parquet` and `all_types_flat.parquet` by CREATE EXTERNAL
   TABLE against the native CSV reads of their twins, value for value
   (one pinned cell differs); `lineitem_sf1`'s columns written as
   Parquet by this script's own writer (`write_lineitem_parquet`: row
   groups of 1,000,000 rows, RLE_DICTIONARY but l_extendedprice PLAIN,
   SNAPPY pages of at most 1 MiB), then Q1 over it through CREATE
   EXTERNAL TABLE ... STORED AS PARQUET, cold and warm, against
   `q1_oracle`, with the scan alone timed.  `parquet_*` lines.
13. Per-query observability (after phase 7, `phase_explain`): EXPLAIN
   ANALYZE of Q1 at SF-1 (rows against `q1_oracle`, 6 grouped-reduce
   launches, "execute" from CUDA events above 0 and within the wall, the
   report printed), Q1's warm p50 plain, under EXPLAIN ANALYZE with the
   host profiler and without it, in turns (`explain_cost`), EXPLAIN
   ANALYZE of Q10 (rows against `q10_columns`, the host profile's top
   frames per phase), config 1 cold under a profiler capture with the
   decode phase split between `dtf_csv_next` and the bridge's Python
   (`config1_parse_split`), `utils/profiling.trace` over one Q1 run (its
   grouped-reduce kernel events) and the console's `\\hbm` report beside
   `torch.cuda.memory_allocated()`.
14. The freshness and durability plane (after phase 13, `phase_ingest`):
   a materialized Q1 view over the SF-1 lineitem maintained through a
   write-ahead log that fsyncs before each ack (one warm-up delta, 15
   deltas of 2,000 rows and one of 131,072: append-plus-maintain ms with
   the log and without, one device pass and 6 grouped-reduce launches a
   delta, the view and a rescan against a numpy oracle), recovery of the
   log into a fresh context, the result cache at config_cache's shape
   (cold, warm-hit p50, hit rate, a miss with the new rows after an
   append), a served append that copies exactly the delta's used columns
   and group ids, and a pin manifest re-pinning the table at a second
   server's `start()`.  `ingest_*` lines.  The grouped reduce is also
   timed at the delta's shape (N = 2,048, G = 8) in phase 2.
15. Tenancy and cost (after phase 14, `phase_tenancy`): two tenants
   with shares 3:1 over the pinned SF-1 lineitem (A's 4 closed-loop
   clients alone, then against B's open-loop burst of 4x A's queries:
   quota sheds for B only, per-tenant and metering conservation, the
   query axis), FIFO without shares, a `device.call` fault plan replayed
   and a tiny retry budget denying B, the cost store across a restart
   (config 2 at 100,000 groups presized onto sort-merge, Q12 with
   lineitem written on the build side swapped to build over orders, a
   poisoned store's replan, `DATAFUSION_TPU_COST=0`), and the learned
   grouped-reduce window routing 12,000 groups.  `tenancy*` lines.
16. Distributed execution (after phase 15, `phase_distributed`): the
   partitioned mesh (`PartitionedContext` on 8 shard slots of cuda:0)
   at config 5's shape (config 2's SQL over 4,000,000 rows and 1,000
   groups in 8 partitions, seeds 100 to 107) against the numpy oracle,
   5 grouped-reduce launches a round cold and one folded pass warm, f64
   bit-identical over two folded warm runs, and against a one-slot
   mesh; two `python -m datafusion_tpu_torch.worker` processes on
   cuda:0 (fragment cache off) serving TPC-H Q1 over phase 12's SF-1
   lineitem CSV cut into 4 partitions (cold, twice warm; their `status`
   launch counts: 6 grouped reduces a batch group of each fragment),
   Q1 over the same 4 partitions written as Parquet (cold, twice warm),
   Q12 over phase 12's orders and lineitem CSVs through the shuffle join
   and under DATAFUSION_TPU_SHUFFLE=0 (the coordinator's grouped
   reduce, sort and, for the local join, build), and Q1 again with one
   worker killed (every fragment on the survivor).  `dist_*` lines.
17. The data plane (after phase 6, `phase_data_plane`): the probes
   (`link_rate_mbps`, both exact probes, which must read True, and
   whether `auto` turns the codec on over this link), the wire spec of
   each of Q1's columns and its `put_compressed` round trip bit for bit
   under DATAFUSION_TPU_WIRE=always, cold Q1 over fresh batch objects
   with =always, =auto and =never in turns (3 runs each: ms,
   `h2d.bytes`, `h2d.encode`; the same result bits, and `auto` sends
   what its choice sends), the SF-1 filter/project's `d2h.bytes` and
   compacted batches, the lineitem sort cold and twice more on one
   relation (permutation-plane bytes; the third run makes no sort
   launch), and the TopK `a DESC, b` over config 4's 4,000,000 rows.
   `data_plane_*` lines.
18. Fleet observability (after phase 16, `phase_fleet`): tenant A's
   warm Q1 round over the resident SF-1 lineitem alone and under tenant
   B's cold scans (shares 3:1): every served pass on its worker's own
   CUDA stream, metering equal to `device.dispatch`, every answer its
   solo bits, A's metered ms a query alone and under B printed; the pin's
   accounted bytes equal to its cached device tensors' bytes; warm Q1
   10 times through the telemetry funnel under a latency SLO it
   breaches (no telemetry error, no ledger leak, 10 histogram samples,
   `device.h2d` events carrying `h2d.bytes`, a breach artifact and a
   slow-query artifact with its OTLP document); the debug HTTP plane's
   routes; two workers with their debug planes: the fleet view, the
   console's `top` and `debug-bundle` over them, and the survivor's
   ring after one is killed mid-query.  A's metered ms a query under B
   must stay within 2x of alone (the meter's host gate, exec/gate.py).
   `fleet_*` lines.
19. The cluster control plane (after phase 18, `phase_cluster`): a
   3-replica service (`python -m datafusion_tpu_torch.cluster`, a primary
   and two standbys, write quorum 2, a write-ahead log each, lease TTL
   2 s) and two `--cluster` workers on cuda:0.  A coordinator given only
   `cluster=` finds both and runs Q1 over phase 16's 4 partitions cold
   and warm (the oracle's rows, each worker's grouped reduces in its
   `status`); a second coordinator in a fresh context gets the same bits
   from the shared result tier with no launch on either worker; an
   invalidation reaches both workers within one heartbeat; `kill -9` of
   the primary: a standby promotes within one TTL, every write
   acknowledged under W=2 is there, the membership epoch holds (leases
   re-armed), the term rises, and Q1 answers; `kill -9` of a worker: its
   lease lapses, the epoch rises by one, and Q1 answers from the
   survivor.  `cluster_*` lines.
20. The analyzers (after phase 19, `phase_analysis`): the invariant
   linter over the package (`python -m datafusion_tpu_torch.analysis`,
   exit 0); a child process (`--analysis-round`) under
   DATAFUSION_TPU_LOCKCHECK=1 and DATAFUSION_TPU_PROFILE_HZ=97 on
   cuda:0 serves Q1 at SF-1, config 4's TopK over 4,000,000 rows and Q12
   at SF-1 through one Server (2 workers, 8 clients) against their
   oracles, appends through the write-ahead log and reads the rows back
   served, hits the result cache, forces one slow-query artifact and
   builds one debug bundle; its lock-order report, evaluated with
   `--lockcheck-report`, must hold no cycle and no blocking call under a
   lock, each of the three kernels must have launched in the child, the
   artifact must carry `profile` and the bundle `profile_continuous`.
   The child also times served Q1 with lockcheck on and off, in turns
   (for information).  Then `execute_physical` writes Q1 at SF-1 to a
   CSV and shows its first rows, `Server.submit` registers a CSV of
   262,144 lineitem rows with CREATE EXTERNAL TABLE and answers Q1 over
   it, and one `append` goes over the loopback wire to an in-process
   worker with an ingest context, each against its oracle.
   `analysis_*` lines.
Every query runs once cold and WARM_RUNS times warm (phase 7: cold
runs only; Q3 and Q10 once warm, to keep the script inside its time
limit), with the peak device memory of its first warm run.  Every
context passes `result_cache=False` (the console phase runs under
`DATAFUSION_TPU_CACHE=0`), so a warm run computes, except the cache
step of phase 14, which measures the result cache.

The batch-group fold (exec/fused.py) folds each scan of the main path
into one group (at most DATAFUSION_TPU_FUSE_GROUP = 256 batches): the
aggregate launches the grouped reduce once per slot per group (Q1 6, config
2 at 16 and 4096 groups 5, Q5 2, Q12 1) or the sort once per group
(config 2 at 100,000 groups, the cache shape, Q3, Q10: 1), and each
TopK query sorts once.  The fold A/B runs Q1, config 2 at 16, 4096 and
100,000 groups, the cache shape and the six TopK queries once more
under DATAFUSION_TPU_FUSE=0, which must give the same rows (ints,
strings and order exactly, f64 within rtol 1e-9) with one launch per
slot per batch (Q1 276, config 2 40) or one sort per batch (8, 4 and 8
per TopK query), and prints both p50s on a `fold_ab` line.  The
prefetch A/B runs Q1, the SF-1 filter/project and config 2 (16 groups)
warm under DATAFUSION_TPU_PREFETCH=1 (the staged prefetch threads; an
in-memory scan runs serial by default), and config 1 cold three times
interleaved with the default under DATAFUSION_TPU_PREFETCH=0 (a CSV
scan stages by default), and prints both p50s on a `prefetch_ab` line.  Q3
and Q10 stay out of both (8 to 17 s a run).

The main path (phases 3 to 10, 12, 12b and 13 to 20) runs each query with the launch counters
set to 0 just before its cold run and read just after; each query must
have launched the kernels of its path, as often as the fold says.  The second-to-last lines are
the `kernels` JSON object and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA device or without the package beside this script.
"""

from __future__ import annotations

import atexit
import functools
import io
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


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; every time the script prints stands beside it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def fold_groups(nb: int) -> int:
    """The batch groups a scan of `nb` batches folds into, at the
    default DATAFUSION_TPU_FUSE_GROUP (one group for every scan here)."""
    from datafusion_tpu_torch.exec.fused import fuse_group_max

    return -(-nb // fuse_group_max())


def expect_launches(rep, label, **want):
    """The cold run launched each named kernel exactly as often as `want`
    says."""
    got = {k: rep["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {rep['launches']}, want {want}")


# ------------------------------------------------------------ phase 1


def phase_build(cuda_mod, torch):
    """The kernels (one nvcc per source) and, beside them, the native
    library of the CSV parser and the SQL front-end (g++) and the
    grouped reduce's phase-clock build (`_agg_clock_library`, which
    phase 2 waits for)."""
    from concurrent.futures import ThreadPoolExecutor

    from datafusion_tpu_torch import native

    def native_build():
        t0 = time.perf_counter()
        native.load_library()
        return time.perf_counter() - t0

    _start_agg_clock_build(cuda_mod)
    with ThreadPoolExecutor(1) as ex:
        native_s = ex.submit(native_build)
        secs = cuda_mod.build_all()
        native_s = native_s.result()
    smi = card()
    log(f"build: {secs:.2f} s (nvcc, sm_90a); native library (g++) {native_s:.2f} s")
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


# (N, G) of the grouped reduce: batches of Q1 and config 2, the SF-1
# lineitem in one call, and the batch-group fold's shapes: Q1's 46
# batches of 131,072 rows in one group, config 2's 8 of 524,288
PARITY_SHAPES = ([(n, g) for n in (131_072, 524_288, 6_000_000)
                  for g in (4, 8, 16, 4096, 8192)]
                 + [(46 * 131_072, 8), (46 * 131_072, 4096), (8 * 524_288, 16)])


def phase_kernel_parity(torch, hash_agg, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    max_abs_err = 0.0
    checked = 0
    for n, g in PARITY_SHAPES:
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
              (524_288, 8192, "8192 groups, the default capacity"),
              (46 * 131_072, 8, "Q1 batch group: 46 batches"),
              (8 * 524_288, 16, "config 2 batch group, 16 groups: 8 batches"),
              (8 * 524_288, 4096, "config 2 batch group, 4096 groups: 8 batches"),
              (2048, 8, "view delta: 2,000 rows in a batch of 2,048"))


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
    for entry in out:
        entry["card"] = card()
    log("kernel_shapes: " + json.dumps(out))
    return out


# the kernel's phases (csrc/hash_agg.cu, DF_AGG_PHASE_CLOCKS); "barrier" runs
# from a block's last partial to its start of the fold, past the grid barrier
AGG_PHASES = ("clear", "rows", "combine", "barrier", "fold")


_AGG_CLOCK_BUILD: list = []  # the phase-clock build's nvcc, once started


def _start_agg_clock_build(cuda_mod):
    """Starts nvcc on csrc/hash_agg.cu with DF_AGG_PHASE_CLOCKS, once;
    a script that ends first stops it."""
    if not _AGG_CLOCK_BUILD:
        out = cuda_mod.BUILD_DIR / "libhash_agg_phase_clocks.so"
        cuda_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(
            [cuda_mod._nvcc(), *cuda_mod.NVCC_FLAGS, "-DDF_AGG_PHASE_CLOCKS", "-o", str(out),
             str(cuda_mod.CSRC / "hash_agg.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(proc.kill)
        _AGG_CLOCK_BUILD.append((out, proc))
    return _AGG_CLOCK_BUILD[0]


def _agg_clock_library(cuda_mod, hash_agg):
    """csrc/hash_agg.cu built once more with DF_AGG_PHASE_CLOCKS: the
    same kernel, recording the global timer at its phase boundaries.  A
    measurement build; the port never loads it."""
    import ctypes

    out, proc = _start_agg_clock_build(cuda_mod)
    log_text = proc.communicate(timeout=600)[0] if proc.returncode is None else ""
    if proc.returncode != 0:
        raise RuntimeError(f"phase-clock build failed:\n{log_text}")
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
            5, 0, ids.data_ptr(), vals.data_ptr(), 0, live.data_ptr(), n, 1, 1, g, tile_g,
            warps, lane_parts, blocks, chunk_rows, fold_lanes, buf.data_ptr(),
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

    # a TopK merge of config 4 at the default fold: its 8 batches, one
    # group, with no state before it
    s_all = ~_f64_images(torch, torch.rand(TOPK_ROWS, generator=gen, device=dev,
                                           dtype=torch.float64) * 1e6)
    b_all = torch.randint(0, 1 << 40, (TOPK_ROWS,), generator=gen, device=dev)
    for ops, where in (([a, b], "config 4b, f64 image + int64"),
                       ([mode, okey], "lineitem sort, shipmode + ~orderkey"),
                       ([s_img], "TopK merge, ORDER BY s DESC LIMIT 100"),
                       ([s_img, b_k], "TopK merge, ORDER BY a DESC, b LIMIT 100"),
                       ([sortmerge_keys(131_072, 1 << 19, 100_000, 1.0)],
                        "sort-merge, config 2 at 100,000 groups: G=131,072 + 524,288"),
                       ([sortmerge_keys(1 << 21, 1 << 17, 1_470_000, 0.2)],
                        "sort-merge, Q3 SF-1: G=2,097,152 + 131,072, 80 % dead"),
                       ([sortmerge_keys(131_072, 8 << 19, 100_000, 1.0)],
                        "sort-merge batch group, config 2 at 100,000 groups: "
                        "G=131,072 + 8 x 524,288"),
                       ([sortmerge_keys(1 << 21, 46 << 17, 1_470_000, 0.2)],
                        "sort-merge batch group, Q3 SF-1: G=2,097,152 + 46 x 131,072, "
                        "80 % dead"),
                       ([s_all], "TopK batch group, ORDER BY s DESC LIMIT 100: 8 batches"),
                       ([s_all, b_all],
                        "TopK batch group, ORDER BY a DESC, b LIMIT 100: 8 batches")):
        n = ops[0].shape[0]
        if not torch.equal(sort_kernel.argsort_multi(ops),
                           sort_kernel.argsort_multi_torch(ops)):
            raise AssertionError(f"argsort at n={n} ({where}) differs from its plain version")
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
    out["card"] = card()
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
    ctx = tdf.ExecutionContext(batch_size=rows, result_cache=False)
    ctx.register_datasource("t", src)
    rel = ctx.sql(CONFIG2)
    core = rel.core
    (batch,) = list(src.batches())
    ids, _ = rel._group_ids(batch)
    data, validity, mask = device_inputs(subset_view(batch, core.used_cols), dev)
    aux = compute_aux_values(core.aux_specs, batch, {}, dev)
    str_aux = rel._compute_str_aux(batch)
    params = param_tensors(rel._param_values, dev)
    state = core._init_state(groups, dev)
    live = torch.arange(batch.capacity, device=dev) < batch.num_rows
    keys = torch.cat([torch.arange(groups, device=dev),
                      torch.where(live, ids.long(), groups)])

    def update():
        return core.fused_group([(data, validity, batch.num_rows, mask, ids)], state,
                                aux, str_aux, params)

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
    log("route_timing: " + json.dumps({"card": card(), "shapes": out}))
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


def q1_oracle(c, dates, cutoff="1998-09-02"):
    keep = c["ship"] <= dates.index(cutoff)
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
    must have launched in the cold run.  `peak_warm_mb`: the device
    memory allocated at its peak during the first warm run
    (`torch.cuda.max_memory_allocated`, the tables' cached device copies
    included).  Returns (result, report, relation)."""
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
    peak = None
    for i in range(warm_runs):
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tdf.collect(ctx.sql(sql))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2**20
    p50 = float(np.median(times))
    report = {
        "query": label, "rows": rows, "cold_ms": cold, "p50_ms": p50,
        "warm_ms": times, "rows_per_s": rows / (p50 / 1e3),
        "launches": launches, "peak_warm_mb": peak, "card": card(),
    }
    log(f"{label}: " + json.dumps(report))
    return table, report, rel


def assert_same_tables(got, want, label, key_cols=1, ordered=False):
    """Two results of one query: the same rows, ints, strings and NULLs
    exactly and f64 within rtol 1e-9; in the same order when `ordered`,
    else after ordering both by their first `key_cols` columns."""
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{label}: {got.num_rows} rows against {want.num_rows}")

    def columns(t):
        cols = [np.asarray(c) for c in t.columns]
        valid = [np.ones(t.num_rows, bool) if v is None else np.asarray(v)
                 for v in t.validity]
        if not ordered:
            keys = [c.astype(str) if c.dtype == object else c for c in cols[:key_cols]]
            order = np.lexsort(keys[::-1])
            cols, valid = [c[order] for c in cols], [v[order] for v in valid]
        return cols, valid

    (g, gv), (w, wv) = columns(got), columns(want)
    for i in range(len(w)):
        if not np.array_equal(gv[i], wv[i]):
            raise AssertionError(f"{label}: column {i} NULLs differ")
        a, b = g[i][wv[i]], w[i][wv[i]]
        same = (np.allclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True)
                if b.dtype.kind == "f" else np.array_equal(a, b))
        if not same:
            raise AssertionError(f"{label}: column {i} differs")


def ab_run(tdf, cuda_mod, torch, ctx, sql, label, rows, base, knob, needs=(),
           want_launches=None, key_cols=1, ordered=False):
    """The query once more (cold, then warm runs) with the environment
    variable `knob` set against its default: DATAFUSION_TPU_FUSE=0 (the
    per-batch path: one update or one TopK merge a batch) or
    DATAFUSION_TPU_PREFETCH=1 (the staged prefetch threads, over these
    in-memory scans).  Its rows
    must equal `base`'s, the default run's (table, report), and its cold
    run must launch `want_launches`.  Prints both p50s on one line
    beside the card."""
    value = "0" if knob == FUSE_KNOB else "1"
    tag = f"{knob}_{value}"
    os.environ[knob] = value
    try:
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, sql, f"{label}_{tag}",
                                  rows, needs=needs)
    finally:
        del os.environ[knob]
    if want_launches is not None:
        expect_launches(rep, f"{label} with {knob}={value}", **want_launches)
    assert_same_tables(table, base[0], f"{label} with {knob}={value}", key_cols, ordered)
    kind = "fold_ab" if knob == FUSE_KNOB else "prefetch_ab"
    log(f"{kind}: " + json.dumps({
        "query": label, "default_p50_ms": base[1]["p50_ms"], f"{tag}_p50_ms": rep["p50_ms"],
        "default_launches": base[1]["launches"], f"{tag}_launches": rep["launches"],
        "default_peak_warm_mb": base[1]["peak_warm_mb"],
        f"{tag}_peak_warm_mb": rep["peak_warm_mb"], "card": card()}))
    return rep


FUSE_KNOB = "DATAFUSION_TPU_FUSE"
PREFETCH_KNOB = "DATAFUSION_TPU_PREFETCH"


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
    out["card"] = card()
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
    out["card"] = card()
    log(f"profile_{label}: " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 4b

CACHE_ROWS = 2_000_000  # benchmarks/suite.py's cache config (BENCH_CACHE_ROWS)


def phase_high_cardinality(tdf, cuda_mod, torch, ctx, smi):
    """Config 2's high_100k leg (100,000 groups over 4,000,000 rows) and
    the cache config's shape (10,000 groups over 2,000,000 rows), both
    above agg_max_groups(): the sort-merge route, one radix-sort launch
    a batch group and no grouped reduce; under DATAFUSION_TPU_FUSE=0 one
    a batch.  Then two more warm runs of the 100,000-group query, whose
    f64 columns must be bit-identical."""
    reports = []
    for groups, rows, label in ((100_000, CONFIG2_ROWS, "config2_groupby_100000"),
                                (10_000, CACHE_ROWS, "cache_config_groupby_10000")):
        src, cols = groupby_table(tdf, groups, rows=rows)
        ctx.register_datasource("t", src)
        nb = len(list(src.batches()))
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, CONFIG2, label, rows,
                                  needs=("sort_kernel",))
        # one sort a batch group, no grouped reduce
        expect_launches(rep, label, sort_kernel=fold_groups(nb), hash_agg=0)
        assert_grouped(table, config2_columns(cols, groups), label)
        log(f"{label}: rows match the numpy oracle ({table.num_rows} groups; {smi})")
        ab_run(tdf, cuda_mod, torch, ctx, CONFIG2, label, rows, (table, rep), FUSE_KNOB,
               needs=("sort_kernel",), want_launches={"sort_kernel": nb, "hash_agg": 0})
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
    nb = fold_groups(len(list(ctx.datasources["lineitem"].batches())))
    expect_launches(rep, "Q5", hash_agg=2 * nb)  # the row count and one sum
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
    expect_launches(rep, "Q12", hash_agg=nb, sort_kernel=1)  # the row count; ORDER BY
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
    expect_launches(host_rep, "Q12 (host index)", hash_agg=nb, sort_kernel=1)
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
        # one warm run each (8 to 17 s a run): the script's time limit
        table, rep, rel = run_query(tdf, cuda_mod, torch, ctx, sql, label, SF1_ROWS,
                                    needs=("sort_kernel", "hash_build"), warm_runs=1)
        assert_grouped(table, want, label)
        routes = join_routes(rel)
        expect_launches(rep, label, hash_agg=0, sort_kernel=fold_groups(
            len(list(ctx.datasources["lineitem"].batches()))))
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

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"cities_{CONFIG1_ROWS}.csv")
    t0 = time.perf_counter()
    city, lat, lng = write_cities_csv(path, CONFIG1_ROWS)
    log(f"cities CSV ({CONFIG1_ROWS} rows, {os.path.getsize(path)} bytes) written in "
        f"{time.perf_counter() - t0:.1f} s")
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("city", D.UTF8, False), tdf.Field("lat", D.FLOAT64, False),
                         tdf.Field("lng", D.FLOAT64, False)])

    def cold():
        ctx = tdf.ExecutionContext(batch_size=1 << 19, result_cache=False)
        ctx.register_csv("cities", path, schema, has_header=True)
        t = time.perf_counter()
        table = tdf.collect(ctx.sql(CITIES_SQL))
        torch.cuda.synchronize()
        return table, (time.perf_counter() - t) * 1e3

    cuda_mod.reset_launch_counts()
    table, warmup_ms = cold()
    launches = cuda_mod.launch_counts()
    keep = (lat > 51.0) & (lat < 53.0)
    oracle = [city[keep], lat[keep], lng[keep], lat[keep] + lng[keep]]
    for i, w in enumerate(oracle):
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
           "launches": launches}
    log("config1_csv_scan_filter: " + json.dumps(rep))
    log(f"config 1 rows match the numpy oracle ({table.num_rows} rows)")
    # the default, the staged prefetch threads (the parse of the next
    # batch beside the host prep of this one), against the serial path:
    # three cold runs each, interleaved
    ab = {"default": [], f"{PREFETCH_KNOB}_0": []}
    for _ in range(3):
        os.environ[PREFETCH_KNOB] = "0"
        try:
            serial, serial_ms = cold()
        finally:
            del os.environ[PREFETCH_KNOB]
        assert_same_tables(serial, table, "config 1 without prefetch", ordered=True)
        ab[f"{PREFETCH_KNOB}_0"].append(serial_ms)
        ab["default"].append(cold()[1])
    log("prefetch_ab: " + json.dumps({
        "query": "config1_csv_scan_filter", "interleaved_cold_ms": ab,
        "default_cold_p50_ms": float(np.median(ab["default"])),
        f"{PREFETCH_KNOB}_0_cold_p50_ms": float(np.median(ab[f"{PREFETCH_KNOB}_0"])),
        "card": card()}))
    # the reference's own example (examples/csv_sql.rs)
    uk = os.path.join(here, "test", "data", "uk_cities.csv")
    ctx = tdf.ExecutionContext(result_cache=False)
    ctx.register_csv("cities", uk, schema, has_header=False)
    got = tdf.collect(ctx.sql(UK_SQL)).to_rows()
    with open(uk, newline="") as f:
        parsed = [(r[0], float(r[1]), float(r[2])) for r in csv.reader(f)]
    want = [(c, a, b, a + b) for c, a, b in parsed if 51.0 < a < 53]
    if got != want or len(got) != 18:
        raise AssertionError(f"uk_cities: {len(got)} rows differ from the file's parse")
    log("uk_cities example: 18 rows match a parse of the file")
    return rep, (path, schema, oracle)


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
    ab_run(tdf, cuda_mod, torch, ctx, SF1_FILTER_PROJECT, "lineitem_filter_project_sf1",
           SF1_ROWS, (table, rep), PREFETCH_KNOB, ordered=True)
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
        expect_launches(rep, label, sort_kernel=fold_groups(nb))  # one a batch group
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
        ab_run(tdf, cuda_mod, torch, ctx, sql, label, TOPK_ROWS, (table, rep), FUSE_KNOB,
               needs=("sort_kernel",), want_launches={"sort_kernel": nb}, ordered=True)
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


# ------------------------------------------------------------ phase 11

# the grouped reduce's query axis: (N, G, Q, values per query, where)
QUERY_AXIS_SHAPES = ((46 * 131_072, 8, 1, False, "Q1 batch group"),
                     (46 * 131_072, 8, 8, False, "Q1 batch group"),
                     (46 * 131_072, 8, 16, False, "Q1 batch group"),
                     (46 * 131_072, 8, 32, False, "Q1 batch group"),
                     (46 * 131_072, 64, 8, False, "Q1 batch group, 64 groups"),
                     (8 * 524_288, 16, 4, True, "config 2 batch group, 16 groups"),
                     (8 * 524_288, 4096, 4, True, "config 2 batch group, 4096 groups"))


def _query_axis_inputs(torch, n, g, q, per_query, gen, dev, kind="sum"):
    ids = torch.randint(-1, g + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    live = torch.rand((q, n), generator=gen, device=dev) > 0.3
    shape = (q, n) if per_query else (n,)
    lo = 0.0 if kind == "sum" else -1e3
    vals = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * (1e3 - lo) + lo
    if kind != "sum":
        vals[torch.rand(shape, generator=gen, device=dev) < 1e-4] = float("nan")
    return ids, vals, live


def _check_query_axis(torch, hash_agg, ids, vals, live, g, kind, label):
    """One query-axis launch against its plain version (rtol 1e-12) and
    against Q solo launches, bit for bit.  Returns the largest absolute
    difference from the plain version."""
    got = hash_agg.grouped_reduce_multi(ids, vals, live, g, kind)
    want = hash_agg.grouped_reduce_multi_torch(ids, vals, live, g, kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0, equal_nan=True, msg=label)
    for j in range(live.shape[0]):
        solo = hash_agg.grouped_reduce(ids, vals if vals.dim() == 1 else vals[j].contiguous(),
                                       live[j].contiguous(), g, kind)
        if not torch.equal(got[j].view(torch.int64), solo.view(torch.int64)):
            raise AssertionError(f"{label}: query {j} differs from its solo launch")
    fin = torch.isfinite(want)
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def phase_query_axis(torch, hash_agg, dev):
    """The grouped reduce's query axis on the card: parity at Q1's group
    shape (Q = 1, 8, 16), config 2's (G = 16 and 4096, Q = 4; values per
    query) and for MIN and MAX with NaN, each query bit for bit against
    its solo launch; then the times of one launch against Q solo
    launches, its plain version and one `scatter_reduce_` over the
    offset ids q * G + id on Q x N rows (dead rows keyed Q * G, one slot
    past the result), with its byte bound: the ids once, the values
    (once when shared) and Q live masks, Q * G results; beside it the
    launch's query tile and passes (`hash_agg.query_tiles`) and the
    bytes it reads: the ids, and shared values, once a pass, each
    query's mask and its own values once."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(909)
    err = 0.0
    for n, g, q, per_query, where in QUERY_AXIS_SHAPES:
        ids, vals, live = _query_axis_inputs(torch, n, g, q, per_query, gen, dev)
        err = max(err, _check_query_axis(torch, hash_agg, ids, vals, live, g, "sum",
                                         f"sum N={n} G={g} Q={q}"))
    for kind in ("min", "max"):
        ids, vals, live = _query_axis_inputs(torch, 1_000_000, 4096, 4, True, gen, dev, kind)
        err = max(err, _check_query_axis(torch, hash_agg, ids, vals, live, 4096, kind,
                                         f"{kind} with NaN"))
    log(f"query axis parity: {len(QUERY_AXIS_SHAPES) + 2} shapes, every query bit for bit "
        f"its solo launch, plain within rtol 1e-12, max_abs_err {err!r}")
    entries = []
    for n, g, q, per_query, where in QUERY_AXIS_SHAPES:
        ids, vals, live = _query_axis_inputs(torch, n, g, q, per_query, gen, dev)

        def kern():
            return hash_agg.grouped_reduce_multi(ids, vals, live, g, "sum")

        def solos():
            for j in range(q):
                hash_agg.grouped_reduce(ids, vals if not per_query else vals[j], live[j], g,
                                        "sum")

        rows = live.reshape(-1)
        offset = (torch.arange(q, device=dev, dtype=torch.int64)[:, None] * g
                  + ids.long()[None, :])
        idx = torch.where(live & (ids >= 0)[None, :] & (ids < g)[None, :], offset,
                          q * g).reshape(-1)
        flat = vals.expand(q, n).reshape(-1).contiguous()
        out = torch.zeros(q * g + 1, dtype=torch.float64, device=dev)

        def library():
            out.zero_().scatter_reduce_(0, idx, flat, "sum")

        kern_ms = _time_ms(torch, kern, reps=50)
        solo_ms = _time_ms(torch, solos, reps=20)
        plain_ms = _time_ms(torch, lambda: hash_agg.grouped_reduce_multi_torch(
            ids, vals, live, g, "sum"), reps=5)
        lib_ms = _time_ms(torch, library, reps=20)
        nbytes = 4 * n + vals.numel() * 8 + rows.numel() + q * g * 8
        tile, passes = hash_agg.query_tiles(n, g, 8, *hash_agg._limits(
            torch.cuda.current_device()), q)
        per_pass = 4 * n + (0 if per_query else 8 * n)
        entry = _kernel_entry(f"{where}: N={n}, G={g}, Q={q}, f64 sum, "
                              f"{'values per query' if per_query else 'shared values'}",
                              kern_ms, plain_ms, lib_ms, _profiled(torch, kern), nbytes)
        entry.update({"query_tile": tile, "passes": passes,
                      "bytes_read": per_pass * passes + vals.numel() * 8 * per_query
                      + rows.numel(),
                      "solo_launches_ms": solo_ms,
                      "solo_launches_device_ms": _profiled(torch, solos),
                      "library_device_ms": _profiled(torch, library), "card": card()})
        log("query_axis_timing: " + json.dumps(entry))
        entries.append(entry)
    return err, entries


def assert_same_bits(got, want, label, key_cols=1, ordered=False):
    """Two results of one query, every column and validity mask byte for
    byte (f64 bit for bit), after ordering both by their first
    `key_cols` columns unless `ordered`."""
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{label}: {got.num_rows} rows against {want.num_rows}")

    def columns(t):
        cols = [np.asarray(c) for c in t.columns]
        valid = [None if v is None else np.asarray(v) for v in t.validity]
        if not ordered:
            keys = [c.astype(str) if c.dtype == object else c for c in cols[:key_cols]]
            order = np.lexsort(keys[::-1])
            cols = [c[order] for c in cols]
            valid = [None if v is None else v[order] for v in valid]
        return cols, valid

    (g, gv), (w, wv) = columns(got), columns(want)
    for i in range(len(w)):
        same_valid = (gv[i] is None) == (wv[i] is None) and (
            gv[i] is None or np.array_equal(gv[i], wv[i]))
        if not same_valid:
            raise AssertionError(f"{label}: column {i} NULLs differ")
        if g[i].dtype == object:
            same = np.array_equal(g[i], w[i])
        else:
            same = g[i].dtype == w[i].dtype and g[i].tobytes() == w[i].tobytes()
        if not same:
            raise AssertionError(f"{label}: column {i} not bit for bit its solo answer")


def _serve_clients(srv, per_client, timeout=600.0):
    """Closed-loop clients, one thread each: client i submits its queries
    `per_client[i]` one after another, each once the last has answered.
    Returns ({sql: table}, per-query latencies in ms, wall seconds)."""
    import threading

    results, lat, errors = {}, [], []
    lock = threading.Lock()
    start = threading.Barrier(len(per_client))

    def client(sqls):
        try:
            start.wait(timeout)
            for sql in sqls:
                t0 = time.perf_counter()
                table = srv.submit(sql).result(timeout=timeout)
                with lock:
                    lat.append((time.perf_counter() - t0) * 1e3)
                    results[sql] = table
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(sqls,)) for sqls in per_client]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout + 60)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a serving client did not finish")
    return results, lat, wall


SERVE_TOPK = ("SELECT l_returnflag, l_extendedprice, l_quantity FROM lineitem "
              "ORDER BY l_extendedprice DESC LIMIT {}")
SERVE_PIPELINE = ("SELECT l_returnflag, l_quantity, l_extendedprice * (1 - l_discount) "
                  "FROM lineitem WHERE l_shipdate <= '1998-09-02' AND l_discount > {}")


def phase_serve(tdf, cuda_mod, torch, hash_agg, src, cols, dates, smi):
    """The serving front door over the SF-1 lineitem (6,000,000 rows in
    memory), pinned by a Server(workers=2, window_s=0.01,
    megabatch_max=16) over a context of its own:

    - aggregate lane: 8 closed-loop clients, 4 Q1-shaped queries each,
      32 distinct l_shipdate cutoffs; a warm-up round pins the table and
      encodes, then the measured round (launch counters reset just
      before, read just after) must copy nothing to the device
      (`h2d.bytes`) and launch the grouped reduce less than once per
      query; every answer equals its solo run bit for bit and the numpy
      oracle within rtol 1e-9; then the same 32 queries back to back
      without a server;
    - TopK lane: LIMIT 10, 100 and 1000 from 3 concurrent clients, each
      its solo answer exactly, less than one sort launch per query;
    - pipeline lane: the SF-1 filter/project with 8 l_discount literals
      from 8 concurrent clients, each its solo answer exactly;
    - eviction: two 1,000,000-row tables under a DATAFUSION_TPU_HBM_BYTES
      cap that holds one; the second evicts the first, and a third
      table under a cap nothing fits sheds `hbm`.
    `admitted + shed == submitted` on every server."""
    from datafusion_tpu_torch.utils.metrics import METRICS

    def counts():
        snap = METRICS.snapshot()
        return snap["counts"], snap["timings_s"]

    ctx = tdf.ExecutionContext(result_cache=False)
    ctx.register_datasource("lineitem", src)
    cutoffs = [dates[dates.index("1998-09-02") - 7 * i] for i in range(32)]
    sqls = [Q1.replace("1998-09-02", c) for c in cutoffs]
    per_client = [sqls[4 * i:4 * i + 4] for i in range(8)]
    reports = []
    srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=16)
    try:
        t0 = time.perf_counter()
        _serve_clients(srv, per_client)
        log(f"serve aggregate lane: warm-up round (pins, encodes) "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        c0, t0_ = counts()
        cuda_mod.reset_launch_counts()
        served, lat, wall = _serve_clients(srv, per_client)
        launches = cuda_mod.launch_counts()
        multi = hash_agg.MULTI_LAUNCHES
        c1, t1_ = counts()
        stats = srv.stats()
    finally:
        srv.stop()
    if srv.admitted + srv.shed != srv.submitted or srv.shed:
        raise AssertionError(f"serve: admitted {srv.admitted} + shed {srv.shed} != "
                             f"submitted {srv.submitted}")
    h2d = c1.get("h2d.bytes", 0) - c0.get("h2d.bytes", 0)
    encode_ms = (t1_.get("agg.host_encode", 0.0) - t0_.get("agg.host_encode", 0.0)) * 1e3
    mega_q = c1.get("serve.megabatch_queries", 0) - c0.get("serve.megabatch_queries", 0)
    if multi <= 0:
        raise AssertionError("serve aggregate lane: the query axis was not launched")
    if h2d != 0:
        raise AssertionError(f"serve aggregate lane: warm round copied {h2d} bytes")
    if launches["hash_agg"] >= len(sqls):
        raise AssertionError(f"serve aggregate lane: {launches['hash_agg']} grouped-reduce "
                             f"launches for {len(sqls)} queries")
    # the same 32 queries back to back without a server, which are also
    # each query's solo answer
    t0 = time.perf_counter()
    solo = {sql: tdf.collect(ctx.sql(sql)) for sql in sqls}
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    for sql, cutoff in zip(sqls, cutoffs):
        assert_same_bits(served[sql], solo[sql], f"served Q1 <= {cutoff}", key_cols=2)
        assert_rows(served[sql], q1_oracle(cols, dates, cutoff), f"served Q1 <= {cutoff}")
    agg = {
        "lane": "aggregate", "queries": len(sqls), "clients": 8,
        "served_queries_per_s": len(sqls) / wall,
        "sequential_queries_per_s": len(sqls) / seq_wall,
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "launches": launches, "query_axis_launches": multi,
        "grouped_reduce_launches_per_query": launches["hash_agg"] / len(sqls),
        "megabatches": c1.get("serve.megabatches", 0) - c0.get("serve.megabatches", 0),
        "megabatched_queries": mega_q, "h2d_bytes": h2d,
        "host_encode_ms_per_query": encode_ms / len(sqls),
        "verify_ms_per_query": (t1_.get("verify", 0.0) - t0_.get("verify", 0.0)) * 1e3
        / len(sqls),
        "pinned_bytes": stats["pinned_bytes"], "server_p50_s": stats.get("p50_s"),
        "card": card(),
    }
    log("serve: " + json.dumps(agg))
    reports.append(agg)

    # TopK lane: one query per client, all at once
    topk_sqls = [SERVE_TOPK.format(k) for k in (10, 100, 1000)]
    srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=16)
    try:
        _serve_clients(srv, [[s] for s in topk_sqls])
        c0, _ = counts()
        cuda_mod.reset_launch_counts()
        served, lat, wall = _serve_clients(srv, [[s] for s in topk_sqls])
        launches = cuda_mod.launch_counts()
        c1, _ = counts()
    finally:
        srv.stop()
    if srv.admitted + srv.shed != srv.submitted:
        raise AssertionError("serve TopK lane: admitted + shed != submitted")
    if not 0 < launches["sort_kernel"] < len(topk_sqls):
        raise AssertionError(f"serve TopK lane: {launches['sort_kernel']} sort launches for "
                             f"{len(topk_sqls)} queries")
    for sql in topk_sqls:
        assert_same_bits(served[sql], tdf.collect(ctx.sql(sql)), sql[-10:], ordered=True)
    topk = {"lane": "topk", "queries": len(topk_sqls), "launches": launches,
            "sort_launches_per_query": launches["sort_kernel"] / len(topk_sqls),
            "megabatches": c1.get("serve.megabatches", 0) - c0.get("serve.megabatches", 0),
            "megabatched_queries": c1.get("serve.megabatch_queries", 0)
            - c0.get("serve.megabatch_queries", 0),
            "p50_ms": float(np.percentile(lat, 50)), "wall_ms": wall * 1e3, "card": card()}
    log("serve: " + json.dumps(topk))
    reports.append(topk)

    # pipeline lane: 8 l_discount literals from 8 concurrent clients
    pipe_sqls = [SERVE_PIPELINE.format(f"{0.01 * i:.2f}") for i in range(8)]
    srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=16)
    try:
        c0, _ = counts()
        cuda_mod.reset_launch_counts()
        served, lat, wall = _serve_clients(srv, [[s] for s in pipe_sqls])
        launches = cuda_mod.launch_counts()
        c1, _ = counts()
    finally:
        srv.stop()
    if srv.admitted + srv.shed != srv.submitted:
        raise AssertionError("serve pipeline lane: admitted + shed != submitted")
    t0 = time.perf_counter()
    for sql in pipe_sqls:
        assert_same_bits(served[sql], tdf.collect(ctx.sql(sql)), sql[-20:], ordered=True)
    seq_ms = (time.perf_counter() - t0) * 1e3
    pipe = {"lane": "pipeline", "queries": len(pipe_sqls), "launches": launches,
            "megabatches": c1.get("serve.megabatches", 0) - c0.get("serve.megabatches", 0),
            "megabatched_queries": c1.get("serve.megabatch_queries", 0)
            - c0.get("serve.megabatch_queries", 0),
            "passes": c1.get("serve.megabatch_launches", 0)
            - c0.get("serve.megabatch_launches", 0),
            "p50_ms": float(np.percentile(lat, 50)), "wall_ms": wall * 1e3,
            "sequential_with_checks_ms": seq_ms, "card": card()}
    log("serve: " + json.dumps(pipe))
    reports.append(pipe)

    reports.append(_serve_eviction(tdf, torch, cuda_mod))
    return reports


def _serve_eviction(tdf, torch, cuda_mod):
    """Two 1,000,000-row tables under a DATAFUSION_TPU_HBM_BYTES cap
    that holds one of them; then a cap nothing fits under."""
    import gc

    from datafusion_tpu_torch.errors import QueryShedError
    from datafusion_tpu_torch.obs.device import LEDGER
    from datafusion_tpu_torch.serve import PinnedSource

    ctx = tdf.ExecutionContext(result_cache=False)
    tables = {}
    for name, groups in (("a", 16), ("b", 4096), ("c", 16)):
        src, cols = groupby_table(tdf, groups, rows=1_000_000)
        ctx.register_datasource(name, src)
        tables[name] = (cols, groups)
    sql = CONFIG2.replace("FROM t", "FROM {}")
    gc.collect()
    cuda_mod.reset_launch_counts()
    srv = ctx.serve(workers=2, window_s=0.01, megabatch_max=16)
    shed = None
    try:
        got_a = srv.submit(sql.format("a")).result(timeout=600)
        if "table:a" not in LEDGER.pins_snapshot():
            raise AssertionError("serve eviction: table a was not pinned")
        est_b = PinnedSource(ctx.datasources["b"], "b").estimated_bytes()
        cap = LEDGER.live_bytes() + est_b // 2
        os.environ["DATAFUSION_TPU_HBM_BYTES"] = str(cap)
        got_b = srv.submit(sql.format("b")).result(timeout=600)
        pins_b = sorted(LEDGER.pins_snapshot())
        if "table:b" not in pins_b or "table:a" in pins_b:
            raise AssertionError(f"serve eviction: pins {pins_b} after b")
        os.environ["DATAFUSION_TPU_HBM_BYTES"] = "1000"
        try:
            srv.submit(sql.format("c"))
        except QueryShedError as e:
            shed = e.reason
        pins_c = sorted(LEDGER.pins_snapshot())
    finally:
        os.environ.pop("DATAFUSION_TPU_HBM_BYTES", None)
        srv.stop()
    if shed != "hbm":
        raise AssertionError(f"serve eviction: table c was not shed for hbm ({shed})")
    if srv.admitted + srv.shed != srv.submitted or (srv.admitted, srv.shed) != (2, 1):
        raise AssertionError(f"serve eviction: admitted {srv.admitted}, shed {srv.shed}, "
                             f"submitted {srv.submitted}")
    for name, got in (("a", got_a), ("b", got_b)):
        cols, groups = tables[name]
        assert_grouped(got, config2_columns(cols, groups), f"served config 2 over {name}")
    rep = {"lane": "eviction", "cap_bytes": cap, "table_bytes": est_b,
           "pins_after_b": pins_b, "pins_after_c": pins_c, "shed": shed,
           "launches": cuda_mod.launch_counts(), "card": card()}
    log("serve: " + json.dumps(rep))
    return rep


def phase_serve_joins(tdf, cuda_mod, torch, ctx, cols):
    """Q12 over the SF-1 star schema through a Server, 4 times (once,
    then 3 at once): the orders build launches the build kernel once and
    the other 3 probe its pin (`join.build.reuse`); answers equal the
    numpy oracle."""
    from datafusion_tpu_torch.utils.metrics import METRICS

    sctx = tdf.ExecutionContext(result_cache=False)
    for name in ("lineitem", "orders"):
        sctx.register_datasource(name, ctx.datasources[name])
    cuda_mod.reset_launch_counts()
    reuse0 = METRICS.snapshot()["counts"].get("join.build.reuse", 0)
    srv = sctx.serve(workers=2, window_s=0.01, megabatch_max=16)
    try:
        first, lat0, _ = _serve_clients(srv, [[Q12]])
        rest = []
        for _ in range(3):
            rest.append(srv.submit(Q12))
        tables = [first[Q12]] + [t.result(timeout=600) for t in rest]
    finally:
        srv.stop()
    launches = cuda_mod.launch_counts()
    reuse = METRICS.snapshot()["counts"].get("join.build.reuse", 0) - reuse0
    for t in tables:
        if t.to_rows() != q12_oracle(cols):
            raise AssertionError("served Q12 differs from the numpy oracle")
    if launches["hash_build"] != 1 or reuse != 3:
        raise AssertionError(f"served Q12: {launches['hash_build']} builds, {reuse} reuses "
                             "(want 1 and 3)")
    if srv.admitted + srv.shed != srv.submitted:
        raise AssertionError("served Q12: admitted + shed != submitted")
    rep = {"lane": "join", "query": "Q12", "submitted": 4, "launches": launches,
           "build_reuse": reuse, "first_ms": lat0[0], "card": card()}
    log("serve: " + json.dumps(rep))
    return rep


# ------------------------------------------------------------ phase 12


def golden_lines(text):
    """The reference smoketest's golden rule (its own copy of
    tests/test_cli.py's): the banner and blank lines dropped, trailing
    spaces stripped, lines holding "seconds" ignored."""
    return [line.rstrip() for line in text.splitlines()
            if line.strip() and "seconds" not in line and line != "DataFusion Console"]


class PrintedRows:
    """The tab-separated rows a console printed, typed by `kinds` (str,
    float or int per column), for `assert_rows`."""

    def __init__(self, text, kinds):
        self.rows = [tuple(k(v) for k, v in zip(kinds, line.split("\t")))
                     for line in text.splitlines() if "\t" in line]

    def to_rows(self):
        return self.rows


def write_csv(path, header, columns):
    """`columns` (numpy arrays, strings as str arrays) as one CSV with a
    header, floats in their shortest round-trip form."""
    fmt = ",".join("{!r}" if c.dtype.kind == "f" else "{}" for c in columns) + "\n"
    fmt = fmt.format
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(",".join(header) + "\n")
        for lo in range(0, len(columns[0]), 1 << 18):
            f.write("".join(map(fmt, *(c[lo:lo + (1 << 18)].tolist() for c in columns))))
    os.replace(tmp, path)


def run_console(tdf, cuda_mod, torch, console, script_path, sql_text):
    """One console script (`cli.run_script`) with the launch counters set
    to 0 just before and read just after.  Returns (printed text, ms,
    launches); any `Error:` line fails."""
    import io

    from datafusion_tpu_torch.cli import run_script

    with open(script_path, "w") as f:
        f.write(sql_text)
    console.out = io.StringIO()
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    run_script(console, script_path)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = cuda_mod.launch_counts()
    text = console.out.getvalue()
    errors = [line for line in text.splitlines() if line.startswith("Error")]
    if errors:
        raise AssertionError(f"console: {errors}")
    return text, ms, launches


LINEITEM_DDL = ("CREATE EXTERNAL TABLE lineitem (l_returnflag VARCHAR(1), "
                "l_linestatus VARCHAR(1), l_quantity DOUBLE, l_extendedprice DOUBLE, "
                "l_discount DOUBLE, l_tax DOUBLE, l_shipdate VARCHAR(10)) "
                "STORED AS CSV WITH HEADER ROW LOCATION '{}';\n")
STAR_DDL = ("CREATE EXTERNAL TABLE orders (o_orderkey BIGINT, o_custkey BIGINT, "
            "o_orderdate VARCHAR(10), o_shippriority BIGINT) STORED AS CSV WITH HEADER ROW "
            "LOCATION '{}';\n"
            "CREATE EXTERNAL TABLE lineitem (l_orderkey BIGINT, l_quantity BIGINT, "
            "l_extendedprice DOUBLE, l_discount DOUBLE, l_shipmode BIGINT) STORED AS CSV "
            "WITH HEADER ROW LOCATION '{}';\n")
Q1_KINDS = (str, str) + (float,) * 7 + (int,)
BAD_GROUP_BY = "SELECT l_returnflag, COUNT(1) FROM lineitem GROUP BY l_quantity % 3"
NDJSON_SQL = "SELECT b, COUNT(1), SUM(c), MAX(a) FROM j GROUP BY b"


def q1_dataframe(tdf, df):
    """TPC-H Q1 through the DataFrame API: the same eight aggregates."""
    f, lit, c = tdf.f, tdf.lit, df.col
    disc_price = c("l_extendedprice") * (lit(1.0) - c("l_discount"))
    charge = disc_price * (lit(1.0) + c("l_tax"))
    return (df.filter(c("l_shipdate").lt_eq(lit("1998-09-02")))
            .aggregate(["l_returnflag", "l_linestatus"],
                       [f.sum(c("l_quantity")), f.sum(c("l_extendedprice")),
                        f.sum(disc_price), f.sum(charge), f.avg(c("l_quantity")),
                        f.avg(c("l_extendedprice")), f.avg(c("l_discount")), f.count()]))


def phase_console(tdf, cuda_mod, torch, src, cols, dates, star, smi):
    """The console and the rest of the SQL front door on cuda:0
    (datafusion_tpu_torch/cli.py, exec/context.py, dataframe.py,
    analysis/verify.py, io/readers.py):

    1. the reference's smoketest through `cli.main(["--script", ...])`,
       its output equal to test/data/smoketest-expected.txt under the
       golden rule;
    2. TPC-H Q1 at SF-1 through a console script: the lineitem columns
       of phase 3 written as one CSV with a header, CREATE EXTERNAL
       TABLE, then Q1 (cold), then Q1 once more (warm); rows equal to
       `q1_oracle`, 6 grouped-reduce launches a batch group;
    3. Q12 at SF-1 through a console script over star_sf1's orders and
       lineitem written as CSV: rows and order equal to `q12_oracle`, 1
       build launch (dense) and 1 sort launch;
    4. Q1 through the DataFrame API over the in-memory SF-1 lineitem,
       equal to `q1_oracle` with SQL Q1's launches; both p50s from warm
       runs in turns;
    5. EXPLAIN and EXPLAIN VERIFY of Q1 give their result types, and a
       computed GROUP BY key raises PlanVerificationError before any
       launch;
    6. an NDJSON table (test/data/example1.ndjson) by DDL and a GROUP BY
       over it through the console, equal to a numpy oracle over
       json.loads of the file.
    Returns the reports whose launches the `kernels` line counts."""
    import gc
    import io
    from contextlib import redirect_stdout

    from datafusion_tpu_torch import cli
    from datafusion_tpu_torch.errors import PlanVerificationError

    gc.collect()
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(here, "test", "data")
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    reports = []

    # 1. the reference's smoketest, its fixtures at this checkout
    with open(os.path.join(data, "smoketest.sql")) as f:
        sql = f.read().replace("'/test/data/", f"'{data}/")
    script = os.path.join(out_dir, "smoketest.sql")
    with open(script, "w") as f:
        f.write(sql)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = cli.main(["--script", script])
    smoke_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(data, "smoketest-expected.txt")) as f:
        want = golden_lines(f.read())
    if rc != 0 or golden_lines(buf.getvalue()) != want:
        raise AssertionError(f"console smoketest (rc {rc}) differs from the golden output:\n"
                             + buf.getvalue()[:2000])
    if not buf.getvalue().startswith("DataFusion Console"):
        raise AssertionError("console smoketest: no banner")
    log(f"console smoketest matches test/data/smoketest-expected.txt "
        f"({len(want)} lines, {smoke_ms:.3f} ms; {smi})")

    # 2. Q1 at SF-1 through the console, over a CSV lineitem
    path = os.path.join(out_dir, f"lineitem_q1_{SF1_ROWS}.csv")
    t0 = time.perf_counter()
    write_csv(path, ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                     "l_discount", "l_tax", "l_shipdate"],
              [np.array(["A", "N", "R"])[cols["flag"]], np.array(["F", "O"])[cols["status"]],
               cols["qty"], cols["price"], cols["disc"], cols["tax"],
               np.array(dates)[cols["ship"]]])
    write_s = time.perf_counter() - t0
    console = cli.Console(cli.make_context())
    text, cold_ms, launches = run_console(tdf, cuda_mod, torch, console,
                                          os.path.join(out_dir, "q1.sql"),
                                          LINEITEM_DDL.format(path) + Q1 + ";\n")
    assert_rows(PrintedRows(text, Q1_KINDS), q1_oracle(cols, dates), "console Q1")
    nb = -(-SF1_ROWS // console.ctx.batch_size)
    rep = {"query": "console_tpch_q1_sf1_csv", "rows": SF1_ROWS, "launches": launches}
    expect_launches(rep, "console Q1", hash_agg=6 * fold_groups(nb))
    warm_text, warm_ms, warm_launches = run_console(tdf, cuda_mod, torch, console,
                                                    os.path.join(out_dir, "q1_warm.sql"),
                                                    Q1 + ";\n")
    if PrintedRows(warm_text, Q1_KINDS).rows != PrintedRows(text, Q1_KINDS).rows:
        raise AssertionError("console Q1: the warm run printed other rows")
    reader = console.ctx.datasources["lineitem"]
    t0 = time.perf_counter()
    for _ in reader.batches():
        pass
    scan_ms = (time.perf_counter() - t0) * 1e3
    rep.update({"csv_bytes": os.path.getsize(path), "csv_write_s": write_s,
                "cold_ms": cold_ms, "warm_ms": warm_ms, "warm_launches": warm_launches,
                "scan_only_ms": scan_ms, "parse_share_of_warm": scan_ms / warm_ms,
                "card": card()})
    log("console_q1: " + json.dumps(rep))
    log(f"console Q1 over a CSV lineitem matches the numpy oracle ({nb} batches)")
    reports.append(rep)
    del console, reader

    # 3. Q12 at SF-1 through the console, over CSV orders and lineitem
    orders_path = os.path.join(out_dir, "orders_q12.csv")
    lineitem_path = os.path.join(out_dir, "lineitem_q12.csv")
    d_date = np.array([f"1995-{m:02d}-{d:02d}" for m in range(1, 13) for d in range(1, 29)])
    t0 = time.perf_counter()
    n_orders = len(star["o_custkey"])
    write_csv(orders_path, ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
              [np.arange(n_orders), star["o_custkey"], d_date[star["o_date"]],
               star["o_shippriority"]])
    write_csv(lineitem_path, ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
                              "l_shipmode"],
              [star["l_orderkey"], star["l_quantity"], star["l_extendedprice"],
               star["l_discount"], star["l_shipmode"]])
    write_s = time.perf_counter() - t0
    console = cli.Console(cli.make_context())
    text, cold_ms, launches = run_console(
        tdf, cuda_mod, torch, console, os.path.join(out_dir, "q12.sql"),
        STAR_DDL.format(orders_path, lineitem_path) + Q12 + ";\n")
    got = PrintedRows(text, (int, int)).rows
    if got != q12_oracle(star):
        raise AssertionError(f"console Q12: {got} != {q12_oracle(star)}")
    nb = -(-len(star["l_orderkey"]) // console.ctx.batch_size)
    rep = {"query": "console_tpch_q12_sf1_csv", "rows": len(star["l_orderkey"]),
           "launches": launches}
    expect_launches(rep, "console Q12", hash_build=1, sort_kernel=1,
                    hash_agg=fold_groups(nb))
    t0 = time.perf_counter()
    rel = console.ctx.sql(Q12)
    if tdf.collect(rel).to_rows() != got or join_routes(rel) != [True]:
        raise AssertionError("console Q12: a second run differs or the orders build "
                             "is not dense")
    torch.cuda.synchronize()
    rep.update({"csv_write_s": write_s, "cold_ms": cold_ms,
                "warm_ms": (time.perf_counter() - t0) * 1e3, "card": card()})
    log("console_q12: " + json.dumps(rep))
    log("console Q12 rows and order match the numpy oracle; orders build dense")
    reports.append(rep)
    del console, rel

    # 4. Q1 through the DataFrame API, beside SQL Q1, over the in-memory lineitem
    ctx = cli.make_context()
    ctx.register_datasource("lineitem", src)
    nb = len(list(src.batches()))
    table, sql_rep, _ = run_query(tdf, cuda_mod, torch, ctx, Q1, "console_ctx_tpch_q1_sf1",
                                  SF1_ROWS)
    frame = q1_dataframe(tdf, ctx.table("lineitem"))
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    df_table = frame.collect()
    torch.cuda.synchronize()
    df_cold = (time.perf_counter() - t0) * 1e3
    df_launches = cuda_mod.launch_counts()
    assert_rows(df_table, q1_oracle(cols, dates), "DataFrame Q1")

    def timed(run):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # warm runs in turns (SQL, DataFrame, DataFrame, SQL, ...): the host
    # clock drifts over a process, so only interleaved p50s compare
    runs = {"sql": lambda: tdf.collect(ctx.sql(Q1)), "dataframe": frame.collect}
    times = {"sql": [], "dataframe": []}
    for turn in range(2 * WARM_RUNS + 1):
        for name in (("sql", "dataframe") if turn % 2 == 0 else ("dataframe", "sql")):
            times[name].append(timed(runs[name]))
    rep = {"query": "dataframe_tpch_q1_sf1", "rows": SF1_ROWS, "launches": df_launches,
           "cold_ms": df_cold, "warm_ms": times["dataframe"],
           "p50_ms": float(np.median(times["dataframe"])),
           "sql_warm_ms": times["sql"], "sql_p50_ms": float(np.median(times["sql"])),
           "sql_launches": sql_rep["launches"], "card": card()}
    expect_launches(rep, "DataFrame Q1", hash_agg=6 * fold_groups(nb))
    if df_launches != sql_rep["launches"]:
        raise AssertionError(f"DataFrame Q1 launches {df_launches}, SQL Q1 "
                             f"{sql_rep['launches']}")
    log("dataframe_q1: " + json.dumps(rep))
    log("DataFrame Q1 matches the numpy oracle with SQL Q1's launches")
    reports += [sql_rep, rep]

    # 5. EXPLAIN, EXPLAIN VERIFY and the verifier on the card's context
    if not isinstance(ctx.sql("EXPLAIN " + Q1), tdf.ExplainResult):
        raise AssertionError("EXPLAIN Q1 did not return an ExplainResult")
    verified = ctx.sql("EXPLAIN VERIFY " + Q1)
    if not isinstance(verified, tdf.ExplainVerifyResult) or not verified.ok:
        raise AssertionError(f"EXPLAIN VERIFY Q1: {verified!r}")
    cuda_mod.reset_launch_counts()
    try:
        ctx.sql(BAD_GROUP_BY)
    except PlanVerificationError as e:
        rejected = str(e)
    else:
        raise AssertionError("a computed GROUP BY key was not rejected")
    if any(cuda_mod.launch_counts().values()):
        raise AssertionError(f"the rejected plan launched {cuda_mod.launch_counts()}")
    log(f"EXPLAIN and EXPLAIN VERIFY of Q1 ok; {BAD_GROUP_BY!r} rejected before any "
        f"launch: {rejected}")
    del ctx

    # 6. an NDJSON table through the console
    console = cli.Console(cli.make_context())
    ndjson = os.path.join(data, "example1.ndjson")
    text, ms, launches = run_console(
        tdf, cuda_mod, torch, console, os.path.join(out_dir, "ndjson.sql"),
        f"CREATE EXTERNAL TABLE j (a BIGINT, b VARCHAR, c DOUBLE) STORED AS NDJSON "
        f"LOCATION '{ndjson}';\n{NDJSON_SQL};\n")
    with open(ndjson) as f:
        objs = [json.loads(line) for line in f if line.strip()]
    keys = sorted({o["b"] for o in objs})
    want = [(k, sum(1 for o in objs if o["b"] == k),
             float(np.sum([o["c"] for o in objs if o["b"] == k])),
             max(o["a"] for o in objs if o["b"] == k)) for k in keys]
    got = sorted(PrintedRows(text, (str, int, float, int)).rows)
    if got != want:
        raise AssertionError(f"console NDJSON: {got} != {want}")
    rep = {"query": "console_ndjson_groupby", "rows": len(objs), "launches": launches,
           "cold_ms": ms, "card": card()}
    if launches["hash_agg"] <= 0:
        raise AssertionError(f"console NDJSON: launches {launches}")
    log("console_ndjson: " + json.dumps(rep))
    reports.append(rep)
    return reports


# ------------------------------------------------------------ phase 12b

# Parquet test data: a writer kept here (no pyarrow on the card's
# machine), in the layout benchmarks/data.py's pyarrow writer gives
# lineitem: row groups of 1,000,000 rows, OPTIONAL columns, the Utf8
# columns and the low-cardinality doubles RLE_DICTIONARY, l_extendedprice
# PLAIN, data pages (v1) of at most 1 MiB, SNAPPY (literals only).
PARQUET_ROW_GROUP = 1_000_000  # benchmarks/data.py's _CHUNK
PARQUET_PAGE_BYTES = 1 << 20
PQ_BYTE_ARRAY, PQ_DOUBLE = 6, 5
PQ_PLAIN, PQ_RLE, PQ_RLE_DICTIONARY = 0, 3, 8
PQ_SNAPPY = 1


def _uvarint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tc_struct(*fields):
    """A Thrift compact-protocol struct: `fields` are (id, kind, value)
    in rising id order, kind "i32", "i64", "bin", "struct" (value
    already encoded) or ("list", element kind); None values are left out."""
    codes = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}
    out, last = bytearray(), 0
    for fid, kind, value in fields:
        if value is None:
            continue
        code = 9 if isinstance(kind, tuple) else codes[kind]
        out.append(((fid - last) << 4) | code)  # ids here rise by 1 to 15
        last = fid
        if isinstance(kind, tuple):
            ek = kind[1]
            n = len(value)
            out.append((n << 4 | codes[ek]) if n < 15 else (0xF0 | codes[ek]))
            if n >= 15:
                out += _uvarint(n)
            for v in value:
                out += _tc_value(ek, v)
        else:
            out += _tc_value(kind, value)
    out.append(0)
    return bytes(out)


def _tc_value(kind, v):
    if kind in ("i32", "i64"):
        return _uvarint((v << 1) ^ (v >> 63))
    if kind == "bin":
        return _uvarint(len(v)) + v
    return v  # an encoded struct


def _snappy_literal(raw):
    """`raw` as raw-format Snappy holding one literal (valid Snappy that
    a decoder must copy through)."""
    n = len(raw)
    if n == 0:
        return b"\x00"
    assert n <= 1 << 24
    return _uvarint(n) + bytes([62 << 2]) + (n - 1).to_bytes(3, "little") + raw


def _page(kind, encoding, n, uncompressed):
    """One SNAPPY page with its header: kind "dict" or "data" (whose
    values are in `encoding`)."""
    body = _snappy_literal(uncompressed)
    if kind == "dict":
        sub = (7, "struct", _tc_struct((1, "i32", n), (2, "i32", PQ_PLAIN)))
        ptype = 2
    else:
        sub = (5, "struct", _tc_struct((1, "i32", n), (2, "i32", encoding), (3, "i32", PQ_RLE),
                                       (4, "i32", PQ_RLE)))
        ptype = 0
    header = _tc_struct((1, "i32", ptype), (2, "i32", len(uncompressed)),
                        (3, "i32", len(body)), sub)
    return header + body, len(header) + len(uncompressed)


def _all_valid_levels(n):
    """Definition levels of n non-NULL rows: a 4-byte length, one RLE run."""
    run = _uvarint(n << 1) + b"\x01"
    return len(run).to_bytes(4, "little") + run


def _bit_pack(idx, bw):
    """Dictionary indices as one bit-packed run of the RLE/bit-packed
    hybrid, led by the bit-width byte (padded to 8 values with 0)."""
    pad = (-len(idx)) % 8
    idx = np.concatenate([idx.astype(np.uint32), np.zeros(pad, np.uint32)])
    bits = ((idx[:, None] >> np.arange(bw, dtype=np.uint32)) & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    return bytes([bw]) + _uvarint(((len(idx) // 8) << 1) | 1) + packed


def _chunk_pages(kind, values, dictionary):
    """(pages, uncompressed bytes, has a dictionary page) of one column
    chunk: PLAIN doubles, or a dictionary page and RLE_DICTIONARY
    indices (`values` then index `dictionary`, doubles or byte strings)."""
    n = len(values)
    pages, total = [], 0
    levels_room = 16
    if kind == "plain":
        per = (PARQUET_PAGE_BYTES - levels_room) // 8
        for lo in range(0, n, per):
            v = values[lo:lo + per]
            page, size = _page("data", PQ_PLAIN, len(v),
                               _all_valid_levels(len(v)) + v.astype("<f8").tobytes())
            pages.append(page)
            total += size
        return pages, total, False
    if dictionary.dtype.kind == "f":
        dict_bytes = dictionary.astype("<f8").tobytes()
    else:
        dict_bytes = b"".join(len(s).to_bytes(4, "little") + s for s in dictionary)
    page, size = _page("dict", None, len(dictionary), dict_bytes)
    pages.append(page)
    total += size
    bw = max(1, int(len(dictionary) - 1).bit_length())
    per = ((PARQUET_PAGE_BYTES - levels_room - 8) * 8 // bw) // 8 * 8
    for lo in range(0, n, per):
        v = values[lo:lo + per]
        page, size = _page("data", PQ_RLE_DICTIONARY, len(v),
                           _all_valid_levels(len(v)) + _bit_pack(v, bw))
        pages.append(page)
        total += size
    return pages, total, True


def write_parquet(path, columns, rows_per_group=PARQUET_ROW_GROUP):
    """`columns` as one Parquet file: a list of (name, physical type
    PQ_DOUBLE or PQ_BYTE_ARRAY, kind "plain" or "dict", values,
    dictionary); a "dict" column's values index its dictionary (doubles
    or byte strings), a "plain" column's values are doubles.  Every
    column is OPTIONAL with no NULL; the Utf8 ones carry the UTF8
    annotation.  Returns the file's size."""
    n = len(columns[0][3])
    tmp = f"{path}.{os.getpid()}.tmp"
    groups = []
    with open(tmp, "wb") as f:
        f.write(b"PAR1")
        offset = 4
        for lo in range(0, n, rows_per_group):
            hi = min(n, lo + rows_per_group)
            chunks, group_bytes = [], 0
            for name, ptype, kind, values, dictionary in columns:
                pages, usize, has_dict = _chunk_pages(kind, values[lo:hi], dictionary)
                start = offset
                data_at = start + (len(pages[0]) if has_dict else 0)
                for page in pages:
                    f.write(page)
                    offset += len(page)
                csize = offset - start
                group_bytes += usize
                meta = _tc_struct(
                    (1, "i32", ptype),
                    (2, ("list", "i32"), [PQ_PLAIN, PQ_RLE] + ([PQ_RLE_DICTIONARY]
                                                               if has_dict else [])),
                    (3, ("list", "bin"), [name.encode()]), (4, "i32", PQ_SNAPPY),
                    (5, "i64", hi - lo), (6, "i64", usize), (7, "i64", csize),
                    (9, "i64", data_at), (11, "i64", start if has_dict else None))
                chunks.append(_tc_struct((2, "i64", start), (3, "struct", meta)))
            groups.append(_tc_struct((1, ("list", "struct"), chunks),
                                     (2, "i64", group_bytes), (3, "i64", hi - lo)))
        schema = [_tc_struct((4, "bin", b"schema"), (5, "i32", len(columns)))]
        for name, ptype, _, _, _ in columns:
            utf8 = ptype == PQ_BYTE_ARRAY
            schema.append(_tc_struct(
                (1, "i32", ptype), (3, "i32", 1), (4, "bin", name.encode()),
                (6, "i32", 0 if utf8 else None),
                (10, "struct", _tc_struct((1, "struct", b"\x00")) if utf8 else None)))
        footer = _tc_struct((1, "i32", 1), (2, ("list", "struct"), schema), (3, "i64", n),
                            (4, ("list", "struct"), groups),
                            (6, "bin", b"datafusion_tpu_torch chip_smoke.py"))
        f.write(footer + len(footer).to_bytes(4, "little") + b"PAR1")
    os.replace(tmp, path)
    return os.path.getsize(path)


def parquet_batches(rows, batch):
    """The batches a scan of `write_parquet`'s file of `rows` rows yields
    (a batch never spans a row group)."""
    return sum(-(-min(PARQUET_ROW_GROUP, rows - lo) // batch)
               for lo in range(0, rows, PARQUET_ROW_GROUP))


def write_lineitem_parquet(path, cols, dates, lo=0, hi=None):
    """Rows [lo, hi) of `lineitem_sf1`'s columns as Parquet
    (`write_parquet`): l_returnflag, l_linestatus and l_shipdate coded
    into lineitem_sf1's dictionaries, l_quantity, l_discount and l_tax
    into their distinct values, l_extendedprice PLAIN."""
    hi = len(cols["flag"]) if hi is None else hi

    def coded(x):
        uniq, codes = np.unique(x[lo:hi], return_inverse=True)
        return codes.reshape(-1), uniq

    def strings(values):
        return np.array([s.encode() for s in values], dtype=object)

    qty, disc, tax = coded(cols["qty"]), coded(cols["disc"]), coded(cols["tax"])
    return write_parquet(path, [
        ("l_returnflag", PQ_BYTE_ARRAY, "dict", cols["flag"][lo:hi], strings("ANR")),
        ("l_linestatus", PQ_BYTE_ARRAY, "dict", cols["status"][lo:hi], strings("FO")),
        ("l_quantity", PQ_DOUBLE, "dict", *qty),
        ("l_extendedprice", PQ_DOUBLE, "plain", cols["price"][lo:hi], None),
        ("l_discount", PQ_DOUBLE, "dict", *disc),
        ("l_tax", PQ_DOUBLE, "dict", *tax),
        ("l_shipdate", PQ_BYTE_ARRAY, "dict", cols["ship"][lo:hi], strings(dates)),
    ])


def _table_columns(table):
    return [list(c) for c in zip(*table.to_rows())]


def phase_parquet(tdf, cuda_mod, torch, cols, dates, smi):
    """Parquet on cuda:0 through the port's own reader
    (datafusion_tpu_torch/native/parquet.cpp; no pyarrow here):

    1. the fixtures `uk_cities.parquet` and `all_types_flat.parquet`
       registered by CREATE EXTERNAL TABLE (schemas inferred), value for
       value against the native CSV reads of their twins `uk_cities.csv`
       and `all_types_flat.csv` under the same schema; the one cell
       where a fixture and its twin differ (`all_types_flat` row 129,
       c_utf8: the Parquet value leads with U+0015, the CSV's does not,
       as tests/test_torch_parquet.py pins) is held to that;
    2. `lineitem_sf1`'s columns written as one Parquet file by
       `write_lineitem_parquet` (6 row groups of 1,000,000 rows), then
       TPC-H Q1 through CREATE EXTERNAL TABLE ... STORED AS PARQUET,
       once cold and WARM_RUNS times warm, against `q1_oracle`, 6
       grouped-reduce launches a batch group, with its device and host
       profile (`profile_parquet_tpch_q1_sf1`); the scan alone timed 3
       times.  `parquet_*` lines; returns the report the `kernels` line
       counts."""
    import gc

    gc.collect()
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(here, "test", "data")
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    reports = []

    # 1. the fixtures against their CSV twins
    ctx = tdf.ExecutionContext(result_cache=False)  # cuda:0
    for name in ("uk_cities", "all_types_flat"):
        t0 = time.perf_counter()
        ctx.sql(f"CREATE EXTERNAL TABLE pq_{name} STORED AS PARQUET "
                f"LOCATION '{data}/{name}.parquet'")
        schema = ctx.datasources[f"pq_{name}"].schema
        ctx.register_csv(f"csv_{name}", os.path.join(data, f"{name}.csv"), schema,
                         has_header=False)
        got = _table_columns(tdf.collect(ctx.sql(f"SELECT * FROM pq_{name}")))
        want = _table_columns(tdf.collect(ctx.sql(f"SELECT * FROM csv_{name}")))
        ms = (time.perf_counter() - t0) * 1e3
        if len(got) != len(want) or len(got[0]) != len(want[0]):
            raise AssertionError(f"{name}.parquet: shape differs from its CSV twin")
        diffs = [(f.name, i) for f, g, w in zip(schema.fields, got, want)
                 for i, (a, b) in enumerate(zip(g, w))
                 if not (a == b or (a != a and b != b))]
        pinned = [("c_utf8", 129)] if name == "all_types_flat" else []
        if diffs != pinned:
            raise AssertionError(f"{name}.parquet differs from its CSV twin at {diffs[:10]}")
        for col, i in pinned:
            j = schema.names().index(col)
            if got[j][i] != "\x15" + want[j][i]:
                raise AssertionError(f"{name}.parquet {col}[{i}]: {got[j][i]!r}")
        log(f"parquet_fixture: {name}.parquet equals {name}.csv value for value "
            f"({len(got[0])} rows x {len(got)} columns"
            + (f"; {pinned} as pinned" if pinned else "") + f", {ms:.3f} ms; {smi})")
    del ctx

    # 2. Q1 over the SF-1 lineitem as Parquet
    path = os.path.join(out_dir, f"lineitem_q1_{SF1_ROWS}.parquet")
    t0 = time.perf_counter()
    nbytes = write_lineitem_parquet(path, cols, dates)
    write_s = time.perf_counter() - t0
    ctx = tdf.ExecutionContext(result_cache=False)  # cuda:0
    t0 = time.perf_counter()
    ctx.sql(f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION '{path}'")
    ddl_ms = (time.perf_counter() - t0) * 1e3
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, Q1, "parquet_tpch_q1_sf1", SF1_ROWS)
    assert_rows(table, q1_oracle(cols, dates), "Parquet Q1")
    src = ctx.datasources["lineitem"]
    nb = parquet_batches(SF1_ROWS, ctx.batch_size)
    scan_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        if sum(1 for _ in src.batches()) != nb:
            raise AssertionError(f"Parquet scan: batches other than {nb}")
        scan_ms.append((time.perf_counter() - t0) * 1e3)
    expect_launches(rep, "Parquet Q1", hash_agg=6 * fold_groups(nb))
    try:
        query_profile(tdf, torch, ctx, Q1, "parquet_tpch_q1_sf1", rep["p50_ms"])
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
    rep.update({"parquet_bytes": nbytes, "write_s": write_s, "ddl_ms": ddl_ms,
                "batches": nb, "scan_only_ms": scan_ms,
                "scan_share_of_warm": float(np.median(scan_ms)) / rep["p50_ms"]})
    log("parquet_q1: " + json.dumps(rep))
    log(f"Parquet Q1 at SF-1 matches the numpy oracle cold and warm ({nb} batches, "
        f"{nbytes} bytes)")
    reports.append(rep)
    return reports


# ------------------------------------------------------------ phase 13

# the CSV bridge's Python frames that split a cold scan's decode phase
# with the native parse (native/csv.py): a sample whose stack holds one
# of them is the bridge's; the rest of the reader generator's samples
# wait in `dtf_csv_next` (a C call adds no Python frame of its own)
CSV_BRIDGE = ("_view", "_grow_lut", "make_host_batch")
EXPLAIN_TURNS = 7


def _frame_name(label: str) -> str:
    return label.split(" (", 1)[0]


def csv_parse_split(report) -> dict:
    """The decode phase's samples of a profiled CSV scan: the bridge's
    Python frames (`CSV_BRIDGE`), the frame that calls `dtf_csv_next`
    (the reader generator `_batches` of native/csv.py at the leaf), and
    the rest."""
    split = {"dtf_csv_next": 0, **{f: 0 for f in CSV_BRIDGE}, "other": 0}
    for (_tid, phase, frames), n in report.stacks.items():
        if phase != "decode":
            continue
        names = [_frame_name(f) for f in frames]
        hit = next((f for f in CSV_BRIDGE if f in names), None)
        if hit is not None:
            split[hit] += n
        elif frames and frames[-1].startswith("_batches (native/csv.py"):
            split["dtf_csv_next"] += n
        else:
            split["other"] += n
    return split


def phase_explain(tdf, cuda_mod, torch, star_ctx, li_src, li_cols, dates, star, cities, smi):
    """Per-query observability on cuda:0 (obs/explain.py, obs/device.py,
    obs/profiler.py, utils/profiling.py):

    1. EXPLAIN ANALYZE of Q1 at SF-1 over the phase-3 lineitem: rows
       equal to `q1_oracle`, the fold's 6 grouped-reduce launches, the
       phase bar's "execute" (CUDA events under profile_sync) above 0
       and within the wall; the report printed;
    2. Q1's warm p50 plain, under EXPLAIN ANALYZE with the host profiler
       and without it (DATAFUSION_TPU_PROFILE_EXPLAIN=0): EXPLAIN_TURNS
       runs each, in turns; no gate: what the trace costs;
    3. EXPLAIN ANALYZE of Q10 at SF-1 (the encoder's general path):
       rows equal to `q10_columns`, 3 dense builds and 1 sort, the host
       profile's top frames per phase;
    4. bench config 1 cold (phase 7's CSV) under a profiler capture: the
       decode phase's samples split between the frame that calls
       `dtf_csv_next` and the bridge's `_view`, `_grow_lut` and
       `make_host_batch` (`csv_parse_split`);
    5. `utils/profiling.trace` over one Q1 run: the written Chrome trace
       holds the grouped reduce's kernel events;
    6. the console's `\\hbm` report after Q1, beside
       `torch.cuda.memory_allocated()`."""
    from datafusion_tpu_torch.obs import profiler
    from datafusion_tpu_torch.obs.device import LEDGER
    from datafusion_tpu_torch.utils.profiling import trace

    reports = []
    ctx = tdf.ExecutionContext(batch_size=star_ctx.batch_size, result_cache=False)
    ctx.register_datasource("lineitem", li_src)
    nb = len(list(li_src.batches()))

    def explain(c, sql, label, needs):
        cuda_mod.reset_launch_counts()
        t0 = time.perf_counter()
        res = c.sql("EXPLAIN ANALYZE " + sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = cuda_mod.launch_counts()
        for name in needs:
            if launches[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched")
        if not 0 < res.phases["execute"] <= res.wall_s:
            raise AssertionError(f"{label}: execute {res.phases['execute']} s outside "
                                 f"(0, wall {res.wall_s} s]")
        for line in res.report().splitlines():
            log(f"{label} | {line}")
        rep = {"query": label, "rows": SF1_ROWS, "cold_ms": ms, "launches": launches,
               "wall_ms": res.wall_s * 1e3,
               "phase_ms": {k: v * 1e3 for k, v in res.phases.items()},
               "counters": res.counters, "hbm": res.hbm, "card": smi}
        log(f"{label}: " + json.dumps(rep))
        return res, rep

    # 1. Q1
    res, rep = explain(ctx, Q1, "explain_tpch_q1_sf1", ("hash_agg",))
    assert_rows(res.result, q1_oracle(li_cols, dates), "EXPLAIN ANALYZE Q1")
    expect_launches(rep, "EXPLAIN ANALYZE Q1", hash_agg=6 * fold_groups(nb))
    reports.append(rep)

    # 6. \hbm after Q1
    from datafusion_tpu_torch.cli import Console

    out = io.StringIO()
    Console(ctx, out=out).handle_command("\\hbm")
    for line in out.getvalue().splitlines():
        log(f"hbm | {line}")
    log("hbm: " + json.dumps({"ledger_live_bytes": LEDGER.buffer_bytes(),
                              "ledger_peak_bytes": LEDGER.peak_bytes(),
                              "cuda_memory_allocated": torch.cuda.memory_allocated(),
                              "card": smi}))

    # 2. the trace's cost on Q1, in turns
    def plain():
        tdf.collect(ctx.sql(Q1))

    def traced():
        ctx.sql("EXPLAIN ANALYZE " + Q1)

    def traced_no_profile():
        os.environ["DATAFUSION_TPU_PROFILE_EXPLAIN"] = "0"
        try:
            ctx.sql("EXPLAIN ANALYZE " + Q1)
        finally:
            del os.environ["DATAFUSION_TPU_PROFILE_EXPLAIN"]

    runs = {"plain": plain, "explain_profiled": traced, "explain_unprofiled": traced_no_profile}
    times = {k: [] for k in runs}
    names = list(runs)
    for turn in range(EXPLAIN_TURNS):
        for name in names[turn % 3:] + names[:turn % 3]:
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    log("explain_cost: " + json.dumps({
        "query": "tpch_q1_sf1", "warm_ms": times,
        **{f"{k}_p50_ms": float(np.median(v)) for k, v in times.items()}, "card": smi}))

    # 3. Q10 over the star schema
    res, rep = explain(star_ctx, Q10, "explain_tpch_q10_sf1", ("hash_build", "sort_kernel"))
    assert_grouped(res.result, q10_columns(star), "EXPLAIN ANALYZE Q10")
    if rep["launches"]["hash_build"] != 3:
        raise AssertionError(f"EXPLAIN ANALYZE Q10: launches {rep['launches']}")
    prof = res.host_profile
    if prof is None or not prof.samples:
        raise AssertionError("EXPLAIN ANALYZE Q10 took no host samples")
    log("explain_q10_profile: " + json.dumps({
        "summary": prof.summary(), "phases": prof.by_phase(6), "card": smi}))
    reports.append(rep)

    # 4. config 1 cold under the profiler
    path, schema, want = cities
    cuda_mod.reset_launch_counts()
    with profiler.profile(name="config1_cold") as cap:
        c1 = tdf.ExecutionContext(batch_size=1 << 19, result_cache=False)
        c1.register_csv("cities", path, schema, has_header=True)
        t0 = time.perf_counter()
        table = tdf.collect(c1.sql(CITIES_SQL))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    for i, w in enumerate(want):
        got = np.asarray(table.columns[i])
        if not np.array_equal(got, w):
            raise AssertionError(f"config 1 profiled: column {i} differs from the oracle "
                                 f"({len(got)} rows, oracle {len(w)})")
    report = cap.report()
    split = csv_parse_split(report)
    log("config1_parse_split: " + json.dumps({
        "query": "config1_csv_scan_filter", "cold_ms": ms, "summary": report.summary(),
        "phase_samples": report.phase_samples(), "decode_split": split,
        "decode_top_frames": report.top_frames(8, "decode"), "card": smi}))
    if not split["dtf_csv_next"]:
        raise AssertionError(f"config 1 profile: no sample in dtf_csv_next {split}")

    # 5. utils/profiling.trace over one Q1 run
    here = os.path.dirname(os.path.abspath(__file__))
    trace_dir = os.path.join(here, "build", "chip_smoke", "q1_trace")
    with trace(trace_dir):
        tdf.collect(ctx.sql(Q1))
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    reduce_events = [e for e in kernels if "reduce_kernel" in e.get("name", "")]
    log("profiling_trace: " + json.dumps({
        "query": "tpch_q1_sf1", "events": len(events), "kernel_events": len(kernels),
        "reduce_kernel_events": len(reduce_events),
        "reduce_kernel_us": sum(e.get("dur", 0) for e in reduce_events), "card": smi}))
    if not reduce_events:
        raise AssertionError("utils/profiling.trace: no grouped-reduce kernel event")
    return reports


# ----------------------------------------------------------- phase 14

INGEST_DELTAS = 15  # benchmarks/suite.py config_ingest (BENCH_INGEST_DELTAS)
INGEST_DELTA_ROWS = 2000  # config_ingest's BENCH_INGEST_DELTA_ROWS
INGEST_BULK_ROWS = 131_072  # one batch of the SF-1 lineitem
Q1_FLAGS, Q1_STATUSES = np.array(["A", "N", "R"]), np.array(["F", "O"])


def ingest_delta(rng, rows):
    """One delta of config_ingest (benchmarks/suite.py:730-742): Q1's
    columns, the shipdate an existing one."""
    return {
        "l_returnflag": [Q1_FLAGS[i] for i in rng.integers(0, 3, rows)],
        "l_linestatus": [Q1_STATUSES[i] for i in rng.integers(0, 2, rows)],
        "l_quantity": rng.uniform(1, 50, rows).round(2),
        "l_extendedprice": rng.uniform(900, 105000, rows).round(2),
        "l_discount": rng.uniform(0, 0.1, rows).round(2),
        "l_tax": rng.uniform(0, 0.08, rows).round(2),
        "l_shipdate": ["1995-06-15"] * rows,
    }


class Q1Oracle:
    """`q1_oracle` kept up to date over a base and appended deltas: the
    per-group sums in f64 (numpy bincount), one batch of rows at a time."""

    def __init__(self, c, dates, cutoff="1998-09-02"):
        self.dates = dates
        self.cut = dates.index(cutoff)
        self.sums = np.zeros((5, 6))
        self.cnt = np.zeros(6, dtype=np.int64)
        self.add(c)

    def add(self, c):
        keep = c["ship"] <= self.cut
        key = (c["flag"] * 2 + c["status"])[keep]
        qty, price = c["qty"][keep], c["price"][keep]
        disc, tax = c["disc"][keep], c["tax"][keep]
        disc_price = price * (1.0 - disc)
        for i, w in enumerate((qty, price, disc_price, disc_price * (1.0 + tax), disc)):
            self.sums[i] += np.bincount(key, weights=w, minlength=6)
        self.cnt += np.bincount(key, minlength=6)

    def add_delta(self, d):
        pos = {s: i for i, s in enumerate(self.dates)}
        self.add({"flag": np.searchsorted(Q1_FLAGS, d["l_returnflag"]),
                  "status": np.searchsorted(Q1_STATUSES, d["l_linestatus"]),
                  "qty": np.asarray(d["l_quantity"]), "price": np.asarray(d["l_extendedprice"]),
                  "disc": np.asarray(d["l_discount"]), "tax": np.asarray(d["l_tax"]),
                  "ship": np.fromiter((pos[x] for x in d["l_shipdate"]), dtype=np.int64,
                                      count=len(d["l_shipdate"]))})

    def rows(self):
        q, p, dp, ch, d = self.sums
        return [("ANR"[k // 2], "FO"[k % 2], q[k], p[k], dp[k], ch[k], q[k] / n, p[k] / n,
                 d[k] / n, int(n)) for k, n in enumerate(self.cnt) if n]


def phase_ingest(tdf, cuda_mod, torch, src, cols, dates, smi):
    """The freshness and durability plane (datafusion_tpu_torch/ingest,
    cache/, utils/wal.py, serve.py's appends and pin manifest) over the
    SF-1 lineitem of phase 3 (6,000,000 rows in memory, seed 42):

    1. setup: `ctx.ingest()` with the write-ahead log in a fresh
       temporary directory under `DATAFUSION_TPU_WAL_SYNC=always` (an
       fsync before each ack), `CREATE MATERIALIZED VIEW q1 AS <Q1>`,
       which must be incremental; a twin context without a log and its
       own view, the no-WAL leg;
    2. trickle: one warm-up delta, then 15 deltas of 2,000 rows
       (config_ingest, `benchmarks/suite.py:692-790`, seed 17): per delta
       the append-plus-maintain ms with the log and without (the two
       legs take turns at going first), the view's
       device passes (exactly 1) and grouped-reduce launches (6: the row
       count and Q1's 5 sums), the view against a numpy oracle over base
       plus deltas, and a rescan's ms and rows;
    3. bulk: one delta of 131,072 rows, timed and checked the same way;
    4. recovery: the log closed, a fresh context over the same base,
       `recover()`: every append replayed, the view equal to the oracle
       and at its revision again;
    5. cache: config_cache (`benchmarks/suite.py:616-690`: 2,000,000 rows,
       10,000 groups, the sort-merge route) with the result cache on:
       cold ms, warm-hit p50 (5 runs) and the hit rate, each warm run a
       `CachedResultRelation`; an append to `t` then misses and answers
       with the new rows;
    6. served: a Server over the pinned lineitem; after `srv.append` of
       2,000 rows the next served Q1 copies exactly the delta's used
       columns and its group ids (`h2d.bytes`), and equals the oracle;
    7. pin manifest: a second `Server(pin_manifest=...)` re-pins the
       table at `start()`, and its first Q1 equals the oracle.
    Launch counters are reset just before each step's timed work and
    read just after.  Returns the reports whose launches the `kernels`
    line counts."""
    import shutil
    import tempfile

    from datafusion_tpu_torch.cache.result import CachedResultRelation
    from datafusion_tpu_torch.obs.device import LEDGER
    from datafusion_tpu_torch.utils.metrics import METRICS

    def count(name):
        return METRICS.snapshot()["counts"].get(name, 0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    reports = []
    wal_dir = tempfile.mkdtemp(prefix="chip_smoke_wal_")
    prior_sync = os.environ.get("DATAFUSION_TPU_WAL_SYNC")
    os.environ["DATAFUSION_TPU_WAL_SYNC"] = "always"
    try:
        # 1. setup
        ctx = tdf.ExecutionContext(result_cache=False)
        ctx.register_datasource("lineitem", src)
        ing = ctx.ingest(wal_dir=wal_dir)
        nw_ctx = tdf.ExecutionContext(result_cache=False)
        nw_ctx.register_datasource("lineitem", src)
        nw_ing = nw_ctx.ingest()
        cuda_mod.reset_launch_counts()
        out, create_ms = timed(lambda: ctx.sql(f"CREATE MATERIALIZED VIEW q1 AS {Q1}"))
        create_launches = cuda_mod.launch_counts()
        if repr(out) != "Registered materialized view q1 (incremental)":
            raise AssertionError(f"ingest: {out!r}")
        view = ing.view("q1")
        nw_ing.create_view("q1", Q1)
        if ing.status()["wal"]["sync"] != "always":
            raise AssertionError("ingest: the log does not fsync before the ack")
        oracle = Q1Oracle(cols, dates)
        assert_rows(ing.read_view("q1"), oracle.rows(), "view q1 at creation")
        nb = len(list(src.batches()))
        expect_launches({"launches": create_launches}, "view q1 creation",
                        hash_agg=6 * fold_groups(nb))
        rep = {"query": "ingest_view_create", "create_view_ms": create_ms,
               "base_rows": SF1_ROWS, "batches": nb, "launches": create_launches,
               "wal_sync": "always", "card": card()}
        log("ingest_setup: " + json.dumps(rep))
        reports.append(rep)

        # 2. trickle, 3. bulk
        rng = np.random.default_rng(17)
        warm = ingest_delta(rng, INGEST_DELTA_ROWS)
        ing.append("lineitem", warm)
        nw_ing.append("lineitem", warm)
        oracle.add_delta(warm)
        deltas = [ingest_delta(rng, INGEST_DELTA_ROWS) for _ in range(INGEST_DELTAS)]
        deltas.append(ingest_delta(rng, INGEST_BULK_ROWS))
        per_delta = []
        trickle_launches = {"hash_agg": 0, "hash_build": 0, "sort_kernel": 0}
        for i, d in enumerate(deltas):
            rows = len(d["l_quantity"])

            def wal_leg():
                passes0 = count("device.launches.view.maintain")
                cuda_mod.reset_launch_counts()
                ack, ms = timed(lambda: ing.append("lineitem", d))
                return (ack, ms, cuda_mod.launch_counts(),
                        count("device.launches.view.maintain") - passes0)

            # the two legs take turns at going first
            wal_first = i % 2 == 0
            if wal_first:
                ack, wal_ms, launches, passes = wal_leg()
            _, nowal_ms = timed(lambda: nw_ing.append("lineitem", d))
            if not wal_first:
                ack, wal_ms, launches, passes = wal_leg()
            oracle.add_delta(d)
            label = f"delta {i}" if rows == INGEST_DELTA_ROWS else "bulk delta"
            if passes != 1 or launches != {"hash_agg": 6, "hash_build": 0, "sort_kernel": 0}:
                raise AssertionError(f"{label}: {passes} passes, launches {launches}")
            if ack["views"] != {"q1": view.revision} or view.lag() != 0.0:
                raise AssertionError(f"{label}: the view is not fresh at the ack: {ack}")
            assert_rows(ing.read_view("q1"), oracle.rows(), f"view q1 after {label}")
            assert_rows(nw_ing.read_view("q1"), oracle.rows(), f"no-WAL view after {label}")
            table, rescan_ms = timed(lambda: tdf.collect(ctx.sql(Q1)))
            assert_rows(table, oracle.rows(), f"rescan after {label}")
            for k in trickle_launches:
                trickle_launches[k] += launches[k]
            line = {"delta": i, "rows": rows, "append_maintain_ms": wal_ms,
                    "append_maintain_no_wal_ms": nowal_ms, "wal_first": wal_first,
                    "passes": passes,
                    "launches": launches, "rescan_ms": rescan_ms, "rev": ack["rev"],
                    "card": card()}
            per_delta.append(line)
            log(("ingest_bulk: " if rows != INGEST_DELTA_ROWS else "ingest_delta: ")
                + json.dumps(line))
        trickle = per_delta[:-1]
        wal = ing.status()["wal"]
        summary = {
            "query": "ingest_q1_view_trickle", "rows": INGEST_DELTA_ROWS * INGEST_DELTAS,
            "append_p50_ms": float(np.median([x["append_maintain_ms"] for x in trickle])),
            "append_no_wal_p50_ms": float(np.median(
                [x["append_maintain_no_wal_ms"] for x in trickle])),
            "rescan_p50_ms": float(np.median([x["rescan_ms"] for x in trickle])),
            "bulk_append_ms": per_delta[-1]["append_maintain_ms"],
            "bulk_append_no_wal_ms": per_delta[-1]["append_maintain_no_wal_ms"],
            "bulk_rescan_ms": per_delta[-1]["rescan_ms"],
            "wal_appends": wal["appends"], "wal_fsyncs": wal["fsyncs"],
            "wal_bytes": wal["bytes_written"], "launches": trickle_launches, "card": card()}
        summary["rows_per_s"] = INGEST_DELTA_ROWS / (summary["append_p50_ms"] / 1e3)
        log("ingest_trickle: " + json.dumps(summary))
        reports.append(summary)
        want_rev = view.revision

        # 4. recovery
        ing.close()
        del ctx, ing, view, nw_ctx, nw_ing
        rctx = tdf.ExecutionContext(result_cache=False)
        rctx.register_datasource("lineitem", src)
        ring = rctx.ingest(wal_dir=wal_dir)
        cuda_mod.reset_launch_counts()
        rec, recover_ms = timed(ring.recover)
        rec_launches = cuda_mod.launch_counts()
        if rec["appends_replayed"] != len(deltas) + 1 or rec["views_recovered"] != 1 \
                or rec["torn_tails"] != 0:
            raise AssertionError(f"ingest recovery: {rec}")
        if ring.view("q1").revision != want_rev:
            raise AssertionError(f"ingest recovery: revision {ring.view('q1').revision}, "
                                 f"want {want_rev}")
        assert_rows(ring.read_view("q1"), oracle.rows(), "view q1 after recovery")
        rep = {"query": "ingest_recovery", "rows": SF1_ROWS, "recover_ms": recover_ms,
               "appends_replayed": rec["appends_replayed"], "wal_recovery_ms":
               rec["recovery_ms"], "launches": rec_launches, "card": card()}
        log("ingest_recovery: " + json.dumps(rep))
        reports.append(rep)
        ring.close()
        del rctx, ring
    finally:
        if prior_sync is None:
            os.environ.pop("DATAFUSION_TPU_WAL_SYNC", None)
        else:
            os.environ["DATAFUSION_TPU_WAL_SYNC"] = prior_sync
        shutil.rmtree(wal_dir, ignore_errors=True)

    # 5. the result cache, config_cache's shape
    gsrc, gcols = groupby_table(tdf, 10_000, rows=CACHE_ROWS)
    cctx = tdf.ExecutionContext()  # the result cache on: the default
    if cctx.result_cache is None:
        raise AssertionError("cache: the result cache is off by default")
    cctx.register_datasource("t", gsrc)
    tdf.collect(cctx.sql(CONFIG2))  # the device copies, outside the cold timing
    cctx.result_cache.clear()
    cuda_mod.reset_launch_counts()
    cold, cold_ms = timed(lambda: tdf.collect(cctx.sql(CONFIG2)))
    cache_launches = cuda_mod.launch_counts()
    expect_launches({"launches": cache_launches}, "cache cold leg",
                    sort_kernel=fold_groups(len(list(gsrc.batches()))), hash_agg=0)
    assert_grouped(cold, config2_columns(gcols, 10_000), "cache cold leg")
    warm_ms = []
    for _ in range(5):
        rel = cctx.sql(CONFIG2)
        if not isinstance(rel, CachedResultRelation):
            raise AssertionError("cache: a warm repeat was not served from the cache")
        cuda_mod.reset_launch_counts()
        table, ms = timed(lambda: tdf.collect(rel))
        if any(cuda_mod.launch_counts().values()):
            raise AssertionError("cache: a warm hit launched a kernel")
        warm_ms.append(ms)
        assert_grouped(table, config2_columns(gcols, 10_000), "cache warm hit")
    stats = cctx.result_cache.stats()
    hits = [r for r in cctx.stats_history(cctx.last_fingerprint) if r.get("cache_hit")]
    rng = np.random.default_rng(23)
    n = INGEST_DELTA_ROWS
    keys = rng.integers(0, 10_010, n).astype(np.int64)
    keys[:10] = np.arange(10_000, 10_010)  # ten new groups
    delta = {"k": keys, "v1": rng.uniform(0.0, 1000.0, n), "v2": rng.uniform(-1.0, 1.0, n),
             "v3": rng.integers(-(10**9), 10**9, n).astype(np.int64)}
    cctx.ingest().append("t", delta)
    rel = cctx.sql(CONFIG2)
    if isinstance(rel, CachedResultRelation):
        raise AssertionError("cache: the run after an append was served stale")
    fresh = tdf.collect(rel)
    grown = [np.concatenate([c, delta[k]]) for c, k in zip(gcols, ("k", "v1", "v2", "v3"))]
    assert_grouped(fresh, config2_columns(grown, 10_010), "cache after an append")
    rep = {"query": "ingest_cache_config", "rows": CACHE_ROWS, "groups": 10_000,
           "cold_ms": cold_ms, "warm_hit_p50_ms": float(np.median(warm_ms)),
           "warm_ms": warm_ms, "hit_rate": stats["hits"] / max(stats["hits"] + stats["misses"], 1),
           "hits": stats["hits"], "misses": stats["misses"], "cached_bytes": stats["bytes"],
           "history_warm_hits": len(hits), "rows_after_append": fresh.num_rows,
           "launches": cache_launches, "card": card()}
    log("ingest_cache: " + json.dumps(rep))
    reports.append(rep)
    del cctx, gsrc, gcols, rel, fresh, grown

    # 6. served appends, 7. the pin manifest
    man_dir = tempfile.mkdtemp(prefix="chip_smoke_pins_")
    try:
        manifest = os.path.join(man_dir, "pin_manifest.json")
        sctx = tdf.ExecutionContext(result_cache=False)
        sctx.register_datasource("lineitem", src)
        soracle = Q1Oracle(cols, dates)
        with sctx.serve(workers=1, window_s=0.001, pin_manifest=manifest) as srv:
            srv.submit(Q1).result(timeout=600)
            h2d0 = count("h2d.bytes")
            srv.submit(Q1).result(timeout=600)
            if count("h2d.bytes") != h2d0:
                raise AssertionError("served: a warm Q1 copied to the device")
            pin0 = LEDGER.pins_snapshot()["table:lineitem"]["bytes"]
            d = ingest_delta(np.random.default_rng(29), INGEST_DELTA_ROWS)
            _, served_append_ms = timed(lambda: srv.append("lineitem", d))
            soracle.add_delta(d)
            pinned = sctx.datasources["lineitem"]
            batch = pinned._resident[-1]
            pin_grown = LEDGER.pins_snapshot()["table:lineitem"]["bytes"] - pin0
            h2d0 = count("h2d.bytes")
            cuda_mod.reset_launch_counts()
            t = srv.submit(Q1)
            table, served_ms = timed(lambda: t.result(timeout=600))
            served_launches = cuda_mod.launch_counts()
            h2d = count("h2d.bytes") - h2d0
            agg = t._rel
            while not hasattr(agg, "encoder"):  # the AggregateRelation
                agg = agg.child
            proj = getattr(agg.child.datasource, "cols", None)
            used = [c if proj is None else proj[c] for c in agg.core.used_cols]
            # the delta's used columns as put_compressed sent them (raw
            # where `auto` leaves the codec off; else their wire images,
            # the core's hints replaying its choices) and its raw group ids
            want = wire_bytes([batch.data[c] for c in used], sctx.device,
                              agg.core.wire_hints) + 4 * batch.capacity
            if h2d != want:
                raise AssertionError(f"served: {h2d} bytes copied after the append, "
                                     f"the delta's used columns and ids are {want}")
            if pin_grown != sum(a.nbytes for a in batch.data):
                raise AssertionError(f"served: the pin grew by {pin_grown} bytes")
            assert_rows(table, soracle.rows(), "served Q1 after an append")
            expect_launches({"launches": served_launches}, "served Q1 after an append",
                            hash_agg=6)
            table_bytes = sum(b.data[c].nbytes for b in pinned._resident for c in used)
        rep = {"query": "ingest_served_append", "rows": SF1_ROWS + INGEST_DELTA_ROWS,
               "append_ms": served_append_ms, "served_q1_ms": served_ms,
               "h2d_bytes": h2d, "delta_used_bytes_and_ids": want,
               "table_used_bytes": table_bytes, "pin_grown_bytes": pin_grown,
               "launches": served_launches, "card": card()}
        log("ingest_served: " + json.dumps(rep))
        reports.append(rep)

        with sctx.serve(workers=1, window_s=0.001, pin_manifest=manifest) as srv2:
            if srv2.pins_rehydrated != 1 or "table:lineitem" not in LEDGER.pins_snapshot():
                raise AssertionError("pin manifest: the table was not re-pinned at start()")
            cuda_mod.reset_launch_counts()
            t = srv2.submit(Q1)
            table, first_ms = timed(lambda: t.result(timeout=600))
            rehydrated_launches = cuda_mod.launch_counts()
            assert_rows(table, soracle.rows(), "served Q1 after re-pinning")
        rep = {"query": "ingest_pin_manifest", "rows": SF1_ROWS + INGEST_DELTA_ROWS,
               "pins_rehydrated": 1, "first_served_q1_ms": first_ms,
               "launches": rehydrated_launches, "card": card()}
        log("ingest_manifest: " + json.dumps(rep))
        reports.append(rep)
    finally:
        shutil.rmtree(man_dir, ignore_errors=True)
    log(f"ingest: views, recovery, cache and served appends match their oracles ({smi})")
    return reports


TENANT_SHARES = {"A": 3, "B": 1}
TENANT_A_CLIENTS = 4
TENANT_A_QUERIES = 8  # per A client, closed loop
TENANT_B_BURST = 4 * TENANT_A_CLIENTS * TENANT_A_QUERIES  # 4x A's count, open loop
# under megabatch_max: an open window cannot flush by size, so B's waves
# overfill the queue
TENANT_QUEUE = 12
TENANT_CUTOFFS = 16  # distinct Q1 l_shipdate cutoffs the tenants share
COST_Q12 = ("SELECT l_shipmode, COUNT(1) FROM orders "
            "JOIN lineitem ON orders.o_orderkey = lineitem.l_orderkey "
            "WHERE l_quantity > 25 GROUP BY l_shipmode")
WINDOW_GROUPS = 12_000


def _tenant_round(srv, a_sqls, b_sqls, wave=16, timeout=600.0):
    """Tenant B's open-loop burst against tenant A's closed-loop clients
    (one thread per list of `a_sqls`).  B never waits for an answer of
    its own: its thread submits `b_sqls` in waves of `wave` back to back,
    the first before A starts (A's clients start once B's first query
    has answered, so B has service on the meter before A can meet a
    full queue), each later one as A's clients have had another answer
    each, so the burst arrives with A's queries for all of A's run.
    Returns {"A"|"B": {"ok": [(sql, table)], "shed": {reason: n},
    "submitted": n, "errors": [...], "lat_ms": [...]}} (latencies: A's,
    submit to answer) and the round's wall seconds."""
    import threading

    from datafusion_tpu_torch.errors import QueryShedError

    out = {c: {"ok": [], "shed": {}, "submitted": 0, "errors": [], "lat_ms": []}
           for c in ("A", "B")}
    lock = threading.Condition()
    first_b = threading.Event()
    b_tickets: list = []
    a_answered = [0]
    a_total = sum(len(sqls) for sqls in a_sqls)

    def submit(client, sql):
        with lock:
            out[client]["submitted"] += 1
        try:
            return srv.submit(sql, client_id=client)
        except QueryShedError as e:
            with lock:
                out[client]["shed"][e.reason] = out[client]["shed"].get(e.reason, 0) + 1
            return None

    def tenant_b():
        try:
            for i, sql in enumerate(b_sqls):
                if i and i % wave == 0:
                    need = min(len(a_sqls) * (i // wave), a_total)
                    with lock:
                        lock.wait_for(lambda: a_answered[0] >= need, timeout)
                t = submit("B", sql)
                if t is not None:
                    b_tickets.append((sql, t))
                if i == 0:
                    first_b.set()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["B"]["errors"].append(e)
            first_b.set()

    def tenant_a(sqls):
        try:
            for sql in sqls:
                t0 = time.perf_counter()
                t = submit("A", sql)
                table = None if t is None else t.result(timeout=timeout)
                with lock:
                    if table is not None:
                        out["A"]["lat_ms"].append((time.perf_counter() - t0) * 1e3)
                        out["A"]["ok"].append((sql, table))
                    a_answered[0] += 1
                    lock.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["A"]["errors"].append(e)
            with lock:
                a_answered[0] = a_total
                lock.notify_all()

    t0 = time.perf_counter()
    b = threading.Thread(target=tenant_b)
    b.start()
    if b_sqls:
        first_b.wait(timeout)
        if b_tickets:
            b_tickets[0][1].result(timeout=timeout)
    threads = [threading.Thread(target=tenant_a, args=(sqls,)) for sqls in a_sqls]
    for th in threads:
        th.start()
    b.join(timeout)
    for sql, t in b_tickets:
        try:
            out["B"]["ok"].append((sql, t.result(timeout=timeout)))
        except QueryShedError as e:  # shed after queueing: a queued victim
            out["B"]["shed"][e.reason] = out["B"]["shed"].get(e.reason, 0) + 1
    for th in threads:
        th.join(timeout)
    wall = time.perf_counter() - t0
    for c in ("A", "B"):
        if out[c]["errors"]:
            raise out[c]["errors"][0]
    if b.is_alive() or any(th.is_alive() for th in threads):
        raise AssertionError("tenancy: a tenant thread did not finish")
    return out, wall


def phase_tenancy(tdf, cuda_mod, torch, hash_agg, src, cols, dates, smi):
    """Tenancy and cost (serve.py's client ids and shares, qos.py,
    obs/attribution.py, utils/retry.py, cost/) over the pinned SF-1
    lineitem of phase 3 and the SF-1 star schema of phase 5:

    1. tenants: a Server(shares={"A": 3, "B": 1}, workers=2,
       window_s=0.01, megabatch_max=16, queue_depth=12).  Tenant A (4
       closed-loop clients x 8 Q1-shaped queries over 16 l_shipdate
       cutoffs) runs alone first, the baseline; the meter starts the
       contended round empty (a new billing period); then tenant B's
       open-loop burst of 128 queries (4x A's: 8 waves of 16, one as A
       starts and one each time every A client has had another answer)
       overfills the queue while A runs again.  Gates: every answer equals the numpy oracle (rtol
       1e-9) and its solo answer bit for bit; every shed names B, at
       least one is `quota`; `admitted + shed == submitted` on the
       server and per tenant (answered + shed == submitted), and the
       meter's `shed` and `shed_quota` equal each tenant's client-side
       sheds; the tenants' metered device seconds (each served pass's
       device time, a CUDA event pair) sum to the round's
       `device.dispatch` timer; the query axis
       launched, with fewer grouped-reduce launches than queries.
       Printed: A's p50 and p99 with and without B, sheds by reason,
       megabatches.  Then the same two tenants with no shares, 12
       queries alternating A and B in one window: they execute in
       submission order (FIFO).
    2. faults: a seeded plan raises DeviceTransientError at `device.call`
       on 4 launches of a served Q1 round (replayed: every answer the
       oracle's, `device.transient_retries` > 0); then with
       DATAFUSION_TPU_QOS=1, a retry budget of ratio 0 (the tenant's
       child bucket holds one token) and every launch failing, B's
       queries fail with DeviceTransientError within seconds, and B's
       `retry_denied` meter counts the denials.
    3. cost across a restart, in a temporary DATAFUSION_TPU_COST_DIR:
       config 2 at 100,000 groups and `COST_Q12` (Q12 with the
       6,000,000-row lineitem on the build side) cold, then
       `cost.flush(force=True)`, `cost.reset_store()` and the trained
       leg: the `agg.capacity` (sort-merge route, presized) and
       `join.build_side` decisions recorded, the join built densely over
       orders through the build kernel, the rows equal to the cold
       leg's and the oracle's; then the 100,000-group table's learned
       groups poisoned to 16: a replan and the exact answer; then
       DATAFUSION_TPU_COST=0: no decision and the same rows.
    4. window: config 2 three times each at 8,192 and at 100,000 groups
       train the route history; the advisor's window and its decision
       are printed, and a 12,000-group config 2 takes the route the
       window names (grouped-reduce launches and no sort launch when
       its capacity of 16,384 is within the window, else sort
       launches), its rows equal to the oracle.
    Launch counters are reset just before each step's main-path work and
    read just after.  Returns the reports whose launches the `kernels`
    line counts."""
    import shutil
    import tempfile

    from datafusion_tpu_torch import cost
    from datafusion_tpu_torch.cost import advisor
    from datafusion_tpu_torch.errors import DeviceTransientError
    from datafusion_tpu_torch.exec.cuda import agg_max_groups
    from datafusion_tpu_torch.join.relation import HashJoinRelation
    from datafusion_tpu_torch.obs import attribution
    from datafusion_tpu_torch.obs.attribution import METER
    from datafusion_tpu_torch.testing import faults
    from datafusion_tpu_torch.utils import retry
    from datafusion_tpu_torch.utils.metrics import METRICS

    def snap():
        s = METRICS.snapshot()
        return s["counts"], s["timings_s"]

    def meter(client, key):
        return METER.snapshot().get(client, {}).get(key, 0.0)

    reports = []
    ctx = tdf.ExecutionContext(result_cache=False)
    ctx.register_datasource("lineitem", src)
    cutoffs = [dates[dates.index("1998-09-02") - 7 * i] for i in range(TENANT_CUTOFFS)]
    sql_of = {c: Q1.replace("1998-09-02", c) for c in cutoffs}
    cutoff_of = {sql: c for c, sql in sql_of.items()}
    a_sqls = [[sql_of[cutoffs[(TENANT_A_QUERIES * i + j) % TENANT_CUTOFFS]]
               for j in range(TENANT_A_QUERIES)] for i in range(TENANT_A_CLIENTS)]
    b_sqls = [sql_of[cutoffs[i % TENANT_CUTOFFS]] for i in range(TENANT_B_BURST)]

    # -- 1. tenants
    srv = ctx.serve(shares=TENANT_SHARES, workers=2, window_s=0.01, megabatch_max=16,
                    queue_depth=TENANT_QUEUE)
    try:
        base, base_wall = _tenant_round(srv, a_sqls, [])
        if any(base["A"]["shed"].values()):
            raise AssertionError(f"tenancy baseline: A shed {base['A']['shed']}")
        METER.clear()  # the contended round's billing period
        submitted0, admitted0, shed0 = srv.submitted, srv.admitted, srv.shed
        c0, t0_ = snap()
        cuda_mod.reset_launch_counts()
        got, wall = _tenant_round(srv, a_sqls, b_sqls)
        launches = cuda_mod.launch_counts()
        multi = hash_agg.MULTI_LAUNCHES
        c1, t1_ = snap()
        meter_after = METER.snapshot()
    finally:
        srv.stop()
    if srv.admitted + srv.shed != srv.submitted:
        raise AssertionError(f"tenancy: admitted {srv.admitted} + shed {srv.shed} != "
                             f"submitted {srv.submitted}")
    round_sub = srv.submitted - submitted0
    round_shed = srv.shed - shed0
    answered = 0
    for c in ("A", "B"):
        g = got[c]
        n_shed = sum(g["shed"].values())
        if len(g["ok"]) + n_shed != g["submitted"]:
            raise AssertionError(f"tenancy {c}: {len(g['ok'])} answered + {n_shed} shed != "
                                 f"{g['submitted']} submitted")
        m = meter_after.get(c, {})
        if m.get("shed", 0.0) != n_shed:
            raise AssertionError(f"tenancy {c}: meter shed {m.get('shed')} != {n_shed}")
        if m.get("queries", 0.0) != len(g["ok"]):
            raise AssertionError(f"tenancy {c}: meter queries {m.get('queries')} != "
                                 f"{len(g['ok'])}")
        answered += len(g["ok"])
    if got["A"]["shed"]:
        raise AssertionError(f"tenancy: A was shed {got['A']['shed']}; every shed must name B")
    if got["B"]["shed"].get("quota", 0) < 1:
        raise AssertionError(f"tenancy: B's burst was never shed for quota {got['B']['shed']}")
    if meter_after["B"].get("shed_quota", 0.0) != got["B"]["shed"]["quota"]:
        raise AssertionError("tenancy: tenant.B.shed_quota != B's client-side quota sheds")
    if round_sub != got["A"]["submitted"] + got["B"]["submitted"] or \
            round_shed != sum(got["B"]["shed"].values()):
        raise AssertionError("tenancy: the server's counts disagree with the tenants'")
    dev_s = sum(m.get("device_seconds", 0.0) for m in meter_after.values())
    dispatch_s = t1_.get("device.dispatch", 0.0) - t0_.get("device.dispatch", 0.0)
    if not dispatch_s > 0 or abs(dev_s - dispatch_s) > 1e-6 * dispatch_s:
        raise AssertionError(f"tenancy: metered device seconds {dev_s} != the round's "
                             f"device.dispatch {dispatch_s}")
    if multi <= 0 or not 0 < launches["hash_agg"] < answered:
        raise AssertionError(f"tenancy: {launches['hash_agg']} grouped-reduce launches "
                             f"({multi} query-axis) for {answered} queries")
    solo = {sql: tdf.collect(ctx.sql(sql)) for sql in sql_of.values()}
    for cutoff, sql in sql_of.items():
        assert_rows(solo[sql], q1_oracle(cols, dates, cutoff), f"tenancy solo Q1 <= {cutoff}")
    for c in ("A", "B"):
        for sql, table in base["A"]["ok"] + got[c]["ok"]:
            assert_same_bits(table, solo[sql], f"tenancy {c} Q1 <= {cutoff_of[sql]}",
                             key_cols=2)
    mega = c1.get("serve.megabatches", 0) - c0.get("serve.megabatches", 0)
    rep = {
        "query": "tenancy_round", "rows": SF1_ROWS, "shares": TENANT_SHARES,
        "queue_depth": TENANT_QUEUE, "a_queries": got["A"]["submitted"],
        "b_queries": got["B"]["submitted"], "answered": answered,
        "a_p50_ms_alone": float(np.percentile(base["A"]["lat_ms"], 50)),
        "a_p99_ms_alone": float(np.percentile(base["A"]["lat_ms"], 99)),
        "a_p50_ms_with_b": float(np.percentile(got["A"]["lat_ms"], 50)),
        "a_p99_ms_with_b": float(np.percentile(got["A"]["lat_ms"], 99)),
        "sheds": {c: got[c]["shed"] for c in ("A", "B")},
        "megabatches": mega, "launches": launches, "query_axis_launches": multi,
        "device_seconds": {c: meter_after.get(c, {}).get("device_seconds", 0.0)
                           for c in ("A", "B")},
        "dispatch_s": dispatch_s, "round_wall_s": wall, "baseline_wall_s": base_wall,
        "card": card(),
    }
    log("tenancy: " + json.dumps(rep))
    reports.append(rep)
    log(attribution.tenants_text())

    # FIFO without shares: 12 queries, alternating tenants, one window
    order: list = []
    orig_execute = ctx.execute

    def recording(plan, *a, **k):
        order.append(attribution.current_client())
        return orig_execute(plan, *a, **k)

    ctx.execute = recording
    fifo_clients = ["A", "B"] * 6
    try:
        with ctx.serve(workers=1, window_s=0.25, megabatch_max=32) as srv:
            if srv._qos is not None:
                raise AssertionError("tenancy FIFO: a policy armed without shares")
            tickets = [srv.submit(sql_of[cutoffs[i]], client_id=c)
                       for i, c in enumerate(fifo_clients)]
            for i, t in enumerate(tickets):
                assert_same_bits(t.result(timeout=600), solo[sql_of[cutoffs[i]]],
                                 "tenancy FIFO", key_cols=2)
    finally:
        del ctx.execute
    if order != fifo_clients:
        raise AssertionError(f"tenancy FIFO: executed {order}, submitted {fifo_clients}")
    log(f"tenancy FIFO without shares: {len(order)} queries in submission order ({smi})")

    # -- 2. faults
    with ctx.serve(shares=TENANT_SHARES, workers=2, window_s=0.01, megabatch_max=16) as srv:
        retries0 = METRICS.snapshot()["counts"].get("device.transient_retries", 0)
        cuda_mod.reset_launch_counts()
        with faults.scoped({"seed": 17, "rules": [
                {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
                 "p": 0.5, "count": 4}]}):
            fault_got, fault_wall = _tenant_round(srv, a_sqls[:2], [])
        fault_launches = cuda_mod.launch_counts()
        retried = METRICS.snapshot()["counts"].get("device.transient_retries", 0) - retries0
        for sql, table in fault_got["A"]["ok"]:
            assert_same_bits(table, solo[sql], f"fault round Q1 <= {cutoff_of[sql]}",
                             key_cols=2)
        if retried <= 0 or len(fault_got["A"]["ok"]) != 2 * TENANT_A_QUERIES:
            raise AssertionError(f"faults: {retried} replays, "
                                 f"{len(fault_got['A']['ok'])} answers")
        os.environ["DATAFUSION_TPU_QOS"] = "1"
        try:
            retry.set_retry_budget(retry.RetryBudget(0.0, burst=8.0))
            denied0 = meter("B", "retry_denied")
            exhausted0 = METRICS.snapshot()["counts"].get("device.retry_budget_exhausted", 0)
            failed, fail_s = 0, []
            with faults.scoped({"rules": [{"site": "device.call", "op": "raise",
                                           "exc": "DeviceTransientError", "count": 0}]}):
                for sql in b_sqls[:8]:
                    t0 = time.perf_counter()
                    try:
                        srv.submit(sql, client_id="B").result(timeout=600)
                    except DeviceTransientError:
                        failed += 1
                    fail_s.append(time.perf_counter() - t0)
        finally:
            retry.set_retry_budget(None)
            del os.environ["DATAFUSION_TPU_QOS"]
        denied = meter("B", "retry_denied") - denied0
        exhausted = (METRICS.snapshot()["counts"].get("device.retry_budget_exhausted", 0)
                     - exhausted0)
        if failed != 8 or denied < 1 or exhausted < 1 or max(fail_s) > 10.0:
            raise AssertionError(f"faults: {failed} of 8 failed, {denied} tenant denials, "
                                 f"{exhausted} exhausted, slowest {max(fail_s):.3f} s")
    rep = {"query": "tenancy_faults", "rows": SF1_ROWS, "replays": retried,
           "answers": len(fault_got["A"]["ok"]), "fault_round_s": fault_wall,
           "denied_b": denied, "budget_exhausted": exhausted,
           "slowest_denied_s": max(fail_s), "launches": fault_launches, "card": card()}
    log("tenancy_faults: " + json.dumps(rep))
    reports.append(rep)

    # -- 3. cost across a restart
    cost_dir = tempfile.mkdtemp(prefix="df_cost_")
    os.environ["DATAFUSION_TPU_COST_DIR"] = cost_dir
    cost.reset_store()
    try:
        star, star_cols = star_sf1(tdf, ctx.batch_size)
        gsrc, gcols = groupby_table(tdf, 100_000)
        cctx = tdf.ExecutionContext(result_cache=False)
        for name in ("orders", "lineitem"):
            cctx.register_datasource(name, star[name])
        cctx.register_datasource("t", gsrc)
        g_oracle = config2_columns(gcols, 100_000)
        q_oracle = q12_oracle(star_cols)

        def leg(label):
            out = {}
            for key, sql in (("config2", CONFIG2), ("q12", COST_Q12)):
                cuda_mod.reset_launch_counts()
                t0 = time.perf_counter()
                rel = cctx.sql(sql)
                table = tdf.collect(rel)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                out[key] = (table, ms, cuda_mod.launch_counts(), rel)
            assert_grouped(out["config2"][0], g_oracle, f"{label} config 2 (100,000 groups)")
            assert_rows(out["q12"][0], q_oracle, f"{label} Q12, lineitem built")
            return out

        mark = cost.store().decision_serial
        cold = leg("cost cold")
        cold_decisions = [d for d in cost.store().decisions if d["seq"] > mark]
        cost.flush(force=True)
        cost.reset_store()  # the restart: the next store loads the file
        if not len(cost.store()):
            raise AssertionError("cost: the restarted store loaded nothing")
        mark = cost.store().decision_serial
        trained = leg("cost trained")
        made = {d["decision"]: d for d in cost.store().decisions if d["seq"] > mark}
        for name in ("agg.capacity", "join.build_side"):
            if name not in made:
                raise AssertionError(f"cost trained: no {name} decision ({list(made)})")
        join = trained["q12"][3]
        while join is not None and not isinstance(join, HashJoinRelation):
            join = getattr(join, "child", None)
        art = None if join is None else join._artifact
        if art is None or not art.dense or art.n_rows != len(star_cols["o_custkey"]) \
                or trained["q12"][2]["hash_build"] != 1:
            raise AssertionError("cost trained: the join did not build densely over orders")
        if trained["config2"][2]["sort_kernel"] < 1 or trained["config2"][2]["hash_agg"]:
            raise AssertionError("cost trained: config 2 left the sort-merge route")
        assert_same_tables(trained["config2"][0], cold["config2"][0], "cost legs config 2")
        assert_same_tables(trained["q12"][0], cold["q12"][0], "cost legs Q12")
        # a poisoned store: the 100,000-group table's learned groups set to
        # 16 in the persisted file, which a restart loads
        cost.flush(force=True)
        path = cost.store_path()
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        rec = doc["entries"][f"{cctx.cost_table_key('t')}\t{advisor.agg_shape(['k'])}"]
        rec.update(groups=16.0, groups_last=16.0, groups_max=16.0)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        cost.reset_store()
        replans0 = METRICS.snapshot()["counts"].get("plan.replans", 0)
        cuda_mod.reset_launch_counts()
        poisoned = tdf.collect(cctx.sql(CONFIG2))
        poison_launches = cuda_mod.launch_counts()
        replans = METRICS.snapshot()["counts"].get("plan.replans", 0) - replans0
        if replans < 1:
            raise AssertionError("cost: the poisoned store caused no replan")
        assert_grouped(poisoned, g_oracle, "cost poisoned config 2")
        os.environ["DATAFUSION_TPU_COST"] = "0"
        try:
            mark = cost.store().decision_serial
            static = leg("cost off")
            if cost.store().decision_serial != mark:
                raise AssertionError("cost off: a decision was made")
        finally:
            del os.environ["DATAFUSION_TPU_COST"]
        assert_same_tables(static["q12"][0], trained["q12"][0], "cost off Q12")
        rep = {"query": "tenancy_cost", "rows": SF1_ROWS,
               "cold_ms": {k: v[1] for k, v in cold.items()},
               "trained_ms": {k: v[1] for k, v in trained.items()},
               "static_ms": {k: v[1] for k, v in static.items()},
               "cold_decisions": [d["decision"] for d in cold_decisions],
               "trained_decisions": {k: [d["chosen"], d["default"], d["reason"]]
                                     for k, d in made.items()},
               "replans": replans, "launches": {
                   k: sum(leg_[q][2][k] for leg_ in (cold, trained, static)
                          for q in ("config2", "q12")) + poison_launches[k]
                   for k in poison_launches},
               "card": card()}
        log("tenancy_cost: " + json.dumps(rep))
        reports.append(rep)
        del star, cctx, cold, trained, static

        # -- 4. the grouped-reduce window
        wctx = tdf.ExecutionContext(result_cache=False)
        train_launches = None
        for groups in (8192, 100_000):
            wsrc, _ = groupby_table(tdf, groups)
            wctx.register_datasource("t", wsrc)
            for _ in range(3):
                cuda_mod.reset_launch_counts()
                tdf.collect(wctx.sql(CONFIG2))
                got_l = cuda_mod.launch_counts()
                train_launches = got_l if train_launches is None else {
                    k: train_launches[k] + got_l[k] for k in got_l}
        window = advisor.agg_window()
        noted = [d for d in cost.store().decisions if d["decision"] == "agg.window"]
        wsrc, wcols = groupby_table(tdf, WINDOW_GROUPS)
        wctx.register_datasource("t", wsrc)
        cuda_mod.reset_launch_counts()
        wtable = tdf.collect(wctx.sql(CONFIG2))
        wl = cuda_mod.launch_counts()
        assert_grouped(wtable, config2_columns(wcols, WINDOW_GROUPS), "window config 2")
        cap = 16384  # the capacity of 12,000 groups
        route = "grouped_reduce" if cap <= window else "sortmerge"
        if route == "grouped_reduce" and (wl["hash_agg"] < 1 or wl["sort_kernel"]):
            raise AssertionError(f"window {window}: 12,000 groups launched {wl}")
        if route == "sortmerge" and (wl["sort_kernel"] < 1 or wl["hash_agg"]):
            raise AssertionError(f"window {window}: 12,000 groups launched {wl}")
        hist = {r: cost.store().lookup(cost.CUDA_KEY, f"agg:{r}")
                for r in ("grouped_reduce", "sortmerge")}
        rep = {"query": "tenancy_window", "window": window, "static": agg_max_groups(),
               "decision": noted[-1] if noted else None, "route_12000": route,
               "history": {r: None if h is None else
                           {"n": h["n"], "s_per_row": h["s_per_row"], "cap_max": h["cap_max"]}
                           for r, h in hist.items()},
               "launches": {k: train_launches[k] + wl[k] for k in wl}, "card": card()}
        log("tenancy_window: " + json.dumps(rep, default=str))
        reports.append(rep)
    finally:
        os.environ.pop("DATAFUSION_TPU_COST_DIR", None)
        cost.reset_store()
        shutil.rmtree(cost_dir, ignore_errors=True)
    log(f"tenancy: tenants, faults, cost and window gates hold ({smi})")
    return reports


# ------------------------------------------------------------ phase 16

MESH_ROWS = 4_000_000  # benchmarks/mesh_bench.py: BENCH_MESH_ROWS
MESH_GROUPS = 1000  # BENCH_MESH_GROUPS
MESH_SLOTS = 8
MESH_BATCH = 1 << 18  # groupby_batches' batch_rows in mesh_bench
DIST_PARTS = 4
# a worker process: no --device, so cuda:0
WORKER_CMD = ("-m", "datafusion_tpu_torch.worker", "--bind", "127.0.0.1:0")
LINEITEM_Q1_SCHEMA = (("l_returnflag", "UTF8"), ("l_linestatus", "UTF8"),
                      ("l_quantity", "FLOAT64"), ("l_extendedprice", "FLOAT64"),
                      ("l_discount", "FLOAT64"), ("l_tax", "FLOAT64"), ("l_shipdate", "UTF8"))
ORDERS_SCHEMA = (("o_orderkey", "INT64"), ("o_custkey", "INT64"), ("o_orderdate", "UTF8"),
                 ("o_shippriority", "INT64"))
LINEITEM_Q12_SCHEMA = (("l_orderkey", "INT64"), ("l_quantity", "INT64"),
                       ("l_extendedprice", "FLOAT64"), ("l_discount", "FLOAT64"),
                       ("l_shipmode", "INT64"))


def config5_partitions(tdf):
    """Config 5's table: 8 in-memory partitions of config 2's columns,
    500,000 rows each, from seeds 100 to 107 with groupby_batches' RNG
    sequence and its batch of 2^18 rows (benchmarks/mesh_bench.py).
    Returns (partitions, the concatenated columns)."""
    I, F = tdf.DataType.INT64, tdf.DataType.FLOAT64
    schema = tdf.Schema([tdf.Field("k", I, False), tdf.Field("v1", F, False),
                         tdf.Field("v2", F, False), tdf.Field("v3", I, False)])
    per_part = MESH_ROWS // MESH_SLOTS
    parts, cols = [], []
    for i in range(MESH_SLOTS):
        rng = np.random.default_rng(100 + i)
        batches = []
        for start in range(0, per_part, MESH_BATCH):
            n = min(MESH_BATCH, per_part - start)
            c = [rng.integers(0, MESH_GROUPS, n).astype(np.int64),
                 rng.uniform(0.0, 1000.0, n), rng.uniform(-1.0, 1.0, n),
                 rng.integers(-(10**9), 10**9, n).astype(np.int64)]
            cols.append(c)
            batches.append(tdf.make_host_batch(schema, c, None, None))
        parts.append(tdf.MemoryDataSource(schema, batches))
    return parts, [np.concatenate([c[i] for c in cols]) for i in range(4)]


def _schema_of(tdf, fields):
    return tdf.Schema([tdf.Field(n, getattr(tdf.DataType, t), False) for n, t in fields])


def split_csv(path, parts, out_dir, stem):
    """`path` (a CSV with a header) as `parts` CSVs cut on line
    boundaries, each with the header.  Returns [(path, rows)]."""
    with open(path, "rb") as f:
        header = f.readline()
        body = f.read()
    out, start = [], 0
    for p in range(parts):
        end = len(body) if p == parts - 1 else body.index(b"\n", len(body) * (p + 1) // parts) + 1
        part = os.path.join(out_dir, f"{stem}_part{p}.csv")
        with open(part, "wb") as f:
            f.write(header)
            f.write(body[start:end])
        out.append((part, body.count(b"\n", start, end)))
        start = end
    return out


def _start_workers(n, out_dir, extra=()):
    """`n` worker processes (`python -m datafusion_tpu_torch.worker`,
    no --device: cuda:0, and the arguments `extra`), fresh interpreters
    on ephemeral ports, the fragment cache off so every run computes.
    Returns [(process, (host, port))]; a worker that does not come up
    fails the phase."""
    import select

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DATAFUSION_TPU_CACHE="0")
    workers = []
    try:
        for i in range(n):
            err = open(os.path.join(out_dir, f"worker{i}.err"), "w")
            proc = subprocess.Popen([sys.executable, *WORKER_CMD, *extra], cwd=here, env=env,
                                    stdout=subprocess.PIPE, stderr=err, text=True)
            err.close()
            workers.append((proc, None))
        out = []
        for i, (proc, _) in enumerate(workers):
            ready, _, _ = select.select([proc.stdout], [], [], 180)
            line = proc.stdout.readline() if ready else ""
            if "listening on" not in line:
                raise AssertionError(f"worker {i} did not start: {line!r} "
                                     f"(see build/chip_smoke/worker{i}.err)")
            host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
            out.append((proc, (host, int(port))))
        return out
    except BaseException:
        _stop_workers(workers)
        raise


def _stop_workers(workers):
    for proc, _ in workers:
        if proc.poll() is None:
            proc.terminate()
    for proc, _ in workers:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _worker_counts(ctx):
    """Per worker address: its `status` kernel launches and queries (a
    worker that does not answer is None)."""
    return {addr: None if st is None else (dict(st["kernels"]), st["queries"])
            for addr, st in ctx.worker_status().items()}


def _counts_delta(before, after):
    out = {}
    for addr, a in after.items():
        b = before.get(addr)
        if a is None:
            continue
        k0 = {} if b is None else b[0]
        out[addr] = ({k: v - k0.get(k, 0) for k, v in a[0].items()},
                     a[1] - (0 if b is None else b[1]))
    return out


def _sum_kernels(delta):
    total = {"hash_agg": 0, "hash_build": 0, "sort_kernel": 0}
    for kernels, _ in delta.values():
        for k in total:
            total[k] += kernels.get(k, 0)
    return total


def _dist_run(tdf, torch, ctx, sql, cuda_mod):
    """One run with the coordinator's and the workers' launch counters
    read around it: (result, ms, coordinator launches, worker deltas,
    wire bytes sent and received)."""
    from datafusion_tpu_torch.utils.metrics import METRICS

    before = _worker_counts(ctx)
    sent0 = METRICS.counts.get("wire.bytes_sent", 0)
    recv0 = METRICS.counts.get("wire.bytes_received", 0)
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    table = tdf.collect(ctx.sql(sql))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    coord = cuda_mod.launch_counts()
    sent = METRICS.counts.get("wire.bytes_sent", 0) - sent0
    recv = METRICS.counts.get("wire.bytes_received", 0) - recv0
    return table, ms, coord, _counts_delta(before, _worker_counts(ctx)), sent + recv


def phase_distributed(tdf, cuda_mod, torch, dev, li_cols, dates, star, smi):
    """Distributed execution on cuda:0 (datafusion_tpu_torch/parallel/):

    1. the partitioned mesh: `PartitionedContext` on 8 slots of cuda:0
       at config 5's shape (config 2's SQL over 4,000,000 rows and 1,000
       groups, 8 partitions from seeds 100 to 107, benchmarks/
       mesh_bench.py), against the numpy oracle, the 8 slots folding
       into one state of 1024 groups: 5 grouped-reduce launches a round
       cold (2 rounds), the same in the warm run that admits the rounds,
       then 5 a folded warm run, whose f64 bits repeat; and against a
       one-slot mesh (`make_mesh()`, the card);
    2. coordinator and workers: two `python -m datafusion_tpu_torch.worker`
       processes on cuda:0 (fragment cache off), TPC-H Q1 over phase
       12's SF-1 lineitem CSV cut into 4 partitions, cold and twice warm,
       against `q1_oracle`; the workers' `status` must show 6
       grouped-reduce launches a batch group of each fragment; the same
       4 partitions written as Parquet (`write_lineitem_parquet`), Q1
       over them cold and twice warm, held to the same oracle and
       launches; then one worker killed and Q1 again (over the CSV
       partitions), every fragment answered by the survivor;
    3. Q12 over phase 12's orders and lineitem CSVs cut into 4
       partitions each: through the shuffle join (the coordinator's
       aggregate launches the grouped reduce, its ORDER BY the sort),
       and under DATAFUSION_TPU_SHUFFLE=0 (the coordinator's local join
       over distributed scans launches the build kernel), against
       `q12_oracle`.
    `dist_*` lines; returns the reports the `kernels` line counts."""
    import gc

    from datafusion_tpu_torch.parallel import (
        DistributedContext,
        PartitionedContext,
        PartitionedDataSource,
        make_mesh,
    )
    from datafusion_tpu_torch.utils.metrics import METRICS

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    reports = []

    # 1. the partitioned mesh
    parts, c5 = config5_partitions(tdf)
    mctx = PartitionedContext(mesh=make_mesh(devices=[dev] * MESH_SLOTS), result_cache=False)
    mctx.register_datasource("t", PartitionedDataSource(parts))
    rel = mctx.sql(CONFIG2)
    rounds = -(-(MESH_ROWS // MESH_SLOTS) // MESH_BATCH)
    cuda_mod.reset_launch_counts()
    t0 = time.perf_counter()
    table = tdf.collect(rel)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold = cuda_mod.launch_counts()
    want = config2_columns(c5, MESH_GROUPS)
    assert_grouped(table, want, "mesh config 5")
    # the row count, SUM(v1), SUM(v2), MIN(v3), MAX(v3): one launch each
    # a round (the 8 slots of cuda:0 fold into one state of 1024 groups)
    rep = {"query": "dist_mesh_config5", "rows": MESH_ROWS, "launches": cold}
    expect_launches(rep, "mesh config 5", hash_agg=5 * rounds, sort_kernel=0)
    warm, warm_launches, outs = [], [], []
    for _ in range(3):
        cuda_mod.reset_launch_counts()
        t0 = time.perf_counter()
        outs.append(tdf.collect(rel))
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        warm_launches.append(cuda_mod.launch_counts()["hash_agg"])
    if warm_launches != [5 * rounds, 5, 5]:
        raise AssertionError(f"mesh warm launches {warm_launches}, want "
                             f"{[5 * rounds, 5, 5]} (admit, then one folded pass)")
    for o in outs:
        assert_grouped(o, want, "mesh config 5 warm")
    for a, b in zip(outs[1].columns, outs[2].columns):
        if np.asarray(a).tobytes() != np.asarray(b).tobytes():
            raise AssertionError("mesh config 5: two folded warm runs differ in their bits")
    one = PartitionedContext(mesh=make_mesh(), result_cache=False)
    one.register_datasource("t", PartitionedDataSource(parts))
    rel1 = one.sql(CONFIG2)
    t1 = tdf.collect(rel1)
    assert_same_tables(t1, table, "mesh 1 slot against 8")
    t0 = time.perf_counter()
    tdf.collect(rel1)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    rep.update({"slots": MESH_SLOTS, "rounds": rounds, "cold_ms": cold_ms,
                "warm_ms": warm, "warm_launches": warm_launches,
                "one_slot_warm_ms": one_ms, "card": card()})
    log("dist_mesh: " + json.dumps(rep))
    log(f"mesh: config 5 on {MESH_SLOTS} slots of cuda:0 matches the numpy oracle and the "
        "one-slot mesh; folded warm runs repeat their f64 bits")
    reports.append(rep)
    del parts, c5, mctx, rel, one, rel1, outs
    gc.collect()

    # the CSVs of phase 12 (written again if absent), cut into partitions
    li_path = os.path.join(out_dir, f"lineitem_q1_{SF1_ROWS}.csv")
    if not os.path.exists(li_path):
        write_csv(li_path, [n for n, _ in LINEITEM_Q1_SCHEMA],
                  [np.array(["A", "N", "R"])[li_cols["flag"]],
                   np.array(["F", "O"])[li_cols["status"]], li_cols["qty"], li_cols["price"],
                   li_cols["disc"], li_cols["tax"], np.array(dates)[li_cols["ship"]]])
    orders_path = os.path.join(out_dir, "orders_q12.csv")
    l12_path = os.path.join(out_dir, "lineitem_q12.csv")
    if not (os.path.exists(orders_path) and os.path.exists(l12_path)):
        d_date = np.array([f"1995-{m:02d}-{d:02d}" for m in range(1, 13) for d in range(1, 29)])
        write_csv(orders_path, [n for n, _ in ORDERS_SCHEMA],
                  [np.arange(len(star["o_custkey"])), star["o_custkey"],
                   d_date[star["o_date"]], star["o_shippriority"]])
        write_csv(l12_path, [n for n, _ in LINEITEM_Q12_SCHEMA],
                  [star["l_orderkey"], star["l_quantity"], star["l_extendedprice"],
                   star["l_discount"], star["l_shipmode"]])
    t0 = time.perf_counter()
    li_parts = split_csv(li_path, DIST_PARTS, out_dir, "dist_lineitem_q1")
    o_parts = split_csv(orders_path, DIST_PARTS, out_dir, "dist_orders_q12")
    l12_parts = split_csv(l12_path, DIST_PARTS, out_dir, "dist_lineitem_q12")
    split_s = time.perf_counter() - t0

    workers = _start_workers(2, out_dir)
    try:
        addrs = [a for _, a in workers]
        ctx = DistributedContext(addrs, result_cache=False)  # the coordinator: cuda:0
        ctx.register_datasource("lineitem", PartitionedDataSource(
            [tdf.CsvDataSource(p, _schema_of(tdf, LINEITEM_Q1_SCHEMA)) for p, _ in li_parts]))
        batch = ctx.batch_size
        want_q1 = 6 * sum(fold_groups(-(-rows // batch)) for _, rows in li_parts)

        # 2. Q1 through two workers: cold, twice warm
        runs = []
        for i in range(3):
            table, ms, coord, delta, nbytes = _dist_run(tdf, torch, ctx, Q1, cuda_mod)
            assert_rows(table, q1_oracle(li_cols, dates), f"distributed Q1 run {i}")
            got = _sum_kernels(delta)
            if got["hash_agg"] != want_q1 or coord["hash_agg"] != 0:
                raise AssertionError(f"distributed Q1 run {i}: workers launched {got}, "
                                     f"coordinator {coord}; want {want_q1} grouped reduces "
                                     "in the workers")
            if sum(q for _, q in delta.values()) != DIST_PARTS:
                raise AssertionError(f"distributed Q1 run {i}: fragments {delta}")
            runs.append((ms, got, delta, nbytes))
        rep = {"query": "dist_tpch_q1_sf1_csv", "rows": SF1_ROWS, "partitions": DIST_PARTS,
               "workers": 2, "launches": runs[0][1], "cold_ms": runs[0][0],
               "warm_ms": [r[0] for r in runs[1:]],
               "per_worker": {a: d for a, d in runs[0][2].items()},
               "wire_bytes": runs[0][3], "csv_split_s": split_s, "card": card()}
        log("dist_q1: " + json.dumps(rep))
        log(f"distributed Q1 through 2 workers matches the numpy oracle ({want_q1} "
            "grouped-reduce launches in the workers a run)")
        reports.append(rep)

        # 2a. the same 4 partitions written as Parquet: cold, twice warm
        t0 = time.perf_counter()
        pq_parts, lo = [], 0
        for p, (_, rows) in enumerate(li_parts):
            part = os.path.join(out_dir, f"dist_parquet_lineitem_q1_part{p}.parquet")
            write_lineitem_parquet(part, li_cols, dates, lo, lo + rows)
            pq_parts.append((part, parquet_batches(rows, batch)))
            lo += rows
        write_s = time.perf_counter() - t0
        ctx.register_datasource("lineitem", PartitionedDataSource(
            [tdf.ParquetDataSource(p) for p, _ in pq_parts]))
        want_pq = 6 * sum(fold_groups(nb) for _, nb in pq_parts)
        runs = []
        for i in range(3):
            table, ms, coord, delta, nbytes = _dist_run(tdf, torch, ctx, Q1, cuda_mod)
            assert_rows(table, q1_oracle(li_cols, dates), f"distributed Parquet Q1 run {i}")
            got = _sum_kernels(delta)
            if got["hash_agg"] != want_pq or coord["hash_agg"] != 0 or \
                    sum(q for _, q in delta.values()) != DIST_PARTS:
                raise AssertionError(f"distributed Parquet Q1 run {i}: workers launched {got}, "
                                     f"coordinator {coord}, fragments {delta}; want {want_pq} "
                                     "grouped reduces in the workers")
            runs.append((ms, got, delta, nbytes))
        rep = {"query": "dist_tpch_q1_sf1_parquet", "rows": SF1_ROWS,
               "partitions": DIST_PARTS, "workers": 2, "launches": runs[0][1],
               "cold_ms": runs[0][0], "warm_ms": [r[0] for r in runs[1:]],
               "per_worker": {a: d for a, d in runs[0][2].items()},
               "wire_bytes": runs[0][3], "parquet_write_s": write_s, "card": card()}
        log("dist_q1_parquet: " + json.dumps(rep))
        log(f"distributed Q1 over 4 Parquet partitions through 2 workers matches the numpy "
            f"oracle ({want_pq} grouped-reduce launches in the workers a run)")
        reports.append(rep)

        # 3. Q12 through the shuffle join, then under DATAFUSION_TPU_SHUFFLE=0
        ctx.register_datasource("orders", PartitionedDataSource(
            [tdf.CsvDataSource(p, _schema_of(tdf, ORDERS_SCHEMA)) for p, _ in o_parts]))
        ctx.register_datasource("lineitem", PartitionedDataSource(
            [tdf.CsvDataSource(p, _schema_of(tdf, LINEITEM_Q12_SCHEMA)) for p, _ in l12_parts]))
        for knob, label in (("1", "shuffle"), ("0", "local_join")):
            os.environ["DATAFUSION_TPU_SHUFFLE"] = knob
            try:
                joins0 = METRICS.counts.get("shuffle.joins", 0)
                table, ms, coord, delta, nbytes = _dist_run(tdf, torch, ctx, Q12, cuda_mod)
                shuffled = METRICS.counts.get("shuffle.joins", 0) - joins0
            finally:
                del os.environ["DATAFUSION_TPU_SHUFFLE"]
            got = table.to_rows()
            if got != q12_oracle(star):
                raise AssertionError(f"distributed Q12 ({label}): {got} != {q12_oracle(star)}")
            # the coordinator's aggregate and ORDER BY launch the grouped
            # reduce and the sort; its local join (SHUFFLE=0) the build
            if coord["sort_kernel"] < 1 or coord["hash_agg"] < 1 or (
                    knob == "0" and coord["hash_build"] != 1) or (
                    (shuffled > 0) != (knob == "1")):
                raise AssertionError(f"distributed Q12 ({label}): coordinator launches "
                                     f"{coord}, shuffle joins {shuffled}")
            rep = {"query": f"dist_tpch_q12_sf1_{label}", "rows": len(star["l_orderkey"]),
                   "launches": coord, "worker_launches": _sum_kernels(delta),
                   "cold_ms": ms, "wire_bytes": nbytes, "card": card()}
            log(f"dist_q12_{label}: " + json.dumps(rep))
            reports.append(rep)
        log("distributed Q12 matches the numpy oracle through the shuffle join and "
            "through the coordinator's local join")

        # 2b. one worker killed: Q1 again, every fragment on the survivor
        ctx.register_datasource("lineitem", PartitionedDataSource(
            [tdf.CsvDataSource(p, _schema_of(tdf, LINEITEM_Q1_SCHEMA)) for p, _ in li_parts]))
        (victim, victim_addr), (_, survivor) = workers
        victim.kill()
        victim.wait(timeout=30)
        moved0 = METRICS.counts.get("coord.fragment_reassigned", 0)
        hedged0 = METRICS.counts.get("coord.hedges_dispatched", 0)
        table, ms, coord, delta, nbytes = _dist_run(tdf, torch, ctx, Q1, cuda_mod)
        assert_rows(table, q1_oracle(li_cols, dates), "distributed Q1 after a kill")
        key = f"{survivor[0]}:{survivor[1]}"
        dead = f"{victim_addr[0]}:{victim_addr[1]}"
        if dead in delta or delta[key][1] != DIST_PARTS or \
                delta[key][0]["hash_agg"] != want_q1:
            raise AssertionError(f"distributed Q1 after a kill: {delta}")
        moved = METRICS.counts.get("coord.fragment_reassigned", 0) - moved0
        if moved < 1:
            raise AssertionError("distributed Q1 after a kill: nothing was reassigned")
        rep = {"query": "dist_tpch_q1_sf1_failover", "rows": SF1_ROWS,
               "launches": delta[key][0], "ms": ms, "reassigned": moved,
               "hedged": METRICS.counts.get("coord.hedges_dispatched", 0) - hedged0,
               "wire_bytes": nbytes, "card": card()}
        log("dist_q1_failover: " + json.dumps(rep))
        log(f"distributed Q1 with one worker killed: the survivor answered all "
            f"{DIST_PARTS} fragments ({moved} reassigned)")
        reports.append(rep)
        ctx.close()
    finally:
        _stop_workers(workers)
    log(f"dist_phase: {time.perf_counter() - t_phase:.3f} s ({smi})")
    return reports


# ------------------------------------------------------------ phase 17


def _counter(name):
    from datafusion_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counts"].get(name, 0)


def _timer_ms(name):
    from datafusion_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["timings_s"].get(name, 0.0) * 1e3


def wire_bytes(arrays, dev, hints=None):
    """The bytes `batch.put_compressed` sends for host `arrays` (in their
    positions): each array's wire images as the host encode produces
    them (`hints` replays a core's codec choices), or its raw bytes
    where the wire is off."""
    from datafusion_tpu_torch.exec import batch as B

    if not B._wire_enabled(dev):
        return sum(B.device_array(np.asarray(a)).nbytes for a in arrays)
    total = 0
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(B.device_array(np.asarray(a)))
        hint = None if hints is None else hints.get(i)
        enc = None if hint is None else B._encode_wire_hinted(a, hint, dev)
        total += sum(w.nbytes for w in (enc or B._encode_wire(a, dev))[1])
    return total


def _fresh_source(tdf, src):
    """The batches of `src` as new batch objects around the same arrays:
    nothing is cached on them, so a scan copies every column again."""
    from datafusion_tpu_torch.exec.batch import RecordBatch

    return tdf.MemoryDataSource(src.schema, [
        RecordBatch(b.schema, list(b.data), list(b.validity), list(b.dicts),
                    num_rows=b.num_rows)
        for b in src.batches()])


def _same_bits(got, want, label):
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype or not np.array_equal(
                g.view(np.uint8) if g.dtype.kind in "fiu" else g,
                w.view(np.uint8) if w.dtype.kind in "fiu" else w):
            raise AssertionError(f"{label}: column {i} differs in its bits")


def phase_data_plane(tdf, cuda_mod, torch, ctx, li_src, li_cols, dates, star, smi):
    """The data plane (exec/batch.py, exec/materialize.py, the run sort's
    permutation planes and cache), on tables already in memory: the
    probes, the codec on Q1's columns, cold Q1 with the codec forced on,
    chosen by `auto` and off, the compaction of the SF-1 filter/project,
    the lineitem sort's permutation planes and its cache, and the TopK
    `a DESC, b`."""
    from datafusion_tpu_torch.exec import batch as B
    from datafusion_tpu_torch.exec.sort import SortRelation

    dev = ctx.device
    reports = []
    # 1. the probes
    knob = os.environ.get("DATAFUSION_TPU_WIRE")

    def wire(mode):
        if mode is None:
            os.environ.pop("DATAFUSION_TPU_WIRE", None)
        else:
            os.environ["DATAFUSION_TPU_WIRE"] = mode

    wire("auto")
    try:
        probes = {"link_rate_mbps": B.link_rate_mbps(dev),
                  "f64_device_exact": B._f64_device_exact(dev),
                  "decimal_division_exact": B._decimal_division_exact(dev),
                  "auto_codec_on": B._wire_enabled(dev),
                  "codec_max_link_mbps": B._WIRE_MAX_LINK_MBPS, "card": smi}
    finally:
        wire(knob)
    log("data_plane_probes: " + json.dumps(probes))
    if not (probes["f64_device_exact"] and probes["decimal_division_exact"]):
        raise AssertionError(f"data plane: an exact probe reads False: {probes}")
    if probes["auto_codec_on"] != (probes["link_rate_mbps"] < B._WIRE_MAX_LINK_MBPS):
        raise AssertionError(f"data plane: auto disagrees with the link: {probes}")

    # 2. the codec on Q1's columns, one batch each, round trips bit for bit
    first = next(iter(li_src.batches()))
    specs = {}
    wire("always")
    for f, col in zip(li_src.schema.fields, first.data):
        want = B.device_array(col)
        spec, _ = B._encode_wire(np.ascontiguousarray(want), dev)
        h0 = _counter("h2d.bytes")
        (got,) = B.put_compressed([col], dev)
        got = got.cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(got.view(np.uint8),
                                                         want.view(np.uint8)):
            raise AssertionError(f"data plane: {f.name} does not round-trip ({spec})")
        specs[f.name] = {"spec": list(spec), "raw_bytes": int(want.nbytes),
                         "wire_bytes": _counter("h2d.bytes") - h0}
    wire(knob)
    log("data_plane_codec: " + json.dumps({"rows": first.capacity, "columns": specs,
                                           "card": smi}))

    # 3. cold Q1 over fresh batch objects, the codec forced on, as auto
    # chooses it over this link, and off, in turns
    modes = ("always", "auto", "never")
    runs = {m: [] for m in modes}
    tables = {}
    for _ in range(3):
        for mode in modes:
            wire(mode)
            try:
                c = tdf.ExecutionContext(result_cache=False)
                c.register_datasource("lineitem", _fresh_source(tdf, li_src))
                h0, e0 = _counter("h2d.bytes"), _timer_ms("h2d.encode")
                t0 = time.perf_counter()
                table = tdf.collect(c.sql(Q1))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                runs[mode].append({"ms": ms, "h2d_bytes": _counter("h2d.bytes") - h0,
                                   "h2d_encode_ms": _timer_ms("h2d.encode") - e0})
            finally:
                wire(knob)
            if mode in tables:
                _same_bits(table, tables[mode], f"cold Q1 ({mode}) rerun")
            tables[mode] = table
    for mode in ("auto", "never"):
        _same_bits(tables["always"], tables[mode], f"cold Q1, codec on against {mode}")
    assert_rows(tables["always"], q1_oracle(li_cols, dates), "cold Q1 through the codec")
    chosen = "always" if probes["auto_codec_on"] else "never"
    if runs["auto"][0]["h2d_bytes"] != runs[chosen][0]["h2d_bytes"]:
        raise AssertionError(f"data plane: auto did not send what {chosen} sends: {runs}")
    rep = {"query": "data_plane_cold_q1_sf1", "rows": SF1_ROWS, "runs": runs,
           "p50_ms": {m: float(np.median([r["ms"] for r in v])) for m, v in runs.items()},
           "card": smi}
    log("data_plane_cold_q1: " + json.dumps(rep))

    # 4. the compaction of the SF-1 filter/project (lineitem of phase 3)
    c = tdf.ExecutionContext(result_cache=False)
    c.register_datasource("lineitem", li_src)
    d0, k0 = _counter("d2h.bytes"), _counter("d2h.compacted_batches")
    t0 = time.perf_counter()
    tdf.collect(c.sql(SF1_FILTER_PROJECT))
    torch.cuda.synchronize()
    log("data_plane_filter_project: " + json.dumps({
        "query": "lineitem_filter_project_sf1", "ms": (time.perf_counter() - t0) * 1e3,
        "d2h_bytes": _counter("d2h.bytes") - d0,
        "d2h_compacted_batches": _counter("d2h.compacted_batches") - k0, "card": smi}))

    # 5. the lineitem sort: cold, then the same relation twice more
    # (second-chance admission stores the permutation on the second run;
    # the third makes no sort launch)
    sel = star["l_quantity"] > 25
    mode, okey = star["l_shipmode"][sel], star["l_orderkey"][sel]
    order = np.lexsort((~okey, mode))
    want_sort = [mode[order], okey[order], star["l_extendedprice"][sel][order]]
    rel = ctx.sql(LINEITEM_SORT)
    sort_runs = []
    for i in range(3):
        p0, h0 = _counter("sort.perm_plane_bytes"), _counter("sort.perm_cache_hits")
        cuda_mod.reset_launch_counts()
        t0 = time.perf_counter()
        table = tdf.collect(rel)
        torch.cuda.synchronize()
        sort_runs.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "sort_launches": cuda_mod.launch_counts()["sort_kernel"],
                          "perm_plane_bytes": _counter("sort.perm_plane_bytes") - p0,
                          "perm_cache_hits": _counter("sort.perm_cache_hits") - h0})
        assert_columns(table, want_sort, f"data plane lineitem sort, run {i + 1}")
    if [r["sort_launches"] for r in sort_runs] != [1, 1, 0]:
        raise AssertionError(f"data plane: lineitem sort launches {sort_runs}")
    node = rel
    while not isinstance(node, SortRelation):
        node = node.child
    log("data_plane_sort: " + json.dumps({
        "query": "lineitem_filtered_sort_sf1", "rows_sorted": int(sel.sum()),
        "runs": sort_runs, "cached_runs": len(node._run_ops_cache), "card": smi}))

    # 6. the TopK `a DESC, b` (config 4's table, keys built on the card)
    tsrc, tc = sort4b_table(tdf, TOPK_ROWS)
    ctx.register_datasource("t4", tsrc)
    sql = "SELECT a, b, x FROM t4 ORDER BY a DESC, b LIMIT 100"
    table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, sql, "data_plane_topk_a_desc_b",
                              TOPK_ROWS, needs=("sort_kernel",))
    order = np.lexsort((tc[1], -tc[0]))[:100]
    assert_columns(table, [tc[0][order], tc[1][order], tc[2][order]], "data plane TopK")
    log("data_plane_topk: " + json.dumps({
        "query": rep["query"], "cold_ms": rep["cold_ms"], "p50_ms": rep["p50_ms"],
        "before_p50_ms": 129.563, "card": smi}))
    reports.append(rep)
    del tsrc, tc

    return reports


# ------------------------------------------------------------ phase 18

FLEET_A_CLIENTS = 4
FLEET_A_QUERIES = 6  # per A client, closed loop
FLEET_Q1_RUNS = 10
FLEET_SLO = "DATAFUSION_TPU_SLO_FLEET_Q1_P99"


def stream_round(tdf, torch, src, cols, dates, profile_round=True):
    """Tenant A's warm Q1 round over the resident SF-1 lineitem, alone
    and while tenant B's cold scans run on the server's other worker:
    a Server(shares={"A": 3, "B": 1}, workers=2, window_s=0.01,
    megabatch_max=16, pin=False), A's table resident (a `PinnedSource`
    made before the server starts, so its copies and ids are cached), B's
    the same batches behind a plain in-memory source, whose projection
    yields new batch objects each query: every B query copies the table
    to the card again.  A's 4 closed-loop clients send 6 Q1-shaped
    queries each (distinct l_shipdate cutoffs); B's one client sends Q1
    back to back for as long as A's contended round runs.  Returns A's
    metered device ms a query alone and under B, B's, both tenants'
    metered seconds of the contended round against its
    `device.dispatch` and (`profile_round`) against the device time of
    `torch.profiler` over it, the streams the served passes recorded
    their event pairs on (`pass_streams`: worker threads, distinct
    streams, passes on the default stream), each answer checked against
    the numpy oracle and its solo answer's bits, and the launches of the
    round."""
    import threading

    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.exec.cuda import hash_agg
    from datafusion_tpu_torch.obs.attribution import METER
    from datafusion_tpu_torch.serve import PinnedSource
    from datafusion_tpu_torch.utils import retry
    from datafusion_tpu_torch.utils.metrics import METRICS

    # the stream each served pass records its event pair on, by thread
    seen: dict = {}
    real_note = retry.note_launch

    def note_launch(seconds, events=None):
        if events is not None:
            seen.setdefault(threading.get_ident(), set()).add(
                torch.cuda.current_stream().cuda_stream)
        return real_note(seconds, events)

    ctx = tdf.ExecutionContext(result_cache=False)
    pin = PinnedSource(src, "lineitem_a")
    pin.ensure()
    ctx.register_datasource("lineitem_a", pin)
    ctx.register_datasource("lineitem_b", tdf.MemoryDataSource(src.schema, list(src.batches())))
    cutoffs = [dates[dates.index("1998-09-02") - 7 * i] for i in range(TENANT_CUTOFFS)]
    a_sqls = [[Q1.replace("1998-09-02", cutoffs[(FLEET_A_QUERIES * i + j) % TENANT_CUTOFFS])
               .replace("FROM lineitem", "FROM lineitem_a") for j in range(FLEET_A_QUERIES)]
              for i in range(FLEET_A_CLIENTS)]
    b_sql = Q1.replace("FROM lineitem", "FROM lineitem_b")
    solo = {s: tdf.collect(ctx.sql(s)) for s in sorted({s for c in a_sqls for s in c})}
    solo[b_sql] = tdf.collect(ctx.sql(b_sql))
    for s, table in solo.items():
        cut = next(c for c in cutoffs if f"'{c}'" in s) if "lineitem_a" in s else "1998-09-02"
        assert_rows(table, q1_oracle(cols, dates, cut), f"stream round solo {s[-60:]}")

    def a_round(srv):
        got, errors = [], []

        def client(sqls):
            try:
                for s in sqls:
                    got.append((s, srv.submit(s, client_id="A").result(timeout=600)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        m0 = METER.snapshot().get("A", {}).get("device_seconds", 0.0)
        threads = [threading.Thread(target=client, args=(c,)) for c in a_sqls]
        for th in threads:
            th.start()
        for th in threads:
            th.join(660)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"stream round: tenant A failed {errors[:1]}")
        n = sum(len(c) for c in a_sqls)
        return (METER.snapshot()["A"]["device_seconds"] - m0) / n * 1e3, got

    out = {}
    retry.note_launch = note_launch
    try:
        with ctx.serve(shares=TENANT_SHARES, workers=2, window_s=0.01, megabatch_max=16,
                       pin=False) as srv:
            a_round(srv)  # warm: A's ids and tables cached on the resident batches
            out["a_ms_alone"], got_alone = a_round(srv)
            METER.clear()  # the contended round's billing period
            stop = threading.Event()
            b_got, b_err = [], []

            def tenant_b():
                try:
                    while not stop.is_set():
                        b_got.append(srv.submit(b_sql, client_id="B").result(timeout=600))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    b_err.append(e)

            disp0 = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0)
            cuda_mod.reset_launch_counts()
            th = threading.Thread(target=tenant_b)
            prof = None
            if profile_round:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            try:
                th.start()
                while not b_got and not b_err and th.is_alive():
                    time.sleep(0.01)  # B's first cold scan is under way
                out["a_ms_under_b"], got_under = a_round(srv)
            finally:
                stop.set()
                th.join(660)
                torch.cuda.synchronize()
                if prof is not None:
                    prof.__exit__(None, None, None)
            launches = cuda_mod.launch_counts()
            multi = hash_agg.MULTI_LAUNCHES
            if b_err or th.is_alive() or not b_got:
                raise AssertionError(f"stream round: tenant B failed {b_err[:1]}")
    finally:
        retry.note_launch = real_note
        pin.release()
    default = torch.cuda.default_stream().cuda_stream
    out["pass_streams"] = {
        "threads": len(seen), "distinct": len(set().union(*seen.values())) if seen else 0,
        "per_thread_max": max((len(v) for v in seen.values()), default=0),
        "on_default": sum(default in v for v in seen.values())}
    meter = METER.snapshot()
    dispatch = METRICS.snapshot()["timings_s"].get("device.dispatch", 0.0) - disp0
    metered = sum(m.get("device_seconds", 0.0) for m in meter.values())
    out.update({
        "a_ratio": out["a_ms_under_b"] / out["a_ms_alone"],
        "b_queries": len(b_got),
        "b_ms": meter["B"]["device_seconds"] / len(b_got) * 1e3,
        "metered_s": {c: meter[c]["device_seconds"] for c in ("A", "B")},
        "dispatch_s": dispatch, "launches": launches, "query_axis_launches": multi,
    })
    if prof is not None:
        from torch.autograd import DeviceType

        out["profiler_device_ms"] = sum(
            e.device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 1e3
    for s, table in got_alone + got_under + [(b_sql, t) for t in b_got]:
        assert_same_bits(table, solo[s], f"stream round {s[-40:]}", key_cols=2)
    out["metered_matches_dispatch"] = bool(
        dispatch > 0 and abs(metered - dispatch) <= 1e-6 * dispatch)
    return out


def _worker_debug_line(proc):
    """The `worker debug: URL/debug` line a worker started with
    --http-port prints after its listening line: (host, port)."""
    import re

    # the line may sit in the pipe's read buffer already: read, do not
    # select (the worker prints its info line right after either way)
    line = proc.stdout.readline()
    m = re.search(r"http://([\d.]+):(\d+)/debug", line)
    if m is None:
        raise AssertionError(f"worker printed no debug plane: {line!r}")
    return m.group(1), int(m.group(2))


def _get(url, timeout=60):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def phase_fleet(tdf, cuda_mod, torch, src, cols, dates, smi):
    """Fleet observability on cuda:0 (serve.py's per-worker streams,
    obs/{recorder,aggregate,otlp,slo,httpd}.py, the worker's telemetry,
    the coordinator's fleet view, the console's modes):

    1. streams: `stream_round` (tenant A's warm Q1 alone and under tenant
       B's cold scans, shares 3:1).  Gates: every served pass recorded
       its event pair on its worker's own stream (no pass on the default
       stream, one stream a worker thread, the two workers' streams
       distinct); the tenants' metered seconds equal the round's
       `device.dispatch` (1e-6); every answer the oracle's and its solo
       answer's bits; A's metered ms a query under B within 2x of alone
       (each served pass's pairs sit behind the meter's host gate,
       exec/gate.py).  Printed: the profiler's device time of the
       round.
    2. pin bytes: a Server(workers=2) over the SF-1 lineitem serves Q1;
       the pin's accounted bytes must equal the storage bytes of the
       device tensors cached on its batches (printed beside the host
       estimate).
    3. funnel and ledger: warm Q1 10 times with a latency SLO declared
       through the environment (``DATAFUSION_TPU_SLO_FLEET_Q1_P99``, 1 us:
       Q1 breaches it) and the flight recorder's slow threshold at 0,
       the first run traced.  Gates: ``obs.telemetry_errors`` and
       ``device.ledger.leaks`` unchanged, 10 more ``query.latency``
       samples, the ``device.h2d`` events' bytes equal to ``h2d.bytes``,
       an ``slo_breach`` artifact and a ``slow_query`` artifact holding
       an OTLP document.
    4. debug plane: `start_debug_server(-1)` answers `/metrics`,
       `/debug/tenants`, `/debug/tail`, `/debug/qos`, `/debug/hbm`,
       `/debug/flights` and `/debug/bundle?format=tar` with 200;
       `/debug/hbm`'s pinned bytes equal step 2's; `config_snapshot`
       names the card.
    5. fleet: two workers with --http-port -1 run Q1 over phase 16's 4
       lineitem CSV partitions; `fleet_refresh()` holds 2 snapshots and
       `top_text` lists both with p50/p99; `cli top --workers` and `cli
       debug-bundle --workers --format tar` exit 0; one worker killed
       mid-query, after which `collect_flight_dumps` of the query's root
       holds the survivor's ring and not the victim's.
    `fleet_*` lines; returns the reports the `kernels` line counts."""
    import gc
    import tarfile
    import threading

    from datafusion_tpu_torch.obs import aggregate, recorder, slo
    from datafusion_tpu_torch.obs import trace as obs_trace
    from datafusion_tpu_torch.obs.device import LEDGER
    from datafusion_tpu_torch.obs.httpd import config_snapshot, start_debug_server
    from datafusion_tpu_torch.parallel import DistributedContext, PartitionedDataSource
    from datafusion_tpu_torch.serve import _cached_tensors

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    reports = []

    # 1. streams
    forced0 = _counter("meter.gate_forced")
    st = stream_round(tdf, torch, src, cols, dates)
    rep = {"query": "fleet_streams", **st, "gate_forced": _counter("meter.gate_forced") - forced0,
           "card": card()}
    log("fleet_streams: " + json.dumps(rep))
    if not st["metered_matches_dispatch"]:
        raise AssertionError(f"fleet streams: metered {st['metered_s']} != the round's "
                             f"device.dispatch {st['dispatch_s']}")
    ps = st["pass_streams"]
    if ps["on_default"] or ps["per_thread_max"] != 1 or ps["threads"] < 2 or \
            ps["distinct"] != ps["threads"]:
        raise AssertionError(f"fleet streams: served passes' streams {ps}: want one stream "
                             "a worker, none the default stream")
    if st["a_ratio"] > 2.0:
        raise AssertionError(f"fleet streams: tenant A billed {st['a_ms_under_b']:.6f} ms a "
                             f"query under B, {st['a_ratio']:.3f}x its {st['a_ms_alone']:.6f} "
                             "alone (bound 2x)")
    log(f"streams: {ps['threads']} serving workers on {ps['distinct']} streams; tenant A "
        f"billed {st['a_ms_alone']:.6f} ms a query alone, {st['a_ms_under_b']:.6f} under B's "
        f"cold scans ({st['a_ratio']:.3f}x, bound 2x); answers equal their solo bits")
    reports.append(rep)

    # 2. pin bytes (the server stays up for step 4's /debug/hbm)
    ctx = tdf.ExecutionContext(result_cache=False)
    ctx.register_datasource("lineitem", src)
    srv = ctx.serve(workers=2, window_s=0.01)
    try:
        cuda_mod.reset_launch_counts()
        table = srv.submit(Q1, client_id="A").result(timeout=600)
        launches = cuda_mod.launch_counts()
        assert_rows(table, q1_oracle(cols, dates), "fleet served Q1")
        pinned = ctx.datasources["lineitem"]
        tensors = [t for t in _cached_tensors(list(pinned._resident))
                   if t.device.type == ctx.device.type]
        device_bytes = sum({(t.device, t.untyped_storage().data_ptr()):
                            t.untyped_storage().nbytes() for t in tensors}.values())
        pin_bytes = LEDGER.pins_snapshot()["table:lineitem"]["bytes"]
        host_est = pinned.estimated_bytes()
        rep = {"query": "fleet_pin_bytes", "pin_bytes": pin_bytes,
               "cached_device_bytes": device_bytes, "host_estimate_bytes": host_est,
               "cached_tensors": len(tensors), "launches": launches, "card": card()}
        log("fleet_pin_bytes: " + json.dumps(rep))
        if not tensors or pin_bytes != device_bytes:
            raise AssertionError(f"fleet pin bytes: {pin_bytes} != cached device bytes "
                                 f"{device_bytes}")
        reports.append(rep)

        # 3. funnel and ledger: warm Q1 under a breached SLO
        flight_dir = os.path.join(out_dir, "flight")
        os.makedirs(flight_dir, exist_ok=True)
        for f in os.listdir(flight_dir):
            os.remove(os.path.join(flight_dir, f))
        saved = (recorder._SLOW_S, recorder._DIR, recorder._DUMP_INTERVAL_S, slo.WATCHDOG)
        os.environ[FLEET_SLO] = "0.000001"
        os.environ["DATAFUSION_TPU_SLO_MIN_SAMPLES"] = str(FLEET_Q1_RUNS)
        qctx = tdf.ExecutionContext(result_cache=False)
        qctx.register_datasource("lineitem", src)
        tdf.collect(qctx.sql(Q1))  # warm
        try:
            recorder.configure(slow_s=0.0, directory=flight_dir, dump_interval_s=0.0)
            slo.WATCHDOG = slo._arm_from_env()
            c0 = _counts()
            h0 = aggregate.HISTOGRAMS["query.latency"].count
            t_ns = time.time_ns()
            cuda_mod.reset_launch_counts()
            ms = []
            for i in range(FLEET_Q1_RUNS):
                t0 = time.perf_counter()
                if i == 0:
                    with obs_trace.session():
                        table = tdf.collect(qctx.sql(Q1))
                else:
                    table = tdf.collect(qctx.sql(Q1))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                assert_rows(table, q1_oracle(cols, dates), f"fleet funnel Q1 {i}")
            launches = cuda_mod.launch_counts()
            rows = slo.WATCHDOG.evaluate()
            c1 = _counts()
            h2d_events = sum(e["attrs"]["bytes"] for e in recorder.events("device.h2d")
                             if e["ts_ns"] >= t_ns)
        finally:
            del os.environ[FLEET_SLO], os.environ["DATAFUSION_TPU_SLO_MIN_SAMPLES"]
            recorder.configure(slow_s=saved[0], directory=saved[1], dump_interval_s=saved[2])
            slo.WATCHDOG = saved[3]
        dumps = [json.load(open(os.path.join(flight_dir, f), encoding="utf-8"))
                 for f in sorted(os.listdir(flight_dir))]
        breach = [d for d in dumps if d["reason"] == "slo_breach"]
        slow_otlp = [d for d in dumps if d["reason"] == "slow_query" and d.get("otlp")]
        delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in
                 ("obs.telemetry_errors", "device.ledger.leaks", "h2d.bytes")}
        rep = {"query": "fleet_funnel", "runs": FLEET_Q1_RUNS, "ms": ms,
               "latency_samples": aggregate.HISTOGRAMS["query.latency"].count - h0,
               "counters": delta, "h2d_event_bytes": h2d_events, "slo": rows,
               "artifacts": {"slo_breach": len(breach), "slow_query_with_otlp": len(slow_otlp),
                             "all": len(dumps)},
               "launches": launches, "card": card()}
        log("fleet_funnel: " + json.dumps(rep, default=str))
        if delta["obs.telemetry_errors"] or delta["device.ledger.leaks"]:
            raise AssertionError(f"fleet funnel: {delta}")
        if rep["latency_samples"] != FLEET_Q1_RUNS:
            raise AssertionError(f"fleet funnel: {rep['latency_samples']} latency samples")
        if h2d_events != delta["h2d.bytes"]:
            raise AssertionError(f"fleet funnel: device.h2d events carry {h2d_events} bytes, "
                                 f"h2d.bytes counted {delta['h2d.bytes']}")
        if not any(r["breached"] for r in rows) or not breach or not slow_otlp:
            raise AssertionError(f"fleet funnel: SLO rows {rows}, {len(breach)} breach and "
                                 f"{len(slow_otlp)} OTLP artifacts")
        reports.append(rep)

        # 4. the debug plane
        dbg = start_debug_server(-1)
        try:
            codes = {}
            for route in ("/metrics", "/debug/tenants", "/debug/tail", "/debug/qos",
                          "/debug/hbm", "/debug/flights", "/debug/bundle?format=tar&seconds=0.2"):
                code, body = _get(dbg.url + route)
                codes[route] = code
                if route == "/debug/hbm":
                    hbm = json.loads(body)
                if route.startswith("/debug/bundle"):
                    with tarfile.open(fileobj=io.BytesIO(body)) as tf:
                        members = tf.getnames()
        finally:
            dbg.close()
        cfg = config_snapshot()
        rep = {"query": "fleet_debug_plane", "codes": codes, "bundle_members": members,
               "hbm_pinned_bytes": hbm.get("pinned_bytes"),
               "config": {k: cfg.get(k) for k in ("backend", "devices", "torch", "cuda")},
               "card": card()}
        log("fleet_debug_plane: " + json.dumps(rep))
        if any(c != 200 for c in codes.values()):
            raise AssertionError(f"fleet debug plane: {codes}")
        if hbm.get("pinned_bytes") != pin_bytes:
            raise AssertionError(f"fleet debug plane: /debug/hbm pinned {hbm.get('pinned_bytes')}"
                                 f" != {pin_bytes}")
        if cfg["backend"] != "cuda" or cfg["devices"][0] != torch.cuda.get_device_name(0):
            raise AssertionError(f"fleet debug plane: config_snapshot {cfg}")
    finally:
        srv.stop()

    # 5. the fleet: two workers with their debug planes
    li_parts = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                      if f.startswith("dist_lineitem_q1_part"))
    if len(li_parts) != DIST_PARTS:
        raise AssertionError(f"fleet: phase 16's partitions are missing ({li_parts})")
    workers = _start_workers(2, out_dir, extra=("--http-port", "-1"))
    try:
        debug = [_worker_debug_line(proc) for proc, _ in workers]
        addrs = [a for _, a in workers]
        dctx = DistributedContext(addrs, result_cache=False)
        schema = _schema_of(tdf, LINEITEM_Q1_SCHEMA)
        dctx.register_datasource("lineitem", PartitionedDataSource(
            [tdf.CsvDataSource(p, schema) for p in li_parts]))
        table, q1_ms, _, delta, _ = _dist_run(tdf, torch, dctx, Q1, cuda_mod)
        assert_rows(table, q1_oracle(cols, dates), "fleet distributed Q1")
        held = dctx.fleet_refresh()
        top = dctx.top_text()
        env = dict(os.environ)
        spec = ",".join(f"{h}:{p}" for h, p in addrs)
        top_run = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.cli", "top",
                                  "--workers", spec], capture_output=True, text=True,
                                 timeout=300, env=env, cwd=here)
        bundle_dir = os.path.join(out_dir, "fleet_bundles")
        bundle_run = subprocess.run(
            [sys.executable, "-m", "datafusion_tpu_torch.cli", "debug-bundle", "--workers",
             ",".join(f"{h}:{p}" for h, p in debug), "--out", bundle_dir, "--format", "tar",
             "--seconds", "0.2"], capture_output=True, text=True, timeout=300, env=env,
            cwd=here)
        # one worker killed mid-query: the survivor's ring, not the victim's
        rel = dctx.sql(Q1)
        result = {}

        def run():
            try:
                result["table"] = tdf.collect(rel)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                result["error"] = e

        th = threading.Thread(target=run)
        th.start()
        time.sleep(1.0)
        (victim, victim_addr), (_, survivor) = workers
        victim.kill()
        victim.wait(timeout=30)
        th.join(600)
        if "error" in result or th.is_alive():
            raise AssertionError(f"fleet: Q1 after the kill failed {result.get('error')!r}")
        assert_rows(result["table"], q1_oracle(cols, dates), "fleet Q1 after a kill")
        dumps = rel.collect_flight_dumps(None)
        dctx.close()
    finally:
        _stop_workers(workers)
    key, dead = f"{survivor[0]}:{survivor[1]}", f"{victim_addr[0]}:{victim_addr[1]}"
    rep = {"query": "fleet_workers", "q1_ms": q1_ms, "snapshots": held,
           "launches": _sum_kernels(delta),
           "top_rc": top_run.returncode, "bundle_rc": bundle_run.returncode,
           "bundles": sorted(os.listdir(bundle_dir)) if os.path.isdir(bundle_dir) else [],
           "dump_nodes": sorted(dumps), "survivor_events": len(dumps.get(key, {}).get(
               "events", [])), "card": card()}
    log("fleet_workers: " + json.dumps(rep))
    log(top)
    if held != 2 or not all(f"node {a}:" in top and "p50=" in top and "p99=" in top
                            for a in spec.split(",")):
        raise AssertionError(f"fleet: {held} snapshots; top:\n{top}")
    if top_run.returncode or bundle_run.returncode or len(rep["bundles"]) != 2:
        raise AssertionError(f"fleet console: top {top_run.returncode} {top_run.stderr[-400:]}"
                             f" bundle {bundle_run.returncode} {bundle_run.stdout[-400:]}")
    if key not in dumps or dead in dumps or not rep["survivor_events"]:
        raise AssertionError(f"fleet: flight dumps after the kill {sorted(dumps)}")
    reports.append(rep)
    log(f"fleet_phase: {time.perf_counter() - t_phase:.3f} s ({smi})")
    return reports



CLUSTER_TTL_S = 2.0  # every process of the phase: the lease TTL
CLUSTER_QUORUM = 2
CLUSTER_CMD = ("-m", "datafusion_tpu_torch.cluster")


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _start_replicas(addrs, out_dir):
    """The 3-replica service: `python -m datafusion_tpu_torch.cluster` on
    `addrs` (the first the primary, the others its standbys), write
    quorum 2, a write-ahead log each.  One at a time: a replica probes
    its peers before it serves, and two that start together each wait
    out the other's probe.  Returns the processes; one that does not
    come up fails the phase."""
    import select
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    peers = ",".join(addrs)
    procs = []

    def start(i):
        wal = os.path.join(out_dir, f"cluster_wal{i}")
        shutil.rmtree(wal, ignore_errors=True)
        env = dict(os.environ, DATAFUSION_TPU_WAL_DIR=wal,
                   DATAFUSION_TPU_CLUSTER_QUORUM=str(CLUSTER_QUORUM))
        args = ["--bind", addrs[i], "--peers", peers]
        if i:
            args += ["--standby-of", addrs[0], "--rank", str(i - 1)]
        with open(os.path.join(out_dir, f"cluster{i}.err"), "w") as err:
            procs.append(subprocess.Popen([sys.executable, *CLUSTER_CMD, *args], cwd=here,
                                          env=env, stdout=subprocess.PIPE, stderr=err,
                                          text=True))

    def listening(i):
        proc = procs[i]
        ready, _, _ = select.select([proc.stdout], [], [], 180)
        line = proc.stdout.readline() if ready else ""
        if "listening on" not in line:
            raise AssertionError(f"cluster replica {i} did not start: {line!r} "
                                 f"(see build/chip_smoke/cluster{i}.err)")

    try:
        for i in range(len(addrs)):
            start(i)
            listening(i)
        return procs
    except BaseException:
        _stop_workers([(p, None) for p in procs])
        raise


def _wait(cond, timeout, step=0.02):
    """Seconds until `cond()` is true, polled every `step`; None past
    `timeout`."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return time.perf_counter() - t0
        time.sleep(step)
    return None


def _status_or_none(client):
    from datafusion_tpu_torch.errors import ExecutionError

    try:
        return client.status()
    except (ConnectionError, OSError, ExecutionError):
        return None


def phase_cluster(tdf, cuda_mod, torch, cols, dates, smi):
    """The cluster control plane (datafusion_tpu_torch/cluster/) over
    phase 16's 4 lineitem CSV partitions:

    1. a 3-replica service (a primary and two standbys, write quorum 2,
       a write-ahead log each) and two `--cluster` workers on cuda:0,
       every process with a 2 s lease TTL; a coordinator given only
       `cluster=` finds both workers and runs Q1 cold and warm (its
       result cache replays the warm run).  Gates: the oracle's rows,
       both workers launched the grouped reduce (their `status`).
    2. a second coordinator, a fresh context: Q1 is a shared-tier hit
       (`CachedResultRelation`, `shared`), the first one's bits, and
       neither worker launches.
    3. `broadcast_invalidate("lineitem")`: both workers apply it within
       one heartbeat (the agent's refresh interval, TTL / 3, plus 0.5 s
       for the status polls).
    4. a writer puts keys through the HA client while the primary is
       `kill -9`ed: a standby promotes within one TTL of the kill, every
       write acknowledged under W=2 reads back, the membership epoch
       holds (the workers' leases were re-armed), the term rises by one,
       and the first coordinator's next Q1 answers the oracle's rows.
    5. `kill -9` of one worker: its lease lapses (within a TTL and a
       refresh), the epoch rises by one, and Q1 answers from the
       survivor.
    `cluster_*` lines; returns the reports the `kernels` line counts."""
    import threading

    from datafusion_tpu_torch import cache as qcache
    from datafusion_tpu_torch.cache.result import CachedResultRelation
    from datafusion_tpu_torch.cluster import ClusterClient
    from datafusion_tpu_torch.parallel import DistributedContext, PartitionedDataSource

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke")
    li_parts = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                      if f.startswith("dist_lineitem_q1_part"))
    if len(li_parts) != DIST_PARTS:
        raise AssertionError(f"cluster: phase 16's partitions are missing ({li_parts})")
    want = q1_oracle(cols, dates)
    schema = _schema_of(tdf, LINEITEM_Q1_SCHEMA)
    saved_ttl = os.environ.get("DATAFUSION_TPU_CLUSTER_TTL_S")
    os.environ["DATAFUSION_TPU_CLUSTER_TTL_S"] = str(CLUSTER_TTL_S)
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(3)]
    endpoints = ",".join(addrs)
    replicas, workers, ctxs = [], [], []
    steps = {}
    try:
        replicas = _start_replicas(addrs, out_dir)
        workers = _start_workers(2, out_dir, extra=("--cluster", endpoints))
        worker_addrs = {f"{h}:{p}" for _, (h, p) in workers}
        client = ClusterClient(endpoints)
        if _wait(lambda: set(client.membership()["workers"]) >= worker_addrs, 60) is None:
            raise AssertionError(f"cluster: workers never registered "
                                 f"({client.membership()['workers']})")

        def coordinator(**kw):
            ctx = DistributedContext(cluster=endpoints, **kw)
            ctx.register_datasource("lineitem", PartitionedDataSource(
                [tdf.CsvDataSource(p, schema) for p in li_parts]))
            ctxs.append(ctx)
            return ctx

        # 1. discovery, Q1 cold and warm
        with qcache.configured(enabled=True):
            ca = coordinator()
            found = {f"{w.host}:{w.port}" for w in ca.workers}
            if found != worker_addrs:
                raise AssertionError(f"cluster: the coordinator found {found}, "
                                     f"want {worker_addrs}")
            cold, cold_ms, _, delta, _ = _dist_run(tdf, torch, ca, Q1, cuda_mod)
            assert_rows(cold, want, "cluster Q1 cold")
            launches = _sum_kernels(delta)
            per_worker = {a: k.get("hash_agg", 0) for a, (k, _) in delta.items()}
            if len(per_worker) != 2 or min(per_worker.values()) < 1:
                raise AssertionError(f"cluster: grouped-reduce launches a worker {per_worker}")
            warm, warm_ms, _, wdelta, _ = _dist_run(tdf, torch, ca, Q1, cuda_mod)
            assert_same_bits(warm, cold, "cluster Q1 warm", key_cols=2)
            steps["q1"] = {"cold_ms": cold_ms, "warm_ms": warm_ms,
                           "warm_worker_launches": _sum_kernels(wdelta)}
            if not ca._shared_tier.flush(timeout_s=30.0):
                raise AssertionError("cluster: the shared tier did not publish Q1")

            # 2. a second coordinator: the shared tier's hit
            cb = coordinator()
            before = _worker_counts(cb)
            t0 = time.perf_counter()
            rel = cb.sql(Q1)
            hit = tdf.collect(rel)
            hit_ms = (time.perf_counter() - t0) * 1e3
            hdelta = _counts_delta(before, _worker_counts(cb))
        if not isinstance(rel, CachedResultRelation) or not rel.entry.shared:
            raise AssertionError(f"cluster: the second coordinator ran {type(rel).__name__}, "
                                 "not a shared-tier hit")
        assert_same_bits(hit, cold, "cluster shared-tier hit", key_cols=2)
        if any(_sum_kernels(hdelta).values()):
            raise AssertionError(f"cluster: the shared-tier hit launched {hdelta}")
        steps["shared_hit"] = {"ms": hit_ms, "worker_launches": _sum_kernels(hdelta),
                               "shared_hits": cb.result_cache.stats()["shared_hits"]}

        # 3. the invalidation broadcast reaches both workers
        def applied():
            st = ca.worker_status()
            return {a: (s or {}).get("cluster", {}).get("events_applied", 0)
                    for a, s in st.items()}

        base = applied()
        refresh_s = CLUSTER_TTL_S / 3.0
        t0 = time.perf_counter()
        ca.broadcast_invalidate("lineitem")
        inv_s = _wait(lambda: all(v > base.get(a, 0) for a, v in applied().items()),
                      10 * refresh_s, step=0.01)
        steps["invalidate"] = {"seconds": inv_s, "heartbeat_s": refresh_s}
        if inv_s is None or inv_s > refresh_s + 0.5:
            raise AssertionError(f"cluster: the invalidation took {inv_s} s to reach both "
                                 f"workers (heartbeat {refresh_s:.3f} s)")

        # 4. kill -9 the primary under quorum writes
        st0 = client.status()
        epoch0, term0 = st0["epoch"], st0["term"]
        acked, stop = {}, threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                key, value = f"smoke/kv/{i}", {"i": i}
                try:
                    client.put(key, value)
                    acked[key] = value
                except Exception:  # noqa: BLE001 — an unacknowledged write owes nothing
                    pass
                i += 1
                time.sleep(0.005)

        th = threading.Thread(target=writer)
        th.start()
        time.sleep(0.5)
        replicas[0].kill()
        replicas[0].wait(timeout=30)
        t_kill = time.perf_counter()
        standbys = [ClusterClient(a) for a in addrs[1:]]

        def promoted():
            return any((_status_or_none(c) or {}).get("role") == "primary" for c in standbys)

        takeover_s = _wait(promoted, 10 * CLUSTER_TTL_S)

        def terms():
            return [(s or {}).get("cluster", {}).get("term")
                    for s in ca.worker_status().values()]

        # both workers heartbeat to the new primary (their agents saw the
        # new term) before the epoch is read: a lease that lapsed in the
        # takeover would have moved it by then
        rejoin_s = _wait(lambda: all(t == term0 + 1 for t in terms()), 5 * CLUSTER_TTL_S,
                         step=0.05)
        stop.set()
        th.join(timeout=60)
        st1 = next(s for s in map(_status_or_none, standbys)
                   if s is not None and s.get("role") == "primary")
        lost = [k for k, v in acked.items() if client.get(k) != v]
        after_kill = coordinator(result_cache=False)
        table, q1_after_ms, _, adelta, _ = _dist_run(tdf, torch, after_kill, Q1, cuda_mod)
        assert_rows(table, want, "cluster Q1 after the primary's kill")
        steps["failover"] = {"takeover_s": takeover_s, "workers_on_new_term_s": rejoin_s,
                             "acked_writes": len(acked),
                             "lost_writes": len(lost), "epoch": [epoch0, st1["epoch"]],
                             "term": [term0, st1["term"]], "q1_ms": q1_after_ms,
                             "worker_launches": _sum_kernels(adelta)}
        if takeover_s is None or takeover_s > CLUSTER_TTL_S:
            raise AssertionError(f"cluster: takeover in {takeover_s} s (TTL {CLUSTER_TTL_S})")
        if lost or len(acked) < 20:
            raise AssertionError(f"cluster: {len(lost)} of {len(acked)} acknowledged writes "
                                 "lost in the failover")
        if st1["epoch"] != epoch0 or st1["term"] != term0 + 1:
            raise AssertionError(f"cluster: epoch {epoch0} -> {st1['epoch']}, term {term0} -> "
                                 f"{st1['term']} across the failover")

        # 5. kill -9 a worker: its lease lapses
        (victim, vaddr), (_, survivor) = workers
        vkey = f"{vaddr[0]}:{vaddr[1]}"
        epoch1 = client.membership()["epoch"]
        victim.kill()
        victim.wait(timeout=30)
        lapse_s = _wait(lambda: vkey not in client.membership()["workers"],
                        4 * CLUSTER_TTL_S, step=0.05)
        epoch2 = client.membership()["epoch"]
        table, q1_survivor_ms, _, sdelta, _ = _dist_run(tdf, torch, after_kill, Q1, cuda_mod)
        assert_rows(table, want, "cluster Q1 on the survivor")
        skey = f"{survivor[0]}:{survivor[1]}"
        steps["worker_kill"] = {"lapse_s": lapse_s, "epoch": [epoch1, epoch2],
                                "q1_ms": q1_survivor_ms,
                                "worker_launches": {a: k for a, (k, _) in sdelta.items()}}
        if lapse_s is None or lapse_s > CLUSTER_TTL_S + CLUSTER_TTL_S / 3.0 + 0.5:
            raise AssertionError(f"cluster: the killed worker's lease lapsed after {lapse_s} s")
        if epoch2 != epoch1 + 1:
            churn = [e for e in client.events_since(0)["events"]
                     if e["kind"] in ("join", "leave")]
            raise AssertionError(f"cluster: epoch {epoch1} -> {epoch2} after a worker's "
                                 f"death (membership events {churn})")
        if set(sdelta) != {skey} or not sdelta[skey][0].get("hash_agg"):
            raise AssertionError(f"cluster: Q1 after the worker's death ran on {sdelta}")
    finally:
        for ctx in ctxs:
            ctx.close()
        _stop_workers(workers)
        _stop_workers([(p, None) for p in replicas])
        if saved_ttl is None:
            os.environ.pop("DATAFUSION_TPU_CLUSTER_TTL_S", None)
        else:
            os.environ["DATAFUSION_TPU_CLUSTER_TTL_S"] = saved_ttl
    total = {k: launches.get(k, 0) + steps["failover"]["worker_launches"].get(k, 0)
             + sum(w.get(k, 0) for w in steps["worker_kill"]["worker_launches"].values())
             for k in ("hash_agg", "hash_build", "sort_kernel")}
    rep = {"query": "cluster", "replicas": len(addrs), "ttl_s": CLUSTER_TTL_S,
           "write_quorum": CLUSTER_QUORUM, "cold_worker_launches": per_worker, **steps,
           "launches": total, "card": card()}
    log("cluster_q1: " + json.dumps({"cold_ms": steps["q1"]["cold_ms"],
                                     "warm_ms": steps["q1"]["warm_ms"],
                                     "per_worker_hash_agg": per_worker}))
    log("cluster_shared_hit: " + json.dumps(steps["shared_hit"]))
    log("cluster_invalidate: " + json.dumps(steps["invalidate"]))
    log("cluster_failover: " + json.dumps(steps["failover"]))
    log("cluster_worker_kill: " + json.dumps(steps["worker_kill"]))
    log("cluster: " + json.dumps(rep))
    log(f"cluster_phase: {time.perf_counter() - t_phase:.3f} s ({smi})")
    return [rep]


# ------------------------------------------------------------ phase 20


ANALYSIS_CMD = ("chip_smoke.py", "--analysis-round")  # the child, from the checkout
ANALYSIS_WORKERS = 2
ANALYSIS_CLIENTS = 8
ANALYSIS_PROFILE_HZ = 97
ANALYSIS_DDL_ROWS = 262_144  # two SF-1 batches: the served DDL's CSV
ANALYSIS_P50_RUNS = 8  # served Q1 runs a lockcheck turn
ANALYSIS_TURNS = ("on", "off", "on", "off")
ANALYSIS_TOPK = "SELECT s, b, x FROM t ORDER BY s DESC LIMIT 100"  # topk_cases' first
ANALYSIS_Q12 = Q12.replace("lineitem", "li12")  # the star's lineitem, renamed


def _analysis_turn(tdf, lockcheck, turn, src):
    """One served Q1 turn's context and server.  For the "off" turn the
    locks a context and a server make are plain, and so are the two
    module-level locks every query takes (the metrics registry's and the
    kernel counts'); the other module-level locks of the child, made at
    import, stay tracked."""
    import threading

    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.utils.metrics import METRICS

    lockcheck._ENABLED = turn == "on"
    METRICS._lock = lockcheck.make_lock("utils.metrics")
    cuda_mod.COUNT_LOCK = lockcheck.make_lock("exec.kernel_counts")
    if turn == "off":
        assert isinstance(METRICS._lock, type(threading.Lock()))
    ctx = tdf.ExecutionContext(result_cache=False)
    ctx.register_datasource("lineitem", src)
    return ctx, ctx.serve(workers=ANALYSIS_WORKERS, window_s=0.005)


def analysis_round(out_path) -> int:
    """The lockcheck-enabled child of `phase_analysis` (run with
    DATAFUSION_TPU_LOCKCHECK=1 and DATAFUSION_TPU_PROFILE_HZ set); writes
    its findings as JSON to `out_path`.  Raises on any wrong answer."""
    import glob

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.analysis import lockcheck
    from datafusion_tpu_torch.exec import cuda as cuda_mod
    from datafusion_tpu_torch.obs import httpd, profiler, recorder
    from datafusion_tpu_torch.utils.metrics import METRICS

    if not (lockcheck.enabled() and profiler.continuous_running()):
        raise AssertionError("analysis round: lockcheck or the continuous profiler is off")
    flight_dir = os.environ["DATAFUSION_TPU_FLIGHT_DIR"]
    t0 = time.perf_counter()
    src, cols, dates = lineitem_sf1(tdf, 131_072)
    topk_src, topk_cols = topk_table(tdf)
    star, star_cols = star_sf1(tdf, 131_072)
    gen_s = time.perf_counter() - t0
    ctx = tdf.ExecutionContext(result_cache=False)  # cuda:0
    ctx.register_datasource("lineitem", src)
    ctx.register_datasource("t", topk_src)
    ctx.register_datasource("orders", star["orders"])
    ctx.register_datasource("li12", star["lineitem"])
    events = tdf.Schema([tdf.Field("k", tdf.DataType.INT64, False),
                         tdf.Field("v", tdf.DataType.FLOAT64, False)])
    ctx.register_datasource("events", tdf.MemoryDataSource(
        events, [tdf.make_host_batch(events, [np.arange(64) % 4, np.arange(64.0)])]))
    ing = ctx.ingest(wal_dir=os.path.join(flight_dir, "wal"))
    _, topk_sql, topk_out, topk_order = topk_cases(topk_cols)[0]
    assert topk_sql == ANALYSIS_TOPK
    srv = ctx.serve(workers=ANALYSIS_WORKERS, window_s=0.005)
    try:
        cuda_mod.reset_launch_counts()
        per_client = [[Q1, ANALYSIS_TOPK, ANALYSIS_Q12] for _ in range(ANALYSIS_CLIENTS)]
        results, lat, wall = _serve_clients(srv, per_client)
        launches = cuda_mod.launch_counts()
        assert_rows(results[Q1], q1_oracle(cols, dates), "analysis served Q1")
        table = results[ANALYSIS_TOPK]
        for i, col in enumerate(topk_out):
            if not np.array_equal(np.asarray(table.columns[i]), col[topk_order]):
                raise AssertionError("analysis served TopK: rows or order differ")
        if results[ANALYSIS_Q12].to_rows() != q12_oracle(star_cols):
            raise AssertionError("analysis served Q12 differs from its oracle")
        ack = srv.append("events", {"k": [7, 7], "v": [0.5, 0.25]}, client_id="ingest")
        got = srv.submit("SELECT k, COUNT(1), SUM(v) FROM events GROUP BY k").result(
            timeout=120).to_rows()
        if sorted(got) != [(0, 16, 480.0), (1, 16, 496.0), (2, 16, 512.0),
                           (3, 16, 528.0), (7, 2, 0.75)]:
            raise AssertionError(f"analysis served append: {sorted(got)}")
        if srv.admitted + srv.shed != srv.submitted:
            raise AssertionError("analysis: admitted + shed != submitted")
    finally:
        srv.stop()
    # a result-cache hit on a context with the cache on
    cctx = tdf.ExecutionContext()
    cctx.register_datasource("lineitem", src)
    hits = METRICS.counts.get("cache.result.hits", 0)
    first = tdf.collect(cctx.sql(Q1)).to_rows()
    if tdf.collect(cctx.sql(Q1)).to_rows() != first or \
            METRICS.counts.get("cache.result.hits", 0) <= hits:
        raise AssertionError("analysis: the repeated Q1 was no result-cache hit")
    # one slow-query artifact (every query is slow for one run) and a bundle
    recorder.configure(slow_s=0.0, dump_interval_s=0.0)
    tdf.collect(ctx.sql(Q1))
    recorder.configure(slow_s=10.0, dump_interval_s=30.0)
    paths = sorted(glob.glob(os.path.join(flight_dir, "flight-*.json")))
    with open(paths[-1]) as f:
        artifact = json.load(f)
    bundle = httpd.build_bundle(profile_seconds=0)
    engine_report = lockcheck.report()
    # served Q1's p50 with lockcheck on and off, in turns (information)
    p50 = {"on": [], "off": []}
    for turn in ANALYSIS_TURNS:
        tctx, tsrv = _analysis_turn(tdf, lockcheck, turn, src)
        try:
            tsrv.submit(Q1).result(timeout=120)  # warm the pin
            times = []
            for _ in range(ANALYSIS_P50_RUNS):
                t1 = time.perf_counter()
                tsrv.submit(Q1).result(timeout=120)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        finally:
            tsrv.stop()
        p50[turn].append(float(np.median(times)))
        del tctx
    lockcheck._ENABLED = True
    out = {
        "gen_s": gen_s, "served_wall_s": wall, "served_queries": len(lat),
        "served_p50_ms": float(np.median(lat)), "launches": launches,
        "append_ack": ack, "artifact_reason": artifact.get("reason"),
        "artifact_keys": sorted(artifact), "bundle_keys": sorted(bundle),
        "profile_samples": profiler.continuous_report().samples,
        "engine_report": engine_report, "q1_p50_ms": p50,
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


class _CsvRows:
    """A CSV written by `ResultTable.to_csv`, read back as Q1's rows."""

    def __init__(self, path):
        import csv

        with open(path, newline="") as f:
            r = list(csv.reader(f))
        self.header = r[0]
        self.rows = [(a, b, *map(float, rest[:-1]), int(rest[-1])) for a, b, *rest in r[1:]]

    def to_rows(self):
        return self.rows


def phase_analysis(tdf, cuda_mod, torch, li_src, li_cols, dates, smi):
    from datafusion_tpu_torch.parallel.physical import PhysicalPlan
    from datafusion_tpu_torch.sql.parser import parse_sql

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "chip_smoke", "analysis")
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # 1. the linter over the package, on this machine (no jax here)
    lint = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.analysis",
                           "datafusion_tpu_torch"], cwd=here, capture_output=True,
                          text=True, timeout=300)
    log("analysis_lint: " + lint.stdout.strip().splitlines()[-1])
    if lint.returncode != 0:
        raise AssertionError(f"analysis: the linter found:\n{lint.stdout}{lint.stderr}")
    # 2. the lockcheck-enabled child
    report_path = os.path.join(out_dir, "lockcheck.json")
    child_out = os.path.join(out_dir, "round.json")
    env = dict(os.environ, DATAFUSION_TPU_LOCKCHECK="1",
               DATAFUSION_TPU_LOCKCHECK_FILE=report_path,
               DATAFUSION_TPU_PROFILE_HZ=str(ANALYSIS_PROFILE_HZ),
               DATAFUSION_TPU_FLIGHT_DIR=out_dir)
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "round.err"), "w") as err:
        child = subprocess.run([sys.executable, *ANALYSIS_CMD, child_out], cwd=here, env=env,
                               stdout=err, stderr=subprocess.STDOUT, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        with open(os.path.join(out_dir, "round.err")) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"analysis round failed (rc {child.returncode}):\n{tail}")
    with open(child_out) as f:
        rnd = json.load(f)
    check = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.analysis",
                            "--lockcheck-report", report_path], cwd=here,
                           capture_output=True, text=True, timeout=120)
    with open(report_path) as f:
        report = json.load(f)
    locks = sorted({e["held"] for e in report["edges"]} |
                   {e["acquired"] for e in report["edges"]})
    log("analysis_locks: " + json.dumps(locks))
    for e in report["edges"]:
        log(f"analysis_edge: {e['held']} -> {e['acquired']} ({e['site']})")
    counts = {"cycles": len(report["cycles"]), "blocking": len(report["blocking"]),
              "edges": len(report["edges"]), "locks": len(locks)}
    log("analysis_lockcheck: " + json.dumps(counts) + " | " +
        check.stdout.strip().splitlines()[-1])
    if check.returncode != 0 or counts["cycles"] or counts["blocking"]:
        raise AssertionError(f"analysis: lockcheck found issues:\n{check.stdout}")
    if [e for e in report["edges"] if e["held"] == "utils.metrics"]:
        raise AssertionError("analysis: an edge leaves the metrics registry's leaf lock")
    launches = rnd["launches"]
    for name in ("hash_agg", "hash_build", "sort_kernel"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"analysis: {name} did not launch under lockcheck")
    if "profile" not in rnd["artifact_keys"] or rnd["artifact_reason"] != "slow_query":
        raise AssertionError(f"analysis: the slow-query artifact has no profile "
                             f"({rnd['artifact_keys']})")
    if "profile_continuous" not in rnd["bundle_keys"]:
        raise AssertionError("analysis: the debug bundle has no profile_continuous")
    log("analysis_round: " + json.dumps({
        k: rnd[k] for k in ("gen_s", "served_wall_s", "served_queries", "served_p50_ms",
                            "launches", "append_ack", "artifact_reason",
                            "profile_samples")} | {"child_s": child_s, "card": smi}))
    p50 = rnd["q1_p50_ms"]
    log("analysis_q1_p50: " + json.dumps({
        "lockcheck_on_ms": p50["on"], "lockcheck_off_ms": p50["off"],
        "turns": list(ANALYSIS_TURNS), "runs_a_turn": ANALYSIS_P50_RUNS,
        "rows": SF1_ROWS, "card": smi}))

    # 3. the PhysicalPlan executor on the card: Write and Show of Q1 at SF-1
    ctx = tdf.ExecutionContext(result_cache=False)  # cuda:0
    ctx.register_datasource("lineitem", li_src)
    plan = ctx._plan(parse_sql(Q1))
    csv_path = os.path.join(out_dir, "q1_write.csv")
    cuda_mod.reset_launch_counts()
    n = ctx.execute_physical(PhysicalPlan("write", plan, filename=csv_path,
                                          file_format="csv"))
    write_launches = cuda_mod.launch_counts()
    back = _CsvRows(csv_path)
    if back.header[:2] != ["l_returnflag", "l_linestatus"] or n != len(back.rows):
        raise AssertionError(f"analysis write: header {back.header}, {n} rows")
    assert_rows(back, q1_oracle(li_cols, dates), "analysis PhysicalPlan write Q1")
    full = tdf.collect(ctx.sql(Q1)).to_rows()
    shown = ctx.execute_physical(PhysicalPlan("show", plan, count=2))
    if shown.num_rows != 2 or shown.to_rows() != full[:2]:
        raise AssertionError("analysis show: not the first 2 rows of Q1")
    assert_rows(shown, [r for r in q1_oracle(li_cols, dates)
                        if (r[0], r[1]) in {(a, b) for a, b, *_ in shown.to_rows()}],
                "analysis PhysicalPlan show Q1")
    if write_launches["hash_agg"] <= 0:
        raise AssertionError("analysis write: the grouped reduce did not launch")
    log(f"analysis_physical: write {n} rows and show 2 match the Q1 oracle "
        f"(launches {json.dumps(write_launches)}; {smi})")

    # 4. DDL through the serving front door over a CSV this phase writes
    ddl_path = os.path.join(out_dir, f"lineitem_{ANALYSIS_DDL_ROWS}.csv")
    part = {k: v[:ANALYSIS_DDL_ROWS] for k, v in li_cols.items()}
    write_csv(ddl_path, ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                         "l_discount", "l_tax", "l_shipdate"],
              [np.array(["A", "N", "R"])[part["flag"]], np.array(["F", "O"])[part["status"]],
               part["qty"], part["price"], part["disc"], part["tax"],
               np.array(dates)[part["ship"]]])
    dctx = tdf.ExecutionContext(result_cache=False)
    with dctx.serve(workers=1, window_s=0.005) as srv:
        ddl = srv.submit(LINEITEM_DDL.format(ddl_path).strip().rstrip(";")).result(timeout=120)
        if srv.submitted != 0:
            raise AssertionError("analysis DDL: the DDL counted as submitted")
        cuda_mod.reset_launch_counts()
        table = srv.submit(Q1).result(timeout=300)
        ddl_launches = cuda_mod.launch_counts()
    assert_rows(table, q1_oracle(part, dates), "analysis served DDL Q1")
    if ddl_launches["hash_agg"] <= 0:
        raise AssertionError("analysis DDL: the grouped reduce did not launch")
    log(f"analysis_ddl: {ddl!r}; served Q1 over {ANALYSIS_DDL_ROWS} CSV rows matches "
        f"the oracle (launches {json.dumps(ddl_launches)})")

    # 5. one append over the loopback wire to an in-process worker
    import socket
    import threading

    from datafusion_tpu_torch.parallel.wire import recv_msg, send_msg
    from datafusion_tpu_torch.parallel.worker import serve

    wctx = tdf.ExecutionContext(result_cache=False)
    schema = tdf.Schema([tdf.Field("k", tdf.DataType.INT64, False),
                         tdf.Field("v", tdf.DataType.FLOAT64, False)])
    wctx.register_datasource("events", tdf.MemoryDataSource(
        schema, [tdf.make_host_batch(schema, [np.arange(64) % 4, np.arange(64.0)])]))
    server = serve("127.0.0.1:0", device="cuda:0")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        server.worker_state.ingest_ctx = wctx.ingest(wal_dir=os.path.join(out_dir, "wal"))
        with socket.create_connection(tuple(server.server_address[:2]), timeout=60) as s:
            send_msg(s, {"type": "append", "table": "events",
                         "columns": {"k": [9, 9, 9], "v": [1.5, 2.5, 3.0]}})
            ack = recv_msg(s)
    finally:
        server.shutdown()
        server.server_close()
    if ack.get("type") != "append_ack" or ack.get("rows") != 3:
        raise AssertionError(f"analysis wire append: {ack}")
    cuda_mod.reset_launch_counts()
    got = sorted(tdf.collect(wctx.sql(
        "SELECT k, COUNT(1), SUM(v) FROM events GROUP BY k")).to_rows())
    append_launches = cuda_mod.launch_counts()
    if got != [(0, 16, 480.0), (1, 16, 496.0), (2, 16, 512.0), (3, 16, 528.0),
               (9, 3, 7.0)]:
        raise AssertionError(f"analysis wire append: the query saw {got}")
    log(f"analysis_wire_append: ack {json.dumps(ack)}; the next query sees the rows "
        f"(launches {json.dumps(append_launches)})")
    total = {k: launches.get(k, 0) + write_launches.get(k, 0) + ddl_launches.get(k, 0)
             + append_launches.get(k, 0) for k in ("hash_agg", "hash_build", "sort_kernel")}
    rep = {"query": "analysis", "launches": total, "lockcheck": counts,
           "q1_p50_ms": p50, "card": smi}
    log("analysis: " + json.dumps(rep))
    log(f"analysis_phase: {time.perf_counter() - t_phase:.3f} s ({smi})")
    return [rep]


def _counts():
    from datafusion_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counts"]


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
    axis_err, axis_shapes = phase_query_axis(torch, hash_agg, dev)

    ctx = tdf.ExecutionContext(result_cache=False)  # cuda:0
    t0 = time.perf_counter()
    src, cols, dates = lineitem_sf1(tdf, ctx.batch_size)
    log(f"lineitem SF-1 generated in {time.perf_counter() - t0:.1f} s "
        f"({len(list(src.batches()))} batches of {ctx.batch_size} rows)")
    ctx.register_datasource("lineitem", src)
    nb = len(list(src.batches()))
    table, q1, _ = run_query(tdf, cuda_mod, torch, ctx, Q1, "tpch_q1_sf1", SF1_ROWS)
    assert_rows(table, q1_oracle(cols, dates), "Q1")
    # one grouped reduce per slot (the row count and 5 sums) per batch group
    expect_launches(q1, "Q1", hash_agg=6 * fold_groups(nb))
    log(f"Q1 rows match the numpy oracle ({table.num_rows} groups)")
    ab_run(tdf, cuda_mod, torch, ctx, Q1, "tpch_q1_sf1", SF1_ROWS, (table, q1), FUSE_KNOB,
           needs=("hash_agg",), want_launches={"hash_agg": 6 * nb}, key_cols=2)
    ab_run(tdf, cuda_mod, torch, ctx, Q1, "tpch_q1_sf1", SF1_ROWS, (table, q1),
           PREFETCH_KNOB, needs=("hash_agg",),
           want_launches={"hash_agg": 6 * fold_groups(nb)}, key_cols=2)
    try:
        q1_profile(tdf, torch, ctx, q1["p50_ms"])
    except RuntimeError as e:  # the profiler is a measurement aid only
        log(f"profiler unavailable: {e}")
    reports = [q1, phase_filter_project(tdf, cuda_mod, torch, ctx, cols, dates, smi)]
    serve_reports = phase_serve(tdf, cuda_mod, torch, hash_agg, src, cols, dates, smi)
    reports += serve_reports
    li_src, li_cols = src, cols  # phase 12's DataFrame Q1 and console Q1
    del src, cols

    for groups in (16, 4096):
        src, cols = groupby_table(tdf, groups)
        ctx.register_datasource("t", src)
        label = f"config2_groupby_{groups}"
        table, rep, _ = run_query(tdf, cuda_mod, torch, ctx, CONFIG2, label, CONFIG2_ROWS)
        assert_rows(table, config2_oracle(cols, groups), f"config 2 G={groups}")
        # the row count, SUM(v1), SUM(v2), MIN(v3), MAX(v3)
        nb = len(list(src.batches()))
        expect_launches(rep, label, hash_agg=5 * fold_groups(nb))
        log(f"config 2 ({groups} groups) rows match the numpy oracle")
        ab_run(tdf, cuda_mod, torch, ctx, CONFIG2, label, CONFIG2_ROWS, (table, rep),
               FUSE_KNOB, needs=("hash_agg",), want_launches={"hash_agg": 5 * nb})
        if groups == 16:
            ab_run(tdf, cuda_mod, torch, ctx, CONFIG2, label, CONFIG2_ROWS, (table, rep),
                   PREFETCH_KNOB, needs=("hash_agg",),
                   want_launches={"hash_agg": 5 * fold_groups(nb)})
        query_profile(tdf, torch, ctx, CONFIG2, f"config2_groupby_{groups}", rep["p50_ms"])
        reports.append(rep)
        del src, cols
    reports += phase_high_cardinality(tdf, cuda_mod, torch, ctx, smi)

    join_reports, star_cols = phase_joins(tdf, cuda_mod, torch, ctx)
    reports += join_reports
    reports.append(phase_serve_joins(tdf, cuda_mod, torch, ctx, star_cols))
    reports += phase_high_cardinality_joins(tdf, cuda_mod, torch, ctx, star_cols, smi)
    reports += phase_sorts(tdf, cuda_mod, torch, ctx, star_cols)
    reports += phase_data_plane(tdf, cuda_mod, torch, ctx, li_src, li_cols, dates, star_cols,
                                smi)
    # the console's contexts compute every run, as every other phase's
    # do (its Q1 warm run and the DataFrame's warm runs count launches)
    os.environ["DATAFUSION_TPU_CACHE"] = "0"
    try:
        reports += phase_console(tdf, cuda_mod, torch, li_src, li_cols, dates, star_cols, smi)
    finally:
        del os.environ["DATAFUSION_TPU_CACHE"]
    reports += phase_parquet(tdf, cuda_mod, torch, li_cols, dates, smi)
    csv_rep, cities = phase_csv(tdf, cuda_mod, torch, smi)
    reports.append(csv_rep)
    reports += phase_explain(tdf, cuda_mod, torch, ctx, li_src, li_cols, dates, star_cols,
                             cities, smi)
    reports += phase_ingest(tdf, cuda_mod, torch, li_src, li_cols, dates, smi)
    tenancy_reports = phase_tenancy(tdf, cuda_mod, torch, hash_agg, li_src, li_cols, dates,
                                    smi)
    reports += tenancy_reports
    reports += phase_distributed(tdf, cuda_mod, torch, dev, li_cols, dates, star_cols, smi)
    fleet_reports = phase_fleet(tdf, cuda_mod, torch, li_src, li_cols, dates, smi)
    reports += fleet_reports
    reports += phase_cluster(tdf, cuda_mod, torch, li_cols, dates, smi)
    reports += phase_analysis(tdf, cuda_mod, torch, li_src, li_cols, dates, smi)
    del star_cols, li_src, li_cols
    reports += phase_topk(tdf, cuda_mod, torch, ctx, smi)
    reports += phase_unsigned(tdf, cuda_mod, torch, ctx, smi)

    def launched(name):
        return sum(r["launches"][name] for r in reports)

    log(json.dumps({"kernels": [
        _kernel_line("hash_agg.grouped_reduce", "datafusion_tpu_torch/csrc/hash_agg.cu",
                     "datafusion_tpu/exec/pallas/hash_agg.py:95", launched("hash_agg"),
                     agg_err, next(e for e in shapes if "Q1 batch group" in e["shape"])),
        _kernel_line("hash_agg.grouped_reduce_multi", "datafusion_tpu_torch/csrc/hash_agg.cu",
                     "datafusion_tpu/exec/pallas/hash_agg.py:95",
                     sum(r.get("query_axis_launches", 0)
                         for r in serve_reports + tenancy_reports + fleet_reports), axis_err,
                     next(e for e in axis_shapes if "Q=8" in e["shape"])),
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
    if sys.argv[1:2] == ["--analysis-round"]:
        sys.exit(analysis_round(sys.argv[2]))
    sys.exit(main())
