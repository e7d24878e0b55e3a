"""PyTorch/CUDA port: the coordinator and its worker processes
(`datafusion_tpu_torch.parallel.coordinator` / `.worker`) against the
JAX package.

Two port worker processes (`python -m datafusion_tpu_torch.worker
--device cpu`, ephemeral ports, started once for the module) serve the
port's `DistributedContext(device="cpu")`; the reference is the JAX
package's single-process `ExecutionContext` over the same CSV
partitions (the generator of tests/test_distributed.py).  Ints,
strings, NULLs and order exactly, floats within rtol 1e-9.  Cases:
grouped, global and WHERE aggregates and Utf8 MIN/MAX, a header-only
partition, a union pipeline and a sort with LIMIT at the coordinator,
inner and left shuffle joins and the same joins under
`DATAFUSION_TPU_SHUFFLE=0`, a killed worker whose fragments complete
on the survivor, the worker's `status` (its kernel launch counts), and
the worker's flags.  Interop: the port's coordinator against one JAX
worker process, and the JAX coordinator against one port worker, both
giving the JAX package's single-process rows.  The fault cases (a
query deadline, a hedged request under a `worker.fragment` delay, an
open breaker, the retry budget denying a storm, the local fallback)
run on in-process port workers over real sockets, where the fault plan
reaches them.  The heartbeat monitor marks down and re-admits where the
JAX package's does on the same probe sequences, and re-admits an
in-process worker restarted on its port.  `initialize_distributed`
brings two processes up over gloo.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.exec.datasource import CsvDataSource as JaxCsv
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.parallel.coordinator import DistributedContext as JaxDistributedContext
from datafusion_tpu.parallel.partition import PartitionedDataSource as JaxPDS

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.errors import ExecutionError, QueryDeadlineError
from datafusion_tpu_torch.exec.datasource import CsvDataSource
from datafusion_tpu_torch.parallel import DistributedContext, PartitionedDataSource
from datafusion_tpu_torch.parallel.worker import serve
from datafusion_tpu_torch.testing import faults
from datafusion_tpu_torch.utils import breaker as breaker_mod
from datafusion_tpu_torch.utils import hedge as hedge_mod
from datafusion_tpu_torch.utils import retry
from datafusion_tpu_torch.utils.metrics import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _schema(mod):
    T = mod.DataType
    return mod.Schema([mod.Field("region", T.UTF8, False), mod.Field("city", T.UTF8, True),
                       mod.Field("v", T.INT64, False), mod.Field("x", T.FLOAT64, True)])


def _dim_schema(mod):
    T = mod.DataType
    return mod.Schema([mod.Field("k", T.INT64, False), mod.Field("name", T.UTF8, True)])


def _write_partitions(tmp_path, n_parts=4, rows_per=500):
    rng = np.random.default_rng(17)
    regions = ["north", "south", "east", "west", "über"]
    cities = [f"city{i}" for i in range(40)]
    paths = []
    for p in range(n_parts):
        path = tmp_path / f"part{p}.csv"
        with open(path, "w", encoding="utf-8") as f:
            f.write("region,city,v,x\n")
            for _ in range(rows_per):
                r = regions[rng.integers(0, len(regions))]
                c = cities[rng.integers(0, len(cities))] if rng.random() > 0.05 else ""
                v = int(rng.integers(-1000, 1000))
                x = "" if rng.random() < 0.1 else f"{rng.uniform(-5, 5):.6f}"
                f.write(f"{r},{c},{v},{x}\n")
        paths.append(str(path))
    return paths


def _write_dim(tmp_path, n_parts=2):
    """A dimension keyed on v's range: every third key, some names NULL."""
    paths = []
    for p in range(n_parts):
        path = tmp_path / f"dim{p}.csv"
        with open(path, "w", encoding="utf-8") as f:
            f.write("k,name\n")
            for k in range(-1000 + p * 1000, p * 1000, 3):
                f.write(f"{k},{'' if k % 7 == 0 else f'n{k}'}\n")
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist")
    return _write_partitions(d), _write_dim(d)


def _spawn(module, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--bind", "127.0.0.1:0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    return proc


def _address(proc):
    line = proc.stdout.readline()  # "worker listening on host:port"
    assert "listening on" in line, line
    host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
    return host, int(port)


@pytest.fixture(scope="module")
def workers():
    """Two port worker processes and one JAX worker process, started
    together."""
    procs = [_spawn("datafusion_tpu_torch.worker"), _spawn("datafusion_tpu_torch.worker"),
             _spawn("datafusion_tpu.worker")]
    try:
        addrs = [_address(p) for p in procs]
        yield procs, addrs[:2], addrs[2]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=20)


def _port_ctx(addrs, paths, dim_paths=None, **kw):
    ctx = DistributedContext(addrs, device="cpu", result_cache=False, **kw)
    ctx.register_datasource("t", PartitionedDataSource(
        [CsvDataSource(p, _schema(tdf), True) for p in paths]))
    if dim_paths:
        ctx.register_datasource("d", PartitionedDataSource(
            [CsvDataSource(p, _dim_schema(tdf), True) for p in dim_paths]))
    return ctx


def _jax_ctx(paths, dim_paths=None):
    ctx = jdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", JaxPDS([JaxCsv(p, _schema(jdf), True) for p in paths]))
    if dim_paths:
        ctx.register_datasource("d", JaxPDS(
            [JaxCsv(p, _dim_schema(jdf), True) for p in dim_paths]))
    return ctx


def _same(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, float):
        if math.isnan(w) or math.isnan(g):
            return math.isnan(w) and math.isnan(g)
        return math.isclose(g, w, rel_tol=1e-9, abs_tol=0.0)
    return g == w and type(g) is type(w)


def _key(row):
    return tuple((v is None, "" if v is None else repr(v)) for v in row)


def assert_rows(got, want, ordered=False, key_cols=None):
    g_rows, w_rows = got.to_rows(), want.to_rows()
    if not ordered:
        k = (lambda r: _key(r)) if key_cols is None else (lambda r: _key(r[:key_cols]))
        g_rows, w_rows = sorted(g_rows, key=k), sorted(w_rows, key=k)
    assert len(g_rows) == len(w_rows), (len(g_rows), len(w_rows))
    for g, w in zip(g_rows, w_rows):
        assert len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)), (g, w)


def _count(name):
    return METRICS.counts.get(name, 0)


AGG_CASES = [
    ("SELECT region, SUM(v), COUNT(1), AVG(x), MIN(v), MAX(v), MIN(city), MAX(city) "
     "FROM t GROUP BY region", 1),
    ("SELECT COUNT(1), SUM(v), MIN(x) FROM t WHERE v > 0", None),
    ("SELECT MIN(region), MAX(region), MIN(city), MAX(city) FROM t", None),
    ("SELECT city, COUNT(x), SUM(x), MAX(x) FROM t WHERE region <> 'east' GROUP BY city", 1),
]


@pytest.mark.parametrize("sql,keys", AGG_CASES)
def test_aggregate_matches_jax(data, workers, sql, keys):
    _, addrs, _ = workers
    paths, _ = data
    ctx = _port_ctx(addrs, paths)
    assert type(ctx.sql(sql)).__name__ == "DistributedAggregateRelation"
    assert_rows(tdf.collect(ctx.sql(sql)), jax_collect(_jax_ctx(paths).sql(sql)),
                key_cols=keys)


def test_empty_partition(data, workers, tmp_path):
    """A header-only partition returns zero groups; the merge skips it."""
    _, addrs, _ = workers
    empty = tmp_path / "empty.csv"
    empty.write_text("region,city,v,x\n")
    paths = data[0][:2] + [str(empty)]
    sql = "SELECT region, SUM(v), MIN(city) FROM t GROUP BY region"
    assert_rows(tdf.collect(_port_ctx(addrs, paths).sql(sql)),
                jax_collect(_jax_ctx(paths).sql(sql)), key_cols=1)


def test_union_pipeline_and_sort_limit(data, workers):
    """Row fragments union at the coordinator; a sort with LIMIT above a
    computed projection runs there, over the distributed union."""
    _, addrs, _ = workers
    paths, _ = data
    ctx, jctx = _port_ctx(addrs, paths), _jax_ctx(paths)
    sql = "SELECT region, v + 1, x FROM t WHERE v > 900"
    assert type(ctx.sql(sql)).__name__ == "DistributedUnionRelation"
    assert_rows(tdf.collect(ctx.sql(sql)), jax_collect(jctx.sql(sql)))
    sql = "SELECT v * 2 AS w, city FROM t WHERE v > 500 ORDER BY w DESC, city LIMIT 7"
    rel = ctx.sql(sql)
    assert type(rel).__name__ == "SortRelation"
    assert type(rel.child).__name__ == "DistributedUnionRelation"
    assert_rows(tdf.collect(rel), jax_collect(jctx.sql(sql)), ordered=True)


JOINS = [
    "SELECT region, v, name FROM t JOIN d ON t.v = d.k",
    "SELECT region, v, name FROM t LEFT JOIN d ON t.v = d.k WHERE v > 800",
    "SELECT name, COUNT(1), SUM(x) FROM t JOIN d ON t.v = d.k GROUP BY name",
]


@pytest.mark.parametrize("shuffle", ["1", "0"])
@pytest.mark.parametrize("sql", JOINS)
def test_join_matches_jax(data, workers, monkeypatch, sql, shuffle):
    """Inner and left joins through the shuffle exchange, and under
    DATAFUSION_TPU_SHUFFLE=0 through the coordinator's local hash join
    over distributed scans."""
    _, addrs, _ = workers
    paths, dims = data
    monkeypatch.setenv("DATAFUSION_TPU_SHUFFLE", shuffle)
    ctx = _port_ctx(addrs, paths, dims)
    joins0 = _count("shuffle.joins")
    got = tdf.collect(ctx.sql(sql))
    assert (_count("shuffle.joins") > joins0) == (shuffle == "1")
    assert_rows(got, jax_collect(_jax_ctx(paths, dims).sql(sql)),
                key_cols=1 if "GROUP BY" in sql else None)


def test_killed_worker_fragments_go_to_the_survivor(data, workers):
    """A worker process killed before the query: its fragments are
    reassigned, and the survivor answers every one."""
    _, addrs, _ = workers
    paths, _ = data
    doomed = _spawn("datafusion_tpu_torch.worker")
    try:
        dead_addr = _address(doomed)
    finally:
        doomed.kill()
        doomed.wait(timeout=20)
    survivor = addrs[0]
    ctx = _port_ctx([dead_addr, survivor], paths)
    before = ctx.worker_status()[f"{survivor[0]}:{survivor[1]}"]["queries"]
    moved0 = _count("coord.fragment_reassigned")
    sql = "SELECT region, SUM(v), COUNT(1) FROM t GROUP BY region"
    assert_rows(tdf.collect(ctx.sql(sql)), jax_collect(_jax_ctx(paths).sql(sql)), key_cols=1)
    assert _count("coord.fragment_reassigned") > moved0
    status = ctx.worker_status()
    assert status[f"{dead_addr[0]}:{dead_addr[1]}"] is None
    assert status[f"{survivor[0]}:{survivor[1]}"]["queries"] >= before
    assert ctx.ping_workers()[f"{dead_addr[0]}:{dead_addr[1]}"] is False


def test_worker_status_carries_kernel_counts(data, workers):
    _, addrs, _ = workers
    ctx = _port_ctx(addrs, data[0])
    tdf.collect(ctx.sql("SELECT region, SUM(v) FROM t GROUP BY region"))
    for st in ctx.worker_status().values():
        assert st["type"] == "status" and st["device"] == "cpu"
        # on the CPU the wrappers run their plain versions: no launch
        assert set(st["kernels"]) >= {"hash_agg", "hash_build", "sort_kernel"}
        assert st["queries"] >= 1 and isinstance(st["prometheus"], str)


# ------------------------------------------------------------------ interop


def test_port_coordinator_with_a_jax_worker(data, workers):
    _, _, jax_addr = workers
    paths, _ = data
    ctx = _port_ctx([jax_addr], paths)
    jctx = _jax_ctx(paths)
    for sql, keys in AGG_CASES[:3]:
        assert_rows(tdf.collect(ctx.sql(sql)), jax_collect(jctx.sql(sql)), key_cols=keys)
    sql = "SELECT region, v + 1, x FROM t WHERE v > 900"
    assert_rows(tdf.collect(ctx.sql(sql)), jax_collect(jctx.sql(sql)))


def test_jax_coordinator_with_a_port_worker(data, workers):
    _, addrs, _ = workers
    paths, dims = data
    jdist = JaxDistributedContext([addrs[0]], result_cache=False)
    jdist.register_datasource("t", JaxPDS([JaxCsv(p, _schema(jdf), True) for p in paths]))
    jdist.register_datasource("d", JaxPDS([JaxCsv(p, _dim_schema(jdf), True) for p in dims]))
    jctx = _jax_ctx(paths, dims)
    for sql, keys in AGG_CASES[:3]:
        assert_rows(jax_collect(jdist.sql(sql)), jax_collect(jctx.sql(sql)), key_cols=keys)
    for sql in ("SELECT region, v + 1, x FROM t WHERE v > 900", JOINS[0]):
        assert_rows(jax_collect(jdist.sql(sql)), jax_collect(jctx.sql(sql)))


# ------------------------------------------------- faults, in-process workers


@pytest.fixture()
def inproc_workers():
    """Two in-process port workers over real TCP sockets: the fault plan
    of this process reaches their fragment sites."""
    servers, addrs = [], []
    for _ in range(2):
        server = serve("127.0.0.1:0", device="cpu")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        addrs.append(tuple(server.server_address[:2]))
    yield addrs
    for s in servers:
        s.shutdown()
        s.server_close()


SQL = "SELECT region, COUNT(1), SUM(v), MIN(v), MAX(v), MIN(x), MAX(x) FROM t GROUP BY region"


def _rows(ctx):
    return sorted(tdf.collect(ctx.sql(SQL)).to_rows(), key=_key)


def _local_rows(paths):
    """The port's single-process rows: a fault-free reference that
    leaves the workers' fragment caches cold (a cached fragment is
    served without reaching its fault site)."""
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", PartitionedDataSource(
        [CsvDataSource(p, _schema(tdf), True) for p in paths]))
    return _rows(ctx)


@pytest.fixture()
def breakers_on():
    breaker_mod.configure(True)
    breaker_mod.reset()
    yield
    breaker_mod.configure(None)
    breaker_mod.reset()


def test_query_deadline(data, inproc_workers):
    paths = data[0][:2]
    ctx = _port_ctx(inproc_workers, paths, query_deadline_s=0.3)
    with faults.scoped({"rules": [
        {"site": "worker.fragment", "op": "delay", "seconds": 1.0, "count": 0},
    ]}):
        with pytest.raises(QueryDeadlineError):
            tdf.collect(ctx.sql(SQL))
    time.sleep(1.0)  # let the delayed fragments finish before teardown


def test_hedged_request_merges_once(data, inproc_workers):
    """A `worker.fragment` delay makes the primary crawl; the hedge
    fires, its answer wins, and the loser's late answer is never
    merged: the rows equal the fault-free run's."""
    paths = data[0][:3]
    want = _local_rows(paths)
    tracker = hedge_mod.HedgeTracker(floor_s=0.05, min_samples=10**6)
    ctx = _port_ctx(inproc_workers, paths, hedge=tracker)
    won0, dup0 = _count("coord.hedges_won"), _count("coord.duplicate_responses_dropped")
    with faults.scoped({"rules": [
        {"site": "worker.fragment", "op": "delay", "seconds": 0.6,
         "where": {"shard": 0}, "count": 1},
    ]}):
        assert _rows(ctx) == want
    assert _count("coord.hedges_won") == won0 + 1
    assert _count("coord.duplicate_responses_dropped") == dup0
    time.sleep(0.7)  # the abandoned loser finishes; the healed path agrees
    assert _rows(ctx) == want
    assert_rows(tdf.collect(ctx.sql(SQL)), jax_collect(_jax_ctx(paths).sql(SQL)), key_cols=1)


def test_open_breaker_skips_its_worker(data, inproc_workers, breakers_on):
    paths = data[0][:3]
    want = _local_rows(paths)
    (h0, p0), _ = inproc_workers
    b = breaker_mod.breaker_for(f"worker:{h0}:{p0}")
    for _ in range(b.failures):
        b.record(False)
    assert b.state == "open"
    skips0 = _count("coord.breaker_skips")
    assert _rows(_port_ctx(inproc_workers, paths)) == want
    assert _count("coord.breaker_skips") > skips0


def test_retry_budget_denies_a_storm(data, inproc_workers):
    """An empty budget turns a reassignment into a prompt failure; with
    no budget (the default) the same fault heals by replay."""
    paths = data[0][:3]
    want = _local_rows(paths)
    plan = {"rules": [{"site": "worker.fragment", "op": "raise",
                       "exc": "InjectedConnectionAbort", "count": 1}]}
    retry.set_retry_budget(retry.RetryBudget(0.0, burst=0.0))
    base = _count("coord.reassign_budget_denied")
    try:
        with faults.scoped(plan):
            with pytest.raises(ExecutionError, match="retry budget"):
                _rows(_port_ctx(inproc_workers, paths))
        assert _count("coord.reassign_budget_denied") == base + 1
    finally:
        retry.set_retry_budget(None)
    with faults.scoped(plan):
        assert _rows(_port_ctx(inproc_workers, paths)) == want


# ------------------------------------------------------------ heartbeats


def _scripted_handle(mod):
    class Scripted(mod.WorkerHandle):
        """A handle whose probe answers from a script, not a socket."""

        def __init__(self):
            super().__init__("a", 0)
            self.probe_ok = True

        def probe(self):
            return self.probe_ok

    return Scripted()


def _heartbeat_trace(mod, events, **kw):
    h = _scripted_handle(mod)
    mon = mod.HeartbeatMonitor([h], interval=0.01, **kw)
    out = []
    for ev in events:
        if ev == "poll":
            mon.poll_once()
        elif ev == "mark_down":
            h.mark_down()  # a dispatch-side failover between cycles
        elif ev == "readmit":
            h.readmit()  # a dispatch-side last-gasp re-admission
        else:
            h.probe_ok = ev == "up"
        out.append((ev, h.alive))
    return out


def _heartbeat_events(seed, n=80):
    rng = np.random.default_rng(seed)
    kinds = ["poll"] * 6 + ["up", "down", "mark_down", "readmit"]
    return [kinds[int(i)] for i in rng.integers(0, len(kinds), n)]


HEARTBEAT_CASES = [
    ("probation and failure detection", dict(probation_pings=2, fail_threshold=2),
     ["down", "poll", "poll", "up", "poll", "poll"]),
    ("streaks reset on an external flip", dict(probation_pings=2, fail_threshold=2),
     ["up"] + ["poll"] * 5 + ["mark_down", "poll", "poll", "down", "poll", "poll",
                              "poll", "readmit", "poll"]),
    ("defaults", {}, ["down", "poll", "poll", "poll", "up", "poll", "poll"]),
] + [(f"random {seed}", dict(probation_pings=1 + seed % 3, fail_threshold=1 + seed % 2),
      _heartbeat_events(seed)) for seed in range(4)]


@pytest.mark.parametrize("name,kw,events", HEARTBEAT_CASES,
                         ids=[c[0] for c in HEARTBEAT_CASES])
def test_heartbeat_matches_jax(name, kw, events):
    """The port's monitor marks down and re-admits exactly where the JAX
    package's does, on the same probe sequence."""
    from datafusion_tpu.parallel import coordinator as jax_coord
    from datafusion_tpu_torch.parallel import coordinator as port_coord

    got = _heartbeat_trace(port_coord, events, **kw)
    assert got == _heartbeat_trace(jax_coord, events, **kw)
    if name == "probation and failure detection":
        # one miss is not dead; two are; two healthy probes re-admit
        assert [a for _, a in got] == [True, True, False, False, False, True]


def test_heartbeat_readmits_a_restarted_worker(data):
    """An in-process port worker stops: the monitor marks it down after
    `fail_threshold` misses.  Restarted on the same port, one probation
    cycle re-admits it, by `poll_once` and by the context's background
    monitor (`heartbeat_interval`), and the query runs on it again."""
    paths = data[0][:2]
    want = _local_rows(paths)

    def start(port=0):
        server = serve(f"127.0.0.1:{port}", device="cpu")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    def stop(server):
        server.shutdown()
        server.server_close()

    server = start()
    port = server.server_address[1]
    ctx = _port_ctx([("127.0.0.1", port)], paths, heartbeat_interval=0.05,
                    probation_pings=1, fail_threshold=2)
    try:
        assert ctx.heartbeat is not None
        ctx.heartbeat.stop()  # driven by hand first
        handle = ctx.workers[0]
        assert _rows(ctx) == want
        stop(server)
        ctx.heartbeat.poll_once()
        assert handle.alive  # one miss is not dead
        ctx.heartbeat.poll_once()
        assert not handle.alive
        server = start(port)
        ctx.heartbeat.poll_once()
        assert handle.alive
        assert _rows(ctx) == want
        handle.mark_down()
        ctx.heartbeat.start()
        deadline = time.monotonic() + 30
        while not handle.alive and time.monotonic() < deadline:
            time.sleep(0.02)
        assert handle.alive
        assert _rows(ctx) == want
    finally:
        ctx.close()
        stop(server)


def test_all_workers_down_and_local_fallback(data, monkeypatch):
    """Every worker dead: the query fails naming the workers, unless
    DATAFUSION_TPU_LOCAL_FALLBACK serves the fragments on the
    coordinator, through the same operators on its device."""
    paths = data[0][:2]
    with pytest.raises(ExecutionError, match="workers"):
        _rows(_port_ctx([("127.0.0.1", 1)], paths))
    monkeypatch.setenv("DATAFUSION_TPU_LOCAL_FALLBACK", "1")
    base = _count("coord.local_fallbacks")
    got = tdf.collect(_port_ctx([("127.0.0.1", 1)], paths).sql(SQL))
    assert _count("coord.local_fallbacks") == base + 2
    assert_rows(got, jax_collect(_jax_ctx(paths).sql(SQL)), key_cols=1)


# ------------------------------------------------------- bring-up and flags


def test_two_process_bringup_over_gloo():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prog = (
        "import sys, torch, torch.distributed as dist\n"
        "from datafusion_tpu_torch.parallel.mesh import initialize_distributed\n"
        f"initialize_distributed('127.0.0.1:{port}', 2, int(sys.argv[1]))\n"
        "t = torch.tensor([dist.get_rank() + 1.0])\n"
        "dist.all_reduce(t)\n"
        "print('proc', dist.get_rank(), 'of', dist.get_world_size(), dist.get_backend(),\n"
        "      'sum', int(t.item()), flush=True)\n"
        "assert dist.get_world_size() == 2 and int(t.item()) == 3\n"
        "dist.destroy_process_group()\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(i)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert all("of 2 gloo sum 3" in o for o in outs), outs


def test_worker_flags_and_device_rule():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.worker", "--help"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert "--coordinator" in out.stdout and "--num-processes" in out.stdout
    import torch

    if not torch.cuda.is_available():
        # no --device means cuda:0: without a card the worker refuses
        run = subprocess.run(
            [sys.executable, "-m", "datafusion_tpu_torch.worker", "--bind", "127.0.0.1:0"],
            capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
        assert run.returncode != 0 and "CUDA" in run.stderr
        with pytest.raises(ExecutionError, match="CUDA"):
            DistributedContext([("127.0.0.1", 1)])
    # a cluster service that does not answer: the worker serves anyway
    # and its agent keeps trying to register
    proc = subprocess.Popen(
        [sys.executable, "-m", "datafusion_tpu_torch.worker", "--bind", "127.0.0.1:0",
         "--device", "cpu", "--cluster", "127.0.0.1:1"], stdout=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    try:
        assert proc.stdout.readline().startswith("worker listening on ")
        assert "registered with 127.0.0.1:1" in proc.stdout.readline()
    finally:
        proc.kill()
        proc.wait(timeout=30)


# ------------------------------------------------------ the wire append


def _append_table(pkg):
    schema = pkg.Schema([pkg.Field("k", pkg.DataType.INT64, False),
                         pkg.Field("v", pkg.DataType.FLOAT64, False)])
    from datafusion_tpu.exec.batch import make_host_batch as jax_batch
    from datafusion_tpu.exec.datasource import MemoryDataSource as JaxMemory

    ctx = pkg.ExecutionContext(device="cpu", result_cache=False)
    memory, batch = ((tdf.MemoryDataSource, tdf.make_host_batch) if pkg is tdf
                     else (JaxMemory, jax_batch))
    src = memory(schema, [batch(schema, [np.arange(8), np.arange(8.0)])])
    ctx.register_datasource("t", src)
    return ctx


def _wire_round(server, msg):
    import socket

    from datafusion_tpu_torch.parallel.wire import recv_msg, send_msg

    with socket.create_connection(tuple(server.server_address[:2]), timeout=30) as s:
        send_msg(s, msg)
        return recv_msg(s)


@pytest.fixture()
def append_workers(tmp_path):
    """One in-process worker of each package, each with an attached
    ingest context over its own log."""
    from datafusion_tpu.parallel.worker import serve as jax_serve

    out = {}
    for pkg, fn in ((tdf, serve), (jdf, jax_serve)):
        server = fn("127.0.0.1:0", device="cpu")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        ctx = _append_table(pkg)
        wal = tmp_path / ("port" if pkg is tdf else "jax")
        server.worker_state.ingest_ctx = ctx.ingest(wal_dir=str(wal))
        out[pkg] = (server, ctx, wal)
    yield out
    for server, _, _ in out.values():
        server.shutdown()
        server.server_close()


APPEND = {"type": "append", "table": "t", "columns": {"k": [8, 9], "v": [8.5, 9.5]},
          "client": "A"}


def test_wire_append_ack_matches_the_jax_worker(append_workers):
    acks = {pkg: _wire_round(server, APPEND) for pkg, (server, _, _) in append_workers.items()}
    got, want = acks[tdf], acks[jdf]
    assert got == want == {"type": "append_ack", "table": "t", "rows": 2, "rev": 1,
                           "views": {}}
    ctx = append_workers[tdf][1]
    assert tdf.collect(ctx.sql("SELECT COUNT(1), SUM(v) FROM t")).to_rows() == [(10, 46.0)]


def test_wire_append_to_a_plain_worker_is_an_error_reply(inproc_workers):
    from datafusion_tpu_torch.errors import IngestUnavailableError, TransientError

    assert issubclass(IngestUnavailableError, TransientError)

    class _Addr:
        server_address = inproc_workers[0]

    out = _wire_round(_Addr, APPEND)
    assert out == {"type": "error", "message": "ingest not enabled on this worker"}


def test_a_replayed_revision_is_absorbed(append_workers):
    server, ctx, wal = append_workers[tdf]
    assert _wire_round(server, APPEND)["rev"] == 1
    # the coordinator's retry of a write that did land: the same
    # revision offered to the log again is dropped, not applied twice
    from datafusion_tpu_torch.ingest import _block_from_batch
    from datafusion_tpu_torch.parallel.wire import BinWriter

    ing = server.worker_state.ingest_ctx
    src = ing.attach("t")
    bw = BinWriter()
    batch = src.build_batch(APPEND["columns"])
    ing._wal.append([({"kind": "append", "rev": 1, "table": "t", "client": "A",
                       "rows": batch.num_rows,
                       "cols": _block_from_batch(src.schema, batch, bw)}, bw)])
    fresh = _append_table(tdf)
    rec = fresh.ingest(wal_dir=str(wal)).recover()
    assert rec["appends_replayed"] == 1 and rec["recovered_rev"] == 1
    assert tdf.collect(fresh.sql("SELECT COUNT(1) FROM t")).to_rows() == [(10,)]
