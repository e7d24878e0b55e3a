"""PyTorch/CUDA port: the worker's fragment cache (`parallel/worker.py`,
`parallel/coordinator.py`) and its key (`cache/fingerprint.py`), against
the JAX package's.

The two cases of the JAX package's `tests/test_cache.py` that hold
them, each run on both packages on the same inputs:

- `TestWorkerFragmentCache::test_replayed_fragment_served_from_cache`:
  a worker process of each package answers a GROUP BY over two CSV
  partitions cold; then the coordinator drops the first fragment
  response it receives (`wire.recv` raising ConnectionResetError), so
  the fragment is reassigned and replayed, and the replay and the rest
  of the repeat query are served from the worker's fragment cache.  The
  rows (each package's against its own local run and against the other
  package's), the growth of `coord.fragment_cache_hits`,
  `coord.fragment_reassigned` and the worker's own cache hits agree.
- `TestFingerprint::test_fragment_fingerprint_ignores_query_id`: the
  fingerprint is the same across query ids and changes with the shard
  and with the partition file's mtime, in both packages.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu import cache as jax_cache
from datafusion_tpu.exec.datasource import CsvDataSource as JaxCsvSource
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.parallel.coordinator import DistributedContext as JaxDistributedContext
from datafusion_tpu.parallel.partition import PartitionedDataSource as JaxPartitioned
from datafusion_tpu.parallel.physical import PlanFragment as JaxPlanFragment
from datafusion_tpu.sql.parser import parse_sql as jax_parse
from datafusion_tpu.testing import faults as jax_faults
from datafusion_tpu.utils.metrics import METRICS as JAX_METRICS

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import cache as port_cache
from datafusion_tpu_torch.exec.datasource import CsvDataSource as PortCsvSource
from datafusion_tpu_torch.parallel.coordinator import DistributedContext as PortDistributedContext
from datafusion_tpu_torch.parallel.partition import PartitionedDataSource as PortPartitioned
from datafusion_tpu_torch.parallel.physical import PlanFragment as PortPlanFragment
from datafusion_tpu_torch.sql.parser import parse_sql as port_parse
from datafusion_tpu_torch.testing import faults as port_faults
from datafusion_tpu_torch.utils.metrics import METRICS as PORT_METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSQL = "SELECT region, SUM(v), COUNT(1), MIN(v), MAX(v) FROM t GROUP BY region"
SQL = "SELECT k, SUM(v), COUNT(1) FROM t GROUP BY k"

PACKAGES = {  # package, CSV source, partitioned source, coordinator, faults, metrics, worker
    "jax": (jdf, JaxCsvSource, JaxPartitioned, JaxDistributedContext, jax_faults, JAX_METRICS,
            "datafusion_tpu.worker"),
    "port": (tdf, PortCsvSource, PortPartitioned, PortDistributedContext, port_faults,
             PORT_METRICS, "datafusion_tpu_torch.worker"),
}


def _write_partitions(tmp_path, n_parts=2, rows_per=200):
    """The JAX test's two partitions (seed 7)."""
    rng = np.random.default_rng(7)
    regions = ["north", "south", "east", "west"]
    paths = []
    for p in range(n_parts):
        path = tmp_path / f"part{p}.csv"
        with open(path, "w", encoding="utf-8") as f:
            f.write("region,v\n")
            for _ in range(rows_per):
                f.write(f"{regions[rng.integers(0, 4)]},{int(rng.integers(-1000, 1000))}\n")
        paths.append(str(path))
    return paths


def _schema(pkg):
    return pkg.Schema([pkg.Field("region", pkg.DataType.UTF8, False),
                       pkg.Field("v", pkg.DataType.INT64, False)])


def _register(ctx, which, paths):
    pkg, csv, partitioned = PACKAGES[which][:3]
    ctx.register_datasource("t", partitioned([csv(p, _schema(pkg), True, 131072)
                                              for p in paths]))
    return ctx


def _spawn(module):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--bind", "127.0.0.1:0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    assert "listening on" in line, line
    host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
    return proc, (host, int(port))


def _counts(metrics):
    snap = metrics.snapshot()["counts"]
    return (snap.get("coord.fragment_cache_hits", 0), snap.get("coord.fragment_reassigned", 0))


def _replay_round(which, paths):
    """(local rows, cold rows, replayed rows, hits in the cold run, hits
    and reassignments in the replayed run, the worker's own cache hits,
    drops fired)."""
    pkg, _, _, dist, faults, metrics, module = PACKAGES[which]
    collect = jax_collect if which == "jax" else tdf.collect
    local = _register(pkg.ExecutionContext(device="cpu"), which, paths)
    want = sorted(collect(local.sql(DSQL)).to_rows())
    proc, addr = _spawn(module)
    try:
        kwargs = {"device": "cpu"} if which == "port" else {}
        dctx = _register(dist([addr], result_cache=False, **kwargs), which, paths)
        h0, r0 = _counts(metrics)
        cold = sorted(collect(dctx.sql(DSQL)).to_rows())
        h1, r1 = _counts(metrics)
        # drop the first fragment response at the coordinator: the worker
        # is marked down, re-probed, and the replay is answered from its
        # fragment cache (no partition re-scan)
        with faults.scoped({"rules": [{"site": "wire.recv", "op": "raise",
                                       "exc": "ConnectionResetError", "after": 1,
                                       "count": 1}]}) as plan:
            replayed = sorted(collect(dctx.sql(DSQL)).to_rows())
            fired = plan.snapshot()[0]["fired"]
        h2, r2 = _counts(metrics)
        status = dctx.worker_status()[f"{addr[0]}:{addr[1]}"]
        worker_hits = status["cache"]["fragment"]["hits"]
        return want, cold, replayed, h1 - h0, h2 - h1, r2 - r1, worker_hits, fired
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_replayed_fragment_served_from_cache(tmp_path):
    paths = _write_partitions(tmp_path)
    got = {which: _replay_round(which, paths) for which in ("jax", "port")}
    for which, (want, cold, replayed, cold_hits, hits, reassigned, worker_hits,
                fired) in got.items():
        assert cold == want and replayed == want, which
        assert cold_hits == 0, which  # a cold run serves nothing cached
        assert fired == 1 and hits >= 2 and reassigned >= 1 and worker_hits >= 2, (
            which, fired, hits, reassigned, worker_hits)
    # the port's rows, counters and the worker's hits are the JAX package's
    assert got["port"][0] == got["jax"][0]
    assert got["port"][3:] == got["jax"][3:]


def _fragment_fingerprints(which, path):
    pkg = PACKAGES[which][0]
    fragment = JaxPlanFragment if which == "jax" else PortPlanFragment
    fingerprint = (jax_cache if which == "jax" else port_cache).fragment_fingerprint
    ctx = pkg.ExecutionContext(device="cpu")
    ctx.register_csv("t", str(path), pkg.Schema([pkg.Field("k", pkg.DataType.UTF8, False),
                                                  pkg.Field("v", pkg.DataType.FLOAT64, False)]))
    plan = ctx._plan((jax_parse if which == "jax" else port_parse)(SQL))
    meta = ctx.datasources["t"].to_meta()
    f1 = fragment(0, 2, plan.to_json(), meta, "query-aaa")
    f2 = fragment(0, 2, plan.to_json(), meta, "query-bbb")
    f3 = fragment(1, 2, plan.to_json(), meta, "query-aaa")
    return f1, fingerprint(f1), fingerprint(f2), fingerprint(f3), fingerprint


@pytest.mark.parametrize("which", ["jax", "port"])
def test_fragment_fingerprint_ignores_query_id(tmp_path, which):
    path = tmp_path / "part.csv"
    path.write_text("k,v\na,1.0\nb,2.0\n")
    f1, fp1, fp2, fp3, fingerprint = _fragment_fingerprints(which, path)
    assert fp1 == fp2
    # shard identity and the source file's version do matter
    assert fp1 != fp3
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert fingerprint(f1) != fp1


def test_fragment_fingerprints_agree_between_packages(tmp_path):
    """The same fragment keys the same entry in both packages: the
    query-id, shard and mtime relations hold alike, and the wire forms
    the fingerprints digest are equal."""
    path = tmp_path / "part.csv"
    path.write_text("k,v\na,1.0\nb,2.0\n")
    jax_side = _fragment_fingerprints("jax", path)
    port_side = _fragment_fingerprints("port", path)
    assert port_side[0].plan == jax_side[0].plan
    assert port_side[0].datasource_meta == jax_side[0].datasource_meta
    relations = [(fps[1] == fps[2], fps[1] == fps[3]) for fps in (jax_side, port_side)]
    assert relations[0] == relations[1] == (True, False)
