"""The SQL console on the port: the JAX package's `cli.py`.

A banner, script mode (`--script file.sql`, statements accumulate
until `;`), an interactive REPL with `datafusion>` / `>` continuation
prompts and `quit`/`exit`, per-query wall-clock timing, DDL, result
rows, EXPLAIN / EXPLAIN VERIFY plans, EXPLAIN ANALYZE reports (also as
`\\explain <sql>`), the device ledger's report (`\\hbm`), the result
cache's counters and per-query history (`\\cache`), the cost store's
observations, decisions and replans (`\\cost`), the ingest plane's
tables, views and log (`\\ingest`), the cluster control plane's
membership, replication and shared result tier (`\\cluster`), one
logged append
(`\\append <table> {"col": [values], ...}`), and the
`ST_Point`/`ST_AsText` geo UDFs the reference's golden smoketest expects
(`test/data/smoketest.sql`, `test/data/smoketest-expected.txt`).

Run: ``python -m datafusion_tpu_torch.cli [--script FILE] [--device cpu]``

The fleet view (`\\top`, and the `top` mode: ``top [--workers
h:p,... | --cluster h:p] [--tenants] [--qos] [--watch N]``) renders this
process's telemetry, or with `--workers` or `--cluster` a fleet's through
a `DistributedContext` (obs/aggregate.FleetAggregator; with `--cluster`
one service round trip reads every worker's heartbeat telemetry).  The
`debug-bundle` mode (``debug-bundle [--workers h:debugport,... |
--cluster h:p] [--out DIR] [--seconds N] [--format json|tar]``) pulls
one debug bundle from each worker's debug HTTP plane (obs/httpd.py),
found through the cluster's membership with `--cluster` (a member whose
lease advertises no debug port counts as a failure), or bundles this
process when no worker is named.  ``DATAFUSION_TPU_CLUSTER`` stands in
for `--cluster`.

The console runs on `cuda:0` unless `--device` names another device
(`cpu` only when asked).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch.sql.parser import split_statements, split_statements_partial

def _fmt_float(v: float) -> str:
    """Shortest round-trip decimal (matches the golden output's
    `52.412811`, `0.10231` style)."""
    return repr(float(v))


def fleet_top_text(ctx=None) -> str:
    """The ``top`` view: a `DistributedContext` renders its fleet (each
    worker's ``telemetry`` snapshot); any other context this process's
    own histograms and counters as node "local"."""
    if ctx is not None and hasattr(ctx, "top_text"):
        return ctx.top_text()
    from datafusion_tpu_torch.obs import slo
    from datafusion_tpu_torch.obs.aggregate import FleetAggregator

    rows = slo.WATCHDOG.evaluate() if slo.WATCHDOG.armed() else None
    return FleetAggregator().top_text(slo_rows=rows)


def qos_text() -> str:
    """The ``top --qos`` block: armed state, each tenant's share and
    attained and normalized service, and the scale hint with its two
    inputs."""
    from datafusion_tpu_torch import qos as qos_mod

    snap = qos_mod.debug_snapshot()
    lines = [f"QoS: {'armed' if snap['enabled'] else 'off'}"]
    for cid, row in snap.get("attained", {}).items():
        lines.append(f"  {cid}: share {row['share']:g}  attained {row['cost_s']:.3f}s  "
                     f"normalized {row['normalized']:.3f}")
    sc = snap["scale"]
    burn = sc["max_burn_rate"]
    lines.append(f"  scale hint: {sc['hint']:+d}  "
                 f"(max burn {'n/a' if burn is None else f'{burn:.2f}x'}, "
                 f"queue_wait share {sc['queue_wait_share']:.0%})")
    return "\n".join(lines)


def _addrs(workers: Optional[str]) -> list[tuple[str, int]]:
    out = []
    for addr in (workers or "").split(","):
        addr = addr.strip()
        if addr:
            host, _, port = addr.rpartition(":")
            out.append((host, int(port)))
    return out


def run_top(workers: Optional[str], watch_s: float, out=None, tenants: bool = False,
            qos: bool = False, device: Optional[str] = None,
            cluster: Optional[str] = None) -> int:
    """``top [--workers a:1,b:2 | --cluster h:p] [--watch N] [--tenants]
    [--qos]``: print the telemetry view once, or every N seconds until
    interrupted.  `--tenants` appends the per-client metering table (the
    fleet's summed tenant gauges with a fleet), `--qos` the fair-share
    view.  With a fleet the coordinator context runs on `device`
    (``cuda:0`` unless it says otherwise), as every context does."""
    import os

    out = out if out is not None else sys.stdout
    ctx = None
    cluster = cluster or os.environ.get("DATAFUSION_TPU_CLUSTER")
    if workers or cluster:
        from datafusion_tpu_torch.parallel.coordinator import DistributedContext

        ctx = DistributedContext(_addrs(workers), device=device, result_cache=False,
                                 cluster=cluster)
    try:
        while True:
            print(fleet_top_text(ctx), file=out)
            if tenants:
                from datafusion_tpu_torch.obs import attribution

                if ctx is not None:
                    # this process served nothing: the node-summed gauges
                    print(attribution.tenants_text_from_gauges(
                        ctx.telemetry.fleet().get("tenants", {})), file=out)
                else:
                    print(attribution.tenants_text(), file=out)
            if qos:
                print(qos_text(), file=out)
            if not watch_s:
                return 0
            print("", file=out)
            time.sleep(watch_s)
    except KeyboardInterrupt:
        return 0
    finally:
        if ctx is not None:
            ctx.close()


def run_debug_bundle(workers: Optional[str], out_dir: Optional[str], seconds: float,
                     out=None, fmt: str = "json", cluster: Optional[str] = None) -> int:
    """``debug-bundle [--workers h:debugport,... | --cluster h:p] [--out
    DIR] [--seconds N] [--format json|tar]``: pull one debug bundle
    (obs/httpd.py ``/debug/bundle``) from each named debug plane, or from
    each live cluster member's advertised one, and write them under DIR;
    ``--format tar`` pulls the tar stream whose members carry the raw
    ring, spans and profile.  With no worker, bundles this process.
    Exits non-zero if any member failed to produce its bundle (a member
    with no advertised debug port counts)."""
    import json
    import os
    import tempfile
    import urllib.request

    out = out if out is not None else sys.stdout
    tar = fmt == "tar"
    cluster = cluster or os.environ.get("DATAFUSION_TPU_CLUSTER")
    targets: list = [(f"{h}:{p}", f"http://{h}:{p}/debug/bundle")
                     for h, p in _addrs(workers)]
    if not workers and cluster:
        from datafusion_tpu_torch.cluster import connect

        status = connect(cluster).status()
        for addr, info in sorted(status.get("workers", {}).items()):
            dport = (info or {}).get("debug_port")
            host = addr.rpartition(":")[0]
            targets.append((addr, f"http://{host}:{dport}/debug/bundle" if dport else None))
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="datafusion_tpu_bundles_")
    os.makedirs(out_dir, exist_ok=True)

    def _stem(member: str) -> str:
        return f"bundle-{member.replace(':', '-').replace('/', '-')}"

    def _write(member: str, doc: dict) -> str:
        path = os.path.join(out_dir, f"{_stem(member)}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
        return path

    def _write_tar(member: str, blob: bytes) -> str:
        path = os.path.join(out_dir, f"{_stem(member)}.tar")
        with open(path, "wb") as f:
            f.write(blob)
        return path

    def _wal_summary(doc: dict) -> str:
        parts = []
        for m in doc.get("wal") or []:
            age = m.get("last_fsync_age_s")
            rec = m.get("recovery") or {}
            clause = (f"{m.get('segments', 0)} segs {m.get('bytes_written', 0)}B "
                      f"fsync_age={age if age is None else f'{age:.1f}s'}")
            if rec:
                clause += (f" recovered@rev={rec.get('recovered_rev')} "
                           f"({rec.get('replayed_events')} events, "
                           f"{rec.get('torn_tails')} torn)")
            parts.append(clause)
        return f"; wal: {' | '.join(parts)}" if parts else ""

    def _tar_summary(blob: bytes) -> str:
        import io
        import tarfile

        try:
            with tarfile.open(fileobj=io.BytesIO(blob)) as tf:
                names = tf.getnames()
        except tarfile.TarError:
            return f"{len(blob)} bytes (not a tar stream)"
        return f"{len(blob)} bytes, {len(names)} members: {', '.join(names)}"

    failures = 0
    if not targets:
        from datafusion_tpu_torch.obs.httpd import build_bundle, build_bundle_tar

        if tar:
            blob = build_bundle_tar(profile_seconds=seconds)
            print(f"local: {_write_tar('local', blob)} ({_tar_summary(blob)})", file=out)
        else:
            doc = build_bundle(profile_seconds=seconds)
            path = _write("local", doc)
            print(f"local: {path} ({(doc.get('profile') or {}).get('samples', 0)} profile "
                  f"samples, {len(doc['flights']['events'])} flight events"
                  f"{_wal_summary(doc)})", file=out)
    # the debug plane may be token-guarded: forward the operator's token
    headers = {}
    token = os.environ.get("DATAFUSION_TPU_DEBUG_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    for member, url in targets:
        if url is None:
            print(f"{member}: NO debug port advertised in its lease (start the "
                  "worker with --http-port / DATAFUSION_TPU_DEBUG_PORT)", file=out)
            failures += 1
            continue
        try:
            req = urllib.request.Request(f"{url}?seconds={seconds:g}"
                                         + ("&format=tar" if tar else ""), headers=headers)
            with urllib.request.urlopen(req, timeout=seconds + 15) as resp:
                raw = resp.read()
            if tar:
                print(f"{member}: {_write_tar(member, raw)} ({_tar_summary(raw)})", file=out)
                continue
            doc = json.loads(raw)
        except (OSError, ValueError) as e:
            print(f"{member}: bundle pull failed: {e}", file=out)
            failures += 1
            continue
        path = _write(member, doc)
        prof = doc.get("profile") or {}
        print(f"{member}: {path} ({prof.get('samples', 0)} profile samples, "
              f"{len((doc.get('flights') or {}).get('events', []))} flight events"
              f"{_wal_summary(doc)})", file=out)
    n = max(len(targets), 1)
    print(f"bundles written to {out_dir} ({n - failures}/{n} ok)", file=out)
    return 1 if failures else 0


def make_context(device: Optional[str] = None, batch_size: int = 131072):
    """An ExecutionContext (`cuda:0` unless `device` says otherwise)
    with the console's geo UDFs registered as host functions."""
    from datafusion_tpu_torch.datatypes import DataType, Field, StructType
    from datafusion_tpu_torch.exec.context import ExecutionContext

    ctx = ExecutionContext(device=device, batch_size=batch_size)

    point_t = StructType(
        [Field("x", DataType.FLOAT64, False), Field("y", DataType.FLOAT64, False)]
    )

    def st_point(x, y):
        return (np.asarray(x, np.float64), np.asarray(y, np.float64))

    def st_astext(pt):
        x, y = pt
        return np.asarray(
            [f"POINT ({_fmt_float(a)} {_fmt_float(b)})" for a, b in zip(x, y)],
            dtype=object,
        )

    ctx.register_udf(
        "ST_Point", [DataType.FLOAT64, DataType.FLOAT64], point_t, host_fn=st_point
    )
    ctx.register_udf("ST_AsText", [point_t], DataType.UTF8, host_fn=st_astext)
    return ctx


class Console:
    """Statement executor (reference `Console`, main.rs:113-153).

    `\\timing` toggles a per-query engine-stage breakdown (parse / plan
    / verify / collect timers and the counters of utils/metrics.py)
    after each result.
    """

    def __init__(self, ctx, out=None, timing: bool = False):
        self.ctx = ctx
        self.out = out if out is not None else sys.stdout
        self.timing = timing

    def _print(self, *a):
        print(*a, file=self.out)

    def handle_command(self, line: str) -> bool:
        """Backslash console commands; True when `line` was one."""
        stripped = line.strip()
        cmd = stripped.lower()
        if cmd == "\\timing":
            self.timing = not self.timing
            self._print(f"Timing is {'on' if self.timing else 'off'}.")
            return True
        if cmd == "\\explain" or cmd.startswith("\\explain "):
            # \explain SELECT ...: EXPLAIN ANALYZE, the annotated
            # operator tree and span timeline (obs/explain.py)
            arg = stripped[len("\\explain"):].strip().rstrip(";").strip()
            if not arg:
                self._print("Usage: \\explain <sql statement>")
            else:
                self.execute(f"EXPLAIN ANALYZE {arg}")
            return True
        if cmd == "\\hbm":
            # the device ledger: live and peak bytes by device and
            # owner, and the pins (obs/device.py)
            from datafusion_tpu_torch.obs.device import LEDGER

            self._print(LEDGER.report_text())
            return True
        if cmd == "\\top":
            # the telemetry view (obs/aggregate.py): fleet-wide on a
            # DistributedContext, this process's otherwise
            self._print(fleet_top_text(self.ctx))
            return True
        if cmd == "\\cache":
            # the result cache (cache/): counters, byte budget and each
            # fingerprint's runs
            self._cache_status()
            return True
        if cmd == "\\ingest":
            # the ingest plane (ingest/): appendable tables, views and
            # their freshness, the log
            self._ingest_status()
            return True
        if cmd == "\\cost":
            # the cost store (cost/): its observations per table, the
            # recent planner decisions and replans
            self._cost_status()
            return True
        if cmd == "\\cluster":
            # the cluster control plane (cluster/): membership epoch,
            # live workers and their lease ages, replication, the
            # shared result tier
            self._cluster_status()
            return True
        if cmd.startswith("\\append"):
            # \append <table> {"col": [v, ...], ...}: one logged delta
            self._append(stripped[len("\\append"):].strip())
            return True
        return False

    def _cluster_status(self) -> None:
        import os

        client = getattr(self.ctx, "cluster", None)
        target = os.environ.get("DATAFUSION_TPU_CLUSTER")
        if client is None and not target:
            self._print("Cluster mode is off (no DATAFUSION_TPU_CLUSTER and the "
                        "context has no cluster client).")
            return
        from datafusion_tpu_torch.errors import ExecutionError

        try:
            if client is None:
                from datafusion_tpu_torch.cluster import connect

                client = connect(target)
            status = client.status()
        except (ConnectionError, OSError, ExecutionError) as e:
            # an error reply from the service is reported, not fatal
            self._print(f"Cluster service unreachable: {e}")
            return
        self._print(f"Cluster epoch {status['epoch']} (rev {status['rev']}), "
                    f"{len(status['workers'])} live worker(s), "
                    f"service up {status['uptime_s']}s")
        if "role" in status:
            lag = status.get("replication_lag_revisions", 0)
            self._print(f"Replica role {status['role']}, term {status.get('term')}, "
                        f"replication lag {lag} revision(s)"
                        + (f", standby of {status['standby_of']}"
                           if status.get("standby_of") else ""))
            if status.get("replica_set_size", 1) > 1 or status.get("write_quorum", 1) > 1:
                self._print(f"Replica set: {status.get('replica_set_size', 1)} node(s), "
                            f"write quorum {status.get('write_quorum', 1)}, succession "
                            f"rank {status.get('rank', 0)}, "
                            f"{status.get('parked_watchers', 0)} parked watch(es)")
        for addr, info in sorted(status["workers"].items()):
            self._print(f"  worker {addr}: lease age {info.get('lease_age_s')}s")
        r = status["results"]
        self._print(f"Shared result tier: {r['entries']} entries, "
                    f"{r['bytes']}/{r['max_bytes']} bytes, {r['hits']} hits, "
                    f"{r['misses']} misses, {r['invalidations']} invalidations")
        membership = getattr(self.ctx, "membership", None)
        if membership is not None:
            lag = membership.watch_lag_s
            self._print(f"This coordinator: epoch {membership.epoch}, watch lag "
                        f"{'never refreshed' if lag is None else f'{lag:.3f}s'}")

    def _cost_status(self) -> None:
        from datafusion_tpu_torch import cost as _cost

        snap = _cost.store().snapshot()
        state = "on" if _cost.enabled() else "off (DATAFUSION_TPU_COST=0)"
        where = snap["path"] or "in-memory"
        self._print(f"Cost store: {snap['entries']} entr(ies), "
                    f"adaptive planning {state}, persisted to {where}")
        for tkey, shapes in sorted(snap["tables"].items()):
            self._print(f"  {tkey}:")
            for shape, rec in sorted(shapes.items()):
                facts = ", ".join(
                    f"{k}={rec[k]:.4g}" for k in sorted(rec)
                    if k not in ("n", "ts") and not k.endswith("_last")
                    and not k.endswith("_max"))
                self._print(f"    {shape}: n={rec.get('n', 0)} ({facts})")
        for d in snap["decisions"][-8:]:
            where = f" [{d['table']}]" if d.get("table") else ""
            self._print(f"  decision {d['decision']}{where}: chose {d['chosen']} "
                        f"(default {d['default']}) — {d['reason']}")
        for r in snap["replans"][-4:]:
            self._print(f"  replan {r['what']}: estimated {r['estimate']}, "
                        f"observed {r['actual']} — {r['action']}")
        if not snap["tables"]:
            self._print("  (no observations yet)")

    def _cache_status(self) -> None:
        store = getattr(self.ctx, "result_cache", None)
        if store is None:
            self._print("Result cache is off (DATAFUSION_TPU_CACHE=0).")
            return
        s = store.stats()
        self._print(
            f"Result cache: {s['entries']} entries, "
            f"{s['bytes']}/{s['max_bytes']} bytes, "
            f"ttl {s['ttl_s']}s — {s['hits']} hits, "
            f"{s['misses']} misses, {s['evictions']} evictions, "
            f"{s['invalidations']} invalidations"
        )
        for fp, runs in self.ctx.stats_history().items():
            warm = sum(1 for r in runs if r.get("cache_hit"))
            self._print(
                f"  {fp}: {len(runs)} runs ({warm} cached), "
                f"last {runs[-1]['wall_s'] * 1e3:.1f} ms"
            )

    def _ingest_status(self) -> None:
        st = self.ctx.ingest().status()
        wal = st["wal"]
        self._print(
            f"Ingest rev {st['rev']}, "
            + (f"WAL {wal['appends']} append(s) in {wal['segments']} "
               f"segment(s) ({wal['segment_bytes']} bytes)"
               if wal else "no WAL (in-memory)")
        )
        if st["recovery"]:
            r = st["recovery"]
            self._print(
                f"  recovered: {r.get('appends_replayed', 0)} append(s) "
                f"replayed, {r.get('views_recovered', 0)} view(s) re-planned"
            )
        for name, t in sorted(st["tables"].items()):
            self._print(
                f"  table {name}: {t['rows']} rows "
                f"({t['base_batches']} base batch(es)), "
                f"data version {t['data_version']}"
            )
        for name, v in sorted(st["views"].items()):
            mode = ("incremental" if v["incremental"]
                    else f"full-recompute ({v['fallback_reason']})")
            self._print(
                f"  view {name} ON {v['table']}: rev {v['revision']}, "
                f"{mode}, lag {v['lag_s'] * 1e3:.1f} ms, "
                f"{v['maintain_launches']} maintain launch(es)"
            )
        if not st["tables"] and not st["views"]:
            self._print("  (no appendable tables or materialized views)")

    def _append(self, arg: str) -> None:
        import json

        from datafusion_tpu_torch.errors import DataFusionError

        table, _, payload = arg.partition(" ")
        if not table or not payload.strip():
            self._print('Usage: \\append <table> {"col": [values], ...}')
            return
        try:
            columns = json.loads(payload)
        except ValueError as e:
            self._print(f"Bad columns JSON: {e}")
            return
        try:
            ack = self.ctx.ingest().append(table, columns)
        except DataFusionError as e:
            self._print(f"Append failed: {e}")
            return
        views = ", ".join(f"{n}@r{r}" for n, r in ack["views"].items())
        self._print(
            f"Appended {ack['rows']} row(s) to {ack['table']} "
            f"(rev {ack['rev']}"
            + (f"; views advanced: {views})" if views else ")")
        )

    def execute(self, sql: str) -> None:
        sql = sql.strip().rstrip(";").strip()
        if not sql:
            return
        if self.handle_command(sql):
            return
        self._print("Executing query ...")
        from datafusion_tpu_torch.utils.metrics import METRICS

        if self.timing:
            METRICS.reset()
        t0 = time.perf_counter()
        try:
            result = self.ctx.sql_collect(sql)
        except Exception as e:  # noqa: BLE001 — errors print, the console survives
            self._print(f"Error: {e}")
            return
        elapsed = time.perf_counter() - t0
        from datafusion_tpu_torch.analysis.verify import ExplainVerifyResult
        from datafusion_tpu_torch.exec.context import ExplainResult
        from datafusion_tpu_torch.exec.materialize import ResultTable
        from datafusion_tpu_torch.obs.explain import ExplainAnalyzeResult

        if isinstance(result, ResultTable):
            for row in result.to_rows():
                self._print("\t".join("NULL" if v is None else str(v) for v in row))
        elif isinstance(result, (ExplainResult, ExplainAnalyzeResult, ExplainVerifyResult)):
            # the plan tree (EXPLAIN), the annotated operator tree and
            # span timeline (EXPLAIN ANALYZE, \explain) or the
            # inferred-schema report (EXPLAIN VERIFY)
            self._print(repr(result))
        # "seconds" keeps this line inside the golden diff's -I filter
        self._print(f"Query executed in {elapsed:.3f} seconds")
        if self.timing:
            snap = METRICS.snapshot()
            stages = ", ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in sorted(snap["timings_s"].items())
            )
            counters = ", ".join(f"{k}={v}" for k, v in sorted(snap["counts"].items()))
            self._print(f"Timing: {stages or 'no stages recorded'}")
            if counters:
                self._print(f"Counters: {counters}")


def run_script(console: Console, path: str) -> None:
    """Accumulate lines until ';', then execute (main.rs:41-63)."""
    with open(path, "r", encoding="utf-8") as f:
        buf = ""
        for line in f:
            if not buf.strip() and console.handle_command(line):
                continue  # line command, outside statement splitting
            buf += line
            stmts, buf = split_statements_partial(buf)
            for stmt in stmts:
                console.execute(stmt)
        for stmt in split_statements(buf):  # comment-stripped leftover
            console.execute(stmt)


def _init_readline() -> None:
    """Line editing and persistent history for the interactive REPL
    (the reference console's rustyline, `linereader.rs:47-103`)."""
    try:
        import readline
    except ImportError:  # platform without readline: plain input()
        return
    import atexit
    import os

    histfile = os.path.join(os.path.expanduser("~"), ".datafusion_tpu_torch_history")
    try:
        readline.read_history_file(histfile)
    except OSError:
        pass
    readline.set_history_length(1000)

    def _save():
        try:
            readline.write_history_file(histfile)
        except OSError:
            pass

    atexit.register(_save)


def run_interactive(console: Console) -> None:
    """REPL with continuation prompts (linereader.rs:47-103).

    Ctrl-C clears the statement buffer and returns to a fresh prompt;
    Ctrl-D exits."""
    _init_readline()
    buf = ""
    while True:
        prompt = "datafusion> " if not buf else "> "
        try:
            line = input(prompt)
        except KeyboardInterrupt:
            print("^C")
            buf = ""
            continue
        except EOFError:
            print()
            return
        if not buf and line.strip().lower() in ("quit", "exit"):
            return
        if not buf and console.handle_command(line):
            # backslash commands are line commands (psql convention)
            continue
        buf += line + "\n"
        stmts, buf = split_statements_partial(buf)
        for stmt in stmts:
            console.execute(stmt)
        if not split_statements(buf):
            # a whitespace- or comment-only leftover must not hold the
            # '>' continuation prompt (or disable quit/exit)
            buf = ""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="datafusion-tpu-torch", description="DataFusion SQL console on PyTorch and CUDA"
    )
    parser.add_argument(
        "mode", nargs="?", choices=["top", "debug-bundle"],
        help="'top': print the telemetry view (latency percentiles, cache hit "
             "rates, SLO burn rates) and exit (or repeat with --watch); "
             "'debug-bundle': pull one debug bundle from each --workers debug "
             "plane (obs/httpd.py) into --out, or bundle this process",
    )
    parser.add_argument("--script", help="execute commands from file, then exit")
    parser.add_argument(
        "--device", default=None,
        help="execution device (default cuda:0; 'cpu' runs on the CPU)",
    )
    parser.add_argument("--batch-size", type=int, default=131072)
    parser.add_argument(
        "--timing", action="store_true",
        help="print per-query engine stage timings (same as \\timing)",
    )
    parser.add_argument(
        "--workers", default=None,
        help="top mode: worker addresses host:port to aggregate; debug-bundle "
             "mode: host:port of the workers' DEBUG HTTP planes (default: "
             "discover them through --cluster)",
    )
    parser.add_argument(
        "--cluster", default=None,
        help="top / debug-bundle mode: cluster service address host:port "
             "(default: env DATAFUSION_TPU_CLUSTER); the fleet is its live "
             "members",
    )
    parser.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                        help="top mode: refresh every N seconds until interrupted")
    parser.add_argument("--tenants", action="store_true",
                        help="top mode: append the per-client metering table")
    parser.add_argument("--qos", action="store_true",
                        help="top mode: append the fair-share view and scale hint")
    parser.add_argument("--out", default=None, metavar="DIR",
                        help="debug-bundle mode: directory for the bundles "
                             "(default: a fresh temporary directory, printed)")
    parser.add_argument("--seconds", type=float, default=0.5, metavar="N",
                        help="debug-bundle mode: host-profile capture per member "
                             "(default 0.5)")
    parser.add_argument("--format", default="json", choices=["json", "tar"],
                        help="debug-bundle mode: 'tar' pulls the tar stream of raw "
                             "members instead of one JSON document each")
    args = parser.parse_args(argv)

    from datafusion_tpu_torch.errors import ExecutionError

    if args.mode == "top":
        try:
            return run_top(args.workers, args.watch, tenants=args.tenants, qos=args.qos,
                           device=args.device, cluster=args.cluster)
        except ExecutionError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    if args.mode == "debug-bundle":
        try:
            return run_debug_bundle(args.workers, args.out, args.seconds, fmt=args.format,
                                    cluster=args.cluster)
        except (ConnectionError, OSError, ExecutionError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    try:
        ctx = make_context(args.device, args.batch_size)
    except ExecutionError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print("DataFusion Console")
    console = Console(ctx, timing=args.timing)
    if args.script:
        run_script(console, args.script)
    else:
        run_interactive(console)
    return 0


if __name__ == "__main__":
    sys.exit(main())
