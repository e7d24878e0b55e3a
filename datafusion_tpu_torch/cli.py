"""The SQL console on the port: the JAX package's `cli.py`.

A banner, script mode (`--script file.sql`, statements accumulate
until `;`), an interactive REPL with `datafusion>` / `>` continuation
prompts and `quit`/`exit`, per-query wall-clock timing, DDL, result
rows, EXPLAIN / EXPLAIN VERIFY plans, EXPLAIN ANALYZE reports (also as
`\\explain <sql>`), the device ledger's report (`\\hbm`), the result
cache's counters and per-query history (`\\cache`), the ingest plane's
tables, views and log (`\\ingest`), one logged append
(`\\append <table> {"col": [values], ...}`), and the
`ST_Point`/`ST_AsText` geo UDFs the reference's golden smoketest expects
(`test/data/smoketest.sql`, `test/data/smoketest-expected.txt`).

Run: ``python -m datafusion_tpu_torch.cli [--script FILE] [--device cpu]``

The console runs on `cuda:0` unless `--device` names another device
(`cpu` only when asked).  The `top` and `debug-bundle` modes and the
commands `\\cluster \\top \\cost` need planes that are not ported
yet: each prints an error naming its ROADMAP item, and the console
carries on.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from datafusion_tpu_torch.sql.parser import split_statements, split_statements_partial

# console commands and modes that wait for an unported plane, with the
# ROADMAP item that ports it
_UNPORTED = {
    "\\cluster": "the cluster control plane, ROADMAP queue 1 item 13.2",
    "\\top": "fleet telemetry, ROADMAP queue 1 item 13.2",
    "\\cost": "the cost store, ROADMAP queue 1 item 11.4",
    "top": "fleet telemetry, ROADMAP queue 1 item 13.2",
    "debug-bundle": "debug bundles, ROADMAP queue 1 item 13.2",
}


def _not_ported(name: str) -> str:
    return f"Error: {name} is not ported yet ({_UNPORTED[name]})"


def _fmt_float(v: float) -> str:
    """Shortest round-trip decimal (matches the golden output's
    `52.412811`, `0.10231` style)."""
    return repr(float(v))


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
        if cmd.startswith("\\append"):
            # \append <table> {"col": [v, ...], ...}: one logged delta
            self._append(stripped[len("\\append"):].strip())
            return True
        name = cmd.split(None, 1)[0] if cmd else ""
        if name in _UNPORTED and name.startswith("\\"):
            self._print(_not_ported(name))
            return True
        return False

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
        help="the JAX package's fleet view and debug bundles (not ported yet)",
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
    args = parser.parse_args(argv)

    if args.mode is not None:
        print(_not_ported(args.mode))
        return 1
    from datafusion_tpu_torch.errors import ExecutionError

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
