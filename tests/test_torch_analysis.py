"""The port's analyzers: the invariant linter (`analysis/lint.py`), its
CLI (`python -m datafusion_tpu_torch.analysis`) and the lock-order
checker over the port's named locks (`analysis/lockcheck.py`).

- DF002 to DF005, DF007 and DF008 on the fixture sources of
  `tests/test_analysis.py` (and of `tests/test_profiler.py` for DF007):
  the port's linter gives the same (rule, line) findings as the JAX
  package's, one case a rule;
- DF001 and DF006 on torch-shaped fixtures;
- the port lints itself clean, and every `# df-lint: ok` marker in it
  carries a reason;
- the CLI's text, github and `--list-rules` output, and
  `--lockcheck-report`'s exit code and lines against the JAX package's;
- a `DATAFUSION_TPU_LOCKCHECK=1` subprocess: a CPU served Q1 round, an
  append through the log and a result-cache hit give no cycle and no
  blocking call under a lock, the serving locks are in the graph, the
  metrics registry's leaf lock has no outgoing edge, and a seeded
  two-lock inversion is reported as a cycle.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from datafusion_tpu.analysis import lint as jlint
from datafusion_tpu.analysis import lockcheck as jlockcheck
from datafusion_tpu.analysis.__main__ import main as jmain

from datafusion_tpu_torch.analysis import lint, lockcheck
from datafusion_tpu_torch.analysis.__main__ import main as tmain

from test_torch_dataframe import LINEITEM_DDL, lineitem_csv
from test_torch_port import Q1

REPO = Path(__file__).resolve().parents[1]

# (rule, relative path under the package, source): tests/test_analysis.py's
# fixtures, and tests/test_profiler.py's for the sampler rules
SHARED_FIXTURES = {
    "DF002": ("x.py", (
        "import time, random\n"
        "from datafusion_tpu.testing import faults\n"
        "def replay():\n"
        "    faults.check('site')\n"
        "    t = time.time()\n"
        "    r = random.random()\n"
        "    time.monotonic(); time.sleep(0)\n"
        "    return t, r\n"
        "def free():\n"
        "    return time.time()\n"
    )),
    "DF003": ("x.py", (
        "def bad(sock):\n"
        "    sock.sendall(b'x')\n"
        "def good(sock):\n"
        "    from datafusion_tpu.testing import faults\n"
        "    faults.check('my.site')\n"
        "    sock.sendall(b'x')\n"
    )),
    "DF004": ("x.py", (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        raise\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:  # noqa: BLE001 — justified\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except ValueError:\n"
        "        pass\n"
    )),
    "DF005": ("utils/metrics.py", (
        "import threading\n"
        "class Metrics:\n"
        "    def add(self, n):\n"
        "        with self._lock:\n"
        "            pass\n"
        "class C:\n"
        "    def _fold(self, k):\n"
        "        with self._lock:\n"
        "            self.d[k] = 1\n"
    )),
    "DF007": ("obs/profiler.py", (
        "class P:\n"
        "    def _sample_once(self, me):\n"
        "        with open('/tmp/x', 'w') as f:\n"
        "            f.write('x')\n"
        "    def _run(self):\n"
        "        import time\n"
        "        time.sleep(1)\n"
        "def report():\n"
        "    with open('/tmp/x', 'w') as f:\n"
        "        f.write('x')\n"
    )),
    "DF008": ("cluster/service.py", (
        "import os\n"
        "class Node:\n"
        "    def bad(self):\n"
        "        with self._lock:\n"
        "            os.fsync(3)\n"
        "            open('/tmp/x', 'wb')\n"
        "            self._wal_sync()\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            tail = list(self._events)\n"
        "        self._wal_sync()\n"
    )),
}

# where each shared rule must stay silent: the same source elsewhere
SILENT_PATHS = {
    "DF005": "cache/store.py",
    "DF007": "obs/trace.py",
    "DF008": "utils/wal.py",
}


def _pairs(findings, rule=None):
    return [(f.rule, f.line) for f in findings if rule is None or f.rule == rule]


@pytest.mark.parametrize("rule", sorted(SHARED_FIXTURES))
def test_shared_rule_findings_equal_the_jax_linters(rule):
    rel, src = SHARED_FIXTURES[rule]
    want = _pairs(jlint.lint_source(src, f"datafusion_tpu/{rel}"))
    got = _pairs(lint.lint_source(src, f"datafusion_tpu_torch/{rel}"))
    assert got == want
    assert (rule, got[0][1]) in got  # the fixture does fire its rule
    if rule in SILENT_PATHS:
        other = SILENT_PATHS[rule]
        assert _pairs(lint.lint_source(src, f"datafusion_tpu_torch/{other}"), rule) == \
            _pairs(jlint.lint_source(src, f"datafusion_tpu/{other}"), rule)


def test_df001_flags_the_torch_host_syncs_in_exec_only():
    src = textwrap.dedent("""\
        import torch
        def f(x, ev, s):
            a = x.item()
            b = x.cpu()
            c = x.tolist()
            d = x.numpy()
            torch.cuda.synchronize()
            ev.synchronize()
            s.synchronize()
            e = x.sum()
            return a, b, c, d, e
        """)
    found = lint.lint_source(src, "datafusion_tpu_torch/exec/aggregate.py")
    assert _pairs(found) == [("DF001", n) for n in range(3, 10)]
    assert lint.lint_source(src, "datafusion_tpu_torch/cli.py") == []
    # the fused fold also bans np.asarray (a pull of a device input)
    fused = "import numpy as np\ndef f(x):\n    return np.asarray(x)\n"
    assert _pairs(lint.lint_source(fused, "datafusion_tpu_torch/exec/fused.py")) == \
        [("DF001", 3)]
    assert lint.lint_source(fused, "datafusion_tpu_torch/exec/sort.py") == []
    marked = "def f(x):\n    return x.item()  # df-lint: ok(DF001) — one flag a build\n"
    assert lint.lint_source(marked, "datafusion_tpu_torch/exec/sort.py") == []


def test_df006_flags_raw_copies_outside_the_seam():
    src = textwrap.dedent("""\
        import torch
        def f(x, arr, device):
            a = x.cuda()
            b = x.to(device)
            c = x.to("cuda:0", non_blocking=True)
            d = torch.as_tensor(arr, device=device)
            e = torch.tensor(3, device=torch.device("cuda"))
            g = torch.from_numpy(arr).to(x.device)
            h = x.to(torch.float32)
            i = torch.as_tensor(arr)
            j = torch.empty(4, device=device)
            return a, b, c, d, e, g, h, i, j
        def to_device(arr, device):
            return torch.from_numpy(arr).to(device)
        """)
    found = lint.lint_source(src, "datafusion_tpu_torch/exec/aggregate.py")
    assert _pairs(found) == [("DF006", n) for n in (*range(3, 9), 14)]
    # the seam: exec/batch.to_device (and put_compressed), and the ledger
    in_batch = lint.lint_source(src, "datafusion_tpu_torch/exec/batch.py")
    assert _pairs(in_batch) == [("DF006", n) for n in range(3, 9)]
    assert lint.lint_source(src, "datafusion_tpu_torch/obs/device.py") == []


def test_the_port_lints_itself_clean():
    findings = lint.lint_paths([str(REPO / "datafusion_tpu_torch")])
    assert findings == [], "\n".join(f.text() for f in findings)


def test_every_suppression_marker_carries_a_reason():
    marker = re.compile(r"#\s*df-lint:\s*ok(?:\(([A-Z0-9, ]+)\))?(.*)$")
    count = 0
    for path in sorted((REPO / "datafusion_tpu_torch").rglob("*.py")):
        for n, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
            m = marker.search(line)
            if m is None or "``" in line:  # the linter's own docs quote it
                continue
            count += 1
            where = f"{path.relative_to(REPO)}:{n}"
            assert m.group(1), f"{where}: a blanket marker names no rule"
            reason = m.group(2).strip().lstrip("—-:").strip()
            assert len(reason) >= 10, f"{where}: marker without a reason"
    assert count > 0


def test_cli_text_github_and_rule_list(tmp_path, capsys):
    assert tmain([]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("0 finding(s) in datafusion_tpu_torch")
    bad = tmp_path / "datafusion_tpu_torch" / "exec"
    bad.mkdir(parents=True)
    f = bad / "sort.py"
    f.write_text("def g(x):\n    return x.item()\n")
    assert tmain([str(f)]) == 1
    out = capsys.readouterr().out
    assert f"{f}:2:12: DF001" in out and "1 finding(s)" in out
    assert tmain([str(f), "--format=github"]) == 1
    out = capsys.readouterr().out
    assert f"::error file={f},line=2,col=12::DF001" in out
    assert tmain(["--list-rules"]) == 0
    rules = capsys.readouterr().out.splitlines()
    assert [r.split()[0] for r in rules] == [f"DF00{i}" for i in range(1, 9)]


def test_cli_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch.analysis", "datafusion_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_lockcheck_report_exit_code_and_lines_equal_the_jax_packages(tmp_path, capsys):
    reg = lockcheck.Registry()
    a = lockcheck.TrackedLock("a", reg)
    b = lockcheck.TrackedLock("b", reg)
    with a:
        with b:
            pass
    with b:
        with a:
            reg.note_blocking("wire.recv")
    path = tmp_path / "lockcheck.json"
    path.write_text(json.dumps(reg.report()))
    assert tmain(["--lockcheck-report", str(path)]) == 1
    ours = capsys.readouterr().out
    assert jmain(["--lockcheck-report", str(path)]) == 1
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert "lockcheck: lock-order cycle: a -> b -> a" in ours
    assert "lockcheck: blocking call 'wire.recv' while holding" in ours
    assert "lockcheck report: 3 issue(s), 2 lock-order edge(s) observed" in ours
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(jlockcheck.Registry().report()))
    assert tmain(["--lockcheck-report", str(clean)]) == 0


def test_metrics_lock_is_a_named_leaf(monkeypatch):
    reg = lockcheck.Registry()
    monkeypatch.setattr(lockcheck, "_ENABLED", True)
    monkeypatch.setattr(lockcheck, "GLOBAL", reg)
    from datafusion_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    assert isinstance(m._lock, lockcheck.TrackedLock) and m._lock.name == "utils.metrics"
    outer = lockcheck.TrackedLock("outer", reg)
    with outer:
        m.add("x")
        with m.timer("t"):
            pass
        m.tally("t", 0.5, ("y", 2))
    assert m.snapshot()["counts"] == {"x": 1, "y": 2}
    assert [(e["held"], e["acquired"]) for e in reg.report()["edges"]] == [
        ("outer", "utils.metrics")]


_SCRIPT = textwrap.dedent("""\
    import json, sys, threading
    import numpy as np
    from datafusion_tpu_torch.analysis import lockcheck
    import datafusion_tpu_torch as tdf
    from datafusion_tpu_torch.exec.datasource import MemoryDataSource

    csv, wal, engine_out, ddl, q1 = sys.argv[1:6]
    assert lockcheck.enabled()
    # a served Q1 round: served DDL, then 8 clients over 2 workers
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=512)
    rows = []
    with ctx.serve(workers=2, window_s=0.005) as srv:
        srv.submit(ddl.format(csv)).result(timeout=60)
        def client(i):
            rows.append(srv.submit(q1, client_id=f"c{i}").result(timeout=60).num_rows)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert rows == [4] * 8, rows
    # an append through the write-ahead log
    schema = tdf.Schema([tdf.Field("k", tdf.DataType.INT64, False),
                         tdf.Field("v", tdf.DataType.FLOAT64, False)])
    ictx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ictx.register_datasource("t", MemoryDataSource(
        schema, [tdf.make_host_batch(schema, [np.arange(8), np.arange(8.0)])]))
    ing = ictx.ingest(wal_dir=wal)
    ing.append("t", {"k": [8, 9], "v": [8.0, 9.0]})
    n = tdf.collect(ictx.sql("SELECT k FROM t")).num_rows
    assert n == 10, n
    # a result-cache hit
    from datafusion_tpu_torch.utils.metrics import METRICS
    cctx = tdf.ExecutionContext(device="cpu", batch_size=512)
    cctx.sql(ddl.format(csv))
    before = METRICS.counts.get("cache.result.hits", 0)
    first = tdf.collect(cctx.sql(q1)).to_rows()
    again = tdf.collect(cctx.sql(q1)).to_rows()
    assert first == again and METRICS.counts.get("cache.result.hits", 0) > before
    with open(engine_out, "w") as f:
        json.dump(lockcheck.report(), f)
    # a seeded inversion: the exit report must show it as a cycle
    a, b = lockcheck.make_lock("seeded.a"), lockcheck.make_lock("seeded.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    """)


def test_lockcheck_run_of_the_served_path(tmp_path):
    csv = tmp_path / "lineitem.csv"
    lineitem_csv(csv)
    script = tmp_path / "run.py"
    script.write_text(_SCRIPT)
    engine = tmp_path / "engine.json"
    final = tmp_path / "final.json"
    env = {**os.environ, "DATAFUSION_TPU_LOCKCHECK": "1",
           "DATAFUSION_TPU_LOCKCHECK_FILE": str(final),
           "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, str(script), str(csv), str(tmp_path / "wal"), str(engine),
         LINEITEM_DDL, Q1],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(engine.read_text())
    assert rep["cycles"] == [] and rep["blocking"] == [], rep
    names = {e["held"] for e in rep["edges"]} | {e["acquired"] for e in rep["edges"]}
    assert {"serve.pin_source", "serve.shared_ids", "utils.metrics"} <= names, names
    assert not [e for e in rep["edges"] if e["held"] == "utils.metrics"], rep["edges"]
    out = json.loads(final.read_text())
    assert [c["cycle"] for c in out["cycles"]] == [["seeded.a", "seeded.b", "seeded.a"]]
    assert "1 cycle(s)" in proc.stderr
    assert tmain(["--lockcheck-report", str(final)]) == 1
    assert tmain(["--lockcheck-report", str(engine)]) == 0
