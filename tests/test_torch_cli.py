"""PyTorch/CUDA port, slice 10: the console (`datafusion_tpu_torch/cli.py`)
against the JAX package's (`datafusion_tpu/cli.py`).

The reference's golden smoketest (`test/data/smoketest.sql` against
`test/data/smoketest-expected.txt`, under the golden rule of
`tests/test_cli.py`: banner and blank lines dropped, trailing spaces
stripped, lines holding "seconds" ignored) runs through the port's
console on the CPU, in process and as `python -m datafusion_tpu_torch.cli
--device cpu --script`.  One case for each console behaviour of the
JAX package's `tests/test_cli.py`, and the console's text equal to the
JAX console's for the same scripts (float32 columns, NULLs, EXPLAIN,
errors).  Without `--device` the console means `cuda:0`, so here it
exits non-zero.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import sys

import pytest

from datafusion_tpu.cli import Console as JaxConsole
from datafusion_tpu.cli import make_context as jax_make_context
from datafusion_tpu.cli import run_script as jax_run_script

from datafusion_tpu_torch.cli import Console, make_context, run_script
from datafusion_tpu_torch.sql.parser import split_statements, split_statements_partial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")


def _run(sql_text: str, tmp_path, jax: bool = False, timing: bool = False) -> list[str]:
    script = tmp_path / ("jax.sql" if jax else "port.sql")
    script.write_text(sql_text)
    out = io.StringIO()
    if jax:
        console = JaxConsole(jax_make_context("cpu"), out=out, timing=timing)
        jax_run_script(console, str(script))
    else:
        console = Console(make_context("cpu"), out=out, timing=timing)
        run_script(console, str(script))
    return out.getvalue().splitlines()


def _strip_timing(lines: list[str]) -> list[str]:
    # the golden harness ignores timing lines (diff -I seconds)
    return [line.rstrip() for line in lines if "seconds" not in line and line.strip()]


def _golden() -> tuple[str, list[str]]:
    sql = open(os.path.join(DATA, "smoketest.sql")).read()
    # the reference's harness mounted the fixtures at /test/data
    sql = sql.replace("'/test/data/", f"'{DATA}/")
    want = open(os.path.join(DATA, "smoketest-expected.txt")).read().splitlines()
    want = [line.rstrip() for line in want if line.strip() and line != "DataFusion Console"]
    return sql, want


def _env(tmp_path):
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, HOME=str(tmp_path))


# ------------------------------------------------------------ golden


def test_smoketest_matches_golden_output(tmp_path):
    sql, want = _golden()
    assert _strip_timing(_run(sql, tmp_path)) == want


def test_smoketest_script_mode_matches_golden_output(tmp_path):
    sql, want = _golden()
    script = tmp_path / "smoketest.sql"
    script.write_text(sql)
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch.cli", "--device", "cpu",
         "--script", str(script)],
        capture_output=True, text=True, timeout=300, env=_env(tmp_path), cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert _strip_timing(proc.stdout.splitlines()) == ["DataFusion Console"] + want


# ------------------------------------------------------------ console


def test_ddl_then_query(tmp_path):
    lines = _run(
        "CREATE EXTERNAL TABLE people (id INT, first_name VARCHAR(100)) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{DATA}/people.csv';\n"
        "SELECT id, first_name FROM people WHERE id > 1;",
        tmp_path,
    )
    assert lines.count("Executing query ...") == 2
    assert not any(line.startswith("Error") for line in lines)
    data_lines = _strip_timing(lines)[2:]
    assert data_lines and all("\t" in line for line in data_lines)


def test_error_does_not_kill_console(tmp_path):
    lines = _run("SELECT * FROM nonexistent;\nSELECT 1 + 1;", tmp_path)
    assert any(line.startswith("Error:") for line in lines)
    assert _strip_timing(lines)[-1] == "2"


def test_multiline_statement_accumulates(tmp_path):
    lines = _run(
        "CREATE EXTERNAL TABLE people (id INT, first_name VARCHAR(100))\n"
        "STORED AS CSV WITH HEADER ROW\n"
        f"LOCATION '{DATA}/people.csv';\n"
        "SELECT COUNT(1)\nFROM people;",
        tmp_path,
    )
    assert lines.count("Executing query ...") == 2
    assert not any(line.startswith("Error") for line in lines)


def test_semicolon_inside_string_literal(tmp_path):
    dst = tmp_path / "people;v2.csv"
    shutil.copy(os.path.join(DATA, "people.csv"), dst)
    lines = _run(
        "CREATE EXTERNAL TABLE people (id INT, first_name VARCHAR(100)) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{dst}';\n"
        "SELECT COUNT(1) FROM people;\n",
        tmp_path,
    )
    assert lines.count("Executing query ...") == 2
    assert not any(line.startswith("Error") for line in lines)


def test_escaped_quote_in_literal():
    stmts, rest = split_statements_partial("SELECT 'it''s;ok'; SELECT 2")
    assert stmts == ["SELECT 'it''s;ok'"]
    assert rest == " SELECT 2"


@pytest.mark.parametrize("text,want_stmts,want_rest", [
    ("-- don't trip on this\nSELECT 1;\nSELECT 2;\n", ["SELECT 1", "SELECT 2"], "\n"),
    ("SELECT 1; -- note", ["SELECT 1"], " -- note"),
    ("SELECT 1; /* note", ["SELECT 1"], " /* note"),
])
def test_comments_in_statement_splitting(text, want_stmts, want_rest):
    assert split_statements_partial(text) == (want_stmts, want_rest)
    assert split_statements("SELECT /* a;b */ 1;") == ["SELECT  1"]


def test_script_trailing_comment_no_error(tmp_path):
    lines = _run("SELECT 1 + 1;\n-- trailing comment\n", tmp_path)
    assert lines.count("Executing query ...") == 1
    assert not any(line.startswith("Error") for line in lines)


def test_timing_toggle_and_output(tmp_path):
    out = io.StringIO()
    csv = tmp_path / "t.csv"
    csv.write_text("a,b\n1,2.5\n3,4.5\n")
    c = Console(make_context("cpu"), out=out)
    c.execute("\\timing")
    c.execute(f"CREATE EXTERNAL TABLE t (a INT, b DOUBLE) STORED AS CSV "
              f"WITH HEADER ROW LOCATION '{csv}'")
    c.execute("SELECT a, b FROM t WHERE a > 0")
    text = out.getvalue()
    assert "Timing is on." in text
    assert "Timing: " in text and "parse=" in text and "verify=" in text
    assert "Counters: " in text and "queries_admitted=1" in text
    c.execute("\\timing")
    assert "Timing is off." in out.getvalue()


def test_timing_as_bare_script_line(tmp_path):
    csv = tmp_path / "t.csv"
    csv.write_text("a\n1\n")
    lines = _run(
        "\\timing\n"
        f"CREATE EXTERNAL TABLE t (a INT) STORED AS CSV WITH HEADER ROW LOCATION '{csv}';\n"
        "SELECT a FROM t;\n",
        tmp_path,
    )
    text = "\n".join(lines)
    assert "Timing is on." in text and "Timing: " in text
    assert "Error" not in text


@pytest.mark.parametrize("command", ["\\cluster"])
def test_unported_command_prints_an_error_and_the_console_survives(tmp_path, monkeypatch,
                                                                     command):
    """`\\cluster` against a cluster service that does not answer: it
    reports the error, as the JAX console does, and the console carries
    on (with no service configured it says cluster mode is off)."""
    lines = _run(f"{command}\nSELECT 2 + 3;\n", tmp_path)
    assert lines[0].startswith("Cluster mode is off")
    monkeypatch.setenv("DATAFUSION_TPU_CLUSTER", "127.0.0.1:1")
    lines = _run(f"{command}\nSELECT 2 + 3;\n", tmp_path)
    assert lines[0].startswith("Cluster service unreachable: ")
    assert _strip_timing(lines)[-1] == "5"


@pytest.mark.parametrize("command,first", [
    ("\\cache", "Result cache: 0 entries"),
    ("\\ingest", "Ingest rev 0, no WAL (in-memory)"),
    ("\\append t {}", "Append failed: no datasource registered as 't'"),
    ("\\cost", "Cost store: "),
    ("\\top", "fleet: 1 node(s) [local]"),
])
def test_ported_command_prints_its_report_and_the_console_survives(tmp_path, command, first):
    """The console commands of the freshness plane (\\cache, \\ingest,
    \\append), the cost store's (\\cost) and the telemetry view
    (\\top), once unported, now answer as the JAX package's do."""
    lines = _run(f"{command}\nSELECT 2 + 3;\n", tmp_path)
    assert lines[0].startswith(first), lines
    assert _strip_timing(lines)[-1] == "5"


def test_interactive_quit(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch.cli", "--device", "cpu"],
        input="SELECT 1 +\n2;\n\\hbm\nquit\n",
        capture_output=True, text=True, timeout=300, env=_env(tmp_path), cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Executing query ..." in proc.stdout and "\n3\n" in proc.stdout
    assert "Device ledger: " in proc.stdout  # \\hbm's report


@pytest.mark.parametrize("argv,want", [
    ([], "no CUDA device"),
    (["top", "--cluster", "127.0.0.1:1"], "no CUDA device"),
])
def test_without_a_card_or_a_plane_the_console_exits_non_zero(tmp_path, argv, want):
    if argv == [] and __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present: the console would run on it")
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch.cli", *argv],
        input="quit\n", capture_output=True, text=True, timeout=300,
        env=_env(tmp_path), cwd=REPO,
    )
    assert proc.returncode == 1
    assert want in proc.stdout + proc.stderr
    assert "DataFusion Console" not in proc.stdout


# --------------------------------------------- text against the JAX console

TEXT_SCRIPTS = {
    "float32_and_ints": (
        f"CREATE EXTERNAL TABLE a (c_int INT, c_float FLOAT, c_string VARCHAR) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{DATA}/all_types.csv';\n"
        "SELECT c_int, c_float, c_string FROM a;\n"
        "SELECT c_float * 2, c_int + 1 FROM a WHERE c_float > 1.5;\n"
        "SELECT SUM(c_float), MIN(c_float), MAX(c_int), COUNT(1) FROM a;\n"
        "SELECT c_string, c_float FROM a ORDER BY c_float DESC;\n"
    ),
    "nulls": (
        f"CREATE EXTERNAL TABLE n (c_int INT, c_float FLOAT, c_string VARCHAR, c_bool BOOLEAN) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{DATA}/null_test.csv';\n"
        "SELECT c_int, c_float, c_string, c_bool FROM n;\n"
        "SELECT c_bool, COUNT(1), SUM(c_float), MIN(c_int) FROM n GROUP BY c_bool;\n"
        "SELECT c_int FROM n WHERE c_float IS NULL OR c_string IS NULL;\n"
        "SELECT c_int, c_float + 1 FROM n ORDER BY c_int LIMIT 3;\n"
    ),
    "explain_and_errors": (
        f"CREATE EXTERNAL TABLE uk (city VARCHAR(100), lat DOUBLE, lng DOUBLE) "
        f"STORED AS CSV WITHOUT HEADER ROW LOCATION '{DATA}/uk_cities.csv';\n"
        "EXPLAIN SELECT city, lat + lng FROM uk WHERE lat > 51.0 AND lat < 53;\n"
        "EXPLAIN VERIFY SELECT city, MIN(lat), COUNT(1) FROM uk GROUP BY city;\n"
        "EXPLAIN VERIFY SELECT city FROM uk WHERE city < city;\n"
        "SELECT city, COUNT(1) FROM uk GROUP BY lat % 3;\n"
        "SELECT city FROM nowhere;\n"
        "SELECT city, lat FROM uk WHERE lat > 57 ORDER BY lat;\n"
    ),
}


@pytest.mark.parametrize("name", sorted(TEXT_SCRIPTS))
def test_console_text_equals_the_jax_console(tmp_path, name):
    sql = TEXT_SCRIPTS[name]
    port = _strip_timing(_run(sql, tmp_path))
    jax = _strip_timing(_run(sql, tmp_path, jax=True))
    assert port == jax
    assert len(port) > sql.count(";")
