"""PyTorch/CUDA port, slice 10: tables registered by CREATE EXTERNAL
TABLE (CSV with and without a header, NDJSON, Parquet), the port's
NDJSON and Parquet readers (`io/readers.py`) and the pyarrow
confinement threads (`io/io_thread.py`), against the JAX package.

The same DDL and queries run through `ctx.sql_collect` in both
packages on the CPU: ints, strings, NULLs and order exactly, floats
within rtol 1e-9.  The port reads Parquet with its own native reader
(`native/parquet.py`), so with pyarrow blocked, as on the card's
machine, a Parquet fixture still registers and gives its CSV twin's
rows (the JAX package's side of these Parquet cases needs pyarrow, and
they skip without it).  The io-thread cases are those of the JAX
package's `tests/test_io_thread.py`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import datafusion_tpu as jdf

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.io.io_thread import _POOL, confined_iter, run_on_io_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")


def _ctxs():
    return (jdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4),
            tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4))


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a is not None and np.isclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True), (g, w)
            else:
                assert a == b, (g, w)


def _run(ddl, queries):
    jctx, tctx = _ctxs()
    assert repr(tctx.sql(ddl)) == repr(jctx.sql(ddl))
    for sql in queries:
        _same_rows(tctx.sql_collect(sql).to_rows(), jctx.sql_collect(sql).to_rows())
    return tctx


UK = "(city VARCHAR(100), lat DOUBLE, lng DOUBLE)"
CASES = {
    "csv_without_header": (
        f"CREATE EXTERNAL TABLE t {UK} STORED AS CSV WITHOUT HEADER ROW "
        f"LOCATION '{DATA}/uk_cities.csv'",
        ["SELECT city, lat, lng FROM t",
         "SELECT city, lat + lng FROM t WHERE lat > 51.0 AND lat < 53",
         "SELECT MIN(lat), MAX(lng), COUNT(1) FROM t"]),
    "csv_with_header": (
        "CREATE EXTERNAL TABLE t (c_int INT, c_float FLOAT, c_string VARCHAR, c_bool BOOLEAN) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{DATA}/null_test.csv'",
        ["SELECT c_int, c_float, c_string, c_bool FROM t",
         "SELECT c_bool, COUNT(1), SUM(c_int) FROM t GROUP BY c_bool",
         "SELECT c_string, c_int FROM t WHERE c_int > 1 ORDER BY c_int DESC"]),
    "ndjson": (
        "CREATE EXTERNAL TABLE t (a BIGINT, b VARCHAR, c DOUBLE) STORED AS NDJSON "
        f"LOCATION '{DATA}/example1.ndjson'",
        ["SELECT a, b, c FROM t",
         "SELECT b, SUM(c), COUNT(1) FROM t GROUP BY b",
         "SELECT a, c * 2 FROM t WHERE a >= 2 ORDER BY c"]),
    "ndjson_missing_keys": (
        "CREATE EXTERNAL TABLE t (a BIGINT, b VARCHAR, z INT) STORED AS NDJSON "
        f"LOCATION '{DATA}/example1.ndjson'",
        ["SELECT a, b, z FROM t", "SELECT COUNT(1), MAX(a) FROM t WHERE z IS NULL"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ddl_tables_give_the_jax_packages_rows(case):
    ddl, queries = CASES[case]
    _run(ddl, queries)


def test_ndjson_rows_equal_a_parse_of_the_file():
    tctx = _run(*CASES["ndjson"])
    with open(os.path.join(DATA, "example1.ndjson")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    got = tctx.sql_collect("SELECT a, b, c FROM t").to_rows()
    assert got == [(r["a"], r["b"], r["c"]) for r in rows]
    src = tctx.datasources["t"]
    assert isinstance(src, tdf.NdJsonDataSource) and src.parses
    assert src.estimated_bytes() == os.path.getsize(os.path.join(DATA, "example1.ndjson"))
    assert src.with_projection([1]).schema.names() == ["b"]


def test_ndjson_bad_line_raises_io_error(tmp_path):
    path = tmp_path / "bad.ndjson"
    path.write_text('{"a": 1}\n{"a": \n')
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_ndjson("t", str(path), tdf.Schema([tdf.Field("a", tdf.DataType.INT64)]))
    with pytest.raises(tdf.IoError, match="bad NDJSON line"):
        ctx.sql_collect("SELECT a FROM t")


def test_file_identity_follows_the_file(tmp_path):
    path = tmp_path / "t.ndjson"
    path.write_text('{"a": 1}\n')
    schema = tdf.Schema([tdf.Field("a", tdf.DataType.INT64)])
    src = tdf.NdJsonDataSource(str(path), schema)
    before = src.data_identity
    assert str(path) in before and before == src.data_identity
    path.write_text('{"a": 1}\n{"a": 2}\n')
    assert src.data_identity != before


def test_ddl_without_columns_needs_parquet():
    _, tctx = _ctxs()
    with pytest.raises(tdf.PlanError, match="requires an explicit column list"):
        tctx.sql(f"CREATE EXTERNAL TABLE t STORED AS NDJSON LOCATION '{DATA}/example1.ndjson'")


# ------------------------------------------------------------ Parquet

PARQUET_FIXTURES = ["alltypes_plain", "all_types_flat", "uk_cities"]


@pytest.mark.parametrize("name", PARQUET_FIXTURES)
def test_infer_parquet_schema_equals_the_jax_package(name):
    pytest.importorskip("pyarrow")
    from datafusion_tpu.io.readers import infer_parquet_schema as jax_infer

    from datafusion_tpu_torch.io.readers import infer_parquet_schema

    path = os.path.join(DATA, f"{name}.parquet")
    try:
        want = jax_infer(path).to_json()
    except jdf.ExecutionError as e:
        with pytest.raises(tdf.ExecutionError) as ei:
            infer_parquet_schema(path)
        assert str(ei.value) == str(e)
        return
    assert infer_parquet_schema(path).to_json() == want


PARQUET_CASES = {
    "inferred_uk_cities": (
        f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION '{DATA}/uk_cities.parquet'",
        ["SELECT city, lat, lng FROM t", "SELECT COUNT(1), MIN(lat) FROM t WHERE lng < 0"]),
    "inferred_all_types_flat": (
        f"CREATE EXTERNAL TABLE t STORED AS PARQUET LOCATION '{DATA}/all_types_flat.parquet'",
        ["SELECT * FROM t", "SELECT c_bool, SUM(c_int64), MAX(c_float32) FROM t GROUP BY c_bool",
         "SELECT c_utf8, c_int32 FROM t ORDER BY c_int32 LIMIT 5"]),
    "declared_alltypes_plain": (
        "CREATE EXTERNAL TABLE t (id INT, bool_col BOOLEAN, int_col INT, bigint_col BIGINT, "
        "float_col FLOAT, double_col DOUBLE, string_col VARCHAR) STORED AS PARQUET "
        f"LOCATION '{DATA}/alltypes_plain.parquet'",
        ["SELECT id, bool_col, int_col, bigint_col, float_col, double_col, string_col FROM t",
         "SELECT string_col, SUM(double_col) FROM t GROUP BY string_col"]),
}


@pytest.mark.parametrize("case", sorted(PARQUET_CASES))
def test_parquet_tables_give_the_jax_packages_rows(case):
    pytest.importorskip("pyarrow")
    ddl, queries = PARQUET_CASES[case]
    tctx = _run(ddl, queries)
    assert isinstance(tctx.datasources["t"], tdf.ParquetDataSource)


def test_parquet_without_pyarrow_reads_the_fixture():
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pyarrow.parquet'] = None\n"
        "import datafusion_tpu_torch as t\n"
        "ctx = t.ExecutionContext(device='cpu', result_cache=False)\n"
        f"ctx.sql(\"CREATE EXTERNAL TABLE p STORED AS PARQUET LOCATION "
        f"'{DATA}/uk_cities.parquet'\")\n"
        "ctx.register_csv('c', "
        f"'{DATA}/uk_cities.csv', ctx.datasources['p'].schema, has_header=False)\n"
        "got = ctx.sql_collect('SELECT city, lat, lng FROM p').to_rows()\n"
        "want = ctx.sql_collect('SELECT city, lat, lng FROM c').to_rows()\n"
        "assert 'pyarrow' not in {m.split('.')[0] for m, v in sys.modules.items() if v}\n"
        "print(len(got), got == want)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["37", "True"]


# ------------------------------------------------------------ io threads


def test_runs_off_caller_thread():
    seen = {}

    def probe():
        seen["thread"] = threading.current_thread().name
        return 41 + 1

    assert run_on_io_thread(probe) == 42
    assert seen["thread"].startswith("df-tpu-io")
    assert seen["thread"] != threading.current_thread().name


def test_exceptions_propagate():
    with pytest.raises(ValueError, match="boom"):
        run_on_io_thread(lambda: (_ for _ in ()).throw(ValueError("boom")))


def test_reentrant_submit_runs_inline():
    def outer():
        return run_on_io_thread(lambda: threading.current_thread().name)

    assert _POOL[0].submit(outer).startswith("df-tpu-io")


def test_confined_iter_yields_in_order_on_one_pool_thread():
    names = []

    def gen():
        for i in range(5):
            names.append(threading.current_thread().name)
            yield i

    assert list(confined_iter(gen())) == [0, 1, 2, 3, 4]
    assert all(n.startswith("df-tpu-io") for n in names)
    assert len(set(names)) == 1


def test_confined_iter_exception_mid_stream():
    def gen():
        yield 1
        raise RuntimeError("mid-stream")

    it = confined_iter(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="mid-stream"):
        next(it)


def test_abandoned_iterator_closes_generator():
    closed = threading.Event()

    def gen():
        try:
            while True:
                yield 0
        finally:
            closed.set()

    it = confined_iter(gen())
    assert next(it) == 0
    it.close()
    assert closed.wait(timeout=10), "generator finally never ran"


def test_many_concurrent_scans_from_fresh_threads():
    out = []
    lock = threading.Lock()

    def scan(tag):
        def gen():
            for i in range(50):
                yield (tag, i)

        got = list(confined_iter(gen()))
        with lock:
            out.append((tag, got == [(tag, i) for i in range(50)]))

    threads = [threading.Thread(target=scan, args=(t,)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(out) == 16 and all(ok for _, ok in out)
