"""PyTorch/CUDA port, slice 8: the staged prefetch pipeline
(`datafusion_tpu_torch/exec/prefetch.py`), after tests/test_prefetch.py.

The pipeline runs on a CUDA device over a CSV scan;
DATAFUSION_TPU_PREFETCH=1 forces it on, so these tests run the staged
path on the CPU: staged
results equal serial ones and the JAX package's (ints, strings and
order exactly, f64 within rtol 1e-9), the knob, a source exception and
a stage exception re-raised in the consumer, a producer that stops when
its consumer walks away, order kept, and an aggregate whose capacity
crosses `agg_max_groups()`, whose f64 results are the same bits in five
staged runs and in a serial one.  The dictionary versions pinned as
batches leave their source make a staged scan over a growing CSV
dictionary build the serial scan's tables, and a streaming TopK on a
Utf8 key ranks each merge at one prefix of a dictionary that grows
while it merges.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.errors import IoError
from datafusion_tpu_torch.exec.aggregate import AggregateRelation
from datafusion_tpu_torch.exec.batch import pin_dict_versions
from datafusion_tpu_torch.exec.datasource import DataSource
from datafusion_tpu_torch.exec.prefetch import (
    pipeline_enabled,
    staged_pipeline,
    staged_prefetch,
)

from test_torch_fold import _csv_contexts, _growing_csv, agg_table
from test_torch_pipeline import T, assert_same, carry, contexts, jax_collect, jax_table

KNOB = "DATAFUSION_TPU_PREFETCH"
SQLS = [
    "SELECT k, SUM(v), AVG(v), MIN(s), MAX(i), COUNT(1) FROM t GROUP BY k",
    "SELECT k, v * 2, s FROM t WHERE v > 50.0 AND s > 'cedar'",
    "SELECT k, SUM(v) FROM t WHERE s >= 'elm' GROUP BY k",
    "SELECT v, tag FROM t WHERE k < 100 ORDER BY v DESC LIMIT 700",
]


def _staged_threads():
    return [t for t in threading.enumerate() if t.name == "df-torch-prefetch"]


@pytest.mark.parametrize("sql", SQLS)
def test_staged_matches_serial_and_the_jax_package(monkeypatch, sql):
    src = agg_table(n=15_000, seed=61)
    jctx, tctx = contexts(src)
    want = jax_collect(jctx.sql(sql))
    ordered = "ORDER BY" in sql
    monkeypatch.setenv(KNOB, "0")
    serial = tdf.collect(tctx.sql(sql))
    monkeypatch.setenv(KNOB, "1")
    staged = tdf.collect(tctx.sql(sql))
    assert assert_same(staged, want, ordered) == assert_same(serial, want, ordered)


def test_pipeline_enabled_knob(monkeypatch, tmp_path):
    from datafusion_tpu_torch.exec.relation import DataSourceRelation

    _growing_csv(tmp_path / "grow.csv")
    _, tctx = _csv_contexts(tmp_path / "grow.csv")
    csv_scan = DataSourceRelation(tctx.datasources["t"])
    memory_scan = DataSourceRelation(carry(agg_table(n=1000, seed=60)))
    cuda, cpu = torch.device("cuda:0"), torch.device("cpu")
    monkeypatch.delenv(KNOB, raising=False)
    assert pipeline_enabled(cuda, csv_scan) is True
    assert pipeline_enabled(cuda, memory_scan) is False
    assert pipeline_enabled(cpu, csv_scan) is False
    assert pipeline_enabled(cuda, object()) is False  # not a scan
    monkeypatch.setenv(KNOB, "1")
    assert pipeline_enabled(cpu, memory_scan) is True
    monkeypatch.setenv(KNOB, "0")
    assert pipeline_enabled(cuda, csv_scan) is False


def test_staging_runs_on_its_threads_only_when_enabled(monkeypatch):
    threads = []
    real = AggregateRelation._stage

    def spy(self, batch):
        threads.append(threading.current_thread().name)
        return real(self, batch)

    monkeypatch.setattr(AggregateRelation, "_stage", spy)
    _, tctx = contexts(agg_table(n=9000, seed=62))
    monkeypatch.setenv(KNOB, "0")
    tdf.collect(tctx.sql(SQLS[0]))
    assert threads == []
    monkeypatch.setenv(KNOB, "1")
    tdf.collect(tctx.sql(SQLS[0]))
    assert threads == ["df-torch-prefetch"] * 5


class _Exploding(DataSource):
    """A source whose scan raises after `after` batches."""

    def __init__(self, inner, after):
        self._inner = inner
        self._after = after

    @property
    def schema(self):
        return self._inner.schema

    def batches(self):
        for i, b in enumerate(self._inner.batches()):
            if i == self._after:
                raise IoError("disk vanished mid-scan")
            yield b

    def with_projection(self, projection):
        return _Exploding(self._inner.with_projection(projection), self._after)


@pytest.mark.parametrize("sql", SQLS[:2])
def test_source_exception_propagates(monkeypatch, sql):
    monkeypatch.setenv(KNOB, "1")
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", _Exploding(carry(agg_table(n=9000, seed=63)), 2))
    with pytest.raises(IoError, match="disk vanished"):
        tdf.collect(ctx.sql(sql))


def test_stage_exception_propagates(monkeypatch):
    def bad_stage(self, batch):
        raise ValueError("stage blew up")

    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setattr(AggregateRelation, "_stage", bad_stage)
    _, tctx = contexts(agg_table(n=9000, seed=64))
    with pytest.raises(ValueError, match="stage blew up"):
        tdf.collect(tctx.sql(SQLS[0]))
    with pytest.raises(ValueError, match="stage blew up"):
        list(staged_prefetch(iter([1, 2, 3]), stage=lambda b: bad_stage(None, b)))


def test_early_abandonment_stops_the_producer():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = staged_prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()  # the consumer walks away; the producer must not run on
    time.sleep(0.3)
    assert len(produced) < 100


@pytest.mark.parametrize("two_threads", [False, True])
def test_abandoning_waits_for_the_producer(two_threads):
    """Closing the generator returns only once the producer has left: a
    stage it was in has ended and no staged thread is alive, so nothing
    of the scan runs on into the next query."""
    events = []

    def slow_stage(x):
        events.append(("start", x))
        time.sleep(0.1)
        events.append(("end", x))

    if two_threads:
        it = staged_pipeline(iter(range(50)), slow_stage, pull=lambda x: None)
    else:
        it = staged_prefetch(iter(range(50)), stage=slow_stage)
    assert next(it) == 0
    it.close()
    starts = [x for e, x in events if e == "start"]
    ends = [x for e, x in events if e == "end"]
    assert starts == ends and len(starts) < 50
    assert not _staged_threads()


def test_limit_closes_a_staged_scan_early(monkeypatch):
    """A LIMIT over a staged pipeline stops pulling: the source is
    closed on its thread and not read to its end."""
    pulled = []
    closed = threading.Event()

    class Counting(DataSource):
        def __init__(self, inner):
            self._inner = inner

        @property
        def schema(self):
            return self._inner.schema

        def batches(self):
            try:
                for b in self._inner.batches():
                    pulled.append(b)
                    yield b
            finally:
                closed.set()

        def with_projection(self, projection):
            return Counting(self._inner.with_projection(projection))

    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_PIPELINE", "1")
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", Counting(carry(agg_table(n=60 * 512, seed=65,
                                                          batch_rows=512))))
    rows = tdf.collect(ctx.sql("SELECT k, v * 2 FROM t WHERE v > 0 LIMIT 10"))
    assert rows.num_rows == 10
    assert closed.wait(5) and len(pulled) < 60
    deadline = time.time() + 5
    while _staged_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _staged_threads()


def test_order_preserved():
    assert list(staged_prefetch(iter(range(57)), stage=lambda x: None)) == list(range(57))
    seen = []
    out = list(staged_pipeline(iter(range(33)), seen.append, pull=lambda x: None))
    assert out == seen == list(range(33))


def test_crossing_the_threshold_gives_the_same_bits_in_five_runs(monkeypatch):
    # ascending keys at two batches a fold: the first chunks take the
    # grouped reduce, later ones sort-merge; the capacity is sized from
    # the group counts recorded at each encode, never from an encoder
    # that the staging thread has already run ahead with
    monkeypatch.setenv("DATAFUSION_TPU_PALLAS_AGG_GROUPS", "256")
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", "2")
    rng = np.random.default_rng(66)
    n = 16_384
    src = jax_table([("k", T.INT64, False), ("v", T.FLOAT64, False)],
                    [np.sort(rng.integers(0, 2000, n)), rng.normal(size=n) * 1e3],
                    batch_rows=1024)
    sql = "SELECT k, SUM(v), AVG(v), MIN(v) FROM t GROUP BY k"
    jctx, tctx = contexts(src)
    monkeypatch.setenv(KNOB, "0")
    serial = tdf.collect(tctx.sql(sql))
    monkeypatch.setenv(KNOB, "1")
    runs = [tdf.collect(tctx.sql(sql)) for _ in range(5)]
    for t in runs:
        for i in (1, 2, 3):
            assert np.array_equal(np.asarray(t.columns[i]).view(np.int64),
                                  np.asarray(serial.columns[i]).view(np.int64))
    assert_same(runs[0], jax_collect(jctx.sql(sql)), ordered=False)


def test_pinned_versions_are_the_serial_scan_versions(tmp_path):
    versions = _growing_csv(tmp_path / "grow.csv")
    _, tctx = _csv_contexts(tmp_path / "grow.csv")
    source = tctx.datasources["t"]

    def slow(batch):
        time.sleep(0.02)  # the reader runs ahead while a batch stages

    staged = [b.cache["dict_versions"] for b in staged_pipeline(
        source.batches(), slow, pull=pin_dict_versions)]
    assert [v[1] for v in staged] == versions


def test_staged_scan_of_a_growing_dictionary_matches_serial_bits(tmp_path, monkeypatch):
    """A string compare and a string MIN over a CSV whose dictionary
    grows while the reader runs ahead: five staged runs give the serial
    run's f64 bits and the JAX package's rows.  Each run reads the file
    with a reader of its own (a reader keeps its dictionaries across
    scans, so a second scan would see them grown from the start)."""
    _growing_csv(tmp_path / "grow.csv")
    sql = "SELECT k, MIN(s), SUM(v) FROM t WHERE s > 'w05' GROUP BY k"

    def run():
        return tdf.collect(_csv_contexts(tmp_path / "grow.csv")[1].sql(sql))

    monkeypatch.setenv(KNOB, "0")
    serial = run()
    monkeypatch.setenv(KNOB, "1")
    for _ in range(5):
        staged = run()
        assert np.array_equal(np.asarray(staged.columns[2]).view(np.int64),
                              np.asarray(serial.columns[2]).view(np.int64))
    jctx, _ = _csv_contexts(tmp_path / "grow.csv")
    assert_same(staged, jax_collect(jctx.sql(sql)), ordered=False)


def test_pins_carry_through_a_staged_pipeline_and_a_join(tmp_path, monkeypatch):
    """The pipeline and the join hand the reader's pinned versions on
    with the columns they pass through, though the reader runs ahead of
    a slow stage."""
    from datafusion_tpu_torch.exec.batch import dict_versions
    from datafusion_tpu_torch.exec.relation import PipelineRelation

    versions = _growing_csv(tmp_path / "grow.csv")
    real = PipelineRelation._stage

    def slow(self, batch):
        time.sleep(0.02)
        return real(self, batch)

    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setattr(PipelineRelation, "_stage", slow)
    _, tctx = _csv_contexts(tmp_path / "grow.csv")
    names = tdf.StringDictionary()
    D = tdf.DataType
    dim = tdf.Schema([tdf.Field("dk", D.INT64, False), tdf.Field("name", D.UTF8, False)])
    tctx.register_datasource("d", tdf.MemoryDataSource(dim, [tdf.make_host_batch(
        dim, [np.arange(40), names.encode([f"n{i}" for i in range(40)])], None,
        [None, names])]))
    for sql in ("SELECT s, v + 1 FROM t WHERE v > -100",
                "SELECT s, k, name FROM t JOIN d ON t.k = d.dk"):
        got = [dict_versions(b)[0] for b in tctx.sql(sql).batches()]
        assert got == versions, sql


def _shuffled_words_csv(path, seed=67, batches=8, batch_rows=512):
    """A CSV whose Utf8 column brings new strings in every batch, drawn
    at random, so each growth of the reader's dictionary ranks new
    strings before, between and after the ones it holds."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghij"))
    words, lines = [], ["k,s,v"]
    for _ in range(batches):
        fresh = ["".join(rng.choice(letters, 3)) for _ in range(12)]
        words += fresh
        picks = fresh + [words[j] for j in rng.integers(0, len(words),
                                                        batch_rows - len(fresh))]
        for w in picks:
            lines.append(f"{rng.integers(0, 6)},{w},{rng.normal() * 10:.6f}")
    path.write_text("\n".join(lines) + "\n")


TOPK_STR_SQLS = [
    "SELECT s, k, v * 2 FROM t WHERE v > -15.0 ORDER BY s DESC, k LIMIT 300",
    "SELECT s, v + 1 FROM t ORDER BY s LIMIT 40",
]


@pytest.mark.parametrize("fuse_group", ["1", "3"])
@pytest.mark.parametrize("sql", TOPK_STR_SQLS)
def test_topk_on_a_string_key_over_a_staged_growing_csv(tmp_path, monkeypatch,
                                                        fuse_group, sql):
    """A TopK on a Utf8 key above a computed projection (so its child is
    a staged pipeline) over a CSV whose dictionary grows in every batch,
    merging while the reader runs ahead: rows and order equal the JAX
    package's, run after run."""
    _shuffled_words_csv(tmp_path / "w.csv")
    jctx, _ = _csv_contexts(tmp_path / "w.csv", batch_size=512)
    want = jax_collect(jctx.sql(sql))
    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", fuse_group)
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_PIPELINE", "1")
    for _ in range(3):
        _, tctx = _csv_contexts(tmp_path / "w.csv", batch_size=512)
        assert_same(tdf.collect(tctx.sql(sql)), want, ordered=True)


@pytest.mark.parametrize("fuse_group", ["1", "2"])
@pytest.mark.parametrize("sql", TOPK_STR_SQLS)
def test_topk_ranks_one_prefix_while_the_dictionary_grows(tmp_path, monkeypatch,
                                                          fuse_group, sql):
    """The race made certain: every read of a dictionary's ranks appends
    a string that sorts before all others, as a reader running ahead on
    another thread may.  A merge that read ranks twice (the state's
    rebuild, then each batch) would rank one string two ways; one prefix
    a merge keeps the JAX package's rows and order."""
    from datafusion_tpu_torch.exec.batch import StringDictionary

    _shuffled_words_csv(tmp_path / "w.csv")
    jctx, tctx = _csv_contexts(tmp_path / "w.csv", batch_size=512)
    want = jax_collect(jctx.sql(sql))
    real = StringDictionary.sort_ranks
    grown = []

    def racing(self, n=None):
        ranks = real(self, n)
        grown.append(self.add(f"!{len(grown):05d}"))
        return ranks

    monkeypatch.setattr(StringDictionary, "sort_ranks", racing)
    monkeypatch.setenv("DATAFUSION_TPU_FUSE_GROUP", fuse_group)
    assert_same(tdf.collect(tctx.sql(sql)), want, ordered=True)
    assert grown
