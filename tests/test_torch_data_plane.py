"""PyTorch/CUDA port, slice 15: the data plane against the JAX package.

- One packed device-to-host copy (`batch.device_pull`) over bool,
  uint8, int32, int64 (a 2-D one too) and f64 tensors.
- Compaction (`materialize.compact_batch`) against the JAX package's
  `compact_batch` at selectivities on both sides of `_COMPACT_FACTOR`,
  with the bit-packed mask pull.
- The full sort's runs on the device, with NaN and mixed signed zeros,
  giving the JAX package's rows; the run-permutation cache's
  second-chance admission and its warm hit.
- The TopK's key operands built on the device (`_device_ops`) equal to
  the ones `_host_keys` builds on the host, and its Utf8 rank tables
  read anew on every run.

Inputs come from numpy seeds; `DATAFUSION_TPU_WIRE=always` runs the
codec and the link's paths on the CPU in both packages where a case
needs them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as jdf
from datafusion_tpu.exec import materialize as JM
from datafusion_tpu.exec.batch import RecordBatch as JaxBatch
from datafusion_tpu.exec.materialize import collect as jax_collect
from datafusion_tpu.utils.metrics import METRICS as JMETRICS

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import batch as TB
from datafusion_tpu_torch.exec import materialize as TM
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.exec.sort import SortRelation
from datafusion_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import contexts, jax_table

T = jdf.DataType
CPU = torch.device("cpu")


def _count(metrics, name):
    return metrics.snapshot()["counts"].get(name, 0)


@pytest.fixture(autouse=True)
def _fresh_cost_store():
    from datafusion_tpu_torch import cost

    cost.reset_store()
    yield
    cost.reset_store()


# ---------------------------------------------------------------- D2H


@pytest.mark.parametrize("wire", ["always", "auto"])
def test_pending_pull_brings_back_every_tensor(monkeypatch, wire):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    rng = np.random.default_rng(31)
    leaves = [
        rng.random(1001) > 0.5,
        rng.integers(0, 255, 999).astype(np.uint8),
        rng.integers(-(2**31), 2**31 - 1, 777).astype(np.int32),
        rng.integers(-(2**62), 2**62, 513).astype(np.int64),
        np.concatenate([rng.standard_normal(500), [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324]]),
    ]
    tensors = [torch.from_numpy(a.copy()) for a in leaves]
    tensors[3] = tensors[3].reshape(27, 19)  # a 2-D leaf keeps its shape
    before = METRICS.snapshot()["counts"]
    got = TB.device_pull(tensors)
    after = METRICS.snapshot()["counts"]
    # across the link all five leaves cross in one copy
    assert (after["device.d2h.transfers"] - before.get("device.d2h.transfers", 0)
            == (1 if wire == "always" else len(leaves)))
    assert got[3].shape == (27, 19)
    got[3] = got[3].reshape(-1)
    for want, g in zip(leaves, got):
        assert g.dtype == want.dtype
        assert np.array_equal(g.view(np.uint8) if g.dtype != np.bool_ else g,
                              want.view(np.uint8) if want.dtype != np.bool_ else want)
    assert after["d2h.bytes"] - before.get("d2h.bytes", 0) == sum(a.nbytes for a in leaves)
    assert TB.device_pull((torch.arange(3),))[0].tolist() == [0, 1, 2]
    assert TB.device_pull([]) == []


# ---------------------------------------------------------- compaction


def _pair(live_share, seed):
    """The same batch in both packages: device columns (an int64, an
    f64 with validity, a uint8) and a device selection mask."""
    rng = np.random.default_rng(seed)
    cap, n = 4096, 4000
    i64 = rng.integers(-(2**40), 2**40, cap).astype(np.int64)
    f64 = rng.standard_normal(cap)
    u8 = rng.integers(0, 255, cap).astype(np.uint8)
    valid = rng.random(cap) > 0.2
    mask = rng.random(cap) < live_share
    jschema = jdf.Schema([jdf.Field("a", T.INT64, False), jdf.Field("b", T.FLOAT64, True),
                          jdf.Field("c", T.UINT8, False)])
    jb = JaxBatch(jschema, [jnp.asarray(i64), jnp.asarray(f64), jnp.asarray(u8)],
                  [None, jnp.asarray(valid), None], [None] * 3, num_rows=n,
                  mask=jnp.asarray(mask))
    tschema = tdf.Schema([tdf.Field("a", tdf.DataType.INT64, False),
                          tdf.Field("b", tdf.DataType.FLOAT64, True),
                          tdf.Field("c", tdf.DataType.UINT8, False)])
    tb = TB.RecordBatch(tschema, [torch.from_numpy(i64), torch.from_numpy(f64),
                                  torch.from_numpy(u8)],
                        [None, torch.from_numpy(valid), None], [None] * 3, num_rows=n,
                        mask=torch.from_numpy(mask))
    return jb, tb


@pytest.mark.parametrize("wire", ["always", "auto"])
@pytest.mark.parametrize("live_share", [0.05, 0.3, 0.6, 0.95])
def test_compaction_matches_the_jax_package(monkeypatch, live_share, wire):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    jb, tb = _pair(live_share, seed=int(live_share * 100))
    j0, t0 = _count(JMETRICS, "d2h.compacted_batches"), _count(METRICS, "d2h.compacted_batches")
    jcols, jvalids, _, jn = JM.compact_batch(jb)
    tcols, tvalids, _, tn = TM.compact_batch(tb)
    assert tn == jn
    for a, b in zip(tcols, jcols):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
    assert tvalids[0] is None and tvalids[2] is None
    assert np.array_equal(tvalids[1], np.asarray(jvalids[1]))
    jc = _count(JMETRICS, "d2h.compacted_batches") - j0
    tc = _count(METRICS, "d2h.compacted_batches") - t0
    assert tc == jc == (1 if live_share < 0.5 else 0)


def test_mask_prefetch_packs_the_mask(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    for i, share in enumerate((0.2, 0.7, 0.4)):
        b = _pair(share, seed=i)[1]
        before = _count(METRICS, "d2h.bytes")
        assert np.array_equal(TM._fetch_mask(b), b.mask.numpy())
        assert _count(METRICS, "d2h.bytes") - before == b.capacity // 8
        assert TM._fetch_mask(b) is b.cache["host_mask"]  # cached: no second copy
        assert _count(METRICS, "d2h.bytes") - before == b.capacity // 8


def test_collect_resolves_one_batch_behind(monkeypatch):
    """A pipeline's device outputs, collected in both packages."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    rng = np.random.default_rng(41)
    n = 9000
    src = jax_table([("x", T.INT64, False), ("y", T.FLOAT64, True)],
                    [rng.integers(-1000, 1000, n), np.round(rng.uniform(0, 50, n), 2)],
                    [None, rng.random(n) > 0.1])
    jctx, tctx = contexts(src)
    sql = "SELECT x * 2, y + 1.5 FROM t WHERE x > 900"
    want = jax_collect(jctx.sql(sql))
    got = tdf.collect(tctx.sql(sql))
    assert got.num_rows == want.num_rows > 0
    for a, b in zip(got.columns, want.columns):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert all((a is None) == (b is None) for a, b in zip(got.validity, want.validity))


# ------------------------------------------------------------ run sort


def _sort_table(n, seed, special=None):
    rng = np.random.default_rng(seed)
    f = np.round(rng.uniform(-100, 100, n), 2)
    if special == "nan":
        f[::37] = np.nan
    elif special == "zeros":
        f[::11] = 0.0
        f[5::11] = -0.0
    words = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    return jax_table([("k", T.INT64, False), ("f", T.FLOAT64, False), ("s", T.UTF8, True)],
                     [rng.integers(0, 50, n), f, list(words[rng.integers(0, 40, n)])],
                     [None, None, rng.random(n) > 0.1])


def _sorted_both(src, sql):
    """The port's and the JAX package's rows, and the JAX package's
    host-routed runs."""
    jctx, tctx = contexts(src)
    j0 = _count(JMETRICS, "sort.host_routed_runs")
    want = jax_collect(jctx.sql(sql)).to_rows()
    got = tdf.collect(tctx.sql(sql)).to_rows()
    return got, want, _count(JMETRICS, "sort.host_routed_runs") - j0


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a == b or (isinstance(a, float) and np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("wire", ["always", "auto"])
@pytest.mark.parametrize("special", [None, "nan", "zeros"])
def test_full_sort_matches_the_jax_package(monkeypatch, special, wire):
    """The run sorts on the device in both packages (the JAX package's
    host route needs a slow link, which its default never assumes);
    NaN and zeros of both signs order as the JAX package orders them."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    src = _sort_table(5000, seed=7, special=special)
    got, want, jr = _sorted_both(src, "SELECT k, f, s FROM t ORDER BY f DESC, s, k")
    _same_rows(got, want)
    assert jr == 0


def test_fast_link_sorts_on_the_device(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    got, want, jr = _sorted_both(_sort_table(5000, seed=8),
                                 "SELECT k, f, s FROM t ORDER BY s DESC, k")
    _same_rows(got, want)
    assert jr == 0


def _node(rel, cls):
    while rel is not None and not isinstance(rel, cls):
        rel = getattr(rel, "child", None)
    return rel


@pytest.mark.parametrize("wire,hits", [("always", [0, 0, 1, 1]), ("auto", [0, 0, 0, 0]),
                                       ("never", [0, 0, 0, 0])])
def test_permutation_cache_admits_on_the_second_run(monkeypatch, wire, hits):
    """A run key seen once is remembered; seen twice its permutation is
    stored; the third run skips the sort (no sort launch).  Without a
    link (the CPU but under `always`) nothing is stored."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    src = _sort_table(3000, seed=9)
    jctx, tctx = contexts(src)
    sql = "SELECT k, s FROM t ORDER BY k, s DESC"
    jrel, trel = jctx.sql(sql), tctx.sql(sql)
    want = jax_collect(jrel).to_rows()
    got_hits, jax_hits, launches = [], [], []
    for _ in range(4):
        t0, j0 = _count(METRICS, "sort.perm_cache_hits"), _count(JMETRICS, "sort.perm_cache_hits")
        l0 = _count(METRICS, "device.launches.sort")
        _same_rows(tdf.collect(trel).to_rows(), want)
        jax_collect(jrel)
        got_hits.append(_count(METRICS, "sort.perm_cache_hits") - t0)
        jax_hits.append(_count(JMETRICS, "sort.perm_cache_hits") - j0)
        launches.append(_count(METRICS, "device.launches.sort") - l0)
    assert got_hits == hits
    if wire == "always":
        assert jax_hits[2:] == hits[2:]
    assert launches == [int(h == 0) for h in hits]
    assert len(_node(trel, SortRelation)._run_ops_cache) == (1 if hits[-1] else 0)


# --------------------------------------------------- TopK key operands


def _topk_source(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    f = rng.standard_normal(n) * 10
    f[::13] = 0.0
    f[6::13] = -0.0
    f[3::29] = np.nan
    f[4::31] = 5e-324
    f[5::41] = -2e-310
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[::17] = np.float32(1e-40)
    words = np.array([f"k{i:02d}" for i in range(30)], dtype=object)
    return jax_table(
        [("a", T.INT64, True), ("b", T.FLOAT64, True), ("u", T.UINT64, False),
         ("s", T.UTF8, True), ("g", T.FLOAT32, False), ("w", T.UINT32, False)],
        [rng.integers(-50, 50, n), f, rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2),
         list(words[rng.integers(0, 30, n)]), f32,
         rng.integers(0, 2**32 - 1, n, dtype=np.uint64).astype(np.uint32)],
        [rng.random(n) > 0.1, rng.random(n) > 0.1, None, rng.random(n) > 0.2, None, None],
        batch_rows=1024)


@pytest.mark.parametrize("wire", ["always", "auto"])
@pytest.mark.parametrize("order", [
    "a DESC, b", "b", "b DESC", "b, a DESC", "u DESC, a", "s DESC, u", "g, a", "g DESC",
    "w DESC, s", "s",
])
@pytest.mark.parametrize("where", ["", "WHERE a > -20"])
def test_device_operands_equal_host_operands(monkeypatch, wire, order, where):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    _, tctx = contexts(_topk_source(61))
    rel = _node(tctx.sql(f"SELECT a, b, s FROM t {where} ORDER BY {order} LIMIT 25"),
                SortRelation)
    assert rel._topk
    str_cols = [kp.index for kp in rel._key_plans if kp.kind == "str"]
    for batch in rel.child.batches():
        cols, valids, _, n = TM.compact_batch(rel._pred_batch(batch))
        dead = tuple(True for _ in rel._key_plans)
        for dead in (rel._null_keys(valids), dead):
            ranks = {i: batch.dicts[i].sort_ranks() for i in str_cols}
            ranks_dev = {i: torch.from_numpy(r.astype(np.int64)) for i, r in ranks.items()}
            host = rel._host_keys(cols, valids, batch.dicts, dead, ranks)
            dev = rel._device_ops(batch, dead, ranks_dev)
            assert len(host) == len(dev)
            for h, d in zip(host, dev):
                assert d.dtype == torch.int64 and len(h) == n
                assert np.array_equal(np.asarray(h, np.int64), d.numpy())


def test_topk_reads_its_keys_once_from_a_warm_batch(monkeypatch):
    """A TopK run again over in-memory batches copies no key column
    again: the device inputs are cached on the batches."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    jctx, tctx = contexts(_topk_source(62))
    sql = "SELECT a, b, s FROM t ORDER BY a DESC, b LIMIT 40"
    want = jax_collect(jctx.sql(sql)).to_rows()
    rel = tctx.sql(sql)
    before = _count(METRICS, "h2d.bytes")
    _same_rows(tdf.collect(rel).to_rows(), want)
    assert _count(METRICS, "h2d.bytes") > before
    before = _count(METRICS, "h2d.bytes")
    _same_rows(tdf.collect(rel).to_rows(), want)
    assert _count(METRICS, "h2d.bytes") == before


class _Reparsed(MemoryDataSource):
    """A source parsed anew on every scan: scan r reads `parses[r]`,
    fresh batches over a fresh dictionary."""

    def __init__(self, schema, parses):
        super().__init__(schema, parses[0])
        self._parses = parses
        self.scans = 0

    def batches(self):
        out = self._parses[min(self.scans, len(self._parses) - 1)]
        self.scans += 1
        return iter(out)

    def with_projection(self, projection):
        assert list(projection) == list(range(len(self.schema)))
        return self


@pytest.mark.parametrize("wire", ["always", "auto"])
def test_topk_ranks_each_runs_own_dictionary(monkeypatch, wire):
    """One TopK relation run twice over two parses whose dictionaries
    have the same length (so the same version) but other orders: each
    run ranks its strings by its own dictionary."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", wire)
    D = tdf.DataType
    schema = tdf.Schema([tdf.Field("s", D.UTF8, False), tdf.Field("v", D.INT64, False)])
    rng = np.random.default_rng(63)
    parses, wants = [], []
    for order in (["b", "a", "c"], ["c", "a", "b"]):
        d = TB.StringDictionary()
        for w in order:
            d.add(w)
        words = [order[i] for i in rng.integers(0, 3, 30)]
        vals = rng.integers(-1000, 1000, 30)
        codes = np.array([order.index(w) for w in words], np.int32)
        parses.append([TB.make_host_batch(schema, [codes, vals], [None, None], [d, None])])
        wants.append(sorted(zip(words, vals.tolist()))[:24])
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", _Reparsed(schema, parses))
    rel = ctx.sql("SELECT s, v FROM t ORDER BY s, v LIMIT 24")
    assert _node(rel, SortRelation)._topk
    for want in wants:
        assert tdf.collect(rel).to_rows() == want
