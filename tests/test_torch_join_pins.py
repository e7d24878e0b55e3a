"""PyTorch/CUDA port: join builds pinned in the device ledger
(`join/relation.py`, `ExecutionContext._build_key`), on the CPU.

- A join a server runs again probes its pinned build
  (`join.build.reuse`, the same artifact) and answers as the first run
  did; `stop` unpins it; a build above `DATAFUSION_TPU_JOIN_PIN_MAX` is
  not pinned; a plain `ctx.sql` pins nothing.
- Two contexts that register different in-memory tables under one name
  each get their own build and their own correct answer, against a
  numpy oracle: the JAX package's collision (ROADMAP queue 3, its pin
  fingerprint holds the name and not the data) does not happen here.
- The fingerprint holds the dense window, so a join forced onto the
  host index does not probe a dense build; the dense path still refuses
  dictionary-coded (Utf8) keys under pinning.
The card's count of build-kernel launches is in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import numpy as np

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.join.relation import HashJoinRelation
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.utils.metrics import METRICS

T = tdf.DataType
SQL = "SELECT l.k, l.v, r.w FROM l JOIN r ON l.k = r.rk"


def _tables(seed: int, nkeys: int = 500, nprobe: int = 6000):
    rng = np.random.default_rng(seed)
    ls = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("v", T.INT64, False)])
    rs = tdf.Schema([tdf.Field("rk", T.INT64, False), tdf.Field("w", T.FLOAT64, False)])
    keys = rng.permutation(nkeys * 3)[:nkeys].astype(np.int64)
    w = np.round(rng.uniform(0, 100, nkeys), 3)
    probe = rng.integers(0, nkeys * 3, nprobe).astype(np.int64)
    v = np.arange(nprobe, dtype=np.int64)
    left = tdf.MemoryDataSource(ls, [tdf.make_host_batch(ls, [probe[i:i + 2048], v[i:i + 2048]])
                                     for i in range(0, nprobe, 2048)])
    right = tdf.MemoryDataSource(rs, [tdf.make_host_batch(rs, [keys, w])])
    lookup = dict(zip(keys.tolist(), w.tolist()))
    want = sorted((int(k), int(x), lookup[int(k)]) for k, x in zip(probe, v)
                  if int(k) in lookup)
    return left, right, want


def _ctx(left, right):
    ctx = tdf.ExecutionContext(device="cpu")
    ctx.register_datasource("l", left)
    ctx.register_datasource("r", right)
    return ctx


def _join_of(rel):
    while not isinstance(rel, HashJoinRelation):
        rel = rel.child
    return rel


def _reuses() -> int:
    return METRICS.snapshot()["counts"].get("join.build.reuse", 0)


def _run(srv):
    """One served run of SQL: its sorted rows and its join relation."""
    t = srv.submit(SQL)
    return sorted(t.result(timeout=60).to_rows()), _join_of(t._rel)


def test_repeated_join_reuses_its_pinned_build():
    left, right, want = _tables(1)
    ctx = _ctx(left, right)
    r0 = _reuses()
    with ctx.serve(workers=1, window_s=0.001) as srv:
        rows, join = _run(srv)
        assert rows == want
        art = join._artifact
        assert art.dense
        fp = join.build_key
        assert fp.startswith("join:") and LEDGER.pins_snapshot()[fp]["owner"] == "join.build"
        for _ in range(3):
            rows, join = _run(srv)
            assert rows == want
            assert join._artifact is art
    assert _reuses() - r0 == 3
    assert fp not in LEDGER.pins_snapshot()  # the server unpinned it


def test_plain_context_pins_no_build():
    left, right, want = _tables(9)
    ctx = _ctx(left, right)
    pins0, r0 = LEDGER.pins_snapshot(), _reuses()
    for _ in range(2):
        rel = ctx.sql(SQL)
        assert sorted(tdf.collect(rel).to_rows()) == want
        assert _join_of(rel).build_key is None
    assert LEDGER.pins_snapshot() == pins0 and _reuses() == r0


def test_build_above_the_pin_cap_is_not_pinned(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_JOIN_PIN_MAX", "0")
    left, right, want = _tables(2)
    ctx = _ctx(left, right)
    r0 = _reuses()
    with ctx.serve(workers=1, window_s=0.001) as srv:
        for _ in range(2):
            rows, join = _run(srv)
            assert rows == want
            assert join.build_key not in LEDGER.pins_snapshot()
    assert _reuses() == r0


def test_same_name_other_data_gets_its_own_build():
    """Two contexts, one table name, different data, both served at
    once: each answer is its own table's (the JAX package probes the
    first context's build)."""
    a = _tables(3)
    b = _tables(4)
    ctx_a, ctx_b = _ctx(a[0], a[1]), _ctx(b[0], b[1])
    with ctx_a.serve(workers=1, window_s=0.001) as srv_a, \
            ctx_b.serve(workers=1, window_s=0.001) as srv_b:
        got_a, join_a = _run(srv_a)
        got_b, join_b = _run(srv_b)
        assert got_a == a[2] and got_b == b[2] and got_a != got_b
        assert join_a.build_key != join_b.build_key
        assert {join_a.build_key, join_b.build_key} <= set(LEDGER.pins_snapshot())
        # and each context keeps reusing its own build
        for srv, want, first in ((srv_b, b[2], join_b), (srv_a, a[2], join_a)):
            rows, join = _run(srv)
            assert rows == want and join._artifact is first._artifact


def test_re_registered_name_rebuilds():
    a = _tables(5)
    b = _tables(6)
    ctx = _ctx(a[0], a[1])
    with ctx.serve(workers=1, window_s=0.001) as srv:
        rows, join_a = _run(srv)
        assert rows == a[2]
        ctx.register_datasource("l", b[0])
        ctx.register_datasource("r", b[1])
        rows, join_b = _run(srv)
        assert rows == b[2]
        assert join_b.build_key != join_a.build_key
    # both servings' sources and pins are given back
    assert ctx.datasources["l"] is b[0] and ctx.datasources["r"] is b[1]
    assert not {join_a.build_key, join_b.build_key} & set(LEDGER.pins_snapshot())


def test_dense_window_is_part_of_the_fingerprint(monkeypatch):
    left, right, want = _tables(7)
    ctx = _ctx(left, right)
    with ctx.serve(workers=1, window_s=0.001) as srv:
        rows, dense = _run(srv)
        assert rows == want
        assert dense._artifact.dense
        monkeypatch.setenv("DATAFUSION_TPU_JOIN_DENSE_SLOTS", "0")
        rows, host = _run(srv)
        assert rows == want
        assert host.build_key != dense.build_key
        assert not host._artifact.dense


def test_dictionary_coded_keys_stay_off_the_dense_path():
    rng = np.random.default_rng(8)
    ls = tdf.Schema([tdf.Field("k", T.UTF8, False), tdf.Field("v", T.INT64, False)])
    rs = tdf.Schema([tdf.Field("rk", T.UTF8, False), tdf.Field("w", T.INT64, False)])
    dl, dr = tdf.StringDictionary(), tdf.StringDictionary()
    names = [f"n{i}" for i in range(50)]
    probe = [names[i] for i in rng.integers(0, 50, 400)]
    left = tdf.MemoryDataSource(ls, [tdf.make_host_batch(
        ls, [dl.encode(probe), np.arange(400)], None, [dl, None])])
    right = tdf.MemoryDataSource(rs, [tdf.make_host_batch(
        rs, [dr.encode(names[::-1]), np.arange(50)], None, [dr, None])])
    ctx = _ctx(left, right)
    want = sorted((p, i, 49 - names.index(p)) for i, p in enumerate(probe))
    with ctx.serve(workers=1, window_s=0.001) as srv:
        for _ in range(2):
            rows, join = _run(srv)
            assert rows == want
            assert not join._artifact.dense
