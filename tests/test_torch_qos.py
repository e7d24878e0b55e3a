"""PyTorch/CUDA port: multi-tenant QoS (`datafusion_tpu_torch.qos`) and
the serving front door's tenancy (`serve.Server(shares=...)`,
`submit(client_id=...)`).

The cases of the JAX package's `tests/test_qos.py` that need no cluster
or SLO watchdog, on the port, each held against the JAX package:

- the same `FairSharePolicy.order` and `shed_victim` on the same tickets
  (hand-made cases and numpy-seeded backlogs, deadlines included);
- the same configuration (`enabled`, `parse_shares`, `shares_from_env`,
  `policy_from_config`, `scope_client`), the same `scale_hint` truth
  table and the same bucket overflow fold;
- served on `ExecutionContext(device="cpu")` in both packages, the same
  submissions against a frozen queue: the same sheds (which tickets,
  which reasons), `admitted + shed == submitted`, the same per-tenant
  shed meters, and the same rows;
- with no shares and `DATAFUSION_TPU_QOS` unset, admission is FIFO; with
  shares the window drains the light tenant first; a full queue sheds
  the over-quota tenant's newest ticket with the reason `quota`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

import datafusion_tpu as jdf
from datafusion_tpu import qos as jqos
from datafusion_tpu.errors import QueryShedError as JaxShedError
from datafusion_tpu.obs import attribution as jatt
from datafusion_tpu.obs.device import LEDGER as JAX_LEDGER
from datafusion_tpu.utils.deadline import Deadline as JaxDeadline

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch import qos as tqos
from datafusion_tpu_torch.errors import QueryShedError
from datafusion_tpu_torch.obs import attribution as tatt
from datafusion_tpu_torch.utils.deadline import Deadline
from datafusion_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import assert_same, carry, jax_table

T = jdf.DataType
WAIT = 60


@pytest.fixture(autouse=True)
def _clean_tenant_state():
    prior = {k: os.environ.pop(k, None)
             for k in ("DATAFUSION_TPU_QOS", "DATAFUSION_TPU_QOS_SHARES",
                       "DATAFUSION_TPU_HBM_BYTES")}
    jatt.reset_for_tests()
    tatt.reset_for_tests()
    yield
    jatt.reset_for_tests()
    tatt.reset_for_tests()
    for k, v in prior.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class _T:
    """A ticket stub: the attributes the policy reads."""

    def __init__(self, cid: str, seq: float, deadline=None):
        self.client_id = cid
        self.deadline = deadline
        self.entry_mono = float(seq)


def _ids(tickets, backlog) -> list:
    return [backlog.index(t) for t in tickets]


def _pair(spec, deadline_cls):
    """One backlog of stubs from (client, seq, deadline seconds|None)."""
    return [_T(c, s, None if d is None else deadline_cls.after(d)) for c, s, d in spec]


ORDER_CASES = {
    "weighted": ({"a": 3.0, "b": 1.0}, [("a", 0, None), ("b", 1, None), ("a", 2, None),
                                        ("b", 3, None), ("a", 4, None), ("b", 5, None)],
                 1.0, {}),
    "attained": ({"a": 1.0, "b": 1.0}, [("b", 0, None), ("a", 1, None), ("b", 2, None),
                                        ("a", 3, None)], 0.001, {"a": 0.0, "b": 10.0}),
    "urgency": ({"a": 1.0, "b": 1.0}, [("a", 0, 10.0), ("a", 1, None), ("a", 2, 0.05)],
                1.0, {}),
    "urgency_cross": ({"a": 1.0, "b": 1.0}, [("b", 0, 0.01), ("a", 1, None), ("b", 2, 0.01)],
                      0.001, {"a": 0.0, "b": 10.0}),
    "fifo": ({}, [(f"c{i}", i, None) for i in range(5)], None, {}),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_order_equals_the_jax_package(case):
    shares, spec, unit, attained = ORDER_CASES[case]
    jb, tb = _pair(spec, JaxDeadline), _pair(spec, Deadline)
    want = _ids(jqos.FairSharePolicy(shares).order(jb, unit_cost_s=unit, attained=attained), jb)
    got = _ids(tqos.FairSharePolicy(shares).order(tb, unit_cost_s=unit, attained=attained), tb)
    assert got == want
    if case == "weighted":
        assert [spec[i][0] for i in got] == ["a", "a", "b", "a", "b", "b"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_backlogs_order_and_shed_alike(seed):
    rng = np.random.default_rng(seed)
    clients = ["a", "b", "c", "d"]
    shares = {c: float(rng.integers(1, 5)) for c in clients[:3]}
    spec = [(clients[rng.integers(0, 4)], i,
             None if rng.random() < 0.5 else float(rng.uniform(5, 50))) for i in range(24)]
    costs = {c: float(rng.uniform(0, 2)) for c in clients}
    for c, v in costs.items():
        jatt.METER.charge(c, "device_seconds", v)
        tatt.METER.charge(c, "device_seconds", v)
    jpol, tpol = jqos.FairSharePolicy(shares), tqos.FairSharePolicy(shares)
    jb, tb = _pair(spec, JaxDeadline), _pair(spec, Deadline)
    assert _ids(tpol.order(tb, unit_cost_s=0.01), tb) == _ids(jpol.order(jb, unit_cost_s=0.01), jb)
    for incoming in clients:
        jv, jself = jpol.shed_victim(list(jb), incoming)
        tv, tself = tpol.shed_victim(list(tb), incoming)
        assert tself == jself
        assert (None if tv is None else tb.index(tv)) == (None if jv is None else jb.index(jv))
    assert tpol.snapshot() == jpol.snapshot()


def test_shed_victim_cases():
    for att, mod, dl in ((jatt, jqos, JaxDeadline), (tatt, tqos, Deadline)):
        att.METER.charge("b", "device_seconds", 100.0)
        pol = mod.FairSharePolicy({"a": 1.0, "b": 1.0})
        b_old, b_new = _T("b", 1.0), _T("b", 2.0)
        assert pol.shed_victim([b_old, _T("a", 0.5), b_new], "a") == (b_new, False)
        assert pol.shed_victim([_T("a", 0.5)], "b") == (None, True)
        urgent, lazy = _T("b", 2.0, dl.after(0.05)), _T("b", 1.0, dl.after(60.0))
        assert mod.FairSharePolicy().shed_victim([urgent, lazy], "a")[0] is lazy


def test_configuration_equals_the_jax_package(monkeypatch):
    assert tqos.enabled() is jqos.enabled() is False
    assert tqos.policy_from_config(None) is None
    for spec in ("a=3, b=1", "x,y=2,z=-1,w=oops", "", None):
        assert tqos.parse_shares(spec) == jqos.parse_shares(spec)
    monkeypatch.setenv("DATAFUSION_TPU_QOS", "on")
    monkeypatch.setenv("DATAFUSION_TPU_QOS_SHARES", "gold=4,silver=2")
    assert tqos.enabled() and tqos.shares_from_env() == jqos.shares_from_env()
    tpol, jpol = tqos.policy_from_config({"silver": 3}), jqos.policy_from_config({"silver": 3})
    assert tpol.shares == jpol.shares == {"gold": 4.0, "silver": 3.0}
    assert tpol.share("bronze") == jpol.share("bronze") == 1.0
    assert (tqos.FairSharePolicy({}, default=0.5).share("bronze")
            == jqos.FairSharePolicy({}, default=0.5).share("bronze") == 0.5)
    assert tqos.policy_from_config("a=2").shares == jqos.policy_from_config("a=2").shares
    for scope in (None, ("solo", "a", [0.0]), ("shared", (("a", 0.2), ("b", 0.8)), [0.0]),
                  ("shared", (), [0.0])):
        assert tqos.scope_client(scope) == jqos.scope_client(scope)


@pytest.mark.parametrize("burn", [None, 0.0, 0.05, 0.5, 1.0, 3.0])
@pytest.mark.parametrize("queue", [None, 0.0, 0.3, 0.6])
def test_scale_hint_truth_table(burn, queue):
    assert tqos.scale_hint(burn, queue) == jqos.scale_hint(burn, queue)


def test_bucket_overflow_fold_caps_cardinality():
    jtb, ttb = jqos.TenantBuckets(1.0, 8.0), tqos.TenantBuckets(1.0, 8.0)
    before = METRICS.counts.get("qos.tenant_bucket_overflow", 0)
    for i in range(tqos._MAX_TENANT_BUCKETS + 3):
        jtb.earn(f"t{i}")
        ttb.earn(f"t{i}")
    assert ttb.gauges("retry") == jtb.gauges("retry")
    assert tqos._OVERFLOW in ttb._buckets
    assert METRICS.counts.get("qos.tenant_bucket_overflow", 0) > before


# -- served -------------------------------------------------------------------------


def _source(seed: int = 7):
    rng = np.random.default_rng(seed)
    n = 4096
    return jax_table([("k", T.UTF8, False), ("v", T.FLOAT64, False), ("p", T.FLOAT64, False)],
                     [np.array([f"g{j}" for j in rng.integers(0, 16, n)], dtype=object),
                      np.round(rng.uniform(0, 100, n), 2), np.round(rng.uniform(0, 1, n), 3)],
                     batch_rows=1024)


def _q(lit: float) -> str:
    return f"SELECT k, SUM(v), COUNT(1) FROM t WHERE p < {lit} GROUP BY k"


def _served_frozen(pkg, src, submissions, shed_error):
    """Submit `submissions` [(client, sql)] to a server whose window
    cannot close by itself (30 s, megabatch 64), with `queue_depth=4` and
    shares a=3, b=1, b already 100 s over; then flush the window and
    collect.  Returns ([outcome per submission], rows per answered sql,
    server, meter snapshot): an outcome is "ok" or the shed reason."""
    ctx = pkg.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", src)
    att = jatt if pkg is jdf else tatt
    att.METER.charge("b", "device_seconds", 100.0)
    srv = ctx.serve(workers=1, window_s=30.0, megabatch_max=64, queue_depth=4,
                    shares={"a": 3.0, "b": 1.0})
    tickets = []
    try:
        for client, sql in submissions:
            try:
                tickets.append(srv.submit(sql, client_id=client))
            except shed_error as e:
                tickets.append(e.reason)
        time.sleep(0.05)  # every ticket reached the window
        srv._loop.call_soon(srv._flush_window)
        outcomes, rows = [], {}
        for (client, sql), t in zip(submissions, tickets):
            if isinstance(t, str):
                outcomes.append(t)
                continue
            try:
                rows[sql] = t.result(timeout=WAIT)
                outcomes.append("ok")
            except shed_error as e:
                outcomes.append(e.reason)
    finally:
        srv.stop()
    return outcomes, rows, srv, att.METER.snapshot()


def test_served_tenants_shed_alike_in_both_packages():
    """The same submissions against a frozen queue: each arrival at the
    full queue sheds the over-quota tenant (b), a queued b ticket when
    the arrival is a's.  Both packages shed the same tickets for the
    same reasons, keep `admitted + shed == submitted`, meter the same
    per-tenant sheds and answer the same rows."""
    JAX_LEDGER.clear()
    src = _source()
    rng = np.random.default_rng(11)
    subs = [("b" if rng.random() < 0.7 else "a", _q(round(0.3 + 0.01 * i, 2)))
            for i in range(14)]
    jout, jrows, jsrv, jmeter = _served_frozen(jdf, src, subs, JaxShedError)
    tout, trows, tsrv, tmeter = _served_frozen(tdf, carry(src), subs, QueryShedError)
    assert tout == jout
    assert "quota" in tout and all(o == "ok" for (c, _), o in zip(subs, tout) if c == "a")
    for srv in (jsrv, tsrv):
        assert srv.admitted + srv.shed == srv.submitted == len(subs)
    for c in ("a", "b"):
        for key in ("shed", "shed_quota", "queries"):
            assert tmeter.get(c, {}).get(key, 0.0) == jmeter.get(c, {}).get(key, 0.0), (c, key)
    assert sorted(trows) == sorted(jrows)
    for sql in trows:
        assert_same(trows[sql], jrows[sql], ordered=False)


def _record_order(ctx, order: list):
    """Shadow `ctx.execute` on the instance: a worker lowers the tickets
    of a flushed window in its drain order, under each one's client
    scope, so the recorded scopes are the drain order."""
    orig = ctx.execute

    def recording(plan, *a, **k):
        order.append(tatt.current_client())
        return orig(plan, *a, **k)

    ctx.execute = recording


def _port_ctx():
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
    ctx.register_datasource("t", carry(_source()))
    return ctx


def test_fifo_when_off():
    ctx = _port_ctx()
    tatt.METER.charge("c0", "device_seconds", 100.0)  # would reorder under QoS
    order: list = []
    _record_order(ctx, order)
    with ctx.serve(workers=1, window_s=0.25, megabatch_max=32) as srv:
        assert srv._qos is None
        tickets = [srv.submit(_q(0.3 + 0.01 * i), client_id=f"c{i}") for i in range(6)]
        for t in tickets:
            t.result(timeout=WAIT)
    assert order == [f"c{i}" for i in range(6)]
    assert srv.admitted + srv.shed == srv.submitted
    assert "qos" not in srv.stats()


def test_env_arms_the_policy(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_QOS", "1")
    monkeypatch.setenv("DATAFUSION_TPU_QOS_SHARES", "hog=1,small=1")
    ctx = _port_ctx()
    tatt.METER.charge("hog", "device_seconds", 100.0)
    order: list = []
    _record_order(ctx, order)
    with ctx.serve(workers=1, window_s=0.5, megabatch_max=32) as srv:
        assert srv._qos is not None
        tickets = [srv.submit(_q(0.3 + 0.01 * i), client_id="hog" if i < 3 else "small")
                   for i in range(6)]
        for t in tickets:
            t.result(timeout=WAIT)
    assert order == ["small"] * 3 + ["hog"] * 3
    assert srv.stats()["qos"]["shares"] == {"hog": 1.0, "small": 1.0}


def test_quota_shed_names_the_over_quota_tenant():
    ctx = _port_ctx()
    tatt.METER.charge("b", "device_seconds", 100.0)
    srv = ctx.serve(workers=1, queue_depth=2, window_s=0.75, megabatch_max=32,
                    shares={"a": 1.0, "b": 1.0})
    try:
        t1 = srv.submit(_q(0.3), client_id="b")
        t2 = srv.submit(_q(0.31), client_id="b")
        t3 = srv.submit(_q(0.32), client_id="a")  # evicts b's newest
        with pytest.raises(QueryShedError) as exc:
            t2.result(timeout=WAIT)
        assert exc.value.reason == "quota"
        t1.result(timeout=WAIT)
        t3.result(timeout=WAIT)
        with pytest.raises(QueryShedError) as exc:  # b arriving over quota sheds itself
            srv.submit(_q(0.33), client_id="b")
            srv.submit(_q(0.34), client_id="b")
            srv.submit(_q(0.35), client_id="b")
        assert exc.value.reason == "quota"
    finally:
        srv.stop()
    assert srv.admitted + srv.shed == srv.submitted
    assert tatt.METER.snapshot()["b"]["shed_quota"] >= 1.0
    assert "shed_quota" not in tatt.METER.snapshot().get("a", {})
