"""Deterministic fault injection (the JAX package's `testing/faults.py`,
whole: the registry, `check`, `corrupt` and the plan).

In the port the disk sites of the write-ahead log (`utils/wal.py`:
``wal.write``, ``wal.fsync``, ``wal.rename``, ``snapshot.write``), the
wire codec's (``wire.send``, ``wire.recv``, ``wire.recv.payload``, in
the blocking codec and the worker's event loop), the device pass's
(``device.call``) and the distributed plane's (``worker.fragment``,
``worker.shuffle_join``, ``coord.request``) consult it; the cluster
sites named below belong to a plane the port has not taken yet.

SURVEY §5.3 names failure detection/recovery as a first-class rebuild
target, but recovery code that only ever runs when real hardware
misbehaves is untested code.  This module makes every failure path
exercisable on demand: production code declares *named sites*
(`faults.check("wire.recv")`) at the points where the real world can
hurt it — wire send/recv, worker fragment execution, device dispatch,
CSV/IO reads, and the cluster control plane (``cluster.request`` =
service partition, ``cluster.lease.refresh`` = lease expiry /
heartbeat loss, ``cluster.watch`` = stale membership view,
``cluster.replicate`` = log-shipping failure, ``cluster.election`` =
aborted standby promotion, ``cluster.snapshot`` = catch-up snapshot
failure, and the durability layer's disk path (``wal.write`` = record
append, ``wal.fsync`` = flush to stable storage, ``wal.rename`` =
snapshot/manifest rename-into-place, ``snapshot.write`` = compacted
snapshot serialization) — and a process-global, seedable *fault plan*
decides which sites fire and how.  The disk sites compose with the
ops the same way the wire sites do: ``raise`` with ``OSError`` models
ENOSPC, ``corrupt`` a torn record, ``short`` a short write, ``kill`` a
crash point mid-IO.

Zero overhead when off: with no plan installed, `check()` is one module
attribute read and a `None` test.  Nothing else in the engine changes.

A plan is JSON (installable in-process or via the environment, so
worker *subprocesses* honor it too):

    {"seed": 7, "rules": [
      {"site": "worker.fragment", "op": "kill", "after": 2},
      {"site": "wire.recv", "op": "raise", "exc": "ConnectionResetError",
       "after": 1, "count": 1},
      {"site": "device.call", "op": "raise", "exc": "DeviceTransientError",
       "count": 2},
      {"site": "io.read", "op": "delay", "seconds": 0.05, "p": 0.5}
    ]}

Rule fields:
- ``site``: fnmatch pattern over site names (``"wire.*"`` works).
- ``op``: ``raise`` | ``delay`` | ``corrupt`` | ``short`` | ``kill``
  (``short`` truncates the payload at a ``corrupt``-style hook — a
  short write at the WAL sites, dropped tail bytes on the wire).
- ``exc`` / ``message``: exception to raise (resolved from builtins,
  then `datafusion_tpu_torch.errors`).  Default ``ExecutionError``.
- ``seconds``: sleep length for ``delay`` — a number, or a
  ``[lo, hi]`` range drawn per firing from a seeded stream (keyed on
  plan seed, rule index, site, and the firing ordinal, like the ``p``
  draws), so *gray failures* — alive-but-slow workers, crawling wire
  reads — are injectable with run-over-run identical slowdown
  schedules at the existing wire/fragment/device sites.
- ``after``: 1-based hit index at which the rule starts firing
  (default 1 = first hit).
- ``count``: number of firings (default 1; 0 means unlimited).
- ``p``: firing probability per eligible hit.  Each (rule, site) pair
  keeps its own *virtual hit clock*: the draw for the k-th hit at a
  site is a pure function of (plan seed, rule index, site name, k), so
  the set of firing hits is identical across runs regardless of thread
  interleaving — probabilistic chaos soaks replay exactly.
- ``role``: only fire in processes whose role matches (workers set
  ``worker``; everything else is ``main``).
- ``where``: dict matched against the site's context kwargs (e.g.
  ``{"shard": 0}`` fires only for fragment 0).
- ``offset``: for ``corrupt`` — byte offset of the flipped run
  (default: drawn from the rule's seeded stream).

Deterministic plans should use ``after``/``count`` (hit counting is
per-rule and lock-protected).  ``p`` draws are deterministic per
(site, hit-index) — see above — so a soak replays the same firing
pattern per site; only ``count``-capped p-rules can still diverge
across runs (which thread reaches its firing hit first decides which
SITE consumes the cap).

Environment: ``DATAFUSION_TPU_FAULTS`` holds the plan JSON inline, or
``@/path/to/plan.json``.  Parsed once at import.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import time
from typing import Any, Optional

_ENV_VAR = "DATAFUSION_TPU_FAULTS"
_KILL_EXIT_CODE = 17  # distinctive: "died by injected fault", not a crash


class InjectedConnectionAbort(ConnectionError):
    """Raised by a fault rule to make an IN-PROCESS worker abort the
    connection without responding — the coordinator sees the same
    mid-query EOF a killed worker process produces, but the test
    process survives (op "kill" would `os._exit` it)."""


def _resolve_exc(name: str):
    import builtins
    import sys

    hit = getattr(sys.modules[__name__], name, None)
    if isinstance(hit, type) and issubclass(hit, BaseException):
        return hit
    hit = getattr(builtins, name, None)
    if isinstance(hit, type) and issubclass(hit, BaseException):
        return hit
    from datafusion_tpu_torch import errors

    hit = getattr(errors, name, None)
    if isinstance(hit, type) and issubclass(hit, BaseException):
        return hit
    raise ValueError(f"unknown fault exception type {name!r}")


class _Rule:
    __slots__ = (
        "site", "op", "exc", "message", "seconds", "seconds_hi",
        "after", "count", "p", "role", "where", "offset", "hits",
        "fired", "rng", "seed", "index", "site_hits",
    )

    def __init__(self, spec: dict, seed: int, index: int):
        self.site = spec["site"]
        self.op = spec.get("op", "raise")
        if self.op not in ("raise", "delay", "corrupt", "short", "kill"):
            raise ValueError(f"unknown fault op {self.op!r}")
        self.exc = spec.get("exc", "ExecutionError")
        _resolve_exc(self.exc)  # fail at install, not at fire
        self.message = spec.get("message", f"injected fault at {self.site}")
        secs = spec.get("seconds", 0.0)
        if isinstance(secs, (list, tuple)):
            if len(secs) != 2 or float(secs[0]) > float(secs[1]):
                raise ValueError(
                    f"delay 'seconds' range must be [lo, hi]: {secs!r}")
            self.seconds = float(secs[0])
            self.seconds_hi = float(secs[1])
        else:
            self.seconds = float(secs)
            self.seconds_hi = None
        self.after = int(spec.get("after", 1))
        self.count = spec.get("count", 1) or 0  # 0 = unlimited
        self.p = spec.get("p")
        self.role = spec.get("role")
        self.where = spec.get("where") or {}
        self.offset = spec.get("offset")  # corrupt: byte offset (None = seeded)
        self.hits = 0
        self.fired = 0
        self.seed = seed
        self.index = index
        # per-(rule, site) virtual hit clocks for the p draws
        self.site_hits: dict = {}
        # per-rule stream (corrupt offsets): adding a rule never
        # perturbs another's draws
        self.rng = random.Random((seed << 8) ^ index)

    def p_fires(self, site: str) -> bool:
        """Advance `site`'s virtual hit clock and decide the p draw.
        The draw is a pure function of (seed, rule index, site, hit
        index) — no shared RNG stream, so thread interleaving cannot
        reshuffle which hits fire (str seeds hash via sha512, stable
        across processes unlike builtin hash())."""
        k = self.site_hits[site] = self.site_hits.get(site, 0) + 1
        draw = random.Random(f"{self.seed}:{self.index}:{site}:{k}").random()
        return draw < self.p

    def delay_s(self, site: str, ordinal: int) -> float:
        """Sleep length for a firing ``delay`` rule: the fixed
        ``seconds``, or — for a ``[lo, hi]`` range — a seeded uniform
        draw keyed on (plan seed, rule index, site, firing ordinal).
        `ordinal` is the rule's `fired` count CAPTURED under the plan
        lock at `_due` time (a post-lock read would let concurrent
        firings share an ordinal), so each firing's draw is unique and
        the whole schedule is a pure function of the plan — a
        probabilistic gray-failure soak replays the same slowdowns run
        over run (thread interleaving can reorder which SITE receives
        which ordinal, exactly like count-capped p-rules)."""
        if self.seconds_hi is None:
            return self.seconds
        draw = random.Random(
            f"{self.seed}:{self.index}:{site}:delay:{ordinal}"
        ).random()
        return self.seconds + draw * (self.seconds_hi - self.seconds)

    def matches(self, site: str, role: str, ctx: dict) -> bool:
        if self.role is not None and self.role != role:
            return False
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        for k, v in self.where.items():
            if ctx.get(k) != v:
                return False
        return True

    def snapshot(self) -> dict:
        out = {"site": self.site, "op": self.op, "hits": self.hits,
               "fired": self.fired}
        if self.site_hits:
            out["site_hits"] = dict(self.site_hits)
        return out


class FaultPlan:
    """A set of rules plus their (lock-protected) firing state."""

    def __init__(self, spec: dict):
        from datafusion_tpu_torch.analysis import lockcheck

        self.seed = int(spec.get("seed", 0))
        self.rules = [
            _Rule(r, self.seed, i) for i, r in enumerate(spec.get("rules", []))
        ]
        self._lock = lockcheck.make_lock("faults.plan")

    def _due(self, site: str, role: str, ctx: dict
             ) -> "Optional[tuple[_Rule, int]]":
        """Advance hit counters; return ``(rule, firing ordinal)`` for
        the rule that fires, if any.  The ordinal is captured HERE,
        under the lock — delay-range draws key on it, and a post-lock
        read of `fired` would let concurrent firings share one."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site, role, ctx):
                    continue
                rule.hits += 1
                if rule.hits < rule.after:
                    continue
                if rule.count and rule.fired >= rule.count:
                    continue
                if rule.p is not None and not rule.p_fires(site):
                    continue
                rule.fired += 1
                return rule, rule.fired
        return None

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [r.snapshot() for r in self.rules]


_PLAN: Optional[FaultPlan] = None
_ROLE = "main"


def install(spec) -> FaultPlan:
    """Install a process-global plan from a dict / JSON string /
    ``@path``.  Replaces any existing plan."""
    global _PLAN
    if isinstance(spec, str):
        if spec.startswith("@"):
            with open(spec[1:], "r", encoding="utf-8") as f:
                spec = json.load(f)
        else:
            spec = json.loads(spec)
    _PLAN = FaultPlan(spec)
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def set_role(role: str) -> None:
    """Tag this process for role-scoped rules (workers pass "worker")."""
    global _ROLE
    _ROLE = role


class scoped:
    """``with faults.scoped({...}):`` — install for a block, then
    restore whatever was active before (tests)."""

    def __init__(self, spec):
        self._spec = spec
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _PLAN
        self._prev = _PLAN
        return install(self._spec)

    def __exit__(self, *exc_info):
        global _PLAN
        _PLAN = self._prev
        return False


def check(site: str, **ctx: Any) -> None:
    """The injection site hook.  No-op (one None test) when no plan is
    installed; otherwise may sleep, raise, or kill the process."""
    plan = _PLAN
    if plan is None:
        return
    due = plan._due(site, _ROLE, ctx)
    if due is None:
        return
    _fire(due[0], site, due[1])


def corrupt(site: str, data, **ctx: Any):
    """Payload-transform hook for wire buffers: returns `data`, with a
    deterministic byte-flip applied when a ``corrupt`` rule fires.
    Non-corrupt rules matched at the site behave as in `check`."""
    plan = _PLAN
    if plan is None:
        return data
    due = plan._due(site, _ROLE, ctx)
    if due is None:
        return data
    rule, ordinal = due
    if rule.op == "short":
        # short write: keep only a prefix (rule "offset" pins the cut;
        # default draws a proper prefix from the rule's seeded stream)
        buf = bytearray(data)
        if not buf:
            return data
        keep = rule.offset
        if keep is None:
            keep = rule.rng.randrange(len(buf))
        return bytes(buf[: min(int(keep), len(buf))])
    if rule.op != "corrupt":
        _fire(rule, site, ordinal)
        return data
    buf = bytearray(data)
    if buf:
        # flip a run of bytes: enough damage that a frame cannot parse,
        # deterministic across replays (rule "offset" pins the spot;
        # default draws from the rule's seeded stream)
        off = rule.offset
        if off is None:
            off = rule.rng.randrange(len(buf))
        off = min(int(off), len(buf) - 1)
        for i in range(off, min(off + 8, len(buf))):
            buf[i] ^= 0x5A
    return buf


def _fire(rule: _Rule, site: str, ordinal: int) -> None:
    from datafusion_tpu_torch.utils.metrics import METRICS

    METRICS.add(f"faults.fired.{site}")
    if rule.op == "delay":
        time.sleep(rule.delay_s(site, ordinal))
        return
    if rule.op == "kill":
        # simulate SIGKILL mid-work: no cleanup, no flushing, the
        # socket peer sees a mid-frame EOF / connection reset
        os._exit(_KILL_EXIT_CODE)
    if rule.op in ("corrupt", "short"):
        # a payload-transform rule on a non-payload site degrades to
        # an error
        raise _resolve_exc("ExecutionError")(rule.message)
    raise _resolve_exc(rule.exc)(rule.message)


_env = os.environ.get(_ENV_VAR)
if _env:
    install(_env)
del _env
