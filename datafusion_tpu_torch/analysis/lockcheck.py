"""Lock-order race detector (a lockdep, sized for one engine).

The JAX package's `analysis/lockcheck.py`, whole.  In the port the
result cache's store (`cache/store.py`), the fault plan
(`testing/faults.py`) and the blocking sites of the write-ahead log,
the wire codec and the ingest plane feed it; the port's other locks
(serve.py, the device ledger, the prefetch threads) are plain
`threading.Lock`s still.  This module makes the discipline checked.
``make_lock(name)`` is the adoption seam: with
``DATAFUSION_TPU_LOCKCHECK`` unset it returns a plain
``threading.Lock`` — zero overhead, byte-identical behavior — and with
``=1`` it returns a :class:`TrackedLock` that records, per thread, the
stack of held locks and folds every *nested blocking* acquisition into
a global lock-order graph:

- thread holds A and blocks-acquires B  =>  edge ``A -> B`` (with the
  acquisition site that created it);
- a **cycle** in the graph is a potential deadlock — two threads can
  interleave the recorded orders and wait on each other forever, even
  if the test run itself never deadlocked;
- a **blocking call while holding a lock** (socket recv, a parked
  io-thread wait — any site that calls :func:`note_blocking`) is
  recorded as a finding: the holder stalls every other thread that
  needs the lock for as long as the network takes.

Edges key on lock *names* (one name per lock role — ``cache.store``,
``cluster.state`` — not per instance), the lockdep convention: an
order inversion between two instances of the same role is still a
deadlock when the instances coincide, and naming roles keeps the graph
small and the report readable.  Try-acquires (``blocking=False``)
record nothing — they cannot deadlock.

Reporting: ``report()`` returns the graph + findings; at process exit
an enabled run writes the JSON report to
``DATAFUSION_TPU_LOCKCHECK_FILE`` (when set) and prints a one-line
summary to stderr.

Tests that *construct* deliberate inversions use a private
:class:`Registry` so the global graph stays an honest record of the
engine's real behavior.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional

_TRUTHY = ("1", "true", "on", "yes")
_ENABLED = os.environ.get("DATAFUSION_TPU_LOCKCHECK", "").lower() in _TRUTHY


def enabled() -> bool:
    return _ENABLED


def _site() -> str:
    """Compact acquisition site: the innermost non-lockcheck frame."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        fn = frame.filename
        if "lockcheck" in fn or "threading" in os.path.basename(fn):
            continue
        return f"{os.path.basename(fn)}:{frame.lineno} in {frame.name}"
    return "?"


class Registry:
    """One lock-order graph plus its findings.  The module-global
    `GLOBAL` instance backs `make_lock`; tests build private registries
    for deliberate-inversion fixtures."""

    def __init__(self):
        self._lock = threading.Lock()  # guards the graph, never tracked
        self._held = threading.local()  # per-thread [names] stack
        # (held, acquired) -> sample site string (first observation)
        self.edges: dict[tuple[str, str], str] = {}
        # blocking-op findings: (op, held, site) — deduped
        self.blocking: dict[tuple[str, str], str] = {}

    # -- per-thread held stack --
    def _stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def note_acquire(self, name: str) -> None:
        """Called BEFORE a blocking acquire: fold edges held -> name."""
        stack = self._stack()
        if stack:
            site = _site()
            with self._lock:
                # held == name makes a SELF-edge: two instances of one
                # role nested — an inversion with itself the moment the
                # instances coincide, so it is recorded like any other
                for held in stack:
                    self.edges.setdefault((held, name), site)

    def note_acquired(self, name: str) -> None:
        self._stack().append(name)

    def note_release(self, name: str) -> None:
        stack = self._stack()
        # release order may not be LIFO (Condition.wait releases the
        # innermost; explicit .release() can target any held lock)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def note_blocking(self, op: str) -> None:
        """A blocking call (socket recv, parked wait) is happening on
        this thread; record every lock it is holding across it."""
        stack = self._stack()
        if not stack:
            return
        site = _site()
        with self._lock:
            for held in stack:
                self.blocking.setdefault((op, held), site)

    def held(self) -> list[str]:
        return list(self._stack())

    # -- analysis --
    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the lock-order graph (names)."""
        with self._lock:  # snapshot: live threads keep inserting edges
            keys = list(self.edges)
        graph: dict[str, set[str]] = {}
        for a, b in keys:
            graph.setdefault(a, set()).add(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(node: str, path: list[str], on_path: set[str]):
            for nxt in sorted(graph.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # canonical rotation dedup
                    body = cyc[:-1]
                    k = min(range(len(body)), key=lambda i: body[i:] + body[:i])
                    canon = tuple(body[k:] + body[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon) + [canon[0]])
                    continue
                dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(graph):
            dfs(start, [start], {start})
        return out

    def report(self) -> dict:
        with self._lock:
            edge_sites = dict(self.edges)
            blocking = [
                {"op": op, "held": held, "site": site}
                for (op, held), site in sorted(self.blocking.items())
            ]
        edges = [
            {"held": a, "acquired": b, "site": site}
            for (a, b), site in sorted(edge_sites.items())
        ]
        cycles = []
        for cyc in self.cycles():
            cyc_edges = [
                {"held": a, "acquired": b,
                 "site": edge_sites.get((a, b), "?")}
                for a, b in zip(cyc, cyc[1:])
                if (a, b) in edge_sites
            ]
            cycles.append({"cycle": cyc, "edges": cyc_edges})
        return {"edges": edges, "cycles": cycles, "blocking": blocking}

    @property
    def ok(self) -> bool:
        return not self.cycles() and not self.blocking

    def reset(self) -> None:
        with self._lock:
            self.edges.clear()
            self.blocking.clear()


GLOBAL = Registry()


class TrackedLock:
    """A ``threading.Lock`` that feeds a :class:`Registry`.

    Duck-compatible with the stdlib lock (``acquire``/``release``/
    context manager/``locked``), including use as the underlying lock
    of a ``threading.Condition`` — the Condition's wait/notify path
    releases and re-acquires through these methods, so the held-stack
    stays coherent across parked waits."""

    __slots__ = ("name", "_lock", "_registry")

    def __init__(self, name: str, registry: Optional[Registry] = None):
        self.name = name
        self._lock = threading.Lock()
        self._registry = registry if registry is not None else GLOBAL

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            # ordering is the INTENT to acquire — record before the
            # wait, so an actually-deadlocking interleaving still
            # contributes its edge to the graph
            self._registry.note_acquire(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._registry.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._registry.note_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc_info) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"TrackedLock({self.name}, {self._lock!r})"


def make_lock(name: str):
    """The adoption seam: a plain ``threading.Lock`` when lockcheck is
    off (zero overhead), a :class:`TrackedLock` feeding the global
    registry when on."""
    if not _ENABLED:
        return threading.Lock()
    return TrackedLock(name)


def note_blocking(op: str) -> None:
    """Mark a blocking call (socket recv/send, parked queue wait) so an
    enabled run records any lock held across it.  One module-flag test
    when off."""
    if _ENABLED:
        GLOBAL.note_blocking(op)


def report() -> dict:
    return GLOBAL.report()


def reset() -> None:
    GLOBAL.reset()


if _ENABLED:
    import atexit
    import json
    import sys

    def _report_at_exit() -> None:
        try:
            rep = GLOBAL.report()
            path = os.environ.get("DATAFUSION_TPU_LOCKCHECK_FILE")
            if path:
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(rep, f, indent=2)
            print(
                f"lockcheck: {len(rep['edges'])} lock-order edge(s), "
                f"{len(rep['cycles'])} cycle(s), "
                f"{len(rep['blocking'])} held-lock blocking call(s)"
                + (f" — report: {path}" if path else ""),
                file=sys.stderr,
            )
            for cyc in rep["cycles"]:
                print(f"lockcheck: CYCLE {' -> '.join(cyc['cycle'])}",
                      file=sys.stderr)
            for b in rep["blocking"]:
                print(
                    f"lockcheck: BLOCKING {b['op']!r} while holding "
                    f"{b['held']} ({b['site']})",
                    file=sys.stderr,
                )
        except Exception:  # noqa: BLE001 — exit hooks must not raise
            pass

    atexit.register(_report_at_exit)
