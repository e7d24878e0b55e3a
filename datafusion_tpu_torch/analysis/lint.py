"""Invariant linter: an ``ast``-based rule engine for the engine's
cross-cutting invariants.

The counterpart of the JAX package's `analysis/lint.py`.  Rules DF002,
DF003, DF004, DF005, DF007 and DF008 keep their meaning and give the
same (rule, line) findings on the same source text; their path scopes
resolve under ``datafusion_tpu_torch/``.  DF001 and DF006 name the
port's own host syncs and host-to-device copies:

- **DF001 host-sync-in-dispatch** — no host sync inside ``exec/``
  device paths: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``
  (a tensor's pull to the host), ``torch.cuda.synchronize`` and an
  ``Event``/``Stream`` ``.synchronize()``; and no ``np.asarray`` inside
  the fused dispatch fold (``exec/fused.py``).  A sync there serializes
  the launch pipeline the fused passes exist to batch.  ``.tolist()``
  and ``.numpy()`` cannot be told from their numpy namesakes by the
  source alone: a numpy site carries a marker that says so.
- **DF002 nondeterminism-in-replayable** — no wall clock
  (``time.time``/``time.time_ns``/``datetime.now``) or process-global
  ``random.*`` calls inside functions guarded by a named fault site:
  those functions are the *replayable* recovery surface, and seeded
  chaos soaks only replay if their behavior is a pure function of the
  plan seed.
- **DF003 unguarded-io-boundary** — raw socket IO (``.sendall`` /
  ``.recv``) only inside functions that hold a named fault site
  (``faults.check``/``faults.corrupt``); everything else must go
  through ``send_msg``/``recv_msg``, which carry the sites.
- **DF004 swallowed-broad-except** — no bare ``except:`` ever, and no
  ``except Exception:`` that swallows without either re-raising or the
  explicit ``# noqa: BLE001`` justification marker: a silent broad
  except around a wire/device call eats the `TransientError`
  classification the retry layer depends on.
- **DF005 lock-in-metrics-callback** — no lock acquisition inside
  ``utils/metrics.py``, the ambient-operator ``record_*`` callbacks
  (``obs/stats.py``), the hedge tracker's evidence path
  (``utils/hedge.py``), or the cost store's observe/lookup path
  (``cost/store.py``): they run inside other subsystems' critical
  sections (CacheStore eviction, retry loops, dispatch threads),
  where taking a lock would build silent lock-order edges.
- **DF007 blocking-io-in-sampler** — no blocking IO (file/socket/HTTP
  calls, ``time.sleep``, ``print``) inside the sampling profiler's
  timer-thread path (``obs/profiler.py`` ``_run``/``_sample_once``/
  ``_fold``): the sampler interrupts every thread's view of the world
  ~100x/second, and a sampler that blocks skews every profile it
  produces — rendering and persistence belong on the caller's thread
  at report time.  (DF005 also covers the same functions: the fold
  path runs beside arbitrary application code and must never take a
  lock.)
- **DF006 raw-device-copy** — no host-to-device copy outside the copy
  seam: ``exec/batch.to_device`` / ``put_compressed`` and
  ``obs/device.py`` (``LEDGER.adopt``).  Flagged: ``.cuda()``,
  ``.to(<device>, ...)`` (a device-named argument, a ``"cuda..."``
  string or a ``torch.device(...)``), and ``torch.as_tensor`` /
  ``torch.tensor`` / ``torch.asarray`` with a ``device=``.  A copy
  around the seam skips the copy counters (``device.h2d.transfers``,
  ``h2d.bytes``), the ledger's live bytes and the transfer profile.
  A ``.to(device)`` of a tensor already on the card is a device copy,
  not a host one; such sites carry a marker that says so.
- **DF008 blocking-disk-io-under-lock** — no blocking disk IO
  (``open``, ``os.fsync``/``os.rename``/``os.replace``/…, or the WAL
  entry points ``atomic_write_json``/``write_snapshot``/``_wal_*``)
  lexically inside a held-lock ``with`` block in the control plane
  (``cluster/``, ``serve.py``), and none at all inside the DF005
  lock-free callback surfaces: a slow fsync under the cluster apply
  lock extends the critical section to disk latency, stalling every
  reader behind a write.  WAL appends copy state under the lock,
  release it, then write.  The one reviewed exception is
  ``utils/wal.py`` itself — the disk-IO boundary module, which holds
  its own internal lock across writes by documented contract and
  announces itself via ``lockcheck.note_blocking``.

Suppression: append ``# df-lint: ok(DF00N)`` (or a blanket
``# df-lint: ok``) to the offending line, with a justification — the
marker is the reviewed exception list.  ``# noqa: BLE001`` additionally
suppresses DF004 (the pre-existing convention for documented swallows).

CLI: ``python -m datafusion_tpu_torch.analysis [paths] [--format=github]``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

_SUPPRESS = re.compile(r"#\s*df-lint:\s*ok(?:\(([A-Z0-9, ]+)\))?")
_NOQA_BLE = re.compile(r"#\s*noqa:[^\n]*\bBLE001\b")

# wall-clock / global-RNG call patterns for DF002: (module, attr)
_WALL_CLOCK = {("time", "time"), ("time", "time_ns"),
               ("datetime", "now"), ("datetime", "utcnow")}
# tensor pulls to the host (DF001): `x.item()`, `x.cpu()`, ...
_HOST_SYNCS = ("item", "cpu", "tolist", "numpy", "synchronize")


class Finding:
    __slots__ = ("rule", "path", "line", "col", "message")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message

    def text(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def github(self) -> str:
        return (f"::error file={self.path},line={self.line},"
                f"col={self.col}::{self.rule} {self.message}")

    def __repr__(self) -> str:
        return self.text()


def _call_name(node: ast.Call) -> Optional[str]:
    """Trailing attribute/name of a call: `a.b.c(...)` -> "c"."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _call_mod_attr(node: ast.Call) -> Optional[tuple[str, str]]:
    """`mod.attr(...)` -> ("mod", "attr") when mod is a bare name."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id, f.attr
    return None


def _is_faults_hook(node: ast.Call) -> bool:
    ma = _call_mod_attr(node)
    return ma is not None and ma[0] == "faults" and ma[1] in (
        "check", "corrupt"
    )


def _calls_in(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def _functions_in(tree: ast.AST):
    for sub in ast.walk(tree):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


class _Rule:
    id = "DF000"
    message = ""

    def applies(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.AST, relpath: str) -> list[Finding]:
        raise NotImplementedError

    def _finding(self, relpath: str, node: ast.AST, msg: str) -> Finding:
        return Finding(self.id, relpath, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0) + 1, msg)


class HostSyncInDispatch(_Rule):
    """DF001: host syncs inside device dispatch paths."""

    id = "DF001"

    def applies(self, relpath: str) -> bool:
        p = relpath.replace(os.sep, "/")
        return "datafusion_tpu_torch/exec/" in p or p.startswith("exec/")

    def check(self, tree, relpath):
        out = []
        fused = relpath.replace(os.sep, "/").endswith("exec/fused.py")
        for call in _calls_in(tree):
            name = _call_name(call)
            if name in _HOST_SYNCS and isinstance(call.func, ast.Attribute):
                out.append(self._finding(
                    relpath, call,
                    f".{name}() is a host sync; device dispatch paths "
                    "must stay async (launch pipelining is the fused-"
                    "pass win)",
                ))
            elif fused and name == "asarray":
                ma = _call_mod_attr(call)
                if ma is not None and ma[0] in ("np", "numpy"):
                    out.append(self._finding(
                        relpath, call,
                        "np.asarray inside the fused dispatch fold "
                        "forces D2H on device-tensor inputs",
                    ))
        return out


class NondeterminismInReplayable(_Rule):
    """DF002: wall clock / global RNG inside fault-guarded functions."""

    id = "DF002"

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, tree, relpath):
        out = []
        for fn in _functions_in(tree):
            if not any(_is_faults_hook(c) for c in _calls_in(fn)):
                continue
            for call in _calls_in(fn):
                ma = _call_mod_attr(call)
                if ma in _WALL_CLOCK:
                    out.append(self._finding(
                        relpath, call,
                        f"{ma[0]}.{ma[1]}() inside fault-site-guarded "
                        f"{fn.name}(): replayable code must not read "
                        "the wall clock (use time.monotonic / inject "
                        "now=)",
                    ))
                elif ma is not None and ma[0] == "random":
                    out.append(self._finding(
                        relpath, call,
                        f"process-global random.{ma[1]}() inside fault-"
                        f"site-guarded {fn.name}(): replayable code "
                        "must draw from a seeded stream",
                    ))
        return out


class UnguardedIoBoundary(_Rule):
    """DF003: raw socket IO outside fault-site-guarded functions."""

    id = "DF003"

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, tree, relpath):
        out = []
        for fn in _functions_in(tree):
            guarded = any(_is_faults_hook(c) for c in _calls_in(fn))
            if guarded:
                continue
            for call in _calls_in(fn):
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in ("sendall", "recv"):
                    out.append(self._finding(
                        relpath, call,
                        f".{call.func.attr}() in {fn.name}() without a "
                        "named fault site: IO boundaries go through "
                        "send_msg/recv_msg (which carry wire.send/"
                        "wire.recv) or declare their own faults.check",
                    ))
        return out


class SwallowedBroadExcept(_Rule):
    """DF004: bare/broad excepts that swallow silently."""

    id = "DF004"

    def applies(self, relpath: str) -> bool:
        return True

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                return True
        return False

    def check(self, tree, relpath):
        out = []
        for sub in ast.walk(tree):
            if not isinstance(sub, ast.ExceptHandler):
                continue
            if sub.type is None:
                out.append(self._finding(
                    relpath, sub,
                    "bare except: swallows everything, including the "
                    "TransientError classification the retry layer "
                    "keys on — name the exception types",
                ))
                continue
            name = sub.type.id if isinstance(sub.type, ast.Name) else None
            if name in ("Exception", "BaseException") and \
                    not self._reraises(sub):
                out.append(self._finding(
                    relpath, sub,
                    f"except {name} without re-raise: a broad swallow "
                    "here eats TransientError classification; narrow "
                    "the types or justify with `# noqa: BLE001`",
                ))
        return out


class LockInMetricsCallback(_Rule):
    """DF005: lock acquisition inside Metrics / stats callbacks."""

    id = "DF005"

    _STATS_FNS = ("record_h2d", "record_d2h", "record_retry",
                  "record_launch", "current_op",
                  "record_h2d_time", "record_d2h_time")
    # the flight recorder's emit path carries the same contract: it is
    # called inside other subsystems' critical sections (cluster state
    # lock, device dispatch) and must never acquire a lock.  The GC
    # pause callback (obs/aggregate.py) fires at arbitrary allocation
    # points — same rule
    _RECORDER_FNS = ("record", "observe", "observe_latency",
                     "_gc_callback")
    # the sampling profiler's timer-thread path (obs/profiler.py): the
    # fold runs beside arbitrary application code on every tick
    _PROFILER_FNS = ("_run", "_sample_once", "_fold")
    # the device ledger's put/adopt/release path (obs/device.py)
    # advertises the same lock-free contract in its module doc — this
    # list keeps it enforced, not just documented (weakref finalizers
    # especially run at arbitrary refcount drops, possibly while other
    # subsystems hold locks)
    _DEVICE_FNS = ("put", "transfer", "adopt", "retag", "_register",
                   "_release", "note_h2d", "sweep", "record_d2h")
    # the hedge tracker's evidence path (utils/hedge.py observe/
    # threshold) rides inside the coordinator's dispatch threads beside
    # spans and metrics — same contract: evidence folding must never
    # take a lock.  (The hedge BUDGET delegates to the internally-
    # locked utils/retry.TokenBucket — decision points, not evidence.)
    _HEDGE_FNS = ("observe", "threshold_s")
    # the attribution observe/apportion path (obs/attribution.py):
    # charge hooks run inside device_call dispatch, the ledger's H2D
    # seam, and abandoned hedge-attempt threads; scope publication
    # wraps whole query executions.  Lock-free is the contract that
    # makes per-client metering safe to leave always-armed — enforced
    # here, not just documented.  (Pin accrual and gauge folds are
    # scrape-path and deliberately NOT listed.)
    _ATTRIBUTION_FNS = ("charge", "charge_scope", "_entry",
                        "note_launch", "charge_h2d",
                        "charge_hedge_loss", "observe",
                        "observe_path", "observe_phases",
                        "current_scope", "current_client",
                        "client_scope", "shared_scope")
    # the cost store's observe/lookup path (cost/store.py): observations
    # arrive from scan generators, aggregate finalizers, the join build
    # path and the serving loop — some of those run inside other
    # subsystems' critical sections.  Fresh-dict publish + GIL-atomic
    # deque appends are the contract; this list enforces it.  (flush()
    # and _load() are cold persistence seams, deliberately NOT listed.)
    _COST_FNS = ("observe", "lookup", "value", "note_decision",
                 "note_replan")

    def applies(self, relpath: str) -> bool:
        p = relpath.replace(os.sep, "/")
        return p.endswith(("utils/metrics.py", "obs/stats.py",
                           "obs/recorder.py", "obs/aggregate.py",
                           "obs/slo.py", "obs/device.py",
                           "obs/profiler.py", "utils/hedge.py",
                           "obs/attribution.py", "cost/store.py"))

    def _scan(self, node, relpath, where):
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _call_name(sub)
                if name == "acquire":
                    out.append(self._finding(
                        relpath, sub,
                        f"lock acquisition in {where}: metrics/trace "
                        "callbacks run inside other subsystems' "
                        "critical sections",
                    ))
                elif name in ("Lock", "RLock", "Condition") and \
                        _call_mod_attr(sub) == ("threading", name):
                    out.append(self._finding(
                        relpath, sub,
                        f"threading.{name} in {where}: the metrics "
                        "registry and stats callbacks stay lock-free "
                        "(GIL-atomic counters only)",
                    ))
            elif isinstance(sub, ast.With):
                for item in sub.items:
                    for leaf in ast.walk(item.context_expr):
                        if isinstance(leaf, (ast.Name, ast.Attribute)):
                            ident = leaf.id if isinstance(leaf, ast.Name) \
                                else leaf.attr
                            if "lock" in ident.lower():
                                out.append(self._finding(
                                    relpath, sub,
                                    f"`with {ident}` in {where}: "
                                    "metrics/trace callbacks must not "
                                    "take locks",
                                ))
        return out

    def check(self, tree, relpath):
        p = relpath.replace(os.sep, "/")
        if p.endswith("utils/metrics.py"):
            return self._scan(tree, relpath, "utils/metrics.py")
        if p.endswith("obs/device.py"):
            wanted = self._DEVICE_FNS
        elif p.endswith("obs/profiler.py"):
            wanted = self._PROFILER_FNS
        elif p.endswith(("obs/recorder.py", "obs/aggregate.py",
                         "obs/slo.py")):
            wanted = self._RECORDER_FNS
        elif p.endswith("utils/hedge.py"):
            wanted = self._HEDGE_FNS
        elif p.endswith("obs/attribution.py"):
            wanted = self._ATTRIBUTION_FNS
        elif p.endswith("cost/store.py"):
            wanted = self._COST_FNS
        else:
            wanted = self._STATS_FNS
        out = []
        for fn in _functions_in(tree):
            if fn.name in wanted:
                out.extend(self._scan(fn, relpath, f"{fn.name}()"))
        return out


class RawDevicePut(_Rule):
    """DF006: raw host-to-device copy outside the copy seam."""

    id = "DF006"

    # the seam's own functions in exec/batch.py
    _SEAM_FNS = ("to_device", "put_compressed")
    _CTORS = ("as_tensor", "tensor", "asarray")

    def applies(self, relpath: str) -> bool:
        p = relpath.replace(os.sep, "/")
        return not p.endswith("obs/device.py")

    @staticmethod
    def _is_device(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str) and \
                node.value.startswith("cuda")
        if isinstance(node, ast.Call):
            return _call_mod_attr(node) == ("torch", "device")
        ident = node.id if isinstance(node, ast.Name) else \
            node.attr if isinstance(node, ast.Attribute) else None
        return ident is not None and "device" in ident.lower()

    def _copy(self, call: ast.Call) -> Optional[str]:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr == "cuda":
            return ".cuda()"
        device_kw = next((k.value for k in call.keywords
                          if k.arg == "device"), None)
        if f.attr == "to":
            arg = call.args[0] if call.args else device_kw
            if arg is not None and self._is_device(arg):
                return ".to(<device>)"
            return None
        if f.attr in self._CTORS and isinstance(f.value, ast.Name) and \
                f.value.id == "torch" and device_kw is not None and \
                not (isinstance(device_kw, ast.Constant)
                     and device_kw.value is None):
            return f"torch.{f.attr}(..., device=)"
        return None

    def check(self, tree, relpath):
        seam: set[int] = set()
        if relpath.replace(os.sep, "/").endswith("exec/batch.py"):
            for fn in _functions_in(tree):
                if fn.name in self._SEAM_FNS:
                    seam.update(id(c) for c in _calls_in(fn))
        out = []
        for call in _calls_in(tree):
            if id(call) in seam:
                continue
            what = self._copy(call)
            if what is not None:
                out.append(self._finding(
                    relpath, call,
                    f"{what} is a raw host-to-device copy: go through "
                    "exec/batch.to_device / put_compressed (or "
                    "LEDGER.adopt) so the copy counters, the ledger's "
                    "live bytes and the transfer profile see it",
                ))
        return out


class BlockingIoInSampler(_Rule):
    """DF007: blocking IO inside the sampling profiler's timer thread."""

    id = "DF007"

    # calls that block (or can block) the sampler's tick: file and
    # socket IO, HTTP, stdout, and explicit sleeps.  `Event.wait` is
    # the tick itself and stays allowed.
    _BLOCKING = ("open", "print", "sleep", "connect", "accept",
                 "sendall", "send", "recv", "recvfrom", "urlopen",
                 "write", "flush", "read", "readline", "dump")
    _SAMPLER_FNS = ("_run", "_sample_once", "_fold")

    def applies(self, relpath: str) -> bool:
        return relpath.replace(os.sep, "/").endswith("obs/profiler.py")

    def check(self, tree, relpath):
        out = []
        for fn in _functions_in(tree):
            if fn.name not in self._SAMPLER_FNS:
                continue
            for call in _calls_in(fn):
                name = _call_name(call)
                if name in self._BLOCKING:
                    out.append(self._finding(
                        relpath, call,
                        f"{name}() in sampler-thread {fn.name}(): the "
                        "sampler must never block — it skews every "
                        "profile it takes; render/persist on the "
                        "caller's thread at report time",
                    ))
        return out


class BlockingDiskIoUnderLock(_Rule):
    """DF008: blocking disk IO while a lock is (or may be) held."""

    id = "DF008"

    # disk-touching os.* calls that block on the filesystem
    _OS_DISK = ("fsync", "fdatasync", "rename", "replace", "truncate",
                "unlink", "remove", "makedirs", "rmdir", "listdir",
                "scandir", "stat")
    # repo-local disk-IO entry points: the WAL seams.  Calling one of
    # these under a held lock is exactly the bug this rule exists for —
    # a slow fsync would extend the cluster apply critical section to
    # disk latency, stalling every reader behind a write
    _WAL_ENTRY = ("atomic_write_json", "write_snapshot",
                  "note_deadlines", "_wal_sync", "_wal_snapshot",
                  "_wal_persist_best_effort", "_save_pin_manifest")

    def applies(self, relpath: str) -> bool:
        p = relpath.replace(os.sep, "/")
        if p.endswith("utils/wal.py"):
            # the reviewed disk-IO boundary: wal.py owns held-lock disk
            # writes by design (its module doc states the contract, and
            # it announces itself via lockcheck.note_blocking before
            # every acquire).  Everything else routes through it.
            return False
        if "datafusion_tpu_torch/cluster/" in p or p.startswith("cluster/"):
            return True
        if p.endswith("serve.py"):
            return True
        # DF005-covered lock-free callback surfaces: disk IO there is
        # as bad as a lock — they run inside other subsystems' critical
        # sections, so a blocking write inherits every caller's lock
        return LockInMetricsCallback().applies(relpath)

    def _disk_call(self, call: ast.Call) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name) and f.id == "open":
            return "open"
        ma = _call_mod_attr(call)
        if ma is not None and ma[0] == "os" and ma[1] in self._OS_DISK:
            return f"os.{ma[1]}"
        name = _call_name(call)
        if name in ("fsync", "fdatasync"):
            return f"{name}"
        if name in self._WAL_ENTRY:
            return f"{name}"
        return None

    def _lockfree_fns(self, p: str) -> tuple[str, ...]:
        df5 = LockInMetricsCallback
        if p.endswith("obs/device.py"):
            return df5._DEVICE_FNS
        if p.endswith("obs/profiler.py"):
            return df5._PROFILER_FNS
        if p.endswith(("obs/recorder.py", "obs/aggregate.py",
                       "obs/slo.py")):
            return df5._RECORDER_FNS
        if p.endswith("utils/hedge.py"):
            return df5._HEDGE_FNS
        if p.endswith("obs/attribution.py"):
            return df5._ATTRIBUTION_FNS
        if p.endswith("obs/stats.py"):
            return df5._STATS_FNS
        if p.endswith("cost/store.py"):
            # the cost observe path is DF005 lock-free AND disk-free:
            # persistence happens only in flush()/_load() (cold seams)
            return df5._COST_FNS
        return ()

    def check(self, tree, relpath):
        p = relpath.replace(os.sep, "/")
        out = []
        lockfree = self._lockfree_fns(p)
        if lockfree or p.endswith("utils/metrics.py"):
            # lock-free callback surface: ALL disk IO is banned, not
            # just disk IO under an explicit `with lock`
            for fn in _functions_in(tree):
                if p.endswith("utils/metrics.py") or fn.name in lockfree:
                    for call in _calls_in(fn):
                        name = self._disk_call(call)
                        if name is not None:
                            out.append(self._finding(
                                relpath, call,
                                f"{name}() in lock-free {fn.name}(): "
                                "this callback runs inside other "
                                "subsystems' critical sections — disk "
                                "IO here inherits every caller's lock",
                            ))
            return out
        # control-plane files: disk IO lexically inside a held-lock
        # `with` block (DF005's ident heuristic: any context expr
        # mentioning "lock").  WAL appends must copy state under the
        # lock, release it, then write — never write while holding it
        for sub in ast.walk(tree):
            if not isinstance(sub, ast.With):
                continue
            held = None
            for item in sub.items:
                for leaf in ast.walk(item.context_expr):
                    if isinstance(leaf, (ast.Name, ast.Attribute)):
                        ident = leaf.id if isinstance(leaf, ast.Name) \
                            else leaf.attr
                        if "lock" in ident.lower():
                            held = ident
            if held is None:
                continue
            for stmt in sub.body:
                for call in _calls_in(stmt):
                    name = self._disk_call(call)
                    if name is not None:
                        out.append(self._finding(
                            relpath, call,
                            f"{name}() while holding `{held}`: copy "
                            "state under the lock, release it, then "
                            "touch disk — a slow fsync must never "
                            "extend a critical section",
                        ))
        return out


RULES: list[_Rule] = [
    HostSyncInDispatch(),
    NondeterminismInReplayable(),
    UnguardedIoBoundary(),
    SwallowedBroadExcept(),
    LockInMetricsCallback(),
    RawDevicePut(),
    BlockingIoInSampler(),
    BlockingDiskIoUnderLock(),
]


def _suppressed(line_text: str, rule_id: str) -> bool:
    m = _SUPPRESS.search(line_text)
    if m is not None:
        ids = m.group(1)
        if ids is None or rule_id in ids:
            return True
    if rule_id == "DF004" and _NOQA_BLE.search(line_text):
        return True
    return False


def lint_source(source: str, relpath: str,
                rules: Optional[list[_Rule]] = None) -> list[Finding]:
    """Lint one file's source text; returns the unsuppressed findings."""
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding("DF000", relpath, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    lines = source.splitlines()
    out: list[Finding] = []
    for rule in (RULES if rules is None else rules):
        if not rule.applies(relpath):
            continue
        for f in rule.check(tree, relpath):
            text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
            if not _suppressed(text, f.rule):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def iter_py_files(paths: Iterable[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(paths: Iterable[str],
               rules: Optional[list[_Rule]] = None) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), path, rules))
    return findings
