"""The debug HTTP plane: one opt-in server per node with every
observability surface behind it (the JAX package's `obs/httpd.py`,
with its routes, documents and bundle members).

====================  =================================================
``/debug/metrics``    Prometheus text (alias ``/metrics``)
``/debug/flights``    the flight ring as JSON (``?trace_id=`` filters)
``/debug/hbm``        the device ledger: buffers by owner and device,
                      pins
``/debug/serve``      the serving front door: admission counters, pins,
                      megabatches, ``serve.latency``
``/debug/ingest``     appendable tables, views, freshness lags
``/debug/cost``       the cost store: observations, decisions, replans
``/debug/tenants``    per-client metering and its conservation check
``/debug/qos``        shares, attained service, the scale hint
``/debug/tail``       the tail explainer (``?window_s=``)
``/debug/top``        the ``top`` view (fleet-wide on a coordinator)
``/debug/profile``    a host profile (``?seconds=N&hz=&format=``),
                      `obs/profiler.capture_seconds`
``/debug/bundle``     ONE artifact of all of the above plus the
                      configuration (``?format=tar`` streams the raw
                      ring, spans and profile as tar members)
``/status``           node status JSON (also ``/healthz``)
====================  =================================================

Off by default: a port of 0 (or None) starts nothing; a negative port
binds an ephemeral one (tests and smoke scripts read ``.port`` back), as
in the JAX package.  The plane binds loopback unless
``DATAFUSION_TPU_DEBUG_BIND`` says otherwise, and with
``DATAFUSION_TPU_DEBUG_TOKEN`` set every request but ``/status`` and
``/healthz`` needs ``Authorization: Bearer <token>``.  Handlers are
read-only; a broken provider answers 500 and never stops the plane.
`config_snapshot` reports torch's version, the CUDA version and each
CUDA device's name.  `build_bundle` and `write_local_bundle` also work
in-process with no server, and `run_with_ci_bundle` writes one under
``DATAFUSION_TPU_CI_BUNDLE_DIR`` when a smoke entry point fails.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from datafusion_tpu_torch.utils.metrics import METRICS

_BUNDLE_PROFILE_S_DEFAULT = 0.5
_PROFILE_S_CAP = 60.0
_BUNDLE_PROFILE_S_CAP = 10.0


def _node_label() -> str:
    from datafusion_tpu_torch.obs import trace

    return f"{trace._ROLE}:{os.getpid()}"


def _local_top_text() -> str:
    """The local-node ``top`` view (a coordinator passes its own
    fleet-wide ``top_text`` instead)."""
    from datafusion_tpu_torch.obs import slo
    from datafusion_tpu_torch.obs.aggregate import FleetAggregator

    rows = slo.WATCHDOG.evaluate() if slo.WATCHDOG.armed() else None
    return FleetAggregator().top_text(slo_rows=rows)


def config_snapshot() -> dict:
    """The node's effective configuration for the bundle: every
    ``DATAFUSION_TPU_*`` knob, the process identity, and the device
    inventory: torch's version, the CUDA version and each CUDA device's
    name (none without CUDA: ``backend`` then reads ``cpu``)."""
    env = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith("DATAFUSION_TPU_")
    }
    import sys

    out = {
        "node": _node_label(),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
        "env": env,
    }
    import torch

    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        out["backend"] = "cuda"
        out["device_count"] = torch.cuda.device_count()
        out["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
    else:
        out["backend"] = "cpu"
        out["device_count"] = 0
        out["devices"] = []
    return out


def build_bundle(*, label: Optional[str] = None,
                 gauges_fn: Optional[Callable[[], dict]] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 profile_seconds: float = _BUNDLE_PROFILE_S_DEFAULT,
                 trace_id: Optional[str] = None) -> dict:
    """The one-stop debug artifact (see module doc).  ``profile_seconds``
    > 0 captures a fresh host profile (bounded)."""
    from datafusion_tpu_torch.obs import device as _device
    from datafusion_tpu_torch.obs import profiler, recorder, slo
    from datafusion_tpu_torch.obs.aggregate import refresh_host_gauges
    from datafusion_tpu_torch.obs.device import LEDGER
    from datafusion_tpu_torch.obs.export import prometheus_text

    refresh_host_gauges()
    gauges = {}
    if gauges_fn is not None:
        try:
            gauges = dict(gauges_fn() or {})
        except Exception:  # noqa: BLE001 — a broken provider must not block the bundle
            METRICS.add("obs.debug_provider_errors")
    doc: dict = {
        "type": "debug_bundle",
        "node": label or _node_label(),
        "recorded_at_ns": time.time_ns(),
        "config": config_snapshot(),
        "metrics": prometheus_text(METRICS, extra_gauges=gauges),
        "gauges": gauges,
        "flights": {
            "events_emitted": recorder.emitted(),
            "events": recorder.events(trace_id=trace_id),
        },
        "hbm": (
            {"enabled": True, **LEDGER.snapshot()}
            if _device.enabled() else {"enabled": False}
        ),
        "slo": slo.WATCHDOG.evaluate() if slo.WATCHDOG.armed() else [],
    }
    try:
        from datafusion_tpu_torch import cost as _cost

        # the cost subsystem's learned statistics + recent decisions:
        # lets a bundle answer "WHY did the planner pick that route"
        doc["cost"] = _cost.store().snapshot()
    except Exception:  # noqa: BLE001 — a broken provider must not block the bundle
        METRICS.add("obs.debug_provider_errors")
    try:
        from datafusion_tpu_torch.utils import wal as _wal
        wal_manifests = _wal.active_manifests()
    except Exception:  # noqa: BLE001 — durability info is best-effort in a bundle
        wal_manifests = []
    if wal_manifests:
        doc["wal"] = wal_manifests
    if status_fn is not None:
        try:
            doc["status"] = status_fn()
        except Exception:  # noqa: BLE001 — a broken provider must not block the bundle
            METRICS.add("obs.debug_provider_errors")
    seconds = min(max(float(profile_seconds), 0.0), _BUNDLE_PROFILE_S_CAP)
    if seconds > 0:
        doc["profile"] = profiler.capture_seconds(
            seconds, name="bundle"
        ).to_json()
    cont = profiler.continuous_report()
    if cont is not None:
        doc["profile_continuous"] = cont.to_json()
    METRICS.add("obs.debug_bundles")
    return doc


def build_bundle_tar(*, label: Optional[str] = None,
                     gauges_fn: Optional[Callable[[], dict]] = None,
                     status_fn: Optional[Callable[[], dict]] = None,
                     profile_seconds: float = _BUNDLE_PROFILE_S_DEFAULT,
                     trace_id: Optional[str] = None) -> bytes:
    """The bundle as a TAR stream (``/debug/bundle?format=tar``): raw
    span/ring/profile attachments ship as their own members instead of
    being inlined into one giant JSON document — on a very large fleet
    the ring alone can run to tens of MB per node, and members stream,
    diff, and grep where a monolithic JSON blob only loads.

    Members: ``bundle.json`` (the core document, heavy attachments
    replaced by member references), ``flights.jsonl`` (one flight
    event per line), ``spans.jsonl`` (the raw span buffer, one span
    per line), ``metrics.prom`` (the Prometheus exposition),
    ``profile.json`` / ``profile_continuous.json`` (host profiles),
    ``tenants.json`` (per-client metering), ``tail.json`` (the tail
    explainer report)."""
    import io
    import tarfile

    from datafusion_tpu_torch.obs import attribution
    from datafusion_tpu_torch.obs import trace as obs_trace

    doc = build_bundle(label=label, gauges_fn=gauges_fn,
                       status_fn=status_fn,
                       profile_seconds=profile_seconds,
                       trace_id=trace_id)
    members: dict[str, bytes] = {}
    flights = doc.pop("flights", {}) or {}
    members["flights.jsonl"] = "\n".join(
        json.dumps(e, default=str) for e in flights.get("events", [])
    ).encode()
    members["metrics.prom"] = str(doc.pop("metrics", "")).encode()
    members["spans.jsonl"] = "\n".join(
        json.dumps(s, default=str) for s in obs_trace.spans(trace_id)
    ).encode()
    for key, name in (("profile", "profile.json"),
                      ("profile_continuous", "profile_continuous.json")):
        attachment = doc.pop(key, None)
        if attachment is not None:
            members[name] = json.dumps(attachment, default=str).encode()
    members["tenants.json"] = json.dumps(
        attribution.tenants_snapshot(), default=str).encode()
    members["tail.json"] = json.dumps(
        attribution.EXPLAINER.explain(), default=str).encode()
    doc["flights"] = {"events_emitted": flights.get("events_emitted"),
                      "member": "flights.jsonl"}
    doc["attachments"] = sorted(members)
    members["bundle.json"] = json.dumps(doc, default=str).encode()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        now = int(time.time())
        for name in sorted(members):
            info = tarfile.TarInfo(name=name)
            info.size = len(members[name])
            info.mtime = now
            tf.addfile(info, io.BytesIO(members[name]))
    return buf.getvalue()


def write_local_bundle(directory: str, reason: str = "manual",
                       profile_seconds: float = _BUNDLE_PROFILE_S_DEFAULT,
                       ) -> str:
    """Build this process's bundle and write it under ``directory`` —
    the CI smoketests call this on failure so the run leaves a debug
    artifact behind.  Returns the written path."""
    os.makedirs(directory, exist_ok=True)
    doc = build_bundle(profile_seconds=profile_seconds)
    doc["reason"] = reason
    path = os.path.join(
        directory,
        f"bundle-{doc['node'].replace(':', '-')}-{time.time_ns()}.json",
    )
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    return path


def run_with_ci_bundle(fn: Callable[[], int], reason: str) -> int:
    """Run a smoketest entry point; on ANY failure, write this
    process's debug bundle under ``$DATAFUSION_TPU_CI_BUNDLE_DIR``
    (when set — the CI workflow uploads that directory as a failure
    artifact) before re-raising.  The bundle never masks the original
    failure."""
    try:
        return fn()
    except BaseException:
        ci_dir = os.environ.get("DATAFUSION_TPU_CI_BUNDLE_DIR")
        if ci_dir:
            try:
                import sys

                path = write_local_bundle(ci_dir, reason)
                print(f"smoke failed; debug bundle: {path}",
                      file=sys.stderr, flush=True)
            except Exception:  # noqa: BLE001 — the original failure must surface
                pass
        raise


_INDEX = """datafusion-tpu debug plane ({label})

GET /debug/metrics            Prometheus text exposition (alias /metrics)
GET /debug/flights[?trace_id=]  flight-recorder ring dump (JSON)
GET /debug/hbm                HBM residency ledger breakdown (JSON)
GET /debug/serve              serving front door: admission counters,
                              pinned tables, megabatch stats (JSON)
GET /debug/ingest             streaming ingest: appendable tables,
                              materialized views, freshness lags (JSON)
GET /debug/cost               cost store: learned statistics + recent
                              planner decisions / replans (JSON)
GET /debug/tenants            per-client metering: device-seconds,
                              H2D bytes, pin byte-seconds, hedge
                              duplicates + conservation check (JSON)
GET /debug/qos                multi-tenant QoS: shares, attained
                              service, shed policy, scale hint (JSON)
GET /debug/tail[?window_s=N]  tail explainer: per-segment p50/p95/p99
                              contributions, ranked (JSON)
GET /debug/top                fleet/local top view (text)
GET /debug/profile?seconds=N[&hz=H&format=speedscope|collapsed|json]
GET /debug/bundle[?seconds=N&trace_id=&format=tar]  one artifact:
                              everything above (format=tar streams raw
                              span/ring/profile attachments as members)
GET /status | /healthz        node status (JSON)

Auth: when DATAFUSION_TPU_DEBUG_TOKEN is set, every /debug/* and
/metrics request needs "Authorization: Bearer <token>" (constant-time
compared); /status and /healthz stay open for probes.
"""


def debug_bind_host(requested: Optional[str] = None) -> str:
    """Where the debug plane binds: LOOPBACK unless the operator opts
    out (``DATAFUSION_TPU_DEBUG_BIND``, e.g. ``0.0.0.0`` inside a
    container whose port mapping is the boundary).  A worker bound to a
    routable interface must NOT drag its diagnostics port onto it by
    default — the plane serves profiles, env vars, and flight rings."""
    env = os.environ.get("DATAFUSION_TPU_DEBUG_BIND", "").strip()
    if env:
        return env
    if requested in (None, "", "localhost", "127.0.0.1", "::1"):
        return requested or "127.0.0.1"
    return "127.0.0.1"


def debug_token() -> Optional[str]:
    """The bearer token guarding /debug/* (None = auth off — fine on
    loopback, mandatory hygiene anywhere else)."""
    return os.environ.get("DATAFUSION_TPU_DEBUG_TOKEN") or None


def _authorized(headers: dict, token: Optional[str]) -> bool:
    """Constant-time bearer check (`hmac.compare_digest` — a scrape
    must not be able to binary-search the token by response timing)."""
    if token is None:
        return True
    import hmac

    supplied = headers.get("authorization", "")
    if supplied.lower().startswith("bearer "):
        supplied = supplied[7:].strip()
    return hmac.compare_digest(supplied.encode("utf-8"),
                               token.encode("utf-8"))


# paths every probe may hit without a token, even when auth is armed
_OPEN_PATHS = frozenset(("/status", "/healthz"))


def _json_body(obj, code: int = 200):
    return code, "application/json", json.dumps(obj, default=str).encode()


def _text_body(text: str, code: int = 200):
    return code, "text/plain; charset=utf-8", text.encode()


def _route_request(srv: "DebugServer", path: str, q: dict):
    """One debug route -> ``(code, content_type, body)``; transport-
    independent so tests can drive it in-process."""
    if path in ("/", "/debug"):
        return _text_body(_INDEX.format(label=srv.label))
    if path in ("/debug/metrics", "/metrics"):
        from datafusion_tpu_torch.obs import attribution
        from datafusion_tpu_torch.obs.aggregate import refresh_host_gauges
        from datafusion_tpu_torch.obs.export import prometheus_text

        refresh_host_gauges()
        attribution.refresh_tenant_gauges()
        return (200, "text/plain; version=0.0.4",
                prometheus_text(METRICS, extra_gauges=srv.gauges()).encode())
    if path == "/debug/flights":
        from datafusion_tpu_torch.obs import recorder

        return _json_body({
            "node": srv.label,
            "events_emitted": recorder.emitted(),
            "events": recorder.events(trace_id=q.get("trace_id") or None),
        })
    if path == "/debug/hbm":
        from datafusion_tpu_torch.obs import device as _device
        from datafusion_tpu_torch.obs.device import LEDGER

        if _device.enabled():
            return _json_body({"enabled": True, **LEDGER.snapshot()})
        return _json_body({"enabled": False})
    if path == "/debug/serve":
        from datafusion_tpu_torch.obs.aggregate import HISTOGRAMS
        from datafusion_tpu_torch.obs.device import LEDGER

        counts = METRICS.snapshot()["counts"]
        h = HISTOGRAMS.get("serve.latency")
        return _json_body({
            "node": srv.label,
            "queries_admitted": counts.get("queries_admitted", 0),
            "queries_queued": counts.get("queries_queued", 0),
            "queries_shed": counts.get("queries_shed", 0),
            "megabatch_launches": counts.get(
                "serve.megabatch_launches", 0),
            "megabatch_queries": counts.get(
                "serve.megabatch_queries", 0),
            "tables_pinned": counts.get("serve.tables_pinned", 0),
            "tables_evicted": counts.get("serve.tables_evicted", 0),
            "pin_evictions": counts.get("device.pin_evictions", 0),
            "pinned_bytes": LEDGER.pinned_bytes(),
            "pins": LEDGER.pins_snapshot(),
            "latency": None if h is None else {
                "count": h.count,
                "p50_s": h.quantile(0.5),
                "p99_s": h.quantile(0.99),
            },
        })
    if path == "/debug/ingest":
        from datafusion_tpu_torch import ingest

        return _json_body({"node": srv.label, **ingest.debug_snapshot()})
    if path == "/debug/cost":
        from datafusion_tpu_torch import cost as _cost

        return _json_body({
            "node": srv.label,
            "enabled": _cost.enabled(),
            **_cost.store().snapshot(),
        })
    if path == "/debug/tenants":
        from datafusion_tpu_torch.obs import attribution

        return _json_body({
            "node": srv.label,
            **attribution.tenants_snapshot(),
        })
    if path == "/debug/qos":
        from datafusion_tpu_torch import qos

        return _json_body({"node": srv.label, **qos.debug_snapshot()})
    if path == "/debug/tail":
        from datafusion_tpu_torch.obs import attribution

        window = float(q["window_s"]) if q.get("window_s") else None
        return _json_body({
            "node": srv.label,
            **attribution.EXPLAINER.explain(window),
        })
    if path == "/debug/top":
        return _text_body(srv.top())
    if path == "/debug/profile":
        from datafusion_tpu_torch.obs import profiler

        seconds = min(max(float(q.get("seconds", 1.0)), 0.0), _PROFILE_S_CAP)
        hz = float(q["hz"]) if q.get("hz") else None
        # the capture sleeps on the EXECUTOR thread — the selector keeps
        # serving scrapes and parked connections meanwhile
        rep = profiler.capture_seconds(seconds, hz=hz, name="/debug/profile")
        fmt = q.get("format", "speedscope")
        if fmt == "collapsed":
            return _text_body(rep.collapsed())
        if fmt == "json":
            return _json_body(rep.to_json())
        return _json_body(rep.speedscope())
    if path == "/debug/bundle":
        if q.get("format") == "tar":
            return (200, "application/x-tar", build_bundle_tar(
                label=srv.label,
                gauges_fn=srv.gauges,
                status_fn=srv.status_fn,
                profile_seconds=float(
                    q.get("seconds", _BUNDLE_PROFILE_S_DEFAULT)),
                trace_id=q.get("trace_id") or None,
            ))
        return _json_body(build_bundle(
            label=srv.label,
            gauges_fn=srv.gauges,
            status_fn=srv.status_fn,
            profile_seconds=float(q.get("seconds", _BUNDLE_PROFILE_S_DEFAULT)),
            trace_id=q.get("trace_id") or None,
        ))
    if path in ("/status", "/healthz", "/debug/status"):
        return _json_body(srv.status())
    return _json_body({"error": f"unknown path {path}"}, 404)


class DebugServer:
    """One node's debug plane, on its own selector event loop: idle
    scrape keep-alives and slow readers cost file descriptors, not
    threads (only route handlers occupy the small executor pool, and
    only while computing).  Providers are injected so the same server
    runs on a worker (worker-state status/gauges) and a coordinator
    (fleet-aggregated gauges + fleet top):

    - ``gauges_fn``: extra point-in-time gauges for the scrape;
    - ``status_fn``: the ``/status`` JSON (defaults to a minimal
      uptime/label document);
    - ``top_fn``: the ``/debug/top`` text (defaults to the local-node
      fleet view).

    Hardening: binds loopback by default (`debug_bind_host`), and when
    ``DATAFUSION_TPU_DEBUG_TOKEN`` is set every ``/debug/*`` and
    ``/metrics`` request must carry the bearer token
    (constant-time-compared; ``/status``/``/healthz`` stay open for
    liveness probes)."""

    def __init__(self, port: int, host: str = "127.0.0.1", *,
                 label: Optional[str] = None,
                 gauges_fn: Optional[Callable[[], dict]] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 top_fn: Optional[Callable[[], str]] = None):
        from datafusion_tpu_torch.utils.eventloop import (
            HttpConnection,
            ServerLoop,
        )

        self.label = label or _node_label()
        self.gauges_fn = gauges_fn
        self.status_fn = status_fn
        self.top_fn = top_fn
        self.started = time.time()
        self._token = debug_token()
        self._loop = ServerLoop(name="df-torch-debug")
        self._lsock = self._loop.listen(
            host, int(port),
            lambda lp, sock, a: HttpConnection(lp, sock, a, self._handle),
        )
        self._thread = threading.Thread(
            target=self._loop.run, name="df-torch-debug-http", daemon=True,
        )
        self._thread.start()

    # -- providers (handler-facing) -----------------------------------
    def gauges(self) -> dict:
        if self.gauges_fn is None:
            return {}
        return self.gauges_fn() or {}

    def top(self) -> str:
        if self.top_fn is not None:
            return self.top_fn()
        return _local_top_text()

    def status(self) -> dict:
        if self.status_fn is not None:
            return self.status_fn()
        return {
            "type": "status",
            "node": self.label,
            "uptime_s": round(time.time() - self.started, 1),
        }

    def _handle(self, method: str, path: str, q: dict, headers: dict):
        # executor thread; HttpConnection turns an escape into a 500
        if path not in _OPEN_PATHS and not _authorized(headers, self._token):
            METRICS.add("obs.debug_auth_rejections")
            return _json_body(
                {"error": "missing or invalid bearer token "
                          "(DATAFUSION_TPU_DEBUG_TOKEN is set)"},
                401,
            )
        try:
            return _route_request(self, path, q)
        except Exception as e:  # noqa: BLE001 — one bad request must not kill the plane
            METRICS.add("obs.debug_request_errors")
            return _json_body({"error": f"{type(e).__name__}: {e}"}, 500)

    # -- address / lifecycle ------------------------------------------
    @property
    def server_address(self):  # backcompat with the old HTTP status shim
        return self._lsock.getsockname()

    @property
    def port(self) -> int:
        return int(self.server_address[1])

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def shutdown(self) -> None:  # backcompat alias
        self._loop.stop()
        self._loop.wait_stopped()

    def close(self) -> None:
        self.shutdown()
        self._loop.close()


def start_debug_server(port: Optional[int], host: str = "127.0.0.1",
                       **providers) -> Optional[DebugServer]:
    """Start the debug plane when ``port`` is configured (0/None =
    off — the documented default; a NEGATIVE port binds an ephemeral
    one, for tests and smoke harnesses that read ``.port`` back).
    Bind failures are reported, not fatal: a node without its debug
    port is degraded, not down."""
    if not port:
        return None
    try:
        return DebugServer(max(int(port), 0), debug_bind_host(host),
                           **providers)
    except OSError:
        METRICS.add("obs.debug_server_errors")
        return None
