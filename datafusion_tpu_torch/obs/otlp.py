"""OTLP/JSON span exporter, standard library only (the JAX package's
`obs/otlp.py`, with its documents byte for byte).

`spans_to_otlp` turns the engine's span dicts (obs/trace.py, local or
ingested from workers, any mix) into an OpenTelemetry
``ExportTraceServiceRequest``: each span ``proc`` becomes one
``resourceSpans`` entry whose resource carries ``service.name`` (the
role) and ``service.instance.id`` (role:pid), so coordinator and worker
spans stitch into one distributed trace in any OTLP backend.
`otlp_to_spans` is its inverse.

Targets:

- `write_otlp(path, spans)`: a JSON file;
- `post_otlp(endpoint, spans)`: an HTTP POST of the document
  (``urllib.request``; collectors listen on ``/v1/traces``),
  gzip-compressed unless ``DATAFUSION_TPU_OTLP_GZIP=0``.

`export_spans(spans)` routes one query's spans to whichever of
``DATAFUSION_TPU_OTLP_FILE`` (one document a line, appended) and
``DATAFUSION_TPU_OTLP_ENDPOINT`` is set.  The endpoint route batches:
spans queue, and one POST ships every queued query once the batch
reaches ``DATAFUSION_TPU_OTLP_BATCH_SPANS`` spans (512) or the flush
interval ``DATAFUSION_TPU_OTLP_FLUSH_S`` (2 s, armed by a daemon timer at
the first enqueue) passes; ``DATAFUSION_TPU_OTLP_FLUSH_S=0`` posts once a
query.  `flush()` ships the pending batch (also at exit).  Export never
raises into a query: failures count in ``obs.otlp_errors``.
"""

from __future__ import annotations

import atexit as _atexit
import gzip as _gzip
import json
import os
import threading
from typing import Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.utils.metrics import METRICS

# the JAX package's scope and service names: one collector sees both
# packages' spans under the same schema
_SCOPE = {"name": "datafusion_tpu", "version": "1"}
# OTLP ids are fixed-width lowercase hex: 16 bytes trace, 8 bytes span
_TRACE_ID_HEX = 32
_SPAN_ID_HEX = 16


def _pad_id(raw: Optional[str], width: int) -> str:
    s = "".join(c for c in str(raw or "") if c in "0123456789abcdef")
    return s[:width].rjust(width, "0")


def _attr_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP/JSON carries int64 as a string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attr_list(attrs: dict) -> list[dict]:
    return [{"key": str(k), "value": _attr_value(v)} for k, v in attrs.items()]


def _attr_dict(kvs) -> dict:
    out = {}
    for kv in kvs or ():
        val = kv.get("value") or {}
        if "boolValue" in val:
            v = bool(val["boolValue"])
        elif "intValue" in val:
            v = int(val["intValue"])
        elif "doubleValue" in val:
            v = float(val["doubleValue"])
        else:
            v = val.get("stringValue", "")
        out[kv.get("key", "")] = v
    return out


def spans_to_otlp(span_dicts: list[dict]) -> dict:
    """Span dicts -> OTLP/JSON ExportTraceServiceRequest."""
    by_proc: dict[str, list[dict]] = {}
    for sp in span_dicts:
        by_proc.setdefault(str(sp.get("proc", "?")), []).append(sp)
    resource_spans = []
    for proc in sorted(by_proc):
        role = proc.split(":", 1)[0]
        otlp_spans = []
        for sp in by_proc[proc]:
            out = {
                "traceId": _pad_id(sp.get("trace_id"), _TRACE_ID_HEX),
                "spanId": _pad_id(sp.get("span_id"), _SPAN_ID_HEX),
                "name": sp.get("name", "?"),
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(sp.get("start_ns", 0))),
                "endTimeUnixNano": str(int(sp.get("end_ns", 0))),
            }
            if sp.get("parent_id"):
                out["parentSpanId"] = _pad_id(sp["parent_id"], _SPAN_ID_HEX)
            attrs = dict(sp.get("attrs") or {})
            # the thread id rides as an attribute (OTLP has no tid slot)
            if sp.get("tid"):
                attrs["thread.id"] = int(sp["tid"])
            if attrs:
                out["attributes"] = _attr_list(attrs)
            otlp_spans.append(out)
        resource_spans.append({
            "resource": {"attributes": _attr_list({
                "service.name": f"{_SCOPE['name']}.{role}",
                "service.instance.id": proc,
            })},
            "scopeSpans": [{"scope": dict(_SCOPE), "spans": otlp_spans}],
        })
    return {"resourceSpans": resource_spans}


def otlp_to_spans(doc: dict) -> list[dict]:
    """Inverse of `spans_to_otlp` (ids come back in OTLP's padded width)."""
    out = []
    for rs in doc.get("resourceSpans", ()):
        res_attrs = _attr_dict((rs.get("resource") or {}).get("attributes"))
        proc = str(res_attrs.get("service.instance.id", "?"))
        for ss in rs.get("scopeSpans", ()):
            for sp in ss.get("spans", ()):
                attrs = _attr_dict(sp.get("attributes"))
                tid = int(attrs.pop("thread.id", 0))
                out.append({
                    "name": sp.get("name", "?"),
                    "trace_id": sp.get("traceId", ""),
                    "span_id": sp.get("spanId", ""),
                    "parent_id": sp.get("parentSpanId") or None,
                    "start_ns": int(sp.get("startTimeUnixNano", 0)),
                    "end_ns": int(sp.get("endTimeUnixNano", 0)),
                    "attrs": attrs,
                    "tid": tid,
                    "proc": proc,
                })
    return out


def write_otlp(path: str, span_dicts: list[dict]) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spans_to_otlp(span_dicts), f)
    METRICS.add("obs.otlp_exported", len(span_dicts))
    return path


def _gzip_enabled() -> bool:
    return os.environ.get("DATAFUSION_TPU_OTLP_GZIP", "1") != "0"


def _flush_interval_s() -> float:
    return float(os.environ.get("DATAFUSION_TPU_OTLP_FLUSH_S", "2") or 2)


def _batch_spans() -> int:
    return int(os.environ.get("DATAFUSION_TPU_OTLP_BATCH_SPANS", "512") or 512)


def post_otlp(endpoint: str, span_dicts: list[dict], timeout_s: float = 5.0,
              compress: Optional[bool] = None) -> int:
    """POST the OTLP/JSON document to `endpoint`; returns the HTTP
    status.  gzip with ``Content-Encoding: gzip`` unless `compress`
    (default: ``DATAFUSION_TPU_OTLP_GZIP``) is false.  Raises on a
    transport error; query paths go through `export_spans`."""
    import urllib.request

    body = json.dumps(spans_to_otlp(span_dicts)).encode("utf-8")
    headers = {"Content-Type": "application/json"}
    if _gzip_enabled() if compress is None else compress:
        body = _gzip.compress(body)
        headers["Content-Encoding"] = "gzip"
    req = urllib.request.Request(endpoint, data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:  # noqa: S310 — operator-configured endpoint
        status = int(getattr(resp, "status", 200))
    METRICS.add("obs.otlp_exported", len(span_dicts))
    return status


# -- batching to the endpoint ---------------------------------------------
_pending: list[dict] = []
_pending_lock = lockcheck.make_lock("obs.otlp_pending")
_flush_timer: Optional[threading.Timer] = None


def pending() -> int:
    """Spans queued for the next batched POST."""
    return len(_pending)


def flush() -> Optional[int]:
    """Ship the pending batch to ``DATAFUSION_TPU_OTLP_ENDPOINT`` in ONE
    POST.  Returns the HTTP status, or None when nothing was pending or
    the POST failed (or the endpoint was unset since the spans queued:
    lost, counted in ``obs.otlp_errors``)."""
    global _flush_timer
    with _pending_lock:
        batch = list(_pending)
        _pending.clear()
        if _flush_timer is not None:
            _flush_timer.cancel()
            _flush_timer = None
    if not batch:
        return None
    endpoint = os.environ.get("DATAFUSION_TPU_OTLP_ENDPOINT")
    if not endpoint:
        METRICS.add("obs.otlp_errors")
        return None
    try:
        status = post_otlp(endpoint, batch)
    except Exception:  # noqa: BLE001 — export is best-effort by contract
        METRICS.add("obs.otlp_errors")
        return None
    METRICS.add("obs.otlp_batches")
    return status


def _enqueue(span_dicts: list[dict]) -> int:
    """Queue one query's spans; arm the flush timer at the first, flush
    inline at the batch size.  Returns the spans now pending (0: an
    overflow flush just shipped them)."""
    global _flush_timer
    overflow = False
    with _pending_lock:
        _pending.extend(span_dicts)
        n = len(_pending)
        if n >= _batch_spans():
            overflow = True
        elif _flush_timer is None:
            t = threading.Timer(_flush_interval_s(), flush)
            t.daemon = True
            t.start()
            _flush_timer = t
    if overflow:
        flush()
        return 0
    return n


_atexit.register(flush)  # the trailing batch ships at interpreter exit


def export_spans(span_dicts: list[dict]) -> Optional[str]:
    """Export one query's spans to the configured targets (module
    docstring).  Returns where they went, or None when no target is set
    or the export failed (counted, never raised)."""
    if not span_dicts:
        return None
    where = []
    path = os.environ.get("DATAFUSION_TPU_OTLP_FILE")
    endpoint = os.environ.get("DATAFUSION_TPU_OTLP_ENDPOINT")
    if not path and not endpoint:
        return None
    try:
        if path:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(spans_to_otlp(span_dicts)) + "\n")
            METRICS.add("obs.otlp_exported", len(span_dicts))
            where.append(path)
        if endpoint:
            if _flush_interval_s() <= 0:
                post_otlp(endpoint, span_dicts)
                where.append(endpoint)
            else:
                n = _enqueue(span_dicts)
                where.append(f"{endpoint} (batched, {n} pending)")
    except Exception:  # noqa: BLE001 — export is best-effort by contract
        METRICS.add("obs.otlp_errors")
        return None
    return ", ".join(where)
