"""PyTorch/CUDA port, slice 16: the debug HTTP plane
(`datafusion_tpu_torch/obs/httpd.py` over `utils/eventloop.HttpConnection`)
against the JAX package's.

`start_debug_server(-1)` (an ephemeral port; 0 is off, as in the JAX
package) on a process that ran a query on `ExecutionContext(device="cpu")`:
every route answers 200 with a body that parses, the bearer token guards
everything but `/status` and `/healthz`, the bundle's tar stream has the
JAX package's member names, keep-alive serves two requests on one
socket, `/debug/qos` carries the scale hint, the configuration names
torch and no JAX platform, and a smoke entry point that fails leaves a
bundle behind.
"""

from __future__ import annotations

import io
import json
import os
import socket
import tarfile
import urllib.error
import urllib.request

import numpy as np
import pytest

from datafusion_tpu.obs import httpd as jhttpd

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.obs import httpd

JSON_ROUTES = ["/debug/flights", "/debug/hbm", "/debug/serve", "/debug/ingest", "/debug/cost",
               "/debug/tenants", "/debug/qos", "/debug/tail", "/debug/profile?seconds=0.05",
               "/debug/profile?seconds=0.05&format=json", "/debug/bundle?seconds=0.05",
               "/status", "/healthz", "/debug/status"]
TEXT_ROUTES = ["/metrics", "/debug/metrics", "/debug/top", "/",
               "/debug/profile?seconds=0.05&format=collapsed"]


@pytest.fixture(scope="module")
def plane():
    T = tdf.DataType
    schema = tdf.Schema([tdf.Field("k", T.INT64, False), tdf.Field("v", T.FLOAT64, False)])
    rng = np.random.default_rng(4)
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=512)
    ctx.register_datasource("t", tdf.MemoryDataSource(
        schema, [tdf.make_host_batch(schema, [rng.integers(0, 5, 512), rng.random(512)])]))
    ctx.sql_collect("SELECT k, SUM(v) FROM t GROUP BY k")
    srv = httpd.start_debug_server(-1)
    assert srv is not None
    yield srv
    srv.close()


def _get(url, headers=None, timeout=30):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


@pytest.mark.parametrize("route", JSON_ROUTES)
def test_json_routes_answer_200(plane, route):
    status, ctype, body = _get(plane.url + route)
    assert status == 200 and ctype == "application/json"
    assert isinstance(json.loads(body), dict)


@pytest.mark.parametrize("route", TEXT_ROUTES)
def test_text_routes_answer_200(plane, route):
    status, ctype, body = _get(plane.url + route)
    assert status == 200 and ctype.startswith("text/plain") and body


def test_metrics_route_carries_the_scrape(plane):
    text = _get(plane.url + "/metrics")[2].decode()
    assert 'name="queries_admitted"' in text
    assert 'name="host.rss_bytes"' in text or not os.path.exists("/proc/self/status")


def test_bundle_tar_has_the_jax_packages_members(plane):
    status, ctype, body = _get(plane.url + "/debug/bundle?format=tar&seconds=0.05")
    assert status == 200 and ctype == "application/x-tar"
    with tarfile.open(fileobj=io.BytesIO(body)) as tf:
        names = sorted(tf.getnames())
        doc = json.load(tf.extractfile("bundle.json"))
    with tarfile.open(fileobj=io.BytesIO(jhttpd.build_bundle_tar(profile_seconds=0.05))) as tf:
        jax_names = sorted(tf.getnames())
    assert names == jax_names
    assert doc["attachments"] == sorted(n for n in names if n != "bundle.json")
    assert doc["type"] == "debug_bundle"


def test_bundle_json_keys_match_the_jax_package(plane):
    doc = json.loads(_get(plane.url + "/debug/bundle?seconds=0")[2])
    jdoc = jhttpd.build_bundle(profile_seconds=0)
    assert set(jdoc) - {"wal"} <= set(doc)
    assert doc["hbm"]["enabled"] is True and "owners" in doc["hbm"]


def test_qos_carries_the_scale_hint(plane):
    doc = json.loads(_get(plane.url + "/debug/qos")[2])
    assert doc["scale"]["hint"] in (-1, 0, 1)
    assert {"max_burn_rate", "queue_wait_share"} <= set(doc["scale"])


def test_config_names_torch_and_no_jax_platform():
    cfg = httpd.config_snapshot()
    import torch

    assert cfg["torch"] == torch.__version__
    assert "JAX_PLATFORMS" not in cfg["env"]
    if torch.cuda.is_available():
        assert cfg["backend"] == "cuda" and cfg["devices"][0] == torch.cuda.get_device_name(0)
    else:
        assert cfg["backend"] == "cpu" and cfg["devices"] == []


def test_keep_alive_serves_two_requests_on_one_socket(plane):
    host, port = plane.server_address[:2]
    with socket.create_connection((host, port), timeout=30) as s:
        answers = []
        for _ in range(2):
            s.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += s.recv(4096)
            head, _, rest = buf.partition(b"\r\n\r\n")
            n = int(next(ln.split(b":")[1] for ln in head.split(b"\r\n")
                         if ln.lower().startswith(b"content-length")))
            while len(rest) < n:
                rest += s.recv(4096)
            assert head.startswith(b"HTTP/1.1 200") and b"keep-alive" in head
            answers.append(json.loads(rest[:n]))
        assert answers[0]["node"] == answers[1]["node"]


def test_unknown_path_and_post(plane):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(plane.url + "/debug/nope")
    assert e.value.code == 404
    req = urllib.request.Request(plane.url + "/status", data=b"x", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 405


def test_token_guards_all_but_the_probes(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_DEBUG_TOKEN", "s3cret")
    srv = httpd.start_debug_server(-1)
    try:
        for route in ("/metrics", "/debug/hbm", "/debug/bundle?seconds=0"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url + route)
            assert e.value.code == 401
        assert _get(srv.url + "/debug/hbm", {"Authorization": "Bearer s3cret"})[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url + "/debug/hbm", {"Authorization": "Bearer wrong"})
        for route in ("/status", "/healthz"):
            assert _get(srv.url + route)[0] == 200
    finally:
        srv.close()


def test_port_zero_is_off_and_the_bind_is_loopback(monkeypatch):
    assert httpd.start_debug_server(0) is None
    assert httpd.start_debug_server(None) is None
    monkeypatch.delenv("DATAFUSION_TPU_DEBUG_BIND", raising=False)
    assert httpd.debug_bind_host("0.0.0.0") == "127.0.0.1"
    assert httpd.debug_bind_host("0.0.0.0") == jhttpd.debug_bind_host("0.0.0.0")
    monkeypatch.setenv("DATAFUSION_TPU_DEBUG_BIND", "0.0.0.0")
    assert httpd.debug_bind_host("127.0.0.1") == "0.0.0.0"


def test_providers_and_a_broken_one(monkeypatch):
    def broken():
        raise RuntimeError("provider down")

    srv = httpd.start_debug_server(-1, status_fn=lambda: {"type": "status", "x": 1},
                                   gauges_fn=lambda: {"my.gauge": 7},
                                   top_fn=lambda: "custom top")
    bad = httpd.start_debug_server(-1, status_fn=broken)
    try:
        assert json.loads(_get(srv.url + "/status")[2]) == {"type": "status", "x": 1}
        assert 'name="my.gauge"' in _get(srv.url + "/metrics")[2].decode()
        assert _get(srv.url + "/debug/top")[2] == b"custom top"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(bad.url + "/status")
        assert e.value.code == 500
        assert _get(bad.url + "/debug/hbm")[0] == 200  # the plane survives
    finally:
        srv.close()
        bad.close()


def test_run_with_ci_bundle_writes_a_bundle_on_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_CI_BUNDLE_DIR", str(tmp_path))

    def smoke():
        raise AssertionError("gate missed")

    with pytest.raises(AssertionError, match="gate missed"):
        httpd.run_with_ci_bundle(smoke, "smoke")
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("bundle-")
    doc = json.loads((tmp_path / files[0]).read_text())
    assert doc["reason"] == "smoke" and doc["type"] == "debug_bundle"
    assert httpd.run_with_ci_bundle(lambda: 0, "ok") == 0
