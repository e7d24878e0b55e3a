"""PyTorch/CUDA port, slice 11: the host sampling profiler
(`datafusion_tpu_torch/obs/profiler.py`) against the JAX package's.

- Behaviour, mirrored from the JAX package's `tests/test_profiler.py`
  and run against the port: no sampler thread when idle, one thread
  shared by overlapping captures, phase attribution through the stage
  timers, trace correlation through `session` and `adopt`, the output
  formats and the stack cap.
- Pure functions, exact: the same folded stacks through both packages'
  `ProfileReport` give the same `collapsed`, `speedscope`, `by_phase`,
  `to_json` and `summary`.
- EXPLAIN ANALYZE's host profile over a CSV scan (on by default;
  `DATAFUSION_TPU_PROFILE_EXPLAIN=0` leaves it out).
- The continuous profiler (`DATAFUSION_TPU_PROFILE_HZ`): off with no
  thread by default, `capture_hz` / `configure`, start and stop, and in
  a subprocess under the variable a slow query's flight artifact carries
  `profile` and a debug bundle `profile_continuous`.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from datafusion_tpu.obs import profiler as jax_profiler

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.obs import profiler
from datafusion_tpu_torch.obs import trace as obs_trace
from datafusion_tpu_torch.utils import metrics as umetrics
from datafusion_tpu_torch.utils.metrics import METRICS


def _busy_under_timer(stage: str, stop: threading.Event):
    with METRICS.timer(stage):
        x = 0
        while not stop.is_set():
            x += 1
        return x


def _capture_busy(stage: str = "scan.parse", seconds: float = 0.4, hz: float = 250.0):
    """Run a busy thread inside `with METRICS.timer(stage)` under a
    scoped capture; returns the report."""
    stop = threading.Event()
    t = threading.Thread(target=_busy_under_timer, args=(stage, stop),
                         name=f"busy-{stage}", daemon=True)
    with profiler.profile(hz=hz, name="test") as cap:
        t.start()
        time.sleep(seconds)
        stop.set()
        t.join()
    return cap.report()


# ----------------------------------------------- mirrored behaviour


def test_no_thread_when_idle():
    assert not profiler.PROFILER.running()
    assert profiler.PROFILER.active_captures() == 0
    assert umetrics.PROFILE_STAGES is None
    assert umetrics.PROFILE_TRACES is None


def test_start_stop_tears_down_thread_and_tables():
    cap = profiler.PROFILER.start_capture(hz=200)
    try:
        assert profiler.PROFILER.running()
        assert umetrics.PROFILE_STAGES is not None
    finally:
        rep = profiler.PROFILER.stop_capture(cap)
    assert not profiler.PROFILER.running()
    assert umetrics.PROFILE_STAGES is None
    assert rep.duration_s >= 0


def test_overlapping_captures_share_one_thread():
    a = profiler.PROFILER.start_capture(hz=100)
    b = profiler.PROFILER.start_capture(hz=100)
    try:
        assert profiler.PROFILER.active_captures() == 2
        assert len([t for t in threading.enumerate() if t.name == "df-torch-profiler"]) == 1
    finally:
        profiler.PROFILER.stop_capture(a)
        assert profiler.PROFILER.running()  # b still sampling
        profiler.PROFILER.stop_capture(b)
    assert not profiler.PROFILER.running()


def test_disabled_scope_is_noop():
    with profiler.profile(enabled=False) as cap:
        assert cap is None
    assert not profiler.PROFILER.running()


def test_samples_accumulate():
    rep = _capture_busy(seconds=0.3)
    assert rep.samples > 5
    assert rep.hz == 250.0


@pytest.mark.parametrize("stage,phase", [("scan.parse", "decode"),
                                         ("agg.host_encode", "decode"),
                                         ("device.dispatch", "execute"),
                                         ("h2d.dispatch", "h2d"),
                                         ("d2h.wait", "d2h"),
                                         ("parse", "other")])
def test_phase_attribution_via_stage_timer(stage, phase):
    rep = _capture_busy(stage, seconds=0.3)
    phases = rep.phase_samples()
    assert phases.get(phase, 0) > 3, phases
    if phase == "decode":
        tops = [label for label, _n in rep.top_frames(5, "decode")]
        assert any("_busy_under_timer" in t or "is_set" in t for t in tops), tops


def test_trace_correlation_via_session():
    stop = threading.Event()
    tid_trace = {}

    def traced_busy():
        with obs_trace.session() as tc:
            tid_trace["trace_id"] = tc.trace_id
            x = 0
            while not stop.is_set():
                x += 1

    t = threading.Thread(target=traced_busy, daemon=True)
    with profiler.profile(hz=250) as cap:
        t.start()
        time.sleep(0.4)
        stop.set()
        t.join()
    rep = cap.report()
    assert rep.trace_counts.get(tid_trace["trace_id"], 0) > 3, rep.trace_counts
    assert umetrics.PROFILE_TRACES is None


def test_trace_correlation_via_adopt():
    with profiler.profile(hz=100):
        with obs_trace.adopt({"trace_id": "feedbeef00000000"}):
            assert umetrics.PROFILE_TRACES[threading.get_ident()] == "feedbeef00000000"
        assert threading.get_ident() not in umetrics.PROFILE_TRACES


def test_collapsed_round_trips_counts():
    rep = _capture_busy(seconds=0.3)
    total = 0
    for line in rep.collapsed().splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and count.isdigit() and ";" in stack, line
        total += int(count)
    assert total == rep.samples


def test_speedscope_round_trips_stacks():
    rep = _capture_busy(seconds=0.3)
    doc = rep.speedscope()
    assert doc["$schema"].endswith("file-format-schema.json")
    json.dumps(doc)
    rebuilt: dict = {}
    for prof in doc["profiles"]:
        assert prof["type"] == "sampled" and prof["endValue"] == sum(prof["weights"])
        for stack, w in zip(prof["samples"], prof["weights"]):
            frames = tuple(doc["shared"]["frames"][i]["name"] for i in stack)
            rebuilt[frames] = rebuilt.get(frames, 0) + w
    want: dict = {}
    for (_tid, _phase, frames), n in rep.stacks.items():
        want[frames] = want.get(frames, 0) + n
    assert rebuilt == want


def test_to_json_is_bounded_and_complete():
    rep = _capture_busy(seconds=0.3)
    doc = rep.to_json(max_lines=2)
    assert doc["samples"] == rep.samples and doc["phases"]
    assert len(doc["collapsed"].splitlines()) <= 2
    json.dumps(doc)


def test_stack_cap_folds_into_truncated():
    cap = profiler.ProfileCapture(hz=10)
    saved = profiler._MAX_STACKS
    profiler._MAX_STACKS = 2
    try:
        for frame in "abcd":
            cap._fold(1, "other", (frame,), None)
    finally:
        profiler._MAX_STACKS = saved
    assert cap.samples == 4 and cap.truncated == 2
    assert cap.stacks[(1, "other", ("(truncated)",))] == 2


def test_stage_tables_take_no_lock():
    """Publication runs inside other subsystems' critical sections: the
    stage helpers must work while the registry's own lock is held."""
    with profiler.profile(hz=50):
        with METRICS._lock:
            tok = umetrics.stage_enter("scan.parse")
            assert umetrics.PROFILE_STAGES[threading.get_ident()] == "scan.parse"
            umetrics.stage_exit(tok)


# ------------------------------------------- renderings against JAX


def _stacks(seed: int = 3) -> dict:
    """Folded stacks as a capture holds them: {(tid, phase, frames): n}."""
    rng = np.random.default_rng(seed)
    frames = [f"f{i} (pkg/mod{i % 3}.py:{10 * i})" for i in range(12)]
    phases = ["decode", "h2d", "execute", "d2h", "other"]
    out: dict = {}
    for _ in range(60):
        tid = int(rng.choice([101, 202, 303]))
        depth = int(rng.integers(1, 6))
        stack = tuple(frames[int(j)] for j in rng.integers(0, len(frames), depth))
        key = (tid, phases[int(rng.integers(0, len(phases)))], stack)
        out[key] = out.get(key, 0) + int(rng.integers(1, 9))
    out[(101, "decode", ("(truncated)",))] = 4
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_report_renderings_equal_the_jax_package(seed):
    stacks = _stacks(seed)
    args = (stacks, sum(stacks.values()), {"t1": 7, "t2": 3}, 4, 1.25, 97.0,
            {101: "main", 202: "df-prefetch"}, "case")
    got, want = profiler.ProfileReport(*args), jax_profiler.ProfileReport(*args)
    assert got.collapsed() == want.collapsed()
    assert got.collapsed(phase="decode", threads=False) == want.collapsed(
        phase="decode", threads=False)
    assert got.by_phase(3) == want.by_phase(3)
    assert got.top_frames(5) == want.top_frames(5)
    assert got.to_json(top_n=4, max_lines=20) == want.to_json(top_n=4, max_lines=20)
    assert got.summary() == want.summary()
    s_got, s_want = got.speedscope(), want.speedscope()
    assert {k: v for k, v in s_got.items() if k != "exporter"} == {
        k: v for k, v in s_want.items() if k != "exporter"}


def test_phase_map_is_the_phase_bars():
    from datafusion_tpu_torch.obs.device import _PHASE_TIMERS

    profiler._STAGE_PHASE = None
    got = profiler._stage_phase()
    assert got == {t: p for p, timers in _PHASE_TIMERS.items() for t in timers}


# ------------------------------------------------ EXPLAIN ANALYZE


def _csv_ctx(tmp_path, rows):
    from datafusion_tpu_torch.datatypes import DataType, Field, Schema

    path = tmp_path / "t.csv"
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        f.write("k,v\n")
        for i in range(rows):
            f.write(f"k{i % 13},{rng.integers(0, 1000)}\n")
    ctx = tdf.ExecutionContext(device="cpu", result_cache=False, batch_size=4096)
    ctx.register_csv("t", str(path), Schema([Field("k", DataType.UTF8, False),
                                             Field("v", DataType.INT64, False)]))
    return ctx


def test_explain_analyze_reports_per_phase_top_frames(tmp_path, monkeypatch):
    # the port scans these 30,000 rows in a few ms on a warm process,
    # under one period of the default 97 Hz: sample at the top rate
    monkeypatch.setattr(profiler, "_CAPTURE_HZ", 1000.0)
    ctx = _csv_ctx(tmp_path, 30000)
    res = ctx.sql_collect("EXPLAIN ANALYZE SELECT k, SUM(v) FROM t GROUP BY k")
    assert res.result.num_rows == 13
    assert res.host_profile is not None and res.host_profile.samples > 0
    by_phase = res.host_profile.by_phase(3)
    assert by_phase
    for d in by_phase.values():
        assert 1 <= len(d["top_frames"]) <= 3
        assert all(isinstance(label, str) and n >= 1 for label, n in d["top_frames"])
    assert "Host profile" in res.report()
    assert res.trace_id in res.host_profile.trace_counts
    assert not profiler.PROFILER.running()


def test_explain_analyze_profile_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_PROFILE_EXPLAIN", "0")
    res = _csv_ctx(tmp_path, 3).sql_collect("EXPLAIN ANALYZE SELECT v FROM t")
    assert res.host_profile is None
    assert "Host profile" not in res.report()


# ---------------------------------------- the continuous profiler


def test_continuous_default_off_and_idempotent():
    # default env (unset): no continuous capture and no thread
    assert not profiler.continuous_running()
    assert profiler.maybe_start_continuous() is False
    assert profiler.continuous_report() is None
    assert profiler.stop_continuous() is None
    assert not profiler.PROFILER.running()


def test_capture_hz_and_configure_match_the_jax_package():
    assert profiler.capture_hz() == jax_profiler.capture_hz() == 97.0
    saved = profiler._CAPTURE_HZ
    profiler.configure(capture_hz=41)
    try:
        assert profiler.capture_hz() == 41.0
        cap = profiler.PROFILER.start_capture(name="rate")
        assert cap.hz == 41.0
        profiler.PROFILER.stop_capture(cap)
    finally:
        profiler.configure(capture_hz=saved)
    assert profiler.capture_hz() == 97.0


def test_continuous_capture_runs_and_stops(monkeypatch):
    monkeypatch.setattr(profiler, "_HZ", 200.0)
    assert profiler.capture_hz() == 200.0  # the continuous rate wins
    try:
        assert profiler.maybe_start_continuous() is True
        assert profiler.maybe_start_continuous() is True  # idempotent
        assert profiler.continuous_running() and profiler.PROFILER.running()
        deadline = time.monotonic() + 10
        while profiler.continuous_report().samples == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        rep = profiler.continuous_report()
        assert rep.samples > 0 and rep.hz == 200.0
        # a scoped capture beside it shares the one sampler thread
        with profiler.profile(hz=50) as cap:
            assert profiler.PROFILER.active_captures() == 2
        assert cap.report().hz == 50.0 and profiler.PROFILER.running()
    finally:
        final = profiler.stop_continuous()
    assert final is not None and final.samples >= rep.samples
    assert not profiler.continuous_running() and not profiler.PROFILER.running()


_CONTINUOUS_SCRIPT = """\
import glob, io, json, sys, tarfile, time
import numpy as np
import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec.datasource import MemoryDataSource
from datafusion_tpu_torch.obs import httpd, profiler, recorder

flight_dir = sys.argv[1]
assert profiler.continuous_running()
recorder.configure(slow_s=0.0, directory=flight_dir, dump_interval_s=0.0)
schema = tdf.Schema([tdf.Field("k", tdf.DataType.INT64, False),
                     tdf.Field("v", tdf.DataType.FLOAT64, False)])
ctx = tdf.ExecutionContext(device="cpu", result_cache=False)
ctx.register_datasource("t", MemoryDataSource(
    schema, [tdf.make_host_batch(schema, [np.arange(4096) % 7, np.arange(4096.0)])]))
deadline = time.monotonic() + 10
while profiler.continuous_report().samples == 0 and time.monotonic() < deadline:
    time.sleep(0.02)
tdf.collect(ctx.sql("SELECT k, SUM(v) FROM t GROUP BY k"))
(path,) = glob.glob(flight_dir + "/flight-*.json")
art = json.load(open(path))
doc = httpd.build_bundle(profile_seconds=0)
members = tarfile.open(fileobj=io.BytesIO(httpd.build_bundle_tar(profile_seconds=0))).getnames()
print(json.dumps({"reason": art["reason"], "artifact": sorted(art),
                  "profile_hz": art["profile"]["hz"], "bundle": sorted(doc),
                  "members": members}))
"""


def test_profile_hz_puts_the_rolling_report_in_artifacts_and_bundles(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "DATAFUSION_TPU_PROFILE_HZ": "97", "PYTHONPATH": str(repo)}
    proc = subprocess.run([sys.executable, "-c", _CONTINUOUS_SCRIPT, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reason"] == "slow_query" and "profile" in out["artifact"]
    assert out["profile_hz"] == 97.0
    assert "profile_continuous" in out["bundle"]
    assert "profile_continuous.json" in out["members"]
