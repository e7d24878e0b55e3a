"""PyTorch/CUDA port, slice 15: the wire codec (`exec/batch.py`) against
the JAX package's.

Every case encodes one numpy-seeded array in both packages: the port
must choose the same spec and produce the same wire bytes, and its
torch decode must give the JAX decode's bits and the array's own.  The
cases are those of the JAX package's codec tests
(`tests/test_execution.py`: decimal, dict, overflow, -0.0, NaN
payloads) plus integer narrowing, bit-packed bools, float32, unsigned
columns (encoded in their device dtype, `batch.device_array`), empty
arrays and a decimal column whose values divide differently from a
multiply by the reciprocal.  Then `put_compressed` itself under
`DATAFUSION_TPU_WIRE=always` (the CPU runs the codec only so): hints
and hint misses in both packages, a blob whose odd-length wires precede
an f64 wire, `h2d.bytes` counting the wire bytes, `device_inputs`
forced through the wire against raw copies, the probes, and `auto`
weighing the codec against the measured link.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.exec import batch as JB

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.exec import batch as TB
from datafusion_tpu_torch.utils.metrics import METRICS

CPU = torch.device("cpu")


def _reciprocal_sensitive(rng, n=4096, scale=100):
    """Decimal values x/scale whose division differs from a multiply by
    1/scale in the last bit."""
    ints = rng.integers(-(2**31) + 1, 2**31 - 1, n * 8)
    div = ints / scale
    mul = ints * (1.0 / scale)
    pick = ints[div != mul][:n]
    assert len(pick) == n
    return pick / scale


def _cases():
    rng = np.random.default_rng(1515)
    over = np.round(np.linspace(900.0, 104950.0, 8192), 2)
    over[1] = 50_000_000.00  # odd index: a stride-2 sample misses it
    negzero = np.round(np.linspace(-10.0, 10.0, 4096), 2)
    negzero[7] = -0.0
    wide = np.round(rng.uniform(-1e4, 1e4, 4096), 6)
    wide[::97] = rng.standard_normal(len(wide[::97]))
    return {
        "decimal_2dp": np.round(rng.uniform(900.0, 104950.0, 4096), 2),
        "decimal_3dp": np.round(rng.uniform(-1000.0, 1000.0, 4096), 3),
        "decimal_reciprocal": _reciprocal_sensitive(rng),
        "whole_counts": rng.integers(1, 51, 4096).astype(np.float64),
        "raw_normal": rng.standard_normal(4096),
        "decimal_overflow": over,
        "decimal_negzero": negzero,
        "dict_discount": rng.integers(0, 11, 8192) / 100.0,
        "dict_bits": np.tile(np.array([0.01, 0.07, -0.0, np.nan, 104949.99, -0.03]), 256),
        "dict_misses": np.concatenate([np.zeros(4096 * 3), np.arange(200) / 7.0]),
        "f32_exact": rng.standard_normal(4096).astype(np.float32).astype(np.float64),
        "scale_miss": wide,
        "int64_narrow8": rng.integers(-100, 100, 4096).astype(np.int64),
        "int64_narrow16": rng.integers(-30000, 30000, 4096).astype(np.int64),
        "int64_narrow32": rng.integers(-(2**30), 2**30, 4096).astype(np.int64),
        "int64_raw": rng.integers(-(2**62), 2**62, 4096).astype(np.int64),
        "int32_narrow": rng.integers(0, 2526, 4096).astype(np.int32),
        "int8_raw": rng.integers(-128, 127, 4096).astype(np.int8),
        "uint8": rng.integers(0, 255, 4096).astype(np.uint8),
        "uint16": rng.integers(0, 60000, 4096).astype(np.uint16),
        "uint32": rng.integers(0, 2**32 - 1, 4096, dtype=np.uint64).astype(np.uint32),
        "uint32_small": rng.integers(0, 30000, 4096).astype(np.uint32),
        "uint64": rng.integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2),
        "bool_bits": rng.random(4096) > 0.3,
        "bool_odd": rng.random(4099) > 0.3,
        "empty_f64": np.empty(0, np.float64),
        "empty_i64": np.empty(0, np.int64),
    }


CASES = _cases()


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_matches_jax_and_decodes_bit_for_bit(name):
    a = TB.device_array(CASES[name])
    spec, wires = TB._encode_wire(np.ascontiguousarray(a), CPU)
    jspec, jwires = JB._encode_wire(np.ascontiguousarray(a))
    assert spec == jspec
    assert len(wires) == len(jwires)
    for w, jw in zip(wires, jwires):
        w, jw = np.asarray(w), np.asarray(jw)
        assert w.dtype == jw.dtype
        assert np.array_equal(_bits(w), _bits(jw))
    got = TB._decode_wire(spec, tuple(torch.from_numpy(np.array(w)) for w in wires)).numpy()
    want = np.asarray(JB._decode_wire(jspec, tuple(jnp.asarray(w) for w in jwires)))
    assert got.dtype == a.dtype
    assert np.array_equal(_bits(got), _bits(want.astype(a.dtype)))
    assert np.array_equal(_bits(got), _bits(a))


@pytest.mark.parametrize("name,spec", [
    ("decimal_2dp", ("decimal", 100)), ("decimal_3dp", ("decimal", 1000)),
    ("decimal_reciprocal", ("decimal", 100)), ("raw_normal", ("raw",)),
    ("dict_discount", ("dict",)), ("dict_bits", ("dict",)), ("f32_exact", ("f32",)),
    ("bool_bits", ("bits", 4096)), ("bool_odd", ("raw",)),
    ("int64_narrow8", ("narrow", "<i8")), ("uint32", ("raw",)),
    ("uint32_small", ("narrow", "<i8")),
])
def test_the_codec_picks_the_jax_packages_form(name, spec):
    """The spec each case takes (the JAX package's codec tests pin the
    same ones); an unsigned column's narrow spec names its device
    container."""
    got, wires = TB._encode_wire(np.ascontiguousarray(TB.device_array(CASES[name])), CPU)
    assert got == spec
    if spec[0] == "dict":
        assert wires[1].shape == (256,)


def test_decimal_decode_divides_by_a_device_operand():
    """A reciprocal multiply is 1 ulp off on these values: the decode
    divides, and the probe fails a decode that multiplies."""
    a = CASES["decimal_reciprocal"]
    spec, wires = TB._encode_wire(a, CPU)
    assert spec == ("decimal", 100)
    codes = torch.from_numpy(wires[0].copy()).to(torch.float64)
    assert not np.array_equal(codes.mul(1.0 / 100).numpy().view(np.int64), a.view(np.int64))
    got = TB._decode_wire(spec, (torch.from_numpy(wires[0].copy()), torch.from_numpy(wires[1])))
    assert np.array_equal(got.numpy().view(np.int64), a.view(np.int64))


def test_the_decimal_probe_runs_the_ports_decode(monkeypatch):
    real = TB._decode_wire

    def multiply(spec, wires):
        if spec[0] == "decimal":
            return wires[0].to(torch.float64) * (1.0 / float(spec[1]))
        return real(spec, wires)

    monkeypatch.setattr(TB, "_DECIMAL_OK", {})
    monkeypatch.setattr(TB, "_decode_wire", multiply)
    assert TB._decimal_division_exact(CPU) is False
    monkeypatch.setattr(TB, "_DECIMAL_OK", {})
    monkeypatch.setattr(TB, "_decode_wire", real)
    assert TB._decimal_division_exact(CPU) is True
    assert TB._f64_device_exact(CPU) is True
    assert TB._decimal_allowed(CPU) is True


def test_wire_knob_and_link_probe(monkeypatch):
    cuda = torch.device("cuda", 0)  # constructible without a card
    monkeypatch.delenv("DATAFUSION_TPU_WIRE", raising=False)
    assert not TB._wire_enabled(CPU) and not TB.has_link(CPU) and TB.has_link(cuda)
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    assert TB._wire_enabled(CPU) and TB.has_link(CPU)
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "never")
    assert not TB._wire_enabled(cuda) and TB.has_link(cuda)
    assert TB.link_rate_mbps(CPU) == float("inf") == JB.link_rate_mbps(None)
    assert TB._link_cache_key(cuda, "cuda") != TB._link_cache_key(torch.device("cuda", 1), "cuda")


@pytest.mark.parametrize("mbps,on", [(5.0, True), (150.0, True), (199.9, True), (200.0, False),
                                     (250.0, False), (36000.0, False)])
def test_auto_weighs_the_codec_against_the_link(monkeypatch, mbps, on):
    """`auto` turns the codec on for a CUDA device only under a link
    slower than the host encode (`_WIRE_MAX_LINK_MBPS`); the measured
    rate is the only input."""
    cuda = torch.device("cuda", 0)
    monkeypatch.delenv("DATAFUSION_TPU_WIRE", raising=False)
    monkeypatch.setattr(TB, "link_rate_mbps", lambda device: mbps)
    assert TB._wire_enabled(cuda) is on
    assert not TB._wire_enabled(CPU)


def _put_both(arrays, jhints, thints):
    jout = JB.put_compressed(list(arrays), None, jhints)
    tout = TB.put_compressed(list(arrays), CPU, thints)
    for a, j, t in zip(arrays, jout, tout):
        want = TB.device_array(np.asarray(a))
        got = t.numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(_bits(got), _bits(want))
        assert np.array_equal(_bits(np.asarray(j)), _bits(np.asarray(a)))
    return tout


def test_hints_skip_the_probe_in_both_packages(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    rng = np.random.default_rng(5)
    col1 = np.round(rng.uniform(900, 105000, 2048), 2)
    col2 = rng.integers(0, 11, 2048) / 100.0
    jh, th = {}, {}
    _put_both([col1, col2], jh, th)
    assert set(th) == set(jh) == {0, 1}
    assert th[0] == jh[0] == ("decimal", 100)
    assert th[1][0] == jh[1][0] == "dict" and np.array_equal(th[1][1], jh[1][1])
    full = []
    for mod in (JB, TB):
        orig = mod._encode_wire
        monkeypatch.setattr(mod, "_encode_wire",
                            lambda a, d=None, _o=orig: full.append(1) or _o(a, d))
    _put_both([np.round(rng.uniform(900, 105000, 2048), 2),
               rng.integers(0, 11, 2048) / 100.0], jh, th)
    assert not full  # both columns rode their hints in both packages


def test_a_hint_miss_runs_the_full_probe(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    rng = np.random.default_rng(6)
    jh, th = {}, {}
    _put_both([np.round(rng.uniform(0, 100, 2048), 2)], jh, th)
    assert th[0] == jh[0] == ("decimal", 100)
    _put_both([rng.standard_normal(2048)], jh, th)
    assert 0 not in th and 0 not in jh  # raw leaves no hint
    _put_both([rng.integers(0, 3, 2048) / 4.0], jh, th)
    assert th[0][0] == jh[0][0] == "dict"


def test_odd_length_wires_before_an_f64_wire(monkeypatch):
    """Every wire starts on an 8-byte boundary of the blob, so the f64
    wire after a 13-byte bool and a 5-byte int8 image views in place."""
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    rng = np.random.default_rng(7)
    arrays = [rng.random(13) > 0.5, rng.integers(-9, 9, 5).astype(np.int64),
              rng.standard_normal(301), np.round(rng.uniform(0, 90, 300), 2)]
    specs = [TB._encode_wire(a, CPU)[0] for a in arrays]
    assert specs == [("raw",), ("narrow", "<i8"), ("raw",), ("decimal", 100)]
    wire_lists = [TB._encode_wire(a, CPU)[1] for a in arrays]
    sizes = [w.nbytes for ws in wire_lists for w in ws]
    assert sizes == [13, 5, 301 * 8, 300 * 2, 8]
    offsets, total = TB._blob_layout(wire_lists)
    assert offsets == [0, 16, 24, 24 + 301 * 8, 24 + 301 * 8 + 600]
    assert total == offsets[-1] + 8
    _put_both(arrays, None, None)


def test_h2d_bytes_count_the_wire(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    rng = np.random.default_rng(8)
    arrays = [np.round(rng.uniform(900, 105000, 4096), 2), rng.integers(0, 11, 4096) / 100.0,
              rng.integers(0, 2526, 4096).astype(np.int32), rng.random(4096) > 0.5]
    want = sum(w.nbytes for a in arrays for w in TB._encode_wire(a, CPU)[1])
    before = METRICS.snapshot()
    TB.put_compressed(arrays, CPU)
    after = METRICS.snapshot()
    assert after["counts"]["h2d.bytes"] - before["counts"].get("h2d.bytes", 0) == want
    assert want == 4096 * 4 + 8 + 4096 + 256 * 8 + 4096 * 2 + 4096 // 8
    assert after["counts"]["device.h2d.transfers"] - before["counts"].get(
        "device.h2d.transfers", 0) == 1
    assert after["timings_s"]["h2d.encode"] > before["timings_s"].get("h2d.encode", 0.0)


def _batch():
    T = tdf.DataType
    schema = tdf.Schema([tdf.Field("p", T.FLOAT64, False), tdf.Field("q", T.FLOAT64, False),
                         tdf.Field("i", T.INT64, True), tdf.Field("u", T.UINT32, False)])
    rng = np.random.default_rng(11)
    cols = [np.round(rng.uniform(900, 105000, 2000), 2), rng.integers(0, 11, 2000) / 100.0,
            rng.integers(-100, 100, 2000).astype(np.int64),
            rng.integers(0, 2**32 - 1, 2000, dtype=np.uint64).astype(np.uint32)]
    b = TB.make_host_batch(schema, cols, [None, None, rng.random(2000) > 0.2, None])
    b.mask = rng.random(b.capacity) > 0.4
    return b


def test_device_inputs_through_the_wire_match_raw_copies(monkeypatch):
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "always")
    hints: dict = {}
    d_wire, v_wire, m_wire = TB.device_inputs(_batch(), CPU, hints)
    assert hints[0] == ("decimal", 100) and hints[1][0] == "dict"
    monkeypatch.setenv("DATAFUSION_TPU_WIRE", "never")
    d_raw, v_raw, m_raw = TB.device_inputs(_batch(), CPU)
    for a, c in zip(d_wire, d_raw):
        assert a.dtype == c.dtype
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                           c.view(torch.uint8) if c.dtype != torch.bool else c)
    assert torch.equal(v_wire[2], v_raw[2]) and v_wire[0] is None
    assert torch.equal(m_wire, m_raw)


def test_without_the_wire_each_array_copies_on_its_own(monkeypatch):
    monkeypatch.delenv("DATAFUSION_TPU_WIRE", raising=False)
    calls = []
    orig = TB._encode_wire
    monkeypatch.setattr(TB, "_encode_wire", lambda a, d: calls.append(1) or orig(a, d))
    b = _batch()
    before = METRICS.snapshot()["counts"]
    data, _, _ = TB.device_inputs(b, CPU)
    after = METRICS.snapshot()["counts"]
    assert not calls
    assert after["device.h2d.transfers"] - before.get("device.h2d.transfers", 0) == 6
    for got, want in zip(data, b.data):
        assert np.array_equal(got.numpy(), TB.device_array(want))
