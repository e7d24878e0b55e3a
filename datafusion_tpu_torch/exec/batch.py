"""Columnar batches on the host and their copies on the device.

Batches are the JAX package's layout (`datafusion_tpu/exec/batch.py`):

- **fixed-capacity and padded**: capacity is bucketed to a power of two;
- **validity-masked**: nulls are bool arrays (None = all valid);
- **selection-masked**: an upstream filter's row mask rides the batch;
- **dictionary-encoded for strings**: Utf8 columns hold int32 codes into
  a global, append-only `StringDictionary`, so codes are stable across
  batches and GROUP BY keys stay consistent for the whole scan.

Scanned batches hold numpy arrays.  `device_inputs` copies the
columns a kernel reads to the device as torch tensors through
`put_compressed`.  Where the wire codec pays (`_wire_enabled`) each
column travels in its smallest exact form (bool arrays as bits,
integers narrowed, float64 as a small dictionary, a scaled decimal,
float32 or raw), every wire image is written into one pinned staging
buffer, ONE host-to-device copy a call moves it, and torch ops restore
the exact original dtypes on the device (`_blob_decode`).  The codec
pays only over a link slower than its host encode (about 200 MB/s,
`link_rate_mbps`): by default it is off on the CPU, where a copy is a
view, and over an H100's PCIe link, where each array copies on its own
(`to_device`); `DATAFUSION_TPU_WIRE=always` forces it on (the CPU tests
run it so), `never` off.  `device_pull` is the reverse copy: every
device leaf viewed as bytes, concatenated on the device, one copy into
pinned host memory, sliced apart with numpy.  A batch may also hold
tensors already on the device (the dense join probe yields such
batches): `device_inputs` passes those through, and `to_host` brings
any column or mask back as numpy.

Not ported: the JAX package's per-wire route (`_decode_jit`,
`DATAFUSION_TPU_H2D_BLOB=0`), which exists only as the blob's A/B, and
its `split` D2H strategy with `_f64_pair_exact`, which exist because
XLA:TPU stores 64-bit values as 32-bit pairs; Hopper has native 64-bit
types, so the pull always bit-casts (`bitcast64`).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.gate import host_wait
from datafusion_tpu_torch.exec.streams import publish, shared
from datafusion_tpu_torch.obs.device import LEDGER, note_h2d, profile_sync_active, record_d2h
from datafusion_tpu_torch.utils.metrics import METRICS, stage_enter, stage_exit

MIN_CAPACITY = 1024


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (floor MIN_CAPACITY)."""
    cap = MIN_CAPACITY
    while cap < n:
        cap <<= 1
    return cap


class StringDictionary:
    """Global append-only string dictionary for one Utf8 column.

    `version` (== len) keys the host-side caches derived from the
    dictionary: comparison lookup tables and sort-rank tables are
    recomputed only when the dictionary has grown.  Those tables can be
    built over the first `n` strings alone (the dictionary as it stood
    at version `n`), so a thread that stages a batch while a reader
    still appends builds the same table as a serial scan would
    (`dict_versions`).
    """

    __slots__ = ("values", "index", "cmp_cache")

    def __init__(self):
        self.values: list[str] = []
        self.index: dict[str, int] = {}
        # derived tables keyed by use, each stored with the version it
        # was built at (host compare tables, join content hashes)
        self.cmp_cache: dict = {}

    @property
    def version(self) -> int:
        return len(self.values)

    def add(self, s: str) -> int:
        code = self.index.get(s)
        if code is None:
            code = len(self.values)
            self.values.append(s)
            self.index[s] = code
        return code

    def code_of(self, s: str, n: Optional[int] = None) -> int:
        """Code for `s` among the first `n` strings (all by default), or
        -1 if absent (a -1 never equals any row)."""
        code = self.index.get(s, -1)
        return code if n is None or code < n else -1

    def encode(self, strings) -> np.ndarray:
        """Encode a sequence of python strings (None for null) to int32
        codes; nulls encode as 0 (callers carry validity)."""
        obj = np.asarray(strings, dtype=object)
        isnull = np.fromiter((s is None for s in obj), dtype=bool, count=len(obj))
        if isnull.any():
            obj = obj.copy()
            obj[isnull] = ""
        uniq, inv = np.unique(obj.astype(str), return_inverse=True)
        lut = np.fromiter(
            (self.add(s) for s in uniq), dtype=np.int32, count=len(uniq)
        )
        codes = lut[inv].astype(np.int32)
        codes[isnull] = 0
        return codes

    def merge_codes(self, codes: np.ndarray, values: Sequence[str]) -> np.ndarray:
        """Remap codes expressed in a local dictionary `values` (a
        Parquet reader's local dictionary, native/parquet.py) into this global
        dictionary, adding every value of `values` in order."""
        lut = np.fromiter(
            (self.add(v) for v in values), dtype=np.int32, count=len(values)
        )
        if len(lut) == 0:
            return codes.astype(np.int32)
        return lut[codes].astype(np.int32)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        arr = np.asarray(self.values, dtype=object)
        return arr[codes]

    def compare_table(self, op, literal: str, n: Optional[int] = None) -> np.ndarray:
        """Bool table t where t[code] == (values[code] <op> literal), over
        the first `n` strings (all by default).

        Ordered comparisons on dictionary codes are meaningless (codes
        are append-ordered), so the host materializes this table and
        the device gathers from it.  Lexicographic order means ISO
        dates compare chronologically (the TPC-H shipdate filter).
        """
        vals = self.values if n is None else self.values[:n]
        if op == "<":
            return np.array([v < literal for v in vals], dtype=bool)
        if op == "<=":
            return np.array([v <= literal for v in vals], dtype=bool)
        if op == ">":
            return np.array([v > literal for v in vals], dtype=bool)
        if op == ">=":
            return np.array([v >= literal for v in vals], dtype=bool)
        raise ExecutionError(f"unsupported string comparison {op!r}")

    def sort_ranks(self, n: Optional[int] = None) -> np.ndarray:
        """rank[code] = position of values[code] in sorted order, over
        the first `n` strings (all by default)."""
        vals = self.values if n is None else self.values[:n]
        order = np.argsort(np.asarray(vals, dtype=object), kind="stable")
        ranks = np.empty(len(order), dtype=np.int32)
        ranks[order] = np.arange(len(order), dtype=np.int32)
        return ranks


class RecordBatch:
    """A padded columnar batch.

    `data[i]` is a numpy array or a torch tensor of length `capacity`;
    rows at index >= num_rows are padding.  `validity[i]` is a bool
    array (None = all valid).  `mask` is the row-selection mask
    produced by upstream filters (None = all rows live).  Utf8 columns store int32 codes and
    their StringDictionary in `dicts[i]`.  `cache` holds values derived
    from the batch (device copies, group ids) and dies with it.
    """

    __slots__ = ("schema", "data", "validity", "dicts", "num_rows", "mask",
                 "cache")

    def __init__(
        self,
        schema: Schema,
        data: list,
        validity: Optional[list] = None,
        dicts: Optional[list] = None,
        num_rows: Optional[int] = None,
        mask=None,
    ):
        self.schema = schema
        self.data = data
        self.validity = validity if validity is not None else [None] * len(data)
        self.dicts = dicts if dicts is not None else [None] * len(data)
        self.num_rows = num_rows if num_rows is not None else (len(data[0]) if data else 0)
        self.mask = mask
        self.cache: dict = {}

    def column(self, i: int):
        return self.data[i]

    @property
    def num_columns(self) -> int:
        return len(self.data)

    @property
    def capacity(self) -> int:
        return int(self.data[0].shape[0]) if self.data else 0


def dict_versions(batch: RecordBatch) -> tuple:
    """Each column's dictionary version for tables built for this batch
    (None for a column without a dictionary): the versions pinned on
    the batch, else the dictionaries' own."""
    pinned = batch.cache.get("dict_versions")
    if pinned is not None:
        return pinned
    return tuple(None if d is None else d.version for d in batch.dicts)


def pin_dict_versions(batch: RecordBatch, versions=None) -> None:
    """Pin on the batch the version of each of its dictionaries:
    `versions` where an operator carries them over from its input,
    else the dictionaries' versions now, unless the batch has them.

    A reader appends to its dictionaries while later batches parse, and
    the prefetch threads (`exec/prefetch.staged_pipeline`) build a
    batch's tables while the reader runs ahead.  Tables built at the
    versions pinned where the batch left its source are the ones a
    serial scan builds, so the tables' identities, and with them the
    fold's batch groups and its float sums, do not depend on thread
    timing.  The CSV reader pins each batch it yields; operators that
    hand a dictionary on (the pipeline, the join) carry the pins."""
    if versions is not None:
        if any(v is not None for v in versions):
            batch.cache["dict_versions"] = tuple(versions)
    elif "dict_versions" not in batch.cache and any(d is not None for d in batch.dicts):
        batch.cache["dict_versions"] = dict_versions(batch)


# host unsigned dtypes and their device containers (DataType.torch_dtype):
# uint16 and uint32 widen by value, uint64 is an int64 bit view
_WIDEN = {np.dtype(np.uint16): np.dtype(np.int32),
          np.dtype(np.uint32): np.dtype(np.int64),
          np.dtype(np.uint64): np.dtype(np.int64)}


def device_array(arr: np.ndarray) -> np.ndarray:
    """A host array in the dtype its device tensor holds: unsigned
    columns wider than 8 bits widen (uint64 as a bit view)."""
    wide = _WIDEN.get(arr.dtype)
    if wide is None:
        return arr
    if wide.itemsize == arr.dtype.itemsize:
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        return arr.view(wide)
    return arr.astype(wide)


def host_array(arr: np.ndarray, np_dtype) -> np.ndarray:
    """A host array pulled from the device, back in its column's numpy
    dtype: the inverse of `device_array` for unsigned columns (uint16
    and uint32 narrow, uint64 is viewed back); other dtypes pass."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind != "u" or arr.dtype == np_dtype:
        return arr
    if arr.dtype.itemsize == np_dtype.itemsize:
        return arr.view(np_dtype)
    return arr.astype(np_dtype)


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (bool, ints, floats)."""
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


# ---- wire compression: shrink H2D bytes losslessly ----------------------
# The JAX package's codec, bit for bit (the same specs, the same wire
# bytes): bool arrays pack to bits (8x); integer columns narrow to the
# smallest signed width holding their observed range; float64 columns
# travel as small-dictionary codes + a value table (<= 255 distinct bit
# patterns), as scaled-decimal narrow ints (prices, rates, whole
# counts), as float32 when that round trip is exact, else raw.  Every
# decoded column is bit-identical to its raw copy.  The encoders read
# `device_array(a)`, the dtype the device tensor holds, so an unsigned
# column's `narrow` spec names that container (uint32 -> int64).

_DICT_MAX = 255
_SAMPLE = 4096

_DECIMAL_OK: dict = {}
_F64_EXACT: dict = {}


def _target_platform(device) -> str:
    """Platform of the transfer target: the torch device type."""
    return torch.device(device).type


def _decimal_division_exact(device) -> bool:
    """Does the port's own decimal decode (`_decode_wire`, int ->
    float64 -> / scale with the scale a device operand) reproduce
    numpy's division bit for bit on this platform?  Probed once per
    platform over random int32 images at scales 100 and 1000.  A decode
    that divided by a host scalar would multiply by its reciprocal, 1
    ulp off for about 13 % of values, and fail here."""
    platform = _target_platform(device)
    hit = _DECIMAL_OK.get(platform)
    if hit is None:
        rng = np.random.default_rng(0xD1CE)
        ints = rng.integers(-(2**31) + 1, 2**31 - 1, _SAMPLE).astype(np.int32)
        hit = True
        codes = torch.from_numpy(ints).to(device)  # df-lint: ok(DF006) — the decimal probe, once a platform
        for scale in (100, 1000):
            want = ints.astype(np.float64) / scale
            sc = torch.from_numpy(np.full(1, scale, np.float64)).to(device)  # df-lint: ok(DF006) — the decimal probe, once a platform
            got = _decode_wire(("decimal", scale), (codes, sc)).cpu().numpy()  # df-lint: ok(DF001) — the decimal probe, once a platform
            if not np.array_equal(got.view(np.int64), want.view(np.int64)):
                hit = False
                break
        _DECIMAL_OK[platform] = hit
    return hit


def _f64_device_exact(device) -> bool:
    """Does a plain copy of float64 to the device and back round-trip
    bit-exactly on this platform?"""
    platform = _target_platform(device)
    hit = _F64_EXACT.get(platform)
    if hit is None:
        rng = np.random.default_rng(0xF64)
        v = np.round(rng.uniform(-1e6, 1e6, _SAMPLE), 2)
        back = torch.from_numpy(v).to(device).cpu().numpy()  # df-lint: ok(DF001, DF006) — the f64 round-trip probe, once a platform
        hit = _F64_EXACT[platform] = bool(
            np.array_equal(back.view(np.int64), v.view(np.int64))
        )
    return hit


def _decimal_allowed(device) -> bool:
    return _decimal_division_exact(device) or not _f64_device_exact(device)


def _wire_mode() -> str:
    """DATAFUSION_TPU_WIRE: auto (the default), always or never."""
    return os.environ.get("DATAFUSION_TPU_WIRE", "auto")


def has_link(device) -> bool:
    """Whether a copy to or from `device` crosses a link: a CUDA device,
    or the CPU under DATAFUSION_TPU_WIRE=always (the CPU tests run the
    link's paths so: the packed pulls and masks, the run-permutation
    cache).  Elsewhere on the CPU a copy is a view."""
    return _target_platform(device) != "cpu" or _wire_mode() == "always"


# The codec's host encode costs about 5 ns a byte it saves: a cold Q1
# over the SF-1 lineitem encoded for 915.569 ms to send 84,697,456 bytes
# in place of 265,293,824 (chip_smoke.py phase_data_plane on an NVIDIA
# H100 80GB HBM3 at 700 W).  So it pays only over a link slower than
# about 1 byte / 5 ns = 200 MB/s.
_WIRE_MAX_LINK_MBPS = 200.0


def _wire_enabled(device) -> bool:
    """Whether host arrays cross to `device` through the wire codec.
    `auto` weighs it against the measured link: on where
    `link_rate_mbps` is under `_WIRE_MAX_LINK_MBPS`, so never on the
    CPU (a copy is a view) and not over an H100's PCIe link.  `always`
    forces it on (the CPU tests run the codec so), `never` off."""
    mode = _wire_mode()
    if mode != "auto":
        return mode == "always"
    return (_target_platform(device) != "cpu"
            and link_rate_mbps(device) < _WIRE_MAX_LINK_MBPS)


def _decimal_image(arr: np.ndarray, arr_bits: np.ndarray, scale: int):
    """int32 wire image of `arr`, or None unless the image reproduces
    every value bit-exactly through the decode arithmetic (int32 -> f64
    -> /scale).  The bit-level compare rejects -0.0 and NaN."""
    scaled = np.round(arr * scale)
    with np.errstate(invalid="ignore"):
        if not bool(np.all(np.abs(scaled) < 2**31)):
            return None
    image = scaled.astype(np.int32)
    ok = np.array_equal(
        (image.astype(np.float64) / scale).view(np.int64), arr_bits
    )
    return image if ok else None


def _narrow_int_image(image: np.ndarray) -> np.ndarray:
    """Narrow an int image to int8/int16 when its range fits."""
    lo, hi = int(image.min()), int(image.max())
    for cand in (np.int8, np.int16):
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            return image.astype(cand)
    return image


def _dict_table(values_bits: np.ndarray) -> np.ndarray:
    """Fixed-size f64 value table from sorted unique bit patterns,
    padded with the last entry."""
    table = np.empty(_DICT_MAX + 1, np.int64)
    table[: len(values_bits)] = values_bits
    table[len(values_bits):] = values_bits[-1]
    return table.view(np.float64)


# ---- link-rate probe: the codec's one input ---------------------------
_LINK_RATE: dict = {}
_LINK_PROBE_BYTES = 1 << 23


def _link_cache_key(device, platform: str):
    """Cache key for one measured link: the platform and the device's
    index, so two cards never inherit each other's rate."""
    return (platform, torch.device(device).index)


def link_rate_mbps(device) -> float:
    """Achieved host-to-device MB/s to `device`, measured once per
    device: the best of two blocking copies of 8 MiB from pinned memory
    (each returns once its bytes have landed), after a small copy back
    that wakes the link and drains the stream.  It syncs no stream and
    makes no CUDA event.  Infinite on the CPU."""
    platform = _target_platform(device)
    if platform == "cpu":
        return float("inf")
    key = _link_cache_key(device, platform)
    hit = _LINK_RATE.get(key)
    if hit is None:
        torch.arange(16, device=device).cpu()  # df-lint: ok(DF001) — the link-rate probe's warm-up, once a card
        rng = np.random.default_rng(0xBEEF)
        src = torch.from_numpy(
            rng.integers(0, 255, _LINK_PROBE_BYTES, dtype=np.uint8)).pin_memory()
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            src.to(device)  # df-lint: ok(DF006) — the link-rate probe times the raw transport, once a card
            rates.append(src.numel() / 1e6 / max(time.perf_counter() - t0, 1e-9))
        hit = _LINK_RATE[key] = float(max(rates))
        METRICS.add("link.probe_mbps", int(hit))
    return hit


def _encode_wire_hinted(a: np.ndarray, hint, device):
    """Re-validate a previously chosen codec against a new batch of the
    same column: one verification pass instead of the full probe
    ladder.  Returns (spec, wires) or None when the hint no longer fits
    (the caller runs the full probe)."""
    if a.dtype != np.float64 or not a.size:
        return None
    tag = hint[0]
    bits = a.view(np.int64)
    if tag == "dict":
        values_bits = hint[1]
        pos = np.searchsorted(values_bits, bits)
        pos = np.minimum(pos, len(values_bits) - 1)
        if bool((values_bits[pos] == bits).all()):
            return ("dict",), (pos.astype(np.uint8), _dict_table(values_bits))
        return None
    if tag == "decimal":
        if not _decimal_allowed(device):
            return None
        scale = hint[1]
        image = _decimal_image(a, bits, scale)
        if image is None:
            return None
        return ("decimal", scale), (
            _narrow_int_image(image),
            np.full(1, scale, np.float64),
        )
    if tag == "f32":
        f32 = a.astype(np.float32)
        if np.array_equal(f32.astype(np.float64), a, equal_nan=True):
            return ("f32",), (f32,)
        return None
    return None


def _wire_hint_of(spec, wires):
    """The reusable part of an encode decision, stored by callers and
    replayed through _encode_wire_hinted on the next batch."""
    tag = spec[0]
    if tag == "dict":
        return ("dict", wires[1].view(np.int64)[:_DICT_MAX + 1].copy())
    if tag == "decimal":
        return ("decimal", spec[1])
    if tag == "f32":
        return ("f32",)
    return None


def _encode_wire(a: np.ndarray, device):
    """(spec, wire_arrays) for one host array (in its device dtype,
    `device_array`); spec is static and hashable."""
    if a.dtype == np.bool_ and a.size % 8 == 0 and a.size:
        return ("bits", a.size), (np.packbits(a),)
    kind = a.dtype.kind
    if kind in ("i", "u") and a.itemsize > 1 and a.size:
        lo, hi = int(a.min()), int(a.max())
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if (
                np.dtype(cand).itemsize < a.itemsize
                and info.min <= lo
                and hi <= info.max
            ):
                return ("narrow", a.dtype.str), (a.astype(cand),)
        return ("raw",), (a,)
    if a.dtype == np.float64 and a.size:
        # codec order = wire width order: dict (1 B/row) -> decimal
        # (1-4 B) -> f32 (4 B) -> raw (8 B).  The dictionary is over BIT
        # patterns, so -0.0 and every NaN payload stay intact; a strided
        # sample builds the candidate table and the full column probes it
        bits = a.view(np.int64)
        stride = max(1, a.size // _SAMPLE)
        values_bits = np.unique(bits[::stride][:_SAMPLE])
        if len(values_bits) <= _DICT_MAX:
            pos = np.searchsorted(values_bits, bits)
            pos = np.minimum(pos, len(values_bits) - 1)
            miss = values_bits[pos] != bits
            overflow = False
            if miss.any():
                extra = np.unique(bits[miss])
                if len(values_bits) + len(extra) > _DICT_MAX:
                    overflow = True  # too many uniques: decimal may still fit
                else:
                    values_bits = np.union1d(values_bits, extra)
                    pos = np.searchsorted(values_bits, bits)
            if not overflow:
                return ("dict",), (pos.astype(np.uint8), _dict_table(values_bits))
        # scaled decimal: round(value*scale)/scale reproduces every value
        # bit-exactly host-side; a strided sample gates the full passes
        sample = np.ascontiguousarray(a[::stride][:_SAMPLE])
        for scale in (1, 100, 1000, 10_000, 1_000_000):
            if _decimal_image(sample, sample.view(np.int64), scale) is None:
                continue
            if not _decimal_allowed(device):
                break
            image = _decimal_image(a, bits, scale)
            if image is not None:
                # the scale travels as a device operand: a division by a
                # host scalar multiplies by 1/s, 1 ulp off for ~13 % of
                # values
                return ("decimal", scale), (
                    _narrow_int_image(image),
                    np.full(1, scale, np.float64),
                )
        f32 = a.astype(np.float32)
        if np.array_equal(f32.astype(np.float64), a, equal_nan=True):
            return ("f32",), (f32,)
        return ("raw",), (a,)
    return ("raw",), (a,)


_SHIFTS: dict = {}


def _decode_wire(spec, wires):
    """The inverse of _encode_wire over device tensors (torch ops)."""
    tag = spec[0]
    if tag == "bits":
        packed = wires[0]
        shifts = _SHIFTS.get(packed.device)
        if shifts is None:
            # packbits is MSB-first within each byte
            shifts = _SHIFTS[packed.device] = torch.arange(
                7, -1, -1, dtype=torch.uint8, device=packed.device)
        bits = (packed.unsqueeze(1) >> shifts) & 1
        return bits.reshape(-1)[: spec[1]].to(torch.bool)
    if tag == "narrow":
        return wires[0].to(torch_dtype(spec[1]))
    if tag == "f32":
        return wires[0].to(torch.float64)  # f32 -> f64 widening is exact
    if tag == "decimal":
        # a true division by a device operand, never a host scalar
        return wires[0].to(torch.float64) / wires[1]
    if tag == "dict":
        codes, values = wires
        # uint8 codes as an index would be a boolean mask: widen first
        return values[codes.to(torch.int64)]
    return wires[0]


# wires per spec kind (dict ships codes + value table; decimal ships
# codes + the runtime scale)
_WIRE_COUNT = {"dict": 2, "decimal": 2}


def _blob_layout(wire_lists):
    """Byte offsets of the host wires in the blob, each wire starting on
    an 8-byte boundary (a typed view of a blob slice needs its offset
    to be a multiple of its item size), and the blob's length."""
    offsets = []
    off = 0
    for ws in wire_lists:
        for w in ws:
            if isinstance(w, np.ndarray):
                offsets.append(off)
                off += (w.nbytes + 7) & ~7
            else:
                offsets.append(None)
    return offsets, off


def _blob_decode(specs, wire_lists, offsets, blob):
    """Slice each host wire back out of the device blob (a uint8
    tensor), view it in its dtype and run the spec's decode; device
    wires pass through."""
    out = []
    k = 0
    for spec, ws in zip(specs, wire_lists):
        wires = []
        for w in ws:
            off = offsets[k]
            k += 1
            if off is None:
                wires.append(w)
                continue
            raw = blob[off: off + w.nbytes]
            wires.append(raw.view(torch_dtype(w.dtype)))
        out.append(_decode_wire(spec, wires))
    return out


def put_compressed(host_arrays, device, hints=None, owner: str = "batch"):
    """Device copies of a flat list of arrays via the wire codec: each
    host array encodes to its smallest exact form, the wires are
    written into ONE pinned staging block (each wire 8-byte aligned),
    one host-to-device copy moves it, and torch ops restore the
    original dtypes on the device.  Entries that are
    already tensors pass through (to `device` if elsewhere).

    The staging buffer comes from PyTorch's pinned host allocator, which
    hands each call its own block and reuses a block only once the copy
    that read it has completed (the allocator records that copy's
    event), so callers on several threads never write over bytes a copy
    still reads, and the seam itself makes no CUDA event and syncs no
    stream (inside `obs/device.profile_sync` it waits for the copy).

    `hints` is an optional caller-owned dict {position: hint}
    remembering each column's codec across batches of a scan (cores
    own one: they persist across runs).  Without the wire
    (`_wire_enabled`) every host array copies on its own
    (`to_device`).  `h2d.bytes` counts the wire bytes; `h2d.encode`
    times the host encode."""
    if not _wire_enabled(device):
        return tuple(
            on_device(a, device, owner) if isinstance(a, (np.ndarray, torch.Tensor)) else a
            for a in host_arrays
        )
    specs = []
    wire_lists = []
    host_pos = []
    wire_bytes = 0
    with METRICS.timer("h2d.encode"):
        for i, a in enumerate(host_arrays):
            if isinstance(a, torch.Tensor):
                spec, wires = ("raw",), (a if a.device == device else a.to(device),)
            else:
                a = np.ascontiguousarray(device_array(np.asarray(a)))
                host_pos.append(i)
                spec = wires = None
                hint = None if hints is None else hints.get(i)
                if hint is not None:
                    hinted = _encode_wire_hinted(a, hint, device)
                    if hinted is not None:
                        spec, wires = hinted
                if spec is None:
                    spec, wires = _encode_wire(a, device)
                    if hints is not None:
                        h = _wire_hint_of(spec, wires)
                        if h is not None:
                            hints[i] = h
                        else:
                            # a dead hint would cost full-column passes
                            # per batch just to fail
                            hints.pop(i, None)
                wires = tuple(np.ascontiguousarray(w) for w in wires)
                wire_bytes += sum(w.nbytes for w in wires)
            specs.append(spec)
            wire_lists.append(wires)
    if not host_pos:
        return tuple(ws[0] for ws in wire_lists)
    offsets, total = _blob_layout(wire_lists)
    tok = stage_enter("h2d.dispatch")
    t0 = time.perf_counter()
    try:
        if device.type == "cpu":
            host = np.zeros(total, np.uint8)
            _write_wires(host, wire_lists, offsets)
            blob = torch.from_numpy(host)
        else:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            _write_wires(buf.numpy(), wire_lists, offsets)  # df-lint: ok(DF001) — a view of pinned host memory, no device wait
            blob = buf.to(device, non_blocking=True)
            if profile_sync_active():
                torch.cuda.current_stream(device).synchronize()  # df-lint: ok(DF001) — only inside profile_sync (EXPLAIN ANALYZE)
    finally:
        stage_exit(tok)
    note_h2d(wire_bytes, time.perf_counter() - t0)
    decoded = _blob_decode(specs, wire_lists, offsets, blob)
    LEDGER.adopt([decoded[i] for i in host_pos], owner)
    return tuple(decoded)


def _write_wires(host: np.ndarray, wire_lists, offsets) -> None:
    k = 0
    for ws in wire_lists:
        for w in ws:
            off = offsets[k]
            k += 1
            if off is not None:
                host[off: off + w.nbytes] = w.reshape(-1).view(np.uint8)


# ---- one packed device-to-host copy ------------------------------------


def device_pull(tensors) -> list:
    """A sequence of tensors on the host in ONE copy: each is viewed as
    bytes (64-bit values bit-cast, the JAX package's `bitcast64`) and
    concatenated on the device behind the work that produces them; the
    blob is copied into pinned host memory (PyTorch's pinned host
    allocator reuses its blocks) in one blocking copy and sliced back
    into numpy arrays.  Where no link is crossed (`has_link`) each is
    read on its own (`to_host`, a view on the CPU)."""
    tensors = list(tensors)
    if not tensors or not has_link(tensors[0].device):
        return [to_host(x) for x in tensors]
    parts = [x.contiguous().reshape(-1).view(torch.uint8) for x in tensors]
    blob = parts[0] if len(parts) == 1 else torch.cat(parts)
    tok = stage_enter("d2h.wait")
    t0 = time.perf_counter()
    try:
        if blob.device.type == "cpu":
            host = blob.numpy()  # df-lint: ok(DF001) — a CPU tensor's view
        else:
            buf = torch.empty(blob.numel(), dtype=torch.uint8, pin_memory=True)
            with host_wait():
                buf.copy_(blob)
            host = buf.numpy()  # df-lint: ok(DF001) — a view of the pinned block the copy above filled
        out = []
        off = 0
        for x in tensors:
            np_dtype = np.dtype(torch.empty(0, dtype=x.dtype).numpy().dtype)  # df-lint: ok(DF001) — an empty CPU tensor names the dtype
            nbytes = x.numel() * np_dtype.itemsize
            # a copy: the pinned block goes back to the allocator
            out.append(host[off: off + nbytes].copy().view(np_dtype).reshape(tuple(x.shape)))
            off += nbytes
    finally:
        stage_exit(tok)
    record_d2h(blob.numel(), time.perf_counter() - t0)
    return out


def to_device(arr: np.ndarray, device: torch.device, owner: str = "batch") -> torch.Tensor:
    """One host array as a tensor on `device` (unsigned columns in
    their device dtype, `device_array`).  On a CUDA device the copy
    goes through pinned memory and is asynchronous on the current
    stream (the pinned buffer stays reserved by PyTorch's host
    allocator until the copy has run; inside `obs/device.profile_sync`
    the copy is waited for, so the `h2d` phase is the copy's time); on
    the CPU it is a view.

    Every call counts one `device.h2d.transfers` and its bytes in
    `h2d.bytes` (utils/metrics.py), on the CPU too, where the copy is
    a view, so a test there sees what a run on the card would send; the
    tensor registers in the device ledger under `owner`."""
    t = torch.from_numpy(np.ascontiguousarray(device_array(np.asarray(arr))))
    tok = stage_enter("h2d.dispatch")
    t0 = time.perf_counter()
    try:
        if device.type != "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
            if profile_sync_active():
                torch.cuda.current_stream(device).synchronize()  # df-lint: ok(DF001) — only inside profile_sync (EXPLAIN ANALYZE)
    finally:
        stage_exit(tok)
    note_h2d(t.numel() * t.element_size(), time.perf_counter() - t0)
    LEDGER.adopt(t, owner)
    return t


def to_host(x, np_dtype=None) -> np.ndarray:
    """A column, validity or mask as a numpy array, whether it is a
    host array or a tensor on any device (one device-to-host copy,
    counted in `d2h.bytes` and the `d2h.wait` timer).  With
    `np_dtype`, a device tensor of an unsigned column comes back in
    that dtype (`host_array`)."""
    if isinstance(x, torch.Tensor):
        tok = stage_enter("d2h.wait")
        t0 = time.perf_counter()
        try:
            with host_wait():
                out = x.cpu().numpy()  # df-lint: ok(DF001) — the pull seam itself, under host_wait
        finally:
            stage_exit(tok)
        record_d2h(out.nbytes, time.perf_counter() - t0)
        return out if np_dtype is None else host_array(out, np_dtype)
    return np.asarray(x)


def on_device(x, device: torch.device, owner: str = "batch") -> torch.Tensor:
    """A host array or a tensor as a tensor on `device`; a tensor
    already there passes through."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)  # df-lint: ok(DF006) — a tensor's move between devices; host data goes through to_device
    return to_device(np.asarray(x), device, owner)


def param_tensors(values, device: torch.device) -> tuple:
    """A core's runtime literal values (numpy scalars,
    exec/kernels.parameterize_exprs) as 0-dim tensors on `device`, in
    their device dtypes."""
    return tuple(
        torch.from_numpy(device_array(np.asarray(v)).copy()).to(device)  # df-lint: ok(DF006) — 0-dim runtime literals ride each launch as arguments, not columns
        for v in values
    )


def device_inputs(batch: RecordBatch, device: torch.device, hints=None):
    """(data, validity, mask) of `batch` as tensors on `device`, cached
    on the batch: a re-scanned in-memory batch crosses to the device
    once, not once per query run.  Host arrays travel through the wire
    codec (`put_compressed`, one copy for the batch); `hints`
    (optional, caller-owned) carries per-column codec memory across
    batches."""
    key = ("device", str(device))
    hit = batch.cache.get(key)
    if hit is not None:
        return shared(hit)
    # layout: data columns, then the present validity arrays, then mask
    arrays: list = list(batch.data)
    valid_pos = [i for i, v in enumerate(batch.validity) if v is not None]
    arrays.extend(batch.validity[i] for i in valid_pos)
    if batch.mask is not None:
        arrays.append(batch.mask)
    decoded = put_compressed(arrays, device, hints)
    n = len(batch.data)
    validity: list = [None] * n
    for j, i in enumerate(valid_pos):
        validity[i] = decoded[n + j]
    mask = decoded[-1] if batch.mask is not None else None
    out = (tuple(decoded[:n]), tuple(validity), mask)
    batch.cache[key] = publish(out)
    return out


def subset_view(batch: RecordBatch, cols: Sequence[int]) -> RecordBatch:
    """A view batch holding only `cols`, cached on the parent batch so
    device copies made against the view survive re-scans of in-memory
    sources (device_inputs caches on the view object)."""
    if len(cols) == batch.num_columns:
        return batch
    key = ("subset_view", tuple(cols))
    hit = batch.cache.get(key)
    if hit is None:
        hit = RecordBatch(
            batch.schema.select(list(cols)),
            [batch.data[c] for c in cols],
            [batch.validity[c] for c in cols],
            [batch.dicts[c] for c in cols],
            num_rows=batch.num_rows,
            mask=batch.mask,
        )
        batch.cache[key] = hit
    return hit


def pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a 1-D host array with zeros up to `capacity`."""
    n = len(arr)
    if n == capacity:
        return np.ascontiguousarray(arr)
    if n > capacity:
        raise ExecutionError(f"batch of {n} rows exceeds capacity {capacity}")
    out = np.zeros(capacity, dtype=arr.dtype)
    out[:n] = arr
    return out


def make_host_batch(
    schema: Schema,
    columns: list[np.ndarray],
    validity: Optional[list[Optional[np.ndarray]]] = None,
    dicts: Optional[list[Optional[StringDictionary]]] = None,
) -> RecordBatch:
    """Assemble a RecordBatch from unpadded host columns, padding all of
    them to a common bucketed capacity."""
    if not columns:
        return RecordBatch(schema, [], num_rows=0)
    n = len(columns[0])
    cap = bucket_capacity(n)
    data = [pad_to(np.asarray(c), cap) for c in columns]
    vals: list[Optional[np.ndarray]] = []
    for i in range(len(columns)):
        v = validity[i] if validity is not None else None
        if v is None:
            vals.append(None)
        else:
            pv = np.zeros(cap, dtype=bool)
            pv[:n] = v
            vals.append(pv)
    return RecordBatch(schema, data, vals, dicts, num_rows=n)
