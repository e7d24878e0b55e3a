"""PyTorch/CUDA port: the Arrow schema pyarrow stores in a Parquet
footer (`ARROW:schema`), decoded by `native/arrow_schema.py`, against
the JAX package's pyarrow reader.

Each file is written by pyarrow and read by both packages'
`infer_parquet_schema` (the same schema, or the same `ExecutionError`
text) and `ParquetReader` (the same values, validity, codes and
dictionaries, in order):

- timestamps in UTC, in `+05:30` and in `America/New_York` (values
  across the spring and autumn DST changes, with NULLs), in units s,
  ms, us and ns, naive and zoned, read as Utf8: local time and offset
  as pyarrow's cast to string prints them;
- a dictionary-typed column, `duration` columns, `date64`, the large and
  view string types: inference raises or maps as the JAX package does;
  declared as Utf8 or Int64 they read alike;
- a file without `ARROW:schema` (`store_schema=False`) reads as before:
  every type from its Parquet annotations, zoned timestamps as UTC;
- a corrupt `ARROW:schema` value raises IoError in the port (pyarrow
  raises too), and 400 seeded mutations of a value each give IoError or
  a schema, never another exception; a zone the machine has no data for
  raises IoError naming it.

The decoder itself is held against pyarrow's own schema: names,
nullability and type strings of every flat type.
"""

from __future__ import annotations

import base64

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import datafusion_tpu as jdf
from datafusion_tpu.io.readers import infer_parquet_schema as jax_infer

import datafusion_tpu_torch as tdf
from datafusion_tpu_torch.io.readers import infer_parquet_schema
from datafusion_tpu_torch.native.arrow_schema import decode_arrow_schema
from datafusion_tpu_torch.native.parquet import ParquetFile
from test_torch_parquet import assert_same_read

NY_SPRING = 1615705200000  # 2021-03-14 07:00 UTC, 03:00 EDT
NY_AUTUMN = 1636264800000  # 2021-11-07 06:00 UTC, 01:00 EST
PER_MS = {"s": 10**-3, "ms": 1, "us": 10**3, "ns": 10**6}


def _instants(unit, rng):
    """ms instants on both sides of New York's two DST changes, a few
    far from them, as `unit` values (a fraction below the ms for us and
    ns), every fifth NULL."""
    ms = [t + k * 600_000 for t in (NY_SPRING, NY_AUTUMN) for k in range(-9, 10)]
    ms += [0, -3_600_000, 951_782_400_000, 4_102_444_800_000]
    vals = [int(t * PER_MS[unit]) if unit != "s" else t // 1000 for t in ms]
    if unit in ("us", "ns"):
        vals = [v + int(rng.integers(0, 1000)) for v in vals]
    return [None if i % 5 == 3 else v for i, v in enumerate(vals)]


ZONES = ["UTC", "+05:30", "America/New_York", None]
UNITS = ["s", "ms", "us", "ns"]


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("tz", ZONES, ids=lambda z: str(z).replace("/", "_"))
def test_timestamps_read_as_the_jax_reader(tmp_path, tz, unit):
    rng = np.random.default_rng(len(unit))
    a = pa.array(_instants(unit, rng), pa.timestamp(unit, tz=tz))
    path = str(tmp_path / "ts.parquet")
    pq.write_table(pa.table({"ts": a, "k": pa.array(np.arange(len(a)))}), path,
                   row_group_size=20)
    with ParquetFile(path) as pf:
        assert pf.fields[0].arrow_type == str(pq.ParquetFile(path).schema_arrow.field(0).type)
    assert_same_read(path, None, 7)  # the JAX package's schema, strings and order


def test_zoned_strings_are_pyarrows_cast():
    ist = pa.array([0, 3_600_000, None], pa.timestamp("ms", tz="+05:30"))
    want = ist.cast(pa.string()).to_pylist()
    assert want[:2] == ["1970-01-01 05:30:00.000+0530", "1970-01-01 06:30:00.000+0530"]
    ny = pa.array([NY_SPRING - 1, NY_SPRING, NY_AUTUMN - 1, NY_AUTUMN],
                  pa.timestamp("ms", tz="America/New_York"))
    assert [s[-5:] for s in ny.cast(pa.string()).to_pylist()] == ["-0500", "-0400",
                                                                  "-0400", "-0500"]


def _write(tmp_path, name, array):
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(pa.table({name: array}), path)
    return path


UNSUPPORTED = {
    "dictionary": pa.array(["a", "b", "a", None]).dictionary_encode(),
    "dictionary_int8": pa.DictionaryArray.from_arrays(pa.array([0, 1, 1], pa.int8()),
                                                      pa.array(["x", "y"])),
    "dictionary_ordered_binary": pa.DictionaryArray.from_arrays(
        pa.array([0, 1], pa.int16()), pa.array([b"x", b"y"]), ordered=True),
    "duration_s": pa.array([1, 2, None], pa.duration("s")),
    "duration_ms": pa.array([1, 2, None], pa.duration("ms")),
    "duration_us": pa.array([1, 2, None], pa.duration("us")),
    "duration_ns": pa.array([1, -2, None], pa.duration("ns")),
    "string_view": pa.array(["x", None], pa.string_view()),
    "large_binary": pa.array([b"x", None], pa.large_binary()),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_types_inference_refuses_raise_the_jax_packages_error(tmp_path, name):
    path = _write(tmp_path, name, UNSUPPORTED[name])
    with pytest.raises(jdf.ExecutionError) as want:
        jax_infer(path)
    with pytest.raises(tdf.ExecutionError) as got:
        infer_parquet_schema(path)
    assert str(got.value) == str(want.value)
    assert str(pq.ParquetFile(path).schema_arrow.field(0).type) in str(got.value)


DECLARED = {
    "dictionary": ("UTF8", pa.array(["b", "a", None, "b", "c"] * 7).dictionary_encode()),
    "duration_ns": ("INT64", pa.array([1, -2, None, 2**40], pa.duration("ns"))),
    "duration_ms": ("INT64", pa.array([5, None, 7], pa.duration("ms"))),
}


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_refused_types_declared_read_as_the_jax_reader(tmp_path, name):
    kind, array = DECLARED[name]
    path = _write(tmp_path, name, array)
    schema = jdf.Schema([jdf.Field(name, getattr(jdf.DataType, kind), True)])
    assert_same_read(path, schema, 3)


MAPPED = {
    "date64": pa.array([0, 86_400_000 * 18_000, None], pa.date64()),
    "large_string": pa.array(["x", "yy", None], pa.large_string()),
    "timestamp_s": pa.array([1, 2, None], pa.timestamp("s")),
    "time32_s": pa.array([1, 2], pa.time32("s")),
}


@pytest.mark.parametrize("name", sorted(MAPPED))
def test_types_the_stored_schema_maps_read_as_the_jax_reader(tmp_path, name):
    path = _write(tmp_path, name, MAPPED[name])
    with ParquetFile(path) as pf:
        assert pf.fields[0].arrow_type == str(pq.ParquetFile(path).schema_arrow.field(0).type)
    try:
        jax_infer(path)
    except jdf.ExecutionError as e:
        with pytest.raises(tdf.ExecutionError) as got:
            infer_parquet_schema(path)
        assert str(got.value) == str(e)
        return
    assert_same_read(path)


@pytest.mark.parametrize("store", [True, False], ids=["stored", "not_stored"])
def test_files_without_the_arrow_schema_read_as_before(tmp_path, store):
    """Without `ARROW:schema` every type comes from the annotations:
    a zoned timestamp reads as UTC, a dictionary as a string, a duration
    as an int64, as pyarrow reads such a file; with it, as stored."""
    table = pa.table({
        "ts": pa.array([0, 3_600_000, None], pa.timestamp("ms", tz="America/New_York")),
        "d": pa.array(["a", "b", "a"]).dictionary_encode(),
        "dur": pa.array([1, 2, 3], pa.duration("ns")),
        "v": pa.array([1.5, None, 2.5]),
    })
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, store_schema=store)
    md = pq.ParquetFile(path).metadata.metadata or {}
    assert (b"ARROW:schema" in md) == store
    want = [str(f.type) for f in pq.ParquetFile(path).schema_arrow]
    with ParquetFile(path) as pf:
        assert [f.arrow_type for f in pf.fields] == want
    if not store:
        assert want == ["timestamp[ms, tz=UTC]", "string", "int64", "double"]
        assert_same_read(path, None, 2)
    schema = jdf.Schema([jdf.Field("ts", jdf.DataType.UTF8, True),
                         jdf.Field("v", jdf.DataType.FLOAT64, True)])
    assert_same_read(path, schema, 2)


# ------------------------------------------------------------ the decoder

FLAT = {
    "b": pa.bool_(), "i8": pa.int8(), "u16": pa.uint16(), "i32": pa.int32(),
    "u64": pa.uint64(), "f16": pa.float16(), "f32": pa.float32(), "f64": pa.float64(),
    "s": pa.string(), "ls": pa.large_string(), "bin": pa.binary(), "lbin": pa.large_binary(),
    "fsb": pa.binary(5), "d32": pa.date32(), "d64": pa.date64(), "t32": pa.time32("s"),
    "t64": pa.time64("ns"), "ts": pa.timestamp("us", tz="Europe/Paris"),
    "tsn": pa.timestamp("ns"), "dur": pa.duration("ms"), "dec": pa.decimal128(12, 3),
    "dec256": pa.decimal256(50, 4), "null": pa.null(),
    "dict": pa.dictionary(pa.int16(), pa.string(), ordered=True),
}


def _stored_value(schema: pa.Schema) -> bytes:
    sink = pa.BufferOutputStream()
    pq.write_table(schema.empty_table(), sink)
    return pq.ParquetFile(pa.BufferReader(sink.getvalue())).metadata.metadata[b"ARROW:schema"]


def test_decoder_gives_pyarrows_names_and_types():
    schema = pa.schema([pa.field(n, t, nullable=(i % 3 != 0) or n == "null")
                        for i, (n, t) in enumerate(FLAT.items())])
    fields = decode_arrow_schema(_stored_value(schema))
    assert [f.name for f in fields] == schema.names
    assert [f.nullable for f in fields] == [f.nullable for f in schema]
    for f, want in zip(fields, schema):
        if pa.types.is_dictionary(want.type):
            assert f.dictionary and f.index_type == "int16" and f.ordered and f.type == "string"
        else:
            assert f.type == str(want.type), f.name
    # the raw IPC framing without the continuation marker reads too
    msg = base64.b64decode(_stored_value(schema))
    assert msg[:4] == b"\xff\xff\xff\xff"
    again = decode_arrow_schema(base64.b64encode(msg[4:]))
    assert again == fields


def _corrupt_file(tmp_path, mutate):
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2])}), path)
    value = pq.ParquetFile(path).metadata.metadata[b"ARROW:schema"]
    blob = open(path, "rb").read()
    assert blob.count(value) == 1
    bad = mutate(value)
    assert len(bad) == len(value)
    with open(path, "wb") as f:
        f.write(blob.replace(value, bad))
    return path


CORRUPTIONS = {
    "not_base64": lambda v: b"!" * len(v),
    "zero_length": lambda v: b"A" * len(v),
    "length_past_the_end": lambda v: base64.b64encode(
        base64.b64decode(v)[:4] + (10**6).to_bytes(4, "little") + base64.b64decode(v)[8:]),
    "garbage_body": lambda v: base64.b64encode(
        base64.b64decode(v)[:8] + bytes(range(256))[:len(base64.b64decode(v)) - 8]),
}


@pytest.mark.parametrize("how", sorted(CORRUPTIONS))
def test_corrupt_arrow_schema_raises_io_error(tmp_path, how):
    path = _corrupt_file(tmp_path, CORRUPTIONS[how])
    with pytest.raises(Exception):
        pq.ParquetFile(path).schema_arrow  # pyarrow refuses it too
    with pytest.raises(tdf.IoError, match="ARROW:schema"):
        infer_parquet_schema(path)
    with pytest.raises(tdf.IoError, match="ARROW:schema"):
        list(tdf.io.readers.ParquetReader(
            path, tdf.Schema([tdf.Field("a", tdf.DataType.INT64)])).batches())


_VALUE = base64.b64decode(_stored_value(pa.schema(
    [pa.field(n, t) for n, t in list(FLAT.items())[:12]])))


def test_mutated_arrow_schema_values_give_io_error_or_a_schema():
    rng = np.random.default_rng(21)
    outcomes = {"raised": 0, "decoded": 0}
    for _ in range(400):
        msg = bytearray(_VALUE)
        for pos in rng.integers(0, len(msg), rng.integers(0, 6)):
            msg[pos] ^= 1 << int(rng.integers(0, 8))
        if rng.random() < 0.3:
            msg = msg[:int(rng.integers(0, len(msg) + 1))]
        try:
            fields = decode_arrow_schema(base64.b64encode(bytes(msg)))
        except tdf.IoError:
            outcomes["raised"] += 1
            continue
        assert all(isinstance(f.type, str) and isinstance(f.name, str) for f in fields)
        outcomes["decoded"] += 1
    assert outcomes["raised"] > 0 and outcomes["decoded"] > 0, outcomes


FAR_ZONES = ["Europe/Berlin", "America/New_York", "Asia/Kolkata", "Australia/Lord_Howe"]


@pytest.mark.parametrize("tz", FAR_ZONES, ids=lambda z: z.replace("/", "_"))
def test_zoned_timestamps_far_from_the_zone_files_transitions_read_as_the_jax_reader(
        tmp_path, tz):
    """Instants before a zone's first transition (local mean time, an
    offset with seconds, which pyarrow prints without them) and after
    the last transition its TZif file lists (2037 for most zones, past
    which pyarrow keeps that transition's offset where zoneinfo applies
    the file's daylight saving rule) read as the JAX package reads them."""
    years = (1700, 1850, 1893, 1916, 1945, 2036, 2037, 2038, 2050, 2087, 2300)
    ms = [int((np.datetime64(f"{y}-{m:02d}-15T12:30:45") - np.datetime64("1970-01-01T00:00"))
              / np.timedelta64(1, "ms")) for y in years for m in (1, 4, 7, 10)]
    path = str(tmp_path / "far.parquet")
    pq.write_table(pa.table({"ts": pa.array(ms, pa.timestamp("ms", tz=tz))}), path)
    assert_same_read(path, None, 9)


def test_a_zone_without_data_raises_io_error_naming_it(tmp_path):
    path = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"ts": pa.array([0, 1], pa.timestamp("ms", tz="Mars/Olympus"))}),
                   path)
    with pytest.raises(tdf.IoError, match="Mars/Olympus"):
        list(tdf.io.readers.ParquetReader(path).batches())
