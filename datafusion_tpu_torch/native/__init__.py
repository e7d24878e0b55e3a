"""ctypes bindings for the C++ native runtime: the CSV reader, the
SQL front-end and the Parquet reader.

The counterpart of the JAX package's `native/__init__.py`.  The port's
own CSV reader `datafusion_tpu_torch/native/csv.cpp` (`dtf_csv_*`,
bound by `native/csv.py`), the SQL front-end at the root of the
checkout `native/sql_frontend.cpp` (`dtf_parse_sql`,
`dtf_plan_roundtrip`, `dtf_plan_repr`, `dtf_free`), and the port's own
`datafusion_tpu_torch/native/parquet.cpp` (`dtf_pq_*`, bound by
`native/parquet.py`) with its page decompressors
`datafusion_tpu_torch/native/codecs.cpp` and Brotli's tables
`datafusion_tpu_torch/native/brotli_dictionary.cpp` (generated by
`scripts/port_brotli_dictionary.py`) are compiled into one library on
first use:

    g++ -O3 -std=c++17 -fPIC -shared -pthread datafusion_tpu_torch/native/csv.cpp \
        native/sql_frontend.cpp datafusion_tpu_torch/native/parquet.cpp \
        datafusion_tpu_torch/native/codecs.cpp \
        datafusion_tpu_torch/native/brotli_dictionary.cpp

into `build/native/<hash>/libdatafusion_native.so`, keyed by a hash of
every source and the flags (an edited source rebuilds).  `native/`
itself is never written.  The compiler is `$CXX`, else `g++`.  A
missing compiler or a failed build raises IoError with the compiler's
message; there is no other CSV or Parquet reader to fall back on
(`DATAFUSION_TPU_NATIVE=0` selects the Python SQL parser, see
`sql/parser.parse_sql`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import IoError

REPO = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).with_name("csv.cpp")
SOURCES = (SOURCE, REPO / "native" / "sql_frontend.cpp", Path(__file__).with_name("parquet.cpp"),
           Path(__file__).with_name("codecs.cpp"),
           Path(__file__).with_name("brotli_dictionary.cpp"))
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
LIB_NAME = "libdatafusion_native.so"

_LIB = None
_LOCK = lockcheck.make_lock("native.build")


def _compiler(cxx: Optional[str]) -> str:
    name = cxx or os.environ.get("CXX") or "g++"
    path = shutil.which(name)
    if path is None:
        raise IoError(f"no C++ compiler {name!r}: the native library cannot be built")
    return path


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES:
        try:
            digest.update(path.read_bytes())
        except OSError as e:
            raise IoError(f"cannot read {path}: {e}") from e
    key = digest.hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / key / LIB_NAME


def build_library(build_dir: Optional[Path] = None, cxx: Optional[str] = None) -> Path:
    """Compile the library unless it is built already; returns its
    path.  The compiler writes a name of its own and the result is
    renamed into place, so builds that race (test workers) each see a
    whole library or none."""
    out = library_path(build_dir)
    if out.exists():
        return out
    compiler = _compiler(cxx)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            [compiler, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise IoError(f"native library build failed: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise IoError(
            f"native library build failed ({compiler}, exit {proc.returncode}):\n"
            f"{proc.stderr or proc.stdout}"
        )
    os.replace(tmp, out)
    return out


def _configure(lib) -> None:
    lib.dtf_csv_open.restype = ctypes.c_void_p
    lib.dtf_csv_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
    ]
    lib.dtf_csv_error.restype = ctypes.c_char_p
    lib.dtf_csv_error.argtypes = [ctypes.c_void_p]
    lib.dtf_csv_next.restype = ctypes.c_int64
    lib.dtf_csv_next.argtypes = [ctypes.c_void_p]
    for fn in ("dtf_csv_col_data", "dtf_csv_col_validity", "dtf_csv_dict_bytes",
               "dtf_csv_dict_offsets"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.dtf_csv_dict_size.restype = ctypes.c_int32
    lib.dtf_csv_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.dtf_csv_close.restype = None
    lib.dtf_csv_close.argtypes = [ctypes.c_void_p]
    # the SQL front-end: restype c_void_p (not c_char_p) so the malloc'd
    # string survives for string_at and dtf_free
    for fn in ("dtf_parse_sql", "dtf_plan_roundtrip", "dtf_plan_repr"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_void_p
        f.argtypes = [ctypes.c_char_p]
    lib.dtf_free.restype = None
    lib.dtf_free.argtypes = [ctypes.c_void_p]


def load_library():
    """The loaded library with its entry points declared, built first
    if needed."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                path = build_library()
                try:
                    lib = ctypes.CDLL(str(path))
                    _configure(lib)
                except (OSError, AttributeError) as e:
                    raise IoError(f"cannot load {path}: {e}") from e
                _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the native library builds and loads here (False where
    no compiler is found or the build fails)."""
    try:
        return load_library() is not None
    except IoError:
        return False
