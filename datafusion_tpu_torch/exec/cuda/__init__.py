"""Hand-written CUDA kernels for Hopper, and their build.

The counterpart of the JAX package's `exec/pallas/`.  Each kernel is a
CUDA C++ source under `datafusion_tpu_torch/csrc/` with a plain C
interface.  It is compiled with `nvcc` for `sm_90a` on first use into
`build/datafusion_tpu_torch/` beside the package, keyed by a hash of
the source and the flags (an edited source rebuilds), and loaded with
`ctypes`.  Processes that build at once (a coordinator and its worker
processes on one machine) each compile into a temporary file of their
own and rename it into place, so a loader finds a whole library or none.

- `hash_agg`: grouped reduce by dense group id (replaces the Pallas
  `hash_agg.grouped_reduce`).
- `hash_build`: direct-address join build (replaces the Pallas
  `hash_build.build_slot_table`).
- `sort_kernel`: stable int64 argsort, an LSD radix sort (replaces the
  Pallas `sort_kernel.argsort_i64` / `argsort_multi`).

There is no probe and no switch that turns a kernel off: a wrapper given
a CUDA tensor launches its kernel or raises; given a CPU tensor it runs
the kernel's plain PyTorch version.  Each wrapper module counts its
launches in a plain int, `LAUNCHES`, read and reset here, and bumped
under `COUNT_LOCK` (the prefetch threads launch too: a join's build runs
on the thread that pulls the scan).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from datafusion_tpu_torch.analysis import lockcheck
from datafusion_tpu_torch.errors import ExecutionError

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "datafusion_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# every kernel source, by the name of the module that wraps it
SOURCES = ("hash_agg", "hash_build", "sort_kernel")

_LIBS: dict = {}
_LOCK = lockcheck.make_lock("exec.kernel_build")
COUNT_LOCK = lockcheck.make_lock("exec.kernel_counts")


def agg_max_groups() -> int:
    """Largest group capacity the grouped-reduce kernel serves; above
    it the aggregate takes its sort-merge route, through the radix-sort
    kernel."""
    return int(os.environ.get("DATAFUSION_TPU_PALLAS_AGG_GROUPS", 8192))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise ExecutionError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library is built already.
    Returns (library path, process or None, temporary output path)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc, tmp


def _finish_build(name: str, out: Path, proc, tmp) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise ExecutionError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build_all() -> float:
    """Build every kernel source that is not built yet, one nvcc per
    source, all started together.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [(name, *_start_build(name)) for name in SOURCES]
        for name, out, proc, tmp in started:
            _finish_build(name, out, proc, tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed.  A build
    counts in the `compile.nvcc` timer and in the ambient operator's
    `compile_s` (the "compile" phase of EXPLAIN ANALYZE)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            t0 = time.perf_counter()
            out, proc, tmp = _start_build(name)
            _finish_build(name, out, proc, tmp)
            lib = _LIBS[name] = ctypes.CDLL(str(out))
            if proc is not None:
                from datafusion_tpu_torch.obs.stats import record_compile
                from datafusion_tpu_torch.utils.metrics import METRICS

                seconds = time.perf_counter() - t0
                METRICS.observe("compile.nvcc", seconds)
                record_compile(seconds)
    return lib


def raw_stream(device) -> int:
    """The current CUDA stream of `device` as a pointer (an int), for a
    C entry point: torch's raw-stream accessor (the one its compiled
    code calls), which makes no Stream object per call."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _modules():
    from datafusion_tpu_torch.exec.cuda import hash_agg, hash_build, sort_kernel

    return {"hash_agg": hash_agg, "hash_build": hash_build,
            "sort_kernel": sort_kernel}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset (the grouped
    reduce's query-axis launches count under `hash_agg`, and alone in
    `hash_agg.MULTI_LAUNCHES`)."""
    return {name: mod.LAUNCHES for name, mod in _modules().items()}


def reset_launch_counts() -> None:
    with COUNT_LOCK:
        for mod in _modules().values():
            mod.LAUNCHES = 0
        _modules()["hash_agg"].MULTI_LAUNCHES = 0
