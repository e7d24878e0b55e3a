"""Stable int64 argsort: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas kernel `sort_kernel.argsort_i64` / `argsort_multi`
of the JAX package (`datafusion_tpu/exec/pallas/sort_kernel.py`,
pallas_call at line 89): the stable ascending permutation (int32) of
one or more int64 key operands, ops[0] most significant.  Keys compose
as `argsort_multi` composes them: sort by the last key, then re-sort by
each earlier key gathered through the running permutation.

The kernel (`csrc/sort_kernel.cu`) is an LSD radix sort after the
onesweep scheme, 8 bits per pass, stable by construction and without a
run-size window (the TPU kernel's 2^18-row window was its VMEM).  One
wrapper call first counts every digit of every key in one histogram
launch and copies the largest count of each digit (k x 8 int32) to the
host; a digit whose one bucket holds all n rows is the same in every
key, and its pass is skipped.  Each remaining digit is one launch
(tile ranking in shared memory, decoupled look-back for the global
offsets, coalesced writes), so a key of P varying digits costs P
launches, and a key that is constant (an all-false NULL flag) none.  It is bound by device
memory; the source says more.

`argsort_multi` takes the kernel for CUDA tensors and the plain
version, `argsort_multi_torch` (chained `torch.sort(stable=True)`), for
CPU tensors; there is no other route.  `LAUNCHES` counts wrapper calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.gate import host_wait

LAUNCHES = 0

THREADS = 256  # threads of a pass's block (csrc/sort_kernel.cu kThreads)
ITEMS = 15  # rows per thread in a pass (kItems)
TILE = THREADS * ITEMS  # rows per tile of a pass (kTile)
RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
DIGITS = 64 // RADIX_BITS  # 8-bit digits of a 64-bit key
_MAX_ROWS = 2**31 - 1  # the permutation is int32


def _check(ops) -> list:
    ops = list(ops)
    if not ops:
        raise ValueError("argsort needs at least one key")
    n = None
    for i, op in enumerate(ops):
        if not isinstance(op, torch.Tensor) or op.dim() != 1:
            raise ValueError(f"key {i} must be a 1-D tensor")
        if op.dtype != torch.int64:
            raise ValueError(f"key {i} must be int64, got {op.dtype}")
        if n is None:
            n = op.shape[0]
        elif op.shape[0] != n:
            raise ValueError(f"key {i} has {op.shape[0]} rows, key 0 has {n}")
        if op.device != ops[0].device:
            raise ValueError(f"key {i} is on {op.device}, key 0 on {ops[0].device}")
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 permutation")
    return ops


def argsort_multi_torch(ops):
    """Plain PyTorch version: chained stable sorts, last key first (the
    composition of `argsort_multi` in the Pallas module)."""
    ops = _check(ops)
    perm = None
    for op in reversed(ops):
        if perm is None:
            perm = torch.sort(op, stable=True).indices
        else:
            perm = perm[torch.sort(op[perm], stable=True).indices]
    return perm.to(torch.int32)


def digit_mask(tops, n: int) -> int:
    """Bit b set when 8-bit digit b differs between some two of the n
    keys: the largest bucket of its histogram (`tops[b]`, the most of
    its 256 counts) holds fewer than all n rows."""
    return sum(1 << b for b, top in enumerate(tops) if top < n)


_FNS = None


def _kernel_fns():
    """The kernel library's entry points with their C signatures."""
    global _FNS
    if _FNS is None:
        from datafusion_tpu_torch.exec import cuda as _cuda

        lib = _cuda.load("sort_kernel")
        hist = lib.df_radix_histograms
        hist.restype = ctypes.c_int
        hist.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_void_p, ctypes.c_void_p]
        sort_key = lib.df_radix_sort_key
        sort_key.restype = ctypes.c_int
        sort_key.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p,
        ]
        _FNS = (hist, sort_key)
    return _FNS


def _launch(ops):
    global LAUNCHES
    from datafusion_tpu_torch.exec import cuda as _cuda

    for i, op in enumerate(ops):
        if not op.is_contiguous():
            raise ExecutionError(f"argsort kernel needs contiguous key {i}")
    dev = ops[0].device
    n = ops[0].shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(ops)
    hist_fn, sort_fn = _kernel_fns()
    stream = _cuda.raw_stream(dev)
    k = len(ops)
    hist = torch.empty((k, DIGITS, RADIX), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * k)(*(op.data_ptr() for op in ops))
    rc = hist_fn(ctypes.cast(ptrs, ctypes.c_void_p), k, n, hist.data_ptr(), stream)
    if rc != 0:
        raise ExecutionError(f"argsort kernel launch failed: CUDA error {rc}")
    keys_a = torch.empty(n, dtype=torch.int64, device=dev)
    keys_b = torch.empty_like(keys_a)
    idx_a = torch.empty(n, dtype=torch.int32, device=dev)
    idx_b = torch.empty_like(idx_a)
    status = torch.empty(-(-n // TILE) * RADIX + 1, dtype=torch.int64, device=dev)
    # the largest bucket of each digit, k x 8 ints, is all the host reads
    with host_wait():
        tops_all = hist.amax(dim=2).cpu().tolist()  # df-lint: ok(DF001) — the digit tops, k x 8 ints a sort, under host_wait
    masks = [digit_mask(tops, n) for tops in tops_all]
    in_b = ctypes.c_int(0)
    perm = None
    for i in reversed(range(k)):
        if masks[i] == 0:
            continue  # a constant key reorders nothing
        rc = sort_fn(ops[i].data_ptr(), 0 if perm is None else perm.data_ptr(), n,
                     masks[i], hist[i].data_ptr(), keys_a.data_ptr(),
                     keys_b.data_ptr(), idx_a.data_ptr(), idx_b.data_ptr(),
                     status.data_ptr(), ctypes.byref(in_b), stream)
        if rc != 0:
            raise ExecutionError(f"argsort kernel launch failed: CUDA error {rc}")
        perm = idx_b if in_b.value else idx_a
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    if perm is None:
        return torch.arange(n, dtype=torch.int32, device=dev)
    return perm


def argsort_multi(ops):
    """Stable lexicographic ascending argsort of int64 key tensors
    (ops[0] most significant) as an int32 permutation on their device."""
    ops = _check(ops)
    dev = ops[0].device
    if dev.type == "cpu":
        return argsort_multi_torch(ops)
    if dev.type != "cuda":
        raise ExecutionError(f"argsort runs on cuda or cpu, not {dev}")
    return _launch(ops)


def argsort_i64(keys):
    """Stable ascending argsort of one int64 key tensor (int32)."""
    return argsort_multi([keys])
