"""Stable int64 argsort: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas kernel `sort_kernel.argsort_i64` / `argsort_multi`
of the JAX package (`datafusion_tpu/exec/pallas/sort_kernel.py`,
pallas_call at line 89): the stable ascending permutation (int32) of
one or more int64 key operands, ops[0] most significant.  Keys compose
as `argsort_multi` composes them: sort by the last key, then re-sort by
each earlier key gathered through the running permutation.

The kernel (`csrc/sort_kernel.cu`) is an LSD radix sort, 4 bits per
pass, stable by construction and without a run-size window (the TPU
kernel's 2^18-row window was its VMEM).  One wrapper call first takes
the AND and OR of every key (one launch per key, then one 16-byte copy
to the host per call) and skips each digit that is the same in every
key, so a key costs 1 + 3 * P launches for its P varying digits, and a
key that is constant (an all-false NULL flag) costs none.  It is bound
by device memory; the source says more.

`argsort_multi` takes the kernel for CUDA tensors and the plain
version, `argsort_multi_torch` (chained `torch.sort(stable=True)`), for
CPU tensors; there is no other route.  `LAUNCHES` counts wrapper calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from datafusion_tpu_torch.errors import ExecutionError

LAUNCHES = 0

TILE = 4096  # rows per tile of a pass (csrc/sort_kernel.cu kTile)
DIGITS = 16  # 4-bit digits of a 64-bit key
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


def digit_mask(and_bits: int, or_bits: int) -> int:
    """Bit d set when 4-bit digit d differs between some two keys (the
    digits where the AND and the OR of all keys disagree)."""
    diff = (and_bits ^ or_bits) & 0xFFFF_FFFF_FFFF_FFFF
    return sum(1 << d for d in range(DIGITS) if (diff >> (4 * d)) & 0xF)


_FNS = None


def _kernel_fns():
    """The kernel library's entry points with their C signatures."""
    global _FNS
    if _FNS is None:
        from datafusion_tpu_torch.exec import cuda as _cuda

        lib = _cuda.load("sort_kernel")
        andor = lib.df_radix_andor
        andor.restype = ctypes.c_int
        andor.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p]
        sort_key = lib.df_radix_sort_key
        sort_key.restype = ctypes.c_int
        sort_key.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _FNS = (andor, sort_key)
    return _FNS


def _launch(ops):
    global LAUNCHES
    for i, op in enumerate(ops):
        if not op.is_contiguous():
            raise ExecutionError(f"argsort kernel needs contiguous key {i}")
    dev = ops[0].device
    n = ops[0].shape[0]
    andor_fn, sort_fn = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bits = torch.zeros((len(ops), 2), dtype=torch.int64, device=dev)
        bits[:, 0] = -1  # AND starts from all ones
        for i, op in enumerate(ops):
            rc = andor_fn(op.data_ptr(), n, bits[i].data_ptr(), stream)
            if rc != 0:
                raise ExecutionError(f"argsort kernel launch failed: CUDA error {rc}")
        masks = [digit_mask(a, o) for a, o in bits.cpu().tolist()]
        keys_a = torch.empty(n, dtype=torch.int64, device=dev)
        keys_b = torch.empty_like(keys_a)
        idx_a = torch.empty(n, dtype=torch.int32, device=dev)
        idx_b = torch.empty_like(idx_a)
        hist = torch.empty(DIGITS * max(1, -(-n // TILE)), dtype=torch.int32,
                           device=dev)
        perm = None
        for op, mask in zip(reversed(ops), reversed(masks)):
            if mask == 0:
                continue  # a constant key reorders nothing
            rc = sort_fn(op.data_ptr(), 0 if perm is None else perm.data_ptr(), n,
                         mask, keys_a.data_ptr(), idx_a.data_ptr(),
                         keys_b.data_ptr(), idx_b.data_ptr(), hist.data_ptr(),
                         stream)
            if rc != 0:
                raise ExecutionError(f"argsort kernel launch failed: CUDA error {rc}")
            perm = idx_a if bin(mask).count("1") % 2 == 0 else idx_b
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
