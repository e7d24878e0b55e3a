"""Process-wide cache of operator cores, and literal parameterization.

The counterpart of the JAX package's `exec/kernels.py`.  An operator
builds its core (expression closures, accumulator slots) through this
registry keyed by the *plan fingerprint*, so a fresh operator tree for
a semantically identical query reuses the core already built.  Numeric
literals become runtime parameters (`parameterize_exprs`), so one core
serves every literal value of the same query shape.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable

# LRU-bounded: string literals stay in fingerprints, so a long-running
# process must not pin every variant forever
_MAX_CORES = int(os.environ.get("DATAFUSION_TPU_KERNEL_CACHE_SIZE", 256))
_REGISTRY: OrderedDict = OrderedDict()


def cached_kernel(key, build: Callable):
    """The cached core for `key`, building it on first use;
    least-recently-used cores evict past the registry bound."""
    hit = _REGISTRY.get(key)
    if hit is None:
        hit = _REGISTRY[key] = build()
        while len(_REGISTRY) > _MAX_CORES:
            _REGISTRY.popitem(last=False)
    else:
        _REGISTRY.move_to_end(key)
    return hit


def parameterize_exprs(exprs):
    """Literal-parameterized fingerprints for a list of Expr trees.

    SURVEY §7 "Recompilation control": with literal values baked into
    the cache key, `WHERE x > <literal>` compiles a distinct kernel per
    value — parameterized workloads recompile forever and churn the
    LRU.  Here numeric literals become runtime scalar kernel arguments:
    the fingerprint replaces each with a ("param", dtype, slot) marker,
    so one core serves every value of `?`.

    Slots are assigned by VALUE-IDENTITY PATTERN, not position: equal
    literal values (same dtype) share a slot, in first-occurrence DFS
    order.  That makes fingerprint equality imply structural kernel
    compatibility — `SUM(x*0.9), AVG(x*0.9)` (pattern [0,0], args
    dedup into one accumulator slot) can never collide with
    `SUM(x*0.8), AVG(x*0.7)` (pattern [0,1], two slots).

    String literals keep their values in the fingerprint: they already
    reach kernels as runtime aux inputs (dictionary codes / compare
    tables), but the aux SPECS embed the string, so cores can only be
    shared between identical string literals.  NULL literals also stay
    in the fingerprint (they compile to a validity constant).

    Returns (fps, slot_by_id, values): one hashable fingerprint per
    expr (None passes through), `slot_by_id` mapping id(Literal node)
    -> slot for the compiler, and the per-slot runtime values as numpy
    scalars.  Callers recompute `values` from their own expr trees —
    identical fingerprints guarantee identical slot assignment.
    """
    from datafusion_tpu_torch.datatypes import DataType
    from datafusion_tpu_torch.plan.expr import (
        AggregateFunction,
        BinaryExpr,
        Cast,
        Column,
        IsNotNull,
        IsNull,
        Literal,
        ScalarFunction,
    )
    import numpy as np

    slot_by_id: dict = {}
    values: list = []
    pattern: dict = {}

    def lit_slot(lit) -> int:
        dt = lit.value.get_datatype()
        key = (repr(dt), repr(lit.value.value))
        slot = pattern.get(key)
        if slot is None:
            slot = pattern[key] = len(values)
            values.append(np.asarray(lit.value.value, dtype=dt.np_dtype))
        slot_by_id[id(lit)] = slot
        return slot

    def fp(e):
        if isinstance(e, Column):
            return ("col", e.index)
        if isinstance(e, Literal):
            if e.value.is_null:
                return ("nulllit", repr(e.value))
            dt = e.value.get_datatype()
            if dt == DataType.UTF8:
                return ("strlit", e.value.value)
            return ("param", repr(dt), lit_slot(e))
        if isinstance(e, Cast):
            return ("cast", repr(e.data_type), fp(e.expr))
        if isinstance(e, IsNull):
            return ("isnull", fp(e.expr))
        if isinstance(e, IsNotNull):
            return ("isnotnull", fp(e.expr))
        if isinstance(e, BinaryExpr):
            return ("bin", e.op, fp(e.left), fp(e.right))
        if isinstance(e, ScalarFunction):
            return ("fn", e.name, tuple(fp(a) for a in e.args))
        if isinstance(e, AggregateFunction):
            return ("agg", e.name, tuple(fp(a) for a in e.args))
        # unknown node: keep it verbatim (its literals stay inline)
        return ("raw", e)

    fps = tuple(None if e is None else fp(e) for e in exprs)
    return fps, slot_by_id, tuple(values)


def schema_fingerprint(schema) -> tuple:
    """Hashable image of a schema as cores see it (positional dtypes +
    nullability; names ride along for dictionary wiring)."""
    return tuple(
        (f.name, repr(f.data_type), f.nullable) for f in schema.fields
    )


def functions_fingerprint(functions) -> tuple:
    """Hashable image of a UDF registry: lowerings are keyed by the
    function objects themselves (not `id(fn)`, whose address a new
    function can reuse after the old one is collected)."""
    if not functions:
        return ()
    return tuple(sorted(functions.items(), key=lambda kv: kv[0]))
