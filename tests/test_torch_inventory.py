"""The port's completeness guard: every public name of the JAX package
has a counterpart in the port, or an entry in `EXCEPTIONS`.

Both packages are walked with `ast`.  A name is a module-level function
or class, or a method of a module-level class, whose every dotted part
is public (no leading underscore; dunder methods count).  Its
counterpart is the same name in the port's module of the same path: a
definition there, a module-level import into it, or, for a method, a
definition in the class or in a base class of the port (looked up by
name across the port).  A name the JAX package gains later fails
`test_every_public_name_has_a_counterpart` until it is ported or
entered below with its reason and its ROADMAP item.
"""

from __future__ import annotations

import ast
import fnmatch
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "datafusion_tpu"
PORT_ROOT = REPO / "datafusion_tpu_torch"

_TPU_ONLY_ITEM_6 = (
    "a link-aware route of the data plane: it pays only on a slow link "
    "(ROADMAP item 6); the H100's link is fast and the port's pulls block"
)
_XLA_RECOMPILE = (
    "bounds XLA recompiles, one program per ladder rung; eager torch "
    "compiles nothing per group size (exec/fused.py docstring, item 6)"
)

# "module path:name" (fnmatch patterns) -> (reason, ROADMAP item)
EXCEPTIONS: dict[str, tuple[str, str]] = {
    "exec/pallas/*.py:*": (
        "the Pallas kernels: each is a hand-written sm_90a kernel under "
        "datafusion_tpu_torch/csrc/*.cu, wrapped by exec/cuda/*.py",
        "queue 2"),
    "exec/fused.py:stack_entries": (_XLA_RECOMPILE, "item 6"),
    "exec/fused.py:bucket_group": (_XLA_RECOMPILE, "item 6"),
    "exec/fused.py:pad_group": (_XLA_RECOMPILE, "item 6"),
    "cost/advisor.py:pallas_agg_window": (
        "the Pallas route's learned window; the port's is "
        "cost/advisor's route history over the CUDA kernels", "item 6"),
    "cost/advisor.py:pallas_sort_window": (
        "the Pallas route's learned window; the port's is "
        "cost/advisor's route history over the CUDA kernels", "item 6"),
    "cost/advisor.py:scan_chunk_rows": (
        "the learned scan chunk, a link-aware route (about 2,200 bytes "
        "a row)", "item 6"),
    "io/readers.py:CsvReader*": (
        "the JAX package's pyarrow CSV reader; the port parses CSV "
        "through native/datafusion_native.cpp (native/csv.py), and the "
        "card's machine has no pyarrow", "item 1"),
    "parallel/partition.py:shard_map": (
        "the mesh's shard_map stacking, a JAX collective; the port's "
        "mesh folds each device's slots into one state", "item 6"),
    "obs/device.py:DeviceLedger.put": (
        "jax.device_put through the ledger; the port's copy seam is "
        "exec/batch.to_device / put_compressed, which adopt", "item 6"),
    "obs/device.py:DeviceLedger.transfer": (
        "jax.device_put between devices through the ledger; the port's "
        "copy seam is exec/batch.to_device / on_device", "item 6"),
    "obs/device.py:DeviceLedger.note_h2d": (
        "the port's is the module-level obs/device.note_h2d, called by "
        "the copy seam", "item 6"),
    "exec/batch.py:PendingPull*": (_TPU_ONLY_ITEM_6, "item 6"),
    "exec/batch.py:device_pull_start": (_TPU_ONLY_ITEM_6, "item 6"),
    "exec/materialize.py:compact_dispatch": (_TPU_ONLY_ITEM_6, "item 6"),
    "exec/materialize.py:iter_with_mask_prefetch": (_TPU_ONLY_ITEM_6, "item 6"),
    "serve.py:PinnedSource.reusable_batches": (
        "marks batches the link-aware placement ships once; the port "
        "caches each pinned batch's tensors on the batch", "item 6"),
    "serve.py:enabled": (
        "DATAFUSION_TPU_SERVE, read only by the JAX package's TPU "
        "bench; the port's `ExecutionContext.serve` needs no switch",
        "item 6"),
    "exec/relation.py:device_scope": (
        "jax.default_device placement; every port operator is given "
        "its torch.device", "item 6"),
    "exec/aggregate.py:force_core_predicate": (
        "keeps the predicate in the XLA core so a megabatch shares one "
        "compiled program; the port's megabatch shares its core's "
        "eager passes without it", "item 6"),
    "exec/expression.py:Env.cols": (
        "the jit-traced column view; the port's Env reads "
        "Env.col(i) / Env.valid(i)", "item 6"),
    "exec/expression.py:Env.valids": (
        "the jit-traced validity view; the port's Env reads "
        "Env.col(i) / Env.valid(i)", "item 6"),
    "exec/expression.py:Env.__getitem__": (
        "the jit-traced column view; the port's Env reads "
        "Env.col(i) / Env.valid(i)", "item 6"),
}


def _public(name: str) -> bool:
    return all(not p.startswith("_") or (p.startswith("__") and p.endswith("__"))
               for p in name.split("."))


def _module_names(root: Path):
    """{relative path: (names defined, names imported)} and the class
    index {class name: (methods, base names)}."""
    modules, classes = {}, {}
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"))
        defined, imported = set(), set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defined.add(node.name)
            elif isinstance(node, ast.ClassDef):
                defined.add(node.name)
                methods = {m.name for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
                defined.update(f"{node.name}.{m}" for m in methods)
                bases = [b.id if isinstance(b, ast.Name) else
                         b.attr if isinstance(b, ast.Attribute) else None
                         for b in node.bases]
                classes.setdefault(node.name, (methods, [b for b in bases if b]))
            elif isinstance(node, ast.ImportFrom):
                imported.update(a.asname or a.name for a in node.names)
        modules[path.relative_to(root).as_posix()] = (defined, imported)
    return modules, classes


def _has_method(classes: dict, cls: str, method: str, seen=()) -> bool:
    if cls not in classes or cls in seen:
        return False
    methods, bases = classes[cls]
    return method in methods or any(
        _has_method(classes, b, method, (*seen, cls)) for b in bases)


def _missing() -> list[str]:
    jax_modules, _ = _module_names(JAX_ROOT)
    port_modules, port_classes = _module_names(PORT_ROOT)
    out = []
    for rel, (names, _) in sorted(jax_modules.items()):
        defined, imported = port_modules.get(rel, (set(), set()))
        for name in sorted(n for n in names if _public(n)):
            if name in defined or name in imported:
                continue
            if "." in name:
                cls, method = name.split(".", 1)
                if cls in defined and _has_method(port_classes, cls, method):
                    continue
            out.append(f"{rel}:{name}")
    return out


def _excepted(key: str) -> bool:
    return any(fnmatch.fnmatchcase(key, pat) for pat in EXCEPTIONS)


def test_every_public_name_has_a_counterpart():
    unported = [k for k in _missing() if not _excepted(k)]
    assert not unported, (
        "public names of datafusion_tpu/ with no counterpart in "
        "datafusion_tpu_torch/ (port them, or enter them in EXCEPTIONS "
        "with a reason and a ROADMAP item):\n  " + "\n  ".join(unported))


def test_every_exception_is_still_missing():
    """A stale entry (the name was ported, or the JAX package dropped
    it) leaves the table claiming a gap that is not there."""
    missing = _missing()
    stale = [pat for pat in EXCEPTIONS
             if not any(fnmatch.fnmatchcase(k, pat) for k in missing)]
    assert not stale, f"EXCEPTIONS entries with nothing missing: {stale}"


def test_every_exception_has_a_reason_and_an_item():
    for pat, (reason, item) in EXCEPTIONS.items():
        assert len(reason) > 20 and (item.startswith("item ") or item.startswith("queue ")), pat
