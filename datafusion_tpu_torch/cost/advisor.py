"""Decision functions: turn accumulated observations into plans (the
JAX package's `cost/advisor.py`).

Each function answers one planner question and, where it deviates from
the static default, records a chosen-vs-default decision on the store.
Every function degrades to None or the static default when the store
has nothing relevant: a cold store plans exactly as the static engine.

The grouped-reduce window (`agg_window`) is the JAX package's
`pallas_agg_window` rule over the port's two aggregate routes: the
grouped-reduce kernel (``agg:grouped_reduce``, `csrc/hash_agg.cu`) up to
the window, sort-merge through the radix-sort kernel
(``agg:sortmerge``) above it.  Route history is kept under
`cost.CUDA_KEY`, never under the JAX package's `PALLAS_KEY`, and only
from runs on the card (the plain versions a CPU run takes are not
evidence about the kernels), timed by CUDA event pairs around the
aggregate's passes (exec/aggregate.py).  A pass over fewer than
`MIN_ROUTE_ROWS` rows is not timed, and an aggregate with fewer is not
observed: its time is launch overhead, not a per-row cost, and the JAX
package's dense one-hot route, which kept such passes out of its
history there, has no counterpart here.  The sort has one route at every size (the radix
kernel): its runs are observed (``sort:radix``) for the record, and no
window sends a sort anywhere else.
"""

from __future__ import annotations

from typing import Optional

from datafusion_tpu_torch import cost as _cost

_MIN_ROUTE_SAMPLES = 3
# one default batch: the smallest pass whose time says something per row
MIN_ROUTE_ROWS = 1 << 17


def agg_shape(group_names) -> str:
    # sorted: GROUP BY a,b and GROUP BY b,a have one group cardinality
    return "agg:g=" + ",".join(sorted(group_names))


def agg_group_estimate(store, tkey: str, group_names) -> Optional[int]:
    """Learned distinct-group count of GROUP BY `group_names` over table
    `tkey` (None when never observed)."""
    rec = store.lookup(tkey, agg_shape(group_names))
    if rec is None:
        return None
    g = rec.get("groups_max", rec.get("groups_last"))
    return int(g) if g else None


def table_rows(store, tkey: str) -> Optional[int]:
    """Learned row count of a table (from completed scans and the serving
    megabatch's passes)."""
    rec = store.lookup(tkey, "scan")
    if rec is None:
        return None
    rows = rec.get("rows_max", rec.get("rows_last"))
    return int(rows) if rows else None


# -- the grouped-reduce window ----------------------------------------

def observe_agg_route(store, route: str, group_cap: int, exec_s: float,
                      rows: float) -> None:
    """One aggregate's route evidence: ``grouped_reduce`` or
    ``sortmerge``, its capacity, the device time of its passes (CUDA
    events, exec/aggregate.py) and its rows."""
    if rows < MIN_ROUTE_ROWS:
        return
    store.observe(_cost.CUDA_KEY, f"agg:{route}", cap=group_cap, exec_s=exec_s,
                  s_per_row=exec_s / rows)


def agg_window(store=None) -> int:
    """The largest group capacity routed to the grouped-reduce kernel.
    `agg_max_groups()` unless route history says otherwise: with at
    least `_MIN_ROUTE_SAMPLES` runs of each route, a grouped reduce
    slower per row than 1.5 x sort-merge shrinks the window to 0 (every
    aggregate sorts); one faster per row than sort-merge that has run at
    the ceiling doubles it, to 2 x agg_max_groups() at most."""
    from datafusion_tpu_torch.exec.cuda import agg_max_groups

    static = agg_max_groups()
    if store is None:
        if not _cost.enabled():
            return static
        store = _cost.store()
    red = store.lookup(_cost.CUDA_KEY, "agg:grouped_reduce")
    srt = store.lookup(_cost.CUDA_KEY, "agg:sortmerge")
    if red is None or red.get("n", 0) < _MIN_ROUTE_SAMPLES:
        return static
    if srt is not None and srt.get("n", 0) >= _MIN_ROUTE_SAMPLES:
        if red.get("s_per_row", 0) > 1.5 * srt.get("s_per_row", 0) > 0:
            store.note_decision(
                "agg.window", 0, static,
                f"grouped reduce {red['s_per_row']:.2e} s/row vs sort-merge "
                f"{srt['s_per_row']:.2e} over {int(red['n'])} runs",
            )
            return 0
        if (red.get("cap_max", 0) >= static
                and 0 < red.get("s_per_row", 0) < srt.get("s_per_row", 0)):
            widened = 2 * static
            if widened > static:
                store.note_decision(
                    "agg.window", widened, static,
                    f"grouped reduce faster per row at cap {int(red['cap_max'])}",
                )
            return widened
    return static


def observe_sort_route(store, route: str, rows: float, exec_s: float) -> None:
    if rows < MIN_ROUTE_ROWS:
        return
    store.observe(_cost.CUDA_KEY, f"sort:{route}", rows=rows, exec_s=exec_s,
                  s_per_row=exec_s / rows)


# -- serving megabatch window -----------------------------------------

def serve_window_s(store, configured_s: float) -> float:
    """Adaptive megabatch window from the observed arrival spacing.

    The configured window is a maximum wait for co-batchable peers.
    Arrivals much sparser than it (spacing above 4x) shrink it to an
    eighth, floored at 0.1 ms: waiting buys nothing but queue wait.
    Dense arrivals (spacing under a quarter) stretch it by twice the
    spacing, to 2x at most, so megabatches fill closer to their size
    trigger."""
    iv = store.value(_cost.SERVE_KEY, "arrivals", "interval_s")
    if not iv:
        return configured_s
    if iv > 4 * configured_s:
        return max(configured_s / 8, 1e-4)
    if iv < configured_s / 4:
        return min(2 * configured_s, configured_s + 2 * iv)
    return configured_s
