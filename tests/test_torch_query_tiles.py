"""PyTorch/CUDA port: the grouped reduce's query tiles, on the CPU.

One launch of the query axis (`hash_agg.grouped_reduce_multi`) runs its
Q queries in query tiles (`hash_agg.query_tiles`): each tile is one
sweep of the rows that reads the ids, and shared values, once and folds
them into every query of the tile.  Here, at the H100's constants, the
schedule is checked (every query in exactly one pass, a tile's partials
fit shared memory, a tile is at least one query, each query keeps its
solo launch's geometry; Q1's group holds 8 queries a pass at G = 8 f64
and one at G = 4096 f64), and a numpy model of the tiled kernel's order
of f64 additions (csrc/hash_agg.cu: passes, group tiles, blocks, warps,
batches of ITEMS steps, query blocks, queries, steps, with each query's
live bytes taken from the four words a lane loads) is held bit for bit
against the solo order model `_reduce_model` of tests/test_torch_kernels.py
for every query, and within rtol 1e-12 against the JAX package's numpy
oracle `grouped_reduce_numpy`.  The plain version of the query axis is
held against that oracle for every query at the tile edges.  The kernel
itself runs in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from datafusion_tpu.exec.pallas import hash_agg as pallas_hash_agg
from datafusion_tpu_torch.exec.cuda import hash_agg
from tests import test_torch_kernels as solo_model

H100 = solo_model.H100
QUERY_BLOCK = 8  # csrc/hash_agg.cu kQueryBlock: live masks a warp loads at once


def _tile_bytes(tile, warps, tile_g, lane_parts, itemsize):
    """Shared memory of a query tile: each query's partials side by
    side, then (without lane_parts) the warps' tag bytes once."""
    if lane_parts:
        return tile * warps * tile_g * 32 * itemsize
    return tile * warps * tile_g * itemsize + warps * tile_g


def _passes(q, tile):
    """The kernel's pass loop: queries [q0, q0 + tile), the last pass
    the rest."""
    return [list(range(q0, min(q, q0 + tile))) for q0 in range(0, q, tile)]


@pytest.mark.parametrize("n,g,itemsize", [
    (46 * 131_072, 8, 8), (46 * 131_072, 64, 8), (46 * 131_072, 8, 4),
    (8 * 524_288, 16, 8), (8 * 524_288, 4096, 8), (1_000_000, 200, 8),
    (70_001, 114, 8), (70_001, 25828, 8), (70_001, 32768, 8), (255, 4, 1),
    (0, 8, 8), (524_288, 8192, 8), (100_000, 1, 2)])
@pytest.mark.parametrize("q", [1, 2, 8, 13, 14, 15, 16, 32])
def test_every_query_lies_in_exactly_one_pass(n, g, itemsize, q):
    sms, smem = H100
    solo = hash_agg.geometry(n, g, itemsize, sms, smem)
    tile, passes = hash_agg.query_tiles(n, g, itemsize, sms, smem, q)
    warps, tile_g, lane_parts = solo[:3]
    assert 1 <= tile <= q
    assert passes == -(-q // tile)
    sweeps = _passes(q, tile)
    assert len(sweeps) == passes
    assert sorted(j for s in sweeps for j in s) == list(range(q))
    assert _tile_bytes(tile, warps, tile_g, lane_parts, itemsize) <= smem
    # the fewest passes: one query more a pass would not fit, or none is needed
    fit = max(t for t in range(1, q + 1)
              if t == 1 or _tile_bytes(t, warps, tile_g, lane_parts, itemsize) <= smem)
    assert passes == -(-q // fit)
    # every query keeps its solo launch's geometry, and a solo call is
    # one query in one pass
    assert hash_agg.geometry(n, g, itemsize, sms, smem) == solo
    assert hash_agg.query_tiles(n, g, itemsize, sms, smem, 1) == (1, 1)


def test_q1_group_holds_eight_queries_a_pass_and_4096_groups_one():
    sms, smem = H100
    n = 46 * 131_072
    assert hash_agg.query_tiles(n, 8, 8, sms, smem, 8) == (8, 1)
    tile, passes = hash_agg.query_tiles(n, 8, 8, sms, smem, 32)
    assert passes == -(-32 // 14) and tile * passes >= 32  # 14 tiles of G = 8 f64 fit
    assert hash_agg.query_tiles(n, 8, 8, sms, smem, 14) == (14, 1)
    assert hash_agg.query_tiles(n, 8, 8, sms, smem, 15) == (8, 2)
    assert hash_agg.query_tiles(8 * 524_288, 4096, 8, sms, smem, 4) == (1, 4)
    assert hash_agg.query_tiles(n, 64, 8, sms, smem, 8) == (1, 8)
    # the tag route holds several queries a tile where its partials are small
    assert hash_agg.query_tiles(1_000_000, 200, 8, sms, smem, 16) == (16, 1)


def _live_words(live, base):
    """The four words a lane loads (csrc/hash_agg.cu load_live): word k
    of lane l holds rows base + 128 k + 4 l .. + 3, also rows past the
    warp's slice (which the fold skips: their rel is -1); bytes past the
    mask's end zero."""
    words = np.zeros((4, 32), dtype=np.uint32)
    for k in range(4):
        for lane in range(32):
            for b in range(4):
                r = base + 128 * k + 4 * lane + b
                if r < len(live) and live[r]:
                    words[k, lane] |= np.uint32(1) << np.uint32(8 * b)
    return words


def _live_bits(words, j):
    """Item j's live byte for every lane, as fold_query shuffles it:
    byte l & 3 of word j >> 2 of lane 8 (j & 3) + (l >> 2)."""
    lanes = np.arange(32)
    word = words[j >> 2, 8 * (j & 3) + (lanes >> 2)]
    return ((word >> (8 * (lanes & 3)).astype(np.uint32)) & 0xFF) != 0


def _tiled_model(ids, vals, live, g, sms, smem):
    """The tiled kernel's order of f64 additions, in numpy: per pass of
    query_tiles' tile, per group tile, block, owning warp and batch of
    ITEMS 32-row steps, the batch's ids (and shared values) once, then
    each query of the pass in query blocks, its live bytes from its load
    words, its rows folded into its own partials step by step (lane
    partials, or peer sets reduced by `_tree`; the kernel interleaves a
    block's lane folds step by step, which leaves each query's order as
    here, its partials being its own); then each query's block combine
    and its fold across chunks as in `_reduce_model`."""
    q, n = live.shape
    shared = vals.ndim == 1
    warps, tile_g, lane_parts, blocks, chunk_rows, lanes = hash_agg.geometry(
        n, g, 8, sms, smem)
    tile, passes = hash_agg.query_tiles(n, g, 8, sms, smem, q)
    per_warp = chunk_rows // warps
    items = hash_agg.ITEMS
    scratch = np.zeros((q, blocks, g))
    for sweep in _passes(q, tile):
        for g0 in range(0, g, tile_g):
            tg = min(tile_g, g - g0)
            for b in range(blocks):
                shape = (warps, tg, 32) if lane_parts else (warps, tg)
                part = {j: np.zeros(shape) for j in sweep}
                for w in range(warps):
                    r0 = b * chunk_rows + w * per_warp
                    r1 = min(n, r0 + per_warp)
                    for base in range(r0, r1, 32 * items):
                        steps = min(items, (r1 - base + 31) // 32)
                        # the batch's ids, once for every query of the pass
                        rows = base + 32 * np.arange(items)[:, None] + np.arange(32)[None, :]
                        inside = rows < r1
                        safe = np.where(inside, rows, 0)
                        rel = np.where(inside & (ids[safe] >= g0) & (ids[safe] - g0 < tg),
                                       ids[safe] - g0, -1)
                        for q0 in range(0, len(sweep), QUERY_BLOCK):
                            for j in sweep[q0:q0 + QUERY_BLOCK]:
                                words = _live_words(live[j], base)
                                v = vals[safe] if shared else vals[j][safe]
                                for s in range(steps):
                                    gid = np.where(_live_bits(words, s), rel[s], -1)
                                    hit = gid >= 0
                                    if lane_parts:
                                        lane = np.arange(32)[hit]
                                        part[j][w, gid[hit], lane] = (
                                            part[j][w, gid[hit], lane] + v[s][hit])
                                        continue
                                    for key in np.unique(gid[hit]):
                                        part[j][w, key] = (part[j][w, key]
                                                           + solo_model._tree(v[s][gid == key]))
                for j in sweep:
                    acc = part[j][0].copy()
                    for w in range(1, warps):
                        acc = acc + part[j][w]
                    scratch[j, b, g0:g0 + tg] = (solo_model._shuffle_tree(acc.T)
                                                 if lane_parts else acc)
    out = np.zeros((q, g))
    for j in range(q):
        lane_acc = np.zeros((lanes, g))
        for s in range(lanes):
            for c in range(s, blocks, lanes):
                lane_acc[s] = lane_acc[s] + scratch[j, c]
        out[j] = solo_model._shuffle_tree(lane_acc)
    return out


# two SMs, so a warp sweeps several batches and a partial last one
_SMS = (2, H100[1])


@pytest.mark.parametrize("n,g,q", [(20_000, 8, 16), (20_000, 8, 5), (9_001, 33, 5),
                                   (9_001, 200, 6), (3_001, 4096, 2), (1, 8, 3),
                                   (20_003, 1, 15)])
@pytest.mark.parametrize("shared", [True, False])
def test_tiled_schedule_replays_each_querys_solo_order(monkeypatch, n, g, q, shared):
    rng = np.random.default_rng(n + g + q)
    ids = rng.integers(-2, g + 2, n).astype(np.int32)
    ids[: min(n, 40)] = 0  # a run of equal ids: peer sets of a whole step
    live = rng.random((q, n)) > 0.3
    vals = rng.uniform(1.0, 1e3, (n,) if shared else (q, n))
    got = _tiled_model(ids, vals, live, g, *_SMS)
    monkeypatch.setattr(solo_model, "H100", _SMS)
    for j in range(q):
        v = vals if shared else vals[j]
        solo = solo_model._reduce_model(ids, v, live[j], g)
        assert np.array_equal(got[j].view(np.int64), solo.view(np.int64)), j
        want = pallas_hash_agg.grouped_reduce_numpy(ids, v, live[j], g, "sum")
        np.testing.assert_allclose(got[j], want, rtol=1e-12)


@pytest.mark.parametrize("g,q", [(8, 14), (8, 15), (8, 32), (200, 16), (4096, 4)])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("shared", [True, False])
def test_plain_query_axis_matches_oracle_for_every_query(g, q, kind, shared):
    rng = np.random.default_rng(g * q)
    n = 7_001
    ids = rng.integers(-2, g + 2, n).astype(np.int32)
    live = rng.random((q, n)) > 0.3
    vals = rng.uniform(-1e3 if kind != "sum" else 0.0, 1e3, (n,) if shared else (q, n))
    if kind != "sum":
        vals[rng.random(vals.shape) < 0.01] = np.nan
    got = hash_agg.grouped_reduce_multi(torch.from_numpy(ids), torch.from_numpy(vals),
                                        torch.from_numpy(live), g, kind).numpy()
    for j in range(q):
        want = pallas_hash_agg.grouped_reduce_numpy(ids, vals if shared else vals[j],
                                                    live[j], g, kind)
        np.testing.assert_allclose(got[j], want, rtol=1e-12, equal_nan=True)
