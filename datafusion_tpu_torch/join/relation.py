"""Hash-join physical operator.

The counterpart of the JAX package's `join/relation.py`.  Build side =
RIGHT input (the planner puts the dimension position there; LEFT OUTER
preserves probe rows, so the probe must be the left input).  The build
side materializes once into a `JoinBuildArtifact`, cached on the
relation; probe batches stream through one of two paths:

- **dense-int device probe**: single integer key, unique on the build
  side, with a value range of at most `_dense_max_slots()` — the build
  fills a direct-address slot table on the device with the
  hand-written CUDA kernel (`exec/cuda/hash_build.py`; its plain
  PyTorch version on the CPU) and every probe batch runs one torch
  function of gathers (`_dense_probe`): hit mask, payload gather,
  validity and selection mask, with the batch's columns staying on
  the device.  Uniqueness comes from the kernel's duplicate flag, so
  the dense path sorts nothing on the host; a duplicate sends the join
  to the host index.  The JAX package capped the kernel at the TPU's
  8,192-slot window, kept a switch to turn the device path off, and
  caps the direct-address table at 2^20 slots, a number from the TPU
  build.  The port has neither switch nor window, and its default
  cap is 2^26 slots: the real TPC-H `o_orderkey` range up to SF-10
  (keys below 60,000,000), a kept slot table of at most 268 MB, 0.3 %
  of an H100's 80 GB.  Tables with a struct column take the host path
  (a struct has no device dtype).  A UInt64 key is an int64 bit view
  on the device; build and probe both offset it from kmin in wrapping
  int64 arithmetic, which is exact for keys in one half, and keys that
  straddle 2^63 read as a range near 2^64 and take the host index, as
  in the JAX package.
- **host probe**: everything else (multi-key, strings, duplicate keys,
  wide key ranges).  `core.HashIndex`, built only for this path,
  CSR-expands matches per batch.

**Build pins** (the JAX package's `_build_artifact`): in a plan a
`serve.Server` lowers (`ExecutionContext.execute(build_pins=...)`), a
built artifact of at most `DATAFUSION_TPU_JOIN_PIN_MAX` bytes (64 MB)
is pinned in the device ledger (`obs/device.LEDGER`, owner
`join.build`) under the build subtree's fingerprint, `join:<fp>`
(`ExecutionContext._build_key`), and a later served query with the same
build side probes it (`join.build.reuse`) instead of building again;
the server unpins its builds when it stops.  A plain `ctx.sql` pins
nothing and builds each time, as before serving was ported (the JAX
package pins in every context).  The fingerprint holds the identity of the
data of every table the build side scans (`DataSource.data_identity`),
so two contexts that register different in-memory tables under one
name never probe each other's build, as they do in the JAX package
(ROADMAP queue 3).  A pinned build is metered like a pinned table
(obs/attribution.py): the client whose served query built it is its
fallback payer, and every probe of it by a served query counts a use.

**Cost observation**: a build over one table (`_cost_obs`, set by the
lowering) records its row count under ``join-build`` in the cost store
(cost/).  The build-side swap itself is a logical rewrite made before
lowering (cost/optimizer.py): a join it swapped builds over what was
its left input.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from datafusion_tpu_torch.datatypes import DataType, Schema
from datafusion_tpu_torch.errors import NotSupportedError
from datafusion_tpu_torch.exec.batch import (
    RecordBatch,
    device_inputs,
    dict_versions,
    make_host_batch,
    pin_dict_versions,
    put_compressed,
)
from datafusion_tpu_torch.exec.cuda import hash_build
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.exec.streams import publish, shared
from datafusion_tpu_torch.join import core as _core
from datafusion_tpu_torch.obs.attribution import (
    current_client,
    note_pin_use,
    register_pin_client,
)
from datafusion_tpu_torch.obs.device import LEDGER
from datafusion_tpu_torch.obs.stats import iter_stats, op_timer
from datafusion_tpu_torch.utils.metrics import METRICS
from datafusion_tpu_torch.utils.retry import device_call


def _dense_max_slots() -> int:
    """Largest direct-address table the dense path will build; above it
    (sparse/huge key ranges) the host index keeps the job.  2^26 by
    default (the module docstring says why not the JAX package's 2^20)."""
    return int(os.environ.get("DATAFUSION_TPU_JOIN_DENSE_SLOTS", 1 << 26))


def _pin_max_bytes() -> int:
    """Largest build artifact the ledger pins (dimension tables are
    small; a fact-side build must not hold device memory)."""
    return int(os.environ.get("DATAFUSION_TPU_JOIN_PIN_MAX", 64 << 20))


def _is_utf8_field(field) -> bool:
    return field.data_type == DataType.UTF8


def _has_device_dtypes(schema: Schema) -> bool:
    """True when every column of `schema` has a device tensor dtype."""
    for f in schema.fields:
        try:
            f.data_type.torch_dtype
        except NotSupportedError:
            return False
    return True


class JoinBuildArtifact:
    """The materialized build side: compacted host columns, plus on the
    host path the `HashIndex` and on the dense path the device-resident
    slot table and payload columns the probe gathers from."""

    __slots__ = ("cols", "valids", "dicts", "versions", "n_rows", "index",
                 "dense", "kmin", "num_slots", "dev_slot_row", "dev_cols",
                 "dev_valids", "nbytes")

    def __init__(self):
        self.dense = False
        self.index = None
        self.dev_slot_row = None


def _dense_probe(key, kvalid, mask, slot_row, pcols, pvalids, kmin: int,
                 num_slots: int, join_type: str):
    """The fused probe of one batch: slot lookup, hit mask, payload
    gather, validity and selection-mask combine (the JAX package's
    `_probe_fn_for`).  Returns (gathered columns, their validity, the
    output mask)."""
    # range check in int64 BEFORE the int32 cast: a far-out-of-range
    # probe key must not wrap into a valid slot
    d = key.to(torch.int64) - kmin
    inr = (d >= 0) & (d < num_slots)
    safe = torch.where(inr, d, 0).to(torch.int32)
    bidx = torch.where(inr, torch.index_select(slot_row, 0, safe), -1)
    hit = bidx >= 0
    if kvalid is not None:
        hit = hit & kvalid
    sb = torch.where(hit, bidx, 0)
    gath = tuple(torch.index_select(c, 0, sb) for c in pcols)
    gval = tuple(hit if v is None else hit & torch.index_select(v, 0, sb)
                 for v in pvalids)
    if join_type == "inner":
        out_mask = hit if mask is None else mask & hit
    else:
        out_mask = mask
    return gath, gval, out_mask


class HashJoinRelation(Relation):
    """INNER / LEFT OUTER equi-join of two child relations."""

    def __init__(self, left: Relation, right: Relation, on, join_type: str,
                 schema: Schema, device: torch.device,
                 build_key: Optional[str] = None):
        self.left = left
        self.right = right
        self.on = [(int(l), int(r)) for l, r in on]
        self.join_type = join_type
        self._schema = schema
        self.device = device
        self.build_key = build_key  # the pin's fingerprint; None: no pin
        self._artifact: Optional[JoinBuildArtifact] = None
        # (table key, "join-build") of a single-table build side, set by
        # the lowering: where the build's row count is observed
        self._cost_obs: Optional[tuple] = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def op_label(self) -> str:
        on = ", ".join(f"#{l}=#{r}" for l, r in self.on)
        return f"HashJoin[{self.join_type}, on={on}]"

    def op_children(self) -> list[Relation]:
        return [self.left, self.right]

    # -- build ---------------------------------------------------------
    def _build_artifact(self) -> JoinBuildArtifact:
        """The build side: the artifact pinned under `build_key` if
        there is one, else built here and pinned."""
        if self._artifact is not None:
            return self._artifact
        fp = self.build_key
        if fp is not None:
            art = LEDGER.pinned(fp)
            if art is not None:
                if art.dense:  # built on another serving worker's stream, perhaps
                    shared((art.dev_slot_row, art.dev_cols, art.dev_valids))
                METRICS.add("join.build.reuse")
                cid = current_client()
                if cid is not None:
                    note_pin_use(fp, cid)
                self._artifact = art
                return art
        art = self._materialize_build()
        if fp is not None and art.nbytes <= _pin_max_bytes():
            if art.dense:
                publish((art.dev_slot_row, art.dev_cols, art.dev_valids))
            LEDGER.pin(fp, art.nbytes, owner="join.build", artifact=art)
            # the building query's client pays for the pin's residency
            # while nobody else probes it (obs/attribution.py)
            cid = current_client()
            if cid is not None:
                register_pin_client(fp, cid)
                note_pin_use(fp, cid)
        self._artifact = art
        return art

    def _materialize_build(self) -> JoinBuildArtifact:
        from datafusion_tpu_torch.exec.materialize import collect_columns

        cols, valids, dicts, n = collect_columns(self.right, iter_stats(self.right))
        art = JoinBuildArtifact()
        art.cols, art.valids, art.dicts, art.n_rows = cols, valids, dicts, n
        art.nbytes = sum(int(c.nbytes) for c in cols) + sum(
            int(v.nbytes) for v in valids if v is not None)
        METRICS.add("join.build.rows", n)
        # the build side is read to its end: its dictionaries' versions
        # now are the ones every output batch's tables are built at
        art.versions = tuple(None if d is None else d.version for d in dicts)
        # a single-table build side teaches the cost store its size (the
        # build-side swap and the dimension reorder plan from it)
        obs = self._cost_obs
        if obs is not None:
            from datafusion_tpu_torch import cost as _cost

            _cost.store().observe(obs[0], obs[1], rows=n, nbytes=art.nbytes)
        if not self._try_dense(art):
            r_keys = [k for _, k in self.on]
            art.index = _core.HashIndex(
                [cols[k] for k in r_keys],
                [valids[k] for k in r_keys],
                [dicts[k] for k in r_keys],
            )
        return art

    def _try_dense(self, art: JoinBuildArtifact) -> bool:
        """Engage the device probe path when the key shape allows it:
        one integer key, value range small enough to direct-address, and
        unique among live build rows by the build kernel's duplicate
        flag.  Returns whether it did; if not, the host index joins."""
        if len(self.on) != 1:
            return False
        if not (_has_device_dtypes(self.left.schema)
                and _has_device_dtypes(self.right.schema)):
            return False
        li, ri = self.on[0]
        bkey = art.cols[ri]
        pfield = self.left.schema.field(li)
        if bkey.dtype.kind not in "iu" or pfield.data_type.np_dtype.kind not in "iu":
            return False
        # dictionary-coded (Utf8) keys LOOK integral but their codes
        # are per-dictionary — direct-address matching would compare
        # codes, not content; only the host index joins strings
        if art.dicts[ri] is not None or _is_utf8_field(pfield):
            return False
        valid = art.valids[ri]
        live = np.ones(art.n_rows, bool) if valid is None else valid.copy()
        if art.n_rows == 0 or not live.any():
            # empty/all-NULL build: the probe gathers payload rows by
            # slot, which needs at least one build row to address; the
            # host index gives "nothing matches" for free instead
            return False
        kv = bkey[live].astype(np.int64)
        kmin = int(kv.min())
        num_slots = int(kv.max()) - kmin + 1
        if num_slots > _dense_max_slots():
            return False
        # dead rows get a pos too (it may wrap or fall outside the
        # table); the kernel skips them by `live` and bounds-checks pos.
        # Live rows' pos lie in [0, num_slots), at most 2^26 by default,
        # so the int32 cast is exact for them.
        pos = (bkey.astype(np.int64) - kmin).astype(np.int32)
        dev = self.device
        # the build's uploads go through put_compressed (the wire codec
        # where it pays): the slot inputs, then the payload (only once
        # the build is dense)
        pos_d, live_d = put_compressed([pos, live], dev, owner="join.build")
        slot_row, _, has_duplicate = device_call(
            hash_build.build_slot_table, pos_d, live_d, num_slots,
            _tag="join.build", _device=dev)
        if has_duplicate:
            return False  # a routing decision: the host index joins
        art.dense = True
        art.kmin, art.num_slots = kmin, num_slots
        art.dev_slot_row = slot_row
        present = [v for v in art.valids if v is not None]
        up = iter(put_compressed(list(art.cols) + present, dev, owner="join.build"))
        art.dev_cols = tuple(next(up) for _ in art.cols)
        art.dev_valids = tuple(None if v is None else next(up) for v in art.valids)
        return True

    # -- probe ---------------------------------------------------------
    def batches(self):
        # the build is this operator's work: it runs with the join
        # ambient (its launch and copies attribute here)
        with op_timer(self):
            art = self._build_artifact()
        if art.dense:
            return self._dense_batches(art)
        return self._host_batches(art)

    def _dense_batches(self, art: JoinBuildArtifact):
        li = self.on[0][0]
        for batch in iter_stats(self.left):
            data, validity, mask = device_inputs(batch, self.device)
            gath, gval, out_mask = device_call(
                _dense_probe, data[li], validity[li], mask, art.dev_slot_row,
                art.dev_cols, art.dev_valids, art.kmin, art.num_slots,
                self.join_type, _tag="join.probe", _device=self.device)
            out = RecordBatch(
                self._schema,
                list(data) + list(gath),
                list(validity) + list(gval),
                list(batch.dicts) + list(art.dicts),
                num_rows=batch.num_rows,
                mask=out_mask,
            )
            pin_dict_versions(out, dict_versions(batch) + art.versions)
            yield out

    def _host_batches(self, art: JoinBuildArtifact):
        from datafusion_tpu_torch.exec.materialize import compact_batch

        l_keys = [k for k, _ in self.on]
        for batch in iter_stats(self.left):
            cols, valids, dicts, n = compact_batch(batch)
            if n == 0:
                continue
            lidx, ridx = art.index.probe(
                [cols[k] for k in l_keys],
                [valids[k] for k in l_keys],
                [dicts[k] for k in l_keys],
                self.join_type,
            )
            if len(lidx) == 0:
                continue
            out_cols, out_valids = _core.gather_joined(
                cols, valids, art.cols, art.valids, lidx, ridx,
                self.join_type,
            )
            out = make_host_batch(
                self._schema, out_cols, out_valids,
                list(dicts) + list(art.dicts),
            )
            pin_dict_versions(out, dict_versions(batch) + art.versions)
            yield out
