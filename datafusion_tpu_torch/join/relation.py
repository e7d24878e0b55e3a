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
  the device.  The JAX package capped the kernel at the TPU's 8,192-slot
  window and kept a switch to turn the device path off; the port has
  neither.  Tables with an unsigned or struct column take the host path
  (they have no device dtype yet, ROADMAP queue 3).
- **host probe**: everything else (multi-key, strings, duplicate keys,
  wide key ranges).  `core.HashIndex` CSR-expands matches per batch.

Not ported (ROADMAP queue 1, "join build pins"): pinning the artifact
in the device ledger under the build subtree's fingerprint, per-client
attribution and the cost store's build-side observation.  A warm query
therefore builds again.
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
    make_host_batch,
    to_device,
)
from datafusion_tpu_torch.exec.cuda import hash_build
from datafusion_tpu_torch.exec.relation import Relation
from datafusion_tpu_torch.join import core as _core


def _dense_max_slots() -> int:
    """Largest direct-address table the dense path will build; above it
    (sparse/huge key ranges) the host index keeps the job."""
    return int(os.environ.get("DATAFUSION_TPU_JOIN_DENSE_SLOTS", 1 << 20))


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
    """The materialized build side: compacted host columns + the
    `HashIndex`, plus — on the dense path — the device-resident slot
    table and payload columns the probe gathers from."""

    __slots__ = ("cols", "valids", "dicts", "n_rows", "index", "dense",
                 "kmin", "num_slots", "dev_slot_row", "dev_cols",
                 "dev_valids")

    def __init__(self):
        self.dense = False
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
                 schema: Schema, device: torch.device):
        self.left = left
        self.right = right
        self.on = [(int(l), int(r)) for l, r in on]
        self.join_type = join_type
        self._schema = schema
        self.device = device
        self._artifact: Optional[JoinBuildArtifact] = None

    @property
    def schema(self) -> Schema:
        return self._schema

    # -- build ---------------------------------------------------------
    def _build_artifact(self) -> JoinBuildArtifact:
        if self._artifact is None:
            self._artifact = self._materialize_build()
        return self._artifact

    def _materialize_build(self) -> JoinBuildArtifact:
        from datafusion_tpu_torch.exec.materialize import collect_columns

        cols, valids, dicts, n = collect_columns(self.right)
        art = JoinBuildArtifact()
        art.cols, art.valids, art.dicts, art.n_rows = cols, valids, dicts, n
        r_keys = [k for _, k in self.on]
        art.index = _core.HashIndex(
            [cols[k] for k in r_keys],
            [valids[k] for k in r_keys],
            [dicts[k] for k in r_keys],
        )
        self._try_dense(art)
        return art

    def _try_dense(self, art: JoinBuildArtifact) -> None:
        """Engage the device probe path when the key shape allows it:
        one integer key, unique among live build rows, value range
        small enough to direct-address."""
        if len(self.on) != 1:
            return
        if not (_has_device_dtypes(self.left.schema)
                and _has_device_dtypes(self.right.schema)):
            return
        li, ri = self.on[0]
        bkey = art.cols[ri]
        pfield = self.left.schema.field(li)
        if bkey.dtype.kind not in "iu" or pfield.data_type.np_dtype.kind not in "iu":
            return
        # dictionary-coded (Utf8) keys LOOK integral but their codes
        # are per-dictionary — direct-address matching would compare
        # codes, not content; only the host index joins strings
        if art.dicts[ri] is not None or _is_utf8_field(pfield):
            return
        if not art.index.unique_keys:
            return
        valid = art.valids[ri]
        live = np.ones(art.n_rows, bool) if valid is None else valid.copy()
        if art.n_rows == 0 or not live.any():
            # empty/all-NULL build: the probe gathers payload rows by
            # slot, which needs at least one build row to address; the
            # host index gives "nothing matches" for free instead
            return
        kv = bkey[live].astype(np.int64)
        kmin = int(kv.min())
        num_slots = int(kv.max()) - kmin + 1
        if num_slots > _dense_max_slots():
            return
        # dead rows get a pos too (it may wrap or fall outside the
        # table); the kernel skips them by `live` and bounds-checks pos
        pos = (bkey.astype(np.int64) - kmin).astype(np.int32)
        art.dense = True
        art.kmin, art.num_slots = kmin, num_slots
        dev = self.device
        art.dev_cols = tuple(to_device(c, dev) for c in art.cols)
        art.dev_valids = tuple(
            None if v is None else to_device(v, dev) for v in art.valids
        )
        art.dev_slot_row = hash_build.build_slot_table(
            to_device(pos, dev), to_device(live, dev), num_slots
        )[0]

    # -- probe ---------------------------------------------------------
    def batches(self):
        art = self._build_artifact()
        if art.dense:
            return self._dense_batches(art)
        return self._host_batches(art)

    def _dense_batches(self, art: JoinBuildArtifact):
        li = self.on[0][0]
        for batch in self.left.batches():
            data, validity, mask = device_inputs(batch, self.device)
            gath, gval, out_mask = _dense_probe(
                data[li], validity[li], mask, art.dev_slot_row,
                art.dev_cols, art.dev_valids, art.kmin, art.num_slots,
                self.join_type,
            )
            yield RecordBatch(
                self._schema,
                list(data) + list(gath),
                list(validity) + list(gval),
                list(batch.dicts) + list(art.dicts),
                num_rows=batch.num_rows,
                mask=out_mask,
            )

    def _host_batches(self, art: JoinBuildArtifact):
        from datafusion_tpu_torch.exec.materialize import compact_batch

        l_keys = [k for k, _ in self.on]
        for batch in self.left.batches():
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
            yield make_host_batch(
                self._schema, out_cols, out_valids,
                list(dicts) + list(art.dicts),
            )
