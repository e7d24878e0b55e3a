"""Relation protocol and the scan adapter.

The counterpart of the JAX package's `exec/relation.py`: a volcano-
style pull iterator of RecordBatches.  The fused scan -> filter ->
project operator (`PipelineRelation`) is the next slice (ROADMAP queue
1, "PipelineRelation and the CSV scan").
"""

from __future__ import annotations

from typing import Iterator

from datafusion_tpu_torch.datatypes import Schema
from datafusion_tpu_torch.exec.batch import RecordBatch


class Relation:
    """Pull-based iterator of RecordBatches (reference `Relation` trait)."""

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[RecordBatch]:
        raise NotImplementedError


class DataSourceRelation(Relation):
    """Adapts a DataSource into a Relation (reference `relation.rs:34-54`)."""

    def __init__(self, datasource):
        self.datasource = datasource

    @property
    def schema(self) -> Schema:
        return self.datasource.schema

    def batches(self) -> Iterator[RecordBatch]:
        return self.datasource.batches()
