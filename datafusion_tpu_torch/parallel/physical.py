"""Physical plan: the serializable unit of distributed work (the JAX
package's `parallel/physical.py`; its wire JSON byte for byte, so either
package's coordinator can ship a fragment to either package's worker).

The reference defines (but never uses) `PhysicalPlan::{Interactive,
Write, Show}` wrapping a logical plan as the thing a coordinator ships
to a worker (`src/execution/physicalplan.rs:18-34`).  Here that layer
is real: `PlanFragment` describes one partition's slice of a query —
the logical plan in the JSON wire format (`logicalplan.rs:609-648`'s
contract), the partition's datasource meta (`datasource.rs:70-85`),
and its shard assignment on the mesh.  `PartitionedContext` round-trips
every fragment through JSON before executing it, so the local mesh path
and the multi-process coordinator (parallel/coordinator.py) use the
same wire format.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.plan.logical import LogicalPlan


@dataclass
class PhysicalPlan:
    """Top-level statement wrapper (reference `physicalplan.rs:18-34`).

    kind: "interactive" (stream results back), "write" (materialize to
    a file), or "show" (first `count` rows).
    """

    kind: str
    plan: LogicalPlan
    filename: Optional[str] = None
    file_format: Optional[str] = None
    count: Optional[int] = None

    def to_json(self) -> dict:
        if self.kind == "interactive":
            return {"Interactive": {"plan": self.plan.to_json()}}
        if self.kind == "write":
            return {
                "Write": {
                    "plan": self.plan.to_json(),
                    "filename": self.filename,
                    "kind": self.file_format,
                }
            }
        if self.kind == "show":
            return {"Show": {"plan": self.plan.to_json(), "count": self.count}}
        raise PlanError(f"unknown physical plan kind {self.kind!r}")

    @staticmethod
    def from_json(obj: dict) -> "PhysicalPlan":
        if "Interactive" in obj:
            return PhysicalPlan("interactive", LogicalPlan.from_json(obj["Interactive"]["plan"]))
        if "Write" in obj:
            w = obj["Write"]
            return PhysicalPlan(
                "write", LogicalPlan.from_json(w["plan"]),
                filename=w["filename"], file_format=w["kind"],
            )
        if "Show" in obj:
            s = obj["Show"]
            return PhysicalPlan("show", LogicalPlan.from_json(s["plan"]), count=s["count"])
        raise PlanError(f"unknown physical plan {list(obj)!r}")


@dataclass
class PlanFragment:
    """One partition's unit of work in a partitioned query.

    `datasource_meta` is the `DataSourceMeta`-shaped description of the
    partition's input file (`datasource.rs:70-85`); `plan` is the
    logical plan in JSON wire form.  A coordinator sends this to the
    host owning shard `shard`; locally we execute it on mesh device
    `shard`.

    `query_id` scopes the fragment to one query execution; with it the
    fragment's identity (`fragment_id`) is idempotent — a coordinator
    that replays a fragment (worker died, response lost) can recognize
    a duplicate response and merge each fragment exactly once.
    """

    shard: int
    num_shards: int
    plan: dict
    datasource_meta: dict
    query_id: str = ""

    @property
    def fragment_id(self) -> str:
        return f"{self.query_id}/{self.shard}"

    def span_attrs(self) -> dict:
        """Span attributes identifying this fragment in a trace — the
        coordinator's dispatch span and the worker's fragment span both
        carry them, so the merged timeline joins on shard/fragment_id."""
        return {
            "shard": self.shard,
            "num_shards": self.num_shards,
            "fragment_id": self.fragment_id,
        }

    def table_names(self) -> list[str]:
        """Table names the fragment's plan scans, read straight from
        the wire JSON (no plan reconstruction); the worker fragment
        cache tags its entries with them."""
        names: set[str] = set()

        def walk(node):
            if isinstance(node, dict):
                for key, body in node.items():
                    if key == "TableScan" and isinstance(body, dict):
                        name = body.get("table_name")
                        if name:
                            names.add(name)
                    else:
                        walk(body)
            elif isinstance(node, list):
                for item in node:
                    walk(item)

        walk(self.plan)
        return sorted(names)

    def to_json_str(self) -> str:
        return json.dumps(
            {
                "shard": self.shard,
                "num_shards": self.num_shards,
                "plan": self.plan,
                "datasource": self.datasource_meta,
                "query_id": self.query_id,
            }
        )

    @staticmethod
    def from_json_str(s: str) -> "PlanFragment":
        o = json.loads(s)
        return PlanFragment(
            o["shard"], o["num_shards"], o["plan"], o["datasource"],
            o.get("query_id", ""),
        )

    def logical_plan(self) -> LogicalPlan:
        return LogicalPlan.from_json(self.plan)

    def build_datasource(self, batch_size: int):
        """Reconstruct the partition's DataSource from its wire meta —
        what a remote worker does on receipt.  CSV reads through the
        port's native parser, Parquet through its native reader
        (native/parquet.py), on the card's machine too."""
        from datafusion_tpu_torch.datatypes import Schema
        from datafusion_tpu_torch.exec.datasource import (
            CsvDataSource,
            NdJsonDataSource,
            ParquetDataSource,
        )

        meta = self.datasource_meta
        if "CsvFile" in meta:
            m = meta["CsvFile"]
            return CsvDataSource(
                m["filename"], Schema.from_json(m["schema"]), m["has_header"],
                batch_size, m.get("projection"),
            )
        if "ParquetFile" in meta:
            m = meta["ParquetFile"]
            return ParquetDataSource(
                m["filename"], Schema.from_json(m["schema"]), batch_size,
                m.get("projection"),
            )
        if "NdJsonFile" in meta:
            m = meta["NdJsonFile"]
            return NdJsonDataSource(
                m["filename"], Schema.from_json(m["schema"]), batch_size,
                m.get("projection"),
            )
        if "Partitioned" in meta:
            from datafusion_tpu_torch.parallel.partition import PartitionedDataSource

            children = [
                PlanFragment(self.shard, self.num_shards, self.plan, child_meta)
                .build_datasource(batch_size)
                for child_meta in meta["Partitioned"]
            ]
            return PartitionedDataSource(children)
        raise PlanError(f"unknown datasource meta {list(meta)!r}")
