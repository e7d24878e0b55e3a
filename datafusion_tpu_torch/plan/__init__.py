"""Logical/physical plan IR (mirror of reference `src/logicalplan.rs`
and `src/execution/physicalplan.rs`, redesigned for a tensor backend)."""
