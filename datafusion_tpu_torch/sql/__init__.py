"""SQL front-end: tokenizer, recursive-descent parser, AST, planner.

The reference delegates ANSI SQL to the external `sqlparser` crate and
hand-parses only the CREATE EXTERNAL TABLE DDL (`src/dfparser.rs`).
There is no Python equivalent to lean on, so the whole grammar subset
lives here, in pure Python.
"""
