"""The wire protocol (`parallel/wire.py`); the distributed planes of the
JAX package's `parallel/` wait for ROADMAP queue 1, item 12."""
