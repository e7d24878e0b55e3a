"""Test-support subsystems that ship with the engine.

`faults` is the deterministic fault-injection layer (the JAX package's
`testing/faults.py`): production code names injection sites on its
disk and wire paths, and a seedable process-global plan decides which
sites fire.
"""
