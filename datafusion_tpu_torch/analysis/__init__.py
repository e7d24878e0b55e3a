"""Static verification and lock checking: the plan-IR verifier
(`analysis.verify`) and the lock-order checker (`analysis.lockcheck`).

The counterpart of the JAX package's `analysis/`.  The invariant linter
and the instrumentation of the port's other locks wait for ROADMAP
queue 1, item 13.3.
"""

from datafusion_tpu_torch.analysis import lockcheck, verify

__all__ = ["lockcheck", "verify"]
