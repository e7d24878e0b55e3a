"""Static verification: the plan-IR verifier (`analysis.verify`).

The counterpart of the JAX package's `analysis/`.  Only the verifier
is ported; the invariant linter and the lock-order checker wait for
the observability slice (ROADMAP queue 1, item 13).
"""

from datafusion_tpu_torch.analysis import verify

__all__ = ["verify"]
