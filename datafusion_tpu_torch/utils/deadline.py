"""Per-query deadline propagation (the JAX package's
`utils/deadline.py`).

A caller's time budget travels in a contextvar scope (`deadline_scope`)
that code under it reads with `current_deadline`.  Deadlines are
anchored on the monotonic clock, so a wall-clock step can neither
expire nor resurrect a query.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Optional


class Deadline:
    """An absolute point on the monotonic clock."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @staticmethod
    def after(seconds: float) -> "Deadline":
        return Deadline(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "query") -> None:
        """Raise `QueryDeadlineError` once the budget is spent (the mesh
        round loops and the coordinator's dispatch call it)."""
        rem = self.remaining()
        if rem <= 0.0:
            from datafusion_tpu_torch.errors import QueryDeadlineError

            raise QueryDeadlineError(
                f"{what} exceeded its deadline (over budget by {-rem:.3f}s)"
            )

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


_CURRENT: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "datafusion_tpu_torch_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _CURRENT.get()


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Make `deadline` visible to code in this thread's scope; None
    clears any outer scope."""
    token = _CURRENT.set(deadline)
    try:
        yield deadline
    finally:
        _CURRENT.reset(token)
