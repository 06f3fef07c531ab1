"""End-to-end request deadlines (counterpart of
``docqa_tpu/resilience/deadline.py``).

A :class:`Deadline` is created once, when a request is admitted, and
threaded through every stage it touches; each stage reads
:meth:`Deadline.remaining` or :meth:`Deadline.check` before doing work, so
a request that can no longer finish in time is shed instead of queued.
Shedding raises :class:`DeadlineExceeded`, a ``TimeoutError``.  The
reference also marks the shed on the active trace; tracing is not ported
yet, so here the exception is the whole record.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import monotonic
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end budget ran out at ``stage``."""

    def __init__(self, stage: str = "", overrun_s: float = 0.0) -> None:
        self.stage = stage
        self.overrun_s = overrun_s
        detail = f" at {stage}" if stage else ""
        super().__init__(
            f"deadline exceeded{detail} (overrun {overrun_s * 1000:.0f} ms)"
        )


@dataclass
class Deadline:
    """A monotonic-clock expiry carried by one request; ``None`` means no
    deadline everywhere one is accepted."""

    expires_at: float  # time.monotonic() value

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(expires_at=monotonic() + seconds)

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_at - monotonic()

    @property
    def expired(self) -> bool:
        return monotonic() >= self.expires_at

    def check(self, stage: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is gone."""
        overrun = monotonic() - self.expires_at
        if overrun >= 0:
            raise DeadlineExceeded(stage, overrun)

    def bound(self, timeout: Optional[float]) -> float:
        """Clamp a stage-local wait to the remaining budget (never
        negative)."""
        rem = max(self.remaining(), 0.0)
        if timeout is None:
            return rem
        return min(timeout, rem)
