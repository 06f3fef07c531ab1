"""End-to-end request deadlines (admission-time budgets), counterpart of
``docqa_tpu/resilience/deadline.py``.

A :class:`Deadline` is created once, when a request is admitted (the
caller of ``QAService.ask``), and threaded through every stage it touches:
``service/qa.py`` → ``engines/pool.py`` → ``engines/serve.py``.  Each stage
calls :meth:`Deadline.check` (or reads :meth:`Deadline.remaining`) before
doing work, so a request that can no longer finish in time is shed at the
first opportunity instead of queueing.

Shedding raises :class:`DeadlineExceeded`, a ``TimeoutError`` subclass, so
callers that already handle timeouts keep working, while a front end can
map it (504) apart from a queue-full shed (503).  The reference also marks
the shed on the request's trace; traces come with the obs slice, so here
the exception, with its stage and overrun, is the whole record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import monotonic
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end budget ran out.

    ``stage`` names where the shed happened ("retrieve", "serve_queue",
    "serve_decode", ...): which stage is eating the budget."""

    def __init__(self, stage: str = "", overrun_s: float = 0.0) -> None:
        self.stage = stage
        self.overrun_s = overrun_s
        detail = f" at {stage}" if stage else ""
        super().__init__(
            f"deadline exceeded{detail} (overrun {overrun_s * 1000:.0f} ms)"
        )


@dataclass
class Deadline:
    """A monotonic-clock expiry carried by one request.

    Construct with :meth:`after` at admission; stages only ever read it.
    ``None`` is the "no deadline" sentinel: every consumer accepts
    ``deadline=None`` and skips its checks."""

    expires_at: float  # time.monotonic() value
    budget_s: float = field(default=0.0)  # original budget (introspection)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(expires_at=monotonic() + seconds, budget_s=seconds)

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_at - monotonic()

    @property
    def expired(self) -> bool:
        return monotonic() >= self.expires_at

    def check(self, stage: str = "") -> None:
        """Raise :class:`DeadlineExceeded` naming ``stage`` if the budget
        is gone."""
        overrun = monotonic() - self.expires_at
        if overrun >= 0:
            raise DeadlineExceeded(stage, overrun)

    def bound(self, timeout: Optional[float]) -> float:
        """Clamp a stage-local wait to the remaining budget (never
        negative — a 0 wait lets pollers fail fast on their own path)."""
        rem = max(self.remaining(), 0.0)
        if timeout is None:
            return rem
        return min(timeout, rem)
