"""Retry policy: jittered exponential backoff, deterministic by seed.
Counterpart of ``docqa_tpu/resilience/policy.py`` (near verbatim).

The broker backs off *redeliveries* (``MemoryBroker.nack``); this policy
covers in-place retries of a fallible call (a broker publish, an
extraction, a queue handler's pure phase) *before* the failure escalates
to a nack, a dead letter or a terminal status.

Jitter is deterministic: delay ``i`` is drawn from a ``random.Random``
seeded by ``(seed, attempt)``, so a fault-injected test replays the same
schedule every run, and the same schedule as the reference's.

One rule the reference does not have: a kernel or CUDA fault
(``ops/_kernels.is_device_fault``) is never retried and never fed to the
breaker.  It propagates at once, whatever ``retry_on`` says.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type, TypeVar

from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger

log = get_logger("docqa.resilience")

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """``call(fn)`` runs ``fn`` up to ``max_attempts`` times.

    * delays: ``base_delay_s * multiplier**i``, capped at ``max_delay_s``,
      each scaled by a deterministic jitter factor in
      ``[1 - jitter, 1 + jitter]``;
    * only ``retry_on`` exceptions are retried — anything else (and
      :class:`DeadlineExceeded`, always) propagates immediately, though
      every call failure still feeds the breaker;
    * a device fault propagates immediately and feeds nothing;
    * a :class:`~docqa_tpu_torch.resilience.deadline.Deadline` stops the
      loop early: no attempt (or sleep) starts past the deadline;
    * a :class:`~docqa_tpu_torch.resilience.breaker.CircuitBreaker` is
      consulted before and fed after every attempt.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.5  # ± fraction of the nominal delay
    seed: int = 0
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    def delay(self, attempt: int) -> float:
        """Deterministic jittered delay after failed attempt ``attempt``
        (1-based)."""
        nominal = min(
            self.base_delay_s * (self.multiplier ** (attempt - 1)),
            self.max_delay_s,
        )
        if not self.jitter:
            return nominal
        rng = random.Random(self.seed * 1_000_003 + attempt)
        return nominal * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def call(
        self,
        fn: Callable[[], T],
        *,
        name: str = "op",
        deadline: Optional[Deadline] = None,
        breaker=None,  # CircuitBreaker (duck-typed)
        sleep: Callable[[float], None] = time.sleep,
    ) -> T:
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if deadline is not None:
                deadline.check(f"retry:{name}")
            if breaker is not None:
                breaker.raise_if_open()
            try:
                out = fn()
            except DeadlineExceeded:
                raise  # a shed is a decision, not a transient failure
            except Exception as e:
                if is_device_fault(e):
                    raise  # the card's fault reaches the caller unchanged
                # every other failure feeds the breaker, retryable or not
                if breaker is not None:
                    breaker.record_failure()
                if not isinstance(e, self.retry_on):
                    raise
                last = e
                DEFAULT_REGISTRY.counter(f"retry_{name}_failures").inc()
                if attempt >= self.max_attempts:
                    break
                pause = self.delay(attempt)
                if deadline is not None and deadline.remaining() <= pause:
                    # sleeping would outlive the request: surface the real
                    # failure, not a synthetic timeout
                    break
                log.warning(
                    "%s failed (attempt %d/%d): %r — retrying in %.0f ms",
                    name, attempt, self.max_attempts, e, pause * 1000,
                )
                sleep(pause)
            else:
                if breaker is not None:
                    breaker.record_success()
                return out
        assert last is not None
        raise last
