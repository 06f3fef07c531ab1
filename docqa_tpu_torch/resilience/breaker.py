"""Per-dependency circuit breakers, counterpart of
``docqa_tpu/resilience/breaker.py`` (host only, near verbatim).

A breaker wraps one dependency (here: the decoder, and each replica of the
engine pool).  Repeated failures OPEN it; while open, callers fail fast
(:class:`BreakerOpen`) instead of hammering a dependency that needs a
recovery window, and the QA path uses that fast signal to serve the
degraded extractive answer while the decoder is down (``service/qa.py``).

States:

* ``closed`` — normal; consecutive failures are counted.
* ``open`` — ``failure_threshold`` consecutive failures seen; every call is
  rejected until ``reset_timeout_s`` elapses.
* ``half_open`` — after the timeout a bounded number of probe calls pass;
  one success closes the breaker, one failure re-opens it (and restarts the
  timer).

State changes are published to the metrics registry as the gauge
``breaker_<name>_state`` (0 closed / 1 half-open / 2 open) plus the
``breaker_<name>_opened`` / ``_rejected`` counters.

A kernel or CUDA fault (``ops/_kernels.is_device_fault``) is not a
dependency outage: the callers in this package never record one as a
failure, they let it through to their own caller.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, TypeVar

from docqa_tpu_torch.runtime.metrics import (
    DEFAULT_REGISTRY,
    MetricsRegistry,
    get_logger,
)

log = get_logger("docqa.breaker")

T = TypeVar("T")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(RuntimeError):
    """The dependency's circuit is open — fail fast, don't queue."""

    def __init__(self, name: str, retry_after_s: float) -> None:
        self.breaker_name = name
        self.retry_after_s = retry_after_s
        super().__init__(
            f"circuit '{name}' is open (retry in {retry_after_s:.1f}s)"
        )


class CircuitBreaker:
    """Thread-safe three-state breaker.  ``clock`` is injectable so tests
    drive the reset timeout without sleeping."""

    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_max: int = 1,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = max(1, half_open_max)
        self._registry = registry or DEFAULT_REGISTRY
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive, while closed
        self._opened_at = 0.0
        self._probes = 0  # in-flight probes while half-open
        self._publish_state()

    # ---- state ---------------------------------------------------------------

    def _publish_state(self) -> None:
        self._registry.gauge(f"breaker_{self.name}_state").set(
            _STATE_GAUGE[self._state]
        )

    def _to(self, state: str) -> None:
        if state != self._state:
            log.warning("breaker '%s': %s -> %s", self.name, self._state, state)
            self._state = state
            self._publish_state()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._probes = 0
            self._to(HALF_OPEN)

    # ---- call-side API -------------------------------------------------------

    def allow(self) -> bool:
        """True if a call may proceed (reserves a probe slot when
        half-open)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return True
            self._registry.counter(f"breaker_{self.name}_rejected").inc()
            return False

    def release_probe(self) -> None:
        """Return an unused half-open probe slot: for callers that took
        ``allow()`` but never ran the guarded call to an outcome (shed by
        other admission control), so the breaker cannot wedge half-open."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes > 0:
                self._probes -= 1

    def raise_if_open(self) -> None:
        if not self.allow():
            with self._lock:
                retry_after = max(
                    0.0,
                    self.reset_timeout_s - (self._clock() - self._opened_at),
                )
            raise BreakerOpen(self.name, retry_after)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state in (HALF_OPEN, OPEN):
                # OPEN included: a success from a call admitted before the
                # trip proves the dependency lives
                self._to(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip_locked()
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self) -> None:
        self._opened_at = self._clock()
        self._failures = 0
        self._registry.counter(f"breaker_{self.name}_opened").inc()
        self._to(OPEN)

    def call(self, fn: Callable[[], T]) -> T:
        """Run ``fn`` under the breaker: reject when open, feed the outcome
        back."""
        self.raise_if_open()
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


class BreakerBoard:
    """The runtime's named breakers, one per dependency; ``get(name)``
    creates one with the board's defaults on first use."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._defaults = dict(
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s,
        )
        self._registry = registry
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(
                    name, registry=self._registry, clock=self._clock,
                    **self._defaults,
                )
                self._breakers[name] = br
            return br

    def adopt(self, breaker: CircuitBreaker) -> CircuitBreaker:
        """Register an externally owned breaker so its state shows on the
        same status surface as the board's own."""
        with self._lock:
            return self._breakers.setdefault(breaker.name, breaker)

    def states(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: br.state for name, br in items}
