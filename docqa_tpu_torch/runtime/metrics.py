"""Counters, gauges, latency histograms and wall-clock spans, counterpart of
``docqa_tpu/runtime/metrics.py``.

Thread-safe, one lock per instrument and one per registry; the only global
state is :data:`DEFAULT_REGISTRY`.  The serving plane bumps the same
counter names as the reference (``qa_degraded``, ``qos_preempted``,
``qos_preempted_<class>``, ``qos_preempt_advisory``, the
``breaker_<name>_state`` gauges, ``pool_*``, ``serve_*``), so the two
registries can be compared name by name.

Not in this port yet: the trace-id log filter and the trace span that the
reference's :func:`span` opens beside its histogram sample, and the
histograms' rollup windows (the reference keeps its samples in the
telemetry store's windowed digests).  They come with the obs slice; until
then a histogram keeps its most recent ``max_samples`` observations and
answers percentiles over them with the reference's nearest-rank rule.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


def get_logger(name: str) -> logging.Logger:
    """A logger with one stream handler when the process configured none."""
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def percentile_nearest_rank(ordered: List[float], q: float) -> float:
    """Nearest-rank percentile over a sorted sequence (0.0 when empty), the
    reference's definition of p50/p95/p99."""
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, max(0, round(q / 100 * (len(ordered) - 1))))
    return ordered[idx]


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A settable point-in-time value (breaker states, queue depths)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Latency histogram: lifetime count and mean, percentiles over the
    most recent ``max_samples`` observations.  (The reference's exemplars
    link samples to traces; they come with the obs slice.)"""

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self._samples: collections.deque = collections.deque(maxlen=max_samples)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._samples.append(value)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of the retained samples; NaN before any
        observation."""
        with self._lock:
            ordered = sorted(self._samples)
        if not ordered:
            return float("nan")
        return percentile_nearest_rank(ordered, q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    def summary(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


@dataclass
class MetricsRegistry:
    counters: Dict[str, Counter] = field(default_factory=dict)
    histograms: Dict[str, Histogram] = field(default_factory=dict)
    gauges: Dict[str, Gauge] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = Counter(name)
            return self.counters[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self.histograms:
                self.histograms[name] = Histogram(name)
            return self.histograms[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self.gauges:
                self.gauges[name] = Gauge(name)
            return self.gauges[name]

    def instruments(
        self,
    ) -> Tuple[Dict[str, Counter], Dict[str, Histogram], Dict[str, Gauge]]:
        """Shallow copies of the three instrument maps, so a reader never
        iterates a dict the serving threads are inserting into."""
        with self._lock:
            return dict(self.counters), dict(self.histograms), dict(self.gauges)

    def snapshot(self) -> Dict[str, object]:
        counters, histograms, gauges = self.instruments()
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "histograms": {k: h.summary() for k, h in histograms.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
        }


DEFAULT_REGISTRY = MetricsRegistry()


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None) -> Iterator[None]:
    """Wall-clock span recorded as the ``<name>_ms`` histogram."""
    registry = registry or DEFAULT_REGISTRY
    start = time.perf_counter()
    try:
        yield
    finally:
        registry.histogram(f"{name}_ms").observe(
            (time.perf_counter() - start) * 1000.0
        )
