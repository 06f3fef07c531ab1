"""Counters, gauges, latency histograms and wall-clock spans, counterpart of
``docqa_tpu/runtime/metrics.py``.

Thread-safe, one lock per instrument and one per registry; the only global
state is :data:`DEFAULT_REGISTRY`.  The serving plane bumps the same
counter names as the reference (``qa_degraded``, ``qos_preempted``,
``qos_preempted_<class>``, the ``breaker_<name>_state`` gauges, ``pool_*``,
``serve_*``, ``dispatch_*``, ``cost_*``), so the two registries compare
name by name.  Histograms keep windowed digests (``obs/telemetry.py``) and
trace-id exemplars; :func:`span` records a trace span beside its histogram
sample; every logger carries the trace-id filter.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

# the obs package imports no torch at module top: no import cycle
from docqa_tpu_torch.obs.context import current_trace_id
from docqa_tpu_torch.obs.profiler import DEFAULT_PROFILER as _PROFILER
from docqa_tpu_torch.obs.spans import start_span as _trace_span
from docqa_tpu_torch.obs.telemetry import WindowedDigest


class TraceLogFilter(logging.Filter):
    """Prefix ``trace_id=<id>`` when a TraceContext is active, so every
    log line correlates with its request timeline.  Inactive contexts pass
    records through untouched: one context-var read per log call."""

    def filter(self, record: logging.LogRecord) -> bool:
        tid = current_trace_id()
        if tid is not None:
            # resolve %-args NOW so the prefix composes with any format
            # string; the message is about to be emitted anyway
            record.msg = f"trace_id={tid} {record.getMessage()}"
            record.args = None
        return True


def get_logger(name: str) -> logging.Logger:
    """A logger with one stream handler when the process configured none.
    Every logger carries :class:`TraceLogFilter`, so log lines name the
    active trace."""
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s [%(name)s] %(message)s"
            )
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    if not any(isinstance(f, TraceLogFilter) for f in logger.filters):
        logger.addFilter(TraceLogFilter())
    return logger


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
    """Windowed-digest histogram: exact percentiles over *recent* time.

    Samples feed a :class:`~docqa_tpu_torch.obs.telemetry.WindowedDigest`:
    fixed-interval rollup windows, each sealed with count/sum/p50/p95/p99,
    recent windows keeping their samples.  ``percentile()`` /
    ``summary()`` merge the sample-retention horizon, so a long-running
    service's p95 reflects the last few minutes of traffic.  With no
    recent samples the last sealed window's digest answers, so an idle
    service reports its last known percentiles.  ``count``/``mean`` are
    lifetime totals.  The largest traced samples keep their trace id
    (exemplars).
    """

    MAX_EXEMPLARS = 8

    def __init__(
        self,
        name: str,
        max_samples: int = 65536,
        digest: Optional[WindowedDigest] = None,
    ):
        self.name = name
        # the windowed rollups behind percentile()/summary(); also
        # registered with the telemetry store (obs/telemetry.py), so its
        # export serves the identical windows
        self.digest = digest or WindowedDigest(
            max_samples_per_window=min(max_samples, 4096)
        )
        self._count = 0
        self._sum = 0.0
        self._exemplars: List[tuple] = []  # (value, trace_id), largest kept
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            if trace_id is not None:
                # exemplars: the LARGEST traced samples keep their trace id,
                # so a p95 links to a real flight-recorder timeline
                if len(self._exemplars) < self.MAX_EXEMPLARS:
                    self._exemplars.append((value, trace_id))
                else:
                    lo = min(
                        range(len(self._exemplars)),
                        key=lambda i: self._exemplars[i][0],
                    )
                    if value >= self._exemplars[lo][0]:
                        self._exemplars[lo] = (value, trace_id)
        # digest has its own (strictly inner, never-held-together) lock
        self.digest.observe(value)

    def percentile(self, q: float) -> float:
        # windowed first (percentiles mean NOW); stale-idle falls back
        # to the last sealed digest; NaN only before any observation.
        # Percentile definition stays obs/spans.percentile_nearest_rank
        # (inside the digest) — histograms, the recorder's slow flag,
        # and the attribution table can never disagree about "p95".
        recent = self.digest.recent_percentiles((q,))
        if recent is not None:
            return recent[f"p{int(q)}"]
        last = self.digest.last_percentiles()
        if last is not None:
            return last.get(f"p{int(q)}", float("nan"))
        return float("nan")

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else float("nan")

    def exemplars(self) -> List[Dict[str, object]]:
        with self._lock:
            return [
                {"value": v, "trace_id": t}
                for v, t in sorted(self._exemplars, reverse=True)
            ]

    def summary(self) -> Dict[str, object]:
        ps = self.digest.recent_percentiles((50, 95, 99))
        if ps is None:
            ps = self.digest.last_percentiles() or {
                "p50": float("nan"),
                "p95": float("nan"),
                "p99": float("nan"),
            }
        out: Dict[str, object] = {
            "count": self.count,
            "mean": self.mean,
            "p50": ps["p50"],
            "p95": ps["p95"],
            "p99": ps["p99"],
        }
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out


@dataclass
class MetricsRegistry:
    counters: Dict[str, Counter] = field(default_factory=dict)
    histograms: Dict[str, Histogram] = field(default_factory=dict)
    gauges: Dict[str, Gauge] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    # rollup parameters applied to every histogram's WindowedDigest
    # (configure_windows aligns them with the telemetry store's clock)
    _window_params: Optional[dict] = None

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = Counter(name)
            return self.counters[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self.histograms:
                digest = (
                    WindowedDigest(**self._window_params)
                    if self._window_params
                    else None
                )
                self.histograms[name] = Histogram(name, digest=digest)
            return self.histograms[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self.gauges:
                self.gauges[name] = Gauge(name)
            return self.gauges[name]

    def configure_windows(
        self,
        interval_s: float,
        points: int = 360,
        sample_windows: Optional[int] = None,
    ) -> None:
        """Align every histogram's rollup windows with the telemetry
        store's clock (before serving; tests with sub-second intervals).
        Existing digests are REPLACED: sealed history does not survive a
        re-window."""
        params = {"interval_s": float(interval_s), "points": int(points)}
        if sample_windows is not None:
            params["sample_windows"] = int(sample_windows)
        with self._lock:
            self._window_params = params
            for h in self.histograms.values():
                h.digest = WindowedDigest(**params)

    def instruments(
        self,
    ) -> Tuple[Dict[str, Counter], Dict[str, Histogram], Dict[str, Gauge]]:
        """Shallow copies of the three instrument maps — the telemetry
        sampler's scrape surface (and the Prometheus renderer's), so
        neither iterates a dict the serving threads are inserting into."""
        with self._lock:
            return (
                dict(self.counters),
                dict(self.histograms),
                dict(self.gauges),
            )

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counters = dict(self.counters)
            histograms = dict(self.histograms)
            gauges = dict(self.gauges)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "histograms": {k: h.summary() for k, h in histograms.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
        }


DEFAULT_REGISTRY = MetricsRegistry()


@contextlib.contextmanager
def span(
    name: str,
    registry: Optional[MetricsRegistry] = None,
) -> Iterator[None]:
    """Wall-clock span recorded as the ``<name>_ms`` histogram.

    When a TraceContext is active (``docqa_tpu_torch/obs``) the same
    interval is also recorded as a trace span, and the histogram sample
    carries the trace id as an exemplar.  While a profiler window is open
    (``obs.DEFAULT_PROFILER``) the span also enters
    ``torch.profiler.record_function``, so the stage shows up by name in
    the trace; with no window open that costs one attribute read."""
    registry = registry or DEFAULT_REGISTRY
    start = time.perf_counter()
    if _PROFILER.active:
        import torch.profiler

        ctx: contextlib.AbstractContextManager = (
            torch.profiler.record_function(name)
        )
    else:
        ctx = contextlib.nullcontext()
    with ctx, _trace_span(name):
        try:
            yield
        finally:
            registry.histogram(f"{name}_ms").observe(
                (time.perf_counter() - start) * 1000.0,
                trace_id=current_trace_id(),
            )
