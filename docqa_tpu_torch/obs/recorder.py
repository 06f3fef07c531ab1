"""FlightRecorder: bounded retention of recent request timelines,
counterpart of ``docqa_tpu/obs/recorder.py``.

A ring of the last ``capacity`` completed traces plus a separate ring of
anomalous ones (deadline sheds, degraded answers, decode failures, and the
slowest ``slow_percentile`` by wall time), so a burst of healthy traffic
cannot evict the one request that shed.  Open traces are bounded
(``max_open``): a trace nobody finishes is evicted oldest first with an
``abandoned`` flag.

Recording is on by default; ``set_enabled(False)`` turns every entry point
into a no-op (the recorder on/off comparison flips exactly this switch).
"""

from __future__ import annotations

import collections
import threading
from contextlib import contextmanager as contextlib_contextmanager
from typing import Any, Dict, List, Optional

from docqa_tpu_torch.obs.context import (
    SPAN_HEADER,
    TRACE_HEADER,
    TraceContext,
    next_trace_id,
)
from docqa_tpu_torch.obs.spans import Trace, percentile_nearest_rank

_enabled = True


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


def enabled() -> bool:
    return _enabled


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 256,
        anomalous_capacity: int = 64,
        slow_percentile: float = 95.0,
        min_slow_samples: int = 20,
        max_open: int = 1024,
    ) -> None:
        self.slow_percentile = slow_percentile
        self.min_slow_samples = min_slow_samples
        self.max_open = max_open
        self._lock = threading.Lock()
        self._open: "collections.OrderedDict[str, Trace]" = (
            collections.OrderedDict()
        )
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._anomalous: collections.deque = collections.deque(
            maxlen=anomalous_capacity
        )
        self._durations: collections.deque = collections.deque(maxlen=512)
        # lifetime count of traces that entered the anomalous ring — the
        # telemetry sampler scrapes this as a counter series, so a burst
        # of anomalies is visible even after the ring itself rotated
        self.anomalous_total = 0

    # ---- trace lifecycle -----------------------------------------------------

    def new_trace(self, name: str, **attrs: Any) -> Optional[TraceContext]:
        if not _enabled:
            return None
        trace = Trace(next_trace_id(), name, attrs=attrs)
        self._register(trace)
        return TraceContext(trace, trace.root.span_id)

    def adopt(self, trace_id: str, name: str) -> TraceContext:
        """Open a trace under a GIVEN id — the cross-restart case: a
        journal-replayed message carries a trace id whose original trace
        object died with the old process.  The stub still links the
        post-replay hops under the same id."""
        trace = Trace(trace_id, name)
        trace.root.attrs["adopted"] = True
        self._register(trace)
        return TraceContext(trace, trace.root.span_id)

    def _register(self, trace: Trace) -> None:
        evicted: List[Trace] = []
        with self._lock:
            self._open[trace.trace_id] = trace
            while len(self._open) > self.max_open:
                _, old = self._open.popitem(last=False)
                evicted.append(old)
        for old in evicted:
            old.flag("abandoned")
            self.complete(old, status="abandoned")

    def from_headers(
        self, headers: Optional[Dict[str, Any]], name: str = "linked"
    ) -> Optional[TraceContext]:
        """Re-attach to the trace a broker message names (or adopt a stub
        for an id we no longer hold).  Returns None when the message
        carries no trace or recording is disabled."""
        if not _enabled or not headers:
            return None
        trace_id = headers.get(TRACE_HEADER)
        if not trace_id:
            return None
        with self._lock:
            trace = self._open.get(trace_id)
        if trace is None:
            return self.adopt(trace_id, name)
        parent = headers.get(SPAN_HEADER) or trace.root.span_id
        return TraceContext(trace, parent)

    def complete(self, trace: Optional[Trace], status: str = "ok") -> None:
        """Finish + retain.  Idempotent: the first completion wins (a
        document trace can be finished by either the pipeline terminal
        status or a dead-letter callback)."""
        if trace is None:
            return
        # cost-record fallback retirement (docqa-costscope): a request
        # whose typed path never retired its record — a 503 the batcher
        # never saw, an exception escaping the HTTP handler — retires
        # here when its trace completes, so no traced request can leak
        # an open record.  Exactly-once: the ledger guards, so the
        # normal typed retirement always wins.
        rec = getattr(trace, "cost_record", None)
        if rec is not None:
            try:
                from docqa_tpu_torch.obs.costs import DEFAULT_COST_LEDGER

                DEFAULT_COST_LEDGER.retire(
                    rec, "ok" if status == "ok" else "error"
                )
            except Exception:
                pass
        if not trace.finish(status):
            with self._lock:
                self._open.pop(trace.trace_id, None)
            return
        dur = trace.duration_ms
        with self._lock:
            self._open.pop(trace.trace_id, None)
            if (
                len(self._durations) >= self.min_slow_samples
                and dur >= self._quantile_locked(self.slow_percentile)
            ):
                # flag() takes the trace's own lock; safe (distinct locks)
                trace.flag(f"slow_p{int(self.slow_percentile)}")
            self._durations.append(dur)
            self._ring.append(trace)
            if trace.flags and not any(
                t is trace for t in self._anomalous
            ):
                # membership check: flag_window() racing this completion
                # may have promoted the trace already — a double insert
                # would evict a real always-keep trace from the ring and
                # over-count anomalous_total during exactly the incident
                # the ring preserves evidence for
                self._anomalous.append(trace)
                self.anomalous_total += 1

    def _quantile_locked(self, q: float) -> float:
        return percentile_nearest_rank(sorted(self._durations), q)

    def flag_window(
        self,
        t_lo_unix: float,
        t_hi_unix: float,
        flag: str,
        names: Optional[List[str]] = None,
    ) -> int:
        """Flag every retained trace that STARTED inside the wall-clock
        window ``[t_lo_unix, t_hi_unix)`` — the SLO burn-rate alert's
        evidence hook (obs/slo.py): "the p95 objective burned between
        14:02:10 and 14:02:30" becomes exactly those timelines in the
        always-keep anomalous ring.  Completed traces that were healthy
        at completion are promoted into the ring here; open traces get
        the flag now and land in the ring at completion as usual.
        Returns the number of traces newly flagged."""
        n = 0
        with self._lock:
            anomalous_ids = {id(t) for t in self._anomalous}
            pools = (
                list(self._open.values())
                + list(self._ring)
                + list(self._anomalous)
            )
            seen: set = set()
            for trace in pools:
                if id(trace) in seen:
                    continue
                seen.add(id(trace))
                if not (t_lo_unix <= trace.wall0 < t_hi_unix):
                    continue
                if names is not None and trace.name not in names:
                    continue
                if flag in trace.flags:
                    continue
                trace.flag(flag)
                n += 1
                if trace.finished and id(trace) not in anomalous_ids:
                    self._anomalous.append(trace)
                    self.anomalous_total += 1
        return n

    # ---- lookup --------------------------------------------------------------

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            if trace_id in self._open:
                return self._open[trace_id]
            for pool in (self._anomalous, self._ring):
                for trace in pool:
                    if trace.trace_id == trace_id:
                        return trace
        return None

    def recent(self, n: int = 50) -> List[Trace]:
        with self._lock:
            return list(self._ring)[-n:][::-1]

    def anomalous(self, n: int = 50) -> List[Trace]:
        with self._lock:
            return list(self._anomalous)[-n:][::-1]

    def open_traces(self) -> List[Trace]:
        with self._lock:
            return list(self._open.values())

    def summaries(
        self, n: int = 50, anomalous: bool = False
    ) -> List[Dict[str, Any]]:
        traces = self.anomalous(n) if anomalous else self.recent(n)
        return [
            {
                "trace_id": t.trace_id,
                "name": t.name,
                "status": t.status,
                "flags": list(t.flags),
                "duration_ms": round(t.duration_ms, 3),
                "n_spans": len(t.snapshot_spans()),
                "started_unix": t.wall0,
            }
            for t in traces
        ]

    def clear(self) -> None:
        with self._lock:
            self._open.clear()
            self._ring.clear()
            self._anomalous.clear()
            self._durations.clear()
            self.anomalous_total = 0


DEFAULT_RECORDER = FlightRecorder()


# ---- module-level conveniences over the default recorder -------------------


def new_trace(name: str, **attrs: Any) -> Optional[TraceContext]:
    return DEFAULT_RECORDER.new_trace(name, **attrs)


def from_headers(
    headers: Optional[Dict[str, Any]], name: str = "linked"
) -> Optional[TraceContext]:
    return DEFAULT_RECORDER.from_headers(headers, name=name)


def finish(ctx: Optional[TraceContext], status: str = "ok") -> None:
    if ctx is not None:
        DEFAULT_RECORDER.complete(ctx.trace, status=status)


@contextlib_contextmanager
def ensure(name: str, **attrs: Any):
    """Yield the ACTIVE context, or open (and activate) a fresh trace for
    the duration — the entry-point idiom for code reachable both from a
    traced HTTP request and directly (scripts, tests, chaos drives)."""
    from docqa_tpu_torch.obs.context import current

    ctx = current()
    if ctx is not None:
        yield ctx
        return
    ctx = new_trace(name, **attrs)
    if ctx is None:
        yield None
        return
    with ctx.activate():
        yield ctx


def finish_id(
    trace_id: Optional[str], status: str = "ok", flag: Optional[str] = None
) -> None:
    """Finish an open trace by id (the pipeline's terminal-status path,
    which holds only the message headers)."""
    if not trace_id:
        return
    trace = DEFAULT_RECORDER.get(trace_id)
    if trace is None or trace.finished:
        return
    if flag:
        trace.flag(flag)
    DEFAULT_RECORDER.complete(trace, status="error" if flag else status)
