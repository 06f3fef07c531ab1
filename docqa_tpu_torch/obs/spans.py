"""Host-side span recording, counterpart of ``docqa_tpu/obs/spans.py``.

A :class:`Trace` is a thread-safe record of one request's timeline: a root
span plus child spans recorded from any thread.  Two recording styles share
one storage:

* :func:`start_span`, a context manager for code running under the
  request's context var (``runtime/metrics.span`` wraps it);
* :meth:`Trace.record_span`, explicit (name, t_start, t_end) for the batcher
  worker and the pipeline consumers, which serve many requests per thread.

Span times are ``time.perf_counter()`` values, the clock
``runtime/metrics.span`` uses too; each trace anchors one wall-clock
timestamp at birth for export.  Recording is a list append under a lock.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import contextlib

from docqa_tpu_torch.obs.context import TraceContext, current


def percentile_nearest_rank(ordered: list, q: float) -> float:
    """Nearest-rank percentile over an already-SORTED sequence — the ONE
    implementation behind the recorder's slow-p95 flagging, the
    attribution table's p50/p95, and the metrics histograms, so the
    three can never disagree about what "p95" means.  Returns 0.0 on
    empty input (callers gate on sample counts themselves)."""
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, max(0, round(q / 100 * (len(ordered) - 1))))
    return ordered[idx]


@dataclass
class Span:
    """One timed interval.  ``t_start``/``t_end`` are perf_counter
    values; export converts to trace-relative milliseconds."""

    name: str
    span_id: str
    parent_id: Optional[str]
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def duration_ms(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return (end - self.t_start) * 1000.0


class Trace:
    """All spans of one request.  Thread-safe; completion is idempotent."""

    def __init__(
        self, trace_id: str, name: str, attrs: Optional[Dict[str, Any]] = None
    ) -> None:
        self.trace_id = trace_id
        self.name = name
        self.t0 = time.perf_counter()
        self.wall0 = time.time()  # export anchor only; never used for math
        self.status: Optional[str] = None
        self.flags: List[str] = []
        self._lock = threading.Lock()
        self._span_ids = itertools.count(2)
        self.root = Span(
            name=name, span_id="s1", parent_id=None, t_start=self.t0,
            attrs=dict(attrs or {}),
        )
        self.spans: List[Span] = [self.root]

    # ---- recording -----------------------------------------------------------

    def _new_span_id(self) -> str:
        return f"s{next(self._span_ids)}"

    def start_span(
        self, name: str, parent_id: Optional[str] = None, **attrs: Any
    ) -> Span:
        sp = Span(
            name=name,
            span_id=self._new_span_id(),
            parent_id=parent_id or self.root.span_id,
            t_start=time.perf_counter(),
            attrs=attrs,
        )
        with self._lock:
            self.spans.append(sp)
        return sp

    def end_span(self, span: Span, t_end: Optional[float] = None) -> None:
        span.t_end = t_end if t_end is not None else time.perf_counter()

    def record_span(
        self,
        name: str,
        t_start: float,
        t_end: float,
        parent_id: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Explicit-times recording — the worker-thread API (the batcher
        and pipeline consumers multiplex requests, so the interval is
        measured first and attributed to a request's trace after)."""
        sp = Span(
            name=name,
            span_id=self._new_span_id(),
            parent_id=parent_id or self.root.span_id,
            t_start=t_start,
            t_end=t_end,
            attrs=attrs,
        )
        with self._lock:
            self.spans.append(sp)
        return sp

    def add_event(
        self, name: str, span_id: Optional[str] = None, **attrs: Any
    ) -> None:
        evt = {"name": name, "t": time.perf_counter(), **attrs}
        with self._lock:
            target = self.root
            if span_id is not None:
                for sp in reversed(self.spans):
                    if sp.span_id == span_id:
                        target = sp
                        break
            target.events.append(evt)

    def flag(self, reason: str) -> None:
        with self._lock:
            if reason not in self.flags:
                self.flags.append(reason)

    # ---- completion ----------------------------------------------------------

    def finish(self, status: str = "ok") -> bool:
        """Close the root span; True only the FIRST time (idempotent —
        a trace can reach completion from both the HTTP layer and a
        pipeline terminal-status write)."""
        with self._lock:
            if self.root.t_end is not None:
                return False
            self.root.t_end = time.perf_counter()
            self.status = status
            for sp in self.spans:
                if sp.t_end is None:  # close stragglers at trace end
                    sp.t_end = self.root.t_end
            return True

    @property
    def finished(self) -> bool:
        return self.root.t_end is not None

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    def snapshot_spans(self) -> List[Span]:
        with self._lock:
            return list(self.spans)


@contextlib.contextmanager
def start_span(name: str, **attrs: Any) -> Iterator[Optional[Span]]:
    """Record a child span of the ACTIVE context (no-op when untraced:
    one context-var read).  The body runs with the child as the current
    context, so nested spans parent correctly."""
    ctx = current()
    if ctx is None:
        yield None
        return
    sp = ctx.trace.start_span(name, parent_id=ctx.span_id, **attrs)
    child = TraceContext(ctx.trace, sp.span_id)
    with child.activate():
        try:
            yield sp
        finally:
            ctx.trace.end_span(sp)
