"""Request-scoped trace identity and propagation, counterpart of
``docqa_tpu/obs/context.py``.

A :class:`TraceContext` names one logical request (a question's submit ->
admit -> prefill -> decode -> result wait, or a document's extract -> deid
-> index) and rides every boundary that request crosses:

* the same thread: a ``contextvars.ContextVar`` (:func:`current`), so nested
  stages pick the trace up implicitly (``runtime/metrics.span`` records a
  trace span whenever a context is active);
* executor threads: an explicit handoff through :meth:`TraceContext.run` /
  :func:`call_in` (context vars do not cross thread submissions);
* the batcher worker serves many requests at once, so it never uses the
  context var: each queued request carries its trace and the worker records
  spans on it explicitly (``engines/serve.py``);
* broker messages: :func:`headers_of` / ``recorder.from_headers`` carry the
  (trace id, span id) pair in message headers (``service/broker.py``).

Ids are deterministic: a process-wide counter under a settable prefix
(:func:`reset_ids`), so a replayed workload yields the same id sequence.

PHI policy: trace and span attributes hold identifiers and sizes only,
never document or answer text (timelines are exported verbatim).
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, Iterator, Optional

TRACE_HEADER = "x-trace-id"
SPAN_HEADER = "x-parent-span"

_CURRENT: ContextVar[Optional["TraceContext"]] = ContextVar(
    "docqa_trace", default=None
)

# deterministic id mint: prefix + monotonic counter (thread-safe: next()
# on itertools.count is atomic at the C level)
_id_lock = threading.Lock()
_id_prefix = "t"
_id_counter = itertools.count(1)


def reset_ids(prefix: str = "t", start: int = 1) -> None:
    """Restart the id sequence (tests / bench determinism)."""
    global _id_prefix, _id_counter
    with _id_lock:
        _id_prefix = prefix
        _id_counter = itertools.count(start)


def next_trace_id() -> str:
    return f"{_id_prefix}-{next(_id_counter):06x}"


class TraceContext:
    """One (trace, current-span) position.  Immutable; child spans make
    new contexts.  ``trace`` is an ``obs.spans.Trace`` (duck-typed here
    to keep this module dependency-free)."""

    __slots__ = ("trace", "span_id")

    def __init__(self, trace: Any, span_id: str) -> None:
        self.trace = trace
        self.span_id = span_id

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    @contextmanager
    def activate(self) -> Iterator["TraceContext"]:
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)

    def run(self, fn: Callable, *args, **kwargs):
        """Explicit cross-thread handoff: run ``fn`` with this context
        active (the executor-lambda entry point)."""
        with self.activate():
            return fn(*args, **kwargs)


def current() -> Optional[TraceContext]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    ctx = _CURRENT.get()
    return ctx.trace.trace_id if ctx is not None else None


def call_in(ctx: Optional[TraceContext], fn: Callable, *args, **kwargs):
    """Run ``fn`` under ``ctx`` (or plainly when tracing is off) — the
    one helper the HTTP layer threads through its executor lambdas, so
    a disabled recorder costs a single ``None`` check."""
    if ctx is None:
        return fn(*args, **kwargs)
    return ctx.run(fn, *args, **kwargs)


def headers_of(
    ctx: Optional[TraceContext] = None,
) -> Dict[str, str]:
    """Serialize the context for a broker message (empty when inactive).
    The pair is enough to re-link on the consumer side: the open trace
    is found by id, or a stub trace is adopted after a journal replay
    across a restart (the id still ties the hops together)."""
    ctx = ctx if ctx is not None else _CURRENT.get()
    if ctx is None:
        return {}
    return {TRACE_HEADER: ctx.trace.trace_id, SPAN_HEADER: ctx.span_id}


def event(name: str, **attrs: Any) -> None:
    """Record an instant event on the active span (no-op untraced)."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.trace.add_event(name, span_id=ctx.span_id, **attrs)


def flag(reason: str) -> None:
    """Mark the active trace anomalous (always kept by the recorder)."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.trace.flag(reason)
