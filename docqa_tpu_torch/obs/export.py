"""Timeline export: JSON and Chrome-trace formats, counterpart of
``docqa_tpu/obs/export.py``.

:func:`timeline_dict` gives trace-relative millisecond spans plus the
coverage figure (the union of child spans over the request's wall time).
:func:`to_chrome_trace` emits the Trace Event Format (``ph: "X"`` complete
events, microsecond timestamps) that Perfetto and ``chrome://tracing``
load; each trace gets its own ``tid`` row.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

from docqa_tpu_torch.obs.spans import Span, Trace


def _span_dict(trace: Trace, sp: Span) -> Dict[str, Any]:
    end = sp.t_end if sp.t_end is not None else sp.t_start
    return {
        "name": sp.name,
        "span_id": sp.span_id,
        "parent_id": sp.parent_id,
        "start_ms": round((sp.t_start - trace.t0) * 1000.0, 3),
        "end_ms": round((end - trace.t0) * 1000.0, 3),
        "duration_ms": round((end - sp.t_start) * 1000.0, 3),
        "attrs": dict(sp.attrs),
        "events": [
            {
                **{k: v for k, v in evt.items() if k != "t"},
                "t_ms": round((evt["t"] - trace.t0) * 1000.0, 3),
            }
            for evt in sp.events
        ],
    }


def coverage(trace: Trace) -> float:
    """Fraction of the root span's wall time covered by the union of its
    child spans — the "no unattributed gap" acceptance figure.  Child
    intervals are clipped to the root window and merged, so overlapping
    spans (a result-wait spanning decode chunks) count once."""
    spans = trace.snapshot_spans()
    root = trace.root
    root_end = root.t_end if root.t_end is not None else max(
        (s.t_end or s.t_start for s in spans), default=root.t_start
    )
    total = root_end - root.t_start
    if total <= 0:
        return 1.0
    intervals = []
    for sp in spans:
        if sp is root:
            continue
        lo = max(sp.t_start, root.t_start)
        hi = min(sp.t_end if sp.t_end is not None else root_end, root_end)
        if hi > lo:
            intervals.append((lo, hi))
    if not intervals:
        return 0.0
    intervals.sort()
    covered = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo
    return min(covered / total, 1.0)


def timeline_dict(trace: Trace) -> Dict[str, Any]:
    spans = trace.snapshot_spans()
    out = {
        "trace_id": trace.trace_id,
        "name": trace.name,
        "status": trace.status,
        "flags": list(trace.flags),
        "started_unix": trace.wall0,
        "duration_ms": round(trace.duration_ms, 3),
        "coverage": round(coverage(trace), 4),
        "spans": [_span_dict(trace, sp) for sp in spans],
    }
    # per-request cost summary (docqa-costscope): attached by the
    # ledger at retirement — class, outcome, device-ms split, KV
    # block-seconds.  Absent on unaccounted traces.
    cost = getattr(trace, "cost_summary", None)
    if cost is not None:
        out["cost"] = cost
    return out


def to_chrome_trace(traces: Iterable[Trace]) -> Dict[str, Any]:
    traces = list(traces)
    if not traces:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(t.t0 for t in traces)
    events: List[Dict[str, Any]] = []
    for tid, trace in enumerate(traces, start=1):
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 1,
                "tid": tid,
                "args": {"name": f"{trace.name} {trace.trace_id}"},
            }
        )
        cost = getattr(trace, "cost_summary", None)
        if cost is not None:
            # the cost vector as an instant event at trace start: shows
            # up in Perfetto's args pane without inventing counter rows
            events.append(
                {
                    "ph": "i",
                    "s": "t",
                    "name": "cost_summary",
                    "pid": 1,
                    "tid": tid,
                    "ts": round((trace.t0 - base) * 1e6, 1),
                    "args": dict(cost),
                }
            )
        for sp in trace.snapshot_spans():
            end = sp.t_end if sp.t_end is not None else sp.t_start
            events.append(
                {
                    "ph": "X",
                    "name": sp.name,
                    "cat": trace.name,
                    "pid": 1,
                    "tid": tid,
                    "ts": round((sp.t_start - base) * 1e6, 1),
                    "dur": round((end - sp.t_start) * 1e6, 1),
                    "args": {
                        "trace_id": trace.trace_id,
                        "span_id": sp.span_id,
                        "parent_id": sp.parent_id,
                        **sp.attrs,
                    },
                }
            )
            for evt in sp.events:
                events.append(
                    {
                        "ph": "i",
                        "s": "t",
                        "name": evt["name"],
                        "pid": 1,
                        "tid": tid,
                        "ts": round((evt["t"] - base) * 1e6, 1),
                        "args": {
                            k: v
                            for k, v in evt.items()
                            if k not in ("name", "t")
                        },
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
