"""On-demand ``torch.profiler`` window and per-stage attribution, counterpart
of ``docqa_tpu/obs/profiler.py``.

* :class:`ProfilerWindow` starts and stops one ``torch.profiler`` trace (CPU
  activity, plus CUDA activity when the device is a card) and writes its
  Chrome trace into the window's logdir.  One window at a time; while it is
  open, ``runtime/metrics.span`` also enters ``torch.profiler.
  record_function`` so stages show up in the trace by name.
* :func:`attribution` folds completed request timelines into a per-stage
  table (count, total, p50, p95, share of wall), each stage classified
  device or host (:data:`DEVICE_STAGES`; a ``dispatch:<stage>`` span of the
  spine is device by construction), with an "(unattributed)" row for wall
  time no span covered.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Optional

from docqa_tpu_torch.obs.export import coverage
from docqa_tpu_torch.obs.spans import Trace, percentile_nearest_rank

# Stage -> device/host classification: a "device" span's wall time is
# dominated by device work (the spine item that runs it completes it); a
# "host" span is host work or waiting on host events.  The reference's
# list, so both packages classify a timeline the same way; unknown stages
# read "host" (the conservative read).
DEVICE_STAGES = frozenset(
    {
        "serve_prefill",
        "serve_decode_chunk",
        "encode_batch",
        "fused_query",
        "fused_tiered_query",
        "store_search",
        "store_add",
        "generate",
        "seq2seq_generate",
        "fused_rag_generate",
        "ivf_build",
        "ivf_search",
        "tiered_search",
        "tiered_rebuild",
        "deid_batch",
        "index_batch",
    }
)


def stage_kind(name: str) -> str:
    # "dispatch:<stage>" spans are recorded by the dispatch spine
    # (engines/spine.py) around device work items — device by
    # construction, whatever the stage is called
    if name.startswith("dispatch:"):
        return "device"
    return "device" if name in DEVICE_STAGES else "host"


def attribution(traces: Iterable[Trace]) -> List[Dict[str, Any]]:
    """Per-stage rows over completed traces, sorted by total time desc,
    with an "(unattributed)" row for wall time no span covered.  Share
    is of total request wall (root durations summed), so overlapping
    spans (result-wait over decode chunks) can push the stage SUM past
    100% — share answers "how much wall does this stage touch", not a
    partition; the device/host split plus the unattributed row are the
    partition-style reads."""
    traces = [t for t in traces if t is not None]
    per_stage: Dict[str, List[float]] = {}
    wall_total = 0.0
    covered_total = 0.0
    for trace in traces:
        wall = trace.duration_ms
        wall_total += wall
        covered_total += coverage(trace) * wall
        for sp in trace.snapshot_spans():
            if sp is trace.root:
                continue
            per_stage.setdefault(sp.name, []).append(sp.duration_ms)
    rows: List[Dict[str, Any]] = []
    for name, durs in per_stage.items():
        durs.sort()
        total = sum(durs)
        rows.append(
            {
                "stage": name,
                "kind": stage_kind(name),
                "count": len(durs),
                "total_ms": round(total, 1),
                "mean_ms": round(total / len(durs), 2),
                "p50_ms": round(percentile_nearest_rank(durs, 50), 2),
                "p95_ms": round(percentile_nearest_rank(durs, 95), 2),
                "share_pct": round(100.0 * total / wall_total, 1)
                if wall_total
                else 0.0,
            }
        )
    rows.sort(key=lambda r: -r["total_ms"])
    if wall_total:
        rows.append(
            {
                "stage": "(unattributed)",
                "kind": "host",
                "count": len(traces),
                "total_ms": round(wall_total - covered_total, 1),
                "mean_ms": round(
                    (wall_total - covered_total) / max(len(traces), 1), 2
                ),
                "p50_ms": None,
                "p95_ms": None,
                "share_pct": round(
                    100.0 * (wall_total - covered_total) / wall_total, 1
                ),
            }
        )
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    """Fixed-width text table for script output."""
    header = (
        f"{'stage':<24} {'kind':<6} {'count':>6} {'total_ms':>10} "
        f"{'mean_ms':>8} {'p50_ms':>8} {'p95_ms':>8} {'share%':>7}"
    )
    lines = [header, "-" * len(header)]
    for r in rows:
        p50 = "-" if r["p50_ms"] is None else f"{r['p50_ms']:.2f}"
        p95 = "-" if r["p95_ms"] is None else f"{r['p95_ms']:.2f}"
        lines.append(
            f"{r['stage']:<24} {r['kind']:<6} {r['count']:>6} "
            f"{r['total_ms']:>10.1f} {r['mean_ms']:>8.2f} {p50:>8} "
            f"{p95:>8} {r['share_pct']:>7.1f}"
        )
    return "\n".join(lines)


def device_host_split(traces: Iterable[Trace]) -> Dict[str, float]:
    """Aggregate device-ms vs host-ms over the traces (host = wall not
    inside a device-classified span)."""
    device = 0.0
    wall = 0.0
    for trace in traces:
        if trace is None:
            continue
        wall += trace.duration_ms
        for sp in trace.snapshot_spans():
            if sp is not trace.root and stage_kind(sp.name) == "device":
                device += sp.duration_ms
    return {
        "device_ms": round(device, 1),
        "host_ms": round(max(wall - device, 0.0), 1),
        "wall_ms": round(wall, 1),
    }


def _all_threads():
    """The profiler config that records the ranges of every thread (the
    batcher's worker, the spine's lanes), where this torch offers it; else
    None, and only the thread that opened the window shows its ranges."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class ProfilerWindow:
    """One guarded ``torch.profiler`` start/stop window.

    torch is imported inside the methods, so importing obs imports no
    torch.  :attr:`active` is a lock-free read: ``runtime/metrics.span``
    checks it on every span."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logdir: Optional[str] = None
        self._prof: Any = None
        # Chrome trace of the last closed window
        self.trace_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._logdir is not None

    @property
    def logdir(self) -> Optional[str]:
        return self._logdir

    def start(self, logdir: Optional[str] = None, device: Any = None) -> str:
        """Open the window.  ``device`` picks the activities: CUDA ones on
        a card (default: when torch sees one), CPU ones always."""
        import tempfile

        import torch
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._logdir is not None:
                raise RuntimeError(
                    f"profiler window already active ({self._logdir})"
                )
            if logdir is None:
                logdir = tempfile.mkdtemp(prefix="docqa_profile_")
            os.makedirs(logdir, exist_ok=True)
            on_card = (
                torch.device(device).type == "cuda"
                if device is not None
                else torch.cuda.is_available()
            )
            activities = [ProfilerActivity.CPU]
            if on_card:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(
                activities=activities, experimental_config=_all_threads()
            )
            prof.start()
            self._prof = prof
            self._logdir = logdir
            return logdir

    def stop(self) -> str:
        """Close the window and write ``trace.json`` (Chrome trace format)
        into its logdir; returns the logdir."""
        with self._lock:
            if self._logdir is None:
                raise RuntimeError("no profiler window active")
            prof, logdir = self._prof, self._logdir
            self._prof = self._logdir = None
            prof.stop()
            path = os.path.join(logdir, "trace.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            return logdir


DEFAULT_PROFILER = ProfilerWindow()
