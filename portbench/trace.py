"""The traced part of a ``--trace 1`` run and its reduction.

The window is the port's own profiler window (``obs.DEFAULT_PROFILER``,
CPU and CUDA activity, every thread), so the port's stage spans
(``serve_prefill``, ``serve_decode_chunk``, ``fused_query`` ...) show up as
ranges.  Its Chrome trace is read back into device intervals, kernels and
the host ranges; two clock marks, taken inside ``record_function`` ranges,
bound the traced window.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MARK = "portbench_clock"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Kernel:
    name: str
    ts: float  # microseconds, trace clock
    dur: float


@dataclass
class Summary:
    t0: float  # window start and end, microseconds, trace clock
    t1: float
    kernels: List[Kernel] = field(default_factory=list)
    device: List[Tuple[float, float]] = field(default_factory=list)  # every device op
    ranges: List[Tuple[str, int, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_us(self.device, self.t0, self.t1) / 1e6


def union_us(intervals, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Window:
    """Open and close the port's profiler window around part of a run."""

    def __init__(self, logdir: str, device):
        self.logdir, self.device = logdir, device

    def _mark(self) -> None:
        import torch.profiler

        with torch.profiler.record_function(MARK):
            pass

    def start(self) -> None:
        from docqa_tpu_torch.obs import DEFAULT_PROFILER

        os.makedirs(self.logdir, exist_ok=True)
        DEFAULT_PROFILER.start(logdir=self.logdir, device=self.device)
        self._mark()

    def stop(self) -> str:
        from docqa_tpu_torch.obs import DEFAULT_PROFILER

        self._mark()
        DEFAULT_PROFILER.stop()
        return DEFAULT_PROFILER.trace_path


def read(path: str) -> Summary:
    """Reduce a Chrome trace written by :class:`Window`."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    marks, ranges, device, kernels = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if ev["name"] == MARK:
                marks.append(ts)
                continue
            ranges.append((ev["name"], ev.get("tid"), ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append(Kernel(ev["name"], ts, dur))
    if len(marks) < 2:
        raise ValueError(f"{path}: the window's clock marks are missing")
    marks.sort()
    return Summary(t0=marks[0], t1=marks[-1], kernels=kernels, device=device, ranges=ranges)


def breakdown(summary: Summary, top: int = 10) -> Dict[str, List[List]]:
    """The device operations that took most time, and the idle time by what
    the host was doing (the innermost stage range open on any thread at each
    gap's middle), each a list of ``[name, seconds]``."""
    by_name: Dict[str, float] = defaultdict(float)
    for k in summary.kernels:
        if summary.t0 <= k.ts <= summary.t1:
            by_name[k.name[:160]] += k.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the gaps between device intervals, labelled in one sweep over the
    # ranges ordered by start
    gap_list, end = [], summary.t0
    for s, e in sorted(summary.device) + [(summary.t1, summary.t1)]:
        s, e = max(s, summary.t0), min(e, summary.t1)
        if s > end:
            gap_list.append(((s + end) / 2, (s - end) / 1e6))
        end = max(end, e)
    spans = sorted(summary.ranges, key=lambda r: r[2])
    gaps: Dict[str, float] = defaultdict(float)
    active: List[Tuple[str, int, float, float]] = []
    j = 0
    for mid, seconds in gap_list:
        while j < len(spans) and spans[j][2] <= mid:
            active.append(spans[j])
            j += 1
        active = [r for r in active if r[3] >= mid]
        label = min(active, key=lambda r: r[3] - r[2])[0] if active else "(no stage open)"
        gaps[label] += seconds
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}
