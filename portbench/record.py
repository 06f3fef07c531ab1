"""What a run hands to the metric readers (``metrics/<name>.py``).

A reader is a function ``read(run) -> float | None`` over a :class:`Run`:
the cell's configuration and mix, every ask's record, the window's bounds
on the host clock, the changes over the window in the port's counters (the
dispatch spine's per-stage items and device seconds, the pool's work
counts) and, in a traced run, the reduced trace.  A reader that finds
nothing to read returns None and its metric is left out of the line.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from portbench.flops import ModelShape


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) over all the values."""
    ordered = sorted(values)
    if not ordered:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


@dataclass
class Run:
    config: Dict[str, Any]
    mix: Dict[str, Any]
    shape: ModelShape
    records: List[Any]
    t_open: float  # perf_counter
    t_close: float
    setup_s: float
    spine: Dict[str, Dict[str, float]] = field(default_factory=dict)  # stage -> delta
    stats: Dict[str, float] = field(default_factory=dict)  # pool stats delta
    trace: Optional[Any] = None  # trace.Summary

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def judged(self) -> List[Any]:
        """The asks the window is judged on: those that ended inside it
        (the asks that the close cancelled left out)."""
        return [r for r in self.records
                if self.t_open <= r.t_end <= self.t_close and r.outcome != "cancelled"]

    def latencies(self, first: bool) -> List[float]:
        """Seconds from each judged ask's sending to its first answer
        delta (``first``) or to its whole answer; an ask that failed
        counts as missing every limit: the mix's whole budget, or its
        measured time where that is longer."""
        budget = float(self.mix["request_deadline_s"])
        out = []
        for r in self.judged():
            t = r.t_first if first else r.t_end
            if r.answered and not math.isnan(t):
                out.append(t - r.t_due)
            else:
                end = r.t_end if not math.isnan(r.t_end) else self.t_close
                out.append(max(budget, end - r.t_due))
        return out

    def pieces_in_window(self) -> int:
        """Answer tokens delivered inside the window (each a text delta)."""
        return sum(1 for r in self.records for t in r.piece_times
                   if self.t_open <= t <= self.t_close)

    def spine_stage(self, stage: str) -> Dict[str, float]:
        return self.spine.get(stage, {"count": 0, "device_s": 0.0})
