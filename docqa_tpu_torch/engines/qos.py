"""Multi-tenant QoS policy for the continuous batcher, counterpart of
``docqa_tpu/engines/qos.py`` (host only, near verbatim).

* :class:`ClassQueue` — a drop-in for the batcher's FIFO admission deque
  that keeps one deque per request class and picks the next head by
  weighted-fair queueing (deficit-style virtual time) with a
  starvation-aging floor.
* :class:`QoSPolicy` — the configured weights, aging floor, preemption
  mode (``off`` / ``advisory`` / ``on``), class ranks for victim selection
  and the SLO-burn deferral rule.
* ``CLASS_RANK`` / ``DEFER_SLOS`` — the fixed policy tables.  Ranks are not
  the weights: weights shape throughput sharing among admitted work, ranks
  decide who may evict whom under block pressure.

A request's class is its cost record's class (``obs/costs.py``), as in
the reference: the class it was submitted with, or the class its
endpoint stamped on the trace.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "CLASS_RANK",
    "DEFER_SLOS",
    "ClassQueue",
    "QoSPolicy",
    "request_class",
]

# who may evict whom: preemption requires pressure rank > victim rank.
# interactive outranks everything; background is always the first victim;
# batch and unclassed traffic are peers (no mutual eviction)
CLASS_RANK: Dict[str, int] = {
    "interactive": 3,
    "batch": 2,
    "other": 2,
    "background": 1,
}
_DEFAULT_RANK = 2

# the SLO burns that defer batch-class admission: the interactive SLOs this
# layer protects (the degraded-rate SLO is absent: degradation is often
# caused by load shedding, and deferring on it would latch the pressure)
DEFER_SLOS: Tuple[str, ...] = ("ask_p95_latency", "ask_availability")

# deterministic class order for iteration/sweeps
_CLASS_ORDER = ("interactive", "batch", "other", "background")


def request_class(req) -> str:
    """A request's QoS class: its cost record's class, or ``other`` when
    the ledger is off (the convention of ``pressure_by_class``)."""
    cost = getattr(req, "cost", None)
    return cost.cls if cost is not None else "other"


class ClassQueue:
    """Per-class admission queue with weighted-fair head selection.

    All mutation and inspection happens under the batcher's ``_cv``, like
    the deque it replaces.  Each class carries a virtual time
    ``served / weight``; the next head is the non-empty class with the
    smallest one.  Two guards: a head that waited longer than
    ``aging_floor_s`` wins outright (oldest first), and a class going
    empty -> non-empty has its virtual time clamped up to the current
    minimum (idle time banks no credit).  ``[0]`` pins the selected head:
    the next ``popleft`` returns exactly that request."""

    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        aging_floor_s: float = 0.0,
        now_fn=None,
    ) -> None:
        self._weights = dict(weights or {})
        self.aging_floor_s = float(aging_floor_s)
        self._now = now_fn or time.perf_counter
        self._queues: Dict[str, collections.deque] = {}
        self._vtime: Dict[str, float] = {}
        self._peeked: Optional[str] = None

    # ---- policy internals ------------------------------------------------

    def _weight(self, cls: str) -> float:
        w = self._weights.get(cls)
        if w is None:
            # unknown/unclassed classes share batch's weight
            w = self._weights.get("batch", 1.0)
        return max(float(w), 1e-9)

    def _deque(self, cls: str) -> collections.deque:
        q = self._queues.get(cls)
        if q is None:
            q = self._queues[cls] = collections.deque()
            self._vtime.setdefault(cls, 0.0)
        return q

    def _nonempty(self) -> List[str]:
        return [c for c, q in self._queues.items() if q]

    def _order(self, cls: str) -> int:
        try:
            return _CLASS_ORDER.index(cls)
        except ValueError:
            return len(_CLASS_ORDER)

    def _select(self) -> Optional[str]:
        """The next class to serve; None when empty."""
        live = self._nonempty()
        if not live:
            return None
        if len(live) == 1:
            return live[0]
        if self.aging_floor_s > 0:
            now = self._now()
            aged = []
            for c in live:
                head = self._queues[c][0]
                t0 = getattr(head, "t_queue", None) or getattr(
                    head, "t_submit", None
                )
                if t0 is not None and now - t0 > self.aging_floor_s:
                    aged.append((t0, self._order(c), c))
            if aged:
                return min(aged)[2]
        return min(live, key=lambda c: (self._vtime[c], self._order(c)))

    def _on_arrival(self, cls: str) -> None:
        if len(self._queues.get(cls, ())) == 1:  # was empty before this
            live = [c for c in self._nonempty() if c != cls]
            if live:
                floor = min(self._vtime[c] for c in live)
                if self._vtime[cls] < floor:
                    self._vtime[cls] = floor

    # ---- deque surface (all under the batcher's _cv) ---------------------

    def append(self, req) -> None:
        self._peeked = None
        cls = request_class(req)
        self._deque(cls).append(req)
        self._on_arrival(cls)

    def appendleft(self, req) -> None:
        # a bounced request goes back to ITS class's head
        self._peeked = None
        cls = request_class(req)
        self._deque(cls).appendleft(req)
        self._on_arrival(cls)

    def popleft(self):
        cls = self._peeked
        self._peeked = None
        if cls is None or not self._queues.get(cls):
            cls = self._select()
        if cls is None:
            raise IndexError("pop from an empty ClassQueue")
        req = self._queues[cls].popleft()
        self._vtime[cls] += 1.0 / self._weight(cls)
        return req

    def __getitem__(self, idx: int):
        if idx != 0:
            raise IndexError("ClassQueue only exposes its head")
        cls = self._select()
        if cls is None:
            raise IndexError("empty ClassQueue")
        self._peeked = cls
        return self._queues[cls][0]

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self) -> Iterator:
        for cls in sorted(self._queues, key=self._order):
            for req in self._queues[cls]:
                yield req

    def clear(self) -> None:
        self._peeked = None
        for q in self._queues.values():
            q.clear()

    def depths(self) -> Dict[str, int]:
        """Per-class queue depths (status snapshot)."""
        return {c: len(q) for c, q in self._queues.items() if q}


class QoSPolicy:
    """The configured QoS policy: weights, ranks, preemption mode and the
    SLO-burn deferral rule.  Built from a ``config.QoSConfig`` by
    :meth:`coerce`."""

    __slots__ = (
        "weights", "aging_floor_s", "preemption", "defer_batch_on_burn",
        "preempt_min_resume_s",
    )

    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        aging_floor_s: float = 5.0,
        preemption: str = "off",
        defer_batch_on_burn: bool = True,
        preempt_min_resume_s: float = 0.5,
    ) -> None:
        self.weights = dict(
            weights
            or {"interactive": 8.0, "batch": 2.0, "background": 1.0}
        )
        self.aging_floor_s = float(aging_floor_s)
        if preemption not in ("off", "advisory", "on"):
            raise ValueError(
                f"preemption must be off|advisory|on, got {preemption!r}"
            )
        self.preemption = preemption
        self.defer_batch_on_burn = bool(defer_batch_on_burn)
        self.preempt_min_resume_s = float(preempt_min_resume_s)

    @classmethod
    def coerce(cls, qos) -> Optional["QoSPolicy"]:
        """None -> None (plain FIFO); a QoSPolicy passes through; anything
        else is read like a ``config.QoSConfig``."""
        if qos is None or isinstance(qos, QoSPolicy):
            return qos
        if not bool(getattr(qos, "enabled", True)):
            return None
        return cls(
            weights={
                "interactive": float(getattr(qos, "weight_interactive", 8.0)),
                "batch": float(getattr(qos, "weight_batch", 2.0)),
                "background": float(getattr(qos, "weight_background", 1.0)),
            },
            aging_floor_s=float(getattr(qos, "aging_floor_s", 5.0)),
            preemption=str(getattr(qos, "preemption", "off")),
            defer_batch_on_burn=bool(getattr(qos, "defer_batch_on_burn", True)),
            preempt_min_resume_s=float(getattr(qos, "preempt_min_resume_s", 0.5)),
        )

    # ---- ranks / victims -------------------------------------------------

    @staticmethod
    def rank(cls_name: Optional[str]) -> int:
        return CLASS_RANK.get(cls_name or "other", _DEFAULT_RANK)

    @staticmethod
    def order_victims(
        holders: Sequence[Tuple[int, str, int]], pressure_cls: str
    ) -> List[Tuple[int, str, int]]:
        """Order ``(slot, class, reclaimable_blocks)`` holders into the
        eviction sequence for ``pressure_cls``: only strictly lower-ranked
        holders qualify, lowest rank first, most reclaimable blocks first
        within a rank, slot index as the final tiebreak."""
        p = QoSPolicy.rank(pressure_cls)
        eligible = [h for h in holders if QoSPolicy.rank(h[1]) < p]
        eligible.sort(key=lambda h: (QoSPolicy.rank(h[1]), -h[2], h[0]))
        return eligible

    # ---- deferral --------------------------------------------------------

    def should_defer(self, cls_name: str, firing: Sequence[str]) -> bool:
        """Defer ``cls_name`` admission given the firing SLO burns (the
        probe is ``obs.BurnRateEvaluator.firing``, wired with
        ``set_slo_probe`` on the batcher or the pool)?  Only batch is ever
        deferred: interactive is the protected class and background carries
        the pool's canaries."""
        if not self.defer_batch_on_burn or cls_name != "batch":
            return False
        return any(name in DEFER_SLOS for name in firing)

    def make_queue(self, now_fn=None) -> ClassQueue:
        return ClassQueue(
            weights=self.weights,
            aging_floor_s=self.aging_floor_s,
            now_fn=now_fn,
        )

    def status(self) -> Dict[str, Any]:
        return {
            "weights": dict(self.weights),
            "aging_floor_s": self.aging_floor_s,
            "preemption": self.preemption,
            "defer_batch_on_burn": self.defer_batch_on_burn,
            "preempt_min_resume_s": self.preempt_min_resume_s,
        }
