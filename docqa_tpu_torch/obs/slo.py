"""SLO objectives and multi-window burn-rate alerting over telemetry,
counterpart of ``docqa_tpu/obs/slo.py``.

An SLO is a budgeted promise about /ask: availability (the non-failure
fraction), p95 latency (the fraction of requests under a threshold) and the
degraded-answer rate.  Burn rate is how fast the error budget is spent
relative to plan: 1.0 spends exactly the budget over the objective period.
An alert fires only when a short window (fast detection) and a long window
(evidence the burn is sustained) both exceed ``burn_threshold``; windows
count telemetry rollup windows, so one config serves a 10 s production
cadence and a 100 ms test cadence.

Firing flags the firing window's traces anomalous in the flight recorder,
and :meth:`BurnRateEvaluator.firing` is the probe the QoS layer's batch
deferral reads (``QoSConfig.defer_batch_on_burn``).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from docqa_tpu_torch.obs.telemetry import TelemetryStore


@dataclass(frozen=True)
class SLODef:
    """One objective.  ``kind``:

    * ``"latency"`` — good = samples of ``digest_name`` at or under
      ``threshold_ms``; ``objective`` is the good fraction (0.95 = a
      p95 objective by construction);
    * ``"ratio"`` — good = 1 − ``bad_series``/``total_series`` counter
      deltas; covers availability (bad = 5xx) and degraded-answer rate
      (bad = ``qa_degraded``) alike; ``objective`` is the good fraction.
    """

    name: str
    kind: str  # "latency" | "ratio"
    objective: float
    total_series: str = ""
    bad_series: str = ""
    digest_name: str = ""
    threshold_ms: float = 0.0
    short_windows: int = 2
    long_windows: int = 30
    burn_threshold: float = 4.0
    clear_windows: int = 3
    # traffic floor: burn math over a handful of events is noise — below
    # this many events in the window, the window reads as not burning
    min_events: int = 6
    # which trace names the firing window flags anomalous (empty = all)
    trace_names: Tuple[str, ...] = ()

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)


def default_ask_slos(
    p95_objective_ms: float,
    availability: float = 0.99,
    degraded_budget: float = 0.05,
    short_windows: int = 2,
    long_windows: int = 30,
    burn_threshold: float = 4.0,
) -> List[SLODef]:
    """The /ask objectives served by default: availability, p95 latency,
    degraded-answer rate.  ``ask_requests``/``ask_failures`` are stamped
    where an /ask answers; ``qa_degraded`` by ``service/qa.py``."""
    ask_traces = ("ask", "ask_stream")
    return [
        SLODef(
            name="ask_availability",
            kind="ratio",
            objective=availability,
            total_series="ask_requests",
            bad_series="ask_failures",
            short_windows=short_windows,
            long_windows=long_windows,
            burn_threshold=burn_threshold,
            trace_names=ask_traces,
        ),
        SLODef(
            name="ask_p95_latency",
            kind="latency",
            objective=0.95,
            digest_name="qa_e2e_ms",
            threshold_ms=p95_objective_ms,
            short_windows=short_windows,
            long_windows=long_windows,
            burn_threshold=burn_threshold,
            trace_names=ask_traces,
        ),
        SLODef(
            name="ask_degraded_rate",
            kind="ratio",
            objective=1.0 - degraded_budget,
            total_series="ask_requests",
            bad_series="qa_degraded",
            short_windows=short_windows,
            long_windows=long_windows,
            burn_threshold=burn_threshold,
            trace_names=ask_traces,
        ),
    ]


def default_retrieval_slos(
    recall_target: float = 0.95,
    short_windows: int = 2,
    long_windows: int = 30,
    burn_threshold: float = 4.0,
    min_events: int = 6,
) -> List[SLODef]:
    """The retrieval-quality objective (docqa-recallscope): a ratio-kind
    SLO over the shadow estimator's per-comparison counters — good
    fraction == online recall@k, objective == the configured recall
    target — so a recall regression burns and alerts EXACTLY like an
    availability or latency burn, flagging the window's /ask traces
    anomalous.  ``retrieve_shadow_expected`` / ``retrieve_shadow_missed``
    are stamped by ``obs/retrieval_observatory.py`` per shadow
    comparison and rolled into windows by the telemetry sampler."""
    return [
        SLODef(
            name="retrieve_recall",
            kind="ratio",
            objective=recall_target,
            total_series="retrieve_shadow_expected",
            bad_series="retrieve_shadow_missed",
            short_windows=short_windows,
            long_windows=long_windows,
            burn_threshold=burn_threshold,
            min_events=min_events,
            trace_names=("ask", "ask_stream"),
        ),
    ]


@dataclass
class _AlertState:
    firing: bool = False
    fired_at_unix: Optional[float] = None
    fired_count: int = 0
    # distinct windows seen with short burn below 1.0 while firing
    calm_windows: int = 0
    last_eval_widx: Optional[int] = None
    last_short_burn: float = 0.0
    last_long_burn: float = 0.0
    history: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=32)
    )


class BurnRateEvaluator:
    """Evaluates every SLO once per telemetry tick (the sampler calls
    :meth:`evaluate`).  Thread-safe; designed to be read (``status()``)
    from HTTP handlers while the sampler thread evaluates."""

    def __init__(
        self,
        store: TelemetryStore,
        slos: List[SLODef],
        registry=None,  # metrics registry: alert counters + gauges
        recorder=None,  # flight recorder: firing-window trace flagging
    ) -> None:
        self.store = store
        self.slos = list(slos)
        self.registry = registry
        self.recorder = recorder
        self._lock = threading.Lock()
        self._states: Dict[str, _AlertState] = {
            s.name: _AlertState() for s in self.slos
        }
        # latency objectives must pre-register their thresholds so
        # sealed windows carry over-threshold counts
        for slo in self.slos:
            if slo.kind == "latency":
                d = self._digest(slo)
                if d is not None:
                    d.register_threshold(slo.threshold_ms)

    # ---- inputs --------------------------------------------------------------

    def _digest(self, slo: SLODef):
        if self.registry is None:
            return None
        # histogram() creates on first touch — the digest (and its
        # registered threshold) must exist BEFORE the first request
        # observes into it, or early windows would lack over-counts
        h = self.registry.histogram(slo.digest_name)
        return getattr(h, "digest", None)

    def _window_burn(
        self, slo: SLODef, n_windows: int, now: Optional[float]
    ) -> Tuple[float, int]:
        """(burn rate, total events) over the last ``n_windows``."""
        if slo.kind == "latency":
            d = self._digest(slo)
            if d is None:
                return 0.0, 0
            counts = d.window_counts(
                n_windows, threshold_ms=slo.threshold_ms, now=now
            )
            total, bad = counts["total"], counts["over"]
        else:
            total = int(
                self.store.window_delta(slo.total_series, n_windows, now=now)
            )
            bad = int(
                self.store.window_delta(slo.bad_series, n_windows, now=now)
            )
        if total < slo.min_events:
            return 0.0, total
        return (bad / total) / slo.budget, total

    # ---- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One pass over every SLO; returns the transitions (fired /
        cleared) this pass produced."""
        transitions: List[Dict[str, Any]] = []
        widx = self.store.widx(now)
        for slo in self.slos:
            short_burn, _ = self._window_burn(slo, slo.short_windows, now)
            long_burn, _ = self._window_burn(slo, slo.long_windows, now)
            with self._lock:
                st = self._states[slo.name]
                new_window = st.last_eval_widx != widx
                st.last_short_burn = short_burn
                st.last_long_burn = long_burn
                if not st.firing:
                    if (
                        short_burn >= slo.burn_threshold
                        and long_burn >= slo.burn_threshold
                    ):
                        st.firing = True
                        st.fired_at_unix = time.time()
                        st.fired_count += 1
                        st.calm_windows = 0
                        st.history.append(
                            {
                                "event": "fired",
                                "t_unix": st.fired_at_unix,
                                "short_burn": round(short_burn, 2),
                                "long_burn": round(long_burn, 2),
                            }
                        )
                        transitions.append(
                            {"slo": slo.name, "event": "fired"}
                        )
                        self._on_fired(slo, widx)
                else:
                    if short_burn < 1.0:
                        if new_window:
                            st.calm_windows += 1
                        if st.calm_windows >= slo.clear_windows:
                            st.firing = False
                            st.calm_windows = 0
                            st.history.append(
                                {"event": "cleared", "t_unix": time.time()}
                            )
                            transitions.append(
                                {"slo": slo.name, "event": "cleared"}
                            )
                            self._gauge(slo, 0.0)
                    else:
                        st.calm_windows = 0
                        # still burning: keep marking the current
                        # window's traces so an ongoing incident's
                        # evidence doesn't stop at the firing edge
                        self._flag_window(slo, widx, widx)
                st.last_eval_widx = widx
        return transitions

    def _on_fired(self, slo: SLODef, widx: int) -> None:
        if self.registry is not None:
            self.registry.counter(f"slo_{slo.name}_fired").inc()
        self._gauge(slo, 1.0)
        # the firing evidence: every trace in the short window that
        # crossed the threshold is flagged into the always-keep ring
        self._flag_window(slo, widx - slo.short_windows + 1, widx)

    def _gauge(self, slo: SLODef, value: float) -> None:
        if self.registry is not None:
            self.registry.gauge(f"slo_{slo.name}_burning").set(value)

    def _flag_window(self, slo: SLODef, widx_lo: int, widx_hi: int) -> None:
        if self.recorder is None:
            return
        t_lo = self.store.window_wall_start(widx_lo)
        t_hi = self.store.window_wall_start(widx_hi + 1)
        self.recorder.flag_window(
            t_lo,
            t_hi,
            f"slo_{slo.name}_burn",
            names=slo.trace_names or None,
        )

    # ---- surfaces ------------------------------------------------------------

    def status(self) -> List[Dict[str, Any]]:
        out = []
        for slo in self.slos:
            with self._lock:
                st = self._states[slo.name]
                row: Dict[str, Any] = {
                    "name": slo.name,
                    "kind": slo.kind,
                    "objective": slo.objective,
                    "burn_threshold": slo.burn_threshold,
                    "windows": [slo.short_windows, slo.long_windows],
                    "short_burn": round(st.last_short_burn, 3),
                    "long_burn": round(st.last_long_burn, 3),
                    "firing": st.firing,
                    "fired_count": st.fired_count,
                    "fired_at_unix": st.fired_at_unix,
                    "history": list(st.history),
                }
            if slo.kind == "latency":
                row["threshold_ms"] = slo.threshold_ms
                row["series"] = slo.digest_name
            else:
                row["series"] = [slo.total_series, slo.bad_series]
            out.append(row)
        return out

    def firing(self) -> List[str]:
        with self._lock:
            return [
                name for name, st in self._states.items() if st.firing
            ]

    def any_firing(self, *names: str) -> bool:
        """True if any of the named SLOs is currently burning (all SLOs
        when called with no names).  Convenience for policy hooks —
        e.g. the QoS layer's batch-deferral check — that gate on a
        subset of alerts without list plumbing."""
        with self._lock:
            if not names:
                return any(st.firing for st in self._states.values())
            return any(
                st.firing
                for name, st in self._states.items()
                if name in names
            )
