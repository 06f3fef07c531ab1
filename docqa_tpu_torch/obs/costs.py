"""Per-class request cost attribution, counterpart of
``docqa_tpu/obs/costs.py``.

* Request class: each request carries one of :data:`REQUEST_CLASSES`
  (``interactive`` /ask, ``batch`` bulk generation, ``background`` warm-ups,
  canaries and probes), threaded through qa -> pool -> batcher -> spine by
  the :class:`CostRecord` attached to the request's trace and to the
  batcher's ``_Request``.
* Cost vector: a :class:`CostRecord` accumulates queue and admission wait,
  prefill device ms split cold vs warm with ``prefill_tokens_avoided``,
  decode device ms and tokens, retrieval device ms, spine queue wait,
  estimated FLOPs (the observatory's analytic cost models) and KV
  block-seconds (the time integral of KV blocks held, billed exactly by
  ``engines/paged.BlockAllocator``: a prefix-shared block bills each holder
  ``1/refcount`` per second, so the pool balances to zero after a drain).
* Bounded aggregation: the :class:`RequestCostLedger` folds retired records
  into per-class sums (registry counters ``cost_*_<class>``) and a bounded
  top-K table per session.
* Shed forensics: every queue-full, block-pool, spine-saturation, deadline
  and deferral shed calls :meth:`RequestCostLedger.record_shed`, which keeps
  a pressure snapshot (which classes held how many KV blocks, lanes and
  queue slots at that instant) in a bounded ring.

A record retires once (the first caller wins: the batcher's ``_finish``, a
pool-level shed, or the trace-completion fallback in ``obs/recorder.py``);
cost added after retirement still folds into the aggregates, so accounting
stays exact under eviction and failover.

Stdlib only (the metrics registry is resolved lazily).  Class names,
session hashes, counts and durations only: never query or document text.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

REQUEST_CLASSES = ("interactive", "batch", "background")

# the one fallback bucket: anything outside the taxonomy aggregates
# here, so series cardinality is bounded by construction
OTHER_CLASS = "other"

# fields a CostRecord accumulates (floats; ms unless named otherwise)
COST_FIELDS = (
    "queue_wait_ms",          # serve queue: submit -> admission pop
    "spine_queue_wait_ms",    # attributed dispatch-spine queue wait
    "prefill_device_ms_cold",
    "prefill_device_ms_warm",
    "prefill_tokens",
    "prefill_tokens_avoided",  # prefix-cache shared tokens (docqa-prefix)
    "decode_device_ms",
    "decode_tokens",
    "retrieve_device_ms",
    "other_device_ms",        # traced spine items outside the buckets
    "flops_est",              # observatory cost-model attribution
    "kv_block_seconds",       # paged-KV time integral (engines/paged.py)
    # block-seconds a QoS preemption threw away (docqa-qos): the
    # victim's holding up to eviction, ALSO billed under
    # kv_block_seconds (the identity stays exact) — this line names
    # the waste so operators can price the policy
    "preempted_block_seconds",
)

# fields whose per-class cumulative sums ride the metrics registry as
# counters (bounded: len(classes) x len(this)); the rest stay
# snapshot-only detail
_COUNTER_FIELDS = (
    "queue_wait_ms",
    "prefill_device_ms_cold",
    "prefill_device_ms_warm",
    "prefill_tokens_avoided",
    "decode_device_ms",
    "decode_tokens",
    "retrieve_device_ms",
    "kv_block_seconds",
    "flops_est",
    "preempted_block_seconds",  # mints cost_preempted_block_seconds_<cls>
)

_DEVICE_FIELDS = (
    "prefill_device_ms_cold",
    "prefill_device_ms_warm",
    "decode_device_ms",
    "retrieve_device_ms",
    "other_device_ms",
)

SHED_OUTCOMES = frozenset(
    {
        "shed_deadline", "shed_queue", "shed_block_pool", "shed_spine",
        # QoS batch deferral (serve.DeferredByPolicy, docqa-qos): a
        # policy choice, not a capacity shed — kept distinguishable so
        # "how much batch did self-protection turn away" is a ledger
        # query, not a log grep
        "shed_deferred",
    }
)


def normalize_class(cls: Optional[str]) -> str:
    return cls if cls in REQUEST_CLASSES else OTHER_CLASS


_REGISTRY_CACHE: Any = None


def _default_registry():
    """Lazy metrics-registry resolution (keeps this module's import
    stdlib-only, the obs discipline)."""
    global _REGISTRY_CACHE
    if _REGISTRY_CACHE is None:
        try:
            from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

            _REGISTRY_CACHE = DEFAULT_REGISTRY
        except Exception:  # pragma: no cover - import cycle safety net
            _REGISTRY_CACHE = False
    return _REGISTRY_CACHE or None


class CostRecord:
    """One request's cost vector.  Thread-safe: the batcher worker, the
    spine accounting hook, and waiter threads all add to it; adds after
    retirement forward to the ledger's aggregates (late-add) so a
    teardown sweep billing KV block-seconds after a typed failure still
    lands exactly once."""

    __slots__ = (
        "cls", "session", "trace", "t_open", "outcome", "f",
        "_lock", "_retired", "_ledger",
    )

    def __init__(
        self,
        ledger: "RequestCostLedger",
        cls: str,
        session: Optional[str] = None,
        trace: Any = None,
    ) -> None:
        self._ledger = ledger
        self.cls = normalize_class(cls)
        self.session = session
        self.trace = trace
        self.t_open = time.monotonic()
        self.outcome: Optional[str] = None
        self.f: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._retired = False

    # ---- accumulation --------------------------------------------------------

    def add(self, field: str, value: float) -> None:
        if not value:
            return
        with self._lock:
            if self._retired:
                late = True
            else:
                late = False
                self.f[field] = self.f.get(field, 0.0) + float(value)
        if late:
            self._ledger._fold(
                self.cls, self.session, {field: float(value)}
            )

    def set_session(self, session: Optional[str]) -> None:
        if session and self.session is None:
            self.session = session

    def account_dispatch(
        self, stage: str, queue_wait_s: float, device_s: float
    ) -> None:
        """Spine hook (engines/spine.py): a work item submitted UNDER
        this request's trace completed.  Worker-side serve items carry
        no trace and are attributed explicitly by the batcher — so this
        path covers the submitter-side stages (retrieval, store search,
        solo generate) with no double count."""
        self.add("spine_queue_wait_ms", queue_wait_s * 1e3)
        if stage.startswith(("retrieve", "store_search", "fused")):
            self.add("retrieve_device_ms", device_s * 1e3)
        else:
            self.add("other_device_ms", device_s * 1e3)

    def _finalize(self, outcome: str) -> Optional[Dict[str, float]]:
        """Retirement CAS: first caller wins and gets the field
        snapshot to fold; every later caller gets None.  The one place
        ``_retired`` flips — the ledger never touches this record's
        guarded state directly."""
        with self._lock:
            if self._retired:
                return None
            self._retired = True
            self.outcome = outcome
            return dict(self.f)

    # ---- views ---------------------------------------------------------------

    @property
    def retired(self) -> bool:
        with self._lock:
            return self._retired

    def device_ms_total(self) -> float:
        with self._lock:
            return sum(self.f.get(k, 0.0) for k in _DEVICE_FIELDS)

    def snapshot_fields(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.f)

    def summary(self) -> Dict[str, Any]:
        """Compact cost summary (attached to the trace at retirement —
        exported on the timeline and the Chrome trace)."""
        with self._lock:
            f = dict(self.f)
            outcome = self.outcome
        out: Dict[str, Any] = {
            "class": self.cls,
            "outcome": outcome,
            "device_ms": round(
                sum(f.get(k, 0.0) for k in _DEVICE_FIELDS), 3
            ),
        }
        if self.session:
            out["session"] = self.session
        for k, v in sorted(f.items()):
            out[k] = round(v, 3)
        return out


class RequestCostLedger:
    """Bounded per-class (and top-K per-session) cost aggregation plus
    the shed-forensics ring.  One per process (:data:`DEFAULT_COST_
    LEDGER`); the serving plane wires the pressure probe and reads
    :meth:`snapshot`."""

    def __init__(
        self,
        registry: Any = None,
        max_sessions: int = 64,
        shed_ring: int = 64,
    ) -> None:
        self._registry = registry
        self.max_sessions = int(max_sessions)
        self._lock = threading.Lock()
        self._enabled = True
        # cls -> {field: cumulative, "requests": n, outcomes...}
        self._classes: Dict[str, Dict[str, float]] = {}
        self._outcomes: Dict[str, Dict[str, int]] = {}
        # session -> {"cls", "requests", "device_ms", "kv_block_seconds"}
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._sheds: collections.deque = collections.deque(
            maxlen=max(1, int(shed_ring))
        )
        self._shed_counts: Dict[str, int] = {}
        self._retired_total = 0
        self._pressure_probe: Optional[Callable[[], Dict[str, Any]]] = None

    # ---- wiring --------------------------------------------------------------

    def set_enabled(self, value: bool) -> None:
        """The cost-overhead A/B's switch: disabled, :meth:`open`
        returns None and every call site's ``is not None`` guard makes
        accounting cost one attribute read."""
        self._enabled = bool(value)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_pressure_probe(
        self, probe: Optional[Callable[[], Dict[str, Any]]]
    ) -> None:
        """Register the closure :meth:`record_shed` snapshots — the
        runtime wires one over the batcher/pool + spine.  Must be cheap
        and lock-light: it runs on the shedding thread."""
        self._pressure_probe = probe

    def registry(self):
        return self._registry if self._registry is not None else (
            _default_registry()
        )

    # ---- record lifecycle ----------------------------------------------------

    def open(
        self,
        cls: str,
        session: Optional[str] = None,
        trace: Any = None,
    ) -> Optional[CostRecord]:
        """Mint a record (None when the ledger is disabled).  When a
        ``trace`` is given the record is attached as
        ``trace.cost_record`` — the spine's accounting hook and the
        batcher's ``make_request`` both find it there, which is how one
        HTTP request's retrieval, prefill, decode, and KV holdings land
        on ONE record."""
        if not self._enabled:
            return None
        rec = CostRecord(self, cls, session=session, trace=trace)
        if trace is not None:
            trace.cost_record = rec
        return rec

    def retire(self, rec: Optional[CostRecord], outcome: str = "ok") -> bool:
        """Fold a record into the aggregates — exactly once (the first
        caller wins; False = already retired).  ``outcome`` is ``ok``, a
        ``shed_*`` kind, ``cancelled``, ``failed_replica``, or
        ``error``."""
        if rec is None:
            return False
        fields = rec._finalize(outcome)
        if fields is None:
            return False
        self._fold(rec.cls, rec.session, fields, outcome=outcome)
        if rec.trace is not None:
            try:
                rec.trace.cost_summary = rec.summary()
            except Exception:  # a finished/foreign trace must never fail this
                pass
        return True

    def _fold(
        self,
        cls: str,
        session: Optional[str],
        fields: Dict[str, float],
        outcome: Optional[str] = None,
    ) -> None:
        dev_ms = sum(fields.get(k, 0.0) for k in _DEVICE_FIELDS)
        with self._lock:
            row = self._classes.setdefault(cls, {})
            for k, v in fields.items():
                row[k] = row.get(k, 0.0) + v
            row["device_ms"] = row.get("device_ms", 0.0) + dev_ms
            if outcome is not None:
                row["requests"] = row.get("requests", 0.0) + 1
                oc = self._outcomes.setdefault(cls, {})
                oc[outcome] = oc.get(outcome, 0) + 1
                self._retired_total += 1
            if session:
                srow = self._sessions.get(session)
                if srow is None:
                    if len(self._sessions) >= self.max_sessions:
                        # bounded: evict the smallest spender (a table of
                        # top-K by construction, never a cardinality leak)
                        victim = min(
                            self._sessions,
                            key=lambda s: self._sessions[s]["device_ms"],
                        )
                        del self._sessions[victim]
                    srow = self._sessions[session] = {
                        "cls": cls, "requests": 0, "device_ms": 0.0,
                        "kv_block_seconds": 0.0,
                    }
                if outcome is not None:
                    srow["requests"] += 1
                srow["device_ms"] += dev_ms
                srow["kv_block_seconds"] += fields.get(
                    "kv_block_seconds", 0.0
                )
        reg = self.registry()
        if reg is not None:
            try:
                if outcome is not None:
                    # shed counting lives in record_shed (one bump per
                    # shed EVENT incl. spine saturation, which never
                    # retires through a typed serve outcome) — bumping
                    # here too would double-count every typed shed
                    reg.counter(f"cost_requests_{cls}").inc()
                if dev_ms:
                    reg.counter(f"cost_device_ms_{cls}").inc(dev_ms)
                for k in _COUNTER_FIELDS:
                    v = fields.get(k, 0.0)
                    if v:
                        reg.counter(f"cost_{k}_{cls}").inc(v)
            except Exception:  # metrics must never fail accounting
                pass

    # ---- shed forensics ------------------------------------------------------

    def record_shed(
        self, kind: str, cls: Optional[str] = None, **attrs: Any
    ) -> Optional[Dict[str, Any]]:
        """Capture one shed's pressure snapshot into the bounded ring
        (:meth:`sheds`): the shed kind, the shed REQUEST's class,
        and — via the registered probe — which classes held how many KV
        blocks, decode lanes, and queue slots at that instant.  Fenced
        and cheap; returns the snapshot (tests read it back)."""
        if not self._enabled:
            return None
        snap: Dict[str, Any] = {
            "t_unix": time.time(),
            "kind": kind,
            "class": normalize_class(cls) if cls is not None else None,
        }
        if attrs:
            snap.update(attrs)
        probe = self._pressure_probe
        if probe is not None:
            try:
                pressure = probe() or {}
                snap["pressure"] = pressure
                by_class = pressure.get("by_class") or {}
                if by_class:
                    majority = max(
                        by_class,
                        key=lambda c: by_class[c].get("kv_blocks", 0),
                    )
                    if by_class[majority].get("kv_blocks", 0) > 0:
                        snap["majority_block_class"] = majority
            except Exception:
                snap["pressure_error"] = True
        with self._lock:
            self._sheds.append(snap)
            self._shed_counts[kind] = self._shed_counts.get(kind, 0) + 1
        reg = self.registry()
        if reg is not None:
            try:
                reg.counter("cost_shed_snapshots").inc()
                if cls is not None:
                    # per-class shed series (the runbook's trend input):
                    # one bump per shed EVENT, the single count source
                    reg.counter(
                        f"cost_sheds_{normalize_class(cls)}"
                    ).inc()
            except Exception:
                pass
        return snap

    def sheds(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last ring contents; ``n`` bounds to the most recent n
        (None = all, <= 0 = none — never the slicing surprise where
        ``[-0:]`` would return everything)."""
        with self._lock:
            out = list(self._sheds)
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    # ---- surfaces ------------------------------------------------------------

    def class_totals(self) -> Dict[str, Dict[str, float]]:
        """Deep-copied per-class cumulative sums (measurement windows
        difference two of these)."""
        with self._lock:
            return {c: dict(row) for c, row in self._classes.items()}

    def top_sessions(self, k: int = 10) -> List[Dict[str, Any]]:
        with self._lock:
            rows = [
                {"session": s, **row} for s, row in self._sessions.items()
            ]
        rows.sort(key=lambda r: -r["device_ms"])
        for r in rows:
            r["device_ms"] = round(r["device_ms"], 3)
            r["kv_block_seconds"] = round(r["kv_block_seconds"], 6)
        return rows[:k]

    def snapshot(
        self,
        spine_device_s: Optional[float] = None,
        pool_block_seconds: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The ledger's snapshot: per-class breakdown, top
        spenders, and each class's share of measured device time
        (vs the spine's total, the cross-check ``chip_smoke.py`` asserts) and
        of the KV pool's block-seconds."""
        with self._lock:
            classes = {c: dict(row) for c, row in self._classes.items()}
            outcomes = {c: dict(o) for c, o in self._outcomes.items()}
            shed_counts = dict(self._shed_counts)
            n_sheds = len(self._sheds)
            retired = self._retired_total
        total_dev_ms = sum(r.get("device_ms", 0.0) for r in classes.values())
        total_kv = sum(
            r.get("kv_block_seconds", 0.0) for r in classes.values()
        )
        out_classes: Dict[str, Any] = {}
        for c, row in sorted(classes.items()):
            entry = {k: round(v, 3) for k, v in sorted(row.items())}
            entry["outcomes"] = outcomes.get(c, {})
            dev = row.get("device_ms", 0.0)
            entry["share_of_attributed_device"] = (
                round(dev / total_dev_ms, 4) if total_dev_ms else None
            )
            if spine_device_s:
                entry["share_of_spine_device"] = round(
                    (dev / 1e3) / spine_device_s, 4
                )
            kv = row.get("kv_block_seconds", 0.0)
            entry["share_of_kv_block_seconds"] = (
                round(kv / total_kv, 4) if total_kv else None
            )
            if pool_block_seconds:
                entry["share_of_kv_pool"] = round(
                    kv / pool_block_seconds, 4
                )
            out_classes[c] = entry
        return {
            "enabled": self._enabled,
            "classes": out_classes,
            "requests_retired": retired,
            "attributed_device_ms": round(total_dev_ms, 3),
            "spine_device_ms": (
                round(spine_device_s * 1e3, 3)
                if spine_device_s is not None
                else None
            ),
            "attributed_device_coverage": (
                round((total_dev_ms / 1e3) / spine_device_s, 4)
                if spine_device_s
                else None
            ),
            "kv_block_seconds_total": round(total_kv, 6),
            "pool_block_seconds": (
                round(pool_block_seconds, 6)
                if pool_block_seconds is not None
                else None
            ),
            "top_sessions": self.top_sessions(),
            "sheds": {"recorded": n_sheds, "by_kind": shed_counts},
        }

    def telemetry_gauges(self) -> Dict[str, float]:
        """Bounded live gauges for the telemetry sampler's extra-probe
        hook (the per-class counters ride the registry scrape)."""
        with self._lock:
            n_sessions = len(self._sessions)
            top = max(
                (r["device_ms"] for r in self._sessions.values()),
                default=0.0,
            )
            n_sheds = len(self._sheds)
        return {
            "cost_sessions_tracked": float(n_sessions),
            "cost_top_session_device_ms": round(top, 3),
            "cost_shed_ring_depth": float(n_sheds),
        }

    def reset(self) -> None:
        """Zero the aggregates (measurement windows).  Open
        records keep working — their retire/late-adds fold into the
        fresh sums."""
        with self._lock:
            self._classes.clear()
            self._outcomes.clear()
            self._sessions.clear()
            self._sheds.clear()
            self._shed_counts.clear()
            self._retired_total = 0


DEFAULT_COST_LEDGER = RequestCostLedger()


def cost_record_of(trace: Any) -> Optional[CostRecord]:
    """The record attached to a trace, if any (duck-typed: traces are
    plain objects; absent attribute = unattributed)."""
    if trace is None:
        return None
    return getattr(trace, "cost_record", None)


def cost_open(ctx: Any, cls: str) -> Optional[CostRecord]:
    """Endpoint idiom: attach a class-stamped record to
    a just-opened trace context.  No-ops (None) when tracing is off or
    the ledger is disabled; reuses an already-attached record rather
    than double-opening."""
    if ctx is None:
        return None
    existing = cost_record_of(ctx.trace)
    if existing is not None:
        return existing
    return DEFAULT_COST_LEDGER.open(cls, trace=ctx.trace)
