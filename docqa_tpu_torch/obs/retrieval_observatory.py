"""Online retrieval-quality estimation for the tiered index, counterpart of
``docqa_tpu/obs/retrieval_observatory.py``.

* **shadow sampling**: one in ``sample_every`` tiered retrievals (a seeded,
  deterministic slot in each window of that many, so a replayed workload
  samples the same requests) gets an exact-scan shadow query, run on the
  dispatch spine's background ``probe`` stream under its own
  ``retrieve_shadow`` stage;
* **online recall@k**: shadow top-k against served top-k under the tie
  rule (a served row scoring at least the shadow's k-th score, within
  ``_TIE_EPS``, is a hit), folded into bounded windows per (tier, nprobe)
  with Wilson intervals;
* **drift digests**: served score margins and query norms feed the
  ``retrieve_score_margin`` / ``retrieve_query_norm`` histograms;
* **the measured nprobe frontier**: every ``frontier_every``-th sampled
  shadow re-probes the IVF tier at neighbouring nprobe values, giving an
  observed recall / latency curve and the smallest nprobe that meets
  ``recall_target``; ``auto_apply`` applies it through a callback the
  runtime wires to ``TieredIndex.set_nprobe``;
* **the recall SLO**: per-comparison ``retrieve_shadow_expected`` /
  ``retrieve_shadow_missed`` counters, which ``obs/slo.py``'s
  ``default_retrieval_slos`` burns like availability.

Stdlib only, like the rest of ``obs/``: the device work lives in closures
the call sites build (``index/tiered.py``, ``engines/retrieve.py``) over
their own snapshotted state, and the worker thread only runs them.

PHI: everything stored, exported or logged holds row ids, scores,
latencies and norms, never text; a queued :class:`ShadowJob` holds query
embeddings and a salted content hash, never the query's text.

Failure policy differs from the reference's in one place: the reference's
worker counts every failing shadow as an error and carries on.  Here a
kernel or CUDA fault (``ops/_kernels.is_device_fault``) stops the worker;
it is kept as :attr:`RetrievalObservatory.device_fault` and raised by
:meth:`RetrievalObservatory.stop` and :meth:`RetrievalObservatory.drain`.
Other failures count as ``retrieve_shadow_errors``, as in the reference.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("docqa.recallscope")

# the telemetry digests' deterministic multiplicative hash: no RNG state
_HASH_MULT = 2654435761
_SEED_MULT = 40503
_TIE_EPS = 1e-6


def _is_device_fault(exc: BaseException) -> bool:
    """``ops/_kernels.is_device_fault``, imported when first needed (this
    package stays stdlib-only at import)."""
    from docqa_tpu_torch.ops._kernels import is_device_fault

    return is_device_fault(exc)


def wilson_interval(hits: int, total: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval ``(lo, hi)`` of a binomial proportion;
    ``(0.0, 1.0)`` with no evidence.  The edges are pinned at p = 0 and
    p = 1, where they are exact."""
    if total <= 0:
        return 0.0, 1.0
    p = hits / total
    z2 = z * z
    denom = 1.0 + z2 / total
    center = (p + z2 / (2.0 * total)) / denom
    spread = (
        z * math.sqrt(p * (1.0 - p) / total + z2 / (4.0 * total * total)) / denom
    )
    lo = max(0.0, center - spread)
    hi = min(1.0, center + spread)
    if hits >= total:
        hi = 1.0
    if hits <= 0:
        lo = 0.0
    return lo, hi


def compare_topk(
    served: Sequence[Tuple[int, float]],
    shadow: Sequence[Tuple[int, float]],
    k: int,
) -> Tuple[int, int]:
    """(hits, expected) for one query's served against exact top-k.

    ``expected`` is ``min(k, len(shadow))``.  A served row is a hit when
    its id is in the shadow's top list, or when its score reaches the
    shadow's k-th score within ``_TIE_EPS``: under equal scores exact
    top-k picks an arbitrary representative."""
    expected = min(k, len(shadow))
    if expected == 0:
        return 0, 0
    shadow_ids = {int(rid) for rid, _ in shadow[:expected]}
    kth = min(float(s) for _, s in shadow[:expected])
    hits = 0
    for rid, score in served[:expected]:
        if int(rid) in shadow_ids or float(score) >= kth - _TIE_EPS:
            hits += 1
    return min(hits, expected), expected


class _EstimateWindow:
    """Bounded window of per-query (hits, expected) pairs; the estimate is
    their ratio over the window with a Wilson interval."""

    def __init__(self, window: int = 512) -> None:
        self._pairs: collections.deque = collections.deque(maxlen=window)

    def add(self, hits: int, expected: int) -> None:
        if expected > 0:
            self._pairs.append((int(hits), int(expected)))

    def estimate(self) -> Optional[Dict[str, Any]]:
        if not self._pairs:
            return None
        hits = sum(h for h, _ in self._pairs)
        total = sum(e for _, e in self._pairs)
        lo, hi = wilson_interval(hits, total)
        return {
            "recall": round(hits / total, 4) if total else None,
            "ci_lo": round(lo, 4),
            "ci_hi": round(hi, 4),
            "hits": hits,
            "expected": total,
            "comparisons": len(self._pairs),
        }


@dataclass
class ShadowJob:
    """One sampled retrieval, queued for the worker.

    ``served``: per query a list of (row_id, score).  ``shadow_fn()``
    returns ``(shadow_rows, queries_or_None)``: the exact ground truth and
    the query embeddings the frontier probes reuse.  ``frontier_fn(queries,
    nprobe)`` returns ``(rows, seconds)`` or ``(rows, seconds,
    fresh_compile)`` for one neighbour probe.  Both run on the worker
    only."""

    tier: str
    nprobe: int
    k: int
    served: List[List[Tuple[int, float]]]
    shadow_fn: Callable[[], Tuple[List[List[Tuple[int, float]]], Any]]
    frontier_fn: Optional[Callable[[Any, int], tuple]] = None
    covered: Optional[int] = None
    n_clusters: Optional[int] = None
    query_norms: Optional[List[float]] = None
    served_margins: Optional[List[float]] = None
    seq: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)


class RetrievalObservatory:
    """Shadow-sampling online recall estimator and nprobe frontier.

    Serving threads call :meth:`sample` (a counter bump and one hash) and,
    when it says so, :meth:`submit` (a bounded enqueue); one worker thread
    does every comparison, estimate and frontier probe.  State is guarded
    by ``_lock``; :meth:`stop` joins the worker."""

    def __init__(
        self,
        sample_every: int = 32,
        seed: int = 0,
        window: int = 512,
        max_pending: int = 8,
        frontier_every: int = 4,
        frontier_factors: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0),
        min_frontier_n: int = 5,
        recall_target: float = 0.95,
        auto_apply: bool = False,
        apply_nprobe: Optional[Callable[[int], Any]] = None,
        registry=None,  # runtime.metrics.MetricsRegistry (duck-typed)
    ) -> None:
        self.sample_every = max(1, int(sample_every))
        self.seed = int(seed)
        self.window = int(window)
        self.max_pending = max(1, int(max_pending))
        # 0 disables frontier probing
        self.frontier_every = max(0, int(frontier_every))
        self.frontier_factors = tuple(frontier_factors)
        self.min_frontier_n = int(min_frontier_n)
        self.recall_target = float(recall_target)
        self.auto_apply = bool(auto_apply)
        self.apply_nprobe = apply_nprobe
        self.registry = registry
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._seq = 0  # retrieval sequence number (the sampler's input)
        self._n_sampled = 0
        self._n_dropped = 0
        self._n_errors = 0
        self._n_shadows = 0
        # (tier, nprobe) -> window; _current_key is what the gauges report
        self._windows: Dict[Tuple[str, int], _EstimateWindow] = {}
        self._current_key: Optional[Tuple[str, int]] = None
        # nprobe -> {"window", "lat_ms", "compiled"}, valid for one tier
        # build signature (n_clusters, covered): a rebuild reclusters
        self._frontier: Dict[int, Dict[str, Any]] = {}
        self._frontier_sig: Optional[Tuple[Any, Any]] = None
        self._applied_nprobe: Optional[int] = None
        self._busy = False
        # the kernel or CUDA fault the worker stopped on, if any
        self.device_fault: Optional[BaseException] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle -----------------------------------------------------------

    def start(self) -> "RetrievalObservatory":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="recallscope"
        )
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        """Idempotent; joins the worker, then raises the device fault it
        stopped on, if any."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                log.warning("recallscope worker still alive after stop()")
            else:
                self._thread = None
        self._raise_fault()

    def _raise_fault(self) -> None:
        fault = self.device_fault
        if fault is not None:
            raise fault

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ---- sampling (serving threads) ------------------------------------------

    def _sampled(self, seq: int) -> bool:
        """Exactly one sample in every window of ``sample_every``
        consecutive retrievals, at a slot hashed from (seed, window)."""
        win, offset = divmod(seq, self.sample_every)
        h = ((win + 1) * _HASH_MULT + self.seed * _SEED_MULT) & 0xFFFFFFFF
        return offset == h % self.sample_every

    def sample(self) -> bool:
        """Called once per tiered retrieval: counts it and says whether to
        build a shadow job.  Never samples while the worker is not
        running."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        self._count("retrieve_served_total")
        if not self.running:
            return False
        return self._sampled(seq)

    def submit(self, job: ShadowJob) -> bool:
        """Bounded enqueue; False (and a counted drop) when the worker is
        behind."""
        with self._lock:
            job.seq = self._n_sampled
            self._n_sampled += 1
            if len(self._pending) >= self.max_pending:
                self._n_dropped += 1
                dropped = True
            else:
                self._pending.append(job)
                dropped = False
        if dropped:
            self._count("retrieve_shadow_dropped")
            return False
        self._wake.set()
        return True

    # ---- worker --------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                job = self._pending.popleft() if self._pending else None
                self._busy = job is not None
            if job is None:
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            try:
                self._process(job)
            except Exception as e:
                if _is_device_fault(e):
                    # the context is poisoned: stop, keep it for stop/drain
                    self.device_fault = e
                    log.error("recallscope stopped on a device fault: %r", e)
                    return
                with self._lock:
                    self._n_errors += 1
                self._count("retrieve_shadow_errors")
                log.exception("shadow job failed (tier=%s)", job.tier)
            finally:
                with self._lock:
                    self._busy = False

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until the queue is empty and the worker idle; False on
        timeout.  Raises the device fault the worker stopped on."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._raise_fault()
            with self._lock:
                idle = not self._pending and not self._busy
            if idle:
                return True
            self._wake.set()
            time.sleep(0.02)
        self._raise_fault()
        return False

    def _process(self, job: ShadowJob) -> None:
        shadow_rows, queries = job.shadow_fn()
        key = (job.tier, int(job.nprobe))
        hits_total = expected_total = 0
        recalls: List[float] = []
        pairs: List[Tuple[int, int]] = []
        for qi, served_row in enumerate(job.served):
            shadow_row = shadow_rows[qi] if qi < len(shadow_rows) else []
            hits, expected = compare_topk(served_row, shadow_row, job.k)
            hits_total += hits
            expected_total += expected
            if expected:
                recalls.append(hits / expected)
                pairs.append((hits, expected))
        with self._lock:
            self._n_shadows += 1
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = _EstimateWindow(self.window)
            for h, e in pairs:
                win.add(h, e)
            self._current_key = key
        self._count("retrieve_shadow_total")
        self._count("retrieve_shadow_expected", expected_total)
        self._count("retrieve_shadow_missed", expected_total - hits_total)
        reg = self.registry
        if reg is not None:
            for r in recalls:
                reg.histogram("retrieve_recall").observe(r)
            for m in job.served_margins or ():
                reg.histogram("retrieve_score_margin").observe(float(m))
            for n in job.query_norms or ():
                reg.histogram("retrieve_query_norm").observe(float(n))
        if (
            job.frontier_fn is not None
            and queries is not None
            and self.frontier_every > 0
            and job.seq % self.frontier_every == 0
        ):
            self._probe_frontier(job, shadow_rows, queries)

    # ---- frontier ------------------------------------------------------------

    def frontier_candidates(self, nprobe: int, n_clusters: Optional[int]) -> List[int]:
        cap = int(n_clusters) if n_clusters else max(1, nprobe)
        return sorted(
            {min(cap, max(1, int(round(nprobe * f)))) for f in self.frontier_factors}
        )

    def _probe_frontier(self, job: ShadowJob, shadow_rows, queries) -> None:
        """Re-probe the bulk tier at neighbouring nprobe values against the
        shadow's bulk ground truth (ids below the tier's watermark: the
        tail is exact at every nprobe)."""
        covered = job.covered
        sig = (job.n_clusters, job.covered)
        with self._lock:
            if self._frontier_sig != sig:
                if self._frontier:
                    log.info(
                        "recallscope: tier rebuilt (%s -> %s); frontier "
                        "evidence reset", self._frontier_sig, sig,
                    )
                self._frontier.clear()
                self._frontier_sig = sig
        bulk_truth: List[List[Tuple[int, float]]] = []
        for row in shadow_rows:
            if covered is None:
                bulk_truth.append(list(row))
            else:
                bulk_truth.append([(rid, s) for rid, s in row if int(rid) < covered])
        for p in self.frontier_candidates(job.nprobe, job.n_clusters):
            try:
                res = job.frontier_fn(queries, p)
            except Exception as e:
                if _is_device_fault(e):
                    raise
                self._count("retrieve_shadow_errors")
                log.exception("frontier probe failed at nprobe=%d", p)
                continue
            if len(res) == 3:
                rows, seconds, fresh = res
            else:
                rows, seconds = res
                fresh = None
            probe_pairs: List[Tuple[int, int]] = []
            for qi, truth in enumerate(bulk_truth):
                served = rows[qi] if qi < len(rows) else []
                h, e = compare_topk(served, truth, job.k)
                if e:
                    probe_pairs.append((h, e))
            with self._lock:
                entry = self._frontier.get(p)
                if entry is None:
                    entry = self._frontier[p] = {
                        "window": _EstimateWindow(self.window),
                        "lat_ms": collections.deque(maxlen=64),
                        "compiled": False,
                    }
                for h, e in probe_pairs:
                    entry["window"].add(h, e)
                if fresh is not None:
                    # the probe says whether this sample paid a first call
                    # at its shape: such samples stay off the latency axis
                    if not fresh:
                        entry["lat_ms"].append(seconds * 1e3)
                elif entry["compiled"]:
                    entry["lat_ms"].append(seconds * 1e3)
                else:
                    entry["compiled"] = True
        self._maybe_auto_apply(job.nprobe)

    def recommended_nprobe(self) -> Optional[int]:
        """Smallest frontier nprobe whose estimate meets the target over at
        least ``min_frontier_n`` comparisons; None until one does."""
        with self._lock:
            rows = [
                (p, e["window"].estimate()) for p, e in sorted(self._frontier.items())
            ]
        qualified = [
            p
            for p, est in rows
            if est is not None
            and est["comparisons"] >= self.min_frontier_n
            and est["recall"] is not None
            and est["recall"] >= self.recall_target
        ]
        return min(qualified) if qualified else None

    def _maybe_auto_apply(self, current_nprobe: int) -> None:
        if not self.auto_apply or self.apply_nprobe is None:
            return
        rec = self.recommended_nprobe()
        with self._lock:
            already = self._applied_nprobe
        if rec is None or rec == current_nprobe or rec == already:
            return
        try:
            self.apply_nprobe(rec)
        except Exception as e:
            if _is_device_fault(e):
                raise
            log.exception("auto-apply of nprobe=%d failed", rec)
            return
        with self._lock:
            self._applied_nprobe = rec
        self._count("retrieve_nprobe_autoapplied")
        log.warning(
            "recallscope auto-applied nprobe %d -> %d (measured frontier "
            "meets recall target %.3f)",
            current_nprobe, rec, self.recall_target,
        )

    # ---- surfaces ------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self.registry is not None and n:
            self.registry.counter(name).inc(n)

    def _estimates_locked(self) -> Dict[str, Any]:
        out = {}
        for (tier, nprobe), win in sorted(self._windows.items()):
            est = win.estimate()
            if est is not None:
                out[f"{tier}@nprobe={nprobe}"] = est
        return out

    def status(self) -> Dict[str, Any]:
        """The ``/api/retrieval`` payload: estimates, drift digests, the
        observed frontier and the recommendation."""
        with self._lock:
            current = self._current_key
            cur_est = self._windows[current].estimate() if current else None
            estimates = self._estimates_locked()
            frontier_rows = []
            for p, entry in sorted(self._frontier.items()):
                est = entry["window"].estimate()
                if est is None:
                    continue
                lats = sorted(entry["lat_ms"])
                frontier_rows.append(
                    {
                        "nprobe": p,
                        "recall": est["recall"],
                        "ci_lo": est["ci_lo"],
                        "ci_hi": est["ci_hi"],
                        "comparisons": est["comparisons"],
                        # the bulk probe's latency, first calls excluded
                        "probe_ms_p50": (
                            round(lats[len(lats) // 2], 3) if lats else None
                        ),
                    }
                )
            counts = {
                "served": self._seq,
                "sampled": self._n_sampled,
                "shadows": self._n_shadows,
                "dropped": self._n_dropped,
                "errors": self._n_errors,
                "pending": len(self._pending),
            }
            applied = self._applied_nprobe
        drift = {}
        if self.registry is not None:
            for name in (
                "retrieve_score_margin",
                "retrieve_query_norm",
                "retrieve_tier_ms_bulk_ivf",
                "retrieve_tier_ms_tail_exact",
                "retrieve_tier_ms_merge",
                "retrieve_tier_ms_fused_probe",
            ):
                s = self.registry.histogram(name).summary()
                if s.get("count"):
                    drift[name] = {k: s.get(k) for k in ("count", "p50", "p95")}
        return {
            "enabled": True,
            "running": self.running,
            "sample_every": self.sample_every,
            "seed": self.seed,
            "recall_target": self.recall_target,
            "counts": counts,
            "estimate": cur_est,
            "current": (
                {"tier": current[0], "nprobe": current[1]} if current else None
            ),
            "estimates": estimates,
            "frontier": frontier_rows,
            "recommended_nprobe": self.recommended_nprobe(),
            "auto_apply": self.auto_apply,
            "applied_nprobe": applied,
            "drift": drift,
        }

    def telemetry_gauges(self) -> Dict[str, float]:
        """Gauges for the telemetry sampler (``retrieve_recall_*``)."""
        with self._lock:
            current = self._current_key
            est = self._windows[current].estimate() if current else None
            pending = float(len(self._pending))
            nprobe = float(current[1]) if current else 0.0
        out = {
            "retrieve_shadow_pending": pending,
            "retrieve_sample_every": float(self.sample_every),
        }
        if est is not None:
            out["retrieve_recall_estimate"] = float(est["recall"])
            out["retrieve_recall_ci_lo"] = float(est["ci_lo"])
            out["retrieve_recall_ci_hi"] = float(est["ci_hi"])
            out["retrieve_recall_window_n"] = float(est["comparisons"])
            out["retrieve_nprobe_current"] = nprobe
        rec = self.recommended_nprobe()
        if rec is not None:
            out["retrieve_nprobe_recommended"] = float(rec)
        return out


# ---- the process observatory (the serving hooks' lookup point) ---------------

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[RetrievalObservatory] = None


def get_retrieval_observatory() -> Optional[RetrievalObservatory]:
    """The process observatory, or None when none is installed (the hooks
    then do nothing)."""
    return _GLOBAL


def set_retrieval_observatory(
    observatory: Optional[RetrievalObservatory],
) -> Optional[RetrievalObservatory]:
    """Install the process observatory; returns the previous one, which
    the caller owns."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, observatory
        return prev
