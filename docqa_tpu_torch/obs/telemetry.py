"""Fixed-interval time-series rollups of the serving plane, counterpart of
``docqa_tpu/obs/telemetry.py``.

* :class:`WindowedDigest`: per-histogram rollups.  Samples fall into fixed
  ``interval_s`` windows; each sealed window keeps a digest (count, sum,
  p50/p95/p99, max, over-threshold counts for SLO math) and recent windows
  keep their samples, so "p95 now" merges the last few minutes.
* :class:`TelemetryStore`: named counter, gauge and digest series over one
  window clock, pruned to a bounded ring (default 10 s x 360 points),
  rendered as JSON and Prometheus text by ``obs/expo.py``.
* :class:`TelemetrySampler`: a background thread that scrapes the serving
  plane into the store each tick (registry instruments, pool replica health
  and breaker states, queue depths, KV block occupancy, broker depths, the
  flight recorder, the dispatch spine, the engine's device memory) and
  drives the SLO burn-rate evaluator (``obs/slo.py``) once per tick.

Two probes differ from the reference, whose engine compiles programs:
``jit_decode_cache_programs`` (a jit cache size) is dropped, because the
port compiles nothing; the ``hbm_decode_*`` gauges (a compiled program's
``memory_analysis``) become ``device_mem_*`` gauges read from
``torch.cuda.memory_stats`` of the engine's device.  The retrieval
observatory's probe comes with that observatory (the tiered and IVF search
it shadows are not ported yet).

Every probe is fenced so a dying replica never kills the sampler, except
for a kernel or CUDA fault (``ops/_kernels.is_device_fault``): it reaches
the caller of :meth:`TelemetrySampler.tick`, and the sampler thread stops
on it and keeps it as :attr:`TelemetrySampler.device_fault`.  Window
arithmetic runs on an injectable monotonic clock (``now_fn``), so tests step
time explicitly.  Series hold identifiers, counts and sizes only.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from docqa_tpu_torch.obs.spans import percentile_nearest_rank

log = logging.getLogger("docqa.telemetry")

# deterministic sample-slot hash for the per-window cap (Knuth
# multiplicative): no RNG, so replayed workloads digest identically
_HASH_MULT = 2654435761


class WindowedDigest:
    """Fixed-interval histogram rollups with bounded memory.

    Retention is two-tier: every sealed window keeps its digest for
    ``points`` windows; the most recent ``sample_windows`` of them also
    keep (sorted) samples so percentiles can be MERGED across windows —
    that merge is what ``Histogram.summary()`` reports as "now".  The
    last sealed digest is additionally kept forever as the stale-idle
    fallback, so a service quiet for an hour still reports its last
    known percentiles instead of NaN.
    """

    def __init__(
        self,
        interval_s: float = 10.0,
        points: int = 360,
        sample_windows: int = 18,
        max_samples_per_window: int = 2048,
        now_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.interval_s = float(interval_s)
        self.points = int(points)
        self.sample_windows = int(sample_windows)
        self.max_samples_per_window = int(max_samples_per_window)
        self._now = now_fn
        # wall anchor for export only, never for window math
        self._wall_offset = time.time() - now_fn()
        self._lock = threading.Lock()
        self._thresholds: List[float] = []
        # sealed windows, oldest first: list of digest dicts; entries
        # within sample_windows of the head also carry "_samples"
        self._sealed: List[Dict[str, Any]] = []
        self._last_digest: Optional[Dict[str, Any]] = None
        self._cur_widx: Optional[int] = None
        self._cur_samples: List[float] = []
        self._cur_count = 0
        self._cur_sum = 0.0
        # over-threshold counts kept at OBSERVE time, not derived from
        # the capped sample list: at 2× the per-window sample cap a
        # scan-at-seal would halve the SLO's bad fraction exactly when
        # the overload it guards against is happening
        self._cur_over: Dict[str, int] = {}

    # ---- window clock --------------------------------------------------------

    def _widx(self, now: Optional[float]) -> int:
        t = self._now() if now is None else now
        return int(t // self.interval_s)

    def window_wall_start(self, widx: int) -> float:
        return self._wall_offset + widx * self.interval_s

    def register_threshold(self, threshold_ms: float) -> None:
        """Record over-threshold counts per sealed window from now on —
        the SLO evaluator registers its latency objective here so burn
        rates read pre-counted good/bad events instead of re-scanning
        samples that may already have been dropped."""
        with self._lock:
            if threshold_ms not in self._thresholds:
                self._thresholds.append(threshold_ms)

    # ---- recording -----------------------------------------------------------

    def observe(self, value: float, now: Optional[float] = None) -> None:
        widx = self._widx(now)
        with self._lock:
            self._roll_locked(widx)
            self._cur_count += 1
            self._cur_sum += value
            for t in self._thresholds:
                if value > t:
                    key = _thr_key(t)
                    self._cur_over[key] = self._cur_over.get(key, 0) + 1
            n = self._cur_count
            cap = self.max_samples_per_window
            if len(self._cur_samples) < cap:
                self._cur_samples.append(value)
            else:
                # deterministic overwrite keeps the window's sample set
                # representative without RNG (replay-diffable, like
                # obs trace ids)
                self._cur_samples[(n * _HASH_MULT) % cap] = value

    def _seal_locked(self) -> None:
        """Digest the current window and push it onto the sealed ring."""
        if self._cur_widx is None:
            return
        samples = sorted(self._cur_samples)
        digest: Dict[str, Any] = {
            "widx": self._cur_widx,
            "t_unix": self.window_wall_start(self._cur_widx),
            "count": self._cur_count,
            "sum": self._cur_sum,
            "p50": percentile_nearest_rank(samples, 50),
            "p95": percentile_nearest_rank(samples, 95),
            "p99": percentile_nearest_rank(samples, 99),
            "max": samples[-1] if samples else 0.0,
        }
        if self._thresholds:
            # exact observe-time counts (the sample list is capped)
            digest["over"] = {
                _thr_key(t): self._cur_over.get(_thr_key(t), 0)
                for t in self._thresholds
            }
        digest["_samples"] = samples
        self._sealed.append(digest)
        self._last_digest = digest
        self._cur_samples = []
        self._cur_count = 0
        self._cur_sum = 0.0
        self._cur_over = {}

    def _roll_locked(self, widx: int) -> None:
        if self._cur_widx is None:
            self._cur_widx = widx
            return
        if widx == self._cur_widx:
            return
        if widx < self._cur_widx:
            # clock went backwards between caller's now and ours (racing
            # threads): attribute to the current window, never rewind
            return
        self._seal_locked()
        self._cur_widx = widx
        # prune: bounded digest ring, samples only on the recent tail
        if len(self._sealed) > self.points:
            del self._sealed[: len(self._sealed) - self.points]
        horizon = widx - self.sample_windows
        for d in self._sealed:
            if d["widx"] < horizon and "_samples" in d:
                del d["_samples"]

    def roll(self, now: Optional[float] = None) -> None:
        """Advance the window clock without a sample (sampler tick)."""
        with self._lock:
            self._roll_locked(self._widx(now))

    # ---- queries -------------------------------------------------------------

    def recent_percentiles(
        self, qs: Sequence[float] = (50, 95, 99), now: Optional[float] = None
    ) -> Optional[Dict[str, float]]:
        """Merged percentiles over the sample-retention horizon (current
        window included).  None when no samples are retained — callers
        fall back to :meth:`last_percentiles`."""
        widx = self._widx(now)
        with self._lock:
            self._roll_locked(widx)
            horizon = widx - self.sample_windows
            merged: List[float] = list(self._cur_samples)
            for d in self._sealed:
                if d["widx"] >= horizon and "_samples" in d:
                    merged.extend(d["_samples"])
        if not merged:
            return None
        merged.sort()
        return {f"p{int(q)}": percentile_nearest_rank(merged, q) for q in qs}

    def last_percentiles(self) -> Optional[Dict[str, float]]:
        with self._lock:
            d = self._last_digest
        if d is None:
            return None
        return {"p50": d["p50"], "p95": d["p95"], "p99": d["p99"]}

    def windows(
        self, n: Optional[int] = None, now: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Sealed digests oldest-first (samples stripped), plus the
        current partial window last (marked ``"partial": True``)."""
        widx = self._widx(now)
        with self._lock:
            self._roll_locked(widx)
            out = [
                {k: v for k, v in d.items() if k != "_samples"}
                for d in self._sealed
            ]
            if self._cur_count:
                samples = sorted(self._cur_samples)
                cur = {
                    "widx": self._cur_widx,
                    "t_unix": self.window_wall_start(self._cur_widx),
                    "count": self._cur_count,
                    "sum": self._cur_sum,
                    "p50": percentile_nearest_rank(samples, 50),
                    "p95": percentile_nearest_rank(samples, 95),
                    "p99": percentile_nearest_rank(samples, 99),
                    "max": samples[-1] if samples else 0.0,
                    "partial": True,
                }
                if self._thresholds:
                    cur["over"] = {
                        _thr_key(t): self._cur_over.get(_thr_key(t), 0)
                        for t in self._thresholds
                    }
                out.append(cur)
        return out[-n:] if n is not None else out

    def window_counts(
        self,
        n_windows: int,
        threshold_ms: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, int]:
        """(total, over-threshold) event counts across the last
        ``n_windows`` windows including the current partial one — the
        SLO evaluator's good/bad input.  ``threshold_ms`` must have been
        registered before the windows of interest sealed."""
        wins = self.windows(now=now)
        widx = self._widx(now)
        lo = widx - n_windows + 1
        total = over = 0
        key = _thr_key(threshold_ms) if threshold_ms is not None else None
        for d in wins:
            if d["widx"] < lo:
                continue
            total += d["count"]
            if key is not None:
                over += d.get("over", {}).get(key, 0)
        return {"total": total, "over": over}


def _thr_key(threshold: float) -> str:
    """Stable string key for a threshold (JSON dict keys)."""
    return f"{threshold:g}"


class TelemetryStore:
    """Named time series sharing one window clock.

    Three kinds:

    * **counter** — the sampler records the live cumulative value each
      tick; a window's point is the DELTA vs the previous retained
      window (a decrease is treated as a process-restart reset, so the
      delta is the new cumulative, never negative);
    * **gauge** — last sample in the window wins;
    * **digest** — a :class:`WindowedDigest` registered by name (the
      metrics histograms register theirs, so the JSON export serves
      the same rollups ``summary()`` reads).
    """

    def __init__(
        self,
        interval_s: float = 10.0,
        points: int = 360,
        now_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.interval_s = float(interval_s)
        self.points = int(points)
        self._now = now_fn
        self._wall_offset = time.time() - now_fn()
        self._lock = threading.Lock()
        # name -> {widx: value}; kinds tracked separately so exposition
        # can render the right Prometheus TYPE line
        self._counters: Dict[str, Dict[int, float]] = {}
        # cumulative value of the most recently PRUNED window per
        # counter, so the oldest retained window's delta stays a real
        # delta after a ring wrap instead of re-baselining to the full
        # cumulative (which would read as a giant spike at the ring's
        # trailing edge)
        self._counter_base: Dict[str, float] = {}
        self._gauges: Dict[str, Dict[int, float]] = {}
        self._digests: Dict[str, WindowedDigest] = {}

    # ---- window clock --------------------------------------------------------

    def _widx(self, now: Optional[float]) -> int:
        t = self._now() if now is None else now
        return int(t // self.interval_s)

    def widx(self, now: Optional[float] = None) -> int:
        """Current window index (the SLO evaluator's clock)."""
        return self._widx(now)

    def window_wall_start(self, widx: int) -> float:
        return self._wall_offset + widx * self.interval_s

    # ---- recording -----------------------------------------------------------

    def record_counter(
        self, name: str, cumulative: float, now: Optional[float] = None
    ) -> None:
        widx = self._widx(now)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[widx] = cumulative
            lo = widx - self.points + 1
            if len(series) > self.points:
                pruned = [k for k in series if k < lo]
                if pruned:
                    self._counter_base[name] = series[max(pruned)]
                for k in pruned:
                    del series[k]

    def record_gauge(
        self, name: str, value: float, now: Optional[float] = None
    ) -> None:
        widx = self._widx(now)
        with self._lock:
            series = self._gauges.setdefault(name, {})
            series[widx] = value
            self._prune_locked(series, widx)

    def register_digest(self, name: str, digest: WindowedDigest) -> None:
        with self._lock:
            self._digests[name] = digest

    def _prune_locked(self, series: Dict[int, float], widx: int) -> None:
        lo = widx - self.points + 1
        if len(series) > self.points:
            for k in [k for k in series if k < lo]:
                del series[k]

    # ---- queries -------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(
                set(self._counters) | set(self._gauges) | set(self._digests)
            )

    def series(
        self, name: str, now: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """One series, JSON-ready: ``{"name", "kind", "interval_s",
        "points": [...]}``.  Counter points carry both the window delta
        and the raw cumulative so consumers can re-derive rates."""
        with self._lock:
            if name in self._digests:
                digest = self._digests[name]
            elif name in self._counters:
                items = sorted(self._counters[name].items())
                points = []
                # the ring's trailing edge re-anchors on the last
                # PRUNED window's cumulative; a first-ever window
                # anchors at zero (its delta is the since-boot count)
                prev: Optional[float] = self._counter_base.get(name)
                for widx, cum in items:
                    if cum < (prev or 0.0):
                        # reset (restart): attribute the new cumulative
                        # — a negative delta would be a lie
                        delta = cum
                    else:
                        delta = cum - (prev or 0.0)
                    points.append(
                        {
                            "widx": widx,
                            "t_unix": self.window_wall_start(widx),
                            "value": delta,
                            "cumulative": cum,
                        }
                    )
                    prev = cum
                return {
                    "name": name,
                    "kind": "counter",
                    "interval_s": self.interval_s,
                    "points": points,
                }
            elif name in self._gauges:
                items = sorted(self._gauges[name].items())
                return {
                    "name": name,
                    "kind": "gauge",
                    "interval_s": self.interval_s,
                    "points": [
                        {
                            "widx": widx,
                            "t_unix": self.window_wall_start(widx),
                            "value": v,
                        }
                        for widx, v in items
                    ],
                }
            else:
                return None
        # digest path runs outside the store lock (digest has its own)
        return {
            "name": name,
            "kind": "histogram",
            "interval_s": digest.interval_s,
            "points": digest.windows(now=now),
        }

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "points": self.points,
            "series": {
                name: self.series(name, now=now) for name in self.names()
            },
        }

    def latest_gauge(self, name: str) -> Optional[float]:
        with self._lock:
            series = self._gauges.get(name)
            if not series:
                return None
            return series[max(series)]

    def latest_gauges(self) -> Dict[str, float]:
        """Last sample of every gauge series — the Prometheus renderer's
        scrape surface, so a /metrics hit never materializes full
        counter/digest point lists just to learn their kind."""
        with self._lock:
            return {
                name: series[max(series)]
                for name, series in self._gauges.items()
                if series
            }

    def window_delta(
        self, name: str, n_windows: int, now: Optional[float] = None
    ) -> float:
        """Counter increase over the last ``n_windows`` windows
        (current partial included) — the SLO evaluator's event-count
        input.  Deltas are summed from the series points so restart
        resets stay non-negative."""
        s = self.series(name, now=now)
        if s is None or s["kind"] != "counter":
            return 0.0
        lo = self._widx(now) - n_windows + 1
        return float(
            sum(p["value"] for p in s["points"] if p["widx"] >= lo)
        )


# breaker states as numeric gauges: closed=0,
# half_open=1, open=2 — unknown strings surface as -1 rather than lying
_BREAKER_NUM = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

# torch.cuda.memory_stats keys sampled as device_mem_<name> gauges
_DEVICE_MEM_STATS = (
    ("allocated_bytes.all.current", "allocated_bytes"),
    ("allocated_bytes.all.peak", "allocated_peak_bytes"),
    ("reserved_bytes.all.current", "reserved_bytes"),
    ("reserved_bytes.all.peak", "reserved_peak_bytes"),
)


def _is_device_fault(exc: BaseException) -> bool:
    """``ops/_kernels.is_device_fault``, imported when first needed (the
    obs package imports no torch at module top)."""
    from docqa_tpu_torch.ops._kernels import is_device_fault

    return is_device_fault(exc)


class TelemetrySampler:
    """Background scrape of the live serving plane into a store.

    Everything is duck-typed and every probe is individually fenced: a
    dying replica or a closed broker must never kill the sampler — the
    whole point is observing the system while it misbehaves.  The
    sampler owns NO locks of its own beyond the stop event; it only
    reads brief, already-synchronized surfaces (``pool.status()``,
    ``broker.depth``, registry snapshots), so it can never deadlock a
    drain or rolling restart it happens to observe mid-flight.
    """

    def __init__(
        self,
        store: TelemetryStore,
        registry=None,  # runtime.metrics.MetricsRegistry (duck-typed)
        batcher=None,  # EnginePool or ContinuousBatcher (duck-typed)
        broker=None,
        queues: Sequence[str] = (),
        recorder=None,  # obs.recorder.FlightRecorder
        engine=None,  # GenerateEngine (device memory probe)
        slo_evaluator=None,  # obs.slo.BurnRateEvaluator
        spine=None,  # engines.spine.DispatchSpine (duck-typed)
        sample_every_s: float = 2.0,
        extra_probes: Sequence[Callable[[], Dict[str, float]]] = (),
    ) -> None:
        self.store = store
        self.registry = registry
        self.batcher = batcher
        self.broker = broker
        self.queues = tuple(queues)
        self.recorder = recorder
        self.engine = engine
        self.slo_evaluator = slo_evaluator
        self.spine = spine
        self.sample_every_s = float(sample_every_s)
        self.extra_probes = list(extra_probes)
        # the kernel or CUDA fault the sampler thread stopped on, if any
        self.device_fault: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        # cumulative wall seconds spent inside tick(): a caller divides
        # this by the measured window to report the sampler's CPU share
        # against the 2% observability budget
        self.tick_seconds = 0.0
        self._probe_errors: Dict[str, int] = {}

    # ---- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetrySampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-sampler"
        )
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        """Idempotent; joins the thread.  Ticks only read bounded
        surfaces, so the join bound is slack, not load-bearing."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                log.warning("telemetry sampler still alive after stop()")
            else:
                self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self.tick()
            except Exception as e:
                if _is_device_fault(e):
                    # the context is poisoned: stop observing and keep
                    # the fault for whoever owns the sampler
                    self.device_fault = e
                    log.error("telemetry sampler stopped on a device fault: %r", e)
                    return
                # belt-and-braces: individual probes are fenced below;
                # this catches store-level surprises
                log.exception("telemetry tick failed")
            self.tick_seconds += time.perf_counter() - t0
            self._stop.wait(self.sample_every_s)

    # ---- one scrape ----------------------------------------------------------

    def _fenced(self, what: str, fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception as e:
            if _is_device_fault(e):
                raise
            # log the FIRST failure of each probe, then count quietly —
            # a dead replica would otherwise spam one traceback per tick
            n = self._probe_errors.get(what, 0)
            self._probe_errors[what] = n + 1
            if n == 0:
                log.exception("telemetry probe %r failed", what)

    def tick(self, now: Optional[float] = None) -> None:
        self.ticks += 1
        if self.registry is not None:
            self._fenced("registry", lambda: self._scrape_registry(now))
        if self.batcher is not None:
            self._fenced("batcher", lambda: self._scrape_batcher(now))
        if self.broker is not None:
            self._fenced("broker", lambda: self._scrape_broker(now))
        if self.recorder is not None:
            self._fenced("recorder", lambda: self._scrape_recorder(now))
        if self.engine is not None:
            self._fenced("engine", lambda: self._scrape_engine(now))
        if self.spine is not None:
            self._fenced("spine", lambda: self._scrape_spine(now))
        for probe in self.extra_probes:
            self._fenced(
                getattr(probe, "__name__", "extra"),
                lambda p=probe: self._scrape_extra(p, now),
            )
        if self.slo_evaluator is not None:
            self._fenced("slo", lambda: self.slo_evaluator.evaluate(now=now))

    def _scrape_registry(self, now: Optional[float]) -> None:
        counters, histograms, gauges = self.registry.instruments()
        for name, c in counters.items():
            self.store.record_counter(name, c.value, now=now)
        for name, g in gauges.items():
            self.store.record_gauge(name, g.value, now=now)
        for name, h in histograms.items():
            d = getattr(h, "digest", None)
            if d is not None:
                self.store.register_digest(name, d)
                d.roll(now=now)

    def _scrape_batcher(self, now: Optional[float]) -> None:
        b = self.batcher
        rec = self.store.record_gauge
        rec("serve_queue_depth", float(b.n_queued), now=now)
        rec("serve_active_slots", float(b.n_active), now=now)
        n_admitting = getattr(b, "n_admitting", None)
        if n_admitting is not None:
            rec("serve_admitting", float(n_admitting), now=now)
        occupancy = getattr(b, "kv_block_occupancy", None)
        if occupancy is not None:
            # block-pool occupancy (engines/paged.py): per-token KV HBM
            # accounting at block granularity — the ROADMAP item 1
            # evidence that replaced the per-bucket slot gauges (a slot
            # no longer pins a bucket's worth of HBM for its lifetime)
            occ = occupancy()
            for key in (
                "blocks_total", "blocks_used", "block_size",
                "bytes_per_token", "pool_bytes", "used_bytes",
                "tokens_committed", "utilization",
                # prefix-cache occupancy (docqa-prefix): entries, the
                # blocks the cache pins, and the lifetime hit economics
                "prefix_entries", "prefix_blocks", "prefix_hit_rate",
                "prefix_tokens_avoided",
            ):
                if key in occ:
                    rec(f"serve_kv_{key}", float(occ[key]), now=now)
        qos_status = getattr(b, "qos_status", None)
        if qos_status is not None:
            # multi-tenant QoS (docqa-qos): live deferral flag + class
            # queue depths as gauges; the qos_deferred_* /
            # qos_preempted_* counters ride the registry scrape like
            # every other counter
            q = qos_status()
            if q.get("enabled"):
                rec(
                    "qos_defer_active",
                    1.0 if q.get("defer_active") else 0.0,
                    now=now,
                )
                for cls, n in q.get("queued_by_class", {}).items():
                    rec(f"qos_queued_{cls}", float(n), now=now)
        status = getattr(b, "status", None)
        if status is None:
            return
        st = status()
        self.store.record_gauge(
            "pool_pending", float(st.get("pending", 0)), now=now
        )
        for row in st.get("replicas", ()):
            i = row["replica"]
            rec(
                f"pool_replica{i}_alive",
                1.0 if row.get("worker_alive") else 0.0,
                now=now,
            )
            rec(
                f"pool_replica{i}_breaker",
                _BREAKER_NUM.get(str(row.get("breaker")), -1.0),
                now=now,
            )
            rec(
                f"pool_replica{i}_heartbeat_age_s",
                float(row.get("heartbeat_age_s", 0.0)),
                now=now,
            )
            rec(
                f"pool_replica{i}_queued",
                float(row.get("n_queued", 0)),
                now=now,
            )
            rec(
                f"pool_replica{i}_active",
                float(row.get("n_active", 0)),
                now=now,
            )

    def _scrape_broker(self, now: Optional[float]) -> None:
        for q in self.queues:
            self.store.record_gauge(
                f"broker_depth_{q}", float(self.broker.depth(q)), now=now
            )
            self.store.record_gauge(
                f"broker_in_flight_{q}",
                float(self.broker.in_flight(q)),
                now=now,
            )
            self.store.record_gauge(
                f"broker_dead_letters_{q}",
                float(len(self.broker.dead_letters(q))),
                now=now,
            )

    def _scrape_recorder(self, now: Optional[float]) -> None:
        r = self.recorder
        self.store.record_gauge(
            "trace_open", float(len(r.open_traces())), now=now
        )
        self.store.record_counter(
            "trace_anomalous_total",
            float(getattr(r, "anomalous_total", 0)),
            now=now,
        )

    def _scrape_engine(self, now: Optional[float]) -> None:
        """Device memory of the engine's card (``device_mem_*``), read
        from ``torch.cuda.memory_stats``; nothing on a CPU engine."""
        device = getattr(self.engine, "device", None)
        if device is None or getattr(device, "type", None) != "cuda":
            return
        import torch

        stats = torch.cuda.memory_stats(device)
        for key, name in _DEVICE_MEM_STATS:
            if key in stats:
                self.store.record_gauge(
                    f"device_mem_{name}", float(stats[key]), now=now
                )

    def _scrape_spine(self, now: Optional[float]) -> None:
        """Dispatch-spine series (``dispatch_*``; engines/spine.py):
        live gauges — queue depth, lane occupancy (the runtime value of
        the concurrency bound the stream ledger used to gate
        statically) — plus cumulative per-stage device/queue-wait time
        as counters, so the store serves per-window device-time
        deltas per stage."""
        for name, value in self.spine.telemetry_gauges().items():
            self.store.record_gauge(name, float(value), now=now)
        for name, value in self.spine.telemetry_counters().items():
            self.store.record_counter(name, float(value), now=now)

    def _scrape_extra(self, probe, now: Optional[float]) -> None:
        for name, value in (probe() or {}).items():
            self.store.record_gauge(name, float(value), now=now)
