"""Replicated decode-engine pool with health-checked failover, counterpart
of ``docqa_tpu/engines/pool.py``.

An :class:`EnginePool` owns N :class:`~docqa_tpu_torch.engines.serve.
ContinuousBatcher` replicas over ONE shared ``GenerateEngine`` (weights are
read-only; replicas differ in KV pool, RNG stream, worker thread and CUDA
stream: each batcher runs its device work on its own ``spine.Lane``) and is
the single submit surface for ``service/qa.py``.

Liveness contract, per replica:

* **worker heartbeat** — a stale beat WITH work pending (queued, active or
  in the admission window) means the loop is wedged inside one iteration;
  a ``cold`` replica (not yet warmed, no chunk landed) is never judged;
* **synthetic canary** — a periodic 2-token generate on an idle replica,
  its outcome fed to the replica's breaker (a replica that delivered a
  chunk within the interval counts as a passed probe instead);
* **per-replica circuit breaker** — deaths and canary failures open it; an
  open breaker makes the replica unroutable, and its half-open probe gates
  the rebuild of a crash-looping replica.

Mechanics:

* **routing** — least-queued among routable replicas, session-affine on
  the request's ``prefix_key`` (its warm KV prefix lives there) unless the
  preferred replica is ``affinity_max_queue_delta`` requests deeper;
* **failover** — a dead or wedged replica's queued requests requeue to a
  healthy one (deadline-aware, at most ``requeue_max_hops`` hops; the same
  request object moves, so the caller's handle never notices); admitted
  ones fail fast with a typed :class:`WorkerDied`, which ``service/qa.py``
  turns into the degraded answer.  KV preemption victims ride the same
  requeue;
* **rebuild** — a fresh batcher (new KV pool, new worker, new ``Lane`` and
  so a new CUDA stream) replaces a dead one.  The old batcher's device
  state stays referenced until its worker thread has exited and its stream
  is drained, so no block returns to the caching allocator while the old
  stream can still write it; then the cache is emptied, so a rebuild does
  not grow the process's reserved device memory;
* **pending park** — while no replica is routable but one is coming back,
  submissions park and flush on recovery (a 1-replica pool survives its own
  rolling restart);
* **drain / resume / rolling restart**, **hedged dispatch** (first token
  wins), **warm-up** at construction (``gen.startup_warm_buckets``; a
  kernel that fails to build or launch raises from the constructor).

A kernel or CUDA fault (``ops/_kernels.is_device_fault``) is not a replica
failure: the process's CUDA context is poisoned, so there is nothing to
fail over to.  The pool rebuilds nothing around it; it fails every waiter
on every replica with the original error, marks every replica ``failed``
in :meth:`status`, and raises that error to every later submission.

On a mesh with a command stream (``runtime/mesh.py``) every rank builds the
pool over its shard of the one engine, and the leader's pool alone routes,
monitors and runs canaries: a follower's pool starts no thread, and its
batchers run only the commands the leader publishes.  The startup warm-up
runs the replicas one after another (every rank issues the same
collectives in one order), and a rebuild (:meth:`EnginePool._build_replica`)
is a command, so a follower replaces its replica too.

Observability, as in the reference: requests are pool-managed (a replica's
refusal is routing, so only the pool's terminal shed leaves a snapshot in the
cost ledger and retires the record); routing, parking, failover and hedging
leave events on the request's trace; a hedge twin shares its primary's trace
and cost record.  :meth:`EnginePool.set_slo_probe` wires the burn probe: batch
traffic is deferred once, at dispatch (``QoSConfig.defer_batch_on_burn``).
"""

from __future__ import annotations

import collections
import threading
import zlib
from time import monotonic as time_monotonic
from time import perf_counter as _now
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from docqa_tpu_torch.engines.qos import QoSPolicy, request_class
from docqa_tpu_torch.runtime.mesh import mirrored
from docqa_tpu_torch.engines.serve import (
    DEFAULT_RESULT_TIMEOUT,
    ContinuousBatcher,
    DeferredByPolicy,
    Draining,
    Handle,
    QueueFull,
    RequestCancelled,
    ResultTimeout,
    WorkerDied,
    _finish,
    _req_mark,
    make_request,
)
from docqa_tpu_torch.obs.costs import DEFAULT_COST_LEDGER
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience.breaker import OPEN, CircuitBreaker
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.pool")

# replica health states (surfaced by status())
HEALTHY = "healthy"
DRAINING = "draining"
REBUILDING = "rebuilding"
DEAD = "dead"
FAILED = "failed"  # the pool hit a kernel or CUDA fault: nothing serves


class FailoverExhausted(WorkerDied):
    """A request's replica died and it had no failover budget left.  Typed
    so the QA layer degrades it like any replica loss."""


class _Replica:
    """One pooled decode lane: the batcher plus its health bookkeeping.
    The pool lock guards ``state``; counters are monotonic ints."""

    def __init__(self, idx: int, batcher: ContinuousBatcher,
                 breaker: CircuitBreaker) -> None:
        self.idx = idx
        self.batcher = batcher
        self.breaker = breaker
        self.state = HEALTHY
        self.generation = 0  # bumps on every rebuild
        self.deaths = 0
        self.routed = 0
        self.canary_ok = 0
        self.canary_failed = 0
        # the first canary waits one full interval
        self.last_canary_at = time_monotonic()
        self.canary: Optional[Handle] = None
        self.canary_deadline: Optional[Deadline] = None

    def routable(self, heartbeat_max_age_s: float) -> bool:
        b = self.batcher
        return (
            self.state == HEALTHY
            and b.worker_alive
            and not b.draining
            and b.heartbeat_age_s < heartbeat_max_age_s
            and self.breaker.state != OPEN
        )


class PoolHandle:
    """Future-like result for a pooled request, shaped like the batcher's
    :class:`Handle` (``result`` / ``text`` / ``iter_tokens`` / ``cancel``).
    Failover is invisible here: the request object moves between replicas
    and this handle waits on its one ``done`` event.  With hedging, the
    twin that answers first wins; one side's error only loses if the other
    side failed too."""

    def __init__(self, pool: "EnginePool", req) -> None:
        self._pool = pool
        self._req = req

    def _twin(self):
        return self._pool._hedge_twin(self._req)

    def cancel(self) -> None:
        self._req.cancelled = True
        twin = self._twin()
        if twin is not None:
            twin.cancelled = True

    def result(
        self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> List[int]:
        t0 = _now()
        try:
            if not self._pool.hedge_enabled:
                out = Handle(self._req).result(timeout)
            else:
                out = self._result_hedged(timeout)
            self._pool._observe_latency(_now() - t0)
            return out
        finally:
            self._pool._inflight_done(self._req)

    @staticmethod
    def _losing_error(candidates) -> BaseException:
        """Both hedge lanes failed: the most actionable error (a
        RequestCancelled is the pool's own first-token bookkeeping)."""
        errs = [c.error for c in candidates if c.error is not None]
        real = [e for e in errs if not isinstance(e, RequestCancelled)]
        return (real or errs)[0]

    def _await_winner(self, timeout: Optional[float], win):
        """The hedge wait: cycle over (primary, twin-if-any) until one
        satisfies ``win``, every one failed, or the timeout lapses.
        Returns ``(winner, candidates_at_win)``."""
        req = self._req
        dl = req.deadline
        if dl is not None:
            timeout = dl.bound(timeout)
        end = None if timeout is None else time_monotonic() + timeout
        while True:
            twin = self._twin()
            candidates = [c for c in (req, twin) if c is not None]
            for cand in candidates:
                if win(cand):
                    return cand, candidates
            if all(c.done.is_set() for c in candidates):
                raise self._losing_error(candidates)
            remaining = None if end is None else end - time_monotonic()
            if remaining is not None and remaining <= 0:
                if dl is not None and dl.expired:
                    raise DeadlineExceeded("pool_result", -dl.remaining())
                raise ResultTimeout(timeout)
            wait_s = 0.02 if remaining is None else min(0.02, remaining)
            waiter = next((c for c in candidates if not c.done.is_set()), req)
            with waiter.cv:
                if not waiter.done.is_set() and not win(waiter):
                    waiter.cv.wait(wait_s)

    def _result_hedged(self, timeout: Optional[float]) -> List[int]:
        """First clean completion wins; the loser is cancelled."""
        winner, candidates = self._await_winner(
            timeout, lambda c: c.done.is_set() and c.error is None
        )
        for other in candidates:
            if other is not winner:
                other.cancelled = True
        return list(winner.tokens)

    def text(
        self, tokenizer, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> str:
        return tokenizer.decode_ids(self.result(timeout))

    def iter_tokens(self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT):
        """Stream tokens.  With hedging on, the stream pins to whichever
        request produces the first token without having failed."""
        t0 = _now()
        try:
            if not self._pool.hedge_enabled:
                yield from Handle(self._req).iter_tokens(timeout)
                self._pool._observe_latency(_now() - t0)
                return
            req = self._req
            winner, _ = self._await_winner(
                timeout,
                lambda c: c.error is None and (bool(c.tokens) or c.done.is_set()),
            )
            for other in (req, self._twin()):
                if other is not None and other is not winner:
                    other.cancelled = True
            yield from Handle(winner).iter_tokens(timeout)
            self._pool._observe_latency(_now() - t0)
        finally:
            self._pool._inflight_done(self._req)


class EnginePool:
    """N health-checked ContinuousBatcher replicas behind one submit
    surface: a drop-in for a bare batcher where ``service/qa.py`` uses one
    (``submit_ids`` / ``submit_text`` / ``prefix_cache_enabled`` /
    ``warmup`` / ``stop`` / ``n_active`` / ``n_queued`` / ``engine`` /
    ``gen`` / ``device``)."""

    def __init__(
        self,
        engine,  # GenerateEngine shared by every replica (read-only weights)
        cfg=None,  # config.PoolConfig; kwargs below override per field
        *,
        replicas: Optional[int] = None,
        n_slots: Optional[int] = None,
        chunk: Optional[int] = None,
        cache_len: Optional[int] = None,
        max_queue: Optional[int] = None,
        seed: int = 0,
        heartbeat_max_age_s: Optional[float] = None,
        canary_interval_s: Optional[float] = None,
        canary_timeout_s: Optional[float] = None,
        health_interval_s: Optional[float] = None,
        requeue_max_hops: Optional[int] = None,
        hedge: Optional[bool] = None,
        hedge_min_delay_s: Optional[float] = None,
        hedge_warmup: Optional[int] = None,
        session_affinity: Optional[bool] = None,
        affinity_max_queue_delta: Optional[int] = None,
        breaker_failure_threshold: int = 3,
        breaker_reset_s: float = 10.0,
        qos=None,  # config.QoSConfig | qos.QoSPolicy | None (FIFO replicas)
        device="cuda",
    ) -> None:
        def pick(override, field, default):
            if override is not None:
                return override
            if cfg is not None:
                return getattr(cfg, field)
            return default

        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(
                f"engine on {engine.device}; the pool runs on {self.device}"
            )
        self.engine = engine
        self.gen = engine.gen
        self.n_replicas = max(1, int(pick(replicas, "replicas", 1)))
        self._n_slots = pick(n_slots, "n_slots", None)
        self._chunk = chunk
        self._cache_len = cache_len
        self.max_queue = pick(max_queue, "max_queue", 256)
        self._seed = seed
        # generous default: one worker iteration may hold a long
        # first-shape call; pre-warmed deployments can drop it
        self.heartbeat_max_age_s = pick(heartbeat_max_age_s, "heartbeat_max_age_s", 60.0)
        self.canary_interval_s = pick(canary_interval_s, "canary_interval_s", 20.0)
        self.canary_timeout_s = pick(canary_timeout_s, "canary_timeout_s", 30.0)
        self.health_interval_s = pick(health_interval_s, "health_interval_s", 0.5)
        self.requeue_max_hops = pick(requeue_max_hops, "requeue_max_hops", 1)
        self.hedge_enabled = bool(pick(hedge, "hedge", False))
        self.hedge_min_delay_s = pick(hedge_min_delay_s, "hedge_min_delay_s", 0.75)
        self.hedge_warmup = pick(hedge_warmup, "hedge_warmup", 20)
        self.session_affinity = bool(pick(session_affinity, "session_affinity", True))
        self.affinity_max_queue_delta = int(
            pick(affinity_max_queue_delta, "affinity_max_queue_delta", 4)
        )

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stopped = False
        # the kernel or CUDA fault that failed the pool, if one did
        self._failed: Optional[BaseException] = None
        # requests minted while no replica was routable but one was coming
        # back; flushed by the monitor on recovery (bounded by max_queue)
        self._pending: collections.deque = collections.deque()
        # hedging bookkeeping: req id() -> {"req", "twin", "t", "replica"}
        self._inflight: Dict[int, Dict[str, Any]] = {}
        # completion latencies (seconds) feeding the p95 hedge delay
        self._lat: collections.deque = collections.deque(maxlen=512)
        self._warmups: List[threading.Thread] = []
        # replaced batchers whose worker may still run (a wedged thread
        # cannot be interrupted): their device state stays referenced
        # until the thread exits; then their work counts join _retired_stats
        self._zombies: List[ContinuousBatcher] = []
        self._retired_stats: collections.Counter = collections.Counter()
        self._breakers = [
            CircuitBreaker(
                f"decode_replica_{i}",
                failure_threshold=breaker_failure_threshold,
                reset_timeout_s=breaker_reset_s,
            )
            for i in range(self.n_replicas)
        ]
        # the raw config threads to every replica (weighted-fair queues and
        # preemption live there); the coerced policy backs qos_status()
        self._qos_cfg = qos
        self.qos: Optional[QoSPolicy] = QoSPolicy.coerce(qos)
        # the burn probe batch deferral reads (set_slo_probe); None = off
        self._slo_probe = None
        self._replicas: List[_Replica] = []
        stream = getattr(engine, "_command_stream", None)
        self._stream = stream
        self._follower = stream is not None and stream.follower
        if stream is not None:
            stream.register_auto("pool", self)
        try:
            for i in range(self.n_replicas):
                self._replicas.append(self._build_replica(i))
            self._startup_warm()
        except BaseException:
            for r in self._replicas:
                r.batcher.stop()
            raise
        b0 = self._replicas[0].batcher
        # template truncation (submit_text) needs the shared usable budget
        self._usable = b0.cache_len - 2 - b0.spec_k
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="pool-monitor"
        )
        if not self._follower:
            self._monitor.start()

    # ---- replica lifecycle ---------------------------------------------------

    def _build_replica(self, idx: int, generation: int = 0) -> _Replica:
        """A fresh replica ``idx`` of ``generation`` (a command on a mesh: a
        follower swaps its own replica's batcher for the new one)."""
        return mirrored(self, "_build_replica", self._new_replica, idx, generation)

    def _new_replica(self, idx: int, generation: int = 0) -> _Replica:
        if self._follower and idx < len(self._replicas):
            old = self._replicas[idx]
            old.batcher.stop()
            self._stream.unregister(old.batcher)
            self._release_device_state(old.batcher)
        batcher = ContinuousBatcher(
            self.engine,
            n_slots=self._n_slots,
            chunk=self._chunk,
            cache_len=self._cache_len,
            # distinct RNG stream per replica AND per generation
            seed=self._seed + 1009 * idx + 7 * generation,
            max_queue=self.max_queue,
            qos=self._qos_cfg,
        )
        if self._slo_probe is not None:
            batcher.set_slo_probe(self._slo_probe)
        batcher.on_worker_death = (
            lambda b, queued, _i=idx: self._on_worker_death(_i, b, queued)
        )
        # preemption victims ride the failover requeue: deadline-aware,
        # hop-bounded, parking as the fallback
        batcher.on_preempt = lambda b, req, _i=idx: self._requeue(req, from_idx=_i)
        r = _Replica(idx, batcher, self._breakers[idx])
        r.generation = generation
        if self._follower and idx < len(self._replicas):
            self._replicas[idx] = r
        return r

    def _startup_warm(self) -> None:
        """Warm every replica at once (the kernel library's load lock builds
        it once): the ``gen.startup_warm_buckets`` smallest packed token
        budgets and the decode step.  The first error raises."""
        depth = self.gen.startup_warm_buckets
        if depth <= 0:
            return
        buckets = list(self.gen.prefill_token_buckets[:depth])
        if self._stream is not None:
            # one after another: every rank's collectives in one order
            for r in self._replicas:
                r.batcher.warmup(buckets=buckets)
            return
        errors: List[BaseException] = []

        def warm(b):
            try:
                b.warmup(buckets=buckets)
            except BaseException as e:
                errors.append(e)

        threads = [
            threading.Thread(target=warm, args=(r.batcher,), name=f"pool-warm-{r.idx}")
            for r in self._replicas
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _retire_batcher(self, old: ContinuousBatcher) -> None:
        """Release a replaced batcher's device state once its worker has
        exited; a worker still running (wedged) makes it a zombie, reaped
        by the monitor when the thread ends."""
        old._worker.join(timeout=1.0)
        if old._worker.is_alive():
            self._zombies.append(old)
            return
        self._release_device_state(old)

    def _release_device_state(self, old: ContinuousBatcher) -> None:
        self._retired_stats.update(old.stats)
        if old._lane.stream is not None:
            old._lane.stream.synchronize()
        for name in ("_pools", "_tok", "_lengths", "_active", "_table",
                     "_tables_dev", "_caps_dev"):
            setattr(old, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reap_zombies(self) -> None:
        for old in list(self._zombies):
            if not old._worker.is_alive():
                self._zombies.remove(old)
                self._release_device_state(old)

    def _rebuild_replica(self, r: _Replica) -> None:
        """Fresh batcher (fresh KV pool, worker and stream) in place of a
        dead or restarting one.  The batcher reads ``engine.params`` at
        every dispatch, so swapped weights serve from the first round."""
        log.warning(
            "rebuilding replica %d (generation %d -> %d)",
            r.idx, r.generation, r.generation + 1,
        )
        old = r.batcher
        old_was_cold = old.cold
        try:
            if old.worker_alive:
                old.kill(WorkerDied("replica rebuilt"))
            # admission-window stragglers that became slot-resident after
            # kill()'s sweep (idempotent when there are none)
            old.fail_active(WorkerDied(f"replica {r.idx} rebuilt"))
        except Exception:
            log.exception("old batcher teardown failed (continuing)")
        self._retire_batcher(old)
        fresh = self._build_replica(r.idx, generation=r.generation + 1)
        r.batcher = fresh.batcher
        r.generation += 1
        r.canary = None
        r.canary_deadline = None
        with self._lock:
            r.state = HEALTHY
            self._cv.notify_all()
        DEFAULT_REGISTRY.counter("pool_rebuilds").inc()
        if not old_was_cold:
            # the kernel libraries are process-wide and already loaded; the
            # fresh batcher's first iterations hold no build
            r.batcher._cold = False
            return
        # the old replica died during its own cold start: warm the fresh
        # one off the serving path (stop() joins it)
        t = threading.Thread(
            target=self._warm_replica, args=(r.batcher,), daemon=True,
            name=f"pool-warmup-{r.idx}",
        )
        self._warmups = [w for w in self._warmups if w.is_alive()] + [t]
        t.start()

    def _warm_replica(self, batcher: ContinuousBatcher) -> None:
        try:
            batcher.warmup()
        except Exception as e:
            if is_device_fault(e):
                self._fail(e)
                return
            log.exception("replica warmup failed (serving continues cold)")

    def _fail(self, err: BaseException) -> None:
        """A kernel or CUDA fault: fail every waiter on every replica and
        every parked request with ``err``, mark every replica failed, and
        refuse later submissions with it.  Nothing is rebuilt."""
        with self._lock:
            if self._failed is not None:
                return
            self._failed = err
            for r in self._replicas:
                r.state = FAILED
            pending = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        log.error("pool failed on a device fault: %r", err)
        DEFAULT_REGISTRY.counter("pool_device_faults").inc()
        for req in pending:
            if not req.done.is_set():
                req.error = err
                _finish(req)
        for r in self._replicas:
            if r.batcher.worker_alive:
                r.batcher.kill(err)

    # ---- submit surface ------------------------------------------------------

    @property
    def prefix_cache_enabled(self) -> bool:
        return any(r.batcher.prefix_cache_enabled for r in self._replicas)

    def submit_ids(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        prefix_key: Optional[str] = None,
        req_class: Optional[str] = None,
    ) -> PoolHandle:
        max_new = max_new_tokens or self.gen.max_new_tokens
        req = make_request(
            prompt_ids, max_new, deadline=deadline, prefix_key=prefix_key,
            req_class=req_class,
        )
        self._dispatch(req)
        return PoolHandle(self, req)

    def submit_text(
        self,
        prompt: str,
        max_new_tokens: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        prefix_key: Optional[str] = None,
        req_class: Optional[str] = None,
    ) -> PoolHandle:
        # the batcher's template-aware truncation: pooled answers match the
        # solo engine's token for token
        return self.submit_ids(
            self.engine.encode_prompt(prompt, self._usable),
            max_new_tokens, deadline=deadline, prefix_key=prefix_key,
            req_class=req_class,
        )

    def _routable(self, exclude=()) -> List[_Replica]:
        return [
            r for r in self._replicas
            if r.idx not in exclude and r.routable(self.heartbeat_max_age_s)
        ]

    def _preferred_replica(self, req) -> Optional[int]:
        """The replica a request's prefix key hashes to (zlib.crc32: stable
        across processes), or None when affinity is off or there is no
        key."""
        key = getattr(req, "prefix_key", None)
        if not self.session_affinity or not key or self.n_replicas < 2:
            return None
        return zlib.crc32(key.encode("utf-8")) % self.n_replicas

    def _try_place(self, req, exclude=()):
        """The one routing policy (dispatch, failover requeue and park
        flush): offer ``req`` to routable replicas in least-queued order,
        the session-affine one first when it is at most
        ``affinity_max_queue_delta`` deeper than the shallowest.  Returns
        ``(replica_or_None, n_full, n_candidates)``; ``n_full`` counts
        at-capacity refusals.  A draining or just-died replica is routed
        around without counting."""
        candidates = sorted(
            self._routable(exclude),
            key=lambda r: (r.batcher.n_queued, r.batcher.n_active),
        )
        want = self._preferred_replica(req)
        affine = False
        if want is not None and candidates:
            floor_q = candidates[0].batcher.n_queued
            for i, r in enumerate(candidates):
                if r.idx != want:
                    continue
                if i == 0:
                    affine = True
                elif r.batcher.n_queued <= floor_q + self.affinity_max_queue_delta:
                    candidates.insert(0, candidates.pop(i))
                    affine = True
                break
        n_full = 0
        for r in candidates:
            try:
                r.batcher.submit_request(req)
            except Draining:
                continue
            except QueueFull:
                n_full += 1
                continue
            except RuntimeError as e:  # WorkerDied, stopped: died meanwhile
                if is_device_fault(e):
                    raise
                continue
            if affine and r.idx == want:
                DEFAULT_REGISTRY.counter("pool_affinity_routed").inc()
            return r, n_full, len(candidates)
        return None, n_full, len(candidates)

    def _shed(self, req, kind: str, exc: QueueFull) -> QueueFull:
        """Terminal pool-level shed: the forensics snapshot and the cost
        record's retirement (replica refusals on the way were routing)."""
        cls = req.cost.cls if req.cost is not None else None
        DEFAULT_COST_LEDGER.record_shed(
            kind, cls=cls, stage="pool_dispatch",
            n_queued=exc.n_queued, n_active=exc.n_active,
        )
        if req.cost is not None:
            DEFAULT_COST_LEDGER.retire(req.cost, "shed_queue")
        return exc

    def _dispatch(self, req, exclude=()) -> None:
        """Route to the least-queued healthy replica; park when nothing is
        routable but a replica is draining or rebuilding; shed only when
        out of capacity everywhere."""
        if self._failed is not None:
            raise self._failed
        # replica refusals are routing decisions, not terminal sheds
        req.pool_managed = True
        # SLO-aware self-protection, once per request, at pool dispatch
        if self.qos is not None and not req.hops:
            cls = request_class(req)
            firing = self._slo_firing()
            if self.qos.should_defer(cls, firing):
                DEFAULT_REGISTRY.counter("qos_deferred").inc()
                DEFAULT_REGISTRY.counter(f"qos_deferred_{cls}").inc()
                _req_mark(
                    req, "qos_deferred", stage="pool_dispatch",
                    firing=",".join(firing),
                )
                DEFAULT_COST_LEDGER.record_shed(
                    "deferred_by_policy", cls=cls, stage="pool_dispatch",
                    firing=",".join(firing),
                )
                if req.cost is not None:
                    DEFAULT_COST_LEDGER.retire(req.cost, "shed_deferred")
                raise DeferredByPolicy(
                    f"{cls} deferred while SLO burn active: {firing}",
                    n_queued=self.n_queued, n_active=self.n_active,
                )
        placed, n_full, n_candidates = self._try_place(req, exclude)
        if placed is not None:
            placed.routed += 1
            _req_mark(
                req, "pool_route", anomalous=False,
                replica=placed.idx, generation=placed.generation,
            )
            if self.hedge_enabled:
                self._inflight[id(req)] = {
                    "req": req, "twin": None, "t": time_monotonic(),
                    "replica": placed.idx,
                }
            return
        if n_full and n_full == n_candidates:
            DEFAULT_REGISTRY.counter("pool_shed").inc()
            raise self._shed(req, "queue_full", QueueFull(
                f"all {n_candidates} healthy replica(s) at capacity",
                n_queued=self.n_queued, n_active=self.n_active,
            ))
        with self._lock:
            if self._failed is not None:
                raise self._failed
            if self._stopped:
                raise RuntimeError("pool is stopped")
            coming_back = any(
                r.state in (DRAINING, REBUILDING, DEAD) for r in self._replicas
            )
            if not coming_back:
                # n_queued takes self._lock, which this thread holds
                raise self._shed(req, "no_routable_replica", QueueFull(
                    "no routable replica",
                    n_queued=len(self._pending)
                    + sum(r.batcher.n_queued for r in self._replicas),
                    n_active=self.n_active,
                ))
            if len(self._pending) >= (self.max_queue or 256):
                DEFAULT_REGISTRY.counter("pool_shed").inc()
                raise self._shed(req, "queue_full", QueueFull(
                    "pool pending queue at capacity",
                    n_queued=len(self._pending), n_active=self.n_active,
                ))
            self._pending.append(req)
        DEFAULT_REGISTRY.counter("pool_parked").inc()
        _req_mark(req, "pool_parked", anomalous=False)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        for r in self._replicas:
            r.batcher.warmup(buckets=buckets)

    # ---- failover ------------------------------------------------------------

    def _on_worker_death(self, idx: int, batcher: ContinuousBatcher, queued):
        """Runs in the dying replica's worker thread: mark the replica dead,
        requeue its unadmitted requests, return the unrescued rest (they
        fail typed).  A device fault fails the whole pool instead and
        rescues nothing."""
        if batcher.device_fault is not None:
            self._fail(batcher.device_fault)
            return queued
        r = self._replicas[idx]
        if r.batcher is not batcher:
            return queued  # a stale generation's death
        with self._lock:
            if r.state == FAILED:
                return queued
            r.state = DEAD
        r.deaths += 1
        r.breaker.record_failure()
        DEFAULT_REGISTRY.counter("pool_replica_deaths").inc()
        log.error("replica %d worker died (%d queued to fail over)", idx, len(queued))
        unrescued = [req for req in queued if not self._requeue(req, from_idx=idx)]
        with self._cv:
            self._cv.notify_all()
        return unrescued

    def _requeue(self, req, from_idx: int) -> bool:
        """Move one queued-but-unadmitted request (or a preemption victim)
        to a healthy replica: deadline-aware and hop-bounded; False when
        the caller must fail it typed."""
        if req.done.is_set() or req.cancelled:
            return True
        if req.deadline is not None and req.deadline.expired:
            req.error = DeadlineExceeded("pool_requeue")
            DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
            _req_mark(req, "deadline_exceeded", stage="pool_requeue")
            DEFAULT_COST_LEDGER.record_shed(
                "deadline",
                cls=req.cost.cls if req.cost is not None else None,
                stage="pool_requeue",
            )
            _finish(req)
            return True  # handled (typed), not lost
        if req.hops >= self.requeue_max_hops:
            return False
        req.hops += 1
        placed, _, _ = self._try_place(req, exclude=(from_idx,))
        if placed is not None:
            DEFAULT_REGISTRY.counter("pool_requeued").inc()
            _req_mark(
                req, "pool_failover",
                from_replica=from_idx, to_replica=placed.idx, hop=req.hops,
            )
            return True
        # nowhere healthy now: park it (flushed on recovery)
        with self._lock:
            if (
                self._stopped or self._failed is not None
                or len(self._pending) >= (self.max_queue or 256)
            ):
                return False
            self._pending.append(req)
        _req_mark(req, "pool_failover_parked", from_replica=from_idx)
        return True

    # ---- health monitor ------------------------------------------------------

    def _transition(self, r: _Replica, from_states, to_state: str) -> bool:
        """Compare-and-set a replica state under the pool lock: every state
        change goes through here, so the monitor and an operator can never
        both rebuild one replica."""
        with self._lock:
            if r.state not in from_states:
                return False
            r.state = to_state
            self._cv.notify_all()
            return True

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self.health_interval_s):
            try:
                self._tick()
            except Exception as e:
                if is_device_fault(e):
                    # a fault outside the rebuild and canary paths (a dead
                    # replica's teardown, a flush) fails the pool like theirs
                    self._fail(e)
                    continue
                log.exception("pool monitor tick failed (ignored)")

    def _tick(self) -> None:
        if self._stopped:
            return
        self._reap_zombies()
        if self._failed is not None:
            return
        now = time_monotonic()
        # while any replica is rebuilding or still cold, liveness judgment
        # is suspended: its warm-up slows every worker on the host
        storm = any(r.state == REBUILDING or r.batcher.cold for r in self._replicas)
        for r in self._replicas:
            self._check_replica(r, now, storm)
        self._flush_pending()
        if self.hedge_enabled:
            self._hedge_tick(now)
        with self._cv:
            self._cv.notify_all()  # wake bulk submitters waiting on capacity

    def _check_replica(self, r: _Replica, now: float, storm: bool) -> None:
        b = r.batcher
        if r.state == DRAINING:
            return  # operator-owned
        if r.state == HEALTHY and not b.worker_alive:
            # exited without the death hook (external kill/stop)
            if self._transition(r, (HEALTHY,), DEAD):
                r.deaths += 1
                r.breaker.record_failure()
                DEFAULT_REGISTRY.counter("pool_replica_deaths").inc()
                log.error("replica %d worker found dead by monitor", r.idx)
        if (
            r.state == HEALTHY
            and not b.cold
            and not storm
            and b.heartbeat_age_s > self.heartbeat_max_age_s
            # a worker wedged INSIDE the admission window shows 0 queued
            # and 0 active: only n_admitting betrays the pending work
            and (b.n_active > 0 or b.n_queued > 0 or b.n_admitting > 0)
        ):
            # WEDGE: queued requests are rescuable; admitted ones fail fast
            # into the degraded path.  CAS: a drain that won owns the replica
            if not self._transition(r, (HEALTHY,), DEAD):
                return
            log.error(
                "replica %d wedged (heartbeat %.1fs stale, %d active, "
                "%d queued) — failing over",
                r.idx, b.heartbeat_age_s, b.n_active, b.n_queued,
            )
            r.deaths += 1
            r.breaker.record_failure()
            DEFAULT_REGISTRY.counter("pool_replica_wedges").inc()
            for req in b.steal_queued():
                if not self._requeue(req, from_idx=r.idx) and not req.done.is_set():
                    req.error = FailoverExhausted(
                        f"replica {r.idx} wedged; no failover left"
                    )
                    _req_mark(req, "failover_exhausted")
                    _finish(req)
            b.kill(WorkerDied(f"replica {r.idx} wedged (heartbeat stale)"))
        if r.state == DEAD:
            # rebuild gated by the breaker: a crash-looping replica sits out
            # its reset window, then one half-open probe rebuild
            if r.breaker.allow() and self._transition(r, (DEAD,), REBUILDING):
                try:
                    self._rebuild_replica(r)
                    r.last_canary_at = 0.0  # the post-rebuild canary probes now
                except Exception as e:
                    if is_device_fault(e):
                        self._fail(e)
                        return
                    log.exception("replica %d rebuild failed", r.idx)
                    self._transition(r, (REBUILDING,), DEAD)
                    r.breaker.record_failure()
            return
        if r.state != HEALTHY:
            return
        # ---- canary: a tiny real generate, outcome feeds the breaker
        if r.canary is not None:
            dl = r.canary_deadline
            creq = r.canary._req
            if storm and (
                (creq.done.is_set() and creq.error is not None)
                or (dl is not None and dl.expired)
            ):
                # evidence about the warm-up storm, not the replica
                creq.cancelled = True
                r.canary = None
                r.canary_deadline = None
            elif creq.done.is_set():
                if creq.error is None:
                    r.canary_ok += 1
                    r.breaker.record_success()
                elif is_device_fault(creq.error):
                    self._fail(creq.error)
                else:
                    r.canary_failed += 1
                    r.breaker.record_failure()
                    log.warning("replica %d canary failed: %r", r.idx, creq.error)
                r.canary = None
                r.canary_deadline = None
            elif dl is not None and dl.expired:
                r.canary_failed += 1
                r.breaker.record_failure()
                DEFAULT_REGISTRY.counter("pool_canary_timeouts").inc()
                log.warning("replica %d canary timed out", r.idx)
                creq.cancelled = True
                r.canary = None
                r.canary_deadline = None
        elif b.cold or storm:
            # no canary into a cold replica or during a warm-up storm
            r.last_canary_at = now
        elif b.last_progress_age_s < self.canary_interval_s:
            # real traffic proved the dispatch -> device -> fetch path:
            # count a passed probe once per interval, spend no lane
            if now - r.last_canary_at >= self.canary_interval_s:
                r.last_canary_at = now
                r.breaker.record_success()
        elif now - r.last_canary_at >= self.canary_interval_s:
            r.last_canary_at = now
            dl = Deadline.after(self.canary_timeout_s)
            try:
                r.canary = r.batcher.submit_request(
                    make_request([1, 2, 3], 2, deadline=dl, req_class="background")
                )
                r.canary_deadline = dl
            except Exception as e:
                if is_device_fault(e):
                    self._fail(e)
                    return
                r.canary_failed += 1
                r.breaker.record_failure()
                log.warning("replica %d canary submit failed: %r", r.idx, e)

    def _flush_pending(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            if req.done.is_set() or req.cancelled:
                continue
            if req.deadline is not None and req.deadline.expired:
                req.error = DeadlineExceeded("pool_pending")
                DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
                _req_mark(req, "deadline_exceeded", stage="pool_pending")
                DEFAULT_COST_LEDGER.record_shed(
                    "deadline",
                    cls=req.cost.cls if req.cost is not None else None,
                    stage="pool_pending",
                )
                _finish(req)
                continue
            placed, _, _ = self._try_place(req)
            if placed is not None:
                placed.routed += 1
                _req_mark(
                    req, "pool_route", anomalous=False,
                    replica=placed.idx, parked=True,
                )
                continue
            with self._lock:
                if not self._stopped and self._failed is None:
                    self._pending.appendleft(req)
                    return
            # stop() or a fault already swept _pending: fail it like the
            # sweep did
            if not req.done.is_set():
                req.error = self._failed or RuntimeError("pool stopped")
                _finish(req)
            return

    # ---- hedged dispatch -----------------------------------------------------

    def hedge_delay_s(self) -> float:
        """p95 of observed completion latencies, floored by the configured
        minimum; the floor alone until ``hedge_warmup`` samples exist."""
        lat = list(self._lat)
        if len(lat) < self.hedge_warmup:
            return self.hedge_min_delay_s
        return max(float(np.percentile(lat, 95)), self.hedge_min_delay_s)

    def _observe_latency(self, seconds: float) -> None:
        self._lat.append(seconds)

    def _hedge_twin(self, req):
        entry = self._inflight.get(id(req))
        return entry["twin"] if entry else None

    def _inflight_done(self, req) -> None:
        self._inflight.pop(id(req), None)

    def _hedge_tick(self, now: float) -> None:
        delay = self.hedge_delay_s()
        for entry in list(self._inflight.values()):
            req, twin = entry["req"], entry["twin"]
            if twin is not None:
                # first token wins: cancel the laggard
                if req.tokens and not twin.tokens:
                    twin.cancelled = True
                elif twin.tokens and not req.tokens:
                    req.cancelled = True
            if req.done.is_set() and (twin is None or twin.done.is_set()):
                # settled: collect abandoned entries after a grace window
                # (a waiter discovers the twin through this entry)
                if "done_at" not in entry:
                    entry["done_at"] = now
                elif now - entry["done_at"] > 60.0:
                    self._inflight.pop(id(req), None)
                continue
            if twin is not None or req.tokens or req.cancelled:
                continue
            if now - entry["t"] < delay:
                continue
            if req.deadline is not None and req.deadline.remaining() < 0.1:
                continue
            targets = self._routable(exclude=(entry["replica"],))
            if not targets:
                continue
            r = min(targets, key=lambda x: (x.batcher.n_queued, x.batcher.n_active))
            # the twin rides the same trace and the same cost record (the
            # duplicated decode is real cost of the one request); as a
            # shadow it never retires the shared record
            twin = make_request(
                list(req.prompt_ids), req.max_new, deadline=req.deadline,
                prefix_key=req.prefix_key, req_class=req.req_class,
                cost=req.cost,
            )
            twin.trace = req.trace
            twin.span_parent = req.span_parent
            twin.cost_shadow = True
            try:
                r.batcher.submit_request(twin)
            except Exception as e:
                if is_device_fault(e):
                    raise
                continue
            entry["twin"] = twin
            DEFAULT_REGISTRY.counter("pool_hedges").inc()
            _req_mark(
                req, "pool_hedged", anomalous=False,
                to_replica=r.idx, after_ms=round((now - entry["t"]) * 1e3),
            )

    # ---- drain / rolling restart --------------------------------------------

    def drain(self, replica: int, timeout: float = 30.0) -> Dict[str, Any]:
        """Stop admitting to one replica and wait for its in-flight work.
        Routing avoids it at once; a 1-replica pool parks arrivals until
        :meth:`resume`."""
        r = self._replicas[replica]
        if not self._transition(r, (HEALTHY, DRAINING, DEAD), DRAINING):
            return {
                "replica": replica,
                "drained": False,
                "skipped": "rebuild in flight",
                "n_queued": r.batcher.n_queued,
                "n_active": r.batcher.n_active,
            }
        drained = r.batcher.drain(timeout)
        DEFAULT_REGISTRY.counter("pool_drains").inc()
        return {
            "replica": replica,
            "drained": drained,
            "n_queued": r.batcher.n_queued,
            "n_active": r.batcher.n_active,
        }

    def resume(self, replica: int, rebuild: bool = False) -> Dict[str, Any]:
        """Re-open a drained replica, in place or as a fresh batcher (the
        hot-restart path); CAS-gated against the monitor's rebuild."""
        r = self._replicas[replica]
        if rebuild or not r.batcher.worker_alive:
            if not self._transition(r, (HEALTHY, DRAINING, DEAD), REBUILDING):
                return {
                    "replica": replica,
                    "state": r.state,
                    "generation": r.generation,
                    "skipped": "rebuild already in flight",
                }
            try:
                self._rebuild_replica(r)
            except Exception:
                self._transition(r, (REBUILDING,), DEAD)
                raise
        else:
            r.batcher.resume()
            self._transition(r, (DRAINING, HEALTHY), HEALTHY)
        return {"replica": replica, "state": r.state, "generation": r.generation}

    def rolling_restart(self, timeout_per_replica: float = 30.0) -> Dict[str, Any]:
        """Drain -> rebuild -> resume each replica in turn: in-flight work
        finishes on its replica, arrivals route around (or park)."""
        steps = []
        for i in range(self.n_replicas):
            step = self.drain(i, timeout=timeout_per_replica)
            self.resume(i, rebuild=True)
            step["rebuilt"] = True
            steps.append(step)
        DEFAULT_REGISTRY.counter("pool_rolling_restarts").inc()
        return {"replicas": steps, "ok": all(s["drained"] for s in steps)}

    # ---- status / compat surface --------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r.batcher.n_active for r in self._replicas)

    @property
    def n_queued(self) -> int:
        with self._lock:
            parked = len(self._pending)
        return parked + sum(r.batcher.n_queued for r in self._replicas)

    def stats(self) -> collections.Counter:
        """Work counts of every batcher this pool ran, rebuilt and retired
        ones included (``verify_steps``, ``decode_steps``, ``warmup_steps``,
        ``admissions``, ``preempted``, ...)."""
        out = collections.Counter(self._retired_stats)
        for b in [r.batcher for r in self._replicas] + list(self._zombies):
            out.update(b.stats)
        return out

    def kv_block_occupancy(self) -> Dict[str, float]:
        """Pool-wide KV block occupancy: counts and bytes summed over
        replicas, block size and bytes per token config-wide."""
        out: Dict[str, float] = {}
        for r in self._replicas:
            occ = r.batcher.kv_block_occupancy()
            for key in (
                "blocks_total", "blocks_used", "pool_bytes", "used_bytes",
                "tokens_committed", "prefix_entries", "prefix_blocks",
                "prefix_hits", "prefix_misses", "prefix_tokens_avoided",
            ):
                if key in occ:
                    out[key] = out.get(key, 0) + occ[key]
            out["block_size"] = occ["block_size"]
            out["bytes_per_token"] = occ["bytes_per_token"]
        if out.get("blocks_total"):
            out["utilization"] = out["blocks_used"] / out["blocks_total"]
        lookups = out.get("prefix_hits", 0) + out.get("prefix_misses", 0)
        if lookups:
            out["prefix_hit_rate"] = round(out["prefix_hits"] / lookups, 4)
        return out

    def block_seconds(self) -> Dict[str, float]:
        out = {"total": 0.0, "billed": 0.0, "residual": 0.0}
        for r in self._replicas:
            bs = r.batcher.block_seconds()
            for k in out:
                out[k] += bs[k]
        return out

    def pressure_by_class(self) -> Dict[str, Any]:
        """Per-class KV blocks / lanes / queue slots summed over replicas
        plus the pending park (lock-free, like the batcher's)."""
        by: Dict[str, Dict[str, int]] = {}
        out: Dict[str, Any] = {"by_class": by, "free_blocks": 0, "blocks_total": 0}
        for r in self._replicas:
            snap = r.batcher.pressure_by_class()
            for cls, row in snap.get("by_class", {}).items():
                dst = by.setdefault(cls, {"kv_blocks": 0, "lanes": 0, "queued": 0})
                for k in ("kv_blocks", "lanes", "queued"):
                    dst[k] += row.get(k, 0)
            out["free_blocks"] += snap.get("free_blocks", 0)
            out["blocks_total"] += snap.get("blocks_total", 0)
            if "prefix_cache_blocks" in snap:
                out["prefix_cache_blocks"] = (
                    out.get("prefix_cache_blocks", 0) + snap["prefix_cache_blocks"]
                )
        try:
            parked = list(self._pending)
        except RuntimeError:  # deque mutated mid-iteration (lock-free)
            parked = []
        for req in parked:
            cls = request_class(req)
            by.setdefault(cls, {"kv_blocks": 0, "lanes": 0, "queued": 0})["queued"] += 1
        return out

    def preemption_candidates(
        self, pressure_cls: str = "interactive"
    ) -> List[Dict[str, Any]]:
        """Pool-wide dry run: what KV preemption would evict for a
        ``pressure_cls`` request right now, in every mode."""
        out: List[Dict[str, Any]] = []
        for r in self._replicas:
            for row in r.batcher.preemption_candidates(pressure_cls):
                out.append({"replica": r.idx, **row})
        return out

    def set_slo_probe(self, probe) -> None:
        """Wire the burn-rate probe (callable -> names of firing SLOs) into
        the pool and every replica; rebuilt replicas inherit it."""
        self._slo_probe = probe
        for r in self._replicas:
            r.batcher.set_slo_probe(probe)

    def _slo_firing(self) -> List[str]:
        if self._slo_probe is None:
            return []
        try:
            return list(self._slo_probe() or [])
        except Exception as e:
            if is_device_fault(e):
                raise
            return []

    def annotate_costs(self) -> bool:
        """Register the analytic cost models with the observatory: every
        replica runs the same shapes, so replica 0's are every replica's."""
        return self._replicas[0].batcher.annotate_costs()

    def qos_status(self) -> Dict[str, Any]:
        """Policy config, the live burn/deferral view and per-class queue
        depths summed over replicas."""
        if self.qos is None:
            return {"enabled": False}
        firing = self._slo_firing()
        out = self.qos.status()
        out["slo_firing"] = firing
        out["defer_active"] = self.qos.should_defer("batch", firing)
        queued: Dict[str, int] = {}
        for r in self._replicas:
            for cls, n in r.batcher.qos_status().get("queued_by_class", {}).items():
                queued[cls] = queued.get(cls, 0) + n
        out["queued_by_class"] = queued
        return out

    def status(self) -> Dict[str, Any]:
        with self._lock:
            parked = len(self._pending)
        return {
            "qos": self.qos_status(),
            "replicas": [
                {
                    "replica": r.idx,
                    "state": r.state,
                    "generation": r.generation,
                    "worker_alive": r.batcher.worker_alive,
                    "heartbeat_age_s": round(r.batcher.heartbeat_age_s, 3),
                    "n_queued": r.batcher.n_queued,
                    "n_active": r.batcher.n_active,
                    "breaker": r.breaker.state,
                    "routed": r.routed,
                    "deaths": r.deaths,
                    "canary_ok": r.canary_ok,
                    "canary_failed": r.canary_failed,
                }
                for r in self._replicas
            ],
            "pending": parked,
            "hedge": {
                "enabled": self.hedge_enabled,
                "delay_s": round(self.hedge_delay_s(), 3),
                "samples": len(self._lat),
            },
        }

    def stop(self) -> None:
        # _stopped first: it gates _tick (no rebuild starts under teardown)
        # and the park flush's put-back
        with self._lock:
            self._stopped = True
            self._cv.notify_all()
        self._monitor_stop.set()
        if self._monitor.ident is not None:
            self._monitor.join(timeout=30)
        if self._monitor.is_alive():
            log.warning("pool monitor still alive after stop() join")
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            if not req.done.is_set():
                req.error = RuntimeError("pool stopped")
                _finish(req)
        for r in self._replicas:
            try:
                r.batcher.stop()
            except Exception:
                log.exception("replica %d stop failed", r.idx)
        for t in self._warmups:
            t.join(timeout=60)
        for old in list(self._zombies):
            old._worker.join(timeout=10)
        self._reap_zombies()
