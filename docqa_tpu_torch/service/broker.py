"""Service-plane message bus, counterpart of ``docqa_tpu/service/broker.py``
(``Delivery``, ``MemoryBroker`` with its journal, ``Consumer``,
``AmqpBroker`` over pika, ``make_broker``).

Replaces the reference's RabbitMQ deployment (`doc-ingestor/processing.py:21-44`,
`deid-service/anonymizer.py:89-110`, `semantic-indexer/indexer.py:131-143`)
while keeping its *semantics* — durable queues, persistent messages, manual
ack, at-least-once redelivery — and fixing its defects:

* poison messages were nacked without requeue, i.e. silently dropped
  (`anonymizer.py:83-87`, `indexer.py:129`): here a message that exceeds
  ``max_redelivery`` attempts moves to a per-queue dead-letter queue instead;
* ``prefetch_count=1`` forced strictly serial handling (`anonymizer.py:97`,
  `indexer.py:135`): here consumers pull *batches* so the device plane can
  batch-encode/batch-tag them (BASELINE config 2: batch=32);
* durability lived in an external Erlang broker: here an optional append-only
  journal (one JSONL per queue, replayed minus acks on restart) gives the
  same crash-resume story in-process.

``MemoryBroker`` is the single-host backend; ``AmqpBroker`` adapts the
same interface onto pika for multi-host deployments.  One rule the reference does
not have: a kernel or CUDA fault (``ops/_kernels.is_device_fault``) raised
by a handler is never retried, nacked, dead-lettered or recorded on a
breaker; the consumer keeps it, hands it to ``on_fault`` and stops (the
card's context may be poisoned, so no later batch could be trusted).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from docqa_tpu_torch.config import BrokerConfig
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience import breaker as _breaker
from docqa_tpu_torch.resilience import faults
from docqa_tpu_torch.runtime.metrics import get_logger

log = get_logger("docqa.broker")


@dataclass
class Delivery:
    """One in-flight message: ack or nack it via the broker.

    ``headers`` carry message metadata OUTSIDE the payload — trace
    propagation (the reference's obs headers ``x-trace-id`` /
    ``x-parent-span``; this port carries them untouched) rides
    here, and the broker preserves them through every redelivery hop
    (nack→backoff requeue, journal replay, dead-lettering), so a
    document's ingest→deid→index stays one linked timeline no matter how
    many retries it took."""

    queue: str
    tag: int
    body: Dict[str, Any]
    attempts: int  # 1 on first delivery
    headers: Dict[str, Any] = field(default_factory=dict)


class _Queue:
    def __init__(self) -> None:
        # pending entries: (tag, body, attempts, ready_at, headers)
        self.pending: collections.deque = collections.deque()
        self.unacked: Dict[int, tuple] = {}
        self.dead: List[Dict[str, Any]] = []


class MemoryBroker:
    """Thread-safe in-process broker with at-least-once delivery."""

    def __init__(
        self,
        cfg: Optional[BrokerConfig] = None,
        journal_dir: Optional[str] = None,
    ) -> None:
        self.cfg = cfg or BrokerConfig()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues: Dict[str, _Queue] = {}
        self._next_tag = 1
        self._journal_dir = journal_dir
        self._journals: Dict[str, Any] = {}
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
            self._replay()

    # ---- journal (crash durability) -----------------------------------------

    def _journal_path(self, queue: str) -> str:
        assert self._journal_dir is not None
        return os.path.join(self._journal_dir, f"{queue}.jsonl")

    def _journal_write(self, queue: str, record: Dict[str, Any]) -> None:
        if not self._journal_dir:
            return
        f = self._journals.get(queue)
        if f is None:
            f = open(self._journal_path(queue), "a", encoding="utf-8")
            self._journals[queue] = f
        f.write(json.dumps(record) + "\n")
        f.flush()
        os.fsync(f.fileno())

    def _replay(self) -> None:
        """Rebuild queue state: published minus acked/dead, then compact.
        Message headers (trace ids) replay with their bodies — a crash
        must not unlink a document's timeline."""
        assert self._journal_dir is not None
        # sorted: listdir order is filesystem-dependent, and replay order
        # must be identical on every host (docqa-detcheck order-stability)
        for name in sorted(os.listdir(self._journal_dir)):
            if not name.endswith(".jsonl"):
                continue
            queue = name[: -len(".jsonl")]
            alive: Dict[int, tuple] = {}  # tag -> (body, headers)
            dead: List[tuple] = []  # (tag, body, headers) — tags kept so compaction can re-journal them
            with open(os.path.join(self._journal_dir, name), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    if rec["op"] == "pub":
                        alive[rec["tag"]] = (
                            rec["body"], rec.get("headers") or {}
                        )
                    elif rec["op"] == "ack":
                        alive.pop(rec["tag"], None)
                    elif rec["op"] == "dlq":
                        entry = alive.pop(rec["tag"], None)
                        if entry is not None:
                            dead.append((rec["tag"], entry[0], entry[1]))
            q = self._queues.setdefault(queue, _Queue())
            q.dead.extend(body for _, body, _h in dead)
            # compact: rewrite still-alive publications AND dead letters (as
            # pub+dlq pairs) — dead letters must survive any number of restarts
            tmp = self._journal_path(queue) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                # sorted by tag == publish order: the compacted journal
                # and the rebuilt pending queue must not depend on dict
                # insertion history (tags are monotonic, so this is also
                # exactly the original delivery order)
                for tag, (body, headers) in sorted(alive.items()):
                    f.write(json.dumps(
                        {"op": "pub", "tag": tag, "body": body,
                         "headers": headers}
                    ) + "\n")
                for tag, body, headers in dead:
                    f.write(json.dumps(
                        {"op": "pub", "tag": tag, "body": body,
                         "headers": headers}
                    ) + "\n")
                    f.write(json.dumps({"op": "dlq", "tag": tag}) + "\n")
            os.replace(tmp, self._journal_path(queue))
            for tag, (body, headers) in sorted(alive.items()):
                q.pending.append((tag, body, 0, 0.0, headers))
                self._next_tag = max(self._next_tag, tag + 1)
            for tag, _b, _h in dead:
                self._next_tag = max(self._next_tag, tag + 1)
            if alive or dead:
                log.info(
                    "broker replay %s: %d requeued, %d dead", queue, len(alive), len(dead)
                )

    # ---- core API ------------------------------------------------------------

    def publish(
        self,
        queue: str,
        body: Dict[str, Any],
        headers: Optional[Dict[str, Any]] = None,
    ) -> int:
        # resilience_site: broker.publish — an injected raise HERE (before
        # the journal write) models a dropped broker connection: nothing
        # was enqueued, the caller's RetryPolicy re-publishes
        faults.perturb("broker.publish")
        headers = headers or {}
        with self._cv:
            tag = self._next_tag
            self._next_tag += 1
            self._journal_write(
                queue,
                {"op": "pub", "tag": tag, "body": body, "headers": headers},
            )
            self._queues.setdefault(queue, _Queue()).pending.append(
                (tag, body, 0, 0.0, headers)
            )
            self._cv.notify_all()
            return tag

    def get(self, queue: str, timeout: Optional[float] = None) -> Optional[Delivery]:
        out = self.get_many(queue, 1, timeout)
        return out[0] if out else None

    def get_many(
        self, queue: str, max_n: Optional[int] = None, timeout: Optional[float] = None
    ) -> List[Delivery]:
        """Pull up to ``max_n`` (default: prefetch) messages; blocks up to
        ``timeout`` for the *first* message, then drains what's there."""
        max_n = max_n or self.cfg.prefetch
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            q = self._queues.setdefault(queue, _Queue())

            def ready_now():
                now = time.monotonic()
                return [e for e in q.pending if e[3] <= now]

            while True:
                ready = ready_now()
                if ready:
                    break
                # wake early if a backed-off message becomes ready
                next_ready = min((e[3] for e in q.pending), default=None)
                now = time.monotonic()
                waits = []
                if deadline is not None:
                    if deadline - now <= 0:
                        return []
                    waits.append(deadline - now)
                if next_ready is not None:
                    waits.append(max(next_ready - now, 0.001))
                if not waits:
                    return []
                self._cv.wait(min(waits))
            out: List[Delivery] = []
            for entry in ready[:max_n]:
                q.pending.remove(entry)
                tag, body, attempts, _, headers = entry
                attempts += 1
                q.unacked[tag] = (body, attempts, headers)
                out.append(
                    Delivery(queue, tag, body, attempts, headers=headers)
                )
            return out

    def ack(self, delivery: Delivery) -> None:
        with self._cv:
            q = self._queues[delivery.queue]
            if q.unacked.pop(delivery.tag, None) is not None:
                self._journal_write(delivery.queue, {"op": "ack", "tag": delivery.tag})

    def nack(self, delivery: Delivery, requeue: bool = True) -> bool:
        """Failed handling: requeue with exponential backoff, or dead-letter
        after ``max_redelivery`` attempts (the reference dropped these).
        Returns True if the message was dead-lettered."""
        with self._cv:
            q = self._queues[delivery.queue]
            entry = q.unacked.pop(delivery.tag, None)
            if entry is None:
                return False
            body, attempts, headers = entry
            if requeue and attempts < self.cfg.max_redelivery:
                # backoff so transient failures (device busy, downstream
                # hiccup) don't burn every attempt within milliseconds;
                # headers (trace ids) ride every redelivery hop
                delay = self.cfg.retry_backoff_s * (2 ** (attempts - 1))
                q.pending.appendleft(
                    (
                        delivery.tag, body, attempts,
                        time.monotonic() + delay, headers,
                    )
                )
                self._cv.notify_all()
                return False
            self._journal_write(delivery.queue, {"op": "dlq", "tag": delivery.tag})
            q.dead.append(body)
            log.warning(
                "dead-lettered message from %s after %d attempts",
                delivery.queue,
                attempts,
            )
            return True

    # ---- introspection -------------------------------------------------------

    def depth(self, queue: str) -> int:
        with self._lock:
            q = self._queues.get(queue)
            return len(q.pending) if q else 0

    def in_flight(self, queue: str) -> int:
        with self._lock:
            q = self._queues.get(queue)
            return len(q.unacked) if q else 0

    def dead_letters(self, queue: str) -> List[Dict[str, Any]]:
        with self._lock:
            q = self._queues.get(queue)
            return list(q.dead) if q else []

    def drain(self, queue: str, timeout: float = 10.0) -> bool:
        """Block until the queue is empty and fully acked (test/shutdown aid —
        the reference UI faked this with a 5 s sleep, ``app.py:55-58``)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                q = self._queues.get(queue)
                if q is None or (not q.pending and not q.unacked):
                    return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        # under the broker lock: a consumer mid-nack may be appending a
        # journal record on another thread — closing its file underneath
        # it turns an orderly shutdown into a ValueError inside the
        # journal write (guarded-state, PR 8)
        with self._lock:
            for f in self._journals.values():
                f.close()
            self._journals.clear()


class Consumer(threading.Thread):
    """Pull-loop worker: batches messages to a handler, acks on success.

    On a batch failure the messages are retried *individually*, so one
    poison message cannot drag its batch-mates into the DLQ with it.

    Handler contract (what makes that retry safe): a handler that RAISES must
    have produced no external side effects for any message in the batch —
    i.e. do all fallible pure work (device batches, parsing) first, and once
    side effects (publishes, store appends, status writes) begin, handle
    per-message failures internally (record a terminal status) instead of
    raising.  Otherwise the individual retry would replay the already
    side-effected prefix (duplicate publishes / duplicate vectors).

    Resilience: an optional ``retry``
    (:class:`~docqa_tpu_torch.resilience.policy.RetryPolicy`) retries the handler
    *in place* with jittered backoff before any nack — transient failures
    (device busy, downstream hiccup) never touch the redelivery budget.
    The same handler contract makes this safe.  An optional ``breaker``
    (:class:`~docqa_tpu_torch.resilience.breaker.CircuitBreaker`) is fed every
    outcome; while OPEN the consumer *pauses pulling* — messages wait in
    the queue for the dependency's recovery window instead of burning
    their redelivery attempts into the DLQ (the pre-resilience behavior:
    nack-until-dead-letter was the ONLY failure path).

    When a message is finally dead-lettered, ``on_dead`` fires so the owner
    can record a terminal error status.  Replaces the reference's per-service
    ``start_consuming`` loops with their reconnect boilerplate
    (``anonymizer.py:89-110``).

    A device fault (``is_device_fault``) from the handler skips all of the
    above: the consumer stores it in ``error``, calls ``on_fault(exc)``
    and stops; the batch stays unacked."""

    def __init__(
        self,
        broker: MemoryBroker,
        queue: str,
        handler: Callable[[List[Dict[str, Any]]], None],
        batch: Optional[int] = None,
        poll_s: float = 0.1,
        name: Optional[str] = None,
        on_dead: Optional[Callable[[Dict[str, Any]], None]] = None,
        retry=None,  # resilience.RetryPolicy: in-place handler retries
        breaker=None,  # resilience.CircuitBreaker: pause pulls while open
        pass_headers: bool = False,  # handler(bodies, headers) + on_dead
        # (body, headers): trace headers ride without touching payloads —
        # the pipeline's consumers opt in
        on_fault: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        super().__init__(daemon=True, name=name or f"consumer-{queue}")
        self.broker = broker
        self.queue = queue
        self.handler = handler
        self.batch = batch
        self.poll_s = poll_s
        self.on_dead = on_dead
        self.retry = retry
        self.breaker = breaker
        self.pass_headers = pass_headers
        self.on_fault = on_fault
        self.error: Optional[BaseException] = None  # the device fault
        self._stopped = threading.Event()

    def stop(self, join: bool = True) -> None:
        self._stopped.set()
        if join and self.is_alive():  # stop() before start() is a no-op
            self.join(timeout=5)

    def _nack(self, delivery: Delivery) -> None:
        if self.broker.nack(delivery, requeue=True) and self.on_dead:
            try:
                if self.pass_headers:
                    self.on_dead(delivery.body, delivery.headers)
                else:
                    self.on_dead(delivery.body)
            except Exception:
                log.exception("on_dead callback failed for %s", self.queue)

    def _handle(
        self,
        bodies: List[Dict[str, Any]],
        headers: Optional[List[Dict[str, Any]]] = None,
        use_breaker: bool = True,
    ) -> None:
        """One handler invocation under the retry policy (+ breaker).

        The breaker wraps the WHOLE retried invocation, not each inner
        attempt: one batch delivery records one failure.  The one-by-one
        isolation replay then refines it with per-MESSAGE outcomes (fed
        directly in ``run``): a poison message in a healthy batch records
        one failure surrounded by successes — consecutive count resets,
        the circuit never trips — while an outage fails every message and
        crosses the threshold within the first round or two of batches.
        A queue receiving only single-message deliveries is the
        fundamentally ambiguous case (one failure per round looks
        identical for poison and outage); there the DLQ path still
        terminates poison, and the breaker engages only for outages that
        outlast several deliveries.

        ``use_breaker=False`` is the poison-isolation mode: the replay
        must not GATE on the circuit (an open breaker must not nack the
        healthy batch-mates with BreakerOpen, burning their redelivery
        budget)."""

        if self.pass_headers:
            hdrs = headers if headers is not None else [{} for _ in bodies]

            def invoke() -> None:
                self.handler(bodies, hdrs)
        else:

            def invoke() -> None:
                self.handler(bodies)

        def attempt() -> None:
            if self.retry is not None:
                self.retry.call(invoke, name=f"consumer_{self.queue}")
            else:
                invoke()

        if not (use_breaker and self.breaker is not None):
            attempt()
            return
        # the breaker's call(), except that a device fault is not an outage
        # of the dependency: it passes without being recorded
        self.breaker.raise_if_open()
        try:
            attempt()
        except Exception as e:
            if not is_device_fault(e):
                self.breaker.record_failure()
            raise
        self.breaker.record_success()

    def run(self) -> None:
        try:
            self._loop()
        except Exception as e:
            if not is_device_fault(e):
                raise
            log.error("device fault in %s; the consumer stops: %r", self.queue, e)
            self.error = e
            self._stopped.set()
            if self.on_fault is not None:
                self.on_fault(e)

    def _loop(self) -> None:
        while not self._stopped.is_set():
            if (
                self.breaker is not None
                and self.breaker.state == _breaker.OPEN
            ):
                # dependency is in its recovery window: let messages WAIT
                # (they keep their redelivery budget) instead of pulling
                # them into guaranteed failures
                self._stopped.wait(self.poll_s)
                continue
            deliveries = self.broker.get_many(self.queue, self.batch, self.poll_s)
            if not deliveries:
                continue
            try:
                self._handle(
                    [d.body for d in deliveries],
                    [d.headers for d in deliveries],
                )
            except Exception as e:
                if is_device_fault(e):
                    raise
                log.exception(
                    "batch handler failed on %s (%d msgs); isolating",
                    self.queue,
                    len(deliveries),
                )
                if len(deliveries) == 1:
                    self._nack(deliveries[0])
                    continue
                # retry one-by-one so only the poison message pays — the
                # breaker never GATES here (see _handle), but it does see
                # per-message outcomes: successes reset the consecutive
                # count (poison in a healthy batch can't trip it), while
                # an outage failing every message crosses the threshold
                for d in deliveries:
                    try:
                        self._handle(
                            [d.body], [d.headers], use_breaker=False
                        )
                    except Exception as e:
                        if is_device_fault(e):
                            raise
                        if self.breaker is not None:
                            self.breaker.record_failure()
                        self._nack(d)
                    else:
                        if self.breaker is not None:
                            self.breaker.record_success()
                        self.broker.ack(d)
            else:
                for d in deliveries:
                    self.broker.ack(d)


class AmqpBroker:
    """The full MemoryBroker contract over RabbitMQ via pika (multi-host
    service planes).

    Mirrors the reference's wire usage — durable queue declare, persistent
    delivery (``processing.py:27,40``) — and adds what the reference lacked
    and MemoryBroker guarantees:

    * **attempt counting** rides an ``x-attempts`` header: a requeueing
      ``nack`` acks the original and republishes with the counter bumped
      (AMQP redelivery itself carries no attempt count);
    * **dead-lettering** after ``max_redelivery`` attempts publishes to a
      durable ``<queue>.dlq`` companion queue (the reference *dropped*
      poison messages, ``anonymizer.py:83-87``).  ``dead_letters()`` reports
      the bodies this instance dead-lettered (the durable copy lives in the
      DLQ queue for cross-process consumers);
    * **introspection** (``depth``/``in_flight``) and ``drain`` so the
      pipeline's completion signal works unchanged over AMQP.

    Held against the reference's adapter over an in-memory pika stand-in
    (``tests/test_torch_amqp.py``); ``pika`` is imported at construction
    only, which raises ``RuntimeError`` when it is missing (neither the
    test host nor the card's machine has it).  No ``except`` here catches
    more than that ``ImportError``: a device fault raised by a handler
    reaches the :class:`Consumer`, which stops on it.

    AMQP ops are funneled through one connection/channel guarded by a lock —
    pika's BlockingConnection is not thread-safe, and the pipeline's two
    consumers + HTTP publishers call concurrently.
    """

    def __init__(self, cfg: Optional[BrokerConfig] = None, pika_module=None) -> None:
        if pika_module is None:
            try:
                import pika as pika_module  # noqa: F811
            except ImportError as e:
                raise RuntimeError(
                    "AmqpBroker requires pika; install it or use MemoryBroker "
                    "(backend='memory')"
                ) from e
        self.cfg = cfg or BrokerConfig()
        self._pika = pika_module
        self._lock = threading.Lock()
        self._params = pika_module.ConnectionParameters(
            host=self.cfg.amqp_host, port=self.cfg.amqp_port
        )
        self._conn = pika_module.BlockingConnection(self._params)
        self._ch = self._conn.channel()
        self._ch.basic_qos(prefetch_count=self.cfg.prefetch)
        self._declared: set = set()
        self._in_flight: Dict[str, set] = {}
        self._dead: Dict[str, List[Dict[str, Any]]] = {}
        self._n_published = 0

    def _declare(self, queue: str) -> None:
        if queue not in self._declared:
            self._ch.queue_declare(queue=queue, durable=True)
            self._declared.add(queue)

    # broker-reserved header keys; everything else is caller metadata
    # (trace ids) that must survive every republish hop
    _RESERVED_HEADERS = ("x-attempts", "x-ready-at")

    def _publish_locked(
        self,
        queue: str,
        body: Dict[str, Any],
        attempts: int,
        ready_at: float = 0.0,
        headers: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._declare(queue)
        self._ch.basic_publish(
            exchange="",
            routing_key=queue,
            body=json.dumps(body),
            properties=self._pika.BasicProperties(
                delivery_mode=2,
                headers={
                    "x-attempts": attempts,
                    "x-ready-at": ready_at,
                    **(headers or {}),
                },
            ),
        )

    def publish(
        self,
        queue: str,
        body: Dict[str, Any],
        headers: Optional[Dict[str, Any]] = None,
    ) -> int:
        faults.perturb("broker.publish")  # resilience_site: broker.publish
        with self._lock:
            self._publish_locked(queue, body, 0, headers=headers)
            self._n_published += 1
            return self._n_published

    def get_many(
        self,
        queue: str,
        max_n: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> List[Delivery]:
        deadline = None if timeout is None else time.monotonic() + timeout
        max_n = max_n or self.cfg.prefetch
        while True:
            with self._lock:
                self._declare(queue)
                out: List[Delivery] = []
                # budget = queue depth at pass start: each message is popped
                # at most once per pass — a republished (backed-off) message
                # lands at the back, beyond the budget, so a queue of only
                # not-yet-ready messages costs one cycle per pass, not a
                # pop/republish spin
                depth0 = int(
                    self._ch.queue_declare(
                        queue=queue, durable=True, passive=True
                    ).method.message_count
                )
                for _ in range(depth0):
                    if len(out) >= max_n:
                        break
                    method, props, payload = self._ch.basic_get(queue)
                    if method is None:
                        break
                    headers = getattr(props, "headers", None) or {}
                    ready_at = float(headers.get("x-ready-at", 0.0))
                    attempts = int(headers.get("x-attempts", 0))
                    user_headers = {
                        k: v
                        for k, v in headers.items()
                        if k not in self._RESERVED_HEADERS
                    }
                    if ready_at > time.time():
                        # still in retry backoff: push it to the back,
                        # durably, and keep scanning (MemoryBroker parity —
                        # its pending entries carry a not-before timestamp).
                        # Caller headers MUST ride along: this republish
                        # used to reconstruct only the broker's own
                        # bookkeeping, silently stripping trace ids on
                        # every backoff hop.
                        self._publish_locked(
                            queue, json.loads(payload), attempts, ready_at,
                            headers=user_headers,
                        )
                        self._ch.basic_ack(method.delivery_tag)
                        continue
                    self._in_flight.setdefault(queue, set()).add(
                        method.delivery_tag
                    )
                    out.append(
                        Delivery(
                            queue,
                            method.delivery_tag,
                            json.loads(payload),
                            attempts + 1,
                            headers=user_headers,
                        )
                    )
                if out:
                    return out
            if deadline is None or time.monotonic() >= deadline:
                return []
            time.sleep(0.05)

    def ack(self, delivery: Delivery) -> None:
        with self._lock:
            self._ch.basic_ack(delivery.tag)
            self._in_flight.get(delivery.queue, set()).discard(delivery.tag)

    def nack(self, delivery: Delivery, requeue: bool = True) -> bool:
        """Requeue with the attempt header bumped, or dead-letter to
        ``<queue>.dlq`` after ``max_redelivery`` attempts.  Returns True if
        dead-lettered (MemoryBroker contract)."""
        with self._lock:
            self._in_flight.get(delivery.queue, set()).discard(delivery.tag)
            if requeue and delivery.attempts < self.cfg.max_redelivery:
                # exponential backoff via a durable not-before header, so a
                # transient failure doesn't burn every attempt within
                # milliseconds (MemoryBroker.nack parity); caller headers
                # (trace ids) are preserved through the hop
                delay = self.cfg.retry_backoff_s * (2 ** (delivery.attempts - 1))
                self._publish_locked(
                    delivery.queue,
                    delivery.body,
                    delivery.attempts,
                    ready_at=time.time() + delay,
                    headers=delivery.headers,
                )
                self._ch.basic_ack(delivery.tag)
                return False
            self._publish_locked(
                f"{delivery.queue}.dlq", delivery.body, 0,
                headers=delivery.headers,
            )
            self._ch.basic_ack(delivery.tag)
            self._dead.setdefault(delivery.queue, []).append(delivery.body)
            log.warning(
                "dead-lettered message from %s after %d attempts",
                delivery.queue,
                delivery.attempts,
            )
            return True

    # ---- introspection -------------------------------------------------------

    def depth(self, queue: str) -> int:
        with self._lock:
            self._declare(queue)
            method = self._ch.queue_declare(
                queue=queue, durable=True, passive=True
            )
            return int(method.method.message_count)

    def in_flight(self, queue: str) -> int:
        with self._lock:
            return len(self._in_flight.get(queue, ()))

    def dead_letters(self, queue: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._dead.get(queue, ()))

    def drain(self, queue: str, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.depth(queue) == 0 and self.in_flight(queue) == 0:
                return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def make_broker(cfg: Optional[BrokerConfig] = None, journal_dir: Optional[str] = None):
    """``AmqpBroker`` for ``backend="amqp"`` (which ignores ``journal_dir``:
    RabbitMQ's durable queues keep the messages), else ``MemoryBroker``."""
    cfg = cfg or BrokerConfig()
    if cfg.backend == "amqp":
        return AmqpBroker(cfg)
    return MemoryBroker(cfg, journal_dir=journal_dir)
