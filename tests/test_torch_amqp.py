"""Port parity, the AMQP broker: docqa_tpu_torch's ``AmqpBroker`` held
against docqa_tpu's, call for call, over one in-memory pika stand-in.

Neither pika nor a RabbitMQ server is on the test host or the card's
machine, so the stand-in below reproduces the AMQP semantics the adapter
relies on: durable queue declare (passive declares report message counts),
``basic_get`` / ``basic_ack`` with server delivery tags, per-message
headers.  Each side gets its own stand-in instance; after the same calls
the return values, the deliveries (tags, bodies, attempts, caller headers)
and the servers' queues must be equal (the ``x-ready-at`` timestamps
aside, which read the clock).
"""

import collections
import threading
import time
from types import SimpleNamespace

import pytest

from docqa_tpu.config import BrokerConfig as JBrokerConfig
from docqa_tpu.service import broker as jbroker
from docqa_tpu_torch.config import BrokerConfig
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.service import broker as tbroker


class _FakeChannel:
    def __init__(self, server):
        self.server = server

    def basic_qos(self, prefetch_count):
        self.server.prefetch = prefetch_count

    def queue_declare(self, queue, durable=False, passive=False):
        if passive and queue not in self.server.queues:
            raise KeyError(queue)
        q = self.server.queues.setdefault(queue, collections.deque())
        self.server.declared.add((queue, durable))
        return SimpleNamespace(method=SimpleNamespace(message_count=len(q)))

    def basic_publish(self, exchange, routing_key, body, properties=None):
        self.server.published.append(getattr(properties, "delivery_mode", None))
        self.server.queues.setdefault(routing_key, collections.deque()).append(
            (body, dict(getattr(properties, "headers", None) or {}))
        )

    def basic_get(self, queue):
        q = self.server.queues.setdefault(queue, collections.deque())
        if not q:
            return None, None, None
        body, headers = q.popleft()
        self.server.tag += 1
        self.server.unacked[self.server.tag] = (queue, body, headers)
        return (SimpleNamespace(delivery_tag=self.server.tag),
                SimpleNamespace(headers=headers), body)

    def basic_ack(self, tag):
        self.server.unacked.pop(tag, None)


class _FakeConnection:
    def __init__(self, params):
        self.server = params.server
        self.closed = False

    def channel(self):
        return _FakeChannel(self.server)

    def close(self):
        self.closed = True
        self.server.closed = True


class FakePika:
    """Module-shaped stand-in: one in-memory 'server' per instance."""

    def __init__(self):
        self.server = SimpleNamespace(queues={}, unacked={}, tag=0, declared=set(),
                                      published=[], prefetch=None, closed=False)

    def ConnectionParameters(self, host, port):
        self.server.address = (host, port)
        return SimpleNamespace(host=host, port=port, server=self.server)

    def BlockingConnection(self, params):
        return _FakeConnection(params)

    def BasicProperties(self, delivery_mode=None, headers=None):
        return SimpleNamespace(delivery_mode=delivery_mode, headers=headers)


CFG = dict(max_redelivery=3, prefetch=4, retry_backoff_s=0.05)


def _pair(**cfg):
    cfg = {**CFG, **cfg}
    jp, tp = FakePika(), FakePika()
    return (jbroker.AmqpBroker(JBrokerConfig(**cfg), pika_module=jp), jp,
            tbroker.AmqpBroker(BrokerConfig(**cfg), pika_module=tp), tp)


def _server_state(pika):
    s = pika.server

    def strip(headers):
        return {k: v for k, v in headers.items() if k != "x-ready-at"}

    return {
        "queues": {q: [(b, strip(h)) for b, h in d] for q, d in s.queues.items()},
        "ready_at_set": {q: [h.get("x-ready-at", 0.0) > 0 for _b, h in d]
                         for q, d in s.queues.items()},
        "unacked": sorted(s.unacked), "declared": sorted(s.declared),
        "published": s.published, "prefetch": s.prefetch,
        "address": s.address, "closed": s.closed,
    }


def _deliveries(ds):
    return [(d.queue, d.tag, d.body, d.attempts, d.headers) for d in ds]


def _script(broker):
    """The reference's contract cases in one sequence; every observable
    result in order."""
    out = []
    trace = {"x-trace-id": "t-1", "x-parent-span": "s-9"}
    out.append(broker.publish("q", {"n": 1}, headers=trace))
    out.append(broker.publish("q", {"n": 2}))
    out.append(broker.depth("q"))
    got = broker.get_many("q", max_n=4)
    out.append(_deliveries(got))
    out.append(broker.in_flight("q"))
    broker.ack(got[1])
    # a nack requeues with the attempt header bumped and a backoff
    out.append(broker.nack(got[0]))
    out.append(broker.get_many("q"))  # still backing off: nothing
    out.append(broker.depth("q"))
    redelivered = broker.get_many("q", timeout=5)
    out.append(_deliveries(redelivered))  # attempts 2, trace headers kept
    # to the dead letters: attempts 2 -> 3 -> dead
    out.append(broker.nack(redelivered[0]))
    last = broker.get_many("q", timeout=5)
    out.append(_deliveries(last))
    out.append(broker.nack(last[0]))
    out.append(broker.dead_letters("q"))
    out.append((broker.depth("q"), broker.depth("q.dlq"), broker.in_flight("q")))
    # no requeue: dead-lettered at once
    broker.publish("r", {"bad": 1})
    out.append(broker.nack(broker.get_many("r")[0], requeue=False))
    out.append((broker.dead_letters("r"), broker.depth("r.dlq")))
    # prefetch caps a pull; an empty queue times out
    for i in range(6):
        broker.publish("b", {"i": i})
    out.append(_deliveries(broker.get_many("b")))
    t0 = time.monotonic()
    out.append(broker.get_many("empty", timeout=0.15))
    out.append(time.monotonic() - t0 >= 0.1)
    out.append(broker.drain("empty", timeout=1))
    out.append(broker.drain("b", timeout=0.2))  # four in flight: not drained
    return out


def test_contract_script_equals_reference():
    jb, jp, tb, tp = _pair()
    try:
        assert _script(tb) == _script(jb)
        assert _server_state(tp) == _server_state(jp)
        # persistent messages on durable queues, as the reference services
        assert set(tp.server.published) == {2}
        assert all(durable for _q, durable in tp.server.declared)
    finally:
        jb.close()
        tb.close()
    assert tp.server.closed and jp.server.closed


def test_backoff_republish_keeps_caller_headers():
    """A message still in its backoff is pushed to the back of the queue on
    every pull, with its caller headers (trace ids), on both sides."""
    jb, jp, tb, tp = _pair(retry_backoff_s=0.3)
    for b in (jb, tb):
        b.publish("q", {"x": 1}, headers={"x-trace-id": "abc"})
        b.nack(b.get_many("q")[0])
        for _ in range(3):
            assert b.get_many("q") == []
        d = b.get_many("q", timeout=5)[0]
        assert (d.attempts, d.headers) == (2, {"x-trace-id": "abc"})
        b.ack(d)
    assert _server_state(tp) == _server_state(jp)


def test_drain_waits_for_the_ack():
    _jb, _jp, tb, _tp = _pair()
    tb.publish("q", {"a": 1})

    def worker():
        d = tb.get_many("q", timeout=5)[0]
        time.sleep(0.05)
        tb.ack(d)

    t = threading.Thread(target=worker)
    t.start()
    assert tb.drain("q", timeout=5)
    t.join()


def test_missing_pika_raises_as_the_reference(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "pika", None)  # any import raises
    with pytest.raises(RuntimeError) as mine:
        tbroker.AmqpBroker(BrokerConfig())
    with pytest.raises(RuntimeError) as ref:
        jbroker.AmqpBroker(JBrokerConfig())
    assert str(mine.value) == str(ref.value)
    assert "requires pika" in str(mine.value)


def test_make_broker_returns_amqp_and_ignores_the_journal(monkeypatch, tmp_path):
    import sys

    fake = FakePika()
    monkeypatch.setitem(sys.modules, "pika", fake)
    b = tbroker.make_broker(BrokerConfig(backend="amqp", amqp_host="mq", amqp_port=5673),
                            journal_dir=str(tmp_path / "journal"))
    try:
        assert isinstance(b, tbroker.AmqpBroker)
        assert fake.server.address == ("mq", 5673)
        assert not (tmp_path / "journal").exists()
    finally:
        b.close()


def test_consumer_loop_over_amqp_equals_reference():
    """The pipeline's consumer drives either AmqpBroker as a MemoryBroker:
    the batches, a poison message isolated and dead-lettered."""

    def run(mod, b):
        seen, dead = [], []

        def handler(bodies):
            if any(x.get("poison") for x in bodies):
                raise ValueError("poison")
            seen.extend(bodies)

        c = mod.Consumer(b, "jobs", handler, batch=4, poll_s=0.02,
                         on_dead=dead.append, name="amqp-test")
        for i in range(6):
            b.publish("jobs", {"i": i, "poison": i == 2})
        c.start()
        try:
            deadline = time.time() + 20
            while (len(seen) < 5 or not dead) and time.time() < deadline:
                time.sleep(0.01)
        finally:
            c.stop()
        return sorted(x["i"] for x in seen), dead, b.dead_letters("jobs"), b.depth("jobs.dlq")

    jb, _jp, tb, _tp = _pair(retry_backoff_s=0.01)
    try:
        assert run(tbroker, tb) == run(jbroker, jb) == (
            [0, 1, 3, 4, 5], [{"i": 2, "poison": True}], [{"i": 2, "poison": True}], 1)
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("fault", [
    KernelError("qmatmul int8 kernel launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_a_device_fault_passes_the_consumer_over_amqp(fault):
    """A device fault is never retried, nacked, republished or
    dead-lettered over AMQP: the consumer keeps it, hands it on and stops,
    and the batch stays unacked on the server."""
    _jb, _jp, tb, tp = _pair()
    faults_seen, calls = [], []

    def handler(bodies):
        calls.append(list(bodies))
        raise fault

    c = tbroker.Consumer(tb, "jobs", handler, batch=4, poll_s=0.02,
                         on_fault=faults_seen.append, name="amqp-fault")
    for i in range(3):
        tb.publish("jobs", {"i": i})
    published = len(tp.server.published)
    c.start()
    c.join(timeout=20)
    try:
        assert not c.is_alive()
        assert c.error is fault and faults_seen == [fault]
        assert calls == [[{"i": 0}, {"i": 1}, {"i": 2}]]
        assert len(tp.server.unacked) == 3 and tb.in_flight("jobs") == 3
        assert len(tp.server.published) == published  # nothing republished
        assert tb.dead_letters("jobs") == [] and tb.depth("jobs.dlq") == 0
    finally:
        tb.close()


def test_runtime_boots_on_amqp(monkeypatch):
    """``broker.backend="amqp"`` boots the runtime (no refusal any more)
    with its pipeline on the AMQP broker: an upload reaches INDEXED through
    the stand-in server's two queues."""
    import sys

    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import DocQARuntime, refuse_unported

    fake = FakePika()
    monkeypatch.setitem(sys.modules, "pika", fake)
    cfg = load_config(env={}, overrides={
        "broker.backend": "amqp", "ner.train_steps": 0, "ner.hidden_dim": 32,
        "ner.num_layers": 1, "ner.num_heads": 2, "ner.mlp_dim": 64,
        "encoder.hidden_dim": 64, "encoder.num_layers": 1, "encoder.num_heads": 4,
        "encoder.mlp_dim": 128, "encoder.embed_dim": 64, "store.dim": 64,
        "store.shard_capacity": 256, "decoder.hidden_dim": 64,
        "decoder.num_layers": 1, "decoder.num_heads": 4, "decoder.num_kv_heads": 2,
        "decoder.head_dim": 16, "decoder.mlp_dim": 128, "decoder.vocab_size": 512,
        "decoder.max_seq_len": 256, "decoder.dtype": "float32",
        "generate.max_new_tokens": 4, "generate.prefill_buckets": (128,),
        "telemetry.enabled": False, "retrieval_quality.enabled": False,
    })
    refuse_unported(cfg)
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        assert isinstance(rt.broker, tbroker.AmqpBroker)
        rec = rt.pipeline.ingest_document(
            "note.txt", b"the patient was admitted with chest pain", patient_id="p1")
        assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
        assert {q for q, _d in fake.server.declared} >= {
            cfg.broker.raw_queue, cfg.broker.clean_queue}
        assert fake.server.unacked == {}
    finally:
        rt._warmup_thread.join(60)
        rt.stop()
