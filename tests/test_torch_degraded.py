"""Port parity, ``/ask``'s failure policy: docqa_tpu_torch's QAService over
an EnginePool against docqa_tpu's QAService on the same notes, store rows
and seeded weights (CPU, float32, 2 layers).

The response dicts must be EQUAL — a healthy answer with no ``degraded``
key, and the degraded extractive answer with its reason for a decoder
outage (``decoder_error``), an open decoder breaker
(``decoder_breaker_open``), too little budget (``insufficient_budget``) and
a replica dying with the request admitted (``replica_died``).  Greedy
answers are exact (float32 argmax); the degraded answer is the retrieved
chunks verbatim.

The port's one departure: a kernel that fails to build or launch, or a
CUDA error, propagates out of ``ask``.  It is not degraded, not recorded
on the decoder breaker, and the pool rebuilds nothing around it.
"""

import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.config import ResilienceConfig as JResilienceConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.pool import EnginePool as JEnginePool
from docqa_tpu.engines.retrieve import FusedRetriever as JFusedRetriever
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.resilience import BreakerBoard as JBreakerBoard
from docqa_tpu.resilience import Deadline as JDeadline
from docqa_tpu.resilience import FaultPlan as JFaultPlan
from docqa_tpu.resilience import FaultRule as JFaultRule
from docqa_tpu.runtime.metrics import DEFAULT_REGISTRY as J_REGISTRY
from docqa_tpu.service.qa import QAService as JQAService
from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    ResilienceConfig,
    StoreConfig,
)
from docqa_tpu_torch.engines import paged
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.router import extractive_answer
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.resilience import BreakerBoard, Deadline, FaultPlan, FaultRule
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY
from docqa_tpu_torch.service.qa import QAService

torch.set_num_threads(1)

ENC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
           mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
GEN = dict(max_new_tokens=10, prefill_buckets=(64, 128, 256))
STORE = dict(dim=64, shard_capacity=128)
SEED = 4
WAIT = 120
NOTES = [
    ("note-0.txt", "Metformine 500 mg deux fois par jour, diabète de type 2."),
    ("note-1.txt", "Allergie connue à la pénicilline, éruption cutanée."),
    ("note-2.txt", "Tension artérielle 150/95 mmHg au contrôle."),
    ("note-3.txt", "Lisinopril 10 mg par jour pour hypertension."),
]
QUESTION = "quelle est la dose de metformine ?"


@pytest.fixture(scope="module")
def parts():
    texts = [t for _, t in NOTES]
    meta = [{"source": s, "text_content": t} for s, t in NOTES]
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    jstore = JVectorStore(JStoreConfig(**STORE))
    jstore.add(jenc.encode_texts(texts), meta)
    jgen = JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN), seed=SEED)
    enc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    store = VectorStore(StoreConfig(**STORE), device="cpu")
    store.add(enc.encode_texts(texts), meta)
    gen = GenerateEngine(DecoderConfig(**DEC), GenerateConfig(**GEN), seed=SEED,
                         device="cpu")
    return jenc, jstore, jgen, enc, store, gen


def _pool(gen, **kw):
    return EnginePool(gen, replicas=kw.pop("replicas", 2), n_slots=2, chunk=4,
                      cache_len=512, canary_interval_s=600.0,
                      health_interval_s=0.05, device="cpu", **kw)


def _services(parts, pool, board=None, jboard=None, jbatcher=None):
    jenc, jstore, jgen, enc, store, gen = parts
    jqa = JQAService(jenc, jstore, jgen, None, k=3, batcher=jbatcher,
                     retriever=JFusedRetriever(jenc, jstore), breakers=jboard,
                     resilience=JResilienceConfig())
    qa = QAService(enc, store, gen, k=3, device="cpu", batcher=pool,
                   breakers=board, resilience=ResilienceConfig())
    return qa, jqa


def test_healthy_ask_equals_reference_with_no_degraded_key(parts):
    pool = _pool(parts[5])
    try:
        qa, jqa = _services(parts, pool)
        want = jqa.ask(QUESTION)
        got = qa.ask(QUESTION, deadline=Deadline.after(60))
    finally:
        pool.stop()
    assert set(got) == {"answer", "sources"}
    assert got == want


def test_decoder_outage_serves_the_reference_extractive_answer(parts):
    pool = _pool(parts[5])
    before = DEFAULT_REGISTRY.counter("qa_degraded").value
    try:
        qa, jqa = _services(parts, pool)
        with JFaultPlan([JFaultRule("decoder", p=1.0)]):
            want = jqa.ask(QUESTION)
        with FaultPlan([FaultRule("decoder", p=1.0)]):
            got = qa.ask(QUESTION)
    finally:
        pool.stop()
    assert got == want
    assert got["degraded"] is True and got["degrade_reason"] == "decoder_error"
    assert "mg" in got["answer"] and got["sources"]
    assert DEFAULT_REGISTRY.counter("qa_degraded").value == before + 1


def test_open_breaker_degrades_like_reference(parts):
    pool = _pool(parts[5])
    board = BreakerBoard(failure_threshold=2, reset_timeout_s=60.0)
    jboard = JBreakerBoard(failure_threshold=2, reset_timeout_s=60.0)
    try:
        qa, jqa = _services(parts, pool, board, jboard)
        with JFaultPlan([JFaultRule("decoder", p=1.0)]):
            want_trip = [jqa.ask(QUESTION) for _ in range(2)]
        with FaultPlan([FaultRule("decoder", p=1.0)]):
            got_trip = [qa.ask(QUESTION) for _ in range(2)]
        assert got_trip == want_trip
        assert board.states() == jboard.states() == {"decoder": "open"}
        # the plan is gone but the breaker has not seen its recovery window
        want, got = jqa.ask(QUESTION), qa.ask(QUESTION)
    finally:
        pool.stop()
    assert got == want
    assert got["degrade_reason"] == "decoder_breaker_open"


def test_too_little_budget_skips_generation_like_reference(parts):
    pool = _pool(parts[5])
    try:
        qa, jqa = _services(parts, pool)
        jqa.ask(QUESTION)  # the reference's first retrieval compiles
        budget = ResilienceConfig().min_generate_budget_s * 0.8
        want = jqa.ask(QUESTION, deadline=JDeadline.after(budget))
        got = qa.ask(QUESTION, deadline=Deadline.after(budget))
    finally:
        pool.stop()
    assert got == want
    assert got["degrade_reason"] == "insufficient_budget"
    # the retrieved chunks verbatim, in rank order
    assert got["answer"] == extractive_answer([dict(NOTES)[s] for s in got["sources"]])


def _crash_when_admitted(batcher, method):
    """Make the worker loop raise at its first iteration that finds a slot
    occupied: the request dies ADMITTED (the reference calls
    ``_get_decode_fn`` and the port ``_grow_tables`` once per iteration,
    outside any dispatch's error handling)."""
    orig = getattr(batcher, method)

    def crash():
        if any(batcher._slot_req):
            raise RuntimeError("replica crashed")
        return orig()

    setattr(batcher, method, crash)


def test_replica_dying_degrades_like_reference(parts):
    jenc, jstore, jgen, enc, store, gen = parts
    jpool = JEnginePool(jgen, replicas=1, n_slots=2, chunk=4, cache_len=512,
                        canary_interval_s=600.0, health_interval_s=0.05)
    pool = _pool(gen, replicas=1)
    board, jboard = BreakerBoard(), JBreakerBoard()
    try:
        qa, jqa = _services(parts, pool, board, jboard, jbatcher=jpool)
        _crash_when_admitted(jpool._replicas[0].batcher, "_get_decode_fn")
        _crash_when_admitted(pool._replicas[0].batcher, "_grow_tables")
        want = jqa.ask(QUESTION)
        got = qa.ask(QUESTION)
        st = pool.status()
    finally:
        jpool.stop()
        pool.stop()
    assert got == want
    assert got["degraded"] is True and got["degrade_reason"] == "replica_died"
    assert st["replicas"][0]["deaths"] == 1
    assert board.get("decoder")._failures == jboard.get("decoder")._failures == 1


DEVICE_FAULTS = [
    KernelError("flash_attention decode_paged kernel launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
]


@pytest.mark.parametrize("err", DEVICE_FAULTS, ids=["kernel", "cuda"])
def test_device_fault_propagates_out_of_ask(parts, err, monkeypatch):
    """A fault in the paged attention wrapper reaches the caller of ``ask``
    unchanged: no degraded answer, no breaker failure, no rebuild."""
    pool = _pool(parts[5])
    board = BreakerBoard(failure_threshold=1)
    degraded0 = DEFAULT_REGISTRY.counter("qa_degraded").value
    try:
        qa, _ = _services(parts, pool, board)

        def broken(*_a, **_k):
            raise err

        monkeypatch.setattr(paged, "paged_decode_attention", broken)
        with pytest.raises(type(err)) as e:
            qa.ask(QUESTION)
        assert e.value is err
        # the next ask raises at submit: the pool is failed, not degraded
        with pytest.raises(type(err)):
            qa.ask(QUESTION)
        st = pool.status()
    finally:
        pool.stop()
    assert board.states() == {"decoder": "closed"}
    assert board.get("decoder")._failures == 0
    assert DEFAULT_REGISTRY.counter("qa_degraded").value == degraded0
    assert [r["state"] for r in st["replicas"]] == ["failed", "failed"]
    assert all(r["generation"] == 0 and r["deaths"] == 0 for r in st["replicas"])


def test_failed_build_propagates_out_of_ask(parts, monkeypatch):
    """A kernel library that cannot be built: the wrapper's first load
    raises ``KernelError`` from ``_kernels.build`` (no nvcc), and ``ask``
    raises it."""
    pool = _pool(parts[5])
    try:
        qa, _ = _services(parts, pool, BreakerBoard(failure_threshold=1))

        def no_nvcc():
            raise KernelError("nvcc not found; the CUDA kernels cannot be built")

        monkeypatch.setattr(_kernels, "_LIBS", {})
        monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
        monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR / "absent")
        monkeypatch.setattr(
            paged, "paged_decode_attention",
            lambda *a, **k: _kernels.load("flash_attention"),
        )
        with pytest.raises(KernelError, match="nvcc not found"):
            qa.ask(QUESTION)
    finally:
        pool.stop()


def test_degraded_answer_streams_once(parts):
    pool = _pool(parts[5])
    try:
        qa, _ = _services(parts, pool)
        with FaultPlan([FaultRule("decoder", p=1.0)]):
            pending = qa.ask_submit(QUESTION)
        assert pending.degraded
        assert "".join(pending.iter_text()) == pending.answer
        healthy = qa.ask_submit(QUESTION)
        streamed = "".join(healthy.iter_text(timeout=WAIT))
        assert streamed == qa.ask(QUESTION)["answer"]
    finally:
        pool.stop()


def test_registries_count_degraded_answers_alike(parts):
    """Both packages bump ``qa_degraded`` once per degraded answer."""
    pool = _pool(parts[5])
    try:
        qa, jqa = _services(parts, pool)
        j0, p0 = (J_REGISTRY.counter("qa_degraded").value,
                  DEFAULT_REGISTRY.counter("qa_degraded").value)
        with JFaultPlan([JFaultRule("decoder", p=1.0)]):
            for _ in range(3):
                jqa.ask(QUESTION)
        with FaultPlan([FaultRule("decoder", p=1.0)]):
            for _ in range(3):
                qa.ask(QUESTION)
    finally:
        pool.stop()
    assert (J_REGISTRY.counter("qa_degraded").value - j0
            == DEFAULT_REGISTRY.counter("qa_degraded").value - p0 == 3)
