"""Port parity, continuous batcher: docqa_tpu_torch.engines.serve against
the port's solo engine and docqa_tpu's solo engine on the same seeded
weights (CPU, float32, 2 layers).

Greedy token streams must be identical — exact equality, no tolerance:
every engine takes the argmax of float32 logits that agree to ~1e-6.  That
is the port's serve == solo guarantee on the CPU; on the card it is the
weaker bf16 first-step-logits bound that ``chip_smoke.py`` holds.  Block
accounting must balance (zero leaked blocks) after drain, steal + stop,
kill and worker death.  Every ``result()`` takes a timeout and every
batcher is stopped, so nothing here can hang the run.
"""

import threading
import time

import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.retrieve import FusedRetriever as JFusedRetriever
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.service.qa import QAService as JQAService
from docqa_tpu.service.qa import prefix_key_for as j_prefix_key_for
from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    QoSConfig,
    StoreConfig,
)
from docqa_tpu_torch.engines import spine
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.qos import ClassQueue, QoSPolicy
from docqa_tpu_torch.engines.serve import (
    BlockPoolExhausted,
    ContinuousBatcher,
    Draining,
    make_request,
)
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.service.qa import QAService, prefix_key_for

torch.set_num_threads(1)

DEC = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
SEED = 7
MAX_NEW = 24
WAIT = 120  # seconds any single result may take


def _ctx(n=200, seed=3):
    return [(seed + i * 7) % 120 + 1 for i in range(n)]


# short, repetitive (drafts hit), a single token, and two sharing a
# 200-token context (past one 128-token prefix unit)
PROMPTS = [
    [3, 5, 9, 4],
    [2] + [11, 12, 13, 14] * 6 + [3],
    [7],
    _ctx() + [5, 9, 11],
    _ctx() + [8, 4],
]


def _engine(spec_k=4, **gen):
    return GenerateEngine(
        DecoderConfig(**DEC),
        GenerateConfig(eos_id=2, speculative_k=spec_k, **gen),
        seed=SEED, device="cpu",
    )


@pytest.fixture(scope="module")
def engines():
    return {k: _engine(k) for k in (4, 0)}


@pytest.fixture(scope="module")
def solo(engines):
    return engines[0].generate_ids(PROMPTS, max_new_tokens=MAX_NEW)


@pytest.fixture(scope="module")
def reference_streams():
    """docqa_tpu's solo engine on the same host-init weights."""
    eng = JGenerateEngine(
        JDecoderConfig(**DEC), JGenerateConfig(eos_id=2), seed=SEED
    )
    return eng.generate_ids(PROMPTS, max_new_tokens=MAX_NEW)


def _serve(engine, prompts, max_new=MAX_NEW, keys=None, **kw):
    kw = {"n_slots": 2, "chunk": 4, "cache_len": 512, **kw}
    b = ContinuousBatcher(engine, **kw)
    try:
        handles = [
            b.submit_ids(p, max_new_tokens=max_new,
                         prefix_key=None if keys is None else keys[i])
            for i, p in enumerate(prompts)
        ]
        return [h.result(timeout=WAIT) for h in handles], b
    finally:
        b.stop()


class TestGreedyParity:
    @pytest.mark.parametrize("spec_k", [4, 0])
    def test_matches_both_solo_engines(self, engines, solo,
                                       reference_streams, spec_k):
        """More requests than slots, speculation on and off."""
        got, b = _serve(engines[spec_k], PROMPTS)
        assert solo == reference_streams
        assert got == solo
        assert b.stats["admissions"] == len(PROMPTS)
        steps = "verify_steps" if spec_k else "decode_steps"
        assert b.stats[steps] > 0
        assert b._alloc.blocks_in_use == 0

    def test_speculation_saves_steps(self, engines):
        prompt = [[2] + [11, 12, 13, 14] * 6 + [3]]
        a, ba = _serve(engines[4], prompt, max_new=40)
        p, bp = _serve(engines[0], prompt, max_new=40)
        assert a == p
        assert ba.stats["verify_steps"] < bp.stats["decode_steps"]

    def test_warm_equals_cold_equals_solo(self, engines):
        ctx = _ctx(300)
        prompts = [ctx + [5, 9, 11], ctx + [8, 4], ctx + [77]]
        want = engines[0].generate_ids(prompts, max_new_tokens=32)
        cold, _ = _serve(engines[4], prompts, max_new=32, prefix_cache=False)
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=512)
        try:
            warm = [
                b.submit_ids(p, max_new_tokens=32, prefix_key="patient-7")
                .result(timeout=WAIT)
                for p in prompts
            ]
            st = b._prefix_cache.stats()
            assert st["hits"] >= 2 and st["tokens_avoided"] >= 2 * 256
            assert b.stats["warm_admissions"] >= 2
        finally:
            b.stop()
        assert warm == cold == want
        assert b._alloc.blocks_in_use == 0

    def test_concurrent_warm_round_matches_solo(self, engines):
        """A round mixing warm lanes (one packed warm group) and cold ones,
        the cache seeded in-round by the first of the session."""
        ctx = _ctx(260, seed=11)
        session = [ctx + [10 + i] for i in range(4)]
        foreign = [[3, 5, 9 + i] for i in range(2)]
        prompts = session + foreign
        got, b = _serve(
            engines[4], prompts, max_new=16, n_slots=4,
            keys=["s"] * 4 + [None] * 2,
        )
        assert got == engines[0].generate_ids(prompts, max_new_tokens=16)
        assert b.stats["warm_admissions"] >= 3

    def test_grow_past_initial_allocation_matches_solo(self, engines):
        """8-token blocks and a long answer: the lane's table grows several
        times mid-decode."""
        prompt = [3, 5, 9, 4]
        want = engines[0].generate_ids([prompt], max_new_tokens=96)
        got, b = _serve(engines[4], [prompt], max_new=96, cache_len=256,
                        kv_block_size=8)
        assert got == want
        assert b._alloc.blocks_in_use == 0

    def test_eos_retires_and_reuses_a_slot(self, engines, solo):
        """EOS = the 3rd token of prompt 0's answer: its lane retires early
        and the one slot serves the next request."""
        eos = solo[0][2]
        eng_eos = GenerateEngine(
            DecoderConfig(**DEC), GenerateConfig(eos_id=eos, speculative_k=4),
            seed=SEED, device="cpu",
        )
        want = [
            eng_eos.generate_ids([p], max_new_tokens=MAX_NEW)[0]
            for p in PROMPTS[:3]
        ]
        got, b = _serve(eng_eos, PROMPTS[:3], n_slots=1)
        assert got == want
        assert got[0] == solo[0][: solo[0].index(eos)]
        assert b.stats["admissions"] == 3 and b.stats["completed"] == 3

    def test_sampling_is_seeded(self):
        eng = _engine(4, temperature=0.9)
        # one request: the dispatch sequence, and so every seed, is fixed
        a, _ = _serve(eng, PROMPTS[1:2], seed=5)
        c, _ = _serve(eng, PROMPTS[1:2], seed=5)
        assert a == c
        assert all(0 <= t < DEC["vocab_size"] for row in a for t in row)

    def test_iter_tokens_streams_the_result(self, engines, solo):
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=512)
        try:
            h = b.submit_ids(PROMPTS[1], max_new_tokens=MAX_NEW)
            assert list(h.iter_tokens(timeout=WAIT)) == solo[1]
        finally:
            b.stop()


class TestBlockAccounting:
    def test_zero_leak_after_drain_with_warm_cache(self, engines):
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=256)
        try:
            handles = [
                b.submit_ids(_ctx(150) + [5 + i], max_new_tokens=12,
                             prefix_key="p")
                for i in range(5)
            ]
            assert b.drain(timeout=WAIT)
            assert all(len(h.result(timeout=5)) > 0 for h in handles)
            with pytest.raises(Draining):
                b.submit_ids([3, 5], max_new_tokens=4)
            # drained but alive: live blocks are exactly the cache's pins
            st = b._prefix_cache.stats()
            assert st["hits"] >= 1
            assert b._alloc.blocks_in_use == st["pinned_blocks"] > 0
            b.resume()
            assert len(b.submit_ids([3, 5], max_new_tokens=4).result(timeout=WAIT)) > 0
        finally:
            b.stop()
        assert b._alloc.blocks_in_use == 0
        assert b.block_seconds()["residual"] == pytest.approx(0.0, abs=1e-9)

    def test_zero_leak_after_steal_and_stop(self, engines):
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=128)
        b2 = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=128)
        try:
            with b._cv:  # hold the worker off so the requests stay queued
                reqs = [make_request([3 + i, 5], 8) for i in range(3)]
                for r in reqs:
                    b._queue.append(r)
                stolen = b.steal_queued()
            assert stolen == reqs
            b.stop()
            assert b._alloc.blocks_in_use == 0
            # the stolen requests own no blocks and re-admit elsewhere
            handles = [b2.submit_request(r) for r in stolen]
            assert all(len(h.result(timeout=WAIT)) > 0 for h in handles)
        finally:
            b.stop()
            b2.stop()
        assert b2._alloc.blocks_in_use == 0

    @pytest.mark.parametrize("mode", ["kill", "death"])
    def test_zero_leak_after_kill_and_worker_death(self, engines, mode):
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=256,
                              max_queue=16)
        rescued = []
        b.on_worker_death = lambda _b, queued: rescued.extend(queued) or []
        try:
            b.submit_ids(_ctx(150) + [5], max_new_tokens=8,
                         prefix_key="p").result(timeout=WAIT)
            handles = [
                b.submit_ids(_ctx(150) + [6 + i], max_new_tokens=200,
                             prefix_key="p")
                for i in range(4)
            ]
            deadline = time.monotonic() + 30
            while b.n_active == 0 and time.monotonic() < deadline:
                time.sleep(0.002)
            assert b.n_active > 0
            if mode == "kill":
                b.kill(RuntimeError("wedged"))
            else:
                t = threading.Thread(
                    target=b._worker_died, args=(RuntimeError("crash"),)
                )
                t.start()
                t.join(timeout=30)
                with b._cv:
                    b._stopped = True
                    b._cv.notify_all()
            # the worker exits at its next wakeup; its exit sweep closes
            # the books of anything it registered after the sweep above
            b._worker.join(timeout=60)
            assert not b._worker.is_alive()
            rescued_ids = {id(r) for r in rescued}
            for h in handles:
                if id(h._req) in rescued_ids:
                    continue  # the hook owns these
                with pytest.raises(Exception):
                    h.result(timeout=10)
            assert b._alloc.blocks_in_use == 0, mode
        finally:
            b.stop()

    def test_pool_wait_sheds_on_deadline(self, engines):
        """A request waiting for blocks keeps its deadline: it sheds typed
        while the pool is held, and the batcher keeps serving."""
        b = ContinuousBatcher(engines[4], n_slots=2, chunk=4, cache_len=256,
                              kv_block_size=16, kv_pool_tokens=256)
        try:
            hold = b._alloc.new_table()
            hold.ensure(256)  # the whole pool, outside the slot set
            waiter = b.submit_ids([4, 6], max_new_tokens=4,
                                  deadline=Deadline.after(0.3))
            with pytest.raises(DeadlineExceeded):
                waiter.result(timeout=WAIT)
            hold.release()
            assert len(b.submit_ids([3, 5], max_new_tokens=4).result(timeout=WAIT)) > 0
        finally:
            b.stop()
        assert b._alloc.blocks_in_use == 0

    def test_dry_pool_and_full_queue_is_typed(self, engines):
        b = ContinuousBatcher(engines[4], n_slots=1, chunk=4, cache_len=256,
                              kv_block_size=16, kv_pool_tokens=256, max_queue=1)
        try:
            hold = b._alloc.new_table()
            hold.ensure(256)  # the whole pool, outside the slot set
            queued = b.submit_ids([4, 6], max_new_tokens=4)
            with pytest.raises(BlockPoolExhausted):
                b.submit_ids([5], max_new_tokens=2)
            time.sleep(0.2)
            assert not queued._req.done.is_set()  # starved, not lost
            hold.release()
            assert len(queued.result(timeout=WAIT)) > 0
        finally:
            b.stop()


class TestQoS:
    def test_weighted_fair_order(self):
        q = ClassQueue(weights={"interactive": 3.0, "batch": 1.0})
        for i in range(8):
            q.append(make_request([i], 1, req_class="batch"))
            q.append(make_request([100 + i], 1, req_class="interactive"))
        order = [q.popleft().req_class for _ in range(8)]
        assert order.count("interactive") == 6 and order.count("batch") == 2

    def test_aging_floor_serves_a_starved_head(self):
        now = [0.0]
        q = ClassQueue(weights={"interactive": 100.0, "batch": 1.0},
                       aging_floor_s=5.0, now_fn=lambda: now[0])
        old = make_request([1], 1, req_class="batch")
        old.t_queue = -10.0
        q.append(make_request([2], 1, req_class="interactive"))
        q.append(old)
        assert q[0] is old and q.popleft() is old

    def test_config_coerces_to_its_weights(self):
        policy = QoSPolicy.coerce(QoSConfig(weight_batch=3.0, aging_floor_s=1.5))
        assert policy.weights == {"interactive": 8.0, "batch": 3.0, "background": 1.0}
        assert policy.aging_floor_s == 1.5
        assert QoSPolicy.coerce(policy) is policy
        assert QoSPolicy.coerce(None) is None

    def test_disabled_config_is_fifo(self):
        assert QoSPolicy.coerce(QoSConfig(enabled=False)) is None

    def test_batcher_with_qos_matches_solo(self, engines, solo):
        got, b = _serve(engines[4], PROMPTS, qos=QoSConfig())
        assert got == solo
        assert isinstance(b._queue, ClassQueue)


def test_lane_runs_work_in_inference_mode_and_raises_its_errors():
    lane = spine.Lane("cpu")
    assert lane.stream is None
    with lane.active():
        assert torch.is_inference_mode_enabled()
        assert torch.ones(2).is_inference()
    assert not torch.is_inference_mode_enabled()
    with pytest.raises(ZeroDivisionError):
        with lane.active():
            1 / 0


# ---- the service through the batcher ------------------------------------------

ENC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
           mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
STORE = dict(dim=64, shard_capacity=128)
_VISIT = (" Consultation de suivi au cabinet, patient vu avec sa famille,"
          " examen clinique complet sans particularité, bilan sanguin"
          " prescrit et prochain rendez-vous fixé dans trois mois.")
# notes long enough that a prompt passes one 128-token prefix unit
NOTES = [
    ("note-0.txt", "Metformine 500 mg deux fois par jour, diabète de type 2." + _VISIT),
    ("note-1.txt", "Allergie connue à la pénicilline, éruption cutanée." + _VISIT),
    ("note-2.txt", "Tension artérielle 150/95 mmHg au contrôle." + _VISIT),
    ("note-3.txt", "Lisinopril 10 mg par jour pour hypertension." + _VISIT),
]
QUESTIONS = [
    "quelle est la dose de metformine ?",
    "le patient est-il allergique à la pénicilline ?",
    "quelle est la dose de metformine ?",  # same chunks: a warm prefix
]


class TestQAServiceWithBatcher:
    def test_ask_matches_solo_and_reference(self):
        texts = [t for _, t in NOTES]
        meta = [{"source": s, "text_content": t} for s, t in NOTES]
        jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
        jstore = JVectorStore(JStoreConfig(**STORE))
        jstore.add(jenc.encode_texts(texts), meta)
        jgen = JGenerateEngine(JDecoderConfig(**DEC),
                               JGenerateConfig(max_new_tokens=10), seed=SEED)
        jqa = JQAService(jenc, jstore, jgen, None, k=3, batcher=None,
                         retriever=JFusedRetriever(jenc, jstore))
        enc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
        store = VectorStore(StoreConfig(**STORE), device="cpu")
        store.add(enc.encode_texts(texts), meta)
        gen = GenerateEngine(DecoderConfig(**DEC),
                             GenerateConfig(max_new_tokens=10), seed=SEED,
                             device="cpu")
        b = ContinuousBatcher(gen, n_slots=2, chunk=4, cache_len=512)
        try:
            served = QAService(enc, store, gen, k=3, device="cpu", batcher=b)
            solo_qa = QAService(enc, store, gen, k=3, device="cpu")
            for q in QUESTIONS:
                want = jqa.ask(q)
                assert solo_qa.ask(q) == want
                got = served.ask(q)
                assert set(got) == {"answer", "sources"}
                assert got == want
            assert b._prefix_cache.stats()["hits"] >= 1
        finally:
            b.stop()

    def test_prefix_key_matches_reference(self):
        chunks = ["a", "b é", "c"]
        assert prefix_key_for(chunks) == j_prefix_key_for(chunks)
        assert prefix_key_for(chunks) != prefix_key_for(chunks[::-1])

    def test_batcher_error_propagates(self):
        """A kernel fault from the batcher reaches the caller unchanged; an
        ordinary batcher error (a stopped batcher) serves the reference's
        degraded answer instead."""
        gen = _engine(4)
        enc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
        store = VectorStore(StoreConfig(**STORE), device="cpu")
        store.add(enc.encode_texts([t for _, t in NOTES]),
                  [{"source": s, "text_content": t} for s, t in NOTES])
        b = ContinuousBatcher(gen, n_slots=1, chunk=4, cache_len=512)
        b.stop()
        qa = QAService(enc, store, gen, device="cpu", batcher=b)
        out = qa.ask(QUESTIONS[0])
        assert out["degraded"] is True
        assert out["degrade_reason"] == "decoder_error"

        def broken(*_a, **_k):
            raise KernelError("flash_attention decode_paged kernel launch failed")

        b.submit_text = broken
        with pytest.raises(KernelError, match="decode_paged"):
            qa.ask(QUESTIONS[0])
