"""Port parity, the single-sync /ask: docqa_tpu_torch's ``FusedRAG`` against
docqa_tpu's on the same weights (both packages' seeded host init, float32
encoder, decoder and store), and against the port's own classic text path.

In float32 on the CPU the packed prompt ids, the hit ids and the greedy
answer must be identical to the reference's, and the fused answer must
equal the classic path's (the hash tokenizer is whitespace-pretokenized,
so the packed segments equal the tokenized prompt string).  The cases
follow ``tests/test_rag_fused.py``: deleted and tombstoned rows, the
sidecar through compaction and snapshot/restore, the QA service's dispatch
policy, and the generator's device-prompt entry.  The reference's
``test_untemplated_bpe_tail_matches_encode`` waits for the port's BPE
tokenizer and its sharded-mesh case for the multi-GPU slice.
"""

import types

import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.rag_fused import FusedRAG as JFusedRAG
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    StoreConfig,
    load_config,
)
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.rag_fused import EmptyStoreError, FusedRAG
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.service.qa import QA_TEMPLATE, QAService

torch.set_num_threads(1)

ENC = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_seq_len=128, embed_dim=16, dtype="float32")
DEC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=1024,
           dtype="float32")
GEN = dict(temperature=0.0, eos_id=2, prefill_buckets=(128, 256, 512),
           max_new_tokens=12)
W = 32

CHUNKS = [
    "aspirin 81 mg daily reduces cardiac risk score 9",
    "metformin controls glucose in diabetes score 7",
    "lisinopril lowers blood pressure effectively score 8",
    "warfarin requires inr monitoring weekly score 6",
    "albuterol relieves acute bronchospasm quickly score 5",
]
QUESTIONS = [
    "what reduces cardiac risk?",
    "how is glucose controlled?",
    "what lowers blood pressure?",
]


def _sidecar_rows(tokenizer, texts, width=W):
    rows = np.zeros((len(texts), width), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for i, text in enumerate(texts):
        ids = tokenizer.encode(text, add_specials=False)[:width]
        rows[i, : len(ids)] = ids
        lens[i] = len(ids)
    return rows, lens


def _meta(idx):
    return [{"doc_id": f"d{i}", "source": f"chunk {i}", "text_content": CHUNKS[i]}
            for i in idx]


def _fill(store, enc, gen, idx=range(len(CHUNKS)), width=W):
    idx = list(idx)
    texts = [CHUNKS[i] for i in idx]
    rows, lens = _sidecar_rows(gen.tokenizer, texts, width)
    store.add(np.asarray(enc.encode_texts(texts), np.float32), _meta(idx),
              token_rows=rows, token_lens=lens)
    return store


def _port_store(width=W):
    return VectorStore(StoreConfig(dim=16, shard_capacity=256, token_width=width,
                                   dtype="float32"), device="cpu")


def _ref_store(width=W):
    return JVectorStore(JStoreConfig(dim=16, shard_capacity=256, token_width=width,
                                     dtype="float32"))


@pytest.fixture(scope="module")
def stacks():
    """Both packages' encoder, generator and a store of the five chunks
    with their sidecar rows (the same seeded weights on both sides)."""
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=3)
    jgen = JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN), seed=11)
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=3, device="cpu")
    tgen = GenerateEngine(DecoderConfig(**DEC), GenerateConfig(**GEN), seed=11,
                          device="cpu")
    return {
        "ref": (jenc, _fill(_ref_store(), jenc, jgen), jgen),
        "port": (tenc, _fill(_port_store(), tenc, tgen), tgen),
    }


def _text_path(enc, store, gen, question, k=3, max_new=12):
    """The classic ask: host retrieval, the template, the solo engine."""
    hits = store.search(np.asarray(enc.encode_texts([question]), np.float32), k=k)[0]
    context = "\n\n".join(h.metadata["text_content"] for h in hits)
    prompt = QA_TEMPLATE.format(context=context, question=question)
    return {
        "answer": gen.generate_texts([prompt], max_new_tokens=max_new)[0],
        "sources": [h.metadata["source"] for h in hits],
    }


@pytest.mark.parametrize("question", QUESTIONS)
def test_fused_equals_the_reference(stacks, question):
    jrag = JFusedRAG(*stacks["ref"], QA_TEMPLATE, k=3)
    rag = FusedRAG(*stacks["port"], QA_TEMPLATE, k=3, device="cpu")
    want, got = jrag.ask_submit(question), rag.ask_submit(question)
    assert got.prompt_tokens() == want.prompt_tokens()
    assert [h.row_id for h in got.hits()] == [h.row_id for h in want.hits()]
    assert got.resolve() == want.resolve()


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_over_a_quantised_decoder_equals_the_reference(stacks, bits):
    """The device-prompt path through a weight-only quantised engine (each
    projection through K4's plain version here) packs the reference's
    prompt and answers its tokens, int8 and int4 (both packages' quantised
    host init)."""
    jenc, jstore, _jgen = stacks["ref"]
    tenc, tstore, _tgen = stacks["port"]
    cfg = dict(DEC, quantize_weights=True, quant_bits=bits)
    jgen = JGenerateEngine(JDecoderConfig(**cfg), JGenerateConfig(**GEN), seed=11)
    tgen = GenerateEngine(DecoderConfig(**cfg), GenerateConfig(**GEN), seed=11,
                          device="cpu")
    jrag = JFusedRAG(jenc, jstore, jgen, QA_TEMPLATE, k=3)
    rag = FusedRAG(tenc, tstore, tgen, QA_TEMPLATE, k=3, device="cpu")
    for question in QUESTIONS:
        want, got = jrag.ask_submit(question), rag.ask_submit(question)
        assert got.prompt_tokens() == want.prompt_tokens()
        assert got.resolve() == want.resolve()


@pytest.mark.parametrize("question", QUESTIONS)
def test_fused_equals_the_classic_text_path(stacks, question):
    enc, store, gen = stacks["port"]
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device="cpu")
    assert rag.ask(question, max_new_tokens=12) == _text_path(enc, store, gen, question)


def test_fused_with_a_chat_template_equals_classic_and_reference(stacks):
    enc, store, _gen = stacks["port"]
    jenc, jstore, _jgen = stacks["ref"]
    chat = dict(DEC, chat_template="mistral-inst")
    gen = GenerateEngine(DecoderConfig(**chat), GenerateConfig(**GEN), seed=11, device="cpu")
    jgen = JGenerateEngine(JDecoderConfig(**chat), JGenerateConfig(**GEN), seed=11)
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device="cpu")
    jrag = JFusedRAG(jenc, jstore, jgen, QA_TEMPLATE, k=3)
    q = QUESTIONS[0]
    got = rag.ask_submit(q, max_new_tokens=8)
    assert got.prompt_tokens() == jrag.ask_submit(q, max_new_tokens=8).prompt_tokens()
    assert got.resolve() == _text_path(enc, store, gen, q, max_new=8)


def test_fused_skips_deleted_rows(stacks):
    (enc, _s, gen), (jenc, _js, jgen) = stacks["port"], stacks["ref"]
    store, jstore = _fill(_port_store(), enc, gen), _fill(_ref_store(), jenc, jgen)
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device="cpu")
    jrag = JFusedRAG(jenc, jstore, jgen, QA_TEMPLATE, k=3)
    q = QUESTIONS[0]
    top = rag.ask(q)["sources"][0]
    for s in (store, jstore):
        s.delete_docs([f"d{top.split()[-1]}"])
    after = rag.ask(q)
    assert top not in after["sources"]
    assert after == jrag.ask(q)


def test_tombstoned_tokens_never_pack_into_prompts(stacks):
    """With fewer live rows than k, top-k pads with NEG_INF ties whose ids
    point at tombstoned rows: their sidecar tokens must not reach the
    prompt (erased text leaking into generation)."""
    (enc, _s, gen), (jenc, _js, jgen) = stacks["port"], stacks["ref"]
    rows = np.tile(np.arange(100, 104, dtype=np.int32)[:, None], (1, 8))
    lens = np.full((4,), 8, np.int32)
    prompts = []
    for store, e, g, cls in ((_port_store(8), enc, gen, FusedRAG),
                             (_ref_store(8), jenc, jgen, JFusedRAG)):
        store.add(np.asarray(e.encode_texts(CHUNKS[:4]), np.float32), _meta(range(4)),
                  token_rows=rows, token_lens=lens)
        store.delete_docs(["d1", "d2", "d3"])  # one live row, k=3
        kw = {"device": "cpu"} if cls is FusedRAG else {}
        ans = cls(e, store, g, QA_TEMPLATE, k=3, **kw).ask_submit(QUESTIONS[0], max_new_tokens=4)
        prompts.append(ans.prompt_tokens())
        assert [h.metadata["source"] for h in ans.hits()] == ["chunk 0"]
    assert 100 in prompts[0] and not set(prompts[0]) & {101, 102, 103}
    assert prompts[0] == prompts[1]


def test_sidecar_survives_compaction(stacks):
    (enc, _s, gen), (jenc, _js, jgen) = stacks["port"], stacks["ref"]
    store, jstore = _fill(_port_store(), enc, gen), _fill(_ref_store(), jenc, jgen)
    for s in (store, jstore):
        s.delete_docs(["d0", "d3"])
        s.compact_deleted()
    rows, lens = _sidecar_rows(gen.tokenizer, CHUNKS)
    tok, tok_len = store.token_sidecar()
    np.testing.assert_array_equal(tok[: store.count].numpy(), rows[[1, 2, 4]])
    np.testing.assert_array_equal(tok_len[: store.count].numpy(), lens[[1, 2, 4]])
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=2, device="cpu")
    out = rag.ask(QUESTIONS[1], max_new_tokens=8)
    assert "chunk 0" not in out["sources"] and "chunk 3" not in out["sources"]
    assert out == JFusedRAG(jenc, jstore, jgen, QA_TEMPLATE, k=2).ask(QUESTIONS[1], max_new_tokens=8)
    assert out == _text_path(enc, store, gen, QUESTIONS[1], k=2, max_new=8)


def test_sidecar_survives_snapshot_restore(stacks, tmp_path):
    enc, store, gen = stacks["port"]
    store.snapshot(str(tmp_path))
    restored = VectorStore.restore(
        str(tmp_path), StoreConfig(dim=16, shard_capacity=256, token_width=W,
                                   dtype="float32"), device="cpu")
    n = store.count
    for a, b in zip(store.token_sidecar(), restored.token_sidecar()):
        assert torch.equal(a[:n], b[:n])
    rag = FusedRAG(enc, restored, gen, QA_TEMPLATE, k=3, device="cpu")
    q = QUESTIONS[2]
    assert rag.ask(q, max_new_tokens=12) == _text_path(enc, restored, gen, q)


# ---- the QA service's dispatch policy ------------------------------------------

class _Rag:
    def __init__(self, calls, exc=None):
        self.calls, self.exc = calls, exc

    def ask(self, question):
        self.calls.append("fused")
        if self.exc is not None:
            raise self.exc
        return {"answer": "a", "sources": []}


class _Batcher:
    """A batcher stand-in: ``n_active`` lanes busy, answers "b"."""

    prefix_cache_enabled = False
    n_queued = 0

    def __init__(self, calls, engine, active):
        self.calls, self.engine, self.n_active = calls, engine, active
        self.device = engine.device

    def submit_text(self, prompt, **kw):
        self.calls.append("batcher")

        class _Handle:
            def text(self, tokenizer, timeout=None):
                return "b"

        return _Handle()


def test_qa_policy_fused_when_idle_batcher_when_busy(stacks):
    enc, store, gen = stacks["port"]
    calls = []
    qa = QAService(enc, store, gen, k=3, device="cpu",
                   batcher=_Batcher(calls, gen, 0), fused_rag=_Rag(calls))
    assert qa.ask("q")["answer"] == "a"  # idle: fused
    qa.batcher = _Batcher(calls, gen, 2)
    assert qa.ask("q")["answer"] == "b"  # busy: the batcher's slots
    qa.batcher = _Batcher(calls, gen, 0)
    assert qa.ask("q", k=2)["answer"] == "b"  # another k: classic
    assert calls == ["fused", "batcher", "batcher"]
    # the real fused chain through the service, no batcher
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device="cpu")
    qa2 = QAService(enc, store, gen, k=3, device="cpu", fused_rag=rag)
    assert qa2.ask(QUESTIONS[0]) == _text_path(enc, store, gen, QUESTIONS[0])


def test_empty_store_falls_through_to_the_classic_path(stacks):
    enc, _store, gen = stacks["port"]
    empty = _port_store()
    rag = FusedRAG(enc, empty, gen, QA_TEMPLATE, k=3, device="cpu")
    with pytest.raises(EmptyStoreError):
        rag.ask_submit(QUESTIONS[0])
    qa = QAService(enc, empty, gen, k=3, device="cpu", fused_rag=rag)
    classic = QAService(enc, empty, gen, k=3, device="cpu")
    assert qa.ask(QUESTIONS[0]) == classic.ask(QUESTIONS[0])
    assert qa.fused_rag is rag  # not disabled


def test_a_failing_fused_path_is_disabled_and_classic_serves(stacks):
    enc, store, gen = stacks["port"]
    calls = []
    qa = QAService(enc, store, gen, k=3, device="cpu",
                   batcher=_Batcher(calls, gen, 0),
                   fused_rag=_Rag(calls, ValueError("broken fused chain")))
    assert qa.ask("q")["answer"] == "b"
    assert qa.fused_rag is None
    assert qa.ask("q")["answer"] == "b"
    assert calls == ["fused", "batcher", "batcher"]


def test_a_kernel_error_propagates_out_of_ask(stacks):
    enc, store, gen = stacks["port"]
    calls = []
    rag = _Rag(calls, KernelError("injected: flash kernel launch failed"))
    qa = QAService(enc, store, gen, k=3, device="cpu",
                   batcher=_Batcher(calls, gen, 0), fused_rag=rag)
    with pytest.raises(KernelError, match="injected"):
        qa.ask("q")
    assert qa.fused_rag is rag and calls == ["fused"]


def test_fused_rag_checks_its_parts(stacks):
    enc, store, gen = stacks["port"]
    with pytest.raises(ValueError, match="token_width"):
        FusedRAG(enc, _port_store(0), gen, QA_TEMPLATE, device="cpu")
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))  # as if on another device
    with pytest.raises(ValueError, match="generator on meta; FusedRAG runs on cpu"):
        FusedRAG(enc, store, elsewhere, QA_TEMPLATE, device="cpu")


# ---- the generator's device-prompt entry -----------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy_spec", "sampled"])
def test_generate_device_equals_generate_ids(stacks, temperature):
    _enc, _store, gen = stacks["port"]
    prompt = gen.tokenizer.encode(QA_TEMPLATE.format(context=CHUNKS[0], question=QUESTIONS[0]))
    want = gen.generate_ids([prompt], max_new_tokens=10, temperature=temperature, seed=5)[0]
    ids = torch.zeros((1, 128), dtype=torch.long)
    ids[0, : len(prompt)] = torch.tensor(prompt)
    out, n = gen.generate_device(ids, torch.tensor([len(prompt)], dtype=torch.int32),
                                 10, temperature, seed=5)
    assert out[0, : int(n[0])].tolist() == want


def test_request_seeds_are_distinct(stacks):
    _enc, _store, gen = stacks["port"]
    assert len({gen.next_request_seed() for _ in range(8)}) == 8


# ---- the runtime: the fused /ask behind the app ------------------------------------

def test_runtime_serves_the_fused_ask_when_the_pool_is_idle(tmp_path):
    """``store.token_width > 0`` with a real encoder and decoder: the
    runtime builds the fused chain, the ingest pipeline fills the sidecar,
    and ``/ask`` with the pool idle takes the fused path, whose answer
    equals the classic path's through the pool (float32)."""
    from docqa_tpu_torch.service.app import DocQARuntime

    cfg = load_config(env={}, overrides={
        "encoder.vocab_size": 512, "encoder.hidden_dim": 32, "encoder.num_layers": 1,
        "encoder.num_heads": 2, "encoder.mlp_dim": 64, "encoder.max_seq_len": 128,
        "encoder.embed_dim": 16, "encoder.dtype": "float32",
        "store.dim": 16, "store.shard_capacity": 256, "store.dtype": "float32",
        "store.token_width": 32,
        "ner.train_steps": 0, "ner.hidden_dim": 32, "ner.num_layers": 1,
        "ner.num_heads": 2, "ner.mlp_dim": 64,
        **{f"decoder.{k}": v for k, v in DEC.items()},
        "generate.max_new_tokens": 8, "generate.prefill_buckets": (128, 256, 512),
        "pool.canary_interval_s": 3600.0, "resilience.request_deadline_s": 0.0,
        "data.work_dir": str(tmp_path / "work"),
    })
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        assert rt.qa.fused_rag is not None
        for i, text in enumerate(CHUNKS):
            rec = rt.pipeline.ingest_document(f"c{i}.txt", text.encode())
            assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
        tok, tok_len = rt.store.token_sidecar()
        assert (tok_len[: rt.store.count] > 0).all()
        rt._warmup_thread.join(timeout=120)  # the pool idle: no warm-up lane
        assert not rt._warmup_thread.is_alive()
        calls = []
        real = rt.qa.fused_rag.ask
        rt.qa.fused_rag.ask = lambda q: calls.append(q) or real(q)
        fused = rt.qa.ask(QUESTIONS[0])
        assert calls == [QUESTIONS[0]]
        classic = rt.qa.ask_submit(QUESTIONS[0]).resolve(timeout=120)
        assert fused == classic
    finally:
        rt.stop()
