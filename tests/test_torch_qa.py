"""Port parity, retrieval and /ask: docqa_tpu_torch's FusedRetriever and
QAService against docqa_tpu's (CPU, float32 models, bf16 store).

Top-k ids must be equal, except that a tie at the k-th score is not a
miss (scores within 1e-5: float32 sums of the same bf16 products, in
another order).  ``QAService.ask`` must return the identical
``{"answer", "sources"}`` as the reference's solo path
(``QAService(batcher=None, retriever=FusedRetriever(...))``).
"""

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
from docqa_tpu.service.qa import QA_TEMPLATE as J_QA_TEMPLATE
from docqa_tpu.service.qa import QAService as JQAService
from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    StoreConfig,
)
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.service.qa import QA_TEMPLATE, QAService

torch.set_num_threads(1)

ENC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
           mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
GEN = dict(max_new_tokens=10, prefill_buckets=(64, 128, 256))
STORE = dict(dim=64, shard_capacity=128)

NOTES = [
    (f"note-{i:02d}.txt", text)
    for i, text in enumerate([
        "Patient sous lisinopril 10 mg par jour pour hypertension.",
        "Metformine 500 mg deux fois par jour, diabète de type 2.",
        "Aspirine 100 mg après l'événement cardiaque.",
        "Allergie connue à la pénicilline, éruption cutanée.",
        "Tension artérielle 150/95 mmHg au contrôle.",
        "Lévothyroxine 75 µg pour hypothyroïdie.",
        "Atorvastatine 20 mg le soir, dyslipidémie.",
        "Insuffisance cardiaque, furosémide 40 mg.",
        "Suivi dans trois mois, bilan sanguin prévu.",
        "Aucun antécédent chirurgical notable.",
    ])
]
QUESTIONS = [
    "quelle est la dose de metformine ?",
    "le patient est-il allergique à la pénicilline ?",
    "tension artérielle au contrôle ?",
]


def _filler(n, dim, seed):
    rows = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    return rows, [{"source": f"filler-{i}"} for i in range(n)]


@pytest.fixture(scope="module")
def stacks():
    """Both packages' encoder + store (notes encoded through each engine,
    then 300 random filler rows so the store doubles twice)."""
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    jstore = JVectorStore(JStoreConfig(**STORE))
    tstore = VectorStore(StoreConfig(**STORE), device="cpu")
    texts = [t for _, t in NOTES]
    meta = [{"source": s, "text_content": t} for s, t in NOTES]
    jstore.add(jenc.encode_texts(texts), meta)
    tstore.add(tenc.encode_texts(texts), meta)
    rows, fmeta = _filler(300, STORE["dim"], 2)
    jstore.add(rows, fmeta)
    tstore.add(rows, fmeta)
    return jenc, jstore, tenc, tstore


class TestStore:
    def test_capacity_doubles_and_rows_survive(self, stacks):
        _, _, _, tstore = stacks
        assert tstore.count == 310 and tstore.capacity == 512
        buf, count = tstore.device_view()
        host = tstore._host[:count]
        np.testing.assert_array_equal(
            buf[:count].float().numpy(),
            torch.from_numpy(host).bfloat16().float().numpy(),
        )
        np.testing.assert_allclose(np.linalg.norm(host, axis=1), 1.0, atol=1e-5)

    def test_add_validates(self):
        store = VectorStore(StoreConfig(**STORE), device="cpu")
        with pytest.raises(ValueError):
            store.add(np.zeros((2, 3), np.float32), [{}, {}])
        with pytest.raises(ValueError):
            store.add(np.zeros((2, STORE["dim"]), np.float32), [{}])


class TestFusedRetriever:
    @pytest.mark.parametrize("k", [3, 8])
    def test_topk_ids_match_reference(self, stacks, k):
        jenc, jstore, tenc, tstore = stacks
        queries = QUESTIONS + [t for _, t in NOTES[:2]]
        want = JFusedRetriever(jenc, jstore).search_texts(queries, k=k)
        got = FusedRetriever(tenc, tstore, device="cpu").search_texts(queries, k=k)
        for w, g in zip(want, got):
            assert len(w) == len(g) == k
            np.testing.assert_allclose(
                [h.score for h in g], [h.score for h in w], atol=1e-5
            )
            kth = w[-1].score
            w_ids = {h.row_id for h in w}
            for h in g:  # an id outside the reference's set must tie the k-th
                assert h.row_id in w_ids or abs(h.score - kth) < 1e-5
            assert g[0].metadata == w[0].metadata

    def test_empty_store_returns_empty(self, stacks):
        _, _, tenc, _ = stacks
        store = VectorStore(StoreConfig(**STORE), device="cpu")
        assert FusedRetriever(tenc, store, device="cpu").search_texts(["x"]) == [[]]


class TestQAService:
    def test_template_is_verbatim(self):
        assert QA_TEMPLATE == J_QA_TEMPLATE

    def test_ask_matches_reference(self, stacks):
        jenc, jstore, tenc, tstore = stacks
        jgen = JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN), seed=4)
        tgen = GenerateEngine(
            DecoderConfig(**DEC), GenerateConfig(**GEN), seed=4, device="cpu"
        )
        jqa = JQAService(
            jenc, jstore, jgen, None, k=3, batcher=None,
            retriever=JFusedRetriever(jenc, jstore),
        )
        tqa = QAService(tenc, tstore, tgen, k=3, device="cpu")
        for q in QUESTIONS:
            want = jqa.ask(q)
            got = tqa.ask(q)
            assert set(got) == {"answer", "sources"}
            assert got == want
            assert got["answer"] and len(got["sources"]) == 3

    def test_generation_error_propagates(self, stacks):
        """A kernel fault in generation raises out of ``ask``; any other
        generation error serves the reference's degraded answer."""
        _, _, tenc, tstore = stacks
        tgen = GenerateEngine(
            DecoderConfig(**DEC), GenerateConfig(**GEN), seed=4, device="cpu"
        )
        tgen.params.pop("lm_head")
        qa = QAService(tenc, tstore, tgen, device="cpu")
        out = qa.ask(QUESTIONS[0])
        assert out["degraded"] is True
        assert out["degrade_reason"] == "decoder_error"
        assert out["answer"] and len(out["sources"]) == 3

        def broken(_prompts):
            raise KernelError("nvcc failed for flash_attention.cu")

        tgen.generate_texts = broken
        with pytest.raises(KernelError, match="nvcc failed"):
            qa.ask(QUESTIONS[0])
