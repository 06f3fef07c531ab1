"""Port parity, the lexical tier: docqa_tpu_torch's ``clinical_tokens``,
``term_slot`` and ``LexicalIndex`` against docqa_tpu's, and the retrieve
modes of the port's ``TieredIndex`` / ``FusedTieredRetriever`` against the
reference's same classes (below the IVF threshold, so the dense tier is the
exact store) on the same corpus and encoder weights.

Tokens, slots and encoded query operands must be equal outright.  Lexical
scores agree within 1e-5 relative (float32 sums of the same int8 impacts
and weights, in another order).  The two float32 encoders' cosines agree
within 2.4e-7 (two ulps at 1.0); a hybrid score min-max normalizes them
over the query's dense candidates, so its tolerance is that error scaled by
``alpha * 4 / spread``, the spread being the reference's dense candidates'
top-to-last distance for that query.  Top-k ids must be equal,
except that a tie at the k-th score is not a miss.
"""

import json
import os

import numpy as np
import pytest
import torch

from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.index.lexical import LexicalIndex as JLexicalIndex
from docqa_tpu.index.lexical import clinical_tokens as j_clinical_tokens
from docqa_tpu.index.lexical import term_slot as j_term_slot
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.index.tiered import TieredIndex as JTieredIndex
from docqa_tpu_torch.config import EncoderConfig, StoreConfig
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever, FusedTieredRetriever
from docqa_tpu_torch.index.lexical import LexicalIndex, clinical_tokens, term_slot
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.index.tiered import TieredIndex
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_seq_len=128, embed_dim=32, dtype="float32")
LEX = dict(vocab_size=4096, tile_width=8, k1=1.5, b=0.75, ref_len=16)
RTOL = 1e-5
DENSE_TOL = 2.4e-7
ALPHA = 0.6

with open(os.path.join(REPO, "data", "routing_mix.jsonl"), encoding="utf-8") as _f:
    MIX = [json.loads(line) for line in _f if line.strip()]
DOCS = [row["doc"] for row in MIX if "doc" in row]  # the lookups' documents
QUESTIONS = [row["question"] for row in MIX]

TOKEN_CASES = [
    "",
    "Patient MRN 40081223, tel 01.42.34.56.78 / 01-42-34-56-78",
    "Résumé: hypertension artérielle, co-amoxiclav 1 g, Lévothyroxine 75 µg",
    "10mg twice-daily; HbA1c 8.2 % on 2024-03-05",
    "ÉPREUVE d'effort — « posologie » de l'amoxicilline-acide clavulanique",
    "Ångström’s ﬁle, naïve café",
]


@pytest.mark.parametrize("text", TOKEN_CASES)
def test_clinical_tokens_and_slots_equal_reference(text):
    toks = clinical_tokens(text)
    assert toks == j_clinical_tokens(text)
    for vocab in (2, 4096, 1 << 17):
        assert [term_slot(t, vocab) for t in toks] == [j_term_slot(t, vocab) for t in toks]


def _lexical_pair():
    jlex = JLexicalIndex(**LEX)
    tlex = LexicalIndex(**LEX, device="cpu")
    for lo, hi in ((0, 7), (7, len(DOCS))):
        jlex.add(list(range(lo, hi)), DOCS[lo:hi])
        tlex.add(list(range(lo, hi)), DOCS[lo:hi])
    return jlex, tlex


def _assert_same_pairs(jrows, trows, atols=None):
    """Per query: same length, scores within ``RTOL`` relative or the
    query's ``atols`` entry, ids equal but among rows tied at the last
    score."""
    assert len(jrows) == len(trows)
    for qi, (jrow, trow) in enumerate(zip(jrows, trows)):
        assert len(jrow) == len(trow)
        js = np.array([s for s, _ in jrow])
        ts = np.array([s for s, _ in trow])
        atol = 1e-7 if atols is None else atols[qi]
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=atol)
        if jrow:
            tie = js[-1] + max(RTOL * abs(js[-1]), atol)
            assert {r for s, r in jrow if s > tie} == {r for s, r in trow if s > tie}


def test_encoded_queries_equal_reference():
    jlex, tlex = _lexical_pair()
    for batch in (QUESTIONS[:1], QUESTIONS[:3], QUESTIONS):
        jt, jw = jlex.encode_queries(batch)
        tt, tw = tlex.encode_queries(batch)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_lexical_search_equals_reference(k):
    jlex, tlex = _lexical_pair()
    _assert_same_pairs(jlex.search(QUESTIONS, k=k), tlex.search(QUESTIONS, k=k))
    assert tlex.search(["zzz qqq"], k=k) == jlex.search(["zzz qqq"], k=k) == [[]]


def _stacks():
    """Both packages' store with the same rows (the mix's documents encoded
    by the reference encoder), a lexical tier fed through the store's sink,
    the reference's tiered facade and the port's fused tiered retriever over
    its own tiered facade."""
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    emb = jenc.encode_texts(DOCS)
    meta = [
        {"doc_id": f"doc-{i}", "text_content": d, "source": f"src-{i}",
         "patient_id": f"p{i % 3}"}
        for i, d in enumerate(DOCS)
    ]
    jstore = JVectorStore(JStoreConfig(dim=ENC["embed_dim"], dtype="float32"))
    tstore = VectorStore(StoreConfig(dim=ENC["embed_dim"], dtype="float32"),
                         device="cpu")
    jlex = JLexicalIndex(**LEX)
    tlex = LexicalIndex(**LEX, device="cpu")
    jstore.register_index_sink(jlex)
    tstore.register_index_sink(tlex)
    jstore.add(emb, meta)
    tstore.add(emb, meta)
    tiered = JTieredIndex(jstore, min_rows=10**9, lexical=jlex, hybrid_alpha=0.6)
    retriever = FusedTieredRetriever(
        tenc, TieredIndex(tstore, min_rows=10**9, lexical=tlex, hybrid_alpha=0.6),
        device="cpu",
    )
    return jenc, tiered, retriever


def _hits(rows):
    return [[(h.score, h.row_id) for h in row] for row in rows]


def _atols(mode, tiered, q_emb, k):
    """Per-query score tolerance (module docstring): None but in hybrid."""
    if mode != "hybrid":
        return None
    dense = tiered.search(q_emb, k=k, mode="dense", query_texts=QUESTIONS)
    spreads = [max(row[0].score - row[-1].score, 1e-6) if row else 1.0 for row in dense]
    return [ALPHA * 4 * DENSE_TOL / sp + 1e-7 for sp in spreads]


@pytest.mark.parametrize("mode", ["lexical", "hybrid", "dense"])
def test_retrieve_modes_equal_reference(mode):
    jenc, tiered, retriever = _stacks()
    try:
        q_emb = jenc.encode_texts(QUESTIONS)
        for k in (3, 5):
            ref = tiered.search(q_emb, k=k, mode=mode, query_texts=QUESTIONS)
            port = retriever.search_texts(QUESTIONS, k=k, mode=mode)
            _assert_same_pairs(_hits(ref), _hits(port), _atols(mode, tiered, q_emb, k))
            # the metadata rides with each row id
            for rrow, prow in zip(ref, port):
                by_id = {h.row_id: h.metadata for h in rrow}
                for h in prow:
                    assert h.row_id not in by_id or h.metadata == by_id[h.row_id]
        # after tombstones and a compaction both tiers stay row-aligned
        for mutate in (lambda st: st.delete_docs(["doc-0", "doc-5", "doc-17"]),
                       lambda st: st.compact_deleted()):
            for store in (tiered.store, retriever.tiered.store):
                mutate(store)
            _assert_same_pairs(
                _hits(tiered.search(q_emb, k=5, mode=mode, query_texts=QUESTIONS)),
                _hits(retriever.search_texts(QUESTIONS, k=5, mode=mode)),
                _atols(mode, tiered, q_emb, 5),
            )
    finally:
        tiered.close()


def test_filters_fall_back_to_dense_like_reference():
    """Only the dense store implements filters: a lexical or hybrid request
    with a filter serves dense and counts the fallback, on both sides."""
    jenc, tiered, retriever = _stacks()
    try:
        filters = {"patient_id": "p1"}
        q_emb = jenc.encode_texts(QUESTIONS[:4])
        before = DEFAULT_REGISTRY.counter("retrieve_mode_fallback").value
        port = retriever.search_texts(QUESTIONS[:4], k=4, filters=filters,
                                      mode="hybrid")
        assert DEFAULT_REGISTRY.counter("retrieve_mode_fallback").value == before + 1
        ref = tiered.search(q_emb, k=4, filters=filters, mode="hybrid",
                            query_texts=QUESTIONS[:4])
        _assert_same_pairs(_hits(ref), _hits(port))
        assert all(h.metadata["patient_id"] == "p1" for row in port for h in row)
    finally:
        tiered.close()


def test_retriever_without_lexical_tier_serves_dense():
    """With no lexical tier a lexical request serves dense and counts the
    fallback, as the reference's tiered index does; the exact-serving
    retriever is dense only and takes no mode at all."""
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    store = VectorStore(StoreConfig(dim=ENC["embed_dim"], dtype="float32"),
                        device="cpu")
    emb = tenc.encode_texts(DOCS)
    meta = [{"doc_id": str(i)} for i in range(len(DOCS))]
    store.add(emb, meta)
    jstore = JVectorStore(JStoreConfig(dim=ENC["embed_dim"], dtype="float32"))
    jstore.add(emb, meta)
    jtiered = JTieredIndex(jstore, min_rows=10**9)
    retriever = FusedTieredRetriever(tenc, TieredIndex(store, min_rows=10**9), device="cpu")
    before = DEFAULT_REGISTRY.counter("retrieve_mode_fallback").value
    got = retriever.search_texts(QUESTIONS[:2], mode="lexical")
    assert DEFAULT_REGISTRY.counter("retrieve_mode_fallback").value == before + 1
    assert _hits(got) == _hits(retriever.search_texts(QUESTIONS[:2]))
    q_emb = tenc.encode_texts(QUESTIONS[:2])
    _assert_same_pairs(
        _hits(jtiered.search(q_emb, mode="lexical", query_texts=QUESTIONS[:2])), _hits(got)
    )
    exact = FusedRetriever(tenc, store, device="cpu")
    assert not hasattr(exact, "supports_modes")
    assert _hits(exact.search_texts(QUESTIONS[:2])) == _hits(got)
