"""Port parity, the answer router: docqa_tpu_torch's ``AnswerRouter``,
``extractive_confidence``, ``fuse_scores`` and the QA service's routed path
against docqa_tpu's on the labeled routing mix (``data/routing_mix.jsonl``)
and on seeded candidate lists.

Every decision (route, confidence, reason), evidence score and fused list
must be equal outright: both sides run the same host arithmetic.  A routed
answer must equal the reference's routed answer and make no decode: no
pool submission, no paged decode attention call, no kernel launch.
"""

import json
import os

import numpy as np
import pytest
import torch

from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import HashEncoder as JHashEncoder
from docqa_tpu.engines.router import AnswerRouter as JAnswerRouter
from docqa_tpu.engines.router import extractive_confidence as j_confidence
from docqa_tpu.engines.router import fuse_scores as j_fuse_scores
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.service.qa import QAService as JQAService
from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    StoreConfig,
)
from docqa_tpu_torch.engines import paged
from docqa_tpu_torch.engines.encoder import HashEncoder
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.router import (
    AnswerRouter,
    extractive_confidence,
    fuse_scores,
)
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.service.qa import QAService

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "data", "routing_mix.jsonl"), encoding="utf-8") as _f:
    MIX = [json.loads(line) for line in _f if line.strip()]
DOCS = [row["doc"] for row in MIX if "doc" in row]
ROUTERS = [dict(), dict(min_confidence=0.9, evidence_min=0.8),
           dict(min_confidence=0.5, evidence_min=0.2), dict(enabled=False)]


@pytest.mark.parametrize("row", MIX, ids=lambda r: r["id"])
def test_route_decisions_equal_reference(row):
    q = row["question"]
    for kw in ROUTERS:
        jr, tr = JAnswerRouter(**kw), AnswerRouter(**kw)
        jd, td = jr.decide(q), tr.decide(q)
        assert (td.route, td.confidence, td.reason) == (jd.route, jd.confidence, jd.reason)
        for chunks in ([], [row.get("doc", "")], DOCS[:3], DOCS):
            jg, jev = jr.evidence_gate(jd, q, chunks)
            tg, tev = tr.evidence_gate(td, q, chunks)
            assert tev == jev == j_confidence(q, chunks) == extractive_confidence(q, chunks)
            assert (tg.route, tg.confidence, tg.reason) == (jg.route, jg.confidence, jg.reason)


def test_text_stage_meets_the_reference_label_on_the_mix():
    """The reference's routing-precision floor: routed lookups are lookups."""
    router = AnswerRouter()
    routed = [r for r in MIX if router.decide(r["question"]).route == "extractive"]
    assert routed and all(r["label"] == "extractive" for r in routed)


@pytest.mark.parametrize("seed", range(4))
def test_fuse_scores_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(40)
    dense = [(float(s), int(i)) for s, i in zip(rng.normal(size=8), ids[:8])]
    lexical = [(float(s), int(i)) for s, i in zip(rng.exponential(size=6), ids[5:11])]
    flat = [(0.5, int(i)) for i in ids[20:23]]  # one score: normalizes to 1.0
    for d, lx in ((dense, lexical), (dense, []), ([], lexical), (flat, lexical)):
        for alpha in (0.0, 0.6, 1.0):
            for k in (None, 3):
                assert fuse_scores(d, lx, alpha, k) == j_fuse_scores(d, lx, alpha, k)


ENC = dict(vocab_size=512, embed_dim=32)
DEC = dict(vocab_size=256, hidden_dim=32, num_layers=1, num_heads=2,
           num_kv_heads=1, head_dim=16, mlp_dim=64, max_seq_len=512,
           dtype="float32")


@pytest.fixture(scope="module")
def services():
    """The reference's and the port's QA service over the same hash
    embeddings and rows, each with a router; the port's answers through a
    one-replica pool on the CPU."""
    jenc = JHashEncoder(JEncoderConfig(**ENC))
    tenc = HashEncoder(EncoderConfig(**ENC), device="cpu")
    meta = [
        {"doc_id": f"doc-{i}", "text_content": d, "source": f"src-{i}"}
        for i, d in enumerate(DOCS)
    ]
    jstore = JVectorStore(JStoreConfig(dim=ENC["embed_dim"], dtype="float32"))
    tstore = VectorStore(StoreConfig(dim=ENC["embed_dim"], dtype="float32"),
                         device="cpu")
    jstore.add(jenc.encode_texts(DOCS), meta)
    tstore.add(tenc.encode_texts(DOCS), meta)
    jqa = JQAService(jenc, jstore, None, None, k=3, use_fake_llm=True,
                     router=JAnswerRouter())
    gen = GenerateEngine(DecoderConfig(**DEC), GenerateConfig(max_new_tokens=4),
                         device="cpu")
    pool = EnginePool(gen, n_slots=2, chunk=4, canary_interval_s=3600.0,
                      device="cpu")
    tqa = QAService(tenc, tstore, gen, k=3, device="cpu", batcher=pool,
                    router=AnswerRouter())
    yield jqa, tqa, pool
    pool.stop()


def test_routed_answers_equal_reference_and_make_no_decode(services, monkeypatch):
    jqa, tqa, pool = services
    decodes, submits = [], []
    real_decode = paged.paged_decode_attention
    real_submit = pool.submit_ids

    def counting_decode(*a, **kw):
        decodes.append(1)
        return real_decode(*a, **kw)

    def counting_submit(*a, **kw):
        submits.append(1)
        return real_submit(*a, **kw)

    monkeypatch.setattr(paged, "paged_decode_attention", counting_decode)
    monkeypatch.setattr(pool, "submit_ids", counting_submit)
    launches = sum(_kernels.LAUNCHES.values())
    routed = 0
    for row in MIX:
        ref = jqa.ask(row["question"])
        if ref.get("route") != "extractive":
            continue
        routed += 1
        assert tqa.ask(row["question"]) == ref
    assert routed >= 4
    assert decodes == [] and submits == []
    assert sum(_kernels.LAUNCHES.values()) == launches
    # a generative question does reach the pool's decode
    out = tqa.ask("Why was patient Okafor admitted for observation?")
    assert "route" not in out and submits and decodes
