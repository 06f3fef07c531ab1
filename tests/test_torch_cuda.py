"""The Hopper flash kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test here skips (the decision is
taken in the fixture, never at import).  On the card:
``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: float32 5e-5 (only the summation order differs); bf16
``1e-2 + 1e-2 * |plain|`` (both sides round a float32 result to bf16).
"""

import dataclasses
import zlib

import pytest
import torch

from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.ops.attention import (
    attention_reference, flash_attention, gather_paged_kv,
    paged_decode_attention, plan_flash, split_bounds, split_kv_reference,
)

pytestmark = pytest.mark.cuda

# (b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset)
CASES = [
    (2, 256, 256, 4, 2, 64, False, None, [256, 190], None),
    (2, 256, 256, 4, 2, 64, True, None, [256, 190], None),
    (2, 1, 256, 4, 4, 64, True, None, [100, 37], None),
    (1, 128, 128, 2, 2, 64, True, 32, [128], None),
    (3, 32, 32, 4, 4, 32, False, None, [32, 0, 7], None),
    (2, 1, 128, 4, 2, 128, True, None, [51, 90], [50, 89]),
    (2, 4, 128, 4, 2, 128, True, None, [54, 93], [50, 89]),
    (2, 37, 100, 4, 1, 64, True, 20, [100, 60], None),
    (1, 200, 700, 32, 8, 128, True, 64, [650], [450]),
    # split-kv edges: splits wholly past lengths, wholly before the window,
    # lengths = 0 (output 0); packed GQA verify and decode
    (2, 4, 4224, 32, 8, 128, True, None, [100, 4100], [96, 4096]),
    (1, 4, 4224, 32, 8, 128, True, 64, [4100], [4096]),
    (2, 1, 640, 8, 2, 64, True, None, [0, 300], [0, 299]),
    (2, 4, 384, 8, 2, 64, True, None, [233, 54], [229, 50]),
    (1, 16, 512, 16, 4, 128, True, 128, [400], [384]),
    # MiniLM encoder width (d = 32, no GQA, ragged and empty rows)
    (4, 128, 128, 12, 12, 32, False, None, [128, 0, 1, 77], None),
    # first size on the prefill path
    (2, 17, 200, 8, 2, 64, True, None, [150, 17], None),
    # long causal prefill with a window, two warpgroups per block
    (2, 1024, 1100, 32, 8, 128, True, 300, [1030, 700], [6, 0]),
    # the NER tagger's window batch (NERConfig: 8 heads of 32, no GQA,
    # bidirectional), ragged lengths and two empty lanes
    (32, 512, 512, 8, 8, 32, False, None,
     [0, 0] + [300 + (37 * i) % 213 for i in range(30)], None),
    # the batch the pipeline's deid worker serves (8 windows, one warpgroup
    # a block), one lane empty
    (8, 512, 512, 8, 8, 32, False, None,
     [0] + [300 + (53 * i) % 213 for i in range(7)], None),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, case, dtype):
    b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset = case
    gen = torch.Generator(device=dev).manual_seed(sq * 1000 + skv)
    q, k, v = (
        torch.randn(shape, generator=gen, device=dev).to(dtype)
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    )
    kw = dict(
        causal=causal, sliding_window=window,
        lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
        q_offset=None if q_offset is None
        else torch.tensor(q_offset, dtype=torch.int32, device=dev),
    )
    return q, k, v, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(dev, case, dtype):
    q, k, v, kw = _inputs(dev, case, dtype)
    b, sq, skv, hq, hkv = case[:5]
    path = plan_flash(dtype, b, sq, skv, hq, hkv,
                      torch.cuda.get_device_properties(dev).multi_processor_count).path
    assert path == ("simt" if dtype == torch.float32 else "decode" if sq <= 16 else "prefill")
    before = dict(_kernels.LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attention"] == before.get("flash_attention", 0) + 1
    key = f"flash_attention.{path}"
    assert _kernels.LAUNCHES[key] == before.get(key, 0) + 1
    want = attention_reference(q, k, v, **kw)
    atol, rtol = (5e-5, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_kernel_reads_strided_views(dev):
    """A non-contiguous k/v view (a cache slice) needs no copy."""
    q, k, v, kw = _inputs(dev, CASES[1], torch.float32)
    big_k = torch.zeros((2, 300, 2, 64), device=dev)
    big_v = torch.zeros_like(big_k)
    big_k[:, :256], big_v[:, :256] = k, v
    got = flash_attention(q, big_k[:, :256], big_v[:, :256], **kw)
    torch.testing.assert_close(got, attention_reference(q, k, v, **kw),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize(
    "shape,dtype",
    [((1, 4, 2, 48), torch.float32), ((1, 4, 2, 64), torch.float16)],
)
def test_wrapper_raises_on_unsupported(dev, shape, dtype):
    x = torch.zeros(shape, device=dev, dtype=dtype)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)


def test_wrapper_raises_on_misaligned_rows(dev):
    """The kernel reads 16-byte vectors: a base pointer off by one element
    is refused, not read wrongly."""
    flat = torch.zeros(1 + 4 * 2 * 64, device=dev, dtype=torch.bfloat16)
    x = flat[1:].view(1, 4, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x, x, x)


def test_split_reference_matches_kernel_bf16(dev):
    """The decode kernel's split-and-merge against its plain version at the
    plan's own split count (4K-row cache, GQA packed)."""
    case = CASES[9]
    q, k, v, kw = _inputs(dev, case, torch.bfloat16)
    plan = plan_flash(torch.bfloat16, *case[:5],
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.num_splits > 1 and len(split_bounds(case[2], plan.num_splits)) == plan.num_splits
    got = flash_attention(q, k, v, **kw)
    want = split_kv_reference(q, k, v, num_splits=plan.num_splits, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_zero_length_rows_are_zero_not_nan(dev):
    q, k, v, kw = _inputs(dev, CASES[11], torch.bfloat16)
    got = flash_attention(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    assert not got[0].float().any()  # lengths[0] == 0


@pytest.mark.parametrize("case,groups", [(CASES[-2], 2), (CASES[-1], 1)],
                         ids=["b32", "served_b8"])
def test_empty_lanes_of_a_window_batch_are_zero_on_the_prefill_path(dev, case, groups):
    """The tagger's padded window batches (32 windows, two warpgroups a
    block; the pipeline's 8, one): the empty lanes come out as exact zeros
    on the wgmma path, as ``encoder_forward`` documents."""
    q, k, v, kw = _inputs(dev, case, torch.bfloat16)
    plan = plan_flash(torch.bfloat16, *case[:5],
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.path == "prefill" and plan.prefill_groups == groups
    got = flash_attention(q, k, v, **kw)
    empty = case[8].count(0)
    assert torch.isfinite(got.float()).all()
    assert not got[:empty].float().any() and got[empty:].float().abs().sum() > 0


# paged mode: (lanes, q_len, hq, hkv, d, block_size, NB, lengths, window)
PAGED_CASES = [
    (8, 4, 32, 8, 128, 16, 64, [180, 260, 201, 233, 199, 250, 190, 222], None),
    (8, 1, 32, 8, 128, 16, 64, [180, 260, 201, 233, 199, 250, 190, 1], 4096),
    (3, 4, 8, 2, 64, 16, 40, [0, 500, 37], None),
    (2, 4, 32, 8, 128, 16, 264, [4100, 4097], None),
    (4, 4, 8, 8, 32, 8, 20, [150, 9, 64, 100], 50),
]


def _paged_inputs(dev, case):
    """Shuffled block ids per lane, holes (id = n_blocks) past each lane's
    live blocks, and a pool with room for every lane."""
    S, sq, hq, hkv, d, bs, nb, lengths, window = case
    n_blocks = S * nb
    gen = torch.Generator(device=dev).manual_seed(S * 100 + nb)
    pool_shape = (n_blocks * bs, hkv, d)
    q, k_pool, v_pool = (
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for shape in ((S, sq, hq, d), pool_shape, pool_shape)
    )
    perm = torch.randperm(n_blocks, generator=gen, device=dev).to(torch.int32)
    tables = torch.full((S, nb), n_blocks, dtype=torch.int32, device=dev)
    for lane, n in enumerate(lengths):
        used = -(-n // bs)
        tables[lane, :used] = perm[lane * nb: lane * nb + used]
    lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables, lengths_t, dict(
        block_size=bs, q_offset=(lengths_t - sq).clamp(min=0),
        sliding_window=window,
    )


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(dev, case):
    q, k_pool, v_pool, tables, lengths, kw = _paged_inputs(dev, case)
    before = dict(_kernels.LAUNCHES)
    got = paged_decode_attention(q, k_pool, v_pool, tables, lengths, **kw)
    torch.cuda.synchronize()
    key = "flash_attention.decode_paged"
    assert _kernels.LAUNCHES[key] == before.get(key, 0) + 1
    # the plain version: gather + attention_reference, on the same tensors
    k = gather_paged_kv(k_pool, tables, kw["block_size"])
    v = gather_paged_kv(v_pool, tables, kw["block_size"])
    want = attention_reference(
        q, k, v, causal=True, lengths=lengths, q_offset=kw["q_offset"],
        sliding_window=kw["sliding_window"],
    )
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    # and the same numbers as the contiguous path on the gathered view
    dense = flash_attention(q, k, v, causal=True, lengths=lengths,
                            q_offset=kw["q_offset"],
                            sliding_window=kw["sliding_window"])
    torch.testing.assert_close(got.float(), dense.float(), atol=1e-2, rtol=1e-2)


def test_paged_mode_refuses_float32(dev):
    q, k_pool, v_pool, tables, lengths, kw = _paged_inputs(dev, PAGED_CASES[2])
    with pytest.raises(ValueError, match="decode path"):
        paged_decode_attention(q.float(), k_pool.float(), v_pool.float(),
                              tables, lengths, **kw)


def test_paged_batcher_on_the_card(dev):
    """A tiny bf16 batcher on the card: every verify step's attention is a
    paged launch (layers x verify steps) and every request answers."""
    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.serve import ContinuousBatcher

    cfg = DecoderConfig(vocab_size=256, hidden_dim=256, num_layers=2,
                        num_heads=8, num_kv_heads=2, head_dim=64,
                        mlp_dim=512, max_seq_len=512)
    eng = GenerateEngine(cfg, GenerateConfig(max_new_tokens=24), seed=1,
                         device=dev)
    b = ContinuousBatcher(eng, n_slots=4, chunk=8, cache_len=512)
    try:
        before = _kernels.LAUNCHES["flash_attention.decode_paged"]
        prompts = [[3 + i] + list(range(5, 5 + 30 * i)) for i in range(6)]
        handles = [b.submit_ids(p, prefix_key="k") for p in prompts]
        outs = [h.result(timeout=300) for h in handles]
        launched = _kernels.LAUNCHES["flash_attention.decode_paged"] - before
        assert all(len(o) > 0 for o in outs)
        assert launched == cfg.num_layers * b.stats["verify_steps"] > 0
    finally:
        b.stop()
    assert b._alloc.blocks_in_use == 0


def _tiny_pool_engine(dev):
    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine

    cfg = DecoderConfig(vocab_size=256, hidden_dim=256, num_layers=2,
                        num_heads=8, num_kv_heads=2, head_dim=64,
                        mlp_dim=512, max_seq_len=512)
    return cfg, GenerateEngine(cfg, GenerateConfig(max_new_tokens=24), seed=1,
                               device=dev)


def _affine_keys(n_replicas, replica, n):
    """``n`` fresh prefix keys that session affinity routes to ``replica``
    (a fresh key is a cold admission: the prefix cache is keyed by it)."""
    keys = (f"key{j}" for j in range(10_000))
    return [next(k for k in keys if zlib.crc32(k.encode()) % n_replicas == replica)
            for _ in range(n)]


def test_pool_on_the_card_launch_identity_and_no_leak(dev):
    """Two replicas (two worker threads, two streams) on the card: every
    verify step of either replica is one paged launch per layer, and after
    the drain every block is back or pinned by a prefix cache.  Then pairs
    of prompts decoded at once, one alone on each replica, give exactly the
    tokens each gives when it runs with the other replica idle: a replica's
    work on its stream does not leak into the other's.  (The paged path is
    bf16 only on the card, so the reference is the same replica's kernels;
    a lone lane's arithmetic does not depend on what else runs.)"""
    from docqa_tpu_torch.config import PoolConfig
    from docqa_tpu_torch.engines.pool import EnginePool

    cfg, eng = _tiny_pool_engine(dev)
    pool = EnginePool(eng, PoolConfig(replicas=2, n_slots=4),
                      cache_len=512, canary_interval_s=600.0, device=dev)
    try:
        stats0 = pool.stats()
        before = _kernels.LAUNCHES["flash_attention.decode_paged"]
        prompts = [[3 + i] + list(range(5, 5 + 20 * i)) for i in range(8)]
        handles = [pool.submit_ids(p, prefix_key=f"k{i % 3}") for i, p in enumerate(prompts)]
        outs = [h.result(timeout=300) for h in handles]
        launched = _kernels.LAUNCHES["flash_attention.decode_paged"] - before
        steps = pool.stats() - stats0

        pairs = [(prompts[2 * i], prompts[2 * i + 1]) for i in range(4)]
        keys = [_affine_keys(2, r, 2 * len(pairs)) for r in range(2)]
        routed0 = [r["routed"] for r in pool.status()["replicas"]]
        together, alone = [], []
        for i, pair in enumerate(pairs):
            hs = [pool.submit_ids(p, prefix_key=keys[r][i]) for r, p in enumerate(pair)]
            together.append([h.result(timeout=300) for h in hs])
        for i, pair in enumerate(pairs):
            alone.append([
                pool.submit_ids(p, prefix_key=keys[r][len(pairs) + i]).result(timeout=300)
                for r, p in enumerate(pair)
            ])
        routed = [a - b for a, b in zip((r["routed"] for r in pool.status()["replicas"]),
                                        routed0)]
        for i in range(2):
            assert pool.drain(i, timeout=120)["drained"]
        st = pool.status()
        occ = pool.kv_block_occupancy()
    finally:
        pool.stop()
    assert all(len(o) > 0 for o in outs)
    assert all(r["routed"] > 0 for r in st["replicas"])
    assert launched == cfg.num_layers * (steps["verify_steps"] + steps["warmup_steps"]) > 0
    assert occ["blocks_used"] == occ.get("prefix_blocks", 0)
    assert routed == [2 * len(pairs), 2 * len(pairs)]
    assert all(len(o) > 0 for pair in together for o in pair)
    assert together == alone


def test_pool_construction_raises_when_the_kernels_cannot_load(dev, monkeypatch):
    from docqa_tpu_torch.config import PoolConfig
    from docqa_tpu_torch.engines.pool import EnginePool
    from docqa_tpu_torch.ops import attention

    def cannot_load(name):
        raise _kernels.KernelError(f"cannot load lib{name}")

    _, eng = _tiny_pool_engine(dev)
    monkeypatch.setattr(_kernels, "load", cannot_load)
    attention._paged_fn.cache_clear()
    try:
        with pytest.raises(_kernels.KernelError, match="cannot load"):
            EnginePool(eng, PoolConfig(replicas=2, n_slots=4), cache_len=512,
                       device=dev)
    finally:
        attention._paged_fn.cache_clear()


def test_ingest_pipeline_on_the_card(dev):
    """32 uploads through ``DocumentPipeline`` on the card in float32 (K1's
    SIMT path) and on the CPU: the same statuses, rows and masked texts,
    embeddings within 1e-4; on the card, K1 launches = tagger layers x
    tagger forwards + encoder layers x encoder forwards.  The random tagger's
    head is scaled up so that every word's label is decided by a wide
    margin, and the threshold is 0, so the tagger's spans reach the text."""
    import numpy as np

    from docqa_tpu_torch.config import (
        Config, EncoderConfig, NERConfig, StoreConfig,
    )
    from docqa_tpu_torch.deid import datagen
    from docqa_tpu_torch.deid.engine import DeidEngine
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.models.ner import init_ner_params
    from docqa_tpu_torch.service import registry as reg
    from docqa_tpu_torch.service.broker import make_broker
    from docqa_tpu_torch.service.pipeline import DocumentPipeline

    enc_cfg = EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
                            mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
    ner_cfg = NERConfig(vocab_size=512, hidden_dim=128, num_layers=2, num_heads=4,
                        mlp_dim=256, max_seq_len=128, dtype="float32")
    params = init_ner_params(ner_cfg, seed=3)
    params["head_w"] = params["head_w"] * 50
    rng = np.random.default_rng(8)
    docs = []
    for i in range(32):
        parts = [f"Tél : 06 12 34 {i:02d} 78 — courriel : p{i}@chu.fr."]
        while len(" ".join(parts)) < 900:
            parts.append(datagen.generate_example(rng)[0])
        docs.append((f"note{i}.txt", "\n".join(parts).encode()))

    def run(device):
        cfg = Config(encoder=enc_cfg, ner=ner_cfg, store=StoreConfig(dim=64))
        pipe = DocumentPipeline(
            cfg, make_broker(cfg.broker), reg.DocumentRegistry(),
            DeidEngine(ner_cfg, params=params, ner_threshold=0.0, device=device),
            EncoderEngine(enc_cfg, seed=1, device=device),
            VectorStore(cfg.store, device=device),
        )
        ids = [pipe.ingest_document(name, data).doc_id for name, data in docs]
        before = dict(_kernels.LAUNCHES)
        pipe.start()
        try:
            assert all(pipe.wait_indexed(d, timeout=120) for d in ids)
        finally:
            pipe.stop()
        launched = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
                    for k in ("flash_attention", "flash_attention.simt")}
        rows = [dict(r, doc_id=ids.index(r["doc_id"])) for r in pipe.store.metadata_rows()]
        n = pipe.store.count
        return (rows, [pipe.registry.get(d).n_chunks for d in ids],
                pipe.store._host[:n].copy(), launched, pipe.deid.forwards,
                pipe.encoder.forwards)

    rows, chunks, emb, launched, n_ner, n_enc = run(dev)
    c_rows, c_chunks, c_emb, _, _, _ = run("cpu")
    assert rows == c_rows and chunks == c_chunks and sum(chunks) == len(rows)
    assert not any("@chu.fr" in r["text_content"] for r in rows)
    assert any("<PERSON>" in r["text_content"] for r in rows)
    np.testing.assert_allclose(emb, c_emb, atol=1e-4, rtol=0)
    want = ner_cfg.num_layers * n_ner + enc_cfg.num_layers * n_enc
    assert launched == {"flash_attention": want, "flash_attention.simt": want} and n_ner > 0


def _fused_rag(device, dtype):
    """A tiny fused /ask stack: encoder, decoder (head dim 32, K1's smallest
    tensor-core width) and a float32 store of clinical sentences with their
    sidecar rows."""
    import numpy as np

    from docqa_tpu_torch.config import (
        DecoderConfig, EncoderConfig, GenerateConfig, StoreConfig,
    )
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.rag_fused import FusedRAG
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.service.qa import QA_TEMPLATE

    enc = EncoderEngine(EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2,
                                      num_heads=2, mlp_dim=128, max_seq_len=128,
                                      embed_dim=64, dtype=dtype), seed=1, device=device)
    gen = GenerateEngine(DecoderConfig(vocab_size=256, hidden_dim=128, num_layers=2,
                                       num_heads=4, num_kv_heads=2, head_dim=32,
                                       mlp_dim=256, max_seq_len=1024, dtype=dtype),
                         GenerateConfig(max_new_tokens=8, prefill_buckets=(64, 128, 256, 512)),
                         seed=2, device=device)
    store = VectorStore(StoreConfig(dim=64, token_width=32, dtype="float32"), device=device)
    texts = [f"patient P{i:03d} takes drug{i % 7} {10 * i} mg for condition{i % 5}"
             for i in range(40)]
    rows = np.zeros((len(texts), 32), np.int32)
    for i, t in enumerate(texts):
        ids = gen.tokenizer.encode(t, add_specials=False)[:32]
        rows[i, : len(ids)] = ids
    store.add(enc.encode_texts(texts), [{"source": f"s{i}", "text_content": t}
                                        for i, t in enumerate(texts)], token_rows=rows)
    return FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device=device)


def _sync_window(rag, windows):
    """Sync debug mode "error" from the query encode's first launch to the
    prefill's last (the generator marks its prefill done before the decode
    loop's first exit test); returns the undo."""
    enc, gen = rag.encoder, rag.generator
    real_encode, real_mark = enc.encode_ids, gen._mark_prefill

    def encode_ids(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        windows.append("open")
        return real_encode(*a, **kw)

    def mark_prefill():
        torch.cuda.set_sync_debug_mode(0)
        windows.append("closed")
        return real_mark()

    enc.encode_ids, gen._mark_prefill = encode_ids, mark_prefill

    def undo():
        torch.cuda.set_sync_debug_mode(0)
        del enc.encode_ids, gen._mark_prefill

    return undo


def test_fused_chain_makes_no_host_sync_on_the_card(dev):
    rag = _fused_rag(dev, "bfloat16")
    question = "which drug does patient P007 take?"
    rag.ask(question)  # builds the kernels and the shape's constants
    before = dict(_kernels.LAUNCHES)
    windows = []
    undo = _sync_window(rag, windows)
    try:
        out = rag.ask(question)
    finally:
        undo()
    assert windows == ["open", "closed"] and len(out["sources"]) == 3
    launched = {k: _kernels.LAUNCHES[k] - before.get(k, 0)
                for k in ("flash_attention.prefill", "flash_attention.decode")}
    steps = rag.generator.last_stats["forwards"] - 1
    assert launched == {"flash_attention.prefill": 2 + 2, "flash_attention.decode": 2 * steps}


def test_fused_ask_on_the_card_equals_the_cpu_in_float32(dev):
    question = "which drug does patient P012 take?"
    card, cpu = _fused_rag(dev, "float32"), _fused_rag("cpu", "float32")
    got, want = card.ask_submit(question), cpu.ask_submit(question)
    assert got.prompt_tokens() == want.prompt_tokens()
    assert got.resolve() == want.resolve()


def test_card_snapshot_restores_to_equal_ids(dev, tmp_path):
    import numpy as np

    from docqa_tpu_torch.config import StoreConfig
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.runtime import native

    cfg = StoreConfig(dim=64, token_width=16)  # bf16 on the card
    rng = np.random.default_rng(4)
    store = VectorStore(cfg, device=dev)
    store.add(rng.standard_normal((3000, 64)).astype(np.float32),
              [{"doc_id": f"d{i // 3}", "source": f"s{i}"} for i in range(3000)],
              token_rows=rng.integers(1, 500, (3000, 16)))
    store.delete_docs(["d5", "d77"])
    store.snapshot(str(tmp_path))
    restored = VectorStore.restore(str(tmp_path), cfg, device=dev)
    assert native.RUNS[("read", "native")] >= 1
    q = rng.standard_normal((8, 64)).astype(np.float32)
    assert ([[h.row_id for h in r] for r in restored.search(q, k=10)]
            == [[h.row_id for h in r] for r in store.search(q, k=10)])
    for a, b in zip(store.token_sidecar(), restored.token_sidecar()):
        assert torch.equal(a[: store.count], b[: store.count])
    assert restored.version == store.version


def test_flash_wrapper_refuses_autograd_on_the_card(dev):
    """K1 has no backward: a grad-requiring input raises before any launch
    (the CPU test pins the same refusal), and the serving forward of a
    tagger whose params need grad raises; no_grad launches as usual."""
    from docqa_tpu_torch.config import NERConfig
    from docqa_tpu_torch.models.ner import init_ner_params, ner_forward
    from docqa_tpu_torch.training.ner import trainable

    q, k, v, kw = _inputs(dev, CASES[1], torch.bfloat16)
    before = _kernels.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="use_flash=False"):
        flash_attention(q.requires_grad_(), k, v, **kw)
    assert _kernels.LAUNCHES["flash_attention"] == before
    cfg = NERConfig(vocab_size=512, hidden_dim=64, num_layers=1, num_heads=2,
                    mlp_dim=128, max_seq_len=64)
    params = trainable(init_ner_params(cfg, 0), cfg, dev)
    ids = torch.randint(5, 500, (2, 64), device=dev)
    lengths = torch.tensor([64, 30], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="use_flash=False"):
        ner_forward(params, cfg, ids, lengths)
    with torch.no_grad():
        ner_forward(params, cfg, ids, lengths)
    assert _kernels.LAUNCHES["flash_attention"] == before + 1


def test_train_ner_on_the_card_equals_the_cpu(dev):
    """Five steps of train_ner in float32 from one tree and one batch
    stream: the card (plain attention under autograd, no K1 launch) and
    the CPU agree within 1e-4 on every param (float32, other reduction
    orders; Adam turns an eps-sized gradient's rounding into up to a
    step's lr, 2e-3 x the warmup's factor here)."""
    from docqa_tpu_torch.config import NERConfig
    from docqa_tpu_torch.models.ner import init_ner_params
    from docqa_tpu_torch.training.ner import train_ner

    cfg = NERConfig(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
                    mlp_dim=128, max_seq_len=64, dtype="float32")
    init = init_ner_params(cfg, 3)
    kw = dict(steps=5, batch_size=8, seq=48, seed=0, log_every=0, params=init)
    before = _kernels.LAUNCHES["flash_attention"]
    card = train_ner(cfg, device=dev, **kw)
    assert _kernels.LAUNCHES["flash_attention"] == before
    cpu = train_ner(cfg, device="cpu", **kw)
    for name, value in cpu.items():
        torch.testing.assert_close(card[name].cpu(), value, rtol=0, atol=1e-4)


def _tiered_stack(dev, n=3000, seed=0):
    """A float32 store of clustered rows with a lexical tier and a tiered
    index over it, on ``dev``: the same seeded inputs on every device."""
    import numpy as np

    from docqa_tpu_torch.config import EncoderConfig, StoreConfig
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
    from docqa_tpu_torch.index.lexical import LexicalIndex
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.index.tiered import TieredIndex

    enc = EncoderEngine(EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=1,
                                      num_heads=2, mlp_dim=128, max_seq_len=64,
                                      embed_dim=64, dtype="float32"), seed=1, device=dev)
    texts = [f"note {i}: drug-{i % 13} for condition-{i % 7} ward {i % 11}" for i in range(n)]
    emb = enc.encode_texts(texts)
    rng = np.random.default_rng(seed)
    emb = emb + 0.05 * rng.standard_normal(emb.shape).astype(np.float32)
    store = VectorStore(StoreConfig(dim=64, dtype="float32", shard_capacity=4096), device=dev)
    lex = LexicalIndex(vocab_size=4096, tile_width=8, device=dev)
    store.register_index_sink(lex)
    store.add(emb, [{"doc_id": f"d{i}", "text_content": t} for i, t in enumerate(texts)])
    tiered = TieredIndex(store, nprobe=4, min_rows=1000, lexical=lex)
    return enc, tiered, FusedTieredRetriever(enc, tiered, device=dev)


def carry_tier(src, dst):
    """Publish ``src``'s IVF tier (built on its device) as ``dst``'s."""
    from docqa_tpu_torch.index.ivf import ivf_from_arrays

    ivf, covered = src._tier
    carried = ivf_from_arrays(ivf.arrays(), ivf._meta, nprobe=ivf.nprobe,
                              dtype=str(dst.store.cfg.dtype), device=dst.device)
    carried._store_compactions = dst.store.compactions
    dst._tier = (carried, covered)


def test_tiered_search_on_the_card_equals_the_cpu_in_float32(dev):
    """The CPU's tier carried to the card, then dense and hybrid fused
    searches: the same top-k ids but for a tie at the k-th score, scores
    within 1e-5 (float32 sums in another order).  The card's own build
    runs too and serves."""
    import numpy as np

    (_e, card_tier, card), (_c, cpu_tier, cpu) = _tiered_stack(dev), _tiered_stack("cpu")
    assert card_tier.rebuild() and cpu_tier.rebuild()
    assert card.search_texts(["drug-3"], k=3)[0]
    carry_tier(cpu_tier, card_tier)
    qs = ["drug-3 for condition-3", "ward 7 drug-12", "note 42", "condition-5"]
    for mode in ("dense", "hybrid"):
        for got, want in zip(card.search_texts(qs, k=8, mode=mode),
                             cpu.search_texts(qs, k=8, mode=mode)):
            gs, ws = np.array([h.score for h in got]), np.array([h.score for h in want])
            np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
            cut = ws[-1] + 2e-5
            assert ({h.row_id for h in got if h.score > cut}
                    == {h.row_id for h in want if h.score > cut})


def test_tier_rebuild_device_fault_reaches_search_on_the_card(dev, monkeypatch):
    from docqa_tpu_torch.index import tiered as tiered_mod

    _e, tier, retr = _tiered_stack(dev)
    tier.rebuild_tail_rows = 100

    def broken(*a, **kw):
        raise _kernels.KernelError("probe kernel failed to launch")

    monkeypatch.setattr(tiered_mod, "IVFIndex", broken)
    retr.search_texts(["drug-1"], k=3)  # starts the rebuild, served exact
    tier._rebuild_thread.join(60)
    with pytest.raises(_kernels.KernelError):
        retr.search_texts(["drug-1"], k=3)
    with pytest.raises(_kernels.KernelError):
        tier.close()


# BART's attentions on the seq2seq path (16 heads of 64, no GQA): the
# decoder's cross-attention is K1's decode path NOT causal, over a source
# padded to its bucket with short live lengths; the encoder is prefill, not
# causal; the self-attention over the cache is decode, causal
BART_CASES = [
    (32, 1, 1024, 16, 16, 64, False, None,
     [n for n in (300, 1024, 517, 1024, 811, 402, 1024, 655) for _ in range(4)], None),
    (4, 1, 256, 16, 16, 64, False, None, [1, 17, 64, 200], None),
    (4, 1, 1024, 16, 16, 64, False, None, [0, 5, 63, 64], None),
    (8, 1024, 1024, 16, 16, 64, False, None, [300, 1024, 517, 1024, 811, 402, 1024, 655],
     None),
    (32, 1, 143, 16, 16, 64, True, None, [71] * 32, [70] * 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BART_CASES)
def test_kernel_matches_plain_at_bart_shapes(dev, case, dtype):
    test_kernel_matches_plain(dev, case, dtype)


def _tiny_bart(**policy):
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.config import Seq2SeqConfig

    cfg = Seq2SeqConfig(vocab_size=256, d_model=64, enc_layers=2, dec_layers=2,
                        num_heads=2, mlp_dim=128, max_src_len=64, max_tgt_len=40,
                        dtype="float32", **policy)
    tree = weights.host_init_seq2seq_params(cfg, seed=5)
    tree["final_logits_bias"][cfg.eos_id] = -1e9  # run the whole horizon
    return cfg, tree


@pytest.mark.parametrize("policy", [
    {}, {"num_beams": 4, "length_penalty": 2.0, "min_length": 6, "no_repeat_ngram": 2},
], ids=["greedy", "beam4"])
def test_seq2seq_on_the_card_equals_the_cpu_in_float32(dev, policy):
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

    cfg, tree = _tiny_bart(**policy)
    src = [[5, 9, 11, 7, 3], list(range(3, 40)), [8] * 20]
    before = dict(_kernels.LAUNCHES)
    card = Seq2SeqEngine(cfg, params=tree, device=dev)
    got = card.generate_ids(src, max_new_tokens=30)
    steps = card.last_stats["steps"]
    cpu = Seq2SeqEngine(cfg, params=tree, device="cpu").generate_ids(src, max_new_tokens=30)
    assert got == cpu and all(len(x) == 30 for x in got)
    # 2 encoder layers on the f32 path, then 2 x 2 per decoder forward
    launched = _kernels.LAUNCHES["flash_attention"] - before.get("flash_attention", 0)
    assert launched == 2 + 4 * (steps + 1)
    assert card.last_stats["flag_reads"] <= -(-steps // card.check_every) + 1


def test_seq2seq_loop_makes_no_host_sync_between_checks(dev, monkeypatch):
    """bf16 beam search: between two reads of the termination flag the
    loop makes no host sync (CUDA's sync debug mode raises on one)."""
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.models import seq2seq as s2s

    cfg, tree = _tiny_bart()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = s2s.serving_params(weights.to_torch(tree, dev), cfg)
    real, windows = s2s._done_check, []

    def check(done, step, every, stats):
        torch.cuda.set_sync_debug_mode(0)
        out = real(done, step, every, stats)
        windows.append(step)
        torch.cuda.set_sync_debug_mode("error")
        return out

    monkeypatch.setattr(s2s, "_done_check", check)
    ids = torch.tensor([[5, 9, 11, 7, 3, 1], [4, 8, 2, 6, 10, 12]], device=dev)
    lens = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    try:
        with torch.inference_mode():
            out, n = s2s.beam_summarize(params, cfg, ids, lens, max_new=36, n_beams=4,
                                        length_penalty=2.0, min_length=4,
                                        no_repeat_ngram=3, check_every=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert windows == list(range(1, 36))
    assert n.tolist() == [36, 36] and out.shape == (2, 36)


# ---- K4: the weight-only quantised matmul ------------------------------------

# (m, in, out, bits, group[, ldx]): the solo verify and a batcher verify at
# Mistral-7B widths, a prefill past 64 rows, and ragged shapes (rows and
# columns off the 16-byte vectors, an odd int4 group padded by the wrapper,
# a degraded group of 2); then each mode's edges: the ring's 16-, 32- and
# 64-row tiles (m 1 to 64) and the wgmma units past 64 rows, a K tile cut
# short, int4 groups that do and do not span a stage, x as a strided view
# (ldx a 16-byte multiple, read in place; and not, copied), and m = 0
QCASES = [
    (4, 4096, 1024, 8, None), (4, 4096, 1024, 4, None), (64, 4096, 4096, 4, None),
    (300, 1024, 512, 8, None), (300, 1024, 512, 4, None),
    (5, 64, 40, 8, None), (37, 100, 130, 8, None), (3, 45, 24, 4, None),
    (70, 96, 200, 4, 48), (17, 298, 20, 4, None),
    (1, 1024, 1024, 8, None), (1, 1024, 1024, 4, None), (8, 1024, 1024, 4, None),
    (16, 4096, 1024, 8, None), (17, 1024, 512, 4, None), (17, 1024, 512, 8, None),
    (63, 1024, 1024, 8, None), (64, 1024, 1024, 8, None), (65, 1024, 1024, 8, None),
    (65, 1024, 1024, 4, None), (128, 1024, 1024, 4, None), (129, 1024, 1024, 8, None),
    (300, 4096, 1024, 4, None), (4, 256, 20, 8, None), (70, 256, 130, 4, None),
    (4, 1000, 1024, 8, None), (100, 1000, 512, 8, None), (4, 1004, 256, 8, None),
    (9, 1000, 128, 4, None), (4, 512, 256, 4, 64), (4, 512, 256, 4, 256),
    (100, 512, 256, 4, 256), (4, 1024, 1024, 8, None, 1032),
    (80, 1024, 512, 4, None, 1030), (4, 96, 40, 8, None, 100), (0, 1024, 1024, 8, None),
    (4, 4096, 1000, 8, None),
]


def _qinputs(dev, m, k, n, bits, group, ldx=None):
    from docqa_tpu_torch.models import quant

    gen = torch.Generator(device=dev).manual_seed(m * 7919 + k + n + bits)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    q, s = quant.quantize_array(w) if bits == 8 else quant.quantize_array_int4(w, group)
    x = torch.randn((m, ldx or k), generator=gen, device=dev).to(torch.bfloat16)[:, :k]
    return x, q, s


@pytest.mark.parametrize("case", QCASES)
def test_qmatmul_kernel_matches_plain(dev, case):
    """K4 against its plain version at K1's bf16 tolerance (both sum in
    float32 and round once to bf16), one launch counted a call."""
    from docqa_tpu_torch.ops import qmatmul as qm

    x, q, s = _qinputs(dev, *case)
    mode = "int8" if case[3] == 8 else "int4"
    before = dict(_kernels.LAUNCHES)
    got = qm.qmatmul(x, q, s)
    torch.cuda.synchronize()
    launched = int(x.shape[0] > 0)  # m = 0 returns an empty product unlaunched
    kernel = getattr(q, qm._STORE).plan(max(x.shape[0], 1)).kernel
    for name in ("qmatmul", f"qmatmul.{mode}", f"qmatmul.{kernel}"):
        assert _kernels.LAUNCHES[name] == before.get(name, 0) + launched
    want = qm.qmatmul_reference(x, q, s)
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("case", [QCASES[0], QCASES[2], QCASES[7], QCASES[8]])
def test_qmatmul_one_hot_rows_are_the_dequantised_weight_rows(dev, case):
    """x a batch of one-hot rows: K4's output is the dequantised weight's
    rows bit for bit (one nonzero product a sum, W~ already bf16)."""
    from docqa_tpu_torch.ops import qmatmul as qm

    m, k, n, bits, group = case
    _x, q, s = _qinputs(dev, *case)
    rows = torch.arange(m, device=dev) * 7 % k
    onehot = torch.zeros((m, k), dtype=torch.bfloat16, device=dev)
    onehot[torch.arange(m, device=dev), rows] = 1
    got = qm.qmatmul(onehot, q, s)
    assert torch.equal(got, qm.dequantize(q, s, torch.bfloat16, k)[rows])


# one case a mode: the ring's three tile heights with and without split K,
# wgmma with and without split K, int8 and int4, and the simple mode
QMODES = [
    (4, 4096, 1024, 8, None), (4, 4096, 1024, 4, None), (32, 1024, 4096, 8, None),
    (64, 4096, 4096, 4, None), (64, 1024, 14336, 8, None), (2048, 1024, 1024, 8, None),
    (100, 4096, 256, 8, None), (128, 8192, 256, 4, None), (200, 1024, 4096, 4, None),
    (37, 100, 130, 8, None), (4, 4096, 1000, 8, None),
    (70, 96, 200, 4, 48), (4, 4096, 1024, 8, None, 4104),
]


@pytest.mark.parametrize("case", QMODES)
def test_qmatmul_one_hot_rows_in_every_mode(dev, case):
    """The one-hot identity in each kernel mode, split or not: an output row
    is one dequantised weight row, bit for bit, whichever block sums it."""
    from docqa_tpu_torch.ops import qmatmul as qm

    m, k = case[0], case[1]
    _x, q, s = _qinputs(dev, *case)
    rows = torch.arange(m, device=dev) * 131 % k
    onehot = torch.zeros((m, case[5] if len(case) > 5 else k), dtype=torch.bfloat16,
                         device=dev)[:, :k]
    onehot[torch.arange(m, device=dev), rows] = 1
    got = qm.qmatmul(onehot, q, s)
    assert torch.equal(got, qm.dequantize(q, s, torch.bfloat16, k)[rows])


@pytest.mark.parametrize("case", [(4, 4096, 1024, 8, None), (4, 4096, 1024, 4, None),
                                  (100, 4096, 256, 8, None), (2048, 4096, 1024, 4, None),
                                  (4, 4096, 1000, 8, None)])
def test_qmatmul_repeats_bit_for_bit(dev, case):
    """Two products of the same inputs are equal bit for bit: at the split
    shape (wk at the solo verify, K summed by the last block in split order),
    at prefill shapes (persistent units, split and not) and at a ragged
    split the simple kernel takes."""
    from docqa_tpu_torch.ops import qmatmul as qm

    x, q, s = _qinputs(dev, *case)
    first = qm.qmatmul(x, q, s)
    for _ in range(3):
        assert torch.equal(qm.qmatmul(x, q, s), first)


def test_qmatmul_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from docqa_tpu_torch.ops import qmatmul as qm

    x, q, s = _qinputs(dev, 4, 64, 32, 8, None)
    with pytest.raises(ValueError, match="bf16"):
        qm.qmatmul(x.float(), q, s)
    with pytest.raises(ValueError, match="forward-only"):
        qm.qmatmul(x.float().requires_grad_(), q, s)
    with pytest.raises(ValueError, match="does not fit"):
        qm.qmatmul(x[:, :32], q, s)


def test_qmatmul_store_is_validated_once_and_renewed_for_a_copy(dev):
    """A leaf is validated at its first product and its store kept on the
    weight: products at other row counts (the thread's split-K partials
    reused at several sizes, back to back) stay within K1's bf16 tolerance
    of the plain version; a copy of the weight or another scale gets a
    store of its own; a misfitting x still raises after a product."""
    import copy

    from docqa_tpu_torch.ops import qmatmul as qm

    x, q, s = _qinputs(dev, 4, 4096, 1024, 8, None)
    gen = torch.Generator(device=dev).manual_seed(3)
    qm.qmatmul(x, q, s)
    store = getattr(q, qm._STORE)
    outs = []
    for m in (4, 64, 1, 17, 300):
        xm = torch.randn((m, 4096), generator=gen, device=dev).to(torch.bfloat16)
        outs.append((qm.qmatmul(xm, q, s), qm.qmatmul_reference(xm, q, s)))
    for got, want in outs:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    assert getattr(q, qm._STORE) is store
    q2 = copy.deepcopy(q)
    torch.testing.assert_close(qm.qmatmul(x, q2, s).float(), qm.qmatmul(x, q, s).float(),
                               atol=0, rtol=0)
    assert getattr(q2, qm._STORE).w_ptr == q2.data_ptr() != store.w_ptr
    s2 = s * 2
    torch.testing.assert_close(qm.qmatmul(x, q, s2).float(),
                               qm.qmatmul_reference(x, q, s2).float(), atol=1e-2, rtol=1e-2)
    assert getattr(q, qm._STORE).scale is s2
    with pytest.raises(ValueError, match="does not fit"):
        qm.qmatmul(x[:, :32], q, s)


def test_quantised_engine_on_the_card_equals_its_plain_path(dev):
    """A quantised engine's first-step logits through K4 within 5e-2
    relative RMS of the same tree through the plain version, int8 and
    int4, and (7 L + 1) K4 launches a forward."""
    import dataclasses

    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.models.decoder import decoder_forward, init_kv_cache
    from docqa_tpu_torch.ops import qmatmul as qm

    base = DecoderConfig(vocab_size=512, hidden_dim=256, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=256)
    ids = torch.tensor([[3, 9, 17, 4, 8, 1, 2, 30]], device=dev)
    for bits in (8, 4):
        cfg = dataclasses.replace(base, quantize_weights=True, quant_bits=bits)
        eng = GenerateEngine(cfg, GenerateConfig(max_new_tokens=4), seed=3, device=dev)

        def first():
            cache = init_kv_cache(cfg, 1, max_len=64, device=dev)
            return decoder_forward(eng.params, cfg, ids, cache,
                                   torch.zeros(1, dtype=torch.int32, device=dev),
                                   last_token_only=True).float()

        before = _kernels.LAUNCHES["qmatmul"]
        got = first()
        assert _kernels.LAUNCHES["qmatmul"] - before == 7 * cfg.num_layers + 1
        kernel = qm.qmatmul
        qm.qmatmul = qm.qmatmul_reference
        try:
            want = first()
        finally:
            qm.qmatmul = kernel
        assert float((got - want).norm() / want.norm()) < 5e-2
        assert eng.generate_ids([[3, 5, 9]])[0] is not None


def test_probe_int4_support_launches_k4_on_the_card(dev):
    from docqa_tpu_torch.models import quant

    before = _kernels.LAUNCHES["qmatmul.int4"]
    assert quant.probe_int4_support(dev) == (True, "")
    assert _kernels.LAUNCHES["qmatmul.int4"] == before + 1
