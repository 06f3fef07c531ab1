"""The plain reference held to the port at tiny widths on the CPU.

The reference (``portbench/reference``) imports nothing of the port; this
test imports both and shows that, given the same weights and inputs, they
compute the same thing: the tokenizer and prompt template, the encoder's
embedding, the decoder's logits, and the int8 and int4 quantisers.
"""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.flops import ModelShape
from portbench.reference import models, text

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference")

TINY = ModelShape(vocab=300, hidden=64, layers=2, heads=4, kv_heads=2, head_dim=16, mlp=96,
                  window=None)
ENC = {"vocab_size": 500, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
       "intermediate_size": 48, "max_position_embeddings": 64}


def test_reference_imports_nothing_of_the_program():
    for name in sorted(os.listdir(REF_DIR)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name), encoding="utf-8").read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("docqa_tpu_torch", "docqa_tpu", "jax", "jaxlib"), (
                    f"{name} imports {m}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizer_and_template_match_the_port(seed):
    from docqa_tpu_torch.service.qa import QA_TEMPLATE
    from docqa_tpu_torch.text.tokenizer import HashTokenizer

    assert text.QA_TEMPLATE == QA_TEMPLATE
    tok = HashTokenizer(32000)
    chunks = inputs.text_pool(seed, 4, 50)
    q = inputs.questions(seed, 1, 12)[0]
    prompt = text.prompt_text(q, chunks)
    assert prompt == QA_TEMPLATE.format(context="\n\n".join(chunks), question=q)
    assert text.encode(prompt, 32000) == tok.encode(prompt)
    assert text.encode(q, 30522, 512) == HashTokenizer(30522).encode(q, 512)
    assert all(len(text.pieces(c)) == 50 for c in chunks)


def test_encoder_embedding_matches_the_port():
    from docqa_tpu_torch.config import EncoderConfig
    from docqa_tpu_torch.models.encoder import encode_batch

    params = inputs.encoder_weights(ENC, 3, "cpu")
    cfg = EncoderConfig(vocab_size=ENC["vocab_size"], hidden_dim=32, num_layers=2, num_heads=2,
                        mlp_dim=48, max_seq_len=64, embed_dim=32, dtype="float32")
    ids = text.encode("expliquez le traitement du patient sous metformine ?", ENC["vocab_size"])
    with models.exact_float32():
        want = models.bert_embed(params, 2, 2, ids, "cpu")
        got = encode_batch(params, cfg, torch.tensor([ids]), torch.tensor([len(ids)]),
                           use_flash=False)[0]
    torch.testing.assert_close(want, got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [16, 8])
def test_decoder_logits_match_the_port(bits):
    from docqa_tpu_torch.config import DecoderConfig
    from docqa_tpu_torch.models.decoder import decoder_forward, init_kv_cache
    from docqa_tpu_torch.models.quant import quantize_decoder_params

    weights = inputs.decoder_weights(TINY, 5, "cpu", torch.float32)
    cfg = DecoderConfig(vocab_size=300, hidden_dim=64, num_layers=2, num_heads=4,
                        num_kv_heads=2, head_dim=16, mlp_dim=96, max_seq_len=128,
                        rope_theta=1e6, dtype="float32", quantize_weights=bits == 8)
    params = dict(weights)
    if bits == 8:
        params = quantize_decoder_params({k: v.clone() for k, v in weights.items()}, 8)
    seq = [2] + list(np.random.default_rng(0).integers(5, 300, size=40)) + [3]
    n = len(seq)
    cache = init_kv_cache(cfg, 1, max_len=128, dtype=torch.float32)
    with models.exact_float32():
        got = decoder_forward(params, cfg, torch.tensor([seq]), cache, torch.zeros(1, dtype=torch.int32),
                              attn_lengths=torch.tensor([n], dtype=torch.int32), use_flash=False)[0]
        want = models.decoder_logits(weights, TINY, [seq], [10], "cpu", bits=bits,
                                     rope_theta=1e6, norm_eps=1e-5)[0]
    torch.testing.assert_close(want, got[10:], rtol=1e-4, atol=1e-4)


def test_quantisers_match_the_port():
    from docqa_tpu_torch.models.quant import quantize_array, quantize_array_int4
    from docqa_tpu_torch.ops.qmatmul import qmatmul_reference

    w = torch.randn((256, 48), generator=torch.Generator().manual_seed(0)) * 0.05
    q, s = quantize_array(w)
    torch.testing.assert_close(models.int8_columns(w), q.float() * s[None, :], rtol=0, atol=0)
    q4, s4 = quantize_array_int4(w)
    eye = torch.eye(256)
    dequant = qmatmul_reference(eye, q4, s4).float()
    torch.testing.assert_close(models.int4_groups(w), dequant, rtol=1e-6, atol=1e-7)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reference_on_the_card_agrees_with_the_cpu(card):
    weights = inputs.decoder_weights(TINY, 7, "cpu", torch.float32)
    seq = list(range(2, 60))
    with models.exact_float32():
        cpu = models.decoder_logits(weights, TINY, [seq], [0], "cpu")[0]
        gpu = models.decoder_logits({k: v.to(card) for k, v in weights.items()}, TINY, [seq],
                                    [0], card)[0].cpu()
    torch.testing.assert_close(cpu, gpu, rtol=1e-4, atol=1e-4)


def test_every_seed_serves_the_same_decoder_function():
    """The decoder's leaves differ from seed to seed, but only by the order
    of the hidden and intermediate units, so the logits agree."""
    seq = [[2] + list(range(7, 40)) + [3]]
    a = inputs.decoder_weights(TINY, 1, "cpu", torch.float32)
    b = inputs.decoder_weights(TINY, 2**31 + 5, "cpu", torch.float32)
    assert not torch.equal(a["l0_w_gate"], b["l0_w_gate"])
    assert not torch.equal(a["tok_emb"], b["tok_emb"])
    with models.exact_float32():
        la = models.decoder_logits(a, TINY, seq, [0], "cpu", rope_theta=1e4, norm_eps=1e-5)
        lb = models.decoder_logits(b, TINY, seq, [0], "cpu", rope_theta=1e4, norm_eps=1e-5)
    assert torch.allclose(la[0], lb[0], atol=1e-4, rtol=1e-4)
