"""Port parity, generation: docqa_tpu_torch's GenerateEngine against
docqa_tpu's on the same seeded weights (CPU, float32, 2 layers).

Greedy token streams must be identical — exact equality, no tolerance:
both engines take the argmax of float32 logits that agree to ~1e-6.
The port's K=4 prompt-lookup speculation must equal its own K=0 decode.
"""

import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.generate import (
    GenerateEngine,
    accept_drafts,
    draft_tokens,
)

torch.set_num_threads(1)

DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
GEN = dict(max_new_tokens=14, prefill_buckets=(32, 64, 128))
SEED = 3

# a repetitive prompt (drafts hit), a short one, and a single token
PROMPTS = [
    [2, 5, 9, 17, 33, 5, 9, 17, 40, 5, 9, 17, 3],
    [2, 7, 7, 8, 100, 3],
    [2],
]


@pytest.fixture(scope="module")
def reference_streams():
    """docqa_tpu's greedy output: default speculation (K=4) and plain."""
    out = {}
    for k in (4, 0):
        eng = JGenerateEngine(
            JDecoderConfig(**DEC), JGenerateConfig(**GEN, speculative_k=k),
            seed=SEED,
        )
        out[k] = eng.generate_ids(PROMPTS)
    assert out[4] == out[0]  # the reference's own invariant
    return out


@pytest.fixture(scope="module")
def engines():
    return {
        k: GenerateEngine(
            DecoderConfig(**DEC), GenerateConfig(**GEN, speculative_k=k),
            seed=SEED, device="cpu",
        )
        for k in (4, 0)
    }


class TestGreedyParity:
    @pytest.mark.parametrize("spec_k", [4, 0])
    def test_tokens_identical_to_reference(self, engines, reference_streams, spec_k):
        got = engines[spec_k].generate_ids(PROMPTS)
        assert got == reference_streams[0]
        assert all(len(row) == GEN["max_new_tokens"] for row in got[:2])

    def test_speculation_equals_plain_on_long_run(self, engines):
        prompt = [[2] + [11, 12, 13, 14] * 6 + [3]]
        a = engines[4].generate_ids(prompt, max_new_tokens=40)
        b = engines[0].generate_ids(prompt, max_new_tokens=40)
        assert a == b
        # speculation saved forwards: fewer verify steps than tokens
        assert engines[4].last_stats["forwards"] <= engines[0].last_stats["forwards"]

    def test_texts_identical_to_reference(self, engines):
        ref = JGenerateEngine(
            JDecoderConfig(**DEC, chat_template="mistral-inst"),
            JGenerateConfig(**GEN), seed=SEED,
        )
        port = GenerateEngine(
            DecoderConfig(**DEC, chat_template="mistral-inst"),
            GenerateConfig(**GEN), seed=SEED, device="cpu",
        )
        prompt = "patient sous metformine 500 mg ; quelle dose ?"
        assert port.encode_prompt(prompt, 20) == ref.encode_prompt(prompt, 20)
        assert port.generate_texts([prompt]) == ref.generate_texts([prompt])

    def test_eos_stops_and_is_excluded(self, engines):
        """An eos_id equal to the first greedy token ends the stream empty."""
        first = engines[0].generate_ids([PROMPTS[1]], max_new_tokens=1)[0][0]
        for k in (4, 0):
            eng = GenerateEngine(
                DecoderConfig(**DEC),
                GenerateConfig(**GEN, speculative_k=k, eos_id=first),
                seed=SEED, device="cpu",
            )
            assert eng.generate_ids([PROMPTS[1]]) == [[]]


class TestSampling:
    def test_sampled_decode_is_seeded(self, engines):
        eng = engines[4]  # temperature > 0 takes the plain sampled loop
        a = eng.generate_ids(PROMPTS[:2], temperature=0.9, seed=1)
        b = eng.generate_ids(PROMPTS[:2], temperature=0.9, seed=1)
        assert a == b
        assert all(0 <= t < DEC["vocab_size"] for row in a for t in row)


class TestSpeculationHelpers:
    def test_draft_chain_and_acceptance(self):
        table = torch.full((2, 11), -1, dtype=torch.long)
        table[0, 3], table[0, 4] = 4, 5  # lane 0: 3 -> 4 -> 5
        drafts = draft_tokens(table, torch.tensor([3, 7]), K=4)
        assert drafts.tolist() == [[4, 5, 5], [7, 7, 7]]  # misses repeat
        logits = torch.full((2, 4, 11), -5.0)
        for lane, targets in enumerate(([4, 5, 9, 2], [7, 1, 2, 3])):
            for j, t in enumerate(targets):
                logits[lane, j, t] = 5.0
        g, m, cand, is_eos, eos_pos = accept_drafts(logits, drafts, eos_id=2)
        assert m.tolist() == [2, 1]
        assert cand.tolist() == [[1, 1, 1, 0], [1, 1, 0, 0]]
        assert eos_pos.tolist() == [4, 4]  # EOS only beyond the candidates
