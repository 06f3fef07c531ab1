"""Port parity, models layer: docqa_tpu_torch.models / weights against
docqa_tpu.models on the same weights and inputs (CPU, float32, 2 layers).

Tolerance 1e-4 on embeddings and logits: float32 throughout, the two
frameworks differ only in matmul and reduction order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.models.decoder import decoder_forward as j_decoder_forward
from docqa_tpu.models.decoder import init_decoder_params as j_init_decoder_params
from docqa_tpu.models.decoder import init_kv_cache as j_init_kv_cache
from docqa_tpu.models.encoder import encode_batch as j_encode_batch
from docqa_tpu.models.encoder import init_encoder_params as j_init_encoder_params
from docqa_tpu_torch import weights
from docqa_tpu_torch.config import DecoderConfig, EncoderConfig
from docqa_tpu_torch.models.decoder import (
    decoder_forward,
    init_decoder_params,
    init_kv_cache,
    write_cache,
)
from docqa_tpu_torch.models.encoder import encode_batch

torch.set_num_threads(1)

ENC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
           mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")


def _np_tree(params):
    return {k: np.asarray(v) for k, v in params.items()}


class TestWeights:
    @pytest.mark.parametrize("embed_dim", [64, 48])
    def test_encoder_host_init_bit_equal(self, embed_dim):
        cfg = dict(ENC, embed_dim=embed_dim)
        want = _np_tree(j_init_encoder_params(
            jax.random.PRNGKey(11), JEncoderConfig(**cfg),
            host_init=True, host_seed=11,
        ))
        got = weights.host_init_encoder_params(EncoderConfig(**cfg), 11)
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    def test_decoder_host_init_bit_equal(self):
        want = _np_tree(j_init_decoder_params(
            jax.random.PRNGKey(5), JDecoderConfig(**DEC),
            host_init=True, host_seed=5,
        ))
        got = weights.host_init_decoder_params(DecoderConfig(**DEC), 5)
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    def test_bf16_tree_converts_bit_exact(self):
        tree = j_init_decoder_params(
            jax.random.PRNGKey(2), JDecoderConfig(**DEC),
            param_dtype=jnp.bfloat16,
        )
        got = weights.to_torch(_np_tree(tree), "cpu")
        for name, arr in tree.items():
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[name].float().numpy(), np.asarray(arr, np.float32)
            )

    def test_device_init_is_seeded_and_scaled(self):
        cfg = DecoderConfig(**DEC)
        a = init_decoder_params(cfg, seed=3, device="cpu")
        b = init_decoder_params(cfg, seed=3, device="cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        std = float(a["l0_w_down"].std())
        assert abs(std - cfg.mlp_dim ** -0.5) < 0.1 * cfg.mlp_dim ** -0.5
        assert torch.equal(a["final_norm_g"], torch.ones(cfg.hidden_dim))


class TestEncoder:
    def test_embeddings_match(self):
        cfg = EncoderConfig(**ENC)
        tree = weights.host_init_encoder_params(cfg, 4)
        rng = np.random.default_rng(0)
        ids = rng.integers(5, cfg.vocab_size, size=(4, 24)).astype(np.int32)
        lengths = np.array([24, 9, 0, 1], np.int32)  # a padded zero lane
        want = np.asarray(j_encode_batch(
            {k: jnp.asarray(v) for k, v in tree.items()}, JEncoderConfig(**ENC),
            jnp.asarray(ids), jnp.asarray(lengths),
        ))
        got = encode_batch(
            weights.to_torch(tree, "cpu"), cfg,
            torch.from_numpy(ids).long(), torch.from_numpy(lengths),
        ).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert not got[2].any()  # zero-length lane pools to zero


class TestDecoder:
    @pytest.mark.parametrize("route", ["numpy_host_init", "converted"])
    @pytest.mark.parametrize("window", [None, 5])
    def test_logits_match_prefill_then_decode(self, route, window):
        dec = dict(DEC, sliding_window=window)
        jcfg, cfg = JDecoderConfig(**dec), DecoderConfig(**dec)
        if route == "numpy_host_init":
            tree = weights.host_init_decoder_params(cfg, 9)
        else:  # the reference's own device-RNG tree through the converter
            tree = _np_tree(j_init_decoder_params(jax.random.PRNGKey(9), jcfg))
        jp = {k: jnp.asarray(v) for k, v in tree.items()}
        tp = weights.to_torch(tree, "cpu")
        rng = np.random.default_rng(1)
        b, s, max_len = 2, 16, 64
        ids = rng.integers(5, cfg.vocab_size, size=(b, s)).astype(np.int32)
        plens = np.array([16, 11], np.int32)

        jcache = j_init_kv_cache(jcfg, b, max_len=max_len)
        jl, jcache = j_decoder_forward(
            jp, jcfg, jnp.asarray(ids), jcache, jnp.zeros((b,), jnp.int32),
            attn_lengths=jnp.asarray(plens), use_flash=False,
            last_token_only=True,
        )
        tcache = init_kv_cache(cfg, b, max_len=max_len, device="cpu")
        tl = decoder_forward(
            tp, cfg, torch.from_numpy(ids).long(), tcache,
            torch.zeros(b, dtype=torch.int32), attn_lengths=torch.from_numpy(plens),
            last_token_only=True,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)

        # one decode step and one K=3 verify step on the filled caches
        for step_ids, lens in (
            (rng.integers(5, 256, size=(b, 1)), plens),
            (rng.integers(5, 256, size=(b, 3)), plens + 1),
        ):
            step_ids = step_ids.astype(np.int32)
            jl, jcache = j_decoder_forward(
                jp, jcfg, jnp.asarray(step_ids), jcache, jnp.asarray(lens),
                use_flash=False,
            )
            tl = decoder_forward(
                tp, cfg, torch.from_numpy(step_ids).long(), tcache,
                torch.from_numpy(lens),
            )
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        for name in jcache:
            np.testing.assert_allclose(
                tcache[name].numpy(), np.asarray(jcache[name]), atol=1e-4
            )

    def test_write_cache_is_in_place_and_clamped(self):
        cache = torch.zeros((2, 8, 1, 2))
        ptr = cache.data_ptr()
        new = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 1, 2) + 1
        write_cache(cache, new, torch.tensor([1, 7]))  # lane 1 clamps to row 5
        assert cache.data_ptr() == ptr
        assert torch.equal(cache[0, 1:4], new[0])
        assert torch.equal(cache[1, 5:8], new[1])
        assert not cache[0, 4:].any() and not cache[1, :5].any()
