"""Port parity, ops layer: docqa_tpu_torch.ops against docqa_tpu.ops on the
same numpy inputs (CPU, float32).

The flash wrapper on a CPU tensor runs its plain version; it is held
against the reference's Pallas kernel in interpret mode and against the
reference's XLA attention.  So is ``split_kv_reference``, the plain version
of the decode kernel's split-and-merge.  Tolerance 2e-5 (the reference's
own flash test tolerance): same float32 math, only the summation order
differs.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.ops import apply_rope as j_apply_rope
from docqa_tpu.ops import layer_norm as j_layer_norm
from docqa_tpu.ops import rms_norm as j_rms_norm
from docqa_tpu.ops import rope_angles as j_rope_angles
from docqa_tpu.ops.attention import attention_reference as j_attention_reference
from docqa_tpu.ops.attention import flash_attention as j_flash_attention
from docqa_tpu.ops.sampling import greedy as j_greedy
from docqa_tpu.index.store import _search_single as j_search_single
from docqa_tpu_torch.ops.attention import (
    SPLIT_TILE, attention, attention_reference, flash_attention, plan_flash,
    split_bounds, split_kv_reference,
)
from docqa_tpu_torch.ops.norms import layer_norm, rms_norm
from docqa_tpu_torch.ops.rope import apply_rope, rope_angles
from docqa_tpu_torch.ops.sampling import greedy, sample
from docqa_tpu_torch.index.store import search_single

torch.set_num_threads(1)

T = torch.from_numpy


class TestNorms:
    def test_layer_norm(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 5, 16)).astype(np.float32)
        g = rng.normal(size=(16,)).astype(np.float32)
        b = rng.normal(size=(16,)).astype(np.float32)
        want = np.asarray(j_layer_norm(jnp.array(x), jnp.array(g), jnp.array(b)))
        got = layer_norm(T(x), T(g), T(b)).numpy()
        # same float32 formula; reductions may order differently
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_rms_norm_bf16_keeps_dtype(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 8)).astype(np.float32)
        g = rng.normal(size=(8,)).astype(np.float32)
        want = np.asarray(j_rms_norm(jnp.array(x), jnp.array(g)))
        np.testing.assert_allclose(rms_norm(T(x), T(g)).numpy(), want, atol=1e-6)
        assert rms_norm(T(x).bfloat16(), T(g)).dtype == torch.bfloat16


class TestRope:
    def test_angles_and_rotation(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
        pos = rng.integers(0, 512, size=(2, 5)).astype(np.int32)
        jc, js = j_rope_angles(16, 512, 1e6)
        c, s = rope_angles(16, 512, 1e6)
        # float32 cos/sin of the same float32 angles: libm ulps apart
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
        want = np.asarray(j_apply_rope(jnp.array(x), jc, js, jnp.array(pos)))
        got = apply_rope(T(x), c, s, T(pos).long()).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestSampling:
    def test_greedy_matches(self):
        logits = np.random.default_rng(3).normal(size=(6, 97)).astype(np.float32)
        logits[0, 5] = logits[0, 9] = logits[0].max() + 1  # tie -> first index
        want = np.asarray(j_greedy(jnp.array(logits)))
        got = greedy(T(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == 5

    @pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.3), (8, 0.5)])
    def test_sample_stays_in_filter_support(self, top_k, top_p):
        rng = np.random.default_rng(4)
        logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
        order = np.argsort(-logits, axis=-1)
        gen = torch.Generator().manual_seed(0)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        for _ in range(20):
            tok = sample(T(logits), gen, 1.0, top_k, top_p).numpy()
            for lane in range(4):
                rank = int(np.nonzero(order[lane] == tok[lane])[0][0])
                if top_k:
                    assert rank < top_k
                if top_p < 1.0:
                    p_sorted = probs[lane][order[lane]]
                    assert p_sorted[:rank].sum() < top_p + 1e-6

    def test_sample_is_seeded(self):
        logits = T(np.random.default_rng(5).normal(size=(3, 50)).astype(np.float32))
        a = sample(logits, torch.Generator().manual_seed(7), 0.8)
        b = sample(logits, torch.Generator().manual_seed(7), 0.8)
        assert torch.equal(a, b)


class TestTopK:
    def test_search_matches_reference(self):
        """Exact store search over bf16 rows: the same top-k ids as the
        reference's ``_search_single`` (a tie at the k-th score is not a
        miss)."""
        rng = np.random.default_rng(6)
        rows = rng.normal(size=(300, 32)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q = rng.normal(size=(4, 32)).astype(np.float32)
        count, k = 257, 7
        buf = np.zeros((384, 32), np.float32)
        buf[:count] = rows[:count]
        jv, ji = j_search_single(
            jnp.asarray(buf, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16),
            count, None, k,
        )
        tv, ti = search_single(
            T(buf).bfloat16(), T(q).bfloat16(), count, k
        )
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        for lane in range(4):
            got, want = set(ti[lane].tolist()), set(np.asarray(ji[lane]).tolist())
            kth = float(np.asarray(jv)[lane, -1])
            for rid in got ^ want:
                score = float(T(buf[rid]).bfloat16().float() @ T(q[lane]).bfloat16().float())
                assert abs(score - kth) < 1e-5, (lane, rid)


def _case_inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


# (name, seed, b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset,
#  block_q, block_kv) — block sizes are for the reference's Pallas kernel
FLASH_CASES = [
    # tests/test_ops.py::test_flash_matches_reference (both causal settings)
    ("ops_noncausal", 4, 2, 256, 256, 4, 2, 64, False, None, [256, 190], None, 128, 128),
    ("ops_causal", 4, 2, 256, 256, 4, 2, 64, True, None, [256, 190], None, 128, 128),
    # tests/test_ops.py::test_flash_decode_step
    ("ops_decode", 5, 2, 1, 256, 4, 4, 64, True, None, [100, 37], None, 128, 128),
    # tests/test_ops.py::test_sliding_window
    ("ops_window", 6, 1, 128, 128, 2, 2, 64, True, 32, None, None, 64, 64),
    ("gqa", 7, 2, 64, 64, 8, 2, 64, True, None, [64, 40], None, 32, 32),
    ("d32_noncausal_zero_len", 8, 3, 32, 32, 4, 4, 32, False, None, [32, 0, 7], None, 16, 16),
    ("decode_q_offset", 9, 2, 1, 128, 4, 2, 64, True, None, [51, 90], [50, 89], 128, 64),
    ("verify_sq4", 10, 2, 4, 128, 4, 2, 64, True, None, [54, 93], [50, 89], 128, 64),
    ("ragged_sq37", 11, 2, 37, 100, 4, 1, 64, True, 20, [100, 60], None, 16, 32),
    # the split-kv kernel's packed-GQA shapes: 4 q heads per kv head, so a
    # verify step packs 4 x 4 rows and a decode step 4 x 1
    ("gqa_verify_packed", 12, 2, 4, 320, 8, 2, 64, True, None, [233, 54], [229, 50], 128, 64),
    ("gqa_decode_packed", 13, 2, 1, 320, 8, 2, 64, True, None, [230, 37], [229, 36], 128, 64),
]


class TestFlashAttention:
    @pytest.mark.parametrize(
        "case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES]
    )
    def test_cpu_wrapper_matches_reference_and_pallas(self, case):
        (_, seed, b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset,
         block_q, block_kv) = case
        q, k, v = _case_inputs(seed, b, sq, skv, hq, hkv, d)
        lens = None if lengths is None else np.asarray(lengths, np.int32)
        qoff = None if q_offset is None else np.asarray(q_offset, np.int32)
        kw = dict(causal=causal, sliding_window=window)
        jkw = dict(
            kw,
            lengths=None if lens is None else jnp.asarray(lens),
            q_offset=None if qoff is None else jnp.asarray(qoff),
        )
        want_ref = np.asarray(
            j_attention_reference(jnp.array(q), jnp.array(k), jnp.array(v), **jkw)
        )
        want_flash = np.asarray(
            j_flash_attention(
                jnp.array(q), jnp.array(k), jnp.array(v), **jkw,
                block_q=block_q, block_kv=block_kv, interpret=True,
            )
        )
        got = flash_attention(
            T(q), T(k), T(v), **kw,
            lengths=None if lens is None else T(lens),
            q_offset=None if qoff is None else T(qoff),
        ).numpy()
        np.testing.assert_allclose(got, want_ref, atol=2e-5)
        np.testing.assert_allclose(got, want_flash, atol=2e-5)
        if lens is not None and (lens == 0).any():
            assert not got[lens == 0].any()  # fully masked rows output 0

    def test_dispatcher_and_window_guard(self):
        q = torch.ones((1, 8, 2, 16))
        assert attention(q, q, q, causal=True).shape == q.shape
        with pytest.raises(ValueError, match="sliding_window requires causal"):
            flash_attention(q, q, q, sliding_window=4)

    def test_bf16_cpu_keeps_dtype(self):
        q = torch.randn((1, 4, 2, 32), generator=torch.Generator().manual_seed(0))
        out = flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), causal=True)
        assert out.dtype == torch.bfloat16


# (name, seed, sq, lengths, q_offset, window, num_splits): b=2, skv=320
# (5 tiles of SPLIT_TILE rows), hq=8, hkv=2, d=32, causal
SPLIT_CASES = [
    ("verify_packed", 20, 4, [233, 54], [229, 50], None, 5),
    ("decode_packed", 21, 1, [230, 37], [229, 36], None, 5),
    ("splits_past_lengths", 22, 4, [40, 70], [36, 66], None, 5),
    ("splits_before_window", 23, 4, [300, 254], [296, 250], 64, 5),
    ("zero_length", 24, 1, [0, 100], [0, 99], None, 5),
    ("uneven_splits", 25, 4, [317, 129], [313, 125], 100, 3),
]


class TestSplitKvReference:
    @pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
    def test_matches_reference_and_pallas(self, case):
        _, seed, sq, lengths, q_offset, window, num_splits = case
        q, k, v = _case_inputs(seed, 2, sq, 320, 8, 2, 32)
        lens = np.asarray(lengths, np.int32)
        qoff = np.asarray(q_offset, np.int32)
        jkw = dict(causal=True, sliding_window=window, lengths=jnp.asarray(lens),
                   q_offset=jnp.asarray(qoff))
        want_ref = np.asarray(
            j_attention_reference(jnp.array(q), jnp.array(k), jnp.array(v), **jkw)
        )
        want_flash = np.asarray(
            j_flash_attention(jnp.array(q), jnp.array(k), jnp.array(v), **jkw,
                              block_q=128, block_kv=64, interpret=True)
        )
        got = split_kv_reference(
            T(q), T(k), T(v), causal=True, sliding_window=window,
            lengths=T(lens), q_offset=T(qoff), num_splits=num_splits,
        ).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_ref, atol=2e-5)
        np.testing.assert_allclose(got, want_flash, atol=2e-5)
        if (lens == 0).any():
            assert not got[lens == 0].any()  # no live kv: 0, not NaN

    def test_split_count_does_not_change_the_result(self):
        q, k, v = _case_inputs(26, 2, 4, 320, 8, 2, 32)
        kw = dict(causal=True, lengths=torch.tensor([250, 90]),
                  q_offset=torch.tensor([246, 86]), sliding_window=128)
        want = attention_reference(T(q), T(k), T(v), **kw)
        for n in (1, 2, 4, 5, 8):
            got = split_kv_reference(T(q), T(k), T(v), num_splits=n, **kw)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


# (b, sq, skv, hq, hkv): decode, verify, prefill, encoder and edge shapes
PLAN_SHAPES = [
    (1, 1, 384, 32, 8), (1, 4, 384, 32, 8), (1, 4, 4224, 32, 8),
    (2, 1, 1, 4, 4), (3, 16, 1000, 16, 4), (64, 4, 8192, 32, 8),
    (1, 256, 384, 32, 8), (32, 128, 128, 12, 12), (1, 4096, 4224, 32, 8),
    (2, 4, 100, 64, 2),
]


class TestPlanFlash:
    def test_takes_static_shapes_only(self):
        params = inspect.signature(plan_flash).parameters
        assert not {"lengths", "q_offset"} & set(params)

    @pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
    def test_paths_and_split_tiling(self, shape):
        b, sq, skv, hq, hkv = shape
        assert plan_flash(torch.float32, *shape).path == "simt"
        plan = plan_flash(torch.bfloat16, *shape)
        if sq <= 16 and (hq // hkv) * sq <= 64:
            assert plan.path == "decode"
            bounds = split_bounds(skv, plan.num_splits)
            assert len(bounds) == plan.num_splits
            # the splits tile [0, skv): no gap, no overlap, none empty, and
            # each is the plan's whole number of tiles (the last clipped)
            assert bounds[0][0] == 0 and bounds[-1][1] == skv
            for (lo, hi), (nlo, _) in zip(bounds, bounds[1:]):
                assert hi == nlo and hi - lo == plan.split_tiles * SPLIT_TILE
            assert all(hi > lo for lo, hi in bounds)
            # about two blocks per SM, never more splits than tiles
            assert plan.num_splits <= -(-skv // SPLIT_TILE)
        else:
            assert plan.path == "prefill" and plan.num_splits == 1
            assert plan.prefill_groups in (1, 2)
