"""Port parity, weight-only quantisation: docqa_tpu_torch.models.quant,
ops.qmatmul (K4's plain version), the quantised host init and the
quantised engines against docqa_tpu's on the CPU.

Inputs come from numpy seeds; widths are small (hidden 64, 2 layers).
Tolerances: quantisation is held integer for integer and scale for scale
(exact: both sides round half to even from the same float32 values);
dequantised values exactly (one float32 product a side); the product
``_qmatmul`` at 1e-5 relative and first-step logits at 1e-4 (float32, the
frameworks differ only in summation order); greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import QCASES

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.models import quant as jquant
from docqa_tpu.models.decoder import _qmatmul as j_qmatmul
from docqa_tpu.models.decoder import decoder_forward as j_decoder_forward
from docqa_tpu.models.decoder import init_decoder_params as j_init_decoder_params
from docqa_tpu.models.decoder import init_kv_cache as j_init_kv_cache
from docqa_tpu_torch import weights
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.serve import ContinuousBatcher
from docqa_tpu_torch.models import quant
from docqa_tpu_torch.models.decoder import (
    _qmatmul,
    decoder_forward,
    init_decoder_params,
    init_kv_cache,
)
from docqa_tpu_torch.obs.observatory import decoder_weight_bytes
from docqa_tpu_torch.ops import qmatmul as qm
from docqa_tpu_torch.utils import torch_dtype

torch.set_num_threads(1)

DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
# mlp 45: w_down's int4 group is 45, odd (the packed store pads a row)
ODD = dict(DEC, mlp_dim=45)
SEED = 7
PROMPTS = [[3, 5, 9, 4], [2] + [11, 12, 13, 14] * 6 + [3], [7], [5, 9, 11]]
MAX_NEW = 24
WAIT = 120


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _int_values(leaf, in_dim=None):
    """A quantised leaf of either package as int8 numpy [.., in, out]
    (int4: [groups, g, out])."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.uint8:
            return qm.unpack_int4(leaf, in_dim // leaf.shape[0]).numpy()
        return leaf.numpy()
    return np.asarray(leaf).astype(np.int8)


def _assert_quantised_equal(got, want, cfg):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith(quant.SCALE_SUFFIX):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        elif str(np.asarray(w).dtype) in ("int8", "int4"):
            in_dim = np.asarray(w).shape[0] * (np.asarray(w).shape[1] if np.asarray(w).ndim == 3 else 1)
            np.testing.assert_array_equal(_int_values(g, in_dim), _int_values(w), err_msg=name)


class TestQuantizeArrays:
    @pytest.mark.parametrize("shape, dead", [((64, 32), False), ((48, 8), True),
                                             ((1, 5), False)])
    def test_int8_integer_and_scale_equal(self, shape, dead):
        w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        if dead:
            w[:, 3] = 0.0  # a dead column: scale 1e-12, all zeros
        jq, js = jquant.quantize_array(jnp.asarray(w))
        q, s = quant.quantize_array(torch.from_numpy(w))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    @pytest.mark.parametrize("shape, group", [((256, 32), 128), ((48, 8), 48),
                                              ((45, 8), 45), ((298, 4), 2),
                                              ((7, 3), 7)])
    def test_int4_integer_and_scale_equal(self, shape, group):
        w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        w[:, 1] = 0.0  # a dead column
        jq, js = jquant.quantize_array_int4(jnp.asarray(w))
        packed, s = quant.quantize_array_int4(torch.from_numpy(w))
        assert jq.shape[1] == group and quant._int4_group(shape[0]) == group
        assert packed.dtype == torch.uint8
        assert tuple(packed.shape) == (shape[0] // group, -(-group // 2), shape[1])
        np.testing.assert_array_equal(
            qm.unpack_int4(packed, group).numpy(), np.asarray(jq).astype(np.int8))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    def test_pack_unpack_roundtrip(self):
        q = torch.from_numpy(
            np.random.default_rng(2).integers(-8, 8, size=(3, 9, 5)).astype(np.int8))
        packed = qm.pack_int4(q)
        assert tuple(packed.shape) == (3, 5, 5)
        assert (qm.unpack_int4(packed, 9) == q).all()
        assert (packed[:, -1] >> 4 == 0).all()  # the odd group's padding nibble

    def test_should_quantize_selection(self):
        names = ["l0_wq", "l3_wk", "l1_wv", "l0_wo", "l11_w_gate", "l2_w_up",
                 "l11_w_down", "lm_head", "tok_emb", "l0_attn_norm_g",
                 "final_norm_g", "l0_mlp_norm_g", "wq", "lm_head__scale"]
        assert [quant.should_quantize(n) for n in names] == [
            jquant.should_quantize(n) for n in names]
        assert quant.is_quantized({"a__scale": 0}) and not quant.is_quantized({"a": 0})


class TestHostInit:
    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("dec", [DEC, ODD], ids=["even", "odd-group"])
    def test_equals_reference_host_init(self, bits, dec):
        want = jquant.init_quantized_decoder_params(
            jax.random.PRNGKey(SEED), JDecoderConfig(**dec), host_init=True,
            bits=bits, host_seed=SEED)
        got = weights.host_init_quantized_decoder_params(DecoderConfig(**dec), SEED, bits)
        assert list(got) == list(want)
        _assert_quantised_equal(got, want, dec)
        for name, w in want.items():
            if str(np.asarray(w).dtype) == "bfloat16":
                np.testing.assert_array_equal(
                    got[name], np.asarray(w).astype(np.float32), err_msg=name)
        assert str(np.asarray(want["lm_head"]).dtype) == "int8"
        assert got["lm_head"].dtype == torch.int8

    def test_int4_tree_is_half_of_int8_except_lm_head(self):
        cfg = DecoderConfig(**DEC)
        t8 = weights.to_torch(weights.host_init_quantized_decoder_params(cfg, 0, 8), "cpu")
        t4 = weights.to_torch(weights.host_init_quantized_decoder_params(cfg, 0, 4), "cpu")

        def qbytes(t):
            return sum(v.numel() for v in t.values() if v.dtype in (torch.int8, torch.uint8))

        lm = t8["lm_head"].numel()
        assert t4["lm_head"].dtype == torch.int8
        assert qbytes(t4) == (qbytes(t8) - lm) // 2 + lm
        assert quant.tree_bytes(t4) < quant.tree_bytes(t8) < quant.tree_bytes(
            weights.to_torch(weights.host_init_decoder_params(cfg, 0), "cpu", torch.bfloat16))

    def test_device_route_quantises_the_float32_draws(self):
        cfg = DecoderConfig(**DEC)
        for bits in (8, 4):
            got = quant.init_quantized_decoder_params(cfg, 3, "cpu", bits=bits)
            floats = init_decoder_params(cfg, 3, "cpu", dtype=torch.float32)
            want = quant.quantize_decoder_params(floats, bits)
            assert list(got) == list(want)
            for name in want:
                assert torch.equal(got[name], want[name]), name


@pytest.fixture(scope="module")
def carried():
    """The reference's quantised trees of one float32 tree, and the port's
    copies of them (int4 carried out of ``ml_dtypes``)."""
    jcfg = JDecoderConfig(**ODD)
    floats = j_init_decoder_params(jax.random.PRNGKey(0), jcfg)
    out = {"floats": floats}
    for bits in (8, 4):
        jtree = jquant.quantize_decoder_params(floats, bits=bits)
        out[bits] = (jtree, weights.to_torch(_np(jtree), "cpu", torch.float32))
    return out


class TestCarriedTree:
    @pytest.mark.parametrize("bits", [8, 4])
    def test_dequantises_to_the_same_values(self, carried, bits):
        jtree, tree = carried[bits]
        cfg = DecoderConfig(**ODD)
        for name, w in jtree.items():
            if name.endswith(quant.SCALE_SUFFIX) or not quant.should_quantize(name):
                continue
            scale = np.asarray(jtree[name + quant.SCALE_SUFFIX])
            q = np.asarray(w).astype(np.float32)
            want = (q * scale[None, :] if q.ndim == 2 else
                    (q * scale[:, None, :]).reshape(-1, q.shape[-1]))
            got = qm.dequantize(tree[name], tree[name + quant.SCALE_SUFFIX],
                                torch.float32, want.shape[0])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert weights.to_torch(_np(jtree), "cpu", torch.bfloat16)["l0_wq__scale"].dtype == \
            torch.float32
        assert tree["l0_w_up"].dtype == (torch.int8 if bits == 8 else torch.uint8)
        assert cfg.mlp_dim == 45

    @pytest.mark.parametrize("bits", [8, 4])
    def test_qmatmul_equals_reference(self, carried, bits):
        jtree, tree = carried[bits]
        rng = np.random.default_rng(bits)
        for name, in_dim in (("l0_wq", 64), ("l1_w_down", 45), ("lm_head", 64)):
            x = rng.normal(size=(3, 5, in_dim)).astype(np.float32)
            want = np.asarray(j_qmatmul(jnp.asarray(x), jtree, name, jnp.float32))
            got = _qmatmul(torch.from_numpy(x), tree, name, torch.float32).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    @pytest.mark.parametrize("bits", [8, 4])
    def test_first_step_logits_equal_reference(self, carried, bits):
        jtree, tree = carried[bits]
        ids = np.array([[3, 9, 17, 4, 0, 0], [8, 1, 2, 3, 4, 5]], np.int32)
        lengths = np.array([4, 6], np.int32)
        want, _ = j_decoder_forward(
            jtree, JDecoderConfig(**ODD), jnp.asarray(ids),
            j_init_kv_cache(JDecoderConfig(**ODD), 2, max_len=32),
            jnp.zeros((2,), jnp.int32), attn_lengths=jnp.asarray(lengths))
        cfg = DecoderConfig(**ODD)
        got = decoder_forward(
            tree, cfg, torch.from_numpy(ids).long(), init_kv_cache(cfg, 2, max_len=32),
            torch.zeros(2, dtype=torch.long), attn_lengths=torch.from_numpy(lengths).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("bits", [8, 4])
    def test_supplied_tree_quantised_as_the_reference(self, carried, bits, dtype):
        """A float tree handed to an engine with ``quantize_weights`` is
        quantised from its values in their own dtype (a bf16 tree's bf16
        values), then only its float leaves take ``cfg.dtype``."""
        floats = {k: v.astype(jnp.dtype(dtype)) for k, v in carried["floats"].items()}
        want = jquant.quantize_decoder_params(floats, bits=bits)
        cfg = DecoderConfig(**dict(ODD, quantize_weights=True, quant_bits=bits))
        eng = GenerateEngine(cfg, GenerateConfig(), params=_np(floats), device="cpu")
        _assert_quantised_equal(eng.params, want, ODD)
        assert eng.params["tok_emb"].dtype == torch.float32
        assert eng.params["l0_wq__scale"].dtype == torch.float32


@pytest.fixture(scope="module", params=[8, 4])
def engines(request):
    bits = request.param
    jeng = JGenerateEngine(
        JDecoderConfig(**dict(DEC, quantize_weights=True, quant_bits=bits)),
        JGenerateConfig(eos_id=2), seed=SEED)
    eng = GenerateEngine(
        DecoderConfig(**dict(DEC, quantize_weights=True, quant_bits=bits)),
        GenerateConfig(eos_id=2), seed=SEED, device="cpu")
    return bits, jeng, eng


class TestEngines:
    def test_greedy_tokens_equal_reference_with_speculation(self, engines):
        bits, jeng, eng = engines
        assert eng.gen.speculative_k >= 2
        want = jeng.generate_ids(PROMPTS, max_new_tokens=MAX_NEW)
        got = eng.generate_ids(PROMPTS, max_new_tokens=MAX_NEW)
        assert got == want
        assert quant.is_quantized(eng.params)
        assert eng.params["l0_w_gate"].dtype == (torch.int8 if bits == 8 else torch.uint8)

    def test_batcher_equals_solo(self, engines):
        _bits, _jeng, eng = engines
        solo = eng.generate_ids(PROMPTS, max_new_tokens=MAX_NEW)
        b = ContinuousBatcher(eng, n_slots=2, chunk=4, cache_len=512)
        try:
            handles = [b.submit_ids(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
            got = [h.result(timeout=WAIT) for h in handles]
        finally:
            b.stop()
        assert got == solo
        assert b._alloc.blocks_in_use == 0

    def test_quantised_leaves_never_cast(self):
        cfg = DecoderConfig(**dict(DEC, dtype="bfloat16", quantize_weights=True, quant_bits=4))
        eng = GenerateEngine(cfg, GenerateConfig(), seed=1, device="cpu")
        assert eng.params["l0_wq"].dtype == torch.uint8
        assert eng.params["lm_head"].dtype == torch.int8
        assert eng.params["l0_wq__scale"].dtype == torch.float32
        assert eng.params["tok_emb"].dtype == torch.bfloat16
        assert eng.generate_ids([[3, 5, 9]], max_new_tokens=4)[0] is not None
        # an already quantised tree passes through untouched
        again = GenerateEngine(cfg, GenerateConfig(), params=eng.params, device="cpu")
        assert all(again.params[k] is v or torch.equal(again.params[k], v)
                   for k, v in eng.params.items())


class TestKernelWrapper:
    def test_cpu_takes_the_plain_version(self):
        rng = np.random.default_rng(5)
        w = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(2, 3, 40)).astype(np.float32))
        for q, s in (quant.quantize_array(w), quant.quantize_array_int4(w)):
            want = x @ qm.dequantize(q, s, torch.float32, 40)
            torch.testing.assert_close(qm.qmatmul(x, q, s), want, rtol=0, atol=0)

    def test_refuses_grad_and_other_devices(self):
        q, s = quant.quantize_array(torch.ones(8, 4))
        with pytest.raises(ValueError, match="forward-only"):
            qm.qmatmul(torch.ones(2, 8, requires_grad=True), q, s)
        with pytest.raises(ValueError, match="cuda or cpu"):
            qm.qmatmul(torch.ones(2, 8, device="meta"), q, s)

    def test_plan_fills_the_grid_without_outgrowing_the_weights(self):
        # Mistral-7B wk at the solo verify: 8 column blocks of the ring mode
        # split K at least 16 ways, every tile in some split, no split empty,
        # and the blocks fill the card without passing two an SM
        p = qm.plan_qmatmul("int8", 4, 4096, 1024)
        assert p.kernel == "ring" and p.tiles == 4096 // qm.RING_K["int8"]
        assert p.splits * p.tiles_per_split >= p.tiles > (p.splits - 1) * p.tiles_per_split
        assert p.splits >= 16 and qm.H100_SMS // 2 < p.grid == 8 * p.splits <= 2 * qm.H100_SMS
        # the partials' traffic stays under the weight bytes at 64 rows
        p = qm.plan_qmatmul("int8", 64, 4096, 1024)
        assert 1 < p.splits and 2 * p.splits * 64 * 1024 * 4 <= 4096 * 1024
        # prefill rows fill the grid alone: one persistent block an SM
        p = qm.plan_qmatmul("int8", 2048, 4096, 14336)
        assert (p.kernel, p.splits, p.grid) == ("wgmma", 1, qm.H100_SMS)
        # an odd int4 group is walked padded to even
        p4 = qm.plan_qmatmul("int4", 4, 45, 64, group=45)
        assert (p4.k, p4.group) == (46, 46)

    def test_probe_int4_support_on_the_cpu(self):
        assert quant.probe_int4_support("cpu") == (True, "")


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("dec", [dict(DEC, dtype="bfloat16"), ODD], ids=["bf16", "odd-f32"])
def test_decoder_weight_bytes_counts_the_stored_tree(bits, dec):
    """The observatory's weight bytes a forward equal the engine's tree
    (every leaf but the gathered embedding), quantised or not."""
    cfg = DecoderConfig(**dict(dec, quantize_weights=bits is not None, quant_bits=bits or 8))
    host = (weights.host_init_quantized_decoder_params(cfg, 0, cfg.quant_bits)
            if bits else weights.host_init_decoder_params(cfg, 0))
    tree = weights.to_torch(host, "cpu", torch_dtype(cfg.dtype))
    nbytes = sum(t.numel() * t.element_size() for k, t in tree.items() if k != "tok_emb")
    assert decoder_weight_bytes(cfg) == nbytes


def _plan_case(m, in_dim, out, bits, group):
    """The plan the wrapper takes for a product, as ``_Store.plan`` asks."""
    mode = "int8" if bits == 8 else "int4"
    g = quant._int4_group(in_dim, group) if bits == 4 else 0
    return qm.plan_qmatmul(mode, m, in_dim, out, g)


MISTRAL_K4 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000)]


@pytest.mark.parametrize("case", [c[:5] for c in QCASES]
                         + [(m, k, n, bits, None) for m in (4, 64, 2048)
                            for k, n in MISTRAL_K4 for bits in (8, 4)])
def test_plan_meets_its_mode_constraints(case):
    """Every card test's K4 shape and every Mistral-7B projection at the
    solo verify, a 16-lane verify and a prefill gets a mode whose rules
    hold: the TMA modes read 16-byte-multiple weight and x rows, an int4
    group never splits a stage, the ring takes m <= 64 and wgmma the rest;
    the splits cover every K tile with none empty; the partials' traffic
    stays under the weight bytes; Mistral's shapes all take a TMA mode."""
    m, in_dim, out, bits, group = case
    p = _plan_case(m, in_dim, out, bits, group)
    stage = {"simple": qm.STAGE_K, "wgmma": qm.STAGE_K, "ring": qm.RING_K[p.mode]}[p.kernel]
    assert p.tiles == -(-p.k // stage)
    assert p.splits * p.tiles_per_split >= p.tiles
    assert p.splits == 1 or (p.splits - 1) * p.tiles_per_split < p.tiles
    w_bytes = p.k * out // (2 if bits == 4 else 1)
    assert p.splits == 1 or 2 * p.splits * m * out * 4 <= w_bytes
    if p.kernel == "simple":
        assert not qm.tma_ok(p.mode, p.k, out, p.group)
        return
    assert out % 16 == 0 and (p.k * 2) % 16 == 0  # x rows; weight rows are out bytes
    if bits == 4:
        assert p.group % 128 == 0 and p.group % stage == 0 and p.k % 2 == 0
    assert p.kernel == ("ring" if m <= qm.RING_ROWS else "wgmma")
    if p.kernel == "ring":
        assert p.grid == -(-out // qm.TILE_N) * p.splits
    else:
        assert p.grid <= qm.H100_SMS and p.rows in (qm.WGMMA_ROWS, 2 * qm.WGMMA_ROWS)
    if (in_dim, out) in MISTRAL_K4:
        assert p.kernel != "simple"

