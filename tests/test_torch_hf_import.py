"""Port parity, HF weight import: the port's own safetensors reader (and
``chip_smoke.py``'s writer, which builds the card's checkpoint
directories) against the ``safetensors`` package, and its BERT,
Llama/Mistral and BART loaders against docqa_tpu's on the same files.

Imported trees are exact: every leaf must equal the reference loader's
(and the file's) bit for bit, in the file's dtype — float32, float16 and
bfloat16 files alike — with the reference's transposes ([out, in] ->
[in, out]), GQA projection shapes, the tied ``lm_head`` fallback,
multi-shard reads and the stripped ``bert.`` prefix.  A header that lies
(offsets out of range, overlapping, leaving holes, a shape that does not
match its bytes, an unknown dtype, a truncated file) is refused.
"""

import importlib.util
import json
import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from docqa_tpu.models.decoder import load_hf_llama_weights as j_load_llama
from docqa_tpu.models.encoder import load_hf_bert_weights as j_load_bert
from docqa_tpu.models.seq2seq import load_hf_bart_weights as j_load_bart
from docqa_tpu_torch.config import DecoderConfig, EncoderConfig, Seq2SeqConfig
from docqa_tpu_torch.models import safetensors_io
from docqa_tpu_torch.models.decoder import decoder_param_schema, load_hf_llama_weights
from docqa_tpu_torch.models.encoder import load_hf_bert_weights
from docqa_tpu_torch.models.seq2seq import load_hf_bart_weights, seq2seq_param_schema

st = pytest.importorskip("safetensors.numpy")
torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "_ref_test_hf_import", os.path.join(os.path.dirname(__file__), "test_hf_import.py"))
REF = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(REF)  # the reference tests' synthetic HF trees

ENC = dict(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64,
           max_seq_len=48, embed_dim=32, dtype="float32")
DEC = dict(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32")
S2S = dict(vocab_size=256, d_model=64, enc_layers=2, dec_layers=2, num_heads=4,
           mlp_dim=128, max_src_len=64, max_tgt_len=32, dtype="float32")
DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


def _cast(raw, dtype):
    return {k: v.astype(DTYPES[dtype]) for k, v in raw.items()}


def _bits(x):
    """A leaf as (dtype name, shape, raw bytes): bit-for-bit equality."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (str(x.dtype).replace("torch.", ""), tuple(x.shape),
                x.view(-1).view(torch.uint8).numpy().tobytes())
    x = np.asarray(x)
    return (x.dtype.name, tuple(x.shape), x.tobytes())


def _same_tree(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        assert _bits(mine[k]) == _bits(ref[k]), k


def _bart_raw(rng):
    """A synthetic BartForConditionalGeneration file at S2S's widths (the
    reference test's recipe, random LN parameters too)."""
    d, m, v = S2S["d_model"], S2S["mlp_dim"], S2S["vocab_size"]

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    raw = {
        "model.shared.weight": w(v, d),
        "model.encoder.embed_positions.weight": w(S2S["max_src_len"] + 2, d),
        "model.decoder.embed_positions.weight": w(S2S["max_tgt_len"] + 2, d),
        "final_logits_bias": w(1, v),
    }
    for side in ("encoder", "decoder"):
        raw[f"model.{side}.layernorm_embedding.weight"] = 1 + w(d)
        raw[f"model.{side}.layernorm_embedding.bias"] = w(d)
        for i in range(2):
            pre = f"model.{side}.layers.{i}."
            for attn in ["self_attn"] + (["encoder_attn"] if side == "decoder" else []):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    raw[pre + f"{attn}.{proj}.weight"] = w(d, d)
                    raw[pre + f"{attn}.{proj}.bias"] = w(d)
                raw[pre + f"{attn}_layer_norm.weight"] = 1 + w(d)
                raw[pre + f"{attn}_layer_norm.bias"] = w(d)
            raw[pre + "fc1.weight"] = w(m, d)
            raw[pre + "fc1.bias"] = w(m)
            raw[pre + "fc2.weight"] = w(d, m)
            raw[pre + "fc2.bias"] = w(d)
            raw[pre + "final_layer_norm.weight"] = 1 + w(d)
            raw[pre + "final_layer_norm.bias"] = w(d)
    return raw


# ---- the safetensors reader -------------------------------------------------

def _mixed(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "bf16": rng.standard_normal((4, 2, 3)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-2**40, 2**40, (2, 3), dtype=np.int64),
        "i32": rng.integers(-9, 9, (5,)).astype(np.int32),
        "u8": rng.integers(0, 255, (6,)).astype(np.uint8),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_reader_equals_the_safetensors_package(tmp_path):
    raw = _mixed(np.random.default_rng(0))
    path = str(tmp_path / "mixed.safetensors")
    st.save_file(raw, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    _same_tree(got, st.load_file(path))
    assert got["bf16"].dtype == torch.bfloat16 and got["i64"].dtype == torch.int64
    # copy-on-write mapping: writing a tensor never reaches the file
    before = open(path, "rb").read()
    got["f32"].add_(1.0)
    assert open(path, "rb").read() == before


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_writer_is_read_back_by_the_safetensors_package(tmp_path, dtype, chip_smoke):
    raw = _cast(REF._llama_raw(JDecoderConfig(**DEC), np.random.default_rng(1)), dtype)
    tensors = {k: torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16)
               if dtype == "bfloat16" else torch.from_numpy(v) for k, v in raw.items()}
    path = str(tmp_path / "model.safetensors")
    chip_smoke.save_safetensors(tensors, path, metadata={"format": "pt"})
    _same_tree(st.load_file(path), raw)
    _same_tree(safetensors_io.load_file(path), raw)
    chip_smoke.save_safetensors(raw, path)
    _same_tree(safetensors_io.load_file(path), raw)


def _file(tmp_path, header, data=b"", n=None):
    blob = json.dumps(header).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob) if n is None else n) + blob + data)
    return str(path)


@pytest.mark.parametrize("header, data, n, match", [
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 16]}}, b"\0" * 16, None,
     "needs 8 bytes"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}, b"\0" * 4, None,
     "outside"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]},
      "b": {"dtype": "F32", "shape": [1], "data_offsets": [2, 6]}}, b"\0" * 8, None,
     "overlap or leave a hole"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [4, 8]}}, b"\0" * 8, None,
     "overlap or leave a hole"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]}}, b"\0" * 12, None,
     "after the last tensor"),
    ({"a": {"dtype": "Q4", "shape": [1], "data_offsets": [0, 1]}}, b"\0", None,
     "unknown dtype"),
    ({"a": {"dtype": "F32", "shape": [-1], "data_offsets": [0, 4]}}, b"\0" * 4, None,
     "bad shape"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [0]}}, b"\0" * 4, None,
     "bad data_offsets"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]}}, b"\0" * 4, 10**6,
     "exceeds the file"),
    ({"__metadata__": {"k": 1}}, b"", None, "__metadata__"),
], ids=["shape-vs-bytes", "past-the-end", "overlap", "hole", "trailing", "dtype",
        "negative-dim", "offsets", "header-length", "metadata"])
def test_reader_rejects_a_header_that_lies(tmp_path, header, data, n, match):
    with pytest.raises(ValueError, match=match):
        safetensors_io.load_file(_file(tmp_path, header, data, n))


def test_reader_rejects_truncated_and_non_json(tmp_path):
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01\x00")
    with pytest.raises(ValueError, match="8-byte"):
        safetensors_io.load_file(str(short))
    junk = tmp_path / "junk.safetensors"
    junk.write_bytes(struct.pack("<Q", 4) + b"{{{{")
    with pytest.raises(ValueError, match="not JSON"):
        safetensors_io.load_file(str(junk))


# ---- the loaders ------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prefix", ["", "bert."], ids=["bare", "bert-prefix"])
def test_bert_loader_equals_the_reference(tmp_path, dtype, prefix):
    raw = _cast(REF._bert_raw(JEncoderConfig(**ENC), np.random.default_rng(2)), dtype)
    path = str(tmp_path / "model.safetensors")
    st.save_file({prefix + k: v for k, v in raw.items()}, path)
    mine = load_hf_bert_weights(path, EncoderConfig(**ENC))
    _same_tree(mine, j_load_bert(path, JEncoderConfig(**ENC)))
    # the rectangular MLP weight catches a missed transpose by shape alone
    assert tuple(mine["l0_up_w"].shape) == (ENC["hidden_dim"], ENC["mlp_dim"])
    assert all(t.is_contiguous() for t in mine.values())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_llama_loader_equals_the_reference(tmp_path, dtype, tied):
    raw = _cast(REF._llama_raw(JDecoderConfig(**DEC), np.random.default_rng(3), tied=tied),
                dtype)
    path = str(tmp_path / "model.safetensors")
    st.save_file(raw, path)
    mine = load_hf_llama_weights(path, DecoderConfig(**DEC))
    _same_tree(mine, j_load_llama(path, JDecoderConfig(**DEC)))
    kv = DEC["num_kv_heads"] * DEC["head_dim"]
    assert tuple(mine["l0_wk"].shape) == (DEC["hidden_dim"], kv)  # GQA
    if tied:
        assert _bits(mine["lm_head"]) == _bits(raw["model.embed_tokens.weight"].T)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        n: s for n, _kind, s, _fan in decoder_param_schema(DecoderConfig(**DEC))}


def test_llama_loader_reads_shards(tmp_path):
    raw = _cast(REF._llama_raw(JDecoderConfig(**DEC), np.random.default_rng(4)), "bfloat16")
    keys = sorted(raw)
    paths = [str(tmp_path / f"model-0000{i + 1}-of-00003.safetensors") for i in range(3)]
    for i, p in enumerate(paths):
        st.save_file({k: raw[k] for k in keys[i::3]}, p)
    _same_tree(load_hf_llama_weights(paths, DecoderConfig(**DEC)),
               j_load_llama(paths, JDecoderConfig(**DEC)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["logits-bias", "no-logits-bias"])
def test_bart_loader_equals_the_reference(tmp_path, dtype, bias):
    raw = _cast(_bart_raw(np.random.default_rng(5)), dtype)
    if not bias:
        del raw["final_logits_bias"]
    path = str(tmp_path / "model.safetensors")
    st.save_file(raw, path)
    mine = load_hf_bart_weights(path, Seq2SeqConfig(**S2S))
    _same_tree(mine, j_load_bart(path, JSeq2SeqConfig(**S2S)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        n: s for n, _kind, s in seq2seq_param_schema(Seq2SeqConfig(**S2S))}
    assert _bits(mine["d1_xqw"]) == _bits(raw["model.decoder.layers.1.encoder_attn.q_proj.weight"].T)


def test_imported_trees_reach_the_engines_unchanged(tmp_path):
    """The engines keep an imported tree's values: the encoder and the
    seq2seq projections as given (f32 here), the decoder cast to its
    dtype as the reference's engine casts."""
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

    path = str(tmp_path / "bert.safetensors")
    st.save_file(REF._bert_raw(JEncoderConfig(**ENC), np.random.default_rng(6)), path)
    tree = load_hf_bert_weights(path, EncoderConfig(**ENC))
    enc = EncoderEngine(EncoderConfig(**ENC), params=tree, device="cpu")
    _same_tree(enc.params, tree)
    path = str(tmp_path / "llama.safetensors")
    st.save_file(_cast(REF._llama_raw(JDecoderConfig(**DEC), np.random.default_rng(7)),
                       "bfloat16"), path)
    tree = load_hf_llama_weights(path, DecoderConfig(**DEC))
    gen = GenerateEngine(DecoderConfig(**{**DEC, "dtype": "bfloat16"}), params=tree,
                         device="cpu")
    _same_tree(gen.params, tree)
    path = str(tmp_path / "bart.safetensors")
    st.save_file(_bart_raw(np.random.default_rng(8)), path)
    tree = load_hf_bart_weights(path, Seq2SeqConfig(**S2S))
    eng = Seq2SeqEngine(Seq2SeqConfig(**S2S), params=tree, device="cpu")
    _same_tree({k: eng.params[k] for k in tree}, tree)
    out = eng.generate_ids([[5, 9, 11]], max_new_tokens=3)
    assert len(out) == 1 and len(out[0]) <= 3
