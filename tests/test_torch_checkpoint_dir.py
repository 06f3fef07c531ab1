"""Port parity, checkpoint directories: ``load_checkpoint_dir`` and
``generate_engine_from_dir`` of docqa_tpu_torch against docqa_tpu's on the
same HF-layout directories (config.json + safetensors + vocabulary), and
the runtime serving them (``tests/test_checkpoint_dir.py``'s cases).

Exact comparisons: configs field by field (every field of the port's
config, all of which the reference's has), trees bit for bit, the same rejections with the same messages, the same keep overrides
and shipped generation policy.  Weight reads retry ``OSError`` behind the
``checkpoint`` breaker; a device fault passes at once and feeds neither.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from docqa_tpu.models import hf_checkpoint as jhf
from docqa_tpu_torch.config import DecoderConfig, EncoderConfig, GenerateConfig, Seq2SeqConfig
from docqa_tpu_torch.models import hf_checkpoint as hf
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.text.bpe import BPETokenizer

safetensors = pytest.importorskip("safetensors.numpy")
pytest.importorskip("tokenizers")
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def _ref_module(name):
    spec = importlib.util.spec_from_file_location("_ref_" + name, os.path.join(HERE, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_DIR = _ref_module("test_checkpoint_dir.py")  # the reference's Mistral-layout fixture
REF_BPE = _ref_module("test_bpe.py")  # its byte-level BPE fixture
REF_IMPORT = _ref_module("test_hf_import.py")  # its synthetic BERT tree
llama_dir = REF_DIR.llama_dir
bytelevel_json = REF_BPE.bytelevel_json

BART = dict(vocab_size=400, d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
            decoder_ffn_dim=128, max_position_embeddings=64)
SHIPPED = dict(num_beams=4, length_penalty=2.0, min_length=5, no_repeat_ngram_size=3,
               forced_bos_token_id=0, max_length=20)
BERT = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=48)
TYPES = {DecoderConfig: JDecoderConfig, EncoderConfig: JEncoderConfig,
         Seq2SeqConfig: JSeq2SeqConfig}


def _bart_raw(rng):
    d, m, v = BART["d_model"], BART["encoder_ffn_dim"], BART["vocab_size"]

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    raw = {"model.shared.weight": w(v, d), "final_logits_bias": w(1, v)}
    for side in ("encoder", "decoder"):
        raw[f"model.{side}.embed_positions.weight"] = w(BART["max_position_embeddings"] + 2, d)
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
            raw[pre + "fc1.weight"], raw[pre + "fc1.bias"] = w(m, d), w(m)
            raw[pre + "fc2.weight"], raw[pre + "fc2.bias"] = w(d, m), w(d)
            raw[pre + "final_layer_norm.weight"] = 1 + w(d)
            raw[pre + "final_layer_norm.bias"] = w(d)
    return raw


@pytest.fixture(scope="module")
def bart_dir(tmp_path_factory, bytelevel_json):
    """A bart-large-cnn-layout directory at small widths: config.json with
    the shipped policy, one float32 model.safetensors, a byte-level BPE
    tokenizer.json (the reference tests' trained fixture)."""
    d = tmp_path_factory.mktemp("bart")
    json.dump({"model_type": "bart", "activation_function": "gelu", **BART, **SHIPPED},
              open(d / "config.json", "w"))
    safetensors.save_file(_bart_raw(np.random.default_rng(0)), str(d / "model.safetensors"))
    shutil.copy(bytelevel_json, d / "tokenizer.json")
    return str(d)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A MiniLM-layout directory at small widths with a WordPiece vocab.txt."""
    d = tmp_path_factory.mktemp("bert")
    json.dump({"model_type": "bert", **BERT}, open(d / "config.json", "w"))
    cfg = JEncoderConfig(vocab_size=BERT["vocab_size"], hidden_dim=BERT["hidden_size"],
                         num_layers=2, num_heads=2, mlp_dim=64, max_seq_len=48,
                         embed_dim=BERT["hidden_size"])
    safetensors.save_file(REF_IMPORT._bert_raw(cfg, np.random.default_rng(1)),
                          str(d / "model.safetensors"))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "patient", "was",
             "admitted", "with", "chest", "pain", "blood", "pressure", "##s", "##ed"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    return str(d)


def _same_config(mine, ref):
    assert TYPES[type(mine)] is type(ref)
    both = {f.name for f in dataclasses.fields(ref)} & {f.name for f in dataclasses.fields(mine)}
    assert both == {f.name for f in dataclasses.fields(mine)}
    for name in sorted(both):
        assert getattr(mine, name) == getattr(ref, name), name


def _same_tree(mine, ref):
    assert set(mine) == set(ref)
    for k, v in ref.items():
        want = np.asarray(v)
        got = mine[k]
        assert got.shape == want.shape and str(got.dtype).endswith(want.dtype.name), k
        assert got.contiguous().view(-1).view(torch.uint8).numpy().tobytes() == want.tobytes(), k


@pytest.mark.parametrize("which, expect", [
    ("llama", DecoderConfig), ("bart", Seq2SeqConfig), ("bert", EncoderConfig)])
def test_load_equals_the_reference(which, expect, llama_dir, bart_dir, bert_dir):
    path = {"llama": llama_dir, "bart": bart_dir, "bert": bert_dir}[which]
    cfg, tree, tok = hf.load_checkpoint_dir(path, expect=expect)
    jcfg, jtree, jtok = jhf.load_checkpoint_dir(path, expect=TYPES[expect])
    assert isinstance(cfg, expect) and tok == jtok == cfg.tokenizer_path
    _same_config(cfg, jcfg)
    _same_tree(tree, jtree)
    if which == "bart":
        assert (cfg.num_beams, cfg.length_penalty, cfg.min_length, cfg.no_repeat_ngram,
                cfg.forced_bos_id) == (4, 2.0, 5, 3, 0)


def test_shipped_policy_equals_the_reference():
    raw = {"vocab_size": 50264, "d_model": 64, "encoder_layers": 1, "decoder_layers": 1,
           "encoder_attention_heads": 4, "encoder_ffn_dim": 128,
           "max_position_embeddings": 128, "num_beams": 4, "length_penalty": 2.0,
           "min_length": 56, "no_repeat_ngram_size": 3, "forced_bos_token_id": 0}
    _same_config(hf._seq2seq_config(raw, "tok.json"), jhf._seq2seq_config(raw, "tok.json"))
    bare = {k: raw[k] for k in list(raw)[:7]}
    _same_config(hf._seq2seq_config(bare, None), jhf._seq2seq_config(bare, None))
    # the port's MLP is the exact GELU only: any other activation refused
    hf._seq2seq_config(dict(raw, activation_function="gelu"), None)
    for other in ("relu", "gelu_new"):
        with pytest.raises(ValueError, match=f"activation_function '{other}'"):
            hf._seq2seq_config(dict(raw, activation_function=other), None)
    llama = dict(REF_DIR.HF_CONFIG, head_dim=16)
    _same_config(hf._decoder_config(llama, "t.json"), jhf._decoder_config(llama, "t.json"))
    bert = dict(BERT)
    _same_config(hf._encoder_config(bert, "v.txt"), jhf._encoder_config(bert, "v.txt"))


def _raises_like_the_reference(exc, match, path, **kw):
    with pytest.raises(exc, match=match) as mine:
        hf.load_checkpoint_dir(path, **{k: v for k, v in kw.items()})
    jkw = dict(kw)
    if "expect" in jkw:
        jkw["expect"] = TYPES[jkw["expect"]]
    with pytest.raises(exc, match=match) as ref:
        jhf.load_checkpoint_dir(path, **jkw)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("model_type", ["t5", "qwen2", "gemma", "distilbert", ""])
def test_unsupported_families_are_rejected_like_the_reference(tmp_path, model_type):
    json.dump({"model_type": model_type}, open(tmp_path / "config.json", "w"))
    _raises_like_the_reference(ValueError, "unsupported model_type", str(tmp_path))


@pytest.mark.parametrize("model_type, expect, family", [
    ("mistral", EncoderConfig, "BERT-family"), ("bert", Seq2SeqConfig, "BART-family"),
    ("bart", DecoderConfig, "Llama/Mistral-family")])
def test_wrong_family_rejected_before_the_weights(tmp_path, model_type, expect, family):
    # no safetensors here: the family mismatch must be the error
    json.dump({"model_type": model_type}, open(tmp_path / "config.json", "w"))
    _raises_like_the_reference(ValueError, "not a " + family, str(tmp_path), expect=expect)


def test_missing_vocabulary_weights_and_sharding(llama_dir, bart_dir, tmp_path):
    d = tmp_path / "weights_only"
    d.mkdir()
    shutil.copy(f"{llama_dir}/config.json", d / "config.json")
    shutil.copy(f"{llama_dir}/model.safetensors", d / "model.safetensors")
    _raises_like_the_reference(ValueError, "no tokenizer", str(d))
    cfg, _tree, tok = hf.load_checkpoint_dir(
        str(d), tokenizer_fallback=f"{llama_dir}/tokenizer.json")
    assert tok == cfg.tokenizer_path == f"{llama_dir}/tokenizer.json"
    (d / "model.safetensors").unlink()
    _raises_like_the_reference(FileNotFoundError, "no model", str(d),
                               tokenizer_fallback=f"{llama_dir}/tokenizer.json")
    s = tmp_path / "sharded_bart"
    shutil.copytree(bart_dir, s)
    shutil.copy(s / "model.safetensors", s / "model-00002-of-00002.safetensors")
    _raises_like_the_reference(ValueError, "sharded bart", str(s))


def test_keep_overrides_the_loaded_config(llama_dir, bart_dir):
    cfg, _t, _ = hf.load_checkpoint_dir(llama_dir, expect=DecoderConfig,
                                        keep={"max_seq_len": 64})
    assert cfg.max_seq_len == 64
    cfg, _t, _ = hf.load_checkpoint_dir(bart_dir, expect=Seq2SeqConfig,
                                        keep={"num_beams": 1, "min_length": 0})
    jcfg, _t, _ = jhf.load_checkpoint_dir(bart_dir, expect=JSeq2SeqConfig,
                                          keep={"num_beams": 1, "min_length": 0})
    _same_config(cfg, jcfg)
    assert (cfg.num_beams, cfg.min_length, cfg.no_repeat_ngram) == (1, 0, 3)


def test_engine_from_dir_serves_real_text(llama_dir):
    eng = hf.generate_engine_from_dir(llama_dir, gen=GenerateConfig(max_new_tokens=8),
                                      device="cpu")
    assert isinstance(eng.tokenizer, BPETokenizer)
    assert eng.gen.eos_id == eng.tokenizer.eos_id  # the checkpoint's </s>
    out = eng.generate_texts(["the patient was admitted"])
    assert len(out) == 1 and isinstance(out[0], str)
    assert eng.cfg.num_kv_heads == 2 and eng.params["tok_emb"].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hf.generate_engine_from_dir(llama_dir)  # the card unless the CPU is asked for


@pytest.mark.parametrize("bits", [8, 4])
def test_quantisation_is_refused_naming_item_8(llama_dir, bits):
    with pytest.raises(NotImplementedError, match="item 8"):
        hf.generate_engine_from_dir(llama_dir, quant_bits=bits, device="cpu")
    cfg = DecoderConfig(quantize_weights=True, quant_bits=bits)
    from docqa_tpu_torch.engines.generate import GenerateEngine

    with pytest.raises(NotImplementedError, match="item 8"):
        GenerateEngine(cfg, device="cpu")


def test_a_device_fault_passes_the_load_unretried(llama_dir, monkeypatch):
    """A kernel or CUDA error raised while a tree is read goes straight to
    the caller: one attempt, and the breaker is not fed; an OSError is
    retried three times and feeds it."""
    from docqa_tpu_torch.models import decoder as dec_mod

    breaker = hf._LOAD_BREAKER
    calls = []
    for fault in (KernelError("flash_attention launch failed: CUDA error 700"),
                  RuntimeError("CUDA error: an illegal memory access was encountered")):
        def broken(*a, _fault=fault):
            calls.append(1)
            raise _fault

        monkeypatch.setattr(dec_mod, "load_hf_llama_weights", broken)
        before = breaker._failures
        with pytest.raises(type(fault), match="CUDA error"):
            hf.load_checkpoint_dir(llama_dir)
        assert len(calls) == 1 and breaker._failures == before
        calls.clear()

    def flaky(*a):
        calls.append(1)
        raise OSError("stale NFS handle")

    monkeypatch.setattr(dec_mod, "load_hf_llama_weights", flaky)
    try:
        with pytest.raises(OSError, match="stale"):
            hf.load_checkpoint_dir(llama_dir)
        assert len(calls) == 3 and breaker._failures == 3
    finally:
        breaker.record_success()  # the process-wide breaker, closed again
    assert breaker.state == "closed" and breaker._failures == 0


# ---- the runtime -------------------------------------------------------------------

def _overrides(**extra):
    return {
        "encoder.hidden_dim": 64, "encoder.num_layers": 1, "encoder.num_heads": 4,
        "encoder.mlp_dim": 128, "encoder.embed_dim": 64, "store.dim": 64,
        "store.shard_capacity": 256, "ner.hidden_dim": 32, "ner.num_layers": 1,
        "ner.num_heads": 2, "ner.mlp_dim": 64, "ner.train_steps": 0,
        "generate.max_new_tokens": 8, "generate.max_concurrent": 2,
        "generate.prefill_buckets": (128,), "telemetry.enabled": False,
        "retrieval_quality.enabled": False, **extra,
    }


def test_runtime_serves_a_decoder_checkpoint(llama_dir):
    """The reference's ``test_runtime_serves_checkpoint`` on the port: the
    generator and the pool speak the checkpoint's vocabulary, its
    architecture comes from config.json, its context is capped at the
    configured window, /ask answers over an ingested note, and /api/status
    lists the loader's ``checkpoint`` breaker."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import DocQARuntime, Request, make_app

    cfg = load_config(env={}, overrides=_overrides(**{
        "decoder.checkpoint_dir": llama_dir, "decoder.max_seq_len": 96,
        "decoder.chat_template": "mistral-inst"}))
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        assert isinstance(rt.generator.tokenizer, BPETokenizer)
        # the operator's template applies to the checkpoint (the reference
        # drops it with the rest of the configured architecture)
        assert rt.generator.cfg.chat_template == "mistral-inst"
        assert rt.generator.cfg.num_kv_heads == 2
        assert rt.generator.cfg.max_seq_len == 96  # min(128 shipped, 96 configured)
        assert set(rt.load_seconds) == {"decoder"}
        rec = rt.pipeline.ingest_document(
            "note.txt", b"the patient was admitted with chest pain", patient_id="p1")
        assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
        res = rt.qa.ask("what happened to the patient?")
        assert isinstance(res["answer"], str) and res["sources"]
        app = make_app(rt)
        try:
            status = app.handle(Request("GET", "/api/status")).payload
        finally:
            assert app.close(timeout=30)
        assert status["breakers"]["checkpoint"] == "closed"
        assert rt.breakers.get("checkpoint") is hf._LOAD_BREAKER
        with pytest.raises(ValueError, match="pass one"):
            DocQARuntime(cfg, device="cpu", decoder_params={})
    finally:
        rt._warmup_thread.join(60)
        rt.stop()


def test_runtime_serves_all_three_checkpoints(llama_dir, bart_dir, bert_dir):
    """Encoder, decoder and seq2seq summarizer from their directories; an
    operator-set policy knob wins over the checkpoint's, the others are
    the checkpoint's; the summarizer packs within the source window."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine
    from docqa_tpu_torch.service.app import DocQARuntime
    from docqa_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = load_config(env={}, overrides=_overrides(**{
        "encoder.checkpoint_dir": bert_dir, "store.dim": BERT["hidden_size"],
        "decoder.checkpoint_dir": llama_dir, "seq2seq.checkpoint_dir": bart_dir,
        "summarizer.backend": "seq2seq", "seq2seq.num_beams": 2,
        "summarizer.max_summary_tokens": 6, "flags.use_fake_retrieval": True}))
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        assert isinstance(rt.encoder, EncoderEngine)
        assert isinstance(rt.encoder.tokenizer, WordPieceTokenizer)
        s2s = rt.summarizer.generator
        assert isinstance(s2s, Seq2SeqEngine) and isinstance(s2s.tokenizer, BPETokenizer)
        assert (s2s.cfg.num_beams, s2s.cfg.length_penalty, s2s.cfg.min_length,
                s2s.cfg.no_repeat_ngram) == (2, 2.0, 5, 3)
        assert rt.summarizer.cfg.max_input_tokens == BART["max_position_embeddings"]
        assert set(rt.load_seconds) == {"encoder", "decoder", "seq2seq"}
        out = rt.synthesis.patient_summary_submit("P001")()
        assert out.patient_id == "P001" and isinstance(out.sections[0].content, str)
        assert s2s.last_stats["steps"] >= 1
    finally:
        rt._warmup_thread.join(60)
        rt.stop()


@pytest.mark.parametrize("overrides, exc, match", [
    ({"encoder.checkpoint_dir": "LLAMA"}, ValueError, "not a BERT-family"),
    ({"encoder.checkpoint_dir": "BERT"}, ValueError, "store.dim is 64"),
    ({"seq2seq.checkpoint_dir": "LLAMA", "summarizer.backend": "seq2seq"}, ValueError,
     "not a BART-family"),
    ({"decoder.checkpoint_dir": "LLAMA", "decoder.quantize_weights": True},
     NotImplementedError, "item 8"),
], ids=["encoder-wrong-family", "store-dim", "seq2seq-wrong-family", "quantised-decoder"])
def test_runtime_rejects(llama_dir, bert_dir, overrides, exc, match):
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import DocQARuntime

    dirs = {"LLAMA": llama_dir, "BERT": bert_dir}
    o = {k: dirs.get(v, v) if isinstance(v, str) else v for k, v in overrides.items()}
    with pytest.raises(exc, match=match):
        DocQARuntime(load_config(env={}, overrides=_overrides(**o)), device="cpu")


def test_quantised_decoder_refused_before_any_shard_is_read(llama_dir, monkeypatch):
    """``decoder.quantize_weights`` fails the boot before the checkpoint
    directory is opened: no config, shard or vocabulary is read."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.models import safetensors_io
    from docqa_tpu_torch.service.app import DocQARuntime

    reads = []
    monkeypatch.setattr(safetensors_io, "load_file", lambda *a, **k: reads.append(a))
    monkeypatch.setattr(hf, "load_checkpoint_dir", lambda *a, **k: reads.append(a))
    cfg = load_config(env={}, overrides=_overrides(**{
        "decoder.checkpoint_dir": llama_dir, "decoder.quantize_weights": True}))
    with pytest.raises(NotImplementedError, match="item 8"):
        DocQARuntime(cfg, device="cpu")
    assert reads == []


def test_checkpoint_dirs_from_the_environment(bert_dir):
    """``DOCQA_ENCODER__CHECKPOINT_DIR`` and its siblings reach the config
    as strings, as the reference's overlay reads them."""
    from docqa_tpu.config import load_config as j_load_config
    from docqa_tpu_torch.config import load_config

    env = {"DOCQA_ENCODER__CHECKPOINT_DIR": bert_dir,
           "DOCQA_SEQ2SEQ__CHECKPOINT_DIR": "/ckpt/bart", "DOCQA_SEQ2SEQ__NUM_BEAMS": "1",
           "DOCQA_DECODER__CHECKPOINT_DIR": "/ckpt/mistral",
           "DOCQA_SUMMARIZER__BACKEND": "seq2seq"}
    mine, ref = load_config(env=env), j_load_config(env=env)
    for section in ("encoder", "decoder", "seq2seq"):
        _same_config(getattr(mine, section), getattr(ref, section))
    assert mine.encoder.checkpoint_dir == bert_dir and mine.seq2seq.num_beams == 1
    assert mine.summarizer.backend == ref.summarizer.backend == "seq2seq"
