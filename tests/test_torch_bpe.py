"""Port parity, the real-vocabulary tokenizers: docqa_tpu_torch's
``WordPieceTokenizer``, ``BPETokenizer`` (byte-level and metaspace) and
``SentencePieceTokenizer`` against docqa_tpu's on the same files, and
against the independent ``tokenizers`` package where the reference's
tests hold it there (``tests/test_bpe.py``'s fixtures: vocabularies trained
by that package, and a hand-serialized ``tokenizer.model``).

Tokenizers are exact: ids and decoded text must be equal, no tolerance.
Texts: the reference tests' edge cases (odd spacing, tabs and newlines,
accents, CJK, contractions, punctuation runs, empty and blank strings) and
the port's synthetic clinical notes.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from docqa_tpu.text import bpe as jbpe
from docqa_tpu.text.tokenizer import WordPieceTokenizer as JWordPiece
from docqa_tpu.text.tokenizer import default_tokenizer as j_default_tokenizer
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig, Seq2SeqConfig
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.text import bpe
from docqa_tpu_torch.text.tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    default_tokenizer,
)

tokenizers = pytest.importorskip("tokenizers")
torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "_ref_test_bpe", os.path.join(os.path.dirname(__file__), "test_bpe.py"))
REF = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(REF)  # the reference tests' corpus, texts and fixtures

NOTES = [datagen.generate_example(np.random.default_rng(i), datagen.TRAIN_LEXICONS)[0]
         for i in range(12)]
TEXTS = REF.TEXTS + NOTES

bytelevel_json = REF.bytelevel_json
metaspace_json = REF.metaspace_json
sp_model = REF.sp_model


@pytest.fixture(scope="module")
def vocab_txt(tmp_path_factory):
    """A BERT vocab.txt: the specials, words and ## continuations of the
    reference corpus, so unknown words fall back to [UNK] and long ones
    split into pieces."""
    words = sorted({w for t in REF.CORPUS for w in t.lower().replace(".", " ").split()})
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words[::2]
    pieces += sorted({"##" + w[i:] for w in words[1::2] for i in (1, 2, 3) if len(w) > i})
    pieces += sorted({w[:i] for w in words[1::2] for i in (1, 2, 3) if len(w) > i})
    path = str(tmp_path_factory.mktemp("wp") / "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(dict.fromkeys(pieces)) + "\n")
    return path


def _same(mine, ref, texts, **kw):
    for text in texts:
        ids = mine.encode(text, **kw)
        assert ids == ref.encode(text, **kw), text
        assert mine.decode_ids(ids) == ref.decode_ids(ids), text


@pytest.mark.parametrize("lowercase", [True, False])
def test_wordpiece_equals_the_reference(vocab_txt, lowercase):
    mine = WordPieceTokenizer.from_file(vocab_txt, lowercase=lowercase)
    ref = JWordPiece.from_file(vocab_txt, lowercase=lowercase)
    assert (mine.pad_id, mine.unk_id, mine.cls_id, mine.sep_id) == (0, 1, 2, 3)
    _same(mine, ref, TEXTS)
    _same(mine, ref, TEXTS, add_specials=False)
    for max_len in (4, 9, 64):
        a, la = mine.batch(TEXTS, max_len)
        b, lb = ref.batch(TEXTS, max_len)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    # a word past max_word_chars is one [UNK], as in the reference
    assert mine.encode("x" * 101, add_specials=False) == [mine.unk_id]


@pytest.mark.parametrize("which", ["bytelevel", "metaspace"])
def test_bpe_equals_the_reference_and_the_tokenizers_package(
        which, bytelevel_json, metaspace_json):
    from tokenizers import Tokenizer

    path = bytelevel_json if which == "bytelevel" else metaspace_json
    mine = bpe.BPETokenizer.from_tokenizer_json(path)
    ref = jbpe.BPETokenizer.from_tokenizer_json(path)
    assert mine.mode == ref.mode == ("byte_level" if which == "bytelevel" else "metaspace")
    assert (mine.bos_id, mine.eos_id, mine.pad_id, mine.unk_id, mine.add_bos, mine.add_eos) \
        == (ref.bos_id, ref.eos_id, ref.pad_id, ref.unk_id, ref.add_bos, ref.add_eos)
    _same(mine, ref, TEXTS)
    _same(mine, ref, TEXTS, add_specials=False)
    for max_len in (3, 8, 200):
        _same(mine, ref, TEXTS, max_len=max_len)
        a, la = mine.batch(TEXTS, max_len)
        b, lb = ref.batch(TEXTS, max_len)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    theirs = (Tokenizer.from_file(path) if which == "bytelevel"
              else REF._their_metaspace(path))
    texts = TEXTS if which == "bytelevel" else [
        t for t in TEXTS if "\t" not in t and "\n" not in t]
    for text in texts:
        ids = mine.encode(text, add_specials=False)
        assert ids == theirs.encode(text, add_special_tokens=False).ids, text
        assert mine.decode_ids(ids) == theirs.decode(ids), text


def test_metaspace_word_split_equals_the_reference(metaspace_json):
    """The per-word path (taken when no vocab token holds an inner "▁")
    and the whole-text path each give the reference's ids; the flag is
    detected as the reference detects it (this trained vocabulary has
    cross-word tokens, so whole-text is the exact path)."""
    mine = bpe.BPETokenizer.from_tokenizer_json(metaspace_json)
    ref = jbpe.BPETokenizer.from_tokenizer_json(metaspace_json)
    assert mine._word_split == ref._word_split
    for flag in (True, False):
        mine._word_split = ref._word_split = flag
        mine._cache.clear()
        ref._cache.clear()
        for text in TEXTS:
            assert mine.encode(text) == ref.encode(text), (flag, text)
    assert 0 < len(mine._cache) <= mine._CACHE_MAX_ENTRIES


def test_pre_tokenizer_scanner_equals_the_reference():
    for text in TEXTS + ["don't", "a  b", " x", "ab 12!?", "tail  ", "x\n\n y", "  ", "'s'll"]:
        assert bpe.gpt2_pre_tokenize(text) == jbpe.gpt2_pre_tokenize(text), text
    assert bpe._byte_alphabet() == jbpe._byte_alphabet()


@pytest.mark.parametrize("model_type", [2, 1], ids=["bpe", "unigram"])
def test_sentencepiece_equals_the_reference(sp_model, model_type):
    mine = bpe.SentencePieceTokenizer.from_file(sp_model)
    ref = jbpe.SentencePieceTokenizer.from_file(sp_model)
    mine.model_type = ref.model_type = model_type  # Viterbi over the same scores
    assert (mine.unk_id, mine.bos_id, mine.eos_id) == (ref.unk_id, ref.bos_id, ref.eos_id)
    texts = ["the patient", "metformin 500mg", "café x", "zq!?", ""] + TEXTS
    _same(mine, ref, texts)
    _same(mine, ref, texts, add_specials=False, max_len=7)
    if model_type == 2:  # the reference test's known BPE segmentation
        assert [mine._inv[i] for i in mine.encode("the patient", add_specials=False)] == [
            "▁the", "▁", "p", "a", "ti", "ent"]


def test_protobuf_reader_equals_the_reference(sp_model):
    buf = open(sp_model, "rb").read()
    assert list(bpe._pb_fields(buf)) == list(jbpe._pb_fields(buf))
    for n in (0, 1, 127, 128, 300, 2**35 + 7):
        enc = REF._sp_varint(n)
        assert bpe._pb_varint(enc, 0) == jbpe._pb_varint(enc, 0) == (n, len(enc))
    with pytest.raises(ValueError, match="wire type"):
        list(bpe._pb_fields(bytes([0x0B])))  # field 1, wire type 3


def test_load_tokenizer_and_default_tokenizer_dispatch(
        bytelevel_json, sp_model, vocab_txt, tmp_path):
    assert isinstance(bpe.load_tokenizer(bytelevel_json), bpe.BPETokenizer)
    assert isinstance(bpe.load_tokenizer(sp_model), bpe.SentencePieceTokenizer)
    assert isinstance(bpe.load_tokenizer(vocab_txt), WordPieceTokenizer)
    with pytest.raises(ValueError, match="unrecognized"):
        bpe.load_tokenizer(str(tmp_path / "vocab.bin"))
    for path, cls in ((bytelevel_json, bpe.BPETokenizer), (sp_model, bpe.SentencePieceTokenizer),
                      (vocab_txt, WordPieceTokenizer), (None, HashTokenizer)):
        mine, ref = default_tokenizer(777, vocab_path=path), j_default_tokenizer(777, path)
        assert type(mine) is cls and type(ref).__name__ == cls.__name__
        assert mine.vocab_size == ref.vocab_size
        _same(mine, ref, NOTES[:3])


def test_tokenizer_json_rejects_other_models(tmp_path):
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({"model": {"type": "WordPiece", "vocab": {}}}))
    with pytest.raises(ValueError, match="only BPE"):
        bpe.BPETokenizer.from_tokenizer_json(str(path))
    with pytest.raises(ValueError, match="unknown BPE mode"):
        bpe.BPETokenizer({"a": 0}, [], mode="wordpiece")


def test_generate_engine_adopts_the_vocabulary_eos(metaspace_json):
    """A decoder configured with a tokenizer file stops on the
    checkpoint's eos and pads with its pad, as the reference's engine; a
    caller's custom eos stays."""
    from docqa_tpu.config import DecoderConfig as JDecoderConfig
    from docqa_tpu.config import GenerateConfig as JGenerateConfig
    from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine

    tok = bpe.BPETokenizer.from_tokenizer_json(metaspace_json)
    dec = dict(vocab_size=tok.vocab_size, hidden_dim=32, num_layers=1, num_heads=4,
               num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
               tokenizer_path=metaspace_json)
    eng = GenerateEngine(DecoderConfig(**dec), GenerateConfig(max_new_tokens=4), device="cpu")
    ref = JGenerateEngine(JDecoderConfig(**dec), JGenerateConfig(max_new_tokens=4))
    assert isinstance(eng.tokenizer, bpe.BPETokenizer)
    assert (eng.gen.eos_id, eng.gen.pad_id) == (ref.gen.eos_id, ref.gen.pad_id)
    assert eng.gen.eos_id == tok.eos_id
    custom = GenerateEngine(DecoderConfig(**dec), GenerateConfig(eos_id=7), device="cpu")
    assert custom.gen.eos_id == 7
    hashed = GenerateEngine(DecoderConfig(**{**dec, "tokenizer_path": None}),
                            GenerateConfig(), device="cpu")
    assert hashed.gen == GenerateConfig()
    out = eng.generate_texts(["the patient"])
    assert len(out) == 1 and isinstance(out[0], str)


def test_seq2seq_and_encoder_engines_load_the_tokenizer_file(bytelevel_json, vocab_txt):
    from docqa_tpu_torch.config import EncoderConfig
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

    tok = bpe.BPETokenizer.from_tokenizer_json(bytelevel_json)
    cfg = Seq2SeqConfig(vocab_size=tok.vocab_size, d_model=32, enc_layers=1, dec_layers=1,
                        num_heads=4, mlp_dim=64, max_src_len=64, max_tgt_len=16,
                        dtype="float32", tokenizer_path=bytelevel_json)
    eng = Seq2SeqEngine(cfg, device="cpu")
    assert isinstance(eng.tokenizer, bpe.BPETokenizer)
    out = eng.generate_texts(["blood pressure was controlled"], max_new_tokens=4)
    assert len(out) == 1 and isinstance(out[0], str)
    enc = EncoderEngine(EncoderConfig(vocab_size=600, hidden_dim=32, num_layers=1,
                                      num_heads=1, mlp_dim=32, embed_dim=32,
                                      dtype="float32", tokenizer_path=vocab_txt),
                        device="cpu")
    assert isinstance(enc.tokenizer, WordPieceTokenizer)
    assert enc.encode_texts(NOTES[:2]).shape == (2, 32)


def test_untemplated_bpe_tail_matches_encode(tmp_path):
    """The port's counterpart of ``tests/test_rag_fused.py``'s case of that
    name: with no chat template and a sentencepiece-lineage BPE tokenizer
    (``add_eos=False``) the fused prompt ends in no spurious EOS, its tail
    equals ``encode(mid + question + suffix)``, its head opens with BOS,
    and the packed prompt equals the reference's FusedRAG's."""
    from tokenizers import Tokenizer, models, normalizers, trainers

    from docqa_tpu.config import DecoderConfig as JDecoderConfig
    from docqa_tpu.config import EncoderConfig as JEncoderConfig
    from docqa_tpu.config import GenerateConfig as JGenerateConfig
    from docqa_tpu.config import StoreConfig as JStoreConfig
    from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
    from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
    from docqa_tpu.engines.rag_fused import FusedRAG as JFusedRAG
    from docqa_tpu.index.store import VectorStore as JVectorStore
    from docqa_tpu_torch.config import EncoderConfig, StoreConfig
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.rag_fused import FusedRAG
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.service.qa import QA_TEMPLATE

    chunks = ["aspirin 81 mg daily reduces cardiac risk score 9",
              "metformin controls glucose in diabetes score 7",
              "lisinopril lowers blood pressure effectively score 8",
              "warfarin requires inr monitoring weekly score 6"]
    question = "what reduces cardiac risk?"
    path = str(tmp_path / "metaspace.json")
    t = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True))
    t.normalizer = normalizers.Sequence(
        [normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    t.train_from_iterator(
        [QA_TEMPLATE.format(context=c, question=question) for c in chunks],
        trainers.BpeTrainer(vocab_size=600, show_progress=False, special_tokens=[
            "<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]))
    t.save(path)
    blob = json.load(open(path))
    for at in blob["added_tokens"]:
        if at["content"].startswith("<0x"):
            at["special"] = False
    json.dump(blob, open(path, "w"))

    enc_kw = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64,
                  max_seq_len=128, embed_dim=16, dtype="float32")
    dec_kw = dict(vocab_size=1024, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=1024,
                  dtype="float32")
    gen_kw = dict(temperature=0.0, eos_id=2, prefill_buckets=(128, 256, 512),
                  max_new_tokens=4)
    sides = {}
    for name, (Enc, Ecfg, Gen, Dcfg, Gcfg, Store, Scfg, Rag, tok, kw) in {
        "port": (EncoderEngine, EncoderConfig, GenerateEngine, DecoderConfig, GenerateConfig,
                 VectorStore, StoreConfig, FusedRAG, bpe.BPETokenizer, {"device": "cpu"}),
        "ref": (JEncoderEngine, JEncoderConfig, JGenerateEngine, JDecoderConfig,
                JGenerateConfig, JVectorStore, JStoreConfig, JFusedRAG, jbpe.BPETokenizer, {}),
    }.items():
        tk = tok.from_tokenizer_json(path)
        assert tk.add_eos is False
        e = Enc(Ecfg(**enc_kw), seed=3, **kw)
        g = Gen(Dcfg(**dec_kw), Gcfg(**gen_kw), tokenizer=tk, seed=11, **kw)
        store = Store(Scfg(dim=16, shard_capacity=256, token_width=32), **kw)
        rows = np.zeros((len(chunks), 32), np.int32)
        lens = np.zeros((len(chunks),), np.int32)
        for i, text in enumerate(chunks):
            ids = tk.encode(text, add_specials=False)[:32]
            rows[i, : len(ids)] = ids
            lens[i] = len(ids)
        store.add(np.asarray(e.encode_texts(chunks), np.float32),
                  [{"doc_id": f"d{i}", "source": f"chunk {i}", "text_content": c}
                   for i, c in enumerate(chunks)], token_rows=rows, token_lens=lens)
        rag = Rag(e, store, g, QA_TEMPLATE, k=3, **kw)
        assert rag._tail_extra == []
        assert rag._prefix[0] == tk.bos_id
        prompt = rag.ask_submit(question, max_new_tokens=4).prompt_tokens()
        want_tail = [int(x) for x in tk.encode(rag._mid + question + rag._suffix,
                                               add_specials=False)]
        assert prompt[-len(want_tail):] == want_tail
        assert prompt[-1] != tk.eos_id
        sides[name] = [int(x) for x in prompt]
    assert sides["port"] == sides["ref"]


def test_port_tokenizers_need_no_tokenizer_package(bytelevel_json, metaspace_json, sp_model):
    """The port's modules import neither ``tokenizers`` nor ``sentencepiece``
    (the card's machine has neither); every file above loads with both
    blocked."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('tokenizers', 'sentencepiece', 'transformers', 'safetensors', 'jax'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(__file__))!r})\n"
        "from docqa_tpu_torch.text.bpe import load_tokenizer\n"
        f"for p in ({bytelevel_json!r}, {metaspace_json!r}, {sp_model!r}):\n"
        "    print(load_tokenizer(p).encode('the patient'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 3


def test_engines_dataclass_fields_carry_tokenizer_paths():
    from docqa_tpu.config import DecoderConfig as JDecoderConfig
    from docqa_tpu.config import EncoderConfig as JEncoderConfig
    from docqa_tpu_torch.config import EncoderConfig

    for mine, ref in ((EncoderConfig, JEncoderConfig), (DecoderConfig, JDecoderConfig)):
        f = {x.name: x.default for x in dataclasses.fields(mine)}
        g = {x.name: x.default for x in dataclasses.fields(ref)}
        assert f["tokenizer_path"] is None and g["tokenizer_path"] is None
        assert f["checkpoint_dir"] is None and g["checkpoint_dir"] is None
