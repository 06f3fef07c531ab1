"""Port parity, de-identification: docqa_tpu_torch's recognizers, tagger,
DeidEngine, synthetic-note generator and NER cache against docqa_tpu's
(CPU, float32, tagger at 2 layers x hidden 64 x 4 heads, 128 positions).

Tolerances: the tagger's logits within 1e-4 (float32 on both sides, other
summation orders).  Spans must be identical, with one tie rule: a word
whose two largest logits in the reference differ by less than 1e-4 may
take either label, so a span that differs only through such a word is not
a miss.  Everything host-side (regexes, overlap resolution, anonymization,
token ids, generated notes) must be identical.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from docqa_tpu.config import NERConfig as JNERConfig
from docqa_tpu.deid import datagen as jdatagen
from docqa_tpu.deid import engine as jengine
from docqa_tpu.models.ner import bio_to_spans as j_bio_to_spans
from docqa_tpu.models.ner import init_ner_params as j_init_ner_params
from docqa_tpu.models.ner import label_ids as j_label_ids
from docqa_tpu.models.ner import ner_forward as j_ner_forward
from docqa_tpu.text.tokenizer import ShapeHashTokenizer as JShapeHashTokenizer
from docqa_tpu.training.ner import save_ner_params as j_save_ner_params
from docqa_tpu_torch.config import NERConfig
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.deid import engine
from docqa_tpu_torch.models.ner import bio_to_spans, label_ids, ner_forward
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.text.tokenizer import ShapeHashTokenizer
from docqa_tpu_torch.training.ner import (
    load_ner_params,
    save_ner_params,
)
from docqa_tpu_torch.weights import ner_params_to_torch

torch.set_num_threads(1)

NER = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_seq_len=128, dtype="float32")
TIE = 1e-4


def _cfgs():
    return JNERConfig(**NER), NERConfig(**NER)


@pytest.fixture(scope="module")
def tagger():
    """The reference's jax.random tagger, and the same tree as numpy."""
    jcfg, cfg = _cfgs()
    jparams = j_init_ner_params(jax.random.PRNGKey(3), jcfg)
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def header(rng):
    """A header line of pattern-class PHI: phone, email, French date."""
    months = ["janvier", "février", "mars", "avril", "mai", "juin", "juillet",
              "août", "septembre", "octobre", "novembre", "décembre"]
    phone = " ".join(f"{int(rng.integers(0, 100)):02d}" for _ in range(5))
    email = f"dossier{int(rng.integers(1000, 9999))}@chu-{int(rng.integers(1, 99))}.fr"
    date = f"{int(rng.integers(1, 29))} {months[int(rng.integers(12))]} {int(rng.integers(2015, 2027))}"
    return f"Tél : {phone} — courriel : {email} — consultation du {date}."


def notes(n, seed, sentences=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        text, _spans = datagen.generate_example(rng, max_sentences=sentences)
        out.append(header(rng) + "\n" + text)
    return out


def long_doc(rng, words):
    parts = []
    while len(" ".join(parts).split()) < words:
        parts.append(datagen.generate_example(rng, max_sentences=3)[0])
    return " ".join(parts)


# the cases of tests/test_deid.py, both registers
DEID_CASES = [
    "contact jane.doe+x@hospital.org for records",
    "call +1 555 123 4567 today", "call (06) 12 34 56 78 today",
    "call 555-123-4567 today", "dose of 12 34 mg",
    "admitted on 2024-01-31 with fever", "admitted on 31/01/2024 with fever",
    "admitted on March 5, 2024 with fever", "admitted on 5 mar 2024 with fever",
    "admitted on 14:30 with fever", "Seen by Dr. Marie Dupont at the clinic",
    "He moved from Portland last winter.", "Transfer from Mount Auburn pending bed.",
    "Her pharmacist in Quincy will supervise dosing.",
    "Patient joined from Fall River and verified identity.",
    "Residence: New Bedford.", "She was discharged to her home in Worcester yesterday.",
    "The patient is a practicing Buddhist and requests a diet.",
    "As an observant Muslim patient he fasts.",
    "Family identifies as Jehovah's Witnesses; blood declined.",
    "She is an active member of the local Methodist congregation.",
    "He lives in comfortable surroundings now.",
    "She is a practicing physician at the clinic.",
    "Patient was transferred from another facility overnight.",
    "Patient John reachable at j@x.com",
    "Dr. Alice Smith saw the patient on 2024-03-05, phone 555-123-4567, email a@b.org",
    "Vu le 3 juin 2026 pour un suivi.", "Imaging report dated March 5, 2024.",
    "Seen on 3 juin 2026.", "Seen on March 5, 2024.", "Le 3 juin 2026.",
    "Retour mardi prochain.", "AVC d'origine ischémique, patient d'origine marocaine.",
    "pt J. Castellano reports fatigue; Pt. Denies chest pain.",
]


def _tuples(results):
    return [(r.entity_type, r.start, r.end, r.score) for r in results]


class TestRecognizers:
    @pytest.mark.parametrize("language", ["fr", "en"])
    def test_pattern_results_identical(self, language):
        texts = DEID_CASES + notes(200, seed=11)
        for t in texts:
            assert _tuples(engine._pattern_results(t, language)) == _tuples(
                jengine._pattern_results(t, language)
            ), t

    def test_resolve_overlaps_and_anonymize_identical(self):
        rng = np.random.default_rng(5)
        ents = NERConfig().entities
        for text in DEID_CASES + notes(200, seed=12):
            found = engine._pattern_results(text)
            # add seeded model-like spans over word boundaries, ties included
            for _ in range(int(rng.integers(0, 6))):
                a = int(rng.integers(0, max(1, len(text) - 1)))
                b = min(len(text), a + int(rng.integers(1, 20)))
                score = float(rng.choice([0.5, 0.8, 0.9, 1.02, 1.1]))
                found.append(engine.RecognizerResult(str(rng.choice(ents)), a, b, score))
            jfound = [jengine.RecognizerResult(*t) for t in _tuples(found)]
            assert _tuples(engine._resolve_overlaps(found)) == _tuples(
                jengine._resolve_overlaps(jfound))
            assert engine.anonymize_text(text, found) == jengine.anonymize_text(text, jfound)

    def test_pattern_only_engines_identical(self):
        jcfg, cfg = _cfgs()
        texts = DEID_CASES + notes(50, seed=13)
        want = jengine.DeidEngine(jcfg, use_ner_model=False).deidentify_batch(texts)
        got = engine.DeidEngine(cfg, use_ner_model=False, device="cpu").deidentify_batch(texts)
        assert got == want

    def test_constants_identical(self):
        assert engine.DEFAULT_NER_THRESHOLD == jengine.DEFAULT_NER_THRESHOLD
        assert engine._NER_DENY_WORDS == jengine._NER_DENY_WORDS
        assert engine._NRP_ETIOLOGY_FR == jengine._NRP_ETIOLOGY_FR


class TestDatagenAndTokenizer:
    def test_generate_example_identical(self):
        for lex in ("TRAIN_LEXICONS", "EVAL_LEXICONS"):
            r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
            for _ in range(200):
                assert datagen.generate_example(r1, getattr(datagen, lex)) == (
                    jdatagen.generate_example(r2, getattr(jdatagen, lex)))
        assert datagen.DATA_VERSION == jdatagen.DATA_VERSION

    def test_word_bio_labels_and_bio_decoding_identical(self):
        jcfg, cfg = _cfgs()
        assert label_ids(cfg) == j_label_ids(jcfg)
        rng = np.random.default_rng(4)
        for _ in range(100):
            text, spans = datagen.generate_example(rng)
            words, wspans, labels = datagen.word_bio_labels(text, spans, cfg)
            assert (words, wspans, labels) == jdatagen.word_bio_labels(text, spans, jcfg)
            scores = list(rng.random(len(labels)))
            noisy = [int(x) for x in rng.integers(0, cfg.num_labels + 1, len(labels))]
            for labs in (labels, noisy):
                assert bio_to_spans(labs, wspans, cfg, scores) == j_bio_to_spans(
                    labs, wspans, jcfg, scores)

    def test_shape_hash_ids_bit_equal(self):
        tok, jtok = ShapeHashTokenizer(30522), JShapeHashTokenizer(30522)
        words = ["Boston", "boston", "BOSTON", "B", "x", "McDonald", "O'Neil",
                 "Delacroix-Webb", "3mg", "2024", "é", "Élodie", "ÉCHO", "naïve",
                 "d'origine", "555-123-4567", "µg", "ß", "İstanbul", "ǅ"]
        for text in notes(50, seed=14):
            words += text.split()
        for w in words:
            assert tok.word_to_ids(w) == jtok.word_to_ids(w), w
        for text in notes(20, seed=15):
            assert tok.encode(text, max_len=64) == jtok.encode(text, max_len=64)
        assert datagen.ner_tokenizer(NERConfig()).word_to_ids("Lyon") == (
            jdatagen.ner_tokenizer(JNERConfig()).word_to_ids("Lyon"))


class TestTagger:
    def test_ner_forward_matches_reference(self, tagger):
        jparams, nparams = tagger
        jcfg, cfg = _cfgs()
        rng = np.random.default_rng(0)
        ids = rng.integers(0, cfg.vocab_size, (5, 128)).astype(np.int32)
        lengths = np.array([128, 1, 77, 30, 64], np.int32)
        want = np.asarray(j_ner_forward(jparams, jcfg, ids, lengths))
        params = ner_params_to_torch(nparams, cfg, "cpu")
        got = ner_forward(params, cfg, torch.from_numpy(ids).long(),
                          torch.from_numpy(lengths)).numpy()
        assert got.shape == (5, 128, cfg.num_labels) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    def test_converter_rejects_other_trees(self, tagger):
        _, nparams = tagger
        _, cfg = _cfgs()
        bad = dict(nparams)
        bad.pop("head_b")
        with pytest.raises(ValueError, match="missing.*head_b"):
            ner_params_to_torch(bad, cfg, "cpu")
        with pytest.raises(ValueError, match="wrong shape"):
            ner_params_to_torch(nparams, dataclasses.replace(cfg, hidden_dim=32), "cpu")

    @pytest.mark.parametrize("case", ["several_windows", "over_32_windows"])
    def test_ner_spans_match_reference(self, tagger, case):
        """Threshold 0 keeps every model span.  Long documents split into
        several windows; the second case packs more than 32 windows into
        one batch (no bucket)."""
        jparams, nparams = tagger
        jcfg, cfg = _cfgs()
        rng = np.random.default_rng(21)
        if case == "several_windows":
            texts = [long_doc(rng, 250), "Court : Dr Lindqvist.", long_doc(rng, 400)]
        else:
            texts = [long_doc(rng, 220) for _ in range(11)]
        jeng = jengine.DeidEngine(jcfg, params=jparams, ner_threshold=0.0)
        peng = engine.DeidEngine(cfg, params=nparams, ner_threshold=0.0, device="cpu")
        segments, ids, lengths, token_idx = peng.windows(texts)
        n_win = len(segments)
        assert (n_win > 32) == (case == "over_32_windows") and n_win > len(texts)
        assert ids.shape[0] == (n_win if n_win > 32 else ids.shape[0])
        want = jeng._ner_results(texts)
        got = peng._ner_results(texts)
        assert peng.forwards == 1
        # the tie rule: words of near-equal top-2 reference logits
        logits = np.asarray(jeng._forward(jeng.params, ids=ids, lengths=lengths))
        top2 = np.sort(logits, axis=-1)[..., -2:]
        tied = [set() for _ in texts]
        for si, (di, seg) in enumerate(segments):
            for wi, (_w, s, e) in enumerate(seg):
                ti = token_idx[si][wi]
                if top2[si, ti, 1] - top2[si, ti, 0] < TIE:
                    tied[di].add((s, e))
        for di in range(len(texts)):
            w = {t[:3]: t[3] for t in _tuples(want[di])}
            g = {t[:3]: t[3] for t in _tuples(got[di])}
            for ent, s, e in set(w) ^ set(g):
                assert any(s <= a and b <= e for a, b in tied[di]), (di, ent, s, e)
            # scores of the common spans agree to the logits' tolerance
            for key in set(w) & set(g):
                assert abs(w[key] - g[key]) < 1e-4
        assert sum(len(x) for x in got) > 20  # threshold 0: many spans

    def test_masked_texts_match_reference(self, tagger):
        jparams, nparams = tagger
        jcfg, cfg = _cfgs()
        texts = notes(40, seed=31, sentences=6)
        want = jengine.DeidEngine(jcfg, params=jparams, ner_threshold=0.0).deidentify_batch(texts)
        got = engine.DeidEngine(cfg, params=nparams, ner_threshold=0.0,
                                device="cpu").deidentify_batch(texts)
        assert got == want

    def test_device_fault_in_forward_propagates(self, tagger):
        _, nparams = tagger
        _, cfg = _cfgs()
        eng = engine.DeidEngine(cfg, params=nparams, device="cpu")

        def broken(*_a, **_k):
            raise KernelError("flash_attention prefill kernel launch failed: CUDA error 719")

        eng.ner_logits = broken
        with pytest.raises(KernelError):
            eng.deidentify_batch(["Patient Amara Okafor from Lyon."])


class TestNERCache:
    def test_reference_npz_loads_and_masks_the_same(self, tagger, tmp_path):
        """An npz written by the reference's save_ner_params (its random
        tagger, saved under the steps the config asks for, so no training
        runs on either side) loads through DeidEngine.trained."""
        jparams, _ = tagger
        jcfg, cfg = _cfgs()
        path = str(tmp_path / "ner.npz")
        j_save_ner_params(path, jparams, jcfg, train_seq=64, train_steps=jcfg.train_steps)
        texts = notes(30, seed=41, sentences=5)
        jeng = jengine.DeidEngine.trained(jcfg, params_path=path, ner_threshold=0.0)
        peng = engine.DeidEngine.trained(cfg, params_path=path, ner_threshold=0.0,
                                         device="cpu")
        assert peng._window == jeng._window == 64
        assert isinstance(peng.tokenizer, ShapeHashTokenizer)
        assert peng.deidentify_batch(texts) == jeng.deidentify_batch(texts)
        # and the port writes the same cache back
        again = str(tmp_path / "again.npz")
        save_ner_params(again, load_ner_params(path, cfg), cfg, train_seq=64)
        with np.load(path) as a, np.load(again) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])

    def test_missing_or_mismatched_cache_raises(self, tagger, tmp_path):
        """(The name predates training in the port; kept for its testcase
        id.)  As in the reference, a missing, short or mismatched cache
        retrains — 2 steps on this config, never the 1500 default — and
        writes the npz; with no path the tagger trains and nothing is
        cached."""
        jparams, _ = tagger
        jcfg, cfg = _cfgs()
        before = set(os.listdir(tmp_path))
        eng = engine.DeidEngine.trained(cfg, steps=2, device="cpu")
        assert eng.params is not None and set(os.listdir(tmp_path)) == before
        absent = str(tmp_path / "absent.npz")
        engine.DeidEngine.trained(cfg, params_path=absent, steps=2, device="cpu")
        assert load_ner_params(absent, cfg, steps=2) is not None
        path = str(tmp_path / "short.npz")
        # trained (by its fingerprint) for 1 step: not the 2 asked for
        j_save_ner_params(path, jparams, jcfg, train_steps=1)
        eng = engine.DeidEngine.trained(cfg, params_path=path, steps=2, device="cpu")
        assert load_ner_params(path, cfg, steps=1) is None
        retrained = load_ner_params(path, cfg, steps=2)
        assert not np.array_equal(retrained["head_w"], np.asarray(jparams["head_w"]))
        np.testing.assert_array_equal(eng.params["head_w"].numpy(), retrained["head_w"])
        other = dataclasses.replace(cfg, num_layers=1)
        path = str(tmp_path / "other.npz")
        j_save_ner_params(path, jparams, jcfg, train_steps=2)
        eng = engine.DeidEngine.trained(other, params_path=path, steps=2, device="cpu")
        assert "l1_q_w" not in eng.params
        assert load_ner_params(path, other, steps=2) is not None
