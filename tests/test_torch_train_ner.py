"""Port parity, NER training and the deid evaluation: docqa_tpu_torch's
datagen batches, tagger loss, optimizer chain, trainer, cache, boot-time
training and evaluation set against docqa_tpu's (CPU, float32, a tagger
of 2 layers x hidden 32 x 2 heads, 64 positions, batches of 8 x 48).

The reference draws its tagger with ``jax.random``, so its initial tree is
carried across (``weights.ner_params_to_torch`` through ``trainable``), and
both packages get the same numpy-seeded batches.

Tolerances: losses within 2e-6 and params within 2e-6 after five steps
(float32 on both sides, other summation orders: measured 2.4e-7 and
3.6e-7); after 40 steps of ``train_ner`` the params within 2e-5 (Adam
divides each gradient by its own running RMS, so a rounding difference in
a near-zero gradient moves its parameter by up to a step's lr; measured
below 1e-5).  The schedule's lr at every count within 1e-6 relative
(float64 here, float32 in optax: measured 4.7e-8).  Metric dicts, ids
and spans exactly.
"""

import dataclasses
import logging
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from docqa_tpu.config import NERConfig as JNERConfig
from docqa_tpu.deid import datagen as jdatagen
from docqa_tpu.deid import evalset as jevalset
from docqa_tpu.deid.engine import DeidEngine as JDeidEngine
from docqa_tpu.models.ner import init_ner_params as j_init_ner_params
from docqa_tpu.models.ner import ner_forward as j_ner_forward
from docqa_tpu.training import ner as jner
from docqa_tpu_torch.config import NERConfig
from docqa_tpu_torch.deid import datagen, evalset
from docqa_tpu_torch.deid.engine import DeidEngine
from docqa_tpu_torch.models.ner import ner_forward
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.config import load_config
from docqa_tpu_torch.service.app import DocQARuntime
from docqa_tpu_torch.training import ner
from docqa_tpu_torch.training.optim import clip_by_global_norm_

torch.set_num_threads(1)

NER = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=2,
           mlp_dim=64, max_seq_len=64, dtype="float32")
BATCH, SEQ, LR = 8, 48, 2e-3
SHARED_STEPS = 40
STEP_TOL = 2e-6
TRAIN_TOL = 2e-5


def _cfgs():
    return JNERConfig(**NER), NERConfig(**NER)


def _host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _batches(n, seed=0):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    tok = datagen.ner_tokenizer(cfg)
    return [datagen.sample_batch(rng, tok, cfg, BATCH, SEQ) for _ in range(n)]


@pytest.fixture(scope="module")
def shared():
    """The reference's train_ner spelled out on its own step and optimizer
    (init from PRNGKey(0), default_ner_optimizer(LR, steps=SHARED_STEPS),
    make_ner_train_step, sample_batch from default_rng(0)), recording the
    first five losses and params; then the port's train_ner from the same
    initial tree.  One compiled reference step serves every test here."""
    jcfg, cfg = _cfgs()
    jparams = jax.jit(j_init_ner_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    init = _host(jparams)
    jopt = jner.default_ner_optimizer(LR, steps=SHARED_STEPS)
    jstate = jopt.init(jparams)
    jstep = jner.make_ner_train_step(jcfg, jopt)
    rng = np.random.default_rng(0)
    tok = jdatagen.ner_tokenizer(jcfg)
    early = []
    for i in range(SHARED_STEPS):
        batch = jdatagen.sample_batch(rng, tok, jcfg, BATCH, SEQ)
        jparams, jstate, loss = jstep(jparams, jstate, *batch)
        if i < 5:
            early.append((batch, float(loss), _host(jparams)))
    ptrained = ner.train_ner(cfg, steps=SHARED_STEPS, batch_size=BATCH, seq=SEQ,
                             lr=LR, seed=0, log_every=0, params=init, device="cpu")
    return {"init": init, "early": early, "reference": _host(jparams),
            "port": {k: v.numpy() for k, v in ptrained.items()}}


# ---- datagen ----------------------------------------------------------------

@pytest.mark.parametrize("seq", [16, 48, 128])
def test_sample_batch_equals_the_reference(seq):
    jcfg, cfg = _cfgs()
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        want = jdatagen.sample_batch(jrng, jdatagen.ner_tokenizer(jcfg), jcfg, 6, seq)
        got = datagen.sample_batch(rng, datagen.ner_tokenizer(cfg), cfg, 6, seq)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)


def test_encode_example_equals_the_reference():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    for _ in range(20):
        text, spans = datagen.generate_example(rng)
        want = jdatagen.encode_example(jdatagen.ner_tokenizer(jcfg), jcfg, text, spans, 40)
        got = datagen.encode_example(datagen.ner_tokenizer(cfg), cfg, text, spans, 40)
        assert want[1] == got[1]
        for i in (0, 2, 3):
            np.testing.assert_array_equal(want[i], got[i])


# ---- loss, optimizer chain and the train step ----------------------------------

def test_five_steps_equal_the_reference(shared):
    """Losses and params after each of the first five steps of
    make_ner_train_step under default_ner_optimizer (the first step's loss
    is ner_loss at init), and the lr of every update, the first (count 0:
    lr 0, the weights stay as they were) included."""
    _jcfg, cfg = _cfgs()
    opt = ner.default_ner_optimizer(LR, steps=SHARED_STEPS)
    params = ner.trainable(shared["init"], cfg, "cpu")
    state = opt.init(params)
    step = ner.make_ner_train_step(cfg, opt)
    # warmup min(100, 40 // 10) = 4
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 4, SHARED_STEPS, LR * 0.05)
    for i, (batch, jloss, jparams) in enumerate(shared["early"]):
        params, state, loss = step(params, state, *batch)
        assert abs(jloss - float(loss)) <= STEP_TOL
        used = state.adamw.param_groups[0]["lr"]
        np.testing.assert_allclose(used, float(schedule(i)), rtol=1e-6, atol=1e-12)
        if i == 0:
            assert used == 0.0
            for k, v in params.items():
                np.testing.assert_array_equal(v.detach().numpy(), shared["init"][k])
        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(), jparams[k],
                                       rtol=0, atol=STEP_TOL)
    assert state.count == 5
    for count in range(SHARED_STEPS + 10):
        np.testing.assert_allclose(opt.lr_at(count), float(schedule(count)),
                                   rtol=1e-6, atol=1e-12)


def test_clip_is_optax_clip_by_global_norm():
    rng = np.random.default_rng(4)
    for scale in (0.01, 1.0, 30.0):  # under, at and over the bound
        tree = {f"g{i}": (rng.standard_normal((5, 3)) * scale).astype(np.float32)
                for i in range(3)}
        if scale == 1.0:  # exactly at the bound: optax scales by 1 / 1
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in tree.values()))
            tree = {k: (g / norm).astype(np.float32) for k, g in tree.items()}
        want, _ = optax.clip_by_global_norm(1.0).update(
            {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
        got = [torch.from_numpy(v.copy()) for v in tree.values()]
        clip_by_global_norm_(got, 1.0)
        for g, k in zip(got, tree):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-9)


def test_train_ner_equals_the_reference(shared):
    for k, want in shared["reference"].items():
        np.testing.assert_allclose(shared["port"][k], want, rtol=0, atol=TRAIN_TOL)


def test_train_ner_refuses_zero_steps():
    _jcfg, cfg = _cfgs()
    with pytest.raises(ValueError, match="steps >= 1"):
        ner.train_ner(cfg, steps=0, device="cpu")


def test_train_ner_leaves_the_callers_tree_alone(shared):
    init = shared["init"]
    before = {k: v.copy() for k, v in init.items()}
    _jcfg, cfg = _cfgs()
    ner.train_ner(cfg, steps=2, batch_size=2, seq=16, params=init, device="cpu",
                  log_every=0)
    for k in before:
        np.testing.assert_array_equal(init[k], before[k])


def test_flash_wrapper_refuses_autograd():
    """The serving forward (use_flash=True) of a tagger whose params need
    grad raises on the CPU as it would on the card; no_grad and
    use_flash=False both run."""
    _jcfg, cfg = _cfgs()
    params = ner.trainable(ner.init_ner_params(cfg, 0), cfg, "cpu")
    ids, lengths, _labels, _mask = (torch.as_tensor(a) for a in _batches(1)[0])
    with pytest.raises(ValueError, match="use_flash=False"):
        ner_forward(params, cfg, ids.long(), lengths)
    with torch.no_grad():
        served = ner_forward(params, cfg, ids.long(), lengths)
    trained = ner_forward(params, cfg, ids.long(), lengths, use_flash=False)
    assert trained.requires_grad
    torch.testing.assert_close(served, trained.detach(), rtol=0, atol=0)


# ---- evaluation on one tagger -----------------------------------------------

def _engines(params, threshold):
    jcfg, cfg = _cfgs()
    jeng = JDeidEngine(jcfg, tokenizer=jdatagen.ner_tokenizer(jcfg),
                       params={k: jnp.asarray(v) for k, v in params.items()},
                       ner_threshold=threshold)
    peng = DeidEngine(cfg, tokenizer=datagen.ner_tokenizer(cfg), params=params,
                      ner_threshold=threshold, device="cpu")
    return jeng, peng


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_evaluate_ner_equals_the_reference(shared, threshold):
    jtrained = shared["reference"]
    jcfg, cfg = _cfgs()
    want = jner.evaluate_ner({k: jnp.asarray(v) for k, v in jtrained.items()}, jcfg,
                             n_examples=24, threshold=threshold)
    got = ner.evaluate_ner(jtrained, cfg, n_examples=24, threshold=threshold,
                           device="cpu")
    assert got == want
    assert want["f1"] > 0 or threshold > 0


def test_evaluate_deid_equals_the_reference(shared):
    jtrained = shared["reference"]
    jeng, peng = _engines(jtrained, 0.5)
    assert evalset.evaluate_deid(peng) == jevalset.evaluate_deid(jeng)
    sub = jevalset.TEST_EXAMPLES[:9]
    assert evalset.evaluate_deid(peng, sub) == jevalset.evaluate_deid(jeng, sub)


def test_evaluate_deid_split_equals_the_reference(shared):
    """Every metric of the three splits, bootstrap intervals included; the
    ``note`` differs by design (the port does not call any split held
    out, ADVICE.md's first item)."""
    jtrained = shared["reference"]
    jeng, peng = _engines(jtrained, 0.5)
    want = jevalset.evaluate_deid_split(jeng, n_boot=50)
    got = evalset.evaluate_deid_split(peng, n_boot=50)
    assert set(got) == set(want)
    for key in ("dev", "test", "heldout"):
        assert got[key] == want[key], key
    assert "held-out generalization" in got["note"]


def test_evalset_splits_and_scorer_equal_the_reference():
    def flat(examples):
        return [(t, [(g.entity_type, g.start, g.end) for g in spans])
                for t, spans in examples]

    for name in ("EXAMPLES", "DEV_EXAMPLES", "TEST_EXAMPLES", "HELDOUT_EXAMPLES"):
        assert flat(getattr(evalset, name)) == flat(getattr(jevalset, name)), name
    marked = "Seen [PERSON:Ann Lee] in [LOCATION:Lyon] on [DATE_TIME:3 mai]."
    assert flat([evalset._parse(marked)]) == flat([jevalset._parse(marked)])
    # a scripted prediction set: hits, a type confusion, a miss, an FP
    examples = evalset.EXAMPLES[:4]
    preds = []
    for i, (_t, gold) in enumerate(examples):
        row = [evalset.GoldSpan(g.entity_type if j % 2 else "PERSON", g.start, g.end)
               for j, g in enumerate(gold) if (i + j) % 3]
        row.append(evalset.GoldSpan("NRP", 0, 2))
        preds.append(row)
    jpreds = [[jevalset.GoldSpan(p.entity_type, p.start, p.end) for p in row]
              for row in preds]
    jexamples = jevalset.EXAMPLES[:4]
    assert evalset._score(examples, preds) == jevalset._score(jexamples, jpreds)
    assert (evalset._bootstrap_f1_ci(examples, preds, 30, 1)
            == jevalset._bootstrap_f1_ci(jexamples, jpreds, 30, 1))


# ---- the cache, load_or_train and the boot ------------------------------------

def test_port_npz_loads_in_the_reference(shared, tmp_path):
    """The port's train_ner + save_ner_params write an npz that the
    reference's load_or_train loads (no training: its fingerprint matches)
    and whose logits equal the port's."""
    ptrained = shared["port"]
    jcfg, cfg = _cfgs()
    path = str(tmp_path / "ner.npz")
    ner.save_ner_params(path, {k: torch.from_numpy(v) for k, v in ptrained.items()},
                        cfg, train_seq=SEQ, train_steps=SHARED_STEPS)
    jparams, seq = jner.load_or_train(jcfg, path, steps=SHARED_STEPS,
                                      train_in_subprocess=False)
    assert seq == SEQ
    ids, lengths, _l, _m = _batches(1, seed=11)[0]
    want = np.asarray(jax.jit(j_ner_forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths)))
    with torch.no_grad():
        got = ner_forward(ner.trainable(ptrained, cfg, "cpu"), cfg,
                          torch.as_tensor(ids).long(), torch.as_tensor(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_trained_classmethod_caches(tmp_path, monkeypatch):
    """The reference's test of the same name: a first call trains and
    writes the cache, the second loads it (training is made to raise)."""
    tiny = NERConfig(vocab_size=512, hidden_dim=16, num_layers=1, num_heads=2,
                     mlp_dim=32, max_seq_len=64, dtype="float32")
    path = str(tmp_path / "cache.npz")
    eng1 = DeidEngine.trained(tiny, params_path=path, steps=2, device="cpu")
    assert os.path.exists(path)

    def no_training(*a, **k):
        raise AssertionError("the second call trained")

    monkeypatch.setattr(ner, "train_ner", no_training)
    eng2 = DeidEngine.trained(tiny, params_path=path, steps=2, device="cpu")
    for k in eng1.params:
        torch.testing.assert_close(eng1.params[k], eng2.params[k], rtol=0, atol=0)


def test_child_process_trains_and_a_failed_child_falls_back(tmp_path, monkeypatch, caplog):
    """train_in_subprocess=True runs the child (it imports this package
    only, the device in its spec) and the parent loads its npz; a child
    that exits non-zero is logged with its stderr tail and the parent
    trains in-process."""
    tiny = NERConfig(vocab_size=256, hidden_dim=16, num_layers=1, num_heads=2,
                     mlp_dim=32, max_seq_len=32, dtype="float32")
    path = str(tmp_path / "child.npz")
    params, seq = ner.load_or_train(tiny, path, train_in_subprocess=True, steps=2,
                                    batch_size=2, seq=16, log_every=1, device="cpu")
    assert seq == 16 and os.path.exists(path)
    assert ner.load_ner_params(path, tiny, steps=2).keys() == params.keys()

    failed = subprocess.CompletedProcess([], 3, stdout="", stderr="boom: no card")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: failed)
    other = str(tmp_path / "fallback.npz")
    with caplog.at_level(logging.WARNING, logger="docqa.train.ner"):
        ner.load_or_train(tiny, other, train_in_subprocess=True, steps=2,
                          batch_size=2, seq=16, device="cpu")
    assert os.path.exists(other)
    assert "boom: no card" in caplog.text and "in-process" in caplog.text


def test_device_fault_in_training_passes_through(tmp_path, monkeypatch):
    tiny = NERConfig(vocab_size=256, hidden_dim=16, num_layers=1, num_heads=2,
                     mlp_dim=32, max_seq_len=32, dtype="float32")

    def fault(*a, **k):
        raise KernelError("flash_attention prefill kernel launch failed: CUDA error 700")

    monkeypatch.setattr(ner, "train_ner", fault)
    with pytest.raises(KernelError):
        ner.load_or_train(tiny, str(tmp_path / "a.npz"), steps=2, device="cpu")
    monkeypatch.setattr(subprocess, "run", fault)  # the child's launch
    with pytest.raises(KernelError):
        ner.load_or_train(tiny, str(tmp_path / "b.npz"), steps=2, device="cpu",
                          train_in_subprocess=True)
    assert not os.listdir(tmp_path)


def test_boot_trains_the_tagger_then_loads_it(tmp_path, monkeypatch):
    """A runtime under a config that asks for a trained tagger and has no
    cache trains it and caches it under data.work_dir; the next boot loads
    it without training."""
    overrides = {
        "encoder.hidden_dim": 64, "encoder.num_layers": 1, "encoder.num_heads": 4,
        "encoder.mlp_dim": 128, "encoder.embed_dim": 64,
        "store.dim": 64, "store.shard_capacity": 256,
        "ner.train_steps": 2, "ner.hidden_dim": 16, "ner.num_layers": 1,
        "ner.num_heads": 2, "ner.mlp_dim": 32,
        "decoder.hidden_dim": 64, "decoder.num_layers": 1, "decoder.num_heads": 4,
        "decoder.num_kv_heads": 2, "decoder.head_dim": 16, "decoder.mlp_dim": 128,
        "decoder.vocab_size": 512, "generate.max_new_tokens": 8,
        "flags.use_fake_llm": True, "flags.use_fake_encoder": True,
        "data.work_dir": str(tmp_path / "work"),
    }
    cfg = load_config(env={}, overrides=overrides)
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        trained = {k: v.clone() for k, v in rt.deid.params.items()}
    finally:
        rt.stop()
    cache = tmp_path / "work" / "ner.npz"
    assert cache.exists()

    def no_training(*a, **k):
        raise AssertionError("the second boot trained")

    monkeypatch.setattr(ner, "train_ner", no_training)
    rt = DocQARuntime(cfg, device="cpu").start()
    try:
        for k, v in trained.items():
            torch.testing.assert_close(rt.deid.params[k], v, rtol=0, atol=0)
    finally:
        rt.stop()
    # a config that changes the architecture retrains (the fingerprint)
    assert ner.load_ner_params(str(cache), dataclasses.replace(cfg.ner, num_layers=2),
                               steps=2) is None
