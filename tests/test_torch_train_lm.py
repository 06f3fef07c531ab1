"""Port parity, LM training and checkpoints: docqa_tpu_torch's lm_loss,
train step and TrainCheckpointer against docqa_tpu's training plane (CPU,
float32, a decoder of 2 layers x hidden 32, 4 q / 2 kv heads of 8).

Both packages start from the same tree: ``host_init_decoder_params`` is
the reference's ``host_init`` draw bit for bit, carried into the port with
``weights.to_torch``.  Batches are numpy-seeded.

Tolerances: losses within 2e-6 after each of five steps (float32 on
both sides, other summation orders); params as ``adam_close`` says.
Inside the port: remat on and off, and a forward without the cache write,
give bitwise-equal losses and grads on the CPU (the same operations in the
same order), and a resumed run reproduces the uninterrupted one bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.training import train as jtrain
from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.decoder import decoder_head, decoder_layer_stack
from docqa_tpu_torch.ops.attention import attention_reference
from docqa_tpu_torch.training import train
from docqa_tpu_torch.training.checkpoint import TrainCheckpointer
from docqa_tpu_torch.weights import host_init_decoder_params

torch.set_num_threads(1)

DEC = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32")
CFG = DecoderConfig(**DEC)
TOL = 2e-6


def adam_close(got, want, lr, steps, what):
    """All but 0.1 % of the elements within TOL, and every element within
    5 % of the distance ``steps`` updates of ``lr`` can move it: Adam
    divides each gradient by its running RMS plus eps (1e-8), so an element
    whose gradient is near eps takes a step whose size hangs on rounding in
    that gradient."""
    diff = np.abs(got - want)
    assert (diff <= TOL).mean() >= 0.999, (what, float(diff.max()))
    assert diff.max() <= 0.05 * lr * steps, (what, float(diff.max()))


def _batch(b=4, s=16, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 64, (b, s)).astype(np.int32)
    lengths = (rng.integers(s // 2, s + 1, (b,)) if ragged
               else np.full((b,), s)).astype(np.int32)
    return ids, lengths


def _state(seed=0, lr=1e-2):
    return train.init_train_state(CFG, optimizer=train.default_optimizer(lr),
                                  params=host_init_decoder_params(CFG, seed),
                                  device="cpu")


def _loss_and_grads(params, fn):
    loss = fn()
    loss.backward()
    grads = {k: v.grad.clone() for k, v in params.items()}
    for v in params.values():
        v.grad = None
    return loss.detach(), grads


def test_lm_loss_ignores_padding():
    state, _opt = _state()
    ids, lengths = _batch()
    ids2 = ids.copy()
    ids2[np.arange(ids.shape[1])[None, :] >= lengths[:, None]] = 63
    with torch.no_grad():
        base = train.lm_loss(state["params"], CFG, torch.as_tensor(ids),
                             torch.as_tensor(lengths))
        alt = train.lm_loss(state["params"], CFG, torch.as_tensor(ids2),
                            torch.as_tensor(lengths))
    assert float(base) == float(alt)


def test_five_steps_equal_the_reference():
    """make_train_step (remat on, as both default) under default_optimizer:
    the five losses (the first is lm_loss at init, padding ignored) and
    the params after each step; the lr is the constant one throughout."""
    jcfg = JDecoderConfig(**DEC)
    host = host_init_decoder_params(CFG, 3)
    jstate, jopt = jtrain.init_train_state(
        jax.random.PRNGKey(0), jcfg, jtrain.default_optimizer(1e-2),
        params={k: jnp.asarray(v) for k, v in host.items()})
    jstep = jtrain.make_train_step(jcfg, jopt)
    state, opt = train.init_train_state(CFG, optimizer=train.default_optimizer(1e-2),
                                        params=host, device="cpu")
    step = train.make_train_step(CFG, opt)
    for i in range(5):
        ids, lengths = _batch(seed=i)
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(lengths))
        state, loss = step(state, ids, lengths)
        assert abs(float(jloss) - float(loss)) <= TOL, i
        assert state["opt_state"].adamw.param_groups[0]["lr"] == 1e-2
        for k, v in state["params"].items():
            adam_close(v.detach().numpy(), np.asarray(jstate["params"][k]), 1e-2, i + 1,
                       f"{k} after step {i + 1}")
    assert state["step"] == int(jstate["step"]) == 5


def test_remat_and_the_cache_write_leave_loss_and_grads_unchanged():
    """Per-layer checkpointing recomputes the same operations, and the
    in-place K/V write into a cache that needs no grad passes the gradient
    to k and v unchanged: both equal a plain forward with no cache."""
    state, _opt = _state(seed=1)
    params = state["params"]
    ids, lengths = (torch.as_tensor(a) for a in _batch(seed=4))
    b, s = ids.shape

    def no_cache():
        pos = torch.arange(s)[None].expand(b, s)
        x = decoder_layer_stack(
            params, CFG, ids, pos, s,
            lambda i, q, k, v: attention_reference(
                q, k, v, causal=True, lengths=lengths,
                q_offset=torch.zeros(b, dtype=torch.int32)))
        logp = torch.log_softmax(decoder_head(params, CFG, x)[:, :-1], -1)
        nll = -torch.gather(logp, -1, ids[:, 1:].long()[..., None])[..., 0]
        mask = (torch.arange(s - 1)[None] + 1) < lengths[:, None]
        return (nll * mask).sum() / mask.sum()

    plain = _loss_and_grads(params, lambda: train.lm_loss(params, CFG, ids, lengths))
    remat = _loss_and_grads(
        params, lambda: train.lm_loss(params, CFG, ids, lengths, remat=True))
    bare = _loss_and_grads(params, no_cache)
    for other in (remat, bare):
        assert float(other[0]) == float(plain[0])
        for k in params:
            torch.testing.assert_close(other[1][k], plain[1][k], rtol=0, atol=0)
    assert all(float(g.abs().sum()) > 0 for g in plain[1].values())


# ---- checkpoints ----------------------------------------------------------------

def _run(state, step, seeds):
    losses = []
    for seed in seeds:
        state, loss = step(state, *_batch(seed=seed))
        losses.append(float(loss))
    return state, losses


def test_checkpoint_resume_reproduces_the_run_bitwise(tmp_path):
    state, opt = _state(seed=2)
    step = train.make_train_step(CFG, opt)
    state, _ = _run(state, step, [10, 11])
    ckpt = TrainCheckpointer(str(tmp_path / "ck"))
    assert ckpt.save(state) == 2 and ckpt.latest_step() == 2
    straight, want = _run(state, step, [12, 13, 14])

    template, opt2 = _state(seed=9)  # other weights: all of them overwritten
    restored = TrainCheckpointer(str(tmp_path / "ck")).restore(template)
    assert restored["step"] == 2 and restored["opt_state"].count == 2
    resumed, got = _run(restored, train.make_train_step(CFG, opt2), [12, 13, 14])
    assert got == want
    for k, v in straight["params"].items():
        torch.testing.assert_close(resumed["params"][k], v, rtol=0, atol=0)
    ckpt.close()


def test_restore_from_an_empty_directory_raises(tmp_path):
    template, _ = _state()
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore(template)


def test_max_to_keep_prunes_and_a_background_save_lands(tmp_path):
    state, opt = _state()
    step = train.make_train_step(CFG, opt)
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    for i in range(4):
        state, _ = step(state, *_batch(seed=i))
        ckpt.save(state, wait=(i < 3))
    assert ckpt.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    ckpt.close()


def test_restore_takes_the_templates_dtype(tmp_path):
    state, _ = _state()
    TrainCheckpointer(str(tmp_path / "ck")).save(state)
    template, _ = _state(seed=5)
    template["params"] = {k: v.detach().double() for k, v in template["params"].items()}
    template["opt_state"] = train.default_optimizer(1e-2).init(template["params"])
    TrainCheckpointer(str(tmp_path / "ck")).restore(template)
    for k, v in template["params"].items():
        assert v.dtype == torch.float64
        torch.testing.assert_close(v.float(), state["params"][k].detach(), rtol=0, atol=0)
