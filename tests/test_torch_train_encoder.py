"""Port parity, contrastive encoder training: docqa_tpu_torch's pair
generator, InfoNCE loss and train step against docqa_tpu's (CPU, float32,
an encoder of 2 layers x hidden 64, 4 heads, sequences of 32).

Both packages start from the same tree (``host_init_encoder_params`` is
the reference's ``host_init`` draw bit for bit, carried with
``weights.to_torch``).  Pairs, topics and token batches must be equal.
Tolerances: losses within 2e-6 after each of five steps (float32, other
summation orders); params as ``adam_close`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.text.tokenizer import default_tokenizer as j_default_tokenizer
from docqa_tpu.training import encoder as jenc
from docqa_tpu_torch.config import EncoderConfig
from docqa_tpu_torch.text.tokenizer import default_tokenizer
from docqa_tpu_torch.training import encoder
from docqa_tpu_torch.weights import host_init_encoder_params

torch.set_num_threads(1)

ENC = dict(vocab_size=2048, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
           max_seq_len=64, embed_dim=64, dtype="float32")
CFG = EncoderConfig(**ENC)
SEQ = 32
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


def test_pairs_topics_and_batches_equal_the_reference():
    assert encoder._TOPIC_WORDS == jenc._TOPIC_WORDS
    assert encoder._make_topics(5, seed=3) == jenc._make_topics(5, seed=3)
    for n in (3, 16, 70):  # 70 wraps the 64-topic pool
        want = jenc.synthetic_pairs(np.random.default_rng(n), n)
        assert encoder.synthetic_pairs(np.random.default_rng(n), n) == want
        got = encoder.encode_pair_batch(default_tokenizer(CFG.vocab_size), want, SEQ)
        ref = jenc.encode_pair_batch(j_default_tokenizer(CFG.vocab_size), want, SEQ)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_five_steps_equal_the_reference():
    """make_encoder_train_step under the default chain (lr 2e-4, wd
    0.01): five losses (the first is info_nce_loss at init) and the params
    after each step."""
    jcfg = JEncoderConfig(**ENC)
    host = host_init_encoder_params(CFG, 1)
    jstate, jopt = jenc.init_encoder_train_state(
        jax.random.PRNGKey(0), jcfg, params={k: jnp.asarray(v) for k, v in host.items()})
    jstep = jenc.make_encoder_train_step(jcfg, jopt)
    state, opt = encoder.init_encoder_train_state(CFG, params=host, device="cpu")
    step = encoder.make_encoder_train_step(CFG, opt)
    tok = default_tokenizer(CFG.vocab_size)
    rng = np.random.default_rng(5)
    for i in range(5):
        batch = encoder.encode_pair_batch(tok, encoder.synthetic_pairs(rng, 16), SEQ)
        jstate, jloss = jstep(jstate, *(jnp.asarray(a) for a in batch))
        state, loss = step(state, *batch)
        assert abs(float(jloss) - float(loss)) <= TOL, i
        if i == 0:  # random embeddings: about uniform over 16 candidates
            assert 0.5 * np.log(16) < float(loss) < 2.5 * np.log(16)
        for k, v in state["params"].items():
            adam_close(v.detach().numpy(), np.asarray(jstate["params"][k]), 2e-4, i + 1,
                       f"{k} after step {i + 1}")
    assert state["step"] == 5


def test_train_encoder_refuses_zero_steps_and_copies_its_params():
    with pytest.raises(ValueError):
        encoder.train_encoder(CFG, steps=0, device="cpu")
    host = host_init_encoder_params(CFG, 2)
    before = {k: v.copy() for k, v in host.items()}
    trained = encoder.train_encoder(CFG, steps=2, batch_size=4, seq=16, params=host,
                                    device="cpu")
    for k in host:
        np.testing.assert_array_equal(host[k], before[k])
    assert not trained["tok_emb"].requires_grad
    assert float((trained["l0_q_w"] - torch.from_numpy(host["l0_q_w"])).abs().max()) > 0
