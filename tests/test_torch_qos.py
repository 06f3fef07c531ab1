"""Port parity, QoS policy and KV preemption: docqa_tpu_torch.engines.qos
against docqa_tpu.engines.qos, and the port's batcher and pool against the
reference's preemption cases (tests/test_qos.py) — CPU, float32, 2 layers.

Policy functions must agree exactly on seeded random inputs.  A preempted
request resumes token-preserving: its final greedy stream equals the port's
and docqa_tpu's solo engines' (exact equality: argmax of float32 logits
that agree to ~1e-6).  Every pool is stopped and every block comes back.
"""

import time

import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.config import QoSConfig as JQoSConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.qos import CLASS_RANK as J_CLASS_RANK
from docqa_tpu.engines.qos import DEFER_SLOS as J_DEFER_SLOS
from docqa_tpu.engines.qos import QoSPolicy as JQoSPolicy
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig, QoSConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.qos import CLASS_RANK, DEFER_SLOS, QoSPolicy
from docqa_tpu_torch.engines.serve import ContinuousBatcher
from docqa_tpu_torch.resilience import FaultPlan, FaultRule
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

torch.set_num_threads(1)

DEC = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=256,
           dtype="float32")
# speculative_k=0 keeps the block math of the preemption cases exact
GEN = dict(temperature=0.0, prefill_buckets=(16, 32, 64), eos_id=2,
           speculative_k=0)
SEED = 7
WAIT = 240
CLASSES = ["interactive", "batch", "other", "background", "unknown", None]


@pytest.fixture(scope="module")
def engine():
    return GenerateEngine(DecoderConfig(**DEC), GenerateConfig(**GEN),
                          seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def ref_engine():
    return JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN), seed=SEED)


# ---- the policy against the reference ---------------------------------------


def test_tables_match_reference():
    assert CLASS_RANK == J_CLASS_RANK
    assert DEFER_SLOS == J_DEFER_SLOS


@pytest.mark.parametrize("seed", range(4))
def test_rank_and_victim_order_match_reference(seed):
    rng = np.random.default_rng(seed)
    for cls in CLASSES:
        assert QoSPolicy.rank(cls) == JQoSPolicy.rank(cls)
    for _ in range(50):
        n = int(rng.integers(0, 12))
        slots = rng.permutation(32)[:n]
        holders = [
            (int(s), CLASSES[int(rng.integers(0, 5))], int(rng.integers(0, 9)))
            for s in slots
        ]
        for pressure in CLASSES[:5]:
            assert QoSPolicy.order_victims(holders, pressure) == \
                JQoSPolicy.order_victims(holders, pressure)


@pytest.mark.parametrize("seed", range(2))
def test_should_defer_matches_reference(seed):
    rng = np.random.default_rng(seed)
    names = list(DEFER_SLOS) + ["ask_degraded_rate", "retrieve_recall", "x"]
    for _ in range(100):
        firing = [names[int(i)] for i in rng.integers(0, len(names), int(rng.integers(0, 4)))]
        cls = CLASSES[int(rng.integers(0, 5))]
        assert QoSPolicy().should_defer(cls, firing) == \
            JQoSPolicy().should_defer(cls, firing)


def test_config_coercion_and_status_match_reference():
    for kw in ({}, {"preemption": "on", "weight_batch": 3.0},
               {"preemption": "advisory", "preempt_min_resume_s": 2.0,
                "aging_floor_s": 3.0}):
        got = QoSPolicy.coerce(QoSConfig(**kw))
        want = JQoSPolicy.coerce(JQoSConfig(**kw))
        assert got.status() == want.status()
    with pytest.raises(ValueError):
        QoSPolicy(preemption="sometimes")


# ---- KV preemption in the batcher -------------------------------------------


def _make(engine, preemption, **kw):
    """The reference's tight pool: 8 blocks of 16 (cache_len 128).  A
    40-token background prompt holds 4 blocks at admission and a 64-token
    interactive arrival needs 5: they cannot coexist."""
    kw = {"n_slots": 2, "chunk": 4, "cache_len": 128, "kv_block_size": 16,
          "kv_pool_tokens": 128, "prefix_cache": False, **kw}
    return ContinuousBatcher(
        engine, qos=QoSConfig(preemption=preemption, aging_floor_s=0.0), **kw
    )


def _long_prompt(engine, n_tokens, max_new):
    """A prompt whose greedy continuation runs its whole budget (no EOS)."""
    for base in range(3, 40):
        p = [(base + i * 7) % 120 + 4 for i in range(n_tokens)]
        out = engine.generate_ids([p], max_new_tokens=max_new)[0]
        if len(out) == max_new:
            return p, out
    pytest.skip("no EOS-free prompt for this seed")


def _until(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


# a slow decode, so the victim has delivered tokens before the pressure
SLOW = [FaultRule("serve.decode_chunk", p=1.0, delay_s=0.03, raise_error=False)]


def test_preemption_evicts_and_resumes_token_preserving(engine, ref_engine):
    bg_prompt, bg_solo = _long_prompt(engine, 40, 30)
    ia_prompt = [(5 + i * 3) % 120 + 4 for i in range(64)]
    ia_solo = engine.generate_ids([ia_prompt], max_new_tokens=8)[0]
    assert ref_engine.generate_ids([bg_prompt], max_new_tokens=30)[0] == bg_solo
    assert ref_engine.generate_ids([ia_prompt], max_new_tokens=8)[0] == ia_solo
    c0 = DEFAULT_REGISTRY.counter("qos_preempted").value
    c0_bg = DEFAULT_REGISTRY.counter("qos_preempted_background").value
    b = _make(engine, "on")
    try:
        with FaultPlan(SLOW):
            h_bg = b.submit_ids(bg_prompt, max_new_tokens=30, req_class="background")
            assert _until(lambda: len(h_bg._req.tokens) >= 4)
            assert not h_bg._req.done.is_set()
            h_ia = b.submit_ids(ia_prompt, max_new_tokens=8, req_class="interactive")
            assert h_ia.result(timeout=WAIT) == ia_solo
            assert h_bg.result(timeout=WAIT) == bg_solo
        assert b.stats["preempted"] >= 1
        assert _until(lambda: b.n_active == 0)
        assert b.kv_block_occupancy()["blocks_used"] == 0
    finally:
        b.stop()
    assert DEFAULT_REGISTRY.counter("qos_preempted").value > c0
    assert DEFAULT_REGISTRY.counter("qos_preempted_background").value > c0_bg
    assert b.block_seconds()["residual"] == pytest.approx(0.0, abs=1e-6)


def test_advisory_mode_counts_but_never_evicts(engine):
    bg_prompt, bg_solo = _long_prompt(engine, 40, 30)
    ia_prompt = [(11 + i * 5) % 120 + 4 for i in range(64)]
    ia_solo = engine.generate_ids([ia_prompt], max_new_tokens=8)[0]
    c_adv = DEFAULT_REGISTRY.counter("qos_preempt_advisory").value
    b = _make(engine, "advisory")
    try:
        with FaultPlan(SLOW):
            h_bg = b.submit_ids(bg_prompt, max_new_tokens=30, req_class="background")
            assert _until(lambda: len(h_bg._req.tokens) >= 4)
            cands = b.preemption_candidates("interactive")
            assert cands and cands[0]["class"] == "background"
            h_ia = b.submit_ids(ia_prompt, max_new_tokens=8, req_class="interactive")
            assert h_bg.result(timeout=WAIT) == bg_solo
            assert h_ia.result(timeout=WAIT) == ia_solo
        assert b.stats["preempted"] == 0
        assert _until(lambda: b.n_active == 0)
        assert b.kv_block_occupancy()["blocks_used"] == 0
        st = b.qos_status()
        assert st["preemption"] == "advisory" and st["defer_active"] is False
    finally:
        b.stop()
    assert DEFAULT_REGISTRY.counter("qos_preempt_advisory").value > c_adv


def test_grow_preempts_a_lower_ranked_lane_mid_decode(engine):
    """Both lanes admitted; the interactive lane's grow finds the pool dry
    and evicts the background lane, which resumes after it."""
    ia_prompt, ia_solo = _long_prompt(engine, 20, 40)
    bg_prompt, bg_solo = _long_prompt(engine, 40, 30)
    b = _make(engine, "on")
    try:
        with FaultPlan(SLOW):
            # one admission round: interactive takes slot 0, so it grows first
            with b._cv:
                h_ia = b.submit_ids(ia_prompt, max_new_tokens=40, req_class="interactive")
                h_bg = b.submit_ids(bg_prompt, max_new_tokens=30, req_class="background")
            assert h_ia.result(timeout=WAIT) == ia_solo
            assert h_bg.result(timeout=WAIT) == bg_solo
        assert b.stats["preempted"] >= 1
        assert _until(lambda: b.n_active == 0)
        assert b._alloc.blocks_in_use == 0
    finally:
        b.stop()


def test_pool_requeues_a_preemption_victim(engine):
    """In a pool, a mid-decode victim goes through the pool's requeue (it
    parks while its only replica has no room, and resumes there)."""
    ia_prompt, ia_solo = _long_prompt(engine, 20, 40)
    bg_prompt, bg_solo = _long_prompt(engine, 40, 30)
    gen = GenerateConfig(**{**GEN, "kv_pool_tokens": 128, "prefix_cache": False})
    eng = GenerateEngine(DecoderConfig(**DEC), gen, params=engine.params,
                         device="cpu")
    pool = EnginePool(eng, replicas=1, n_slots=2, chunk=4, cache_len=128,
                      canary_interval_s=600.0, health_interval_s=0.05,
                      qos=QoSConfig(preemption="on", aging_floor_s=0.0),
                      device="cpu")
    try:
        b = pool._replicas[0].batcher
        with FaultPlan(SLOW):
            with b._cv:
                h_ia = pool.submit_ids(ia_prompt, max_new_tokens=40, req_class="interactive")
                h_bg = pool.submit_ids(bg_prompt, max_new_tokens=30, req_class="background")
            assert h_ia.result(timeout=WAIT) == ia_solo
            assert h_bg.result(timeout=WAIT) == bg_solo
        # the victim went through the pool's requeue (one hop)
        assert pool.stats()["preempted"] >= 1 and h_bg._req.hops == 1
        assert _until(lambda: pool.n_active == 0)
        assert pool.kv_block_occupancy()["blocks_used"] == 0
        assert pool.preemption_candidates() == []
        assert pool.pressure_by_class()["free_blocks"] == 8
    finally:
        pool.stop()


def test_fifo_batcher_has_no_policy(engine):
    b = ContinuousBatcher(engine, n_slots=2, chunk=4, cache_len=64, qos=None)
    try:
        assert b.qos_status() == {"enabled": False}
        assert b.preemption_candidates() == []
        assert b.submit_ids([3, 5, 9], max_new_tokens=4, req_class="batch").result(timeout=WAIT)
        assert b.pressure_by_class()["blocks_total"] == b.n_blocks
    finally:
        b.stop()


def test_victim_with_too_little_budget_sheds_typed(engine):
    """A victim whose deadline cannot survive a re-prefill fails typed
    instead of requeueing (``preempt_min_resume_s``)."""
    from docqa_tpu_torch.engines.serve import BlockPoolExhausted, make_request
    from docqa_tpu_torch.resilience import Deadline

    b = _make(engine, "on")
    try:
        b._qos.preempt_min_resume_s = 1e6
        with b._cv:  # hold the worker: place a lane by hand
            req = make_request([5] * 20, 8, deadline=Deadline.after(60),
                               req_class="background")
            table = b._alloc.new_table()
            table.ensure(32)
            b._slot_req[0], b._slot_table[0] = req, table
            assert b._preempt_slot(0, "interactive") is None
            b._deact_pending.clear()
        with pytest.raises(BlockPoolExhausted, match="too little deadline"):
            raise req.error
        assert req.done.is_set() and b._alloc.blocks_in_use == 0
    finally:
        b.stop()

