"""Port parity, cost attribution (``docqa_tpu_torch/obs/costs.py``) and the
analytic cost models (``obs/observatory.py``).

* The ledger: the same scripted sequence of opens, adds, late adds,
  retirements and sheds (with a pressure probe) gives the reference's
  snapshot, key for key and value for value.
* The cost models: the analytic linear-layer FLOPs of a small decoder's
  ragged prefill and verify step and of an encoder batch equal what
  ``torch.utils.flop_counter.FlopCounterMode`` counts for the
  ``mm``/``addmm``/``bmm`` calls of the port's plain CPU forward, with the
  attention replaced by a stub that computes nothing (attention counts by
  the bound column's ``4·d·hq·pairs`` convention, not by what the plain
  version computes).
* The batched /ask: one traced /ask through a 1-replica pool on each side
  (float32, 2 layers) gives the same answer, the same span names, parents
  and counts and the same events; the port's per-class device ms equal its
  spine's series for the same stages within 1e-6 relative; the cost
  record carries the reference's fields.
* Batch deferral on an SLO burn, through the pool's probe."""

import collections

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from docqa_tpu import obs as jobs
from docqa_tpu.engines.pool import EnginePool as JEnginePool
from docqa_tpu.obs.costs import RequestCostLedger as JRequestCostLedger
from docqa_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import DecoderConfig, EncoderConfig, QoSConfig
from docqa_tpu_torch.engines import paged
from docqa_tpu_torch.engines.serve import DeferredByPolicy
from docqa_tpu_torch.engines.spine import DispatchSpine, set_spine
from docqa_tpu_torch.models import encoder as enc_model
from docqa_tpu_torch.models.decoder import init_decoder_params
from docqa_tpu_torch.obs.costs import RequestCostLedger
from docqa_tpu_torch.obs.observatory import (
    decoder_linear_flops,
    encoder_linear_flops,
)
from docqa_tpu_torch.runtime.metrics import MetricsRegistry
from docqa_tpu_torch import weights
import test_torch_degraded as ask_setup

torch.set_num_threads(1)

WAIT = 120


# ---- the ledger ---------------------------------------------------------------


def _ledger_script(ledger):
    """One scripted workload; returns the snapshot minus wall times."""
    pressure = {
        "by_class": {
            "batch": {"kv_blocks": 12, "lanes": 2, "queued": 1},
            "interactive": {"kv_blocks": 3, "lanes": 1, "queued": 4},
        },
        "free_blocks": 0,
    }
    ledger.set_pressure_probe(lambda: pressure)
    a = ledger.open("interactive", session="s1")
    a.add("prefill_device_ms_cold", 4.0)
    a.add("decode_device_ms", 10.0)
    a.add("decode_tokens", 8)
    a.add("kv_block_seconds", 1.5)
    b = ledger.open("batch", session="s2")
    b.add("prefill_device_ms_warm", 2.0)
    b.add("prefill_tokens_avoided", 128)
    b.account_dispatch("retrieve", 0.001, 0.003)
    b.account_dispatch("generate", 0.0, 0.002)
    c = ledger.open("mystery")  # folds into "other"
    c.add("queue_wait_ms", 7.0)
    assert ledger.retire(a, "ok") and not ledger.retire(a, "error")
    ledger.retire(b, "shed_queue")
    a.add("kv_block_seconds", 0.5)  # late add after retirement
    shed = ledger.record_shed("queue_full", cls="interactive", stage="serve_submit")
    ledger.record_shed("block_pool_exhausted", cls="batch")
    for i in range(70):  # bounded session table
        r = ledger.open("background", session=f"bg{i}")
        r.add("decode_device_ms", float(i))
        ledger.retire(r)
    snap = ledger.snapshot(spine_device_s=0.05, pool_block_seconds=4.0)
    sheds = [{k: v for k, v in s.items() if k != "t_unix"} for s in ledger.sheds()]
    return snap, sheds, shed["majority_block_class"], c.summary(), a.summary()


def test_ledger_snapshot_equals_the_reference():
    got = _ledger_script(RequestCostLedger(registry=MetricsRegistry()))
    want = _ledger_script(JRequestCostLedger(registry=JMetricsRegistry()))
    assert got == want
    assert got[2] == "batch"


def test_disabled_ledger_and_trace_fallback_retirement():
    ledger = RequestCostLedger(registry=MetricsRegistry())
    ledger.set_enabled(False)
    assert ledger.open("interactive") is None
    # a traced request whose typed path never retired: the trace's
    # completion retires it (the recorder's fallback)
    ctx = obs.new_trace("ask")
    rec = obs.cost_open(ctx, "interactive")
    assert obs.cost_open(ctx, "batch") is rec  # reused, never doubled
    obs.finish(ctx, status="error")
    assert rec.retired and rec.outcome == "error"


# ---- the cost models against FlopCounterMode --------------------------------

DEC = DecoderConfig(vocab_size=96, hidden_dim=32, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=8, mlp_dim=48, max_seq_len=256,
                    dtype="float32")
ENC = EncoderConfig(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=2,
                    mlp_dim=64, max_seq_len=64, embed_dim=24, dtype="float32")
LINEAR_OPS = {"mm", "addmm", "bmm"}


def _linear_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    counts = fc.get_flop_counts()["Global"]
    return sum(v for op, v in counts.items()
               if str(op).split(".")[1] in LINEAR_OPS)


def _no_attention(q, *_a, **_k):
    return torch.zeros_like(q)


def test_prefill_linear_flops_equal_flopcounter(monkeypatch):
    monkeypatch.setattr(paged, "ragged_prefill_attention", _no_attention)
    params = init_decoder_params(DEC, 0, "cpu")
    S, bs, T = 3, 16, 128
    pools = paged.init_paged_pools(DEC, 16, bs, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, DEC.vocab_size, T))
    seg = torch.full((T,), -1, dtype=torch.long)
    seg[:40], seg[40:90] = 0, 1
    pos = torch.cat([torch.arange(40), torch.arange(50), torch.zeros(38, dtype=torch.long)])
    dest = torch.full((T,), 16 * bs, dtype=torch.long)
    last = torch.tensor([39, 89, 0])
    got = _linear_flops(lambda: paged.ragged_prefill_forward(
        params, DEC, pools, ids, seg, pos, dest, last, rope_len=256))
    assert got == decoder_linear_flops(DEC, T, S)


def test_verify_step_linear_flops_equal_flopcounter(monkeypatch):
    monkeypatch.setattr(paged, "paged_decode_attention", _no_attention)
    params = init_decoder_params(DEC, 0, "cpu")
    S, K, bs, nb = 4, 4, 16, 8
    pools = paged.init_paged_pools(DEC, 32, bs, dtype=torch.float32, device="cpu")
    tables = torch.arange(S * nb, dtype=torch.int32).reshape(S, nb)
    tok = torch.randint(0, DEC.vocab_size, (S, K))
    lengths = torch.tensor([5, 17, 40, 0], dtype=torch.int32)
    got = _linear_flops(lambda: paged.paged_decode_forward(
        params, DEC, pools, tables, tok, lengths, block_size=bs, rope_len=256))
    assert got == decoder_linear_flops(DEC, S * K, S * K)


def test_encoder_batch_linear_flops_equal_flopcounter(monkeypatch):
    monkeypatch.setattr(enc_model, "attention", _no_attention)
    params = weights.to_torch(weights.host_init_encoder_params(ENC, 0), "cpu")
    B, L = 8, 64
    ids = torch.randint(0, ENC.vocab_size, (B, L))
    lengths = torch.tensor([64, 10, 33, 1, 0, 0, 5, 64], dtype=torch.int32)
    got = _linear_flops(lambda: enc_model.encode_batch(params, ENC, ids, lengths))
    assert got == encoder_linear_flops(ENC, B, L)


# ---- the batched /ask ----------------------------------------------------------


def _tree(trace):
    spans = trace.snapshot_spans()
    by = {s.span_id: s for s in spans}
    shape = collections.Counter(
        (s.name, by[s.parent_id].name if s.parent_id else None) for s in spans
    )
    events = collections.Counter(
        (e["name"], s.name) for s in spans for e in s.events
    )
    return shape, events


def _traced_ask(o, qa):
    ctx = o.new_trace("ask")
    o.cost_open(ctx, "interactive")
    with ctx.activate():
        out = qa.ask(ask_setup.QUESTION)
    o.finish(ctx)
    return out, ctx.trace


def _parts():
    """``test_torch_degraded``'s engines: the same notes, store rows and
    seeded weights on both sides (float32, 2 layers)."""
    texts = [t for _, t in ask_setup.NOTES]
    meta = [{"source": s, "text_content": t} for s, t in ask_setup.NOTES]
    jenc = ask_setup.JEncoderEngine(ask_setup.JEncoderConfig(**ask_setup.ENC), seed=1)
    jstore = ask_setup.JVectorStore(ask_setup.JStoreConfig(**ask_setup.STORE))
    jstore.add(jenc.encode_texts(texts), meta)
    jgen = ask_setup.JGenerateEngine(
        ask_setup.JDecoderConfig(**ask_setup.DEC),
        ask_setup.JGenerateConfig(**ask_setup.GEN), seed=ask_setup.SEED)
    enc = ask_setup.EncoderEngine(ask_setup.EncoderConfig(**ask_setup.ENC),
                                  seed=1, device="cpu")
    store = ask_setup.VectorStore(ask_setup.StoreConfig(**ask_setup.STORE),
                                  device="cpu")
    store.add(enc.encode_texts(texts), meta)
    gen = ask_setup.GenerateEngine(
        ask_setup.DecoderConfig(**ask_setup.DEC),
        ask_setup.GenerateConfig(**ask_setup.GEN), seed=ask_setup.SEED,
        device="cpu")
    return jenc, jstore, jgen, enc, store, gen


@pytest.fixture(scope="module")
def batched_ask():
    parts = _parts()
    jenc, jstore, jgen, enc, store, gen = parts
    spine = DispatchSpine(n_lanes=2)
    prev = set_spine(spine)
    obs.DEFAULT_COST_LEDGER.reset()
    # the process's observatory may hold uncosted calls of batchers that
    # earlier test files ran in this worker
    obs.DEFAULT_OBSERVATORY.reset()
    pool = ask_setup._pool(gen, replicas=1)
    jpool = JEnginePool(jgen, replicas=1, n_slots=2, chunk=4, cache_len=512,
                        canary_interval_s=600.0, health_interval_s=0.05)
    try:
        qa, jqa = ask_setup._services(parts, pool, jbatcher=jpool)
        pool.annotate_costs()
        jpool.annotate_costs()
        want, jtrace = _traced_ask(jobs, jqa)
        got, trace = _traced_ask(obs, qa)
        classes = obs.DEFAULT_COST_LEDGER.class_totals()
        counters = spine.telemetry_counters()
        stages = obs.DEFAULT_OBSERVATORY.stats()["stages"]
    finally:
        pool.stop()
        jpool.stop()
        set_spine(prev)
        spine.close()
    return want, jtrace, got, trace, classes, counters, stages


def test_batched_ask_answer_and_trace_shape_equal_the_reference(batched_ask):
    want, jtrace, got, trace, *_ = batched_ask
    assert got == want
    # every span name, parent link and count, and every event, is the
    # reference's: no exception is listed, none is needed
    assert _tree(trace) == _tree(jtrace)
    assert trace.status == jtrace.status == "ok"
    names = {s.name for s in trace.snapshot_spans()}
    assert {"qa_retrieve", "fused_query", "dispatch:retrieve", "serve_queue_wait",
            "serve_prefill", "serve_decode_chunk", "serve_result_wait"} <= names


def test_cost_record_carries_the_reference_fields(batched_ask):
    _want, jtrace, _got, trace, *_ = batched_ask
    assert set(trace.cost_summary) == set(jtrace.cost_summary)
    assert trace.cost_summary["class"] == "interactive"
    assert trace.cost_summary["outcome"] == "ok"
    assert trace.cost_summary["session"] == jtrace.cost_summary["session"]


@pytest.mark.parametrize("stage, fields", [
    ("serve_prefill_fetch", ("prefill_device_ms_cold", "prefill_device_ms_warm")),
    ("serve_decode_chunk", ("decode_device_ms",)),
    ("retrieve", ("retrieve_device_ms",)),
])
def test_per_class_device_ms_reconcile_with_the_spine(batched_ask, stage, fields):
    *_rest, classes, counters, _stages = batched_ask
    spine_ms = counters[f"dispatch_device_ms_{stage}"]
    attributed = sum(row.get(f, 0.0) for row in classes.values() for f in fields)
    assert spine_ms > 0
    assert attributed == pytest.approx(spine_ms, rel=1e-6)


def test_costed_stages_have_no_uncosted_calls(batched_ask):
    stages = batched_ask[-1]
    for stage in ("serve_prefill_fetch", "serve_decode_chunk"):
        assert stages[stage]["uncosted_calls"] == 0
        assert stages[stage]["flops"] > 0
        # the CPU has no peak: device time, never a utilisation
        assert stages[stage]["mfu"] is None
        assert "mfu_raw_invalid" not in stages[stage]


def test_pool_defers_batch_while_an_slo_burns():
    gen = ask_setup.GenerateEngine(
        ask_setup.DecoderConfig(**ask_setup.DEC),
        ask_setup.GenerateConfig(**ask_setup.GEN), seed=ask_setup.SEED,
        device="cpu")
    pool = ask_setup._pool(gen, replicas=1, qos=QoSConfig())
    firing = ["ask_p95_latency"]
    obs.DEFAULT_COST_LEDGER.reset()
    try:
        pool.set_slo_probe(lambda: list(firing))
        assert pool.qos_status()["defer_active"] is True
        with pytest.raises(DeferredByPolicy):
            pool.submit_ids([3, 5, 7], max_new_tokens=2, req_class="batch")
        # interactive traffic is never deferred
        assert pool.submit_ids([3, 5, 7], max_new_tokens=2,
                               req_class="interactive").result(timeout=WAIT)
        firing.clear()
        assert pool.submit_ids([3, 5, 7], max_new_tokens=2,
                               req_class="batch").result(timeout=WAIT)
    finally:
        pool.stop()
    outcomes = {c: row["outcomes"] for c, row in
                obs.DEFAULT_COST_LEDGER.snapshot()["classes"].items()}
    assert outcomes["batch"] == {"shed_deferred": 1, "ok": 1}
    assert outcomes["interactive"] == {"ok": 1}
