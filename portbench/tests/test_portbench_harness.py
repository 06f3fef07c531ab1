"""The harness's own CPU tests: the registry, the no-JAX check, the
end-to-end arithmetic, the closed loop's callers, the trace reduction and
the FLOP counts."""

from __future__ import annotations

import json
import os
import re
import sys
import time
import types

import pytest

from portbench import flops, run, trace
from portbench.drive import AskRecord, Driver
from portbench.record import Run, percentile
from portbench.registry import ROOT, find_cell, load_json, load_reader
from portbench.system import model_shape
from portbench.tests.tiny import write_root
from portbench import system
from portbench.traffic import Ask, schedule

CELLS = ("mistral7b-int8.ask_long", "mistral7b-bf16.ask_long")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_registry_finds_each_cells_files_by_name(name):
    cell = find_cell(name)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert cell.traffic["why"]
    assert set(cell.checks["limits"]) >= {"logit_gap", "prompt_mismatch", "retrieval_gap"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and set(cell.readers) == names | {m["name"] for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())


def test_benchmark_file_keeps_the_contracts_shapes():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    every = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    assert all(NAME.match(x["name"]) for x in every)
    assert len({x["name"] for x in every}) == len(every)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and os.path.exists(
            os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        for cell in m["workloads"]:
            owner = e2e[m["moves"]]
            assert "workloads" not in owner or cell in owner["workloads"]
    for c in bench["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_a_new_cell_is_added_by_adding_files(tmp_path):
    """A cell, its mix and its limits come as new files beside the
    repository's, and the registry finds them with nothing edited."""
    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in ("BENCHMARK.json", "portbench/registry.py", "portbench/run.py")}
    cell = write_root(str(tmp_path))
    found = find_cell(cell, root=str(tmp_path))
    assert found.config["hidden_size"] == 64 and found.traffic["clients"] == 3
    assert "ask_mean_s" in found.readers and "tpot_mean_ms" in found.readers
    for p, body in before.items():
        assert open(os.path.join(ROOT, p), "rb").read() == body


@pytest.mark.parametrize("names,caught", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]), (["optax"], ["optax"]), (["docqa_tpu.models.decoder"], ["docqa_tpu"]),
    (["docqa_tpu_torch", "docqa_tpu_torch.ops"], []), (["jaxtyping", "flaxen"], []),
])
def test_no_jax_check_compares_whole_top_level_names(monkeypatch, names, caught):
    for n in names:
        monkeypatch.setitem(sys.modules, n, types.ModuleType(n))
    assert run.blocked_modules() == caught


def _run(records, mix=None, t_open=100.0, seconds=10.0):
    cfg = load_json(os.path.join(ROOT, "portbench/configs/mistral7b-bf16.json"))
    mix = mix or {"request_deadline_s": 8.0}
    return Run(cfg, mix, model_shape(cfg), records, t_open, t_open + seconds, 1.0)


def test_percentile_is_taken_over_all_asks_failed_ones_at_the_budget():
    recs = []
    for i in range(100):
        r = AskRecord(Ask(i, "q"), t_due=100.0 + i * 0.1)
        r.t_first, r.t_end = r.t_due + 0.5 + i * 0.01, r.t_due + 2.0
        r.outcome = "answered"
        recs.append(r)
    for r in recs[:6]:  # six failed asks: at the 8 s budget, above every answer
        r.outcome, r.t_first = "degraded:deadline", float("nan")
    run_ = _run(recs, seconds=20.0)
    ttft = run_.latencies(first=True)
    assert len(ttft) == 100
    assert percentile(ttft, 95) == 8.0
    assert percentile([float(x) for x in range(1, 101)], 95) == 95.0


def test_answer_time_and_token_gap_are_taken_over_every_ask_of_the_window():
    recs = []
    for i in range(4):
        r = AskRecord(Ask(i, "q"), t_due=101.0 + i)
        r.t_first, r.t_end = r.t_due + 1.0, r.t_due + 1.0 + 0.01 * i * 63
        r.tokens, r.outcome = [7] * 64, "answered"
        recs.append(r)
    late = AskRecord(Ask(4, "q"), t_due=108.0)  # ends after the close: not judged
    late.t_first, late.t_end, late.tokens, late.outcome = 109.0, 112.0, [7] * 64, "answered"
    failed = AskRecord(Ask(5, "q"), t_due=105.0)  # shed after 0.5 s: at the budget
    failed.t_end, failed.outcome = 105.5, "shed"
    run_ = _run(recs + [late, failed], mix={"request_deadline_s": 120.0})
    ask = load_reader("ask_mean_s")(run_)
    assert ask == pytest.approx((sum(1.0 + 0.63 * i for i in range(4)) + 120.0) / 5)
    assert load_reader("tpot_mean_ms")(run_) == pytest.approx(1e3 * 0.01 * 1.5)


class _SlowQA:
    """A stand-in service whose submission lane takes ``delay`` seconds and
    answers at once (an answer served at submission)."""

    def __init__(self, delay):
        self.delay = delay
        self.asked = []

    def ask_submit(self, question, k=None, deadline=None):
        assert k is None  # /ask passes no k: the deployment's default_k
        self.asked.append(question)
        time.sleep(self.delay)
        return types.SimpleNamespace(sources=[], chunks=[], answer="x",
                                     degrade_reason=None, route="extractive")


def test_closed_loop_callers_ask_again_when_answered():
    qa = _SlowQA(0.02)
    driver = Driver(qa, 8.0)
    asks = [Ask(i, f"q{i}") for i in range(1000)]
    t_close = time.perf_counter() + 0.3
    recs = driver.run_closed(asks, 3, t_close)
    driver.close()
    # asks are taken in order, each once, and sent one at a time
    assert [r.ask.question for r in recs] == [f"q{i}" for i in range(len(recs))]
    assert sorted(qa.asked) == sorted(r.ask.question for r in recs)
    assert 8 <= len(recs) <= 0.3 / 0.02 + 3
    sent = sorted(r.t_sent for r in recs)
    assert all(b - a >= 0.02 - 1e-3 for a, b in zip(sent, sent[1:]))
    for r in recs:  # each timed from when its caller asked
        assert r.t_due <= r.t_sent <= r.t_end and r.outcome.startswith("degraded")
    assert max(r.t_due for r in recs) <= t_close


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_sends_the_same_sizes(name):
    cell = find_cell(name)
    mix = cell.traffic
    a, b = schedule(mix, 3, 20.0), schedule(mix, 2**31 + 9, 20.0)
    assert len(a) == len(b)
    assert {len(x.question.split()) for x in a + b} == {mix["question_tokens"]}
    assert [x.question for x in a] != [x.question for x in b]
    # one prompt fits the deployment's smallest packed prefill budget
    # (512 rows, starts aligned to 128), as /ask's prompts do
    assert -(-system.prompt_tokens(cell.config, mix) // 128) * 128 <= 512


def _chrome(tmp_path, events):
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_idle_share_and_breakdown_of_a_synthetic_trace(tmp_path):
    events = [
        _ev("user_annotation", trace.MARK, 1000.0, 1.0),
        _ev("user_annotation", trace.MARK, 2000.0, 1.0),
        _ev("user_annotation", "serve_decode_chunk", 1100.0, 500.0, **{"External id": 1}),
        _ev("cpu_op", "aten::mm", 1110.0, 20.0, **{"External id": 2}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1115.0, 5.0, correlation=10),
        _ev("kernel", "nvjet_gemm", 1200.0, 100.0, tid=7, correlation=10, **{"External id": 2}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1140.0, 5.0, correlation=11),
        _ev("kernel", "flash_decode_kernel<128,4>", 1300.0, 50.0, tid=7, correlation=11,
            **{"External id": 1}),
        _ev("cuda_runtime", "cuLaunchKernelEx", 1700.0, 5.0, tid=2, correlation=12),
        _ev("kernel", "qmatmul_ring_kernel<4,false>", 1800.0, 100.0, tid=7, correlation=12),
        _ev("gpu_memcpy", "Memcpy DtoH", 1850.0, 100.0, tid=7),
    ]
    s = trace.read(_chrome(tmp_path, events))
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [1200,1350] + [1800,1950] = 300 us of 1000
    assert s.busy_s() == pytest.approx(300e-6)
    idle = load_reader("device_idle_share.decode")
    assert idle(types.SimpleNamespace(trace=s)) == pytest.approx(70.0)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] in ("nvjet_gemm", "qmatmul_ring_kernel<4,false>")
    labels = dict(b["idle_gaps"])
    # gaps [1000,1200] and [1350,1800] have their middles in the chunk's
    # range, [1950,2000] in none
    assert labels["serve_decode_chunk"] == pytest.approx((200 + 450) * 1e-6)
    assert labels["(no stage open)"] == pytest.approx(50e-6)
    assert sum(labels.values()) == pytest.approx(700e-6)


def test_flop_counts_against_a_hand_count():
    m = flops.ModelShape(vocab=10, hidden=4, layers=2, heads=2, kv_heads=1, head_dim=2, mlp=6)
    # a token through one layer: q 4x4, k 4x2, v 4x2, o 4x4, gate/up 4x6, down 6x4
    per_layer = 2 * (16 + 8 + 8 + 16 + 24 + 24 + 24)
    assert flops.linear_flops(m, 3, 1) == 3 * 2 * per_layer + 2 * 4 * 10
    assert flops.causal_pairs(0, 3) == 6 and flops.causal_pairs(2, 4) == 7
    assert flops.causal_pairs(0, 4, window=2) == 1 + 2 + 2 + 2
    assert flops.attention_flops(m, 6) == 4 * 2 * 2 * 6 * 2
    assert flops.prompt_flops(m, 3) == flops.linear_flops(m, 3, 1) + 4 * 2 * 2 * 6 * 2
    assert flops.ask_flops(m, 3, 2) == flops.linear_flops(m, 4, 2) + flops.attention_flops(m, 10)
    assert flops.mfu_share(flops.PEAK_FLOPS / 2, 1.0) == pytest.approx(50.0)
