"""Port parity, resilience primitives and metrics: docqa_tpu_torch's
breaker, fault plan, deadline and metrics registry against docqa_tpu's on
the same call sequences.

Everything here is deterministic host logic, so every comparison is exact:
breaker state sequences and registry gauges, fault-plan fire logs,
``from_env`` rules, deadline arithmetic (both read ``time.monotonic``; the
one tolerance, 0.05 s, covers the instants between the two reads) and
histogram percentiles (nearest rank over the same samples).
"""

import random

import pytest

from docqa_tpu.resilience import BreakerBoard as JBreakerBoard
from docqa_tpu.resilience import CircuitBreaker as JCircuitBreaker
from docqa_tpu.resilience import Deadline as JDeadline
from docqa_tpu.resilience import DeadlineExceeded as JDeadlineExceeded
from docqa_tpu.resilience import FaultPlan as JFaultPlan
from docqa_tpu.resilience import FaultRule as JFaultRule
from docqa_tpu.resilience import InjectedFault as JInjectedFault
from docqa_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from docqa_tpu_torch.resilience import (
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    FaultPlan,
    FaultRule,
    InjectedFault,
    faults,
)
from docqa_tpu_torch.runtime.metrics import MetricsRegistry, span

OPS = ("allow", "success", "failure", "release", "tick")


def _drive(breaker_cls, registry, ops, clock):
    """Run one op sequence on a breaker; the observed sequence of (op
    result, state, state gauge)."""
    br = breaker_cls("dep", failure_threshold=3, reset_timeout_s=5.0,
                     half_open_max=2, registry=registry, clock=lambda: clock[0])
    seen = []
    for op in ops:
        out = None
        if op == "allow":
            out = br.allow()
        elif op == "success":
            br.record_success()
        elif op == "failure":
            br.record_failure()
        elif op == "release":
            br.release_probe()
        else:
            clock[0] += 2.0
        seen.append((out, br.state,
                     registry.snapshot()["gauges"]["breaker_dep_state"]))
    counters = registry.snapshot()["counters"]
    return seen, {k: v for k, v in counters.items() if k.startswith("breaker_")}


@pytest.mark.parametrize("seed", range(6))
def test_breaker_state_sequences_match_reference(seed):
    rng = random.Random(seed)
    ops = [rng.choice(OPS) for _ in range(200)]
    got = _drive(CircuitBreaker, MetricsRegistry(), ops, [0.0])
    want = _drive(JCircuitBreaker, JMetricsRegistry(), ops, [0.0])
    assert got == want
    assert {s for _, s, _ in got[0]} >= {"closed", "open"}


def test_breaker_call_and_board_match_reference():
    def run(board_cls, exc_open):
        t = [0.0]
        board = board_cls(failure_threshold=2, reset_timeout_s=1.0, clock=lambda: t[0])
        br = board.get("decoder")
        assert board.get("decoder") is br
        out = []
        for i in range(6):
            try:
                out.append(br.call(lambda i=i: i if i >= 4 else 1 / 0))
            except ZeroDivisionError:
                out.append("err")
            except exc_open:
                out.append("open")
            t[0] += 0.6
        other = type(br)("checkpoint.load", registry=JMetricsRegistry()
                         if board_cls is JBreakerBoard else MetricsRegistry())
        assert board.adopt(other) is other and board.adopt(other) is other
        return out, board.states()

    from docqa_tpu.resilience import BreakerOpen as JBreakerOpen

    assert run(BreakerBoard, BreakerOpen) == run(JBreakerBoard, JBreakerOpen)


def _fires(plan_cls, exc, rules, seed, sites, n):
    plan = plan_cls(rules, seed=seed)
    slept = []
    raised = []
    for i in range(n):
        site = sites[i % len(sites)]
        try:
            plan.perturb(site, sleep=slept.append)
        except exc as e:
            raised.append((e.site, e.step))
    return plan.log, raised, slept


@pytest.mark.parametrize("seed", range(4))
def test_seeded_fault_plans_fire_at_the_same_steps(seed):
    def rules(rule_cls):
        return [
            rule_cls("serve.worker_loop", p=0.3),
            rule_cls("serve.decode_chunk", p=0.5, delay_s=0.25, raise_error=False),
            rule_cls("decoder", at_steps=(1, 4, 9), times=2),
            rule_cls("decoder", p=0.1),
        ]

    sites = ("serve.worker_loop", "serve.decode_chunk", "decoder")
    got = _fires(FaultPlan, InjectedFault, rules(FaultRule), seed, sites, 300)
    want = _fires(JFaultPlan, JInjectedFault, rules(JFaultRule), seed, sites, 300)
    assert got == want
    assert got[0] and got[1] and got[2]


@pytest.mark.parametrize("spec", [
    "decoder:p=1",
    "serve.worker_loop:steps=3:times=1;serve.decode_chunk:delay=0.2:p=0.5:noerror",
    "broker.publish:p=0.2;deid:delay=0.5:p=0.3:noerror;decoder:steps=0,2:times=3",
    "",
])
def test_from_env_parses_like_reference(spec):
    env = {"DOCQA_FAULTS": spec, "DOCQA_FAULTS_SEED": "42"}
    got, want = FaultPlan.from_env(env), JFaultPlan.from_env(env)
    if want is None:
        assert got is None
        return
    assert got.seed == want.seed == 42
    assert [r.__dict__ for r in got.rules] == [r.__dict__ for r in want.rules]
    with pytest.raises(ValueError, match="unknown DOCQA_FAULTS key"):
        FaultPlan.from_env({"DOCQA_FAULTS": "decoder:bogus=1"})


def test_single_active_plan_and_the_hook():
    with FaultPlan([FaultRule("x", p=1.0)]) as plan:
        assert faults.active_plan() is plan
        with pytest.raises(RuntimeError, match="already active"):
            faults.install(FaultPlan([]))
        with pytest.raises(InjectedFault):
            faults.perturb("x")
    assert faults.active_plan() is None
    faults.perturb("x")  # no active plan: a no-op
    with pytest.raises(ValueError):
        FaultRule("x", p=1.5)


def test_deadline_matches_reference():
    for budget in (0.0, 0.3, 5.0, -1.0):
        got, want = Deadline.after(budget), JDeadline.after(budget)
        assert got.budget_s == want.budget_s == budget
        assert got.expired == want.expired
        assert abs(got.remaining() - want.remaining()) < 0.05
        for timeout in (None, 0.1, 100.0):
            assert abs(got.bound(timeout) - want.bound(timeout)) < 0.05
        if got.expired:
            with pytest.raises(DeadlineExceeded) as e:
                got.check("serve_queue")
            with pytest.raises(JDeadlineExceeded) as je:
                want.check("serve_queue")
            assert e.value.stage == je.value.stage == "serve_queue"
            assert isinstance(e.value, TimeoutError)
        else:
            got.check("retrieve")
    err, jerr = DeadlineExceeded("decode", 0.25), JDeadlineExceeded("decode", 0.25)
    assert str(err) == str(jerr)


def test_registry_agrees_with_reference_on_the_same_observations():
    rng = random.Random(3)
    got, want = MetricsRegistry(), JMetricsRegistry()
    values = [rng.lognormvariate(3.0, 1.0) for _ in range(500)]
    for reg in (got, want):
        for i, v in enumerate(values):
            reg.counter("qa_degraded").inc()
            reg.counter(f"qos_preempted_{('batch', 'background')[i % 2]}").inc(2)
            reg.gauge("breaker_decoder_state").set(i % 3)
            reg.histogram("qa_e2e_ms").observe(v)
    g, w = got.snapshot(), want.snapshot()
    assert g["counters"] == w["counters"]
    assert g["gauges"] == w["gauges"]
    gh, wh = g["histograms"]["qa_e2e_ms"], w["histograms"]["qa_e2e_ms"]
    assert gh["count"] == wh["count"] == 500
    for key in ("mean", "p50", "p95", "p99"):
        assert gh[key] == pytest.approx(wh[key], rel=1e-12)
    for q in (0, 10, 50, 90, 99, 100):
        assert got.histogram("qa_e2e_ms").percentile(q) == pytest.approx(
            want.histogram("qa_e2e_ms").percentile(q), rel=1e-12)


def test_span_records_a_millisecond_histogram():
    reg = MetricsRegistry()
    with span("qa_retrieve", reg):
        pass
    h = reg.snapshot()["histograms"]["qa_retrieve_ms"]
    assert h["count"] == 1 and 0.0 <= h["p50"] < 1000.0
    empty = MetricsRegistry().histogram("none")
    assert empty.summary()["count"] == 0
