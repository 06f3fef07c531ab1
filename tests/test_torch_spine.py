"""Port parity, the dispatch spine (``docqa_tpu_torch/engines/spine.py``)
against ``docqa_tpu/engines/spine.py``: FIFO order, the queue bound,
cancellation, close, background and prefill priority, re-entrancy, inline
mode, deadline sheds, the stats and telemetry surfaces (key for key with the
reference's), and the port's own rules: an item runs in its submitter's
grad/inference mode, a callable cost key is applied to the item's result,
and a kernel or CUDA fault raised by an item or by the accounting around it
reaches the submitter.  An issued item runs on its caller while a slot is
free.  On a card the slot is free once a closure has returned and the
device time is read where the result is taken: fake CUDA events
(``DispatchSpine._timing_events``) pin that on the CPU.

Every wait is on state (busy lanes, queue depth), never on the order in
which threads start."""

import threading
import time

import pytest
import torch

from docqa_tpu.engines.spine import DispatchSpine as JDispatchSpine
from docqa_tpu_torch import obs
from docqa_tpu_torch.engines import spine as spine_mod
from docqa_tpu_torch.engines.spine import (
    DispatchSpine,
    SpineCancelled,
    SpineClosed,
    SpineSaturated,
    get_spine,
    set_spine,
)
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

torch.set_num_threads(1)

WAIT = 10.0


def _wait_until(cond, timeout=WAIT):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("state not reached in time")
        time.sleep(0.005)


def _hold(s, stream="serve"):
    """Occupy one lane with an item gated on an event; returns (event,
    ticket) once a lane is running it."""
    ev = threading.Event()
    before = s.stats()["busy_lanes"]
    t = s.submit("hold", ev.wait, WAIT, stream=stream)
    _wait_until(lambda: s.stats()["busy_lanes"] > before)
    return ev, t


@pytest.fixture
def s():
    sp = DispatchSpine(n_lanes=1)
    yield sp
    sp.close()


def test_run_returns_result_and_orders_fifo(s):
    log = []
    ev, t1 = _hold(s)
    t2 = s.submit("b", log.append, 2)
    t3 = s.submit("c", log.append, 3)
    assert s.queue_depth == 2
    ev.set()
    for t in (t1, t2, t3):
        t.result(timeout=WAIT)
    assert log == [2, 3]


def test_bounded_queue_raises_typed():
    s = DispatchSpine(n_lanes=1, max_depth=1)
    try:
        ev, _ = _hold(s)
        s.submit("queued", lambda: None)
        with pytest.raises(SpineSaturated):
            s.submit("overflow", lambda: None)
        ev.set()
    finally:
        s.close()


def test_cancellation_before_start(s):
    ran = []
    ev, _ = _hold(s)
    t = s.submit("victim", ran.append, 1)
    assert t.cancel() is True
    ev.set()
    with pytest.raises(SpineCancelled):
        t.result(timeout=WAIT)
    t2 = s.submit("done", lambda: 7)
    assert t2.result(timeout=WAIT) == 7
    assert t2.cancel() is False
    assert ran == []
    st = s.stats()
    # a cancelled item is a terminal outcome: submitted == completed
    assert st["submitted"] == st["completed"] and st["errors"] == 1


def test_exception_propagates_and_spine_survives(s):
    with pytest.raises(ValueError, match="boom"):
        s.run("bad", lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert s.run("ok", lambda: 5) == 5
    assert s.stats()["errors"] == 1


def test_background_capped_below_lanes():
    s = DispatchSpine(n_lanes=2)
    try:
        running = []
        ev = threading.Event()

        def bg(tag):
            running.append(tag)
            ev.wait(WAIT)
            return tag

        t1 = s.submit("w1", bg, 1, stream="warmup")
        t2 = s.submit("w2", bg, 2, stream="warmup")
        # a lane counts the item busy before its closure runs: wait for both
        _wait_until(lambda: s.stats()["busy_background"] == 1 and running)
        # one background item at most; the other lane still serves
        assert s.run("serve_probe", lambda: "ok") == "ok"
        assert running == [1] and s.queue_depth == 1
        ev.set()
        assert t1.result(timeout=WAIT) == 1
        assert t2.result(timeout=WAIT) == 2
    finally:
        s.close()


@pytest.mark.parametrize("max_wait, order", [(60.0, ["serve", "prefill"]),
                                             (0.0, ["prefill", "serve"])])
def test_prefill_runs_after_serve_unless_aged(s, monkeypatch, max_wait, order):
    monkeypatch.setattr(spine_mod, "PREFILL_MAX_WAIT_S", max_wait)
    log = []
    ev, _ = _hold(s)
    tp = s.submit("p", log.append, "prefill", stream="prefill")
    ts = s.submit("d", log.append, "serve")
    ev.set()
    tp.result(timeout=WAIT)
    ts.result(timeout=WAIT)
    assert log == order


def test_issue_runs_on_the_caller_while_a_slot_is_free(s):
    here = threading.get_ident()
    assert s.run("free", threading.get_ident) == here
    # the one slot held: the item queues and a lane thread runs it
    ev, held = _hold(s)
    got = []
    waiter = threading.Thread(
        target=lambda: got.append(s.run("queued", threading.get_ident)))
    waiter.start()
    _wait_until(lambda: s.queue_depth == 1)
    ev.set()
    waiter.join(WAIT)
    held.result(timeout=WAIT)
    assert len(got) == 1 and got[0] not in (here, waiter.ident)


def test_issue_raises_the_closure_error(s):
    with pytest.raises(ValueError, match="boom"):
        s.issue("bad", lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert s.stats()["stages"]["bad"]["errors"] == 1


def test_lane_reentrancy_runs_inline(s):
    assert s.run("outer", lambda: s.run("inner", lambda: 42)) == 42


def test_inline_mode_executes_on_caller():
    s = DispatchSpine(n_lanes=1, inline=True)
    try:
        assert s.run("x", threading.get_ident) == threading.get_ident()
        assert s.stats()["stages"]["x"]["count"] == 1
    finally:
        s.close()


def test_deadline_sheds_before_execution(s):
    ran = []
    dl = Deadline(expires_at=time.monotonic() - 1.0)
    with pytest.raises(DeadlineExceeded):
        s.run("late", ran.append, 1, deadline=dl)
    assert ran == []


def test_close_fails_queued_typed_and_rejects_new():
    s = DispatchSpine(n_lanes=1)
    ev, _ = _hold(s)
    t = s.submit("doomed", lambda: 1)
    closer = threading.Thread(target=s.close)
    closer.start()
    # close() fails the queued item before it joins the lanes: wait on that
    # state, then free the lane
    _wait_until(lambda: t.done)
    ev.set()
    with pytest.raises(SpineClosed):
        t.result(timeout=WAIT)
    closer.join(WAIT)
    assert not closer.is_alive()
    with pytest.raises(SpineClosed):
        s.submit("after", lambda: 1)


def test_stats_and_telemetry_keys_equal_the_reference():
    s, js = DispatchSpine(n_lanes=2), JDispatchSpine(n_lanes=2)
    try:
        for sp in (s, js):
            sp.run("stage_a", lambda: 1)
            sp.run("stage_a", lambda: 2)
        st, jst = s.stats(), js.stats()
        assert set(st) == set(jst)
        assert set(st["stages"]["stage_a"]) == set(jst["stages"]["stage_a"])
        assert st["stages"]["stage_a"]["count"] == 2
        assert set(s.telemetry_gauges()) == set(js.telemetry_gauges())
        c, jc = s.telemetry_counters(), js.telemetry_counters()
        assert set(c) == set(jc) and c["dispatch_count_stage_a"] == 2.0
        s.reset_stats()
        assert s.stats()["stages"] == {}
    finally:
        s.close()
        js.close()


def test_global_spine_swap():
    mine = DispatchSpine(n_lanes=1)
    prev = set_spine(mine)
    try:
        assert get_spine() is mine
        assert spine_mod.spine_run("g", lambda: 3) == 3
    finally:
        set_spine(prev)
        mine.close()


@pytest.mark.parametrize("inference", [False, True])
def test_item_runs_in_the_submitters_grad_mode(s, inference):
    def probe():
        return torch.is_inference_mode_enabled(), torch.is_grad_enabled()

    with torch.inference_mode(inference):
        got = s.run("mode", probe)
        want = probe()
    assert got == want


def test_callable_cost_key_is_applied_to_the_result(s):
    DEFAULT_OBSERVATORY.annotate_model(
        "spine_test_costed",
        lambda key: {"flops": 10.0, "bytes": 4.0} if key == ("k", 3) else None,
    )
    DEFAULT_OBSERVATORY.reset()
    assert s.run("spine_test_costed", lambda: 3,
                 cost_key=lambda out: ("k", out)) == 3
    row = DEFAULT_OBSERVATORY.stats()["stages"]["spine_test_costed"]
    assert row["uncosted_calls"] == 0 and row["flops"] == 10.0


def test_device_time_within_wall_and_traced_dispatch_span(s):
    obs.DEFAULT_COST_LEDGER.reset()
    ctx = obs.new_trace("ask")
    rec = obs.cost_open(ctx, "interactive")
    t0 = time.perf_counter()
    with ctx.activate():
        ticket = s.submit("retrieve", time.sleep, 0.01)
        ticket.result(timeout=WAIT)
    wall = time.perf_counter() - t0
    obs.finish(ctx)
    assert 0.0 < ticket.device_s <= wall
    spans = [sp for sp in ctx.trace.snapshot_spans() if sp.name == "dispatch:retrieve"]
    assert len(spans) == 1 and spans[0].parent_id == ctx.trace.root.span_id
    assert rec.snapshot_fields()["retrieve_device_ms"] == pytest.approx(
        ticket.device_s * 1e3
    )


@pytest.mark.parametrize("fault", [
    KernelError("flash kernel failed to launch"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_device_fault_in_an_item_reaches_the_submitter(s, fault):
    def boom():
        raise fault

    with pytest.raises(type(fault)) as info:
        s.run("serve_decode_chunk", boom)
    assert info.value is fault
    assert s.run("after", lambda: 1) == 1  # the lane lives on


@pytest.mark.parametrize("where", ["device_seconds", "observatory"])
def test_device_fault_in_the_accounting_reaches_the_submitter(
    s, monkeypatch, where
):
    fault = KernelError("event read after a device fault")

    def raise_fault(*_a, **_k):
        raise fault

    if where == "device_seconds":
        monkeypatch.setattr(DispatchSpine, "_device_seconds",
                            staticmethod(raise_fault))
    else:
        monkeypatch.setattr(DEFAULT_OBSERVATORY, "record", raise_fault)
    with pytest.raises(KernelError) as info:
        s.run("serve_prefill_fetch", lambda: "tokens")
    assert info.value is fault


def test_other_accounting_errors_never_fail_an_item(s, monkeypatch):
    def broken(*_a, **_k):
        raise ValueError("unhashable cost key")

    monkeypatch.setattr(DEFAULT_OBSERVATORY, "record", broken)
    assert s.run("stage", lambda: "ok") == "ok"


class _FakeEvent:
    """A CUDA timing event stand-in: the end event's ``synchronize`` waits
    on ``gate`` (the device finishing) or raises ``fault``."""

    def __init__(self, gate=None, fault=None, ms=7.0):
        self.gate, self.fault, self.ms = gate, fault, ms

    def record(self):
        pass

    def synchronize(self):
        if self.fault is not None:
            raise self.fault
        if self.gate is not None:
            assert self.gate.wait(WAIT)

    def elapsed_time(self, end):
        return end.ms


def _fake_events(monkeypatch, **end):
    monkeypatch.setattr(DispatchSpine, "_timing_events",
                        staticmethod(lambda item: (_FakeEvent(), _FakeEvent(**end))))


def test_the_slot_is_free_before_the_device_finishes(s, monkeypatch):
    gate = threading.Event()
    _fake_events(monkeypatch, gate=gate)
    ticket = s.issue("chunk", lambda: "packed")
    # the one slot takes the next item while the chunk's "device" runs
    assert s.issue("probe", lambda: 1).done
    row = s.stats()["stages"]["chunk"]
    assert row["count"] == 1 and row["device_s"] == 0.0
    got = []
    fetcher = threading.Thread(target=lambda: got.append(ticket.result(WAIT)))
    fetcher.start()
    time.sleep(0.05)
    assert got == []  # the fetch waits for the end event
    gate.set()
    fetcher.join(WAIT)
    assert got == ["packed"] and ticket.device_s == pytest.approx(7e-3)
    assert s.stats()["stages"]["chunk"]["device_s"] == pytest.approx(7e-3)


def test_an_unfetched_item_adds_no_device_time(s, monkeypatch):
    _fake_events(monkeypatch)
    ticket = s.issue("dropped", lambda: "packed")
    st = s.stats()
    assert st["submitted"] == st["completed"] == 1
    assert st["stages"]["dropped"]["device_s"] == 0.0
    assert ticket.result(WAIT) == "packed"
    assert s.stats()["stages"]["dropped"]["device_s"] == pytest.approx(7e-3)


def test_device_fault_reading_the_end_event_reaches_the_fetch(s, monkeypatch):
    fault = KernelError("event read after a device fault")
    _fake_events(monkeypatch, fault=fault)
    ticket = s.issue("serve_decode_chunk", lambda: "packed")  # ran clean
    for _ in range(2):
        with pytest.raises(KernelError) as info:
            ticket.result(WAIT)
        assert info.value is fault
