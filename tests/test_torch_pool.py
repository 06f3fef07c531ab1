"""Port parity, replica pool: docqa_tpu_torch.engines.pool against the
cases of tests/test_pool.py (CPU, float32, 2 layers).

The contract is the reference's zero-lost-requests invariant: whatever
happens to a replica (worker crash, wedge, drain, rebuild), every request
completes with the solo engines' greedy tokens or fails with a TYPED error
inside its deadline; nothing hangs.  Greedy streams are compared exactly
(argmax of float32 logits that agree to ~1e-6).  Every ``result()`` takes
a timeout and every pool is stopped in ``finally``; the timing margins are
generous because the suite runs six files at once.

Beyond the reference: a kernel or CUDA fault is not a replica failure.  The
pool fails every waiter with the original error, marks its replicas
``failed``, and rebuilds nothing.
"""

import threading
import time

import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.config import PoolConfig as JPoolConfig
from docqa_tpu.config import QoSConfig as JQoSConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.pool import EnginePool as JEnginePool
from docqa_tpu_torch.config import (
    DecoderConfig,
    GenerateConfig,
    PoolConfig,
    QoSConfig,
)
from docqa_tpu_torch.engines import paged
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool, FailoverExhausted
from docqa_tpu_torch.engines.serve import (
    ContinuousBatcher,
    QueueFull,
    RequestCancelled,
    WorkerDied,
)
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.resilience import (
    Deadline,
    DeadlineExceeded,
    FaultPlan,
    FaultRule,
)
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

torch.set_num_threads(1)

DEC = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=256,
           dtype="float32")
GEN = dict(temperature=0.0, prefill_buckets=(16, 32), eos_id=2)
SEED = 7
WAIT = 120  # seconds any single result may take


@pytest.fixture(scope="module")
def engine():
    return GenerateEngine(DecoderConfig(**DEC), GenerateConfig(**GEN),
                          seed=SEED, device="cpu")


def make_pool(engine, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk", 4)
    kw.setdefault("cache_len", 128)
    # no canary traffic unless a test asks for it
    kw.setdefault("canary_interval_s", 600.0)
    kw.setdefault("health_interval_s", 0.05)
    kw.setdefault("breaker_reset_s", 0.2)
    return EnginePool(engine, device="cpu", **kw)


def _prompts(n, base=3):
    return [[base + i, 5 + i % 7, 9, 4 + i % 3] for i in range(n)]


def _wait_all(handles, timeout=WAIT):
    """Wait for every handle on its own thread: ("ok", n tokens), ("typed",
    error) for the typed failures the contract allows, or
    ("HUNG_OR_UNTYPED", error)."""
    results = {}
    lock = threading.Lock()

    def wait_one(idx, h):
        try:
            out = ("ok", len(h.result(timeout=timeout)))
        except (WorkerDied, DeadlineExceeded, QueueFull) as e:
            out = ("typed", repr(e))
        except Exception as e:
            out = ("HUNG_OR_UNTYPED", repr(e))
        with lock:
            results[idx] = out

    threads = [threading.Thread(target=wait_one, args=(i, h))
               for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    return results


def _until(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


class TestPoolServing:
    def test_matches_both_solo_engines_across_replicas(self, engine):
        prompts = _prompts(6)
        solo = engine.generate_ids(prompts, max_new_tokens=8)
        ref = JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN),
                              seed=SEED).generate_ids(prompts, max_new_tokens=8)
        pool = make_pool(engine)
        try:
            handles = [pool.submit_ids(p, max_new_tokens=8) for p in prompts]
            got = [h.result(timeout=WAIT) for h in handles]
            st = pool.status()
        finally:
            pool.stop()
        assert solo == ref
        assert got == solo
        assert sum(r["routed"] for r in st["replicas"]) == 6

    def test_routes_to_all_replicas(self, engine):
        pool = make_pool(engine)
        try:
            handles = [pool.submit_ids(p, max_new_tokens=4) for p in _prompts(8)]
            for h in handles:
                h.result(timeout=WAIT)
            st = pool.status()
        finally:
            pool.stop()
        assert sum(r["routed"] for r in st["replicas"]) == 8
        assert all(r["routed"] > 0 for r in st["replicas"])

    def test_status_key_tree_matches_reference(self, engine):
        def tree(x):
            if isinstance(x, dict):
                return {k: tree(v) for k, v in x.items()}
            if isinstance(x, list):
                return [tree(v) for v in x]
            return type(x).__name__ if isinstance(x, bool) else None

        jeng = JGenerateEngine(JDecoderConfig(**DEC), JGenerateConfig(**GEN), seed=SEED)
        jpool = JEnginePool(jeng, JPoolConfig(replicas=2, n_slots=2),
                            cache_len=128, qos=JQoSConfig())
        pool = make_pool(engine, cfg=PoolConfig(replicas=2, n_slots=2), qos=QoSConfig())
        try:
            want, got = jpool.status(), pool.status()
        finally:
            jpool.stop()
            pool.stop()
        assert tree(got) == tree(want)
        assert got["qos"] == want["qos"]
        for g, w in zip(got["replicas"], want["replicas"]):
            assert (g["state"], g["breaker"], g["worker_alive"]) == (
                w["state"], w["breaker"], w["worker_alive"])

    def test_pool_handle_is_batcher_shaped(self, engine):
        pool = make_pool(engine, replicas=1)
        try:
            h = pool.submit_ids([3, 5, 9], max_new_tokens=4)
            assert hasattr(h, "text") and hasattr(h, "cancel")
            toks = list(h.iter_tokens(timeout=WAIT))
        finally:
            pool.stop()
        assert toks == engine.generate_ids([[3, 5, 9]], max_new_tokens=4)[0]


class TestPoolFailover:
    def test_replica_crash_zero_lost_requests(self, engine):
        pool = make_pool(engine)
        try:
            plan = FaultPlan([FaultRule("serve.worker_loop", at_steps=(2,))], seed=11)
            with plan:
                handles = [
                    pool.submit_ids(p, max_new_tokens=12, deadline=Deadline.after(90))
                    for p in _prompts(10)
                ]
                results = _wait_all(handles)
            assert len(plan.log) == 1
            # the dead replica comes back
            assert _until(lambda: pool.status()["replicas"][0]["generation"]
                          + pool.status()["replicas"][1]["generation"] >= 1)
        finally:
            st = pool.status()
            pool.stop()
        assert len(results) == 10, "waiter(s) hung"
        kinds = [k for k, _ in results.values()]
        assert "HUNG_OR_UNTYPED" not in kinds, results
        assert sum(r["deaths"] for r in st["replicas"]) >= 1
        # only requests admitted on the dying replica may fail
        assert kinds.count("ok") >= 6, results

    def test_wedge_detected_and_replica_rebuilt(self, engine):
        pool = make_pool(engine, heartbeat_max_age_s=1.0)
        try:
            plan = FaultPlan([FaultRule("serve.worker_loop", at_steps=(2,),
                                        delay_s=3.0, raise_error=False)], seed=5)
            with plan:
                handles = [
                    pool.submit_ids(p, max_new_tokens=10, deadline=Deadline.after(90))
                    for p in _prompts(8)
                ]
                results = _wait_all(handles)
            assert plan.log
            assert _until(lambda: sum(r["generation"] for r in pool.status()["replicas"]) >= 1)
        finally:
            st = pool.status()
            pool.stop()
        assert len(results) == 8, "waiter(s) hung"
        assert not any(k == "HUNG_OR_UNTYPED" for k, _ in results.values()), results
        assert sum(1 for k, _ in results.values() if k == "ok") >= 4
        assert sum(r["deaths"] for r in st["replicas"]) >= 1

    def test_failover_exhausted_is_typed_worker_died(self):
        assert issubclass(FailoverExhausted, WorkerDied)

    def test_wedge_inside_admission_window_fails_typed(self, engine):
        pool = make_pool(engine, replicas=1, heartbeat_max_age_s=0.5)
        release = threading.Event()
        try:
            b = pool._replicas[0].batcher

            def hung_admit(pairs):
                release.wait(30)  # popped, never slot-resident
                raise WorkerDied("test wedge released")

            b._admit_round = hung_admit
            handles = [
                pool.submit_ids(p, max_new_tokens=8, deadline=Deadline.after(60))
                for p in _prompts(3)
            ]
            assert _until(lambda: b.n_admitting > 0, 10)
            assert b.n_active == 0  # the window is invisible to the slots
            outcomes = []
            for h in handles:
                try:
                    outcomes.append(("ok", len(h.result(timeout=30))))
                except (WorkerDied, DeadlineExceeded) as e:
                    outcomes.append(("typed", repr(e)))
            assert len(outcomes) == 3
            assert any(k == "typed" for k, _ in outcomes), outcomes
            assert pool._replicas[0].deaths >= 1
        finally:
            release.set()
            pool.stop()


class TestHedgedDispatch:
    def test_hedge_duplicates_queued_request_first_token_wins(self, engine):
        prompt = [3, 5, 9, 4]
        solo = engine.generate_ids([prompt], max_new_tokens=6)[0]
        pool = make_pool(engine, n_slots=1, hedge=True, hedge_min_delay_s=0.1,
                         hedge_warmup=10_000)
        try:
            before = DEFAULT_REGISTRY.counter("pool_hedges").value
            slow = FaultPlan([FaultRule("serve.decode_chunk", p=1.0, delay_s=0.15,
                                        raise_error=False)])
            with slow:
                long1 = pool.submit_ids([4, 6, 8], max_new_tokens=60)
                long2 = pool.submit_ids([5, 7, 9], max_new_tokens=60)
                assert _until(lambda: pool.n_active == 2)
                h = pool.submit_ids(prompt, max_new_tokens=6,
                                    deadline=Deadline.after(120))
                got = h.result(timeout=WAIT)
                after = DEFAULT_REGISTRY.counter("pool_hedges").value
                long1.result(timeout=WAIT)
                long2.result(timeout=WAIT)
        finally:
            pool.stop()
        assert got == solo
        assert after > before


class TestDrainRestart:
    def test_drain_finishes_inflight_then_resume(self, engine):
        pool = make_pool(engine)
        try:
            handles = [pool.submit_ids(p, max_new_tokens=8) for p in _prompts(6)]
            out = pool.drain(0, timeout=WAIT)
            assert out["drained"] is True
            assert out["n_active"] == 0 and out["n_queued"] == 0
            for h in handles:
                assert h.result(timeout=WAIT)
            assert pool.status()["replicas"][0]["state"] == "draining"
            pool.resume(0)
            assert pool.status()["replicas"][0]["state"] == "healthy"
            assert pool.submit_ids([3, 5], max_new_tokens=2).result(timeout=WAIT)
        finally:
            pool.stop()

    def test_single_replica_pool_parks_during_drain(self, engine):
        pool = make_pool(engine, replicas=1)
        try:
            assert pool.drain(0, timeout=WAIT)["drained"]
            h = pool.submit_ids([3, 5, 9], max_new_tokens=4,
                                deadline=Deadline.after(120))
            assert pool.status()["pending"] == 1
            pool.resume(0)
            assert h.result(timeout=WAIT) == engine.generate_ids(
                [[3, 5, 9]], max_new_tokens=4)[0]
        finally:
            pool.stop()

    def test_rolling_restart_under_load_drops_nothing(self, engine):
        pool = make_pool(engine)
        handles = {}
        stop_feed = threading.Event()

        def feeder():
            for i, p in enumerate(_prompts(12)):
                if stop_feed.is_set():
                    return
                handles[i] = pool.submit_ids(p, max_new_tokens=6,
                                             deadline=Deadline.after(120))
                time.sleep(0.05)

        try:
            feed = threading.Thread(target=feeder)
            feed.start()
            time.sleep(0.2)  # restarts begin with requests in flight
            out = pool.rolling_restart(timeout_per_replica=WAIT)
            feed.join(timeout=60)
            results = _wait_all([handles[i] for i in sorted(handles)])
            st = pool.status()
        finally:
            stop_feed.set()
            pool.stop()
        assert out["ok"] is True
        assert len(handles) == 12 and len(results) == 12
        assert all(k == "ok" for k, _ in results.values()), results
        assert all(r["generation"] >= 1 for r in st["replicas"])
        # replaced batchers close their books
        assert pool.stats()["admissions"] >= 12


class TestCancellation:
    def test_cancel_before_admission_is_typed(self, engine):
        b = ContinuousBatcher(engine, n_slots=1, chunk=4, cache_len=128)
        try:
            busy = b.submit_ids([3, 5, 9], max_new_tokens=40)
            queued = b.submit_ids([4, 6], max_new_tokens=40)
            queued.cancel()
            with pytest.raises(RequestCancelled):
                queued.result(timeout=WAIT)
            assert busy.result(timeout=WAIT)
        finally:
            b.stop()

    def test_cancel_mid_decode_retires_lane(self, engine):
        b = ContinuousBatcher(engine, n_slots=2, chunk=4, cache_len=128)
        try:
            b.warmup()
            slow = FaultPlan([FaultRule("serve.decode_chunk", p=1.0, delay_s=0.05,
                                        raise_error=False)])
            with slow:
                h = b.submit_ids([3, 5, 9], max_new_tokens=60)
                assert _until(lambda: h.started)
                h.cancel()
                with pytest.raises(RequestCancelled):
                    h.result(timeout=60)
            assert b.submit_ids([4, 6], max_new_tokens=4).result(timeout=WAIT)
        finally:
            b.stop()
        assert b._alloc.blocks_in_use == 0


class TestLivenessSurface:
    def test_heartbeat_and_cold_flags(self, engine):
        b = ContinuousBatcher(engine, n_slots=2, chunk=4, cache_len=128)
        try:
            assert b.cold and b.worker_alive
            assert b.heartbeat_age_s < 5.0  # the idle loop re-stamps
            assert b.last_progress_age_s == float("inf")
            b.submit_ids([3, 5], max_new_tokens=2).result(timeout=WAIT)
            assert not b.cold  # the first chunk landed
            assert b.n_admitting == 0
        finally:
            b.stop()
        warmed = ContinuousBatcher(engine, n_slots=2, chunk=4, cache_len=128)
        try:
            warmed.warmup(buckets=[16])
            assert not warmed.cold
            assert warmed.stats["warmup_steps"] == 1
        finally:
            warmed.stop()

    def test_dead_replica_state_surfaced(self, engine):
        pool = make_pool(engine, breaker_failure_threshold=100)
        try:
            pool._replicas[1].batcher.kill(WorkerDied("test kill"))
            assert _until(lambda: pool.status()["replicas"][1]["generation"] >= 1)
            assert pool._replicas[1].deaths >= 1
            assert pool.submit_ids([3, 5], max_new_tokens=2).result(timeout=WAIT)
        finally:
            pool.stop()


def _paged_fault(err):
    def broken(*_a, **_k):
        raise err
    return broken


DEVICE_FAULTS = [
    KernelError("flash_attention decode_paged kernel launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
]


class TestDeviceFault:
    @pytest.mark.parametrize("err", DEVICE_FAULTS, ids=["kernel", "cuda"])
    def test_fault_fails_every_waiter_and_rebuilds_nothing(self, engine, err,
                                                           monkeypatch):
        pool = make_pool(engine)
        try:
            monkeypatch.setattr(paged, "paged_decode_attention", _paged_fault(err))
            handles = [pool.submit_ids(p, max_new_tokens=8) for p in _prompts(6)]
            for h in handles:
                with pytest.raises(type(err)) as e:
                    h.result(timeout=WAIT)
                assert e.value is err
            with pytest.raises(type(err)):
                pool.submit_ids([3, 5], max_new_tokens=2)
            time.sleep(0.3)  # several monitor ticks: nothing may rebuild
            st = pool.status()
        finally:
            pool.stop()
        for r in st["replicas"]:
            assert r["state"] == "failed"
            assert r["generation"] == 0 and r["deaths"] == 0
            assert r["breaker"] == "closed"
        assert all(b._failures == 0 for b in pool._breakers)

    def test_warmup_fault_raises_from_the_constructor(self, engine, monkeypatch):
        err = KernelError("nvcc failed for flash_attention.cu")
        monkeypatch.setattr(paged, "paged_decode_attention", _paged_fault(err))
        with pytest.raises(KernelError, match="nvcc failed"):
            make_pool(engine)
