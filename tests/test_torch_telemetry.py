"""Port parity, telemetry (``docqa_tpu_torch/obs/{telemetry,slo,expo}.py``)
against ``docqa_tpu/obs`` on the same inputs and the same injected clock:

* windowed digests: EQUAL windows, window counts, merged and last
  percentiles;
* the telemetry store: equal counter deltas (ring wrap, restart reset),
  gauges and snapshots;
* burn-rate alerts: equal transitions and status over the same traffic
  (latency and ratio SLOs, firing and clearing), and the firing window's
  traces flagged in the recorder;
* Prometheus text: equal in both dialects and lint-clean;
* the sampler: one tick over a live 1-replica pool, a spine, a broker and
  the recorder renders lint-clean text with each probe's series; a device
  fault in a probe reaches the tick's caller and stops the thread; the
  burn evaluator as the batcher's probe defers batch admission."""

import time

import pytest
import torch

from docqa_tpu.obs.expo import prometheus_text as j_prometheus_text
from docqa_tpu.obs.slo import BurnRateEvaluator as JBurnRateEvaluator
from docqa_tpu.obs.slo import SLODef as JSLODef
from docqa_tpu.obs.telemetry import TelemetryStore as JTelemetryStore
from docqa_tpu.obs.telemetry import WindowedDigest as JWindowedDigest
from docqa_tpu.obs.recorder import FlightRecorder as JFlightRecorder
from docqa_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig, QoSConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.serve import ContinuousBatcher, DeferredByPolicy
from docqa_tpu_torch.engines.spine import DispatchSpine
from docqa_tpu_torch.obs.expo import lint_prometheus_text, prometheus_text
from docqa_tpu_torch.obs.slo import BurnRateEvaluator, SLODef, default_ask_slos
from docqa_tpu_torch.obs.telemetry import (
    TelemetrySampler,
    TelemetryStore,
    WindowedDigest,
)
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.runtime.metrics import MetricsRegistry
from docqa_tpu_torch.service.broker import MemoryBroker
from docqa_tpu_torch.config import BrokerConfig

torch.set_num_threads(1)

WAIT = 60.0
SAMPLES = [12.0, 80.0, 3.5, 41.0, 600.0, 7.25, 99.0, 15.0, 250.0, 1.0, 33.0]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(fn):
    """Run ``fn(side)`` for the port and the reference; sides are dicts of
    the classes to use."""
    port = dict(store=TelemetryStore, digest=WindowedDigest, reg=MetricsRegistry,
                ev=BurnRateEvaluator, slo=SLODef, prom=prometheus_text,
                rec=obs.FlightRecorder)
    ref = dict(store=JTelemetryStore, digest=JWindowedDigest, reg=JMetricsRegistry,
               ev=JBurnRateEvaluator, slo=JSLODef, prom=j_prometheus_text,
               rec=JFlightRecorder)
    return fn(port), fn(ref)


def _digest_script(side):
    clock = Clock()
    d = side["digest"](interval_s=10, points=4, sample_windows=2,
                       max_samples_per_window=4, now_fn=clock)
    d._wall_offset = 0.0  # export anchor: equal on both sides
    d.register_threshold(50.0)
    out = []
    for i, v in enumerate(SAMPLES):
        clock.t = 1000.0 + 7.0 * i
        d.observe(v)
        out.append(d.recent_percentiles((50, 95, 99)))
    clock.t = 1100.0
    out.append(d.windows())
    out.append(d.window_counts(3, threshold_ms=50.0))
    out.append(d.last_percentiles())
    return out


def test_windowed_digest_equals_the_reference():
    got, want = _both(_digest_script)
    assert got == want


def _store_script(side):
    clock = Clock()
    s = side["store"](interval_s=10, points=3, now_fn=clock)
    s._wall_offset = 0.0
    for i, cum in enumerate([5, 9, 9, 20, 4, 11, 30]):  # 4: a restart
        clock.t = 1000.0 + 10 * i
        s.record_counter("c", cum)
        s.record_gauge("g", float(i) * 1.5)
    d = side["digest"](interval_s=10, now_fn=clock)
    d._wall_offset = 0.0
    d.observe(5.0)
    s.register_digest("h_ms", d)
    return [s.snapshot(), s.window_delta("c", 2), s.latest_gauges(), s.names()]


def test_store_series_equal_the_reference():
    got, want = _both(_store_script)
    assert got == want


def _burn_script(side):
    clock = Clock()
    store = side["store"](interval_s=10, points=60, now_fn=clock)
    store._wall_offset = 0.0
    reg = side["reg"]()
    h = reg.histogram("lat_ms")
    h.digest = side["digest"](interval_s=10, points=60, sample_windows=8,
                              now_fn=clock)
    rec = side["rec"]()
    slos = [
        side["slo"](name="p95", kind="latency", objective=0.95,
                    digest_name="lat_ms", threshold_ms=50.0, short_windows=1,
                    long_windows=3, burn_threshold=2.0, clear_windows=2),
        side["slo"](name="avail", kind="ratio", objective=0.99,
                    total_series="ask_requests", bad_series="ask_failures",
                    short_windows=1, long_windows=3, burn_threshold=2.0),
    ]
    ev = side["ev"](store, slos, registry=reg, recorder=rec)
    out = []
    requests = failures = 0
    for w in range(8):
        clock.t = 1000.0 + 10 * w
        slow = 2 <= w <= 4
        for _ in range(10):
            h.observe(600.0 if slow else 5.0)
        requests += 10
        failures += 5 if w == 3 else 0
        store.record_counter("ask_requests", requests)
        store.record_counter("ask_failures", failures)
        out.append(ev.evaluate())
        out.append(sorted(ev.firing()))
    status = [
        {k: v for k, v in row.items() if k not in ("fired_at_unix", "history")}
        for row in ev.status()
    ]
    out.append(status)
    out.append(reg.snapshot()["counters"])
    return out


def test_burn_rate_alerts_equal_the_reference():
    got, want = _both(_burn_script)
    assert got == want
    fired = [t for step in got[:-2:2] for t in step]
    assert {"slo": "p95", "event": "fired"} in fired
    assert {"slo": "p95", "event": "cleared"} in fired
    assert {"slo": "avail", "event": "fired"} in fired


def test_default_ask_slos_equal_the_reference():
    from docqa_tpu.obs.slo import default_ask_slos as j_default_ask_slos

    got = [vars(s) for s in default_ask_slos(800.0)]
    want = [vars(s) for s in j_default_ask_slos(800.0)]
    assert got == want


def _prom_script(side, openmetrics):
    clock = Clock()
    reg = side["reg"]()
    reg.counter("ask_requests").inc(3)
    reg.counter("cost_device_ms_interactive").inc(2.5)
    reg.gauge("pool_pending").set(2.0)
    reg.gauge("breaker_decoder_state").set(0.0)
    h = reg.histogram("qa_e2e_ms")
    h.digest = side["digest"](interval_s=10, now_fn=clock)
    for i, v in enumerate(SAMPLES):
        h.observe(v, trace_id=f"t-{i:06x}" if i % 3 == 0 else None)
    store = side["store"](interval_s=10, points=4, now_fn=clock)
    store.record_gauge("broker_depth_raw-docs", 5.0)  # needs sanitizing
    store.record_gauge("pool_pending", 9.0)  # a registry name wins
    return side["prom"](reg, store, openmetrics=openmetrics)


@pytest.mark.parametrize("openmetrics", [False, True])
def test_prometheus_text_equals_the_reference(openmetrics):
    got, want = _both(lambda side: _prom_script(side, openmetrics))
    assert got == want
    assert lint_prometheus_text(got) == []
    assert ("# EOF" in got) == openmetrics
    assert obs.telemetry_json(TelemetryStore())["series"] == {}


# ---- the sampler over the live serving plane ---------------------------------

DEC = DecoderConfig(vocab_size=96, hidden_dim=32, num_layers=1, num_heads=2,
                    num_kv_heads=1, head_dim=16, mlp_dim=48, max_seq_len=256,
                    dtype="float32")
GEN = GenerateConfig(max_new_tokens=4, prefill_buckets=(64, 128))


@pytest.fixture(scope="module")
def engine():
    return GenerateEngine(DEC, GEN, seed=2, device="cpu")


def test_sampler_tick_over_pool_spine_broker_recorder(engine):
    reg = MetricsRegistry()
    reg.counter("ask_requests").inc(2)
    store = TelemetryStore(interval_s=0.1, points=20)
    spine = DispatchSpine(n_lanes=1)
    broker = MemoryBroker(BrokerConfig())
    broker.publish("raw-docs", {"doc_id": "d"})
    rec = obs.FlightRecorder()
    rec.new_trace("ask")
    pool = EnginePool(engine, replicas=1, n_slots=2, chunk=4, cache_len=256,
                      canary_interval_s=600.0, device="cpu")
    try:
        spine.run("serve_decode_chunk", lambda: None)
        slo = BurnRateEvaluator(store, default_ask_slos(800.0), registry=reg,
                                recorder=rec)
        sampler = TelemetrySampler(
            store, registry=reg, batcher=pool, broker=broker,
            queues=("raw-docs",), recorder=rec, engine=engine,
            slo_evaluator=slo, spine=spine,
            extra_probes=[obs.DEFAULT_COST_LEDGER.telemetry_gauges],
        )
        sampler.tick()
        text = prometheus_text(reg, store)
    finally:
        pool.stop()
        spine.close()
    assert lint_prometheus_text(text) == []
    assert lint_prometheus_text(prometheus_text(reg, store, openmetrics=True)) == []
    gauges = store.latest_gauges()
    for name in ("pool_replica0_alive", "serve_queue_depth",
                 "serve_kv_blocks_total", "dispatch_occupancy",
                 "broker_depth_raw-docs", "trace_open", "cost_shed_ring_depth"):
        assert name in gauges, name
    assert gauges["pool_replica0_alive"] == 1.0 and gauges["trace_open"] == 1.0
    # a CPU engine has no device memory to scrape
    assert not any(n.startswith("device_mem_") for n in gauges)
    assert "dispatch_device_ms_serve_decode_chunk" in store.names()


def test_device_fault_in_a_probe_reaches_the_tick_and_stops_the_thread():
    fault = KernelError("device memory probe after a fault")

    def probe():
        raise fault

    sampler = TelemetrySampler(TelemetryStore(), extra_probes=[probe],
                               sample_every_s=0.01)
    with pytest.raises(KernelError):
        sampler.tick()
    sampler.start()
    end = time.monotonic() + WAIT
    while sampler.running and time.monotonic() < end:
        time.sleep(0.01)
    sampler.stop()
    assert not sampler.running and sampler.device_fault is fault


def test_other_probe_failures_are_fenced():
    def broken():
        raise ValueError("replica gone")

    store = TelemetryStore()
    TelemetrySampler(store, extra_probes=[broken, lambda: {"ok_gauge": 1.0}]).tick()
    assert store.latest_gauge("ok_gauge") == 1.0


def test_burn_evaluator_as_the_batcher_probe_defers_batch(engine):
    clock = Clock()
    store = TelemetryStore(interval_s=10, points=10, now_fn=clock)
    reg = MetricsRegistry()
    slos = default_ask_slos(800.0, short_windows=1, long_windows=2)
    ev = BurnRateEvaluator(store, slos, registry=reg)
    b = ContinuousBatcher(engine, n_slots=2, chunk=4, cache_len=256,
                          qos=QoSConfig())
    try:
        b.set_slo_probe(ev.firing)
        store.record_counter("ask_requests", 20)
        store.record_counter("ask_failures", 10)
        ev.evaluate()
        assert ev.firing() == ["ask_availability"]
        assert b.qos_status()["defer_active"] is True
        with pytest.raises(DeferredByPolicy):
            b.submit_ids([4, 5, 6], max_new_tokens=2, req_class="batch")
        assert b.submit_ids([4, 5, 6], max_new_tokens=2,
                            req_class="interactive").result(timeout=WAIT)
        assert b.submit_ids([4, 5, 6], max_new_tokens=2,
                            req_class="background").result(timeout=WAIT)
    finally:
        b.stop()
