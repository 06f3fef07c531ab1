"""Port parity, tracing and analysis (``docqa_tpu_torch/obs``) against
``docqa_tpu/obs`` on the same inputs:

* synthetic traces built with fixed timestamps give EQUAL timelines, Chrome
  traces, coverage, attribution tables (and their text), and device/host
  splits;
* the flight recorder, driven on the same fake clock through the same
  sequence (slow flags, the anomalous ring, abandoned traces, window
  flagging, header re-linking and stub adoption), keeps the same traces
  with the same flags;
* the trace-id log filter, ``runtime.metrics.span``'s trace span and
  exemplar, a deadline shed's flag and event;
* the observatory's peak: the H100 by name, no peak on a CPU or an unknown
  card, ``DOCQA_PEAK_FLOPS``, and MFU above 1 never reported as
  utilisation;
* the ``torch.profiler`` window: one at a time, a Chrome trace in its
  logdir that names the spans run inside it, on any thread;
* one ingested document through each side's pipeline leaves the same span
  names, parents and counts."""

import collections
import contextlib
import json
import logging
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.config import BrokerConfig as JBrokerConfig
from docqa_tpu.config import Config as JConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import NERConfig as JNERConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.deid.engine import DeidEngine as JDeidEngine
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.models.ner import init_ner_params as j_init_ner_params
from docqa_tpu.obs import spans as jspans
from docqa_tpu.resilience.deadline import Deadline as JDeadline
from docqa_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from docqa_tpu.service import broker as jbroker
from docqa_tpu.service import registry as jreg
from docqa_tpu.service.pipeline import DocumentPipeline as JDocumentPipeline
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import (
    BrokerConfig,
    Config,
    EncoderConfig,
    NERConfig,
    StoreConfig,
)
from docqa_tpu_torch.deid.engine import DeidEngine
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.obs import spans as tspans
from docqa_tpu_torch.obs.observatory import Observatory, detect_peak_flops
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.runtime.metrics import MetricsRegistry, get_logger, span
from docqa_tpu_torch.service import broker as tbroker
from docqa_tpu_torch.service import registry as treg
from docqa_tpu_torch.service.pipeline import DocumentPipeline

torch.set_num_threads(1)

# (name, start_s, end_s, parent index into this list or None = root, attrs)
SPANS = [
    ("qa_e2e", 0.001, 0.950, None, {}),
    ("qa_retrieve", 0.002, 0.120, 0, {"k": 3}),
    ("dispatch:retrieve", 0.010, 0.115, 1, {"stream": "serve"}),
    ("serve_queue_wait", 0.121, 0.180, 0, {}),
    ("serve_prefill", 0.180, 0.300, 0, {"batch": 2, "slot": 1}),
    ("serve_decode_chunk", 0.300, 0.420, 0, {"tokens": 6}),
    ("serve_decode_chunk", 0.420, 0.555, 0, {"tokens": 4}),
    ("serve_result_wait", 0.121, 0.600, 0, {}),
    ("extract", 0.700, 0.710, None, {"bytes": 512}),
]


def _build(o, trace_id, name, offset, dur, status="ok", flag=None):
    """The same trace in package ``o``: fixed clocks, spans, events."""
    tr = o.Trace(trace_id, name, attrs={"doc_id": "d-1"})
    t0 = 1000.0 + offset
    tr.t0 = tr.root.t_start = t0
    tr.wall0 = 1.7e9 + offset
    made = []
    for sname, a, b, parent, attrs in SPANS:
        pid = made[parent].span_id if parent is not None else None
        made.append(tr.record_span(sname, t0 + a, t0 + b, parent_id=pid, **attrs))
    made[4].events.append({"name": "first_token", "t": t0 + 0.299, "slot": 1})
    tr.root.events.append({"name": "serve_submit", "t": t0 + 0.121, "n_queued": 0})
    if flag:
        tr.flag(flag)
    tr.root.t_end = t0 + dur
    tr.status = status
    tr.cost_summary = {"class": "interactive", "outcome": status, "device_ms": 1.5}
    return tr


def _pair(*args, **kw):
    return _build(obs, *args, **kw), _build(jobs, *args, **kw)


def test_timeline_chrome_trace_and_coverage_equal_the_reference():
    got, want = _pair("t-000001", "ask", 0.0, 1.0, flag="slow_p95")
    assert obs.timeline_dict(got) == jobs.timeline_dict(want)
    assert obs.coverage(got) == jobs.coverage(want) == pytest.approx(0.949)
    g2, w2 = _pair("t-000002", "ingest", 3.5, 0.4)
    assert obs.to_chrome_trace([got, g2]) == jobs.to_chrome_trace([want, w2])
    assert obs.to_chrome_trace([]) == jobs.to_chrome_trace([])


def test_attribution_tables_and_split_equal_the_reference():
    pairs = [_pair(f"t-{i:06x}", "ask", i * 2.0, 0.8 + 0.1 * i) for i in range(5)]
    got = [g for g, _ in pairs]
    want = [w for _, w in pairs]
    rows = obs.attribution(got)
    assert rows == jobs.attribution(want)
    assert obs.format_table(rows) == jobs.format_table(jobs.attribution(want))
    assert obs.device_host_split(got) == jobs.device_host_split(want)
    assert obs.DEVICE_STAGES == jobs.DEVICE_STAGES
    assert rows[-1]["stage"] == "(unattributed)"
    assert {r["stage"]: r["kind"] for r in rows}["dispatch:retrieve"] == "device"


def _fake_clock(monkeypatch):
    clock = [0.0]
    fake = types.SimpleNamespace(
        perf_counter=lambda: clock[0], time=lambda: 1.7e9 + clock[0]
    )
    for mod in (jspans, tspans):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def _recorder_script(o, clock):
    o.reset_ids("t", 1)
    rec = o.FlightRecorder(capacity=8, anomalous_capacity=4,
                           min_slow_samples=5, max_open=3)
    durations = [0.1, 0.2, 0.15, 0.12, 0.3, 0.11, 0.9, 0.13, 0.2, 0.14, 0.5, 0.12]
    for i, dur in enumerate(durations):
        clock[0] = 10.0 * i
        ctx = rec.new_trace("ask", question_len=i)
        clock[0] += dur
        if i % 5 == 0:
            ctx.trace.flag("degraded")
        rec.complete(ctx.trace, status="ok")
    # more open traces than max_open: the oldest are abandoned
    opened = []
    for i in range(5):
        clock[0] = 200.0 + i
        opened.append(rec.new_trace("doc"))
    # a window flag promotes retained traces into the anomalous ring
    flagged = rec.flag_window(1.7e9 + 15.0, 1.7e9 + 45.0, "slo_ask_p95_burn",
                              names=["ask"])
    # re-link by headers; an unknown id adopts a stub
    headers = o.headers_of(opened[-1])
    linked = rec.from_headers(headers, name="doc")
    stub = rec.from_headers({o.TRACE_HEADER: "t-gone"}, name="doc")
    clock[0] = 300.0
    rec.complete(linked.trace, status="ok")
    rec.complete(stub.trace, status="dropped")
    return (
        rec.summaries(50), rec.summaries(50, anomalous=True),
        rec.anomalous_total, flagged, headers, stub.trace.root.attrs,
        [t.trace_id for t in rec.open_traces()],
    )


def test_flight_recorder_retention_equals_the_reference(monkeypatch):
    clock = _fake_clock(monkeypatch)
    got = _recorder_script(obs, clock)
    want = _recorder_script(jobs, clock)
    assert got == want
    flags = {s["trace_id"]: s["flags"] for s in got[1]}
    assert any("slow_p95" in f for f in flags.values())
    assert any("abandoned" in f for f in flags.values())


def test_trace_id_log_filter_and_span_exemplar():
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    log = get_logger("docqa.test_obs")
    handler = Keep()
    log.addHandler(handler)
    reg, jreg_ = MetricsRegistry(), JMetricsRegistry()
    try:
        ctx = obs.new_trace("ask")
        with ctx.activate():
            log.warning("shed at %s", "serve_queue")
            with span("qa_retrieve", reg):
                pass
        log.warning("untraced")
        obs.finish(ctx)
    finally:
        log.removeHandler(handler)
    assert seen == [f"trace_id={ctx.trace_id} shed at serve_queue", "untraced"]
    names = [s.name for s in ctx.trace.snapshot_spans()]
    assert names == ["ask", "qa_retrieve"]
    ex = reg.histogram("qa_retrieve_ms").exemplars()
    assert [e["trace_id"] for e in ex] == [ctx.trace_id]
    # the histograms' windowed summaries agree with the reference's
    for r in (reg, jreg_):
        for v in (3.0, 1.0, 7.0, 5.0):
            r.histogram("h").observe(v, trace_id="t-x" if v > 4 else None)
    assert reg.histogram("h").summary() == jreg_.histogram("h").summary()


def test_deadline_shed_flags_the_trace_like_the_reference():
    out = []
    for o, dl_cls in ((obs, Deadline), (jobs, JDeadline)):
        ctx = o.new_trace("ask")
        with ctx.activate():
            with pytest.raises(DeadlineExceeded if o is obs else TimeoutError):
                dl_cls(expires_at=time.monotonic() - 0.5).check("serve_queue")
        o.finish(ctx)
        ev = ctx.trace.root.events[0]
        out.append((ctx.trace.flags, ev["name"], ev["stage"], ctx.trace.status))
    assert out[0] == out[1] == (["deadline_exceeded"], "deadline_exceeded",
                                "serve_queue", "ok")


# ---- the observatory ----------------------------------------------------------


def _fake_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: name)


def test_peak_names_the_h100(monkeypatch):
    monkeypatch.delenv("DOCQA_PEAK_FLOPS", raising=False)
    _fake_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    peak = detect_peak_flops()
    assert peak["peak_flops"] == 989e12 and peak["peak_bytes_s"] == 3.35e12
    assert "NVIDIA H100 80GB HBM3" in peak["peak_flops_source"]


@pytest.mark.parametrize("card", [None, "Some Future Card"])
def test_no_peak_means_no_mfu(monkeypatch, card):
    monkeypatch.delenv("DOCQA_PEAK_FLOPS", raising=False)
    if card is not None:
        _fake_card(monkeypatch, card)
    peak = detect_peak_flops("cpu" if card is None else None)
    assert peak["peak_flops"] is None and peak["peak_bytes_s"] is None
    o = Observatory()
    o.annotate_model("s", lambda key: {"flops": 1e9, "bytes": 1e6})
    o.record("s", "k", 0.5)
    row = o.stats(peak)["stages"]["s"]
    assert row["mfu"] is None and "mfu_raw_invalid" not in row
    assert row["intensity_flops_per_byte"] == 1000.0
    assert row["roofline_bound"] is None


def test_env_peak_and_invalid_mfu(monkeypatch):
    monkeypatch.setenv("DOCQA_PEAK_FLOPS", "1e9")
    peak = detect_peak_flops("cpu")
    assert peak["peak_flops"] == 1e9
    assert peak["peak_flops_source"] == "env:DOCQA_PEAK_FLOPS"
    o = Observatory()
    o.annotate_model("m", lambda key: {"flops": 1e9 * key, "bytes": 0.0})
    o.record("m", 2, 4.0)  # 2 GFLOP in 4 s against 1 GFLOP/s: 0.5
    o.record("fast", None, 1e-3)
    o.annotate_model("fast", lambda key: {"flops": 5e9, "bytes": 0.0})
    o.record("fast", None, 1e-3)  # 5 GFLOP "in" 1 ms: impossible
    st = o.stats()["stages"]
    assert st["m"]["mfu"] == 0.5
    assert st["fast"]["mfu"] is None and st["fast"]["mfu_raw_invalid"] > 1
    assert st["fast"]["uncosted_calls"] == 1


# ---- the profiler window --------------------------------------------------------


def test_profiler_window_writes_a_chrome_trace(tmp_path):
    win = obs.ProfilerWindow()
    with pytest.raises(RuntimeError):
        win.stop()
    logdir = win.start(str(tmp_path / "prof"), device="cpu")
    with pytest.raises(RuntimeError):
        win.start(str(tmp_path / "again"))
    assert win.active
    prev = obs.DEFAULT_PROFILER
    try:
        # runtime.metrics.span reads the default window
        import docqa_tpu_torch.runtime.metrics as metrics

        metrics._PROFILER = win
        with span("obs_profiled_stage", MetricsRegistry()):
            torch.ones(8, 8) @ torch.ones(8, 8)
    finally:
        metrics._PROFILER = prev
        assert win.stop() == logdir
    assert not win.active
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "obs_profiled_stage" for e in events)


def test_profiler_window_records_the_ranges_of_other_threads(tmp_path):
    # the batcher's worker and the spine's lanes issue the device work
    win = obs.ProfilerWindow()
    logdir = win.start(str(tmp_path / "prof"), device="cpu")
    try:
        worker = threading.Thread(target=lambda: _ranged("obs_worker_range"))
        worker.start()
        worker.join(10)
    finally:
        win.stop()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "obs_worker_range" for e in events)


def _ranged(name):
    with torch.profiler.record_function(name):
        torch.ones(8, 8) @ torch.ones(8, 8)


# ---- one ingested document ------------------------------------------------------

ENC = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_seq_len=128, embed_dim=32, dtype="float32")
NER = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_seq_len=128, dtype="float32")
DOC = ("Tél : 01 23 45 67 89 — consultation du 3 mars 2024.\n"
       "Patient suivi pour hypertension, traitement par lisinopril 10 mg.")


@contextlib.contextmanager
def _no_earlier_durations(rec):
    """A finished trace is flagged ``slow_p95`` against the durations of the
    recorder's earlier traces, which other test files in this worker leave
    behind: hide them for the test, then put them back."""
    with rec._lock:
        saved = list(rec._durations)
        rec._durations.clear()
    try:
        yield
    finally:
        with rec._lock:
            rec._durations.clear()
            rec._durations.extend(saved)


def _doc_tree(o, pipe):
    with _no_earlier_durations(o.DEFAULT_RECORDER):
        return _traced_ingest(o, pipe)


def _traced_ingest(o, pipe):
    ctx = o.new_trace("ingest")
    with ctx.activate():
        doc_id = pipe.ingest_document("note.txt", DOC.encode(), patient_id="P1").doc_id
    pipe.start()
    try:
        assert pipe.wait_indexed(doc_id, timeout=60)
        end = time.monotonic() + 10
        while not ctx.trace.finished and time.monotonic() < end:
            time.sleep(0.01)
    finally:
        pipe.stop()
    spans = ctx.trace.snapshot_spans()
    by = {s.span_id: s for s in spans}
    shape = collections.Counter(
        (s.name, by[s.parent_id].name if s.parent_id else None) for s in spans
    )
    return shape, ctx.trace.status, ctx.trace.flags


def test_ingested_document_trace_shape_equals_the_reference():
    jparams = j_init_ner_params(jax.random.PRNGKey(5), JNERConfig(**NER))
    params = {k: np.asarray(v) for k, v in jparams.items()}
    jcfg = JConfig(encoder=JEncoderConfig(**ENC), ner=JNERConfig(**NER),
                   store=JStoreConfig(dim=32, shard_capacity=128),
                   broker=JBrokerConfig(prefetch=4))
    jpipe = JDocumentPipeline(
        jcfg, jbroker.MemoryBroker(jcfg.broker), jreg.DocumentRegistry(),
        JDeidEngine(jcfg.ner, params=jparams, ner_threshold=0.0),
        JEncoderEngine(jcfg.encoder, seed=1), JVectorStore(jcfg.store),
    )
    cfg = Config(encoder=EncoderConfig(**ENC), ner=NERConfig(**NER),
                 store=StoreConfig(dim=32, shard_capacity=128),
                 broker=BrokerConfig(prefetch=4))
    tpipe = DocumentPipeline(
        cfg, tbroker.make_broker(cfg.broker), treg.DocumentRegistry(),
        DeidEngine(cfg.ner, params=params, ner_threshold=0.0, device="cpu"),
        EncoderEngine(cfg.encoder, seed=1, device="cpu"),
        VectorStore(cfg.store, device="cpu"),
    )
    want = _doc_tree(jobs, jpipe)
    got = _doc_tree(obs, tpipe)
    assert got == want
    assert set(dict(got[0])) == {("ingest", None), ("extract", "ingest"),
                                 ("deid_batch", "ingest"), ("index_batch", "ingest")}
    assert got[1] == "ok"
