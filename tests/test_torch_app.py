"""Port parity, the HTTP app: the same requests into docqa_tpu's app (its
aiohttp handlers in process, through aiohttp's test client on 127.0.0.1)
and into docqa_tpu_torch's app over its stdlib HTTP front on 127.0.0.1
port 0, both over a tiny runtime on the CPU (hash embeddings, the random
tagger below its acceptance threshold, deadlines off so a loaded host
cannot degrade an answer) in fake-LLM mode; the port's front also serves a
second runtime that decodes (a 2-layer float32 decoder behind a
one-replica pool).  A third pair, the reference's and the port's, runs
fake-LLM over a real (tiny, seeded) encoder, so both build fused
retrievers: every question of ``data/routing_mix.jsonl`` over its
documents must get the same route, answer and sources.  The reference's decoding runtime is left out: it
shards its decoder over the tests' 8 virtual CPU devices, and its compile
would load every core of a host that runs other test files beside this
one.  Decoding parity with the reference is held by the pool's and the
batcher's own tests.

Status codes must be equal for every request.  Every port response, from
both port runtimes, must pass ``docqa_tpu/analysis/wire_audit.py``'s
``validate_response`` against ``api_contract.json`` where the contract
declares its status (server-sent events against the contract's event
specs).  Values must be equal where both sides are deterministic: answers,
routed answers and sources, patient snippets, summaries, the syntheses'
retrieved parts (a synthesis's text summarizes a prompt that names each
side's random document ids), document listings (document ids mapped by
upload order), chunk counts, and the key trees of the status and retrieval
surfaces.  On the decoding runtime a stream's deltas must make its answer,
a lookup must be routed, a deleted document never cited, and concurrent
answers equal sequential ones.  A kernel or CUDA fault inside a handler
must propagate: no 500, no degraded answer, and the server stops.  The
module leaves both packages' flight recorders and metric counters and
the reference's cost-ledger probe as it found them: later test files in
the same worker read them.
"""

import asyncio
import gc
import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request
import zipfile
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.analysis.wire_audit import _parse_sse, validate_response, validate_value
from docqa_tpu.analysis.wire_schema import default_ledger_path, load_contract
from docqa_tpu.config import load_config as j_load_config
from docqa_tpu.runtime import metrics as jmetrics
from docqa_tpu.service.app import DocQARuntime as JDocQARuntime
from docqa_tpu.service.app import make_app as j_make_app
from docqa_tpu.service.wire import to_wire as j_to_wire
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import load_config
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.runtime import metrics
from docqa_tpu_torch.service.app import (
    AppServer,
    DocQARuntime,
    Request,
    make_app,
    refuse_unported,
)
from docqa_tpu_torch.service.wire import to_wire

torch.set_num_threads(1)
log = logging.getLogger(__name__)

TINY = {
    "encoder.embed_dim": 64, "store.dim": 64, "store.shard_capacity": 256,
    "store.dtype": "float32",
    "ner.hidden_dim": 32, "ner.num_layers": 1, "ner.num_heads": 2,
    "ner.mlp_dim": 64, "ner.train_steps": 0,
    # 8 query and 8 K/V heads: the reference shards them over the tests'
    # 8 virtual CPU devices
    "decoder.hidden_dim": 64, "decoder.num_layers": 2, "decoder.num_heads": 8,
    "decoder.num_kv_heads": 8, "decoder.head_dim": 8, "decoder.mlp_dim": 128,
    "decoder.vocab_size": 512, "decoder.max_seq_len": 512,
    "decoder.dtype": "float32",
    "generate.max_new_tokens": 8, "generate.max_concurrent": 2,
    "generate.prefill_buckets": (64, 128, 256, 512),
    "summarizer.max_summary_tokens": 8, "summarizer.max_input_tokens": 448,
    "pool.canary_interval_s": 3600.0,
    "resilience.request_deadline_s": 0.0,
    # the burn evaluator's tick decides whether a batch request is deferred
    # after the scenario's 503s: timing, not behaviour, so it is off
    "qos.defer_batch_on_burn": False,
    "flags.use_fake_encoder": True,
}
FAKE = {**TINY, "flags.use_fake_llm": True}
# a real (tiny, seeded) encoder: the runtimes build their fused retrievers
ENCODED = {
    **FAKE, "flags.use_fake_encoder": False,
    "encoder.vocab_size": 512, "encoder.hidden_dim": 64, "encoder.num_layers": 2,
    "encoder.num_heads": 8, "encoder.mlp_dim": 128, "encoder.max_seq_len": 128,
    "encoder.dtype": "float32",
}

NOTES = [
    ("okafor.txt", "p1", "admission", "2024-03-05",
     "Admission note: patient Okafor, MRN 40081223, admitted to ward B for "
     "observation after a fall at home. Aspirin 100 mg daily."),
    ("nguyen.txt", "p2", "registration", "2024-04-10",
     "Registration sheet: patient Nguyen, contact phone number 514-555-0187, "
     "next of kin listed as spouse. Metformin 850 mg twice daily."),
    ("silva.docx", "p1", "medication", "2023-11-30",
     "Medication list for patient Silva: metformin 850 mg twice daily with "
     "meals, dosage reviewed at last visit."),
    ("lavoie.pdf", "p3", None, None,
     "Compte rendu: la patiente Lavoie presente une tension arterielle de "
     "150/95 mmHg, lisinopril 10 mg par jour."),
]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "data", "routing_mix.jsonl"), encoding="utf-8") as _f:
    MIX = [json.loads(line) for line in _f if line.strip()]
QUESTIONS = [
    "What is the MRN of patient Okafor?",  # a lookup: routed
    "Why was patient Okafor admitted for observation?",  # generative
    "What is the dosage of metformin for patient Silva?",
]


def _docx(text):
    xml = (b'<?xml version="1.0"?><w:document><w:body><w:p><w:r><w:t>'
           + text.encode() + b"</w:t></w:r></w:p></w:body></w:document>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("word/document.xml", xml)
    return buf.getvalue()


def _pdf(text):
    stream = zlib.compress(b"BT /F1 12 Tf (" + text.encode() + b") Tj ET")
    return (b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode()
            + b" /Filter /FlateDecode >>\nstream\n" + stream
            + b"endstream\nendobj\ntrailer\n%%EOF")


def _multipart(filename, data, fields):
    boundary = "docqa-test-boundary"
    parts = [
        (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
         f'filename="{filename}"\r\nContent-Type: application/octet-stream'
         "\r\n\r\n").encode() + data + b"\r\n"
    ]
    for name, value in fields.items():
        if value is not None:
            parts.append((f'--{boundary}\r\nContent-Disposition: form-data; '
                          f'name="{name}"\r\n\r\n{value}\r\n').encode())
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class _RefClient:
    """The reference app in process, through aiohttp's test client."""

    def __init__(self, rt):
        from aiohttp.test_utils import TestClient, TestServer

        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(j_make_app(rt)), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def __call__(self, method, path, body=None, ctype="application/json", headers=None):
        async def go():
            h = dict(headers or {})
            if body is not None:
                h["Content-Type"] = ctype
            r = await self.client.request(method, path, data=body, headers=h)
            return r.status, dict(r.headers), await r.read()

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


def _port_call(base, method, path, body=None, ctype="application/json",
               headers=None, timeout=120):
    h = dict(headers or {})
    if body is not None:
        h["Content-Type"] = ctype
    req = urllib.request.Request(base + path, data=body, method=method, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _j(payload):
    return json.dumps(payload).encode()


def _scenario(call):
    """The request sequence, driven the same way on either side.  Returns
    [(contract key, status, headers, body bytes, note)] and the uploads'
    doc ids in order."""
    out, doc_ids = [], []

    def rec(key, method, path, body=None, ctype="application/json", note="", headers=None):
        status, hdrs, raw = call(method, path, body, ctype, headers)
        out.append((key, status, hdrs, raw, note or path))
        return status, raw

    rec("GET /health", "GET", "/health")
    rec("POST /ask/", "POST", "/ask/", _j({"question": "x"}), note="empty index")
    rec("POST /ask/", "POST", "/ask/", _j({"q": "x"}), note="bad body")
    rec("POST /ask/", "POST", "/ask/", b"not json", note="not json")
    for filename, pid, dtype, date, text in NOTES:
        fields = {"patient_id": pid, "doc_type": dtype, "doc_date": date}
        if filename.endswith(".txt"):
            body = _j({"filename": filename, "text": text, **fields})
            _s, raw = rec("POST /ingest/", "POST", "/ingest/?wait=1", body)
        else:
            data = _docx(text) if filename.endswith(".docx") else _pdf(text)
            body, ctype = _multipart(filename, data, fields)
            _s, raw = rec("POST /ingest/", "POST", "/ingest/?wait=1", body, ctype)
        doc_ids.append(json.loads(raw)["doc_id"])
    rec("POST /ingest/", "POST", "/ingest/", _j({"filename": "e.txt", "text": ""}),
        note="empty upload")
    rec("GET /documents/", "GET", "/documents/")
    rec("GET /documents/{doc_id}", "GET", f"/documents/{doc_ids[0]}", note="first doc")
    rec("GET /documents/{doc_id}", "GET", "/documents/no-such-doc")
    for q in QUESTIONS:
        rec("POST /ask/", "POST", "/ask/", _j({"question": q}), note=q)
    rec("POST /ask/stream", "POST", "/ask/stream", _j({"question": QUESTIONS[1]}))
    rec("POST /ask/stream", "POST", "/ask/stream", _j({"question": QUESTIONS[0]}),
        note="routed stream")
    rec("GET /api/search/patient-snippets", "GET",
        "/api/search/patient-snippets?patient_id=p1")
    rec("GET /api/search/patient-snippets", "GET",
        "/api/search/patient-snippets?patient_id=p1&from_date=2024-01-01")
    rec("GET /api/search/patient-snippets", "GET",
        "/api/search/patient-snippets?patient_id=p2&focus=metformin%20dose")
    rec("GET /api/search/patient-snippets", "GET",
        "/api/search/patient-snippets?patient_id=p1&to_date=someday")
    rec("GET /api/search/patient-snippets", "GET", "/api/search/patient-snippets")
    rec("POST /api/llm/summarize", "POST", "/api/llm/summarize",
        _j({"prompt": "Resume: " + NOTES[0][4]}))
    rec("POST /api/llm/summarize", "POST", "/api/llm/summarize",
        _j({"prompt": "x", "max_tokens": "many"}), note="bad max_tokens")
    rec("POST /api/synthese/patient", "POST", "/api/synthese/patient",
        _j({"patient_id": "p1"}))
    rec("POST /api/synthese/patient", "POST", "/api/synthese/patient",
        _j({"patient_id": "nobody"}), note="no documents")
    rec("POST /api/synthese/patient", "POST", "/api/synthese/patient",
        _j({"focus": "x"}), note="no patient_id")
    rec("POST /api/synthese/comparaison", "POST", "/api/synthese/comparaison",
        _j({"patient_ids": ["p1", "p2"]}))
    rec("POST /api/synthese/comparaison", "POST", "/api/synthese/comparaison",
        _j({"patient_ids": []}), note="empty ids")
    rec("POST /api/synthese/comparaison", "POST", "/api/synthese/comparaison",
        _j({"patient_ids": ["p1"]}), note="one id")
    rec("DELETE /documents/{doc_id}", "DELETE", f"/documents/{doc_ids[0]}",
        note="delete first doc")
    rec("DELETE /documents/{doc_id}", "DELETE", "/documents/no-such-doc")
    rec("POST /ask/", "POST", "/ask/", _j({"question": QUESTIONS[0]}), note="after delete")
    rec("GET /api/status", "GET", "/api/status")
    rec("GET /api/retrieval", "GET", "/api/retrieval")
    rec("GET /api/telemetry", "GET", "/api/telemetry")
    rec("GET /api/metrics", "GET", "/api/metrics")
    rec("GET /metrics", "GET", "/metrics")
    rec("GET /metrics", "GET", "/metrics", note="openmetrics",
        headers={"Accept": "application/openmetrics-text"})
    rec("GET /api/costs", "GET", "/api/costs")
    rec("GET /api/costs/sheds", "GET", "/api/costs/sheds?limit=5")
    rec("GET /api/costs/sheds", "GET", "/api/costs/sheds?limit=x")
    rec("GET /api/costs/sheds", "GET", "/api/costs/sheds?limit=-1")
    rec("GET /api/traces", "GET", "/api/traces?limit=10")
    rec("GET /api/traces", "GET", "/api/traces?anomalous=1")
    rec("GET /api/traces", "GET", "/api/traces?limit=x")
    rec("GET /api/trace/{trace_id}", "GET", "/api/trace/no-such-trace")
    rec("GET /api/witness", "GET", "/api/witness")
    rec("GET /api/ledger", "GET", "/api/ledger")
    rec("GET /api/pool", "GET", "/api/pool")
    rec("POST /api/pool/drain", "POST", "/api/pool/drain", _j({"replica": 3}))
    rec("POST /api/pool/drain", "POST", "/api/pool/drain", _j({"timeout": "soon"}))
    rec("POST /api/pool/drain", "POST", "/api/pool/drain", b"{", note="bad json")
    rec("POST /api/pool/resume", "POST", "/api/pool/resume", _j({"replica": -1}))
    rec("POST /api/pool/drain", "POST", "/api/pool/drain",
        _j({"replica": 0, "timeout": 10}))
    rec("POST /api/pool/resume", "POST", "/api/pool/resume", _j({"replica": 0}))
    rec("POST /api/pool/rolling_restart", "POST", "/api/pool/rolling_restart",
        _j({"timeout_per_replica": 10}))
    rec("POST /ask/", "POST", "/ask/", _j({"question": QUESTIONS[1]}),
        note="after restart")
    rec("POST /api/profiler/stop", "POST", "/api/profiler/stop", note="no window")
    rec("GET /", "GET", "/")
    return out, doc_ids


def _routing_scenario(call):
    """Every note of the labeled routing mix ingested, then every question
    of the mix asked.  Returns [(question, status, body bytes)] and the
    uploads' doc ids in order."""
    doc_ids = []
    for row in MIX:
        if "doc" in row:
            body = _j({"filename": f"{row['id']}.txt", "text": row["doc"]})
            status, _h, raw = call("POST", "/ingest/?wait=1", body)
            assert status == 200, raw
            doc_ids.append(json.loads(raw)["doc_id"])
    asked = []
    for row in MIX:
        status, _h, raw = call("POST", "/ask/", _j({"question": row["question"]}))
        asked.append((row["question"], status, raw))
    return asked, doc_ids


def _recorder_state(rec):
    with rec._lock:
        return (list(rec._open.items()), list(rec._ring), list(rec._anomalous),
                list(rec._durations), rec.anomalous_total)


def _restore_recorder(rec, state):
    open_, ring, anomalous, durations, total = state
    with rec._lock:
        rec._open.clear()
        rec._open.update(open_)
        for dq, items in ((rec._ring, ring), (rec._anomalous, anomalous),
                          (rec._durations, durations)):
            dq.clear()
            dq.extend(items)
        rec.anomalous_total = total


def _counters(registry):
    with registry._lock:
        return {name: c.value for name, c in registry.counters.items()}


def _restore_counters(registry, saved):
    """A runtime's SLOs read the process registry's cumulative counters
    (``ask_requests``, ``ask_failures``) from their first window: counts
    this module leaves would burn the SLOs of a later runtime in the same
    worker, and it would defer its batch work."""
    with registry._lock:
        counters = list(registry.counters.items())
    for name, c in counters:
        with c._lock:
            c._value = saved.get(name, 0)


class _PortApp:
    """One port runtime behind its HTTP front."""

    def __init__(self, overrides):
        self.rt = DocQARuntime(load_config(env={}, overrides=overrides), device="cpu").start()
        self.server = AppServer(make_app(self.rt)).start()
        self.base = f"http://127.0.0.1:{self.server.port}"

    def call(self, *a, **kw):
        return _port_call(self.base, *a, **kw)

    def close(self):
        try:
            return self.server.close(timeout=10)
        finally:
            self.rt.stop()


class _Apps:
    """The runtimes, their fronts, and the scenario's records: ``j*`` the
    reference's, ``t*`` the port's fake-LLM runtime, ``r*`` the port's
    decoding runtime."""

    def __init__(self):
        self.recorders = [(rec, _recorder_state(rec))
                          for rec in (jobs.DEFAULT_RECORDER, obs.DEFAULT_RECORDER)]
        self.counters = [(reg, _counters(reg))
                         for reg in (jmetrics.DEFAULT_REGISTRY, metrics.DEFAULT_REGISTRY)]
        self.ref_probe = jobs.DEFAULT_COST_LEDGER._pressure_probe
        self.jrt = JDocQARuntime(j_load_config(env={}, overrides=FAKE)).start()
        self.ref = _RefClient(self.jrt)
        self.jrecords, self.jdocs = _scenario(self.ref)
        self.jenc_rt = JDocQARuntime(j_load_config(env={}, overrides=ENCODED)).start()
        self.jenc = _RefClient(self.jenc_rt)
        self.jrouted, self.jrouted_docs = _routing_scenario(self.jenc)
        # the reference's threads (its executors start on first use) are
        # all up by now: every thread past this point is the port's
        self.threads_before = set(threading.enumerate())
        self.fake = _PortApp(FAKE)
        self.trecords, self.tdocs = _scenario(self.fake.call)
        self.real = _PortApp(TINY)
        self.rt = self.real.rt
        self.base = self.real.base
        self.rrecords, self.rdocs = _scenario(self.real.call)
        self.encoded = _PortApp(ENCODED)
        self.routed, self.routed_docs = _routing_scenario(self.encoded.call)
        self.closed = None

    def call(self, *a, **kw):
        return self.real.call(*a, **kw)

    def shutdown(self):
        """Stop every runtime and front (idempotent).  Returns whether the
        port's servers, lanes and runtime threads all ended."""
        if self.closed is not None:
            return self.closed
        try:
            servers_done = all(
                [self.fake.close(), self.real.close(), self.encoded.close()]
            )
            for t in threading.enumerate():
                if t not in self.threads_before:
                    t.join(timeout=10)
            leaked = [
                t.name for t in threading.enumerate()
                if t not in self.threads_before and t.is_alive()
            ]
            self.closed = (servers_done, leaked)
        finally:
            for client, rt in ((self.ref, self.jrt), (self.jenc, self.jenc_rt)):
                client.close()
                rt.stop()
            jobs.DEFAULT_COST_LEDGER.set_pressure_probe(self.ref_probe)
            for rec, state in self.recorders:
                _restore_recorder(rec, state)
            for reg, saved in self.counters:
                _restore_counters(reg, saved)
        return self.closed


@pytest.fixture(scope="module", autouse=True)
def _release_reference_caches():
    """Drop the reference's traced and compiled programs once the module is
    done: left in this xdist worker, they lengthen the collector's pauses,
    which decides a thread-start race in a later reference file
    (``tests/test_spine.py::TestSpineCore::test_close_fails_queued_typed_and_rejects_new``)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def apps():
    holder = _Apps()
    yield holder
    try:
        holder.shutdown()
    except Exception:  # the last test asserts the shutdown itself
        log.exception("app shutdown failed")


def _normalize(raw, docs):
    """Decoded JSON with each side's doc ids replaced by their upload
    index, and per-run fields dropped: the upload time, and a synthesis's
    generated text (its prompt names the random document ids)."""
    text = raw.decode("utf-8")
    for i, d in enumerate(docs):
        text = text.replace(d, f"DOC{i}")
    body = json.loads(text)
    if isinstance(body, list):
        for row in body:
            if isinstance(row, dict):
                row.pop("upload_date", None)
    elif isinstance(body, dict):
        body.pop("upload_date", None)
        if "type" in body:  # a synthesis
            body.pop("sections", None)
            body.pop("summary", None)
    return body


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


CONTRACT = load_contract(default_ledger_path())["endpoints"]
# requests whose status the reference also gives, though its contract does
# not declare it (compared for status only)
UNDECLARED = {"no documents", "one id"}


def test_statuses_equal_reference(apps):
    assert len(apps.trecords) == len(apps.jrecords)
    got = [(key, note, status) for key, status, _h, _b, note in apps.trecords]
    want = [(key, note, status) for key, status, _h, _b, note in apps.jrecords]
    assert got == want


def test_every_route_is_driven(apps):
    """The scenario drives every route but the profiler's start, which
    ``test_profiler_window_over_http`` drives on the port alone (the
    reference's would open a process-wide jax.profiler trace)."""
    driven = {key for key, *_ in apps.trecords} | {"POST /api/profiler/start"}
    assert driven == set(CONTRACT)


@pytest.mark.parametrize("runtime", ["fake", "decoding"])
def test_responses_pass_the_contract(apps, runtime):
    records = apps.trecords if runtime == "fake" else apps.rrecords
    for key, status, headers, raw, note in records:
        if note in UNDECLARED:
            continue
        entry = CONTRACT[key]
        kind = entry.get("kind")
        ctype = headers.get("Content-Type", "")
        if kind == "html":
            assert status == 200 and ctype.startswith("text/html") and raw, note
        elif kind == "prometheus-text":
            assert status == 200 and raw, note
            assert ctype.startswith(
                "application/openmetrics-text" if note == "openmetrics" else "text/plain"
            ), note
            assert obs.lint_prometheus_text(raw.decode()) == [], note
        elif kind == "sse":
            assert status == 200 and ctype.startswith("text/event-stream"), note
            events = _parse_sse(raw.decode())
            assert events and events[-1][0] == "done", note
            for name, payload in events:
                assert validate_value(payload, entry["events"][name], False) == [], note
        else:
            body = json.loads(raw) if raw else None
            assert validate_response(entry, status, body) == [], (note, body)


DETERMINISTIC = {
    "GET /health", "POST /ask/", "GET /documents/", "GET /documents/{doc_id}",
    "GET /api/search/patient-snippets", "POST /api/llm/summarize",
    "POST /api/synthese/patient", "POST /api/synthese/comparaison",
    "DELETE /documents/{doc_id}", "POST /ingest/",
}


def test_values_equal_reference(apps):
    for (key, status, _h, raw, note), (_k, _s, _jh, jraw, _n) in zip(
        apps.trecords, apps.jrecords
    ):
        if key not in DETERMINISTIC or status != 200:
            continue
        assert _normalize(raw, apps.tdocs) == _normalize(jraw, apps.jdocs), note


def test_routed_and_streamed_answers(apps):
    """On the decoding runtime: the lookup is answered from retrieval
    (``route``), the generative question by the decoder; a stream's deltas
    concatenate to the answer of the same question and end with its
    sources; the deleted document is gone from every later answer."""
    by_note = {note: json.loads(raw) for key, _s, _h, raw, note in apps.rrecords
               if key == "POST /ask/"}
    assert by_note[QUESTIONS[0]]["route"] == "extractive"
    assert "route" not in by_note[QUESTIONS[1]]
    for key, _s, _h, raw, note in apps.rrecords:
        if key != "POST /ask/stream":
            continue
        events = _parse_sse(raw.decode())
        question = QUESTIONS[0] if note == "routed stream" else QUESTIONS[1]
        deltas = "".join(p["delta"] for name, p in events if name == "data")
        assert deltas == by_note[question]["answer"]
        assert events[-1][1]["sources"] == by_note[question]["sources"]
    gone = f"Dossier Patient {apps.rdocs[0]}"
    assert gone in by_note[QUESTIONS[0]]["sources"]
    assert gone not in by_note["after delete"]["sources"]


def test_routing_mix_over_a_real_encoder_equals_reference(apps):
    """With fused retrievers over a real encoder, every question of the
    routing mix gets the reference's status, route, answer and sources:
    under exact serving both retrieve dense, so the evidence gate sees the
    same chunks."""
    assert len(apps.routed) == len(apps.jrouted) == len(MIX)
    routes = []
    for (q, status, raw), (_q, jstatus, jraw) in zip(apps.routed, apps.jrouted):
        assert status == jstatus == 200, q
        got = _normalize(raw, apps.routed_docs)
        assert got == _normalize(jraw, apps.jrouted_docs), q
        routes.append(got.get("route"))
    assert "extractive" in routes and None in routes


DRIFT_NAMES = {
    "retrieve_score_margin", "retrieve_query_norm", "retrieve_tier_ms_bulk_ivf",
    "retrieve_tier_ms_tail_exact", "retrieve_tier_ms_merge", "retrieve_tier_ms_fused_probe",
}


def _assert_drift_shape(tree, jtree):
    """Hold both ``/api/retrieval`` drift sections to the reference's shape,
    then take them (and the NaN paths they may carry) out of both trees."""
    for t in (tree, jtree):
        nonfinite = t.pop("_nonfinite_fields", [])
        assert all(p.startswith("drift.") for p in nonfinite), nonfinite
        drift = t.pop("drift")
        assert set(drift) <= DRIFT_NAMES, drift
        assert all(set(entry) == {"count", "p50", "p95"} for entry in drift.values())


def test_key_trees_equal_reference(apps):
    for key in ("GET /api/status", "GET /api/retrieval"):
        (raw,) = [r for k, _s, _h, r, _n in apps.trecords if k == key]
        (jraw,) = [r for k, _s, _h, r, _n in apps.jrecords if k == key]
        tree, jtree = json.loads(raw), json.loads(jraw)
        if key == "GET /api/status":
            # the spine's and the observatory's internals are the port's
            # own; the surface's shape is equal
            assert set(tree) == set(jtree)
            assert set(tree["breakers"]) == set(jtree["breakers"])
            assert tree["pool"] is None and jtree["pool"] is None
            assert [s["name"] for s in tree["slo"]] == [s["name"] for s in jtree["slo"]]
        else:
            # both payloads are the running observatory's status().  Its
            # drift section names the retrieval histograms the process
            # registry has samples in: which test files of this worker
            # recorded them decides the names on each side (exact serving
            # records none), so the names are held to the six the section
            # reads and each entry's key tree to the reference's
            _assert_drift_shape(tree, jtree)
            assert _keys(tree) == _keys(jtree)
            assert tree["routing"]["enabled"] and tree["serving"]["rows"] == 3
            assert tree["running"] is True and tree["serving"]["index"] is None


def test_concurrent_asks_over_http_equal_sequential(apps):
    questions = QUESTIONS[1:] * 2
    results = [None] * len(questions)

    def ask(i):
        results[i] = apps.call("POST", "/ask/", _j({"question": questions[i]}))

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(questions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    solo = {q: apps.call("POST", "/ask/", _j({"question": q}))[2] for q in QUESTIONS[1:]}
    for q, (status, _h, raw) in zip(questions, results):
        assert status == 200 and json.loads(raw) == json.loads(solo[q])


def test_profiler_window_over_http(apps, tmp_path):
    entry = CONTRACT["POST /api/profiler/start"]
    status, _h, raw = apps.call(
        "POST", "/api/profiler/start", _j({"logdir": str(tmp_path)})
    )
    assert status == 200 and json.loads(raw) == {"profiling": True, "logdir": str(tmp_path)}
    assert validate_response(entry, status, json.loads(raw)) == []
    status, _h, raw = apps.call("POST", "/api/profiler/start", _j({"logdir": str(tmp_path)}))
    assert status == 409 and validate_response(entry, status, json.loads(raw)) == []
    apps.call("POST", "/ask/", _j({"question": QUESTIONS[1]}))
    status, _h, raw = apps.call("POST", "/api/profiler/stop")
    assert status == 200 and json.loads(raw)["profiling"] is False


def test_oversized_body_is_refused(apps):
    req = urllib.request.Request(
        apps.base + "/ask/", data=b"{}", method="POST",
        headers={"Content-Type": "application/json",
                 "Content-Length": str(64 * 1024 * 1024 + 1)},
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 413


@pytest.mark.parametrize("cfg, item", [
    # store.serving_index="tiered" (item 5's tiered retrieval), data.work_dir
    # (item 5's store lifecycle), store.token_width (item 4's fused RAG),
    # the seq2seq summarizer, the checkpoint import (item 7) and the AMQP
    # broker (item 1) are ported: all six now boot past the refusals.  The
    # cases keep the ids they had while refused.
    pytest.param({"store.serving_index": "tiered"}, None, id="cfg0-item 5"),
    pytest.param({"data.work_dir": "/nonexistent"}, None, id="cfg1-item 5"),
    pytest.param({"store.token_width": 8}, None, id="cfg2-item 4"),
    pytest.param({"summarizer.backend": "seq2seq"}, None, id="cfg3-item 7"),
    pytest.param({"encoder.checkpoint_dir": "/nonexistent"}, None, id="cfg4-item 7"),
    # the AMQP broker (item 1) is ported too (tests/test_torch_amqp.py boots
    # a runtime on it)
    pytest.param({"broker.backend": "amqp"}, None, id="cfg5-AMQP"),
    # the runtime on a mesh (item 9b) is ported: a mesh section boots past
    # the refusals (tests/test_torch_mesh_runtime.py serves worlds of 2 and
    # 4 ranks); tiered serving on a mesh is what still refuses (item 9c)
    pytest.param({"mesh.model_parallel": 2}, None, id="cfg6-item 9b"),
    pytest.param({"store.serving_index": "tiered", "mesh.model_parallel": 2},
                 "item 9c", id="cfg7-item 9c"),
])
def test_unported_config_raises_at_boot(cfg, item):
    if item is None:
        refuse_unported(load_config(env={}, overrides=cfg))
        return
    with pytest.raises(NotImplementedError, match=item):
        refuse_unported(load_config(env={}, overrides=cfg))


@pytest.mark.parametrize("payload", [
    {"a": np.float32(1.5), "b": [np.int64(3), float("nan")], 4: {"c": float("inf")}},
    [np.arange(3), np.array([1.0, np.nan])],
    {"x": (1, 2.0, "s", None, True)},
], ids=["nested", "arrays", "tuple"])
def test_to_wire_equals_reference(payload):
    assert to_wire(payload) == j_to_wire(payload)


def test_default_config_boots_past_the_refusals():
    refuse_unported(load_config(env={}))


def _raise(exc):
    def fn(*_a, **_kw):
        raise exc
    return fn


def _ask(question="anything"):
    return Request("POST", "/ask/", body=_j({"question": question}))


@pytest.mark.parametrize("where", ["ask_submit", "resolve", "costs", "profiler", "stream"])
def test_device_fault_in_a_handler_propagates(apps, monkeypatch, where):
    """No 500, no degraded answer, no error event: the fault reaches the
    caller of ``App.handle``.  An ordinary error in the same place keeps
    the reference's handling."""
    app = make_app(apps.rt)
    real = apps.rt.qa.ask_submit
    try:
        for exc, fault in ((KernelError("launch failed"), True),
                           (ValueError("ordinary"), False)):
            monkeypatch.undo()
            if where == "ask_submit":
                monkeypatch.setattr(apps.rt.qa, "ask_submit", _raise(exc))
                call = lambda: app.handle(_ask())  # noqa: E731
            elif where == "resolve":
                def submit(*a, _exc=exc, **kw):
                    pending = real(*a, **kw)
                    pending.handle.text = _raise(_exc)
                    return pending

                monkeypatch.setattr(apps.rt.qa, "ask_submit", submit)
                call = lambda: app.handle(_ask(QUESTIONS[1]))  # noqa: E731
            elif where == "costs":
                monkeypatch.setattr(apps.rt.batcher, "block_seconds", _raise(exc))
                call = lambda: app.handle(Request("GET", "/api/costs"))  # noqa: E731
            elif where == "profiler":
                monkeypatch.setattr(obs.DEFAULT_PROFILER, "start", _raise(exc))
                call = lambda: app.handle(Request("POST", "/api/profiler/start"))  # noqa: E731
            else:
                def submit(*a, _exc=exc, **kw):
                    pending = real(*a, **kw)
                    pending.handle.iter_tokens = _raise(_exc)
                    return pending

                monkeypatch.setattr(apps.rt.qa, "ask_submit", submit)
                call = lambda: list(app.handle(  # noqa: E731
                    Request("POST", "/ask/stream", body=_j({"question": QUESTIONS[1]}))
                ).events)
            if fault:
                with pytest.raises(KernelError):
                    call()
                continue
            if where == "ask_submit":
                with pytest.raises(ValueError):  # the front answers 500
                    call()
            elif where == "resolve":
                out = call()
                assert out.status == 200 and out.payload["degraded"] is True
            elif where == "costs":
                out = call()
                assert out.status == 200 and out.payload["pool_block_seconds"] is None
            elif where == "profiler":
                assert call().status == 500
            else:
                events = b"".join(call()).decode()
                assert _parse_sse(events)[-1][0] == "error"
    finally:
        assert app.close(timeout=10)


def test_device_fault_stops_the_http_front(apps, monkeypatch):
    """Over HTTP the faulting request gets no response, the server keeps
    the fault and stops serving; its threads all end."""
    server = AppServer(make_app(apps.rt)).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _port_call(base, "GET", "/health")[0] == 200
        monkeypatch.setattr(apps.rt.qa, "ask_submit", _raise(KernelError("launch failed")))
        with pytest.raises((urllib.error.URLError, ConnectionError)):
            _port_call(base, "POST", "/ask/", _j({"question": "x"}), timeout=30)
        assert isinstance(server.fault, KernelError)
        server._serve_thread.join(timeout=10)
        assert not server._serve_thread.is_alive()
    finally:
        assert server.close(timeout=10)


def test_warmup_device_fault_is_kept_for_stop(apps, monkeypatch):
    monkeypatch.setattr(apps.rt.batcher, "submit_ids", _raise(KernelError("launch failed")))
    try:
        apps.rt._warmup_decode()
        assert isinstance(apps.rt._warmup_fault, KernelError)
    finally:
        apps.rt._warmup_fault = None


def test_shutdown_joins_every_thread(apps):
    """Last in the module: both runtimes stop, and every thread the port's
    server, lanes and runtime started has ended."""
    server_done, leaked = apps.shutdown()
    assert server_done
    assert leaked == []


def test_key_trees_with_work_dir_and_sidecar_equal_reference(tmp_path):
    """With ``data.work_dir`` and ``store.token_width`` set (the lifecycle
    slice lifted both refusals), the status and retrieval surfaces keep
    the reference's key trees, and both runtimes persist the same files.
    After the module's shutdown test: its thread check counts only the
    module's own runtimes."""
    persisted = {"data.work_dir": None, "store.token_width": 16}
    trees = {}
    threads_before = set(threading.enumerate())
    for side in ("ref", "port"):
        overrides = {**FAKE, **persisted, "data.work_dir": str(tmp_path / side)}
        if side == "ref":
            rt = JDocQARuntime(j_load_config(env={}, overrides=overrides)).start()
            client = _RefClient(rt)
            call, close = client, client.close
        else:
            app = _PortApp(overrides)
            rt, call, close = app.rt, app.call, app.close
        try:
            body = _j({"filename": "n.txt", "text": NOTES[0][4], "patient_id": "p1"})
            assert call("POST", "/ingest/?wait=1", body)[0] == 200
            trees[side] = {key: json.loads(call("GET", key)[2])
                           for key in ("/api/status", "/api/retrieval")}
        finally:
            close()
            if side == "ref":
                rt.stop()
        assert sorted(os.listdir(tmp_path / side)) == ["index", "journal", "registry.db"]
    for t in threading.enumerate():
        if t not in threads_before:
            t.join(timeout=10)
    status, jstatus = trees["port"]["/api/status"], trees["ref"]["/api/status"]
    assert set(status) == set(jstatus)
    assert set(status["breakers"]) == set(jstatus["breakers"])
    retrieval, jretrieval = trees["port"]["/api/retrieval"], trees["ref"]["/api/retrieval"]
    _assert_drift_shape(retrieval, jretrieval)  # why: test_key_trees_equal_reference
    assert _keys(retrieval) == _keys(jretrieval)
    assert retrieval["serving"]["rows"] == jretrieval["serving"]["rows"] == 1


def test_tiered_runtime_answers_the_routing_mix_like_the_reference():
    """``store.serving_index="tiered"`` boots: both runtimes ingest the
    routing mix, build their IVF tier in the background (``ivf_min_rows``
    lowered for the small corpus), and answer every question alike through
    their fused tiered retrievers, the router's lookups hybrid.  nprobe 8
    covers every cell of so small a tier, so the probe plus the exact
    re-rank is exact search whatever the clustering.  ``/api/retrieval`` is
    the running observatory's payload, with the tier's stats, and the
    shadows it drew found recall 1.0.  Both packages' counters, recorders
    and observatory hooks are put back."""
    tiered = {**ENCODED, "store.serving_index": "tiered", "store.ivf_min_rows": 8,
              "retrieval_quality.sample_every": 1}
    saved = ([(rec, _recorder_state(rec)) for rec in (jobs.DEFAULT_RECORDER, obs.DEFAULT_RECORDER)],
             [(reg, _counters(reg))
              for reg in (jmetrics.DEFAULT_REGISTRY, metrics.DEFAULT_REGISTRY)],
             jobs.get_retrieval_observatory(), obs.get_retrieval_observatory(),
             jobs.DEFAULT_COST_LEDGER._pressure_probe)
    results = {}
    try:
        for side in ("ref", "port"):
            if side == "ref":
                rt = JDocQARuntime(j_load_config(env={}, overrides=tiered)).start()
                client = _RefClient(rt)
                call, close = client, client.close
            else:
                app = _PortApp(tiered)
                rt, call, close = app.rt, app.call, app.close
                assert type(rt.qa.retriever).__name__ == "FusedTieredRetriever"
            try:
                asked, docs = _routing_scenario(call)
                deadline = time.time() + 120
                while rt.search_index.covered == 0 and time.time() < deadline:
                    time.sleep(0.05)
                assert rt.search_index.covered == rt.store.count
                # once the tier covers the corpus, the mix again
                again = [call("POST", "/ask/", _j({"question": row["question"]}))
                         for row in MIX]
                assert rt.retrieval_obs.drain(60)
                payload = json.loads(call("GET", "/api/retrieval")[2])
                results[side] = (asked, docs, again, payload)
            finally:
                close()
                if side == "ref":
                    rt.stop()
                else:  # the runtime joined its own workers
                    assert not rt.retrieval_obs.running and not rt.search_index.rebuilding
    finally:
        for rec, state in saved[0]:
            _restore_recorder(rec, state)
        for reg, counts in saved[1]:
            _restore_counters(reg, counts)
        jobs.set_retrieval_observatory(saved[2])
        obs.set_retrieval_observatory(saved[3])
        jobs.DEFAULT_COST_LEDGER.set_pressure_probe(saved[4])
    (jasked, jdocs, jagain, jpayload), (asked, docs, again, payload) = (
        results["ref"], results["port"])
    routes = []
    for (q, status, raw), (_q, jstatus, jraw) in zip(asked, jasked):
        assert status == jstatus == 200, q
        got = _normalize(raw, docs)
        assert got == _normalize(jraw, jdocs), q
        routes.append(got.get("route"))
    assert "extractive" in routes and None in routes
    for (status, _h, raw), (jstatus, _jh, jraw) in zip(again, jagain):
        assert status == jstatus == 200
        assert _normalize(raw, docs) == _normalize(jraw, jdocs)
    assert payload["serving"]["index"]["active"] and jpayload["serving"]["index"]["active"]
    assert payload["serving"]["covered"] == jpayload["serving"]["covered"]
    assert payload["counts"]["shadows"] > 0 and payload["counts"]["errors"] == 0
    assert all(est["recall"] == 1.0 for est in payload["estimates"].values())
    assert set(payload["estimates"]) <= set(jpayload["estimates"]) | {
        f"{t}@nprobe={p}" for t in ("tiered_fused", "hybrid") for p in (0, 8)}
    _assert_drift_shape(payload, jpayload)
    assert _keys(payload) == _keys(jpayload)
