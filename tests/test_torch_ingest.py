"""Port parity, document ingest: docqa_tpu_torch's chunker, extractors,
registry, broker, retry policy, CSV bootstrap and ``DocumentPipeline``
against docqa_tpu's, on the same inputs and the same weights (CPU,
float32; tagger at 2 layers x hidden 64 x 4 heads, 128 positions; MiniLM
stand-in at 2 layers x hidden 64).

Tolerances: host-side results (chunks, extracted text, statuses, broker
deliveries, retry delays, metadata rows, masked text) must be identical.
Embeddings within 1e-5 (float32 on both sides, other summation orders).
Top-k ids identical, with the rule that an id outside the reference's set
must tie the k-th score within 1e-5.

Every pipeline is stopped and every wait takes a timeout, so a bug fails a
test instead of hanging the run.
"""

import dataclasses
import http.server
import threading
import time

import jax
import numpy as np
import pytest
import torch

from docqa_tpu.config import BrokerConfig as JBrokerConfig
from docqa_tpu.config import ChunkConfig as JChunkConfig
from docqa_tpu.config import Config as JConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import NERConfig as JNERConfig
from docqa_tpu.config import ResilienceConfig as JResilienceConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.deid.engine import DeidEngine as JDeidEngine
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.retrieve import FusedRetriever as JFusedRetriever
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.models.ner import init_ner_params as j_init_ner_params
from docqa_tpu.resilience.policy import RetryPolicy as JRetryPolicy
from docqa_tpu.service import bootstrap as jbootstrap
from docqa_tpu.service import broker as jbroker
from docqa_tpu.service import extract as jextract
from docqa_tpu.service import registry as jreg
from docqa_tpu.service.pipeline import DocumentPipeline as JDocumentPipeline
from docqa_tpu.text.chunker import chunk_text as j_chunk_text
from docqa_tpu_torch.config import (
    BrokerConfig,
    ChunkConfig,
    Config,
    EncoderConfig,
    NERConfig,
    ResilienceConfig,
    StoreConfig,
)
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.deid.engine import DeidEngine
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.resilience import BreakerBoard, FaultPlan, FaultRule
from docqa_tpu_torch.resilience.policy import RetryPolicy
from docqa_tpu_torch.service import bootstrap, extract
from docqa_tpu_torch.service import broker as tbroker
from docqa_tpu_torch.service import registry as reg
from docqa_tpu_torch.service.pipeline import DocumentPipeline
from docqa_tpu_torch.text.chunker import chunk_text
from test_registry_pg import _FakePsycopg2
from test_service_plane import _make_docx, _make_pdf

torch.set_num_threads(1)

ENC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
           mlp_dim=128, max_seq_len=128, embed_dim=64, dtype="float32")
NER = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
           mlp_dim=128, max_seq_len=128, dtype="float32")
STORE = dict(dim=64, shard_capacity=128)
BROKER = dict(prefetch=8, max_redelivery=3, retry_backoff_s=0.02)
RESILIENCE = dict(retry_base_delay_s=0.01, retry_max_delay_s=0.05,
                  breaker_reset_s=0.2)
WAIT_S = 60.0
TIE = 1e-5

MONTHS = ["janvier", "février", "mars", "avril", "mai", "juin", "juillet",
          "août", "septembre", "octobre", "novembre", "décembre"]


def header(rng):
    """A header line of pattern-class PHI: phone, email, French date."""
    phone = " ".join(f"{int(rng.integers(0, 100)):02d}" for _ in range(5))
    email = f"dossier{int(rng.integers(1000, 9999))}@chu-{int(rng.integers(1, 99))}.fr"
    date = (f"{int(rng.integers(1, 29))} {MONTHS[int(rng.integers(12))]} "
            f"{int(rng.integers(2015, 2027))}")
    return f"Tél : {phone} — courriel : {email} — consultation du {date}."


def note(rng, min_chars):
    parts = [header(rng)]
    while len("\n".join(parts)) < min_chars:
        parts.append(datagen.generate_example(rng, max_sentences=6)[0])
    return "\n".join(parts)


def corpus(n, seed, min_chars=900):
    """``n`` uploads: notes with PHI headers, two as .docx and two as
    text-layer .pdf (built as the reference's tests build them), one
    unreadable .pdf, the rest .txt; every third with a patient id."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        text = note(rng, min_chars)
        kw = {"patient_id": f"P{i:03d}"} if i % 3 == 0 else {}
        if i in (1, 5):
            docs.append((f"doc{i}.docx", _make_docx(text.split("\n")), kw))
        elif i in (2, 7):
            lines = [ln.replace("(", " ").replace(")", " ") for ln in text.split("\n")]
            docs.append((f"doc{i}.pdf", _make_pdf(lines), kw))
        elif i == 4:
            docs.append((f"doc{i}.pdf", b"%PDF-1.4\n\x00\x01 not a text layer", kw))
        else:
            docs.append((f"doc{i}.txt", text.encode("utf-8"), kw))
    return docs


def _wait_terminal(registry, terminal, doc_ids, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(registry.get(d).status in terminal for d in doc_ids):
            return True
        time.sleep(0.02)
    return False


# ---- chunking and extraction ------------------------------------------------

class TestChunkAndExtract:
    @pytest.mark.parametrize("size,overlap", [(500, 0), (200, 50), (120, 20)])
    def test_chunk_text_identical(self, size, overlap):
        rng = np.random.default_rng(size)
        texts = [note(rng, int(rng.integers(10, 3000))) for _ in range(30)]
        texts += ["", "   \n ", "x" * 1234, "a. " * 400, "mot " * 333]
        for text in texts:
            got = chunk_text(text, ChunkConfig(size, overlap))
            want = j_chunk_text(text, JChunkConfig(size, overlap))
            assert [dataclasses.astuple(c) for c in got] == [
                dataclasses.astuple(c) for c in want]

    def test_extractors_and_diagnosis_identical(self):
        rng = np.random.default_rng(3)
        text = note(rng, 700)
        lines = [ln.replace("(", " ").replace(")", " ") for ln in text.split("\n")]
        scanned = (b"%PDF-1.4\n1 0 obj\n<< /Type /XObject /Subtype /Image "
                   b"/Filter /DCTDecode >>\nstream\n\xff\xd8\xff\xe0JFIF"
                   b"\nendstream\nendobj\n%%EOF")
        cid = (b"%PDF-1.4\n2 0 obj\n<< /Length 44 >>\nstream\n"
               b"BT /F1 12 Tf <00470048004F004F0052> Tj ET\nendstream\nendobj\n%%EOF")
        cases = [
            ("a.txt", text.encode("utf-8")), ("b.txt", text.encode("utf-16")),
            ("c.txt", text.encode("latin-1", errors="replace")),
            ("d.txt", b"\x00\x01\x02binary\xff\xfe" * 20), ("e.txt", b""),
            ("f.docx", _make_docx(text.split("\n"))), ("g.docx", b"not a zip"),
            ("h.pdf", _make_pdf(lines)), ("i.pdf", scanned), ("j.pdf", cid),
            ("k.txt", b"{\\rtf1\\ansi hello}"), ("l.doc", b"\xd0\xcf\x11\xe0" + b"\x00" * 64),
            ("m.bin", text.encode()), ("n.pdf", b"\x00\x01garbage"),
        ]
        for name, data in cases:
            for fallback in (None, lambda _d: "rescued by the fallback"):
                assert extract.extract_text_ex(data, name, fallback) == (
                    jextract.extract_text_ex(data, name, fallback)), name
                assert extract.extract_text(data, name, fallback) == (
                    jextract.extract_text(data, name, fallback)), name
            assert extract.diagnose_unextractable(data, name) == (
                jextract.diagnose_unextractable(data, name)), name
        for fn in ("extract_txt", "extract_docx", "extract_pdf"):
            for _name, data in cases:
                assert getattr(extract, fn)(data) == getattr(jextract, fn)(data)


class _TikaHandler(http.server.BaseHTTPRequestHandler):
    """A Tika-protocol stand-in: records each request, answers in UTF-8 (or
    500 when the body asks for it)."""

    seen = []

    def do_PUT(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.command, self.path, self.headers.get("Accept"), body))
        if body == b"fail":
            self.send_response(500)
            self.end_headers()
            return
        out = f"  extrait : {body.decode('utf-8', 'replace')} é  \n".encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=UTF-8")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *_a):
        pass


def test_http_extractor_against_a_local_server(monkeypatch):
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy",
                "https_proxy", "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _TikaHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/"
        _TikaHandler.seen = []
        got = [extract.make_http_extractor(url)(b) for b in (b"scan 1", b"fail")]
        port_seen = list(_TikaHandler.seen)
        _TikaHandler.seen = []
        want = [jextract.make_http_extractor(url)(b) for b in (b"scan 1", b"fail")]
        assert got == want == ["extrait : scan 1 é", None]
        # the same PUT, path, Accept header and body as the reference's
        assert port_seen == _TikaHandler.seen == [
            ("PUT", "/tika", "text/plain", b"scan 1"),
            ("PUT", "/tika", "text/plain", b"fail"),
        ]
        # a scanned pdf reaches the server and is rescued through the port's path
        scanned = b"%PDF-1.4\n1 0 obj\n<< /Subtype /Image /Filter /DCTDecode >>\n%%EOF"
        text, why = extract.extract_text_ex(scanned, "scan.pdf",
                                            extract.make_http_extractor(url))
        assert text.startswith("extrait : %PDF-1.4") and why is None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


# ---- registry ---------------------------------------------------------------

def _registry_trace(mod, url, pg_module=None):
    """The same operations on a registry; returns what each call returned
    and every row's observable state after it."""
    r = mod.DocumentRegistry(url, pg_module=pg_module)
    trace = []
    ids = []

    def state():
        return [(x.filename, x.status, x.n_chunks, x.status_detail, x.patient_id,
                 x.doc_type, x.doc_date) for x in (r.get(i) for i in ids)]

    for i, (name, kw) in enumerate([
        ("a.txt", dict(patient_id="p1")), ("b.pdf", dict(doc_type="consult")),
        ("c.docx", dict(patient_id="p1", doc_date="2026-01-05")), ("d.txt", {}),
    ]):
        ids.append(r.create(name, **kw).doc_id)
        trace.append(("create", i, state()))
    a, b, c, d = ids
    ops = [
        ("set_status", (a, mod.PROCESSED), {}),
        ("set_status_unless_deleted", (a, mod.DEIDENTIFIED), {}),
        ("set_status_unless_deleted", (a, mod.INDEXED), dict(n_chunks=4)),
        ("set_status", (b, mod.ERROR_EXTRACTION), dict(detail="pdf_scanned_image_only")),
        ("set_status", (b, mod.PROCESSED), {}),  # a retry clears the detail
        ("set_status", (c, mod.DELETED), {}),
        ("set_status_unless_deleted", (c, mod.INDEXED), dict(n_chunks=3)),
        ("set_status_unless_deleted", (c, mod.ERROR_DEID), {}),
        ("set_status_unless_deleted", ("absent-doc", mod.INDEXED), {}),
        ("set_status_unless_deleted", (d, mod.ERROR_INDEXING), {}),
        ("set_status", (a, mod.DELETED), {}),
        ("set_status_unless_deleted", (a, mod.INDEXED), {}),
    ]
    for name, args, kw in ops:
        out = getattr(r, name)(*args, **kw)
        trace.append((name, out, state()))
    trace.append(("get_absent", r.get("absent-doc")))
    listed = lambda **kw: sorted(ids.index(x.doc_id) for x in r.list_documents(**kw))  # noqa: E731
    trace.append(("list", listed(), listed(patient_id="p1"), listed(status=mod.DELETED),
                  len(r.list_documents(limit=2))))
    trace.append(("dict_keys", sorted(r.get(a).to_dict())))
    r.close()
    return trace


@pytest.mark.parametrize("backend", ["sqlite_memory", "sqlite_disk", "postgres_driver"])
def test_registry_sequences_identical(backend, tmp_path):
    def run(mod, tag):
        if backend == "sqlite_memory":
            return _registry_trace(mod, "sqlite://")
        if backend == "sqlite_disk":
            return _registry_trace(mod, f"sqlite:///{tmp_path}/{tag}.db")
        return _registry_trace(mod, "postgresql://u:p@db:5432/x", _FakePsycopg2())

    assert run(reg, "port") == run(jreg, "ref")
    if backend == "sqlite_disk":  # and the port's rows survive a reopen
        r = reg.DocumentRegistry(f"sqlite:///{tmp_path}/port.db")
        assert len(r.list_documents()) == 4
        r.close()


def test_registry_postgres_gated_and_schemes():
    with pytest.raises((RuntimeError, ImportError)):
        reg.DocumentRegistry("postgresql://u@h/db")
    with pytest.raises(ValueError):
        reg.DocumentRegistry("mysql://u@h/db")
    fake = _FakePsycopg2()
    r = reg.DocumentRegistry("postgresql://u@h/db", pg_module=fake)
    assert r._param == "%s" and fake.connections[0].autocommit is True
    r.close()
    assert fake.connections[0].closed


# ---- broker -----------------------------------------------------------------

def _broker_trace(mod, cfg_cls, journal):
    """test_redelivery.py / test_service_plane.py's broker cases as one
    sequence; returns every observable result."""
    cfg = cfg_cls(max_redelivery=3, retry_backoff_s=0.01, prefetch=4)
    out = []
    b = mod.MemoryBroker(cfg)
    for i in range(5):
        b.publish("q", {"i": i}, headers={"x-trace-id": f"t{i}"} if i % 2 else None)
    ds = b.get_many("q", timeout=1)
    out.append([(d.body, d.attempts, d.headers) for d in ds])
    for d in ds[1:]:
        b.ack(d)
    d5 = b.get_many("q", timeout=1)  # the fifth, past the prefetch
    out.append([(d.body, d.attempts, d.headers) for d in d5])
    for d in d5:
        b.ack(d)
    # one poison message through its whole life, headers kept
    poison, attempts, dead = ds[0], [], False
    for _ in range(cfg.max_redelivery + 2):
        attempts.append(poison.attempts)
        dead = b.nack(poison)
        if dead:
            break
        nxt = b.get_many("q", timeout=5)
        out.append([(d.body, d.attempts, d.headers) for d in nxt])
        poison = nxt[0]
    out.append((attempts, dead, b.dead_letters("q"), b.depth("q"), b.in_flight("q"),
                b.get_many("q", timeout=0.05)))
    # backoff: a nacked message is not redeliverable inside its window
    wide = mod.MemoryBroker(cfg_cls(max_redelivery=3, retry_backoff_s=0.3))
    wide.publish("w", {"x": 1}, headers={"h": "v"})
    d = wide.get_many("w", timeout=5)[0]
    wide.nack(d)
    out.append(wide.get_many("w", timeout=0.05))
    d2 = wide.get_many("w", timeout=5)[0]
    out.append((d2.attempts, d2.headers))
    wide.ack(d2)
    wide.close()
    # journal crash replay: acked gone, mid-flight and undelivered back
    j = mod.MemoryBroker(cfg, journal_dir=journal)
    for n in (1, 2, 3):
        j.publish("jq", {"n": n}, headers={"k": n})
    got = j.get_many("jq", max_n=2, timeout=5)
    j.ack(got[0])
    j.publish("dq", {"poison": 1})
    for _ in range(cfg.max_redelivery):
        if j.nack(j.get("dq", timeout=5)):
            break
    for _boot in range(2):  # crash (no close), replay, and replay again
        j2 = mod.MemoryBroker(cfg, journal_dir=journal)
        out.append(("dlq", j2.dead_letters("dq"), j2.get("dq", timeout=0.05)))
    replayed = []
    while True:
        d = j2.get("jq", timeout=0.2)
        if d is None:
            break
        replayed.append((d.body, d.headers))
        j2.ack(d)
    out.append(sorted(replayed, key=lambda x: x[0]["n"]))
    j2.close()
    j3 = mod.MemoryBroker(cfg, journal_dir=journal)
    out.append(j3.get("jq", timeout=0.1))
    j3.close()
    # a consumer isolates the poison message of a batch and dead-letters it
    c_b = mod.MemoryBroker(cfg_cls(max_redelivery=2, retry_backoff_s=0.01, prefetch=8))
    seen, dead_cb = [], []

    def handler(bodies):
        if any(x.get("poison") for x in bodies):
            raise ValueError("poison")
        seen.extend(bodies)

    for i in range(4):
        c_b.publish("cq", {"i": i, "poison": i == 2})
    c = mod.Consumer(c_b, "cq", handler, batch=8, poll_s=0.01, on_dead=dead_cb.append)
    c.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not dead_cb:
        time.sleep(0.01)
    assert c_b.drain("cq", timeout=10)
    c.stop()
    out.append((sorted(x["i"] for x in seen), dead_cb, c_b.dead_letters("cq")))
    c_b.close()
    return out


def test_memory_broker_and_consumer_identical(tmp_path):
    got = _broker_trace(tbroker, BrokerConfig, str(tmp_path / "port"))
    want = _broker_trace(jbroker, JBrokerConfig, str(tmp_path / "ref"))
    assert got == want
    assert got[-1] == ([0, 1, 3], [{"i": 2, "poison": True}], [{"i": 2, "poison": True}])


def test_make_broker_memory_and_amqp_refused():
    assert isinstance(tbroker.make_broker(BrokerConfig()), tbroker.MemoryBroker)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbroker.make_broker(BrokerConfig(backend="amqp"))


@pytest.mark.parametrize("fault", [
    KernelError("flash_attention prefill kernel launch failed: CUDA error 719"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_consumer_stops_on_a_device_fault(fault):
    """A device fault is never retried, nacked, dead-lettered or recorded
    on the breaker: the consumer keeps it, hands it on and stops."""
    b = tbroker.MemoryBroker(BrokerConfig(max_redelivery=2, retry_backoff_s=0.01))
    board = BreakerBoard(failure_threshold=1, reset_timeout_s=30.0)
    calls, faults_seen = [], []

    def handler(bodies):
        calls.append(list(bodies))
        raise fault

    for i in range(3):
        b.publish("q", {"i": i})
    c = tbroker.Consumer(b, "q", handler, batch=8, poll_s=0.01,
                         retry=RetryPolicy(max_attempts=3, base_delay_s=0.001),
                         breaker=board.get("deid"), on_fault=faults_seen.append)
    c.start()
    c.join(timeout=10)
    assert not c.is_alive()
    assert c.error is fault and faults_seen == [fault]
    assert len(calls) == 1  # one attempt: no retry, no one-by-one isolation
    assert b.dead_letters("q") == [] and b.in_flight("q") == 3
    assert board.get("deid").state == "closed"


# ---- retry policy -----------------------------------------------------------

def test_retry_policy_delays_identical():
    for seed in (0, 1, 7, 12345):
        for kw in ({}, dict(jitter=0.0), dict(base_delay_s=0.3, max_delay_s=1.0)):
            p, jp = RetryPolicy(seed=seed, **kw), JRetryPolicy(seed=seed, **kw)
            assert [p.delay(a) for a in range(1, 9)] == [jp.delay(a) for a in range(1, 9)]

    def schedule(policy, exc):
        pauses, calls = [], []

        def fn():
            calls.append(1)
            raise exc

        with pytest.raises(type(exc)):
            policy.call(fn, name="t", sleep=pauses.append)
        return len(calls), pauses

    for exc in (OSError("io"), ValueError("deterministic")):
        got = schedule(RetryPolicy(max_attempts=4, seed=3, retry_on=(OSError,)), exc)
        want = schedule(JRetryPolicy(max_attempts=4, seed=3, retry_on=(OSError,)), exc)
        assert got == want
    # a device fault is never retried and never fed to the breaker
    board = BreakerBoard(failure_threshold=1)
    n, pauses = schedule(RetryPolicy(max_attempts=4), KernelError("launch failed"))
    assert (n, pauses) == (1, [])
    with pytest.raises(KernelError):
        RetryPolicy(max_attempts=4).call(
            lambda: (_ for _ in ()).throw(KernelError("x")), breaker=board.get("b"),
            sleep=lambda _s: None)
    assert board.get("b").state == "closed"


# ---- the pipeline -------------------------------------------------------------

@pytest.fixture(scope="module")
def tagger():
    jparams = j_init_ner_params(jax.random.PRNGKey(5), JNERConfig(**NER))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def _port_pipeline(tagger, breakers=None, deid=None, encoder=None, store=None,
                   registry=None, broker=None, **cfg_kw):
    cfg = Config(encoder=EncoderConfig(**ENC), ner=NERConfig(**NER),
                 store=StoreConfig(**STORE),
                 broker=BrokerConfig(**BROKER),
                 resilience=ResilienceConfig(**RESILIENCE), **cfg_kw)
    return DocumentPipeline(
        cfg,
        broker or tbroker.make_broker(cfg.broker),
        registry or reg.DocumentRegistry(),
        deid or DeidEngine(cfg.ner, params=tagger[1], ner_threshold=0.0, device="cpu"),
        encoder or EncoderEngine(cfg.encoder, seed=1, device="cpu"),
        store or VectorStore(cfg.store, device="cpu"),
        breakers=breakers,
    )


def _ingest_all(pipe, docs):
    ids = []
    for name, data, kw in docs:
        ids.append(pipe.ingest_document(name, data, **kw).doc_id)
    return ids


class TestPipelineParity:
    """The slice as a whole: 24 uploads through the reference's
    DocumentPipeline (JAX engines, float32) and the port's, with the same
    tagger and encoder weights.  Uploads are queued before the workers
    start, so both stores take the rows in upload order."""

    @pytest.fixture(scope="class")
    def runs(self, tagger):
        docs = corpus(24, seed=17)
        jcfg = JConfig(encoder=JEncoderConfig(**ENC), ner=JNERConfig(**NER),
                       store=JStoreConfig(**STORE), broker=JBrokerConfig(**BROKER),
                       resilience=JResilienceConfig(**RESILIENCE))
        jpipe = JDocumentPipeline(
            jcfg, jbroker.MemoryBroker(jcfg.broker), jreg.DocumentRegistry(),
            JDeidEngine(jcfg.ner, params=tagger[0], ner_threshold=0.0),
            JEncoderEngine(jcfg.encoder, seed=1), JVectorStore(jcfg.store),
        )
        tpipe = _port_pipeline(tagger)
        out = {}
        for tag, pipe in (("ref", jpipe), ("port", tpipe)):
            ids = _ingest_all(pipe, docs)
            pipe.start()
            try:
                assert _wait_terminal(pipe.registry, pipe._TERMINAL, ids)
            finally:
                pipe.stop()
            out[tag] = (pipe, ids)
        return docs, out

    def test_statuses_and_chunk_counts_identical(self, runs):
        _docs, out = runs
        (jp, jids), (tp, tids) = out["ref"], out["port"]
        want = [(jp.registry.get(d).status, jp.registry.get(d).n_chunks,
                 jp.registry.get(d).status_detail) for d in jids]
        got = [(tp.registry.get(d).status, tp.registry.get(d).n_chunks,
                tp.registry.get(d).status_detail) for d in tids]
        assert got == want
        statuses = [s for s, _n, _d in got]
        assert statuses.count(reg.INDEXED) == 23 and statuses[4] == reg.ERROR_EXTRACTION
        assert sum(n for _s, n, _d in got) == tp.store.count > 23 * 2

    def test_rows_and_masked_text_identical(self, runs):
        docs, out = runs
        (jp, jids), (tp, tids) = out["ref"], out["port"]
        rename = dict(zip(jids, tids))

        def mapped(row):  # doc ids are per-upload uuids: map the reference's
            row = dict(row)
            if row["source"] == f"Dossier Patient {row['doc_id']}":
                row["source"] = f"Dossier Patient {rename[row['doc_id']]}"
            row["doc_id"] = rename[row["doc_id"]]
            return row

        got = tp.store.metadata_rows()
        assert got == [mapped(r) for r in jp.store.metadata_rows()]
        assert {r["doc_id"] for r in got} == set(tids) - {tids[4]}
        # no header email survives, and the tagger (threshold 0) masked words
        assert not any("@chu-" in r["text_content"] for r in got)
        assert any("<PERSON>" in r["text_content"] for r in got)
        del docs

    def test_embeddings_and_topk_identical(self, runs):
        _docs, out = runs
        (jp, _), (tp, _) = out["ref"], out["port"]
        n = tp.store.count
        np.testing.assert_allclose(tp.store._host[:n], jp.store._host[:n], atol=TIE, rtol=0)
        rows = tp.store.metadata_rows()
        queries = [rows[i]["text_content"] for i in (0, 5, 17, 30)] + [
            "patient transféré", "allergie pénicilline", "Methodist congregation",
            "tension artérielle"]
        want = JFusedRetriever(jp.encoder, jp.store).search_texts(queries, k=5)
        got = FusedRetriever(tp.encoder, tp.store, device="cpu").search_texts(queries, k=5)
        for w, g in zip(want, got):
            assert len(w) == len(g) == 5
            np.testing.assert_allclose([h.score for h in g], [h.score for h in w], atol=TIE)
            kth, w_ids = w[-1].score, {h.row_id for h in w}
            for h in g:
                assert h.row_id in w_ids or abs(h.score - kth) < TIE
        for i, q in zip((0, 5, 17, 30), queries):  # a chunk finds itself first
            assert got[queries.index(q)][0].metadata["text_content"] == rows[i]["text_content"]


@pytest.mark.parametrize("stage", ["deid", "index"])
def test_document_deleted_in_flight_is_never_indexed(tagger, stage):
    """A DELETE (``suppress_doc`` + a DELETED row, as the app's delete path
    writes them) landing while the document's batch is inside the tagger
    or the encoder: its rows never reach the store and it never reads
    INDEXED; its batch-mates index as usual."""
    pipe = _port_pipeline(tagger)
    gate, entered = threading.Event(), threading.Event()
    target = pipe.deid if stage == "deid" else pipe.encoder
    name = "deidentify_batch" if stage == "deid" else "encode_texts"
    inner = getattr(target, name)

    def gated(*a, **k):
        entered.set()
        assert gate.wait(WAIT_S)
        return inner(*a, **k)

    setattr(target, name, gated)
    docs = corpus(3, seed=23)
    ids = _ingest_all(pipe, docs)
    pipe.start()
    try:
        assert entered.wait(WAIT_S)
        victim = ids[1]
        pipe.suppress_doc(victim)
        pipe.registry.set_status(victim, reg.DELETED)
        gate.set()
        assert _wait_terminal(pipe.registry, pipe._TERMINAL, ids)
        assert pipe.broker.drain(pipe.cfg.broker.clean_queue, timeout=WAIT_S)
        assert not pipe.wait_indexed(victim, timeout=1)
    finally:
        pipe.stop()
    statuses = [pipe.registry.get(d).status for d in ids]
    assert statuses == [reg.INDEXED, reg.DELETED, reg.INDEXED]
    docs_in_store = {r["doc_id"] for r in pipe.store.metadata_rows()}
    assert docs_in_store == {ids[0], ids[2]}


def test_replayed_indexed_message_adds_no_rows(tagger, tmp_path):
    """At-least-once delivery: a clean-queue message redelivered after its
    document was indexed (journal replay after a crash, with a pipeline
    rebuilt over the same store) adds no rows and leaves it INDEXED."""
    journal = str(tmp_path / "journal")
    store = VectorStore(StoreConfig(**STORE), device="cpu")
    registry = reg.DocumentRegistry()
    pipe = _port_pipeline(tagger, store=store, registry=registry,
                          broker=tbroker.make_broker(BrokerConfig(**BROKER), journal))
    [doc] = _ingest_all(pipe, corpus(1, seed=29))
    pipe.start()
    try:
        assert pipe.wait_indexed(doc, timeout=WAIT_S)
    finally:
        pipe.stop()
    rows = store.count
    body = {"doc_id": doc, "original_text_masked": "replayed text " * 80,
            "metadata": {"filename": "doc0.txt"}, "processed_at": time.time()}
    crashed = tbroker.make_broker(BrokerConfig(**BROKER), journal)
    crashed.publish(BrokerConfig().clean_queue, body)  # delivered, then a crash
    crashed.get(BrokerConfig().clean_queue, timeout=1)
    replay = tbroker.make_broker(BrokerConfig(**BROKER), journal)
    assert replay.depth(BrokerConfig().clean_queue) == 1
    pipe2 = _port_pipeline(tagger, store=store, registry=registry, broker=replay,
                           encoder=pipe.encoder, deid=pipe.deid)
    pipe2.start()
    try:
        assert replay.drain(BrokerConfig().clean_queue, timeout=WAIT_S)
    finally:
        pipe2.stop()
    assert store.count == rows and registry.get(doc).status == reg.INDEXED


def test_bootstrap_csv_dir_identical(tmp_path):
    (tmp_path / "matrice_test.csv").write_text(
        "nom_syndrome,nom_latin,nom_chinois,score_role\n"
        "Vide de Qi,Astragalus membranaceus,Huang Qi,9\n"
        "Vide de Qi,Panax ginseng,Ren Shen,8\n"
        "Stagnation,,Chai Hu,\n", encoding="utf-8")
    (tmp_path / "autre.csv").write_text(
        "symptome,plante,remarque\nfatigue,ginseng,  \n,, \ninsomnie,jujube,le soir\n",
        encoding="utf-8")
    (tmp_path / "ignored.txt").write_text("not a csv")
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    jstore = JVectorStore(JStoreConfig(**STORE))
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    tstore = VectorStore(StoreConfig(**STORE), device="cpu")
    n_want = jbootstrap.bootstrap_csv_dir(str(tmp_path), jenc, jstore)
    n_got = bootstrap.bootstrap_csv_dir(str(tmp_path), tenc, tstore)
    assert n_got == n_want == tstore.count >= 4
    assert tstore.metadata_rows() == jstore.metadata_rows()
    np.testing.assert_allclose(tstore._host[:n_got], jstore._host[:n_got], atol=TIE, rtol=0)
    row = {"nom_syndrome": "Vide de Qi", "nom_latin": "Panax", "score_role": "7"}
    assert bootstrap.row_to_sentence("matrice_x.csv", row) == (
        jbootstrap.row_to_sentence("matrice_x.csv", row))


def test_seeded_fault_plan_loses_no_document(tagger):
    """scripts/chaos_smoke.py's rule on the port: under seeded faults at
    extract, deid, index and broker.publish every upload ends INDEXED with
    its rows, or in a terminal ERROR_*; both queues end empty."""
    breakers = BreakerBoard(failure_threshold=5, reset_timeout_s=0.2)
    pipe = _port_pipeline(tagger, breakers=breakers)
    plan = FaultPlan([
        FaultRule("extract", p=0.2), FaultRule("broker.publish", p=0.2),
        FaultRule("deid", p=0.3), FaultRule("index", p=0.3),
    ], seed=11)
    docs = [(f"chaos_{i}.txt", f"Patient p{i} sous lisinopril {10 * (i + 1)} mg. "
             f"Tél 06 12 34 56 {i:02d}. Suivi dans trois mois.".encode() * 12,
             {"patient_id": f"p{i}"}) for i in range(12)]
    raw, clean = pipe.cfg.broker.raw_queue, pipe.cfg.broker.clean_queue
    pipe.start()
    try:
        with plan:
            ids = _ingest_all(pipe, docs)
            assert _wait_terminal(pipe.registry, pipe._TERMINAL, ids)
            assert pipe.broker.drain(raw, WAIT_S) and pipe.broker.drain(clean, WAIT_S)
    finally:
        pipe.stop()
    assert len(plan.log) > 0
    statuses = {d: pipe.registry.get(d) for d in ids}
    rows = {}
    for r in pipe.store.metadata_rows():
        rows[r["doc_id"]] = rows.get(r["doc_id"], 0) + 1
    for d, rec in statuses.items():
        assert rec.status == reg.INDEXED or rec.status.startswith("ERROR_"), rec
        if rec.status == reg.INDEXED:
            assert rows.get(d) == rec.n_chunks > 0
    assert sum(pipe.broker.depth(q) + pipe.broker.in_flight(q) for q in (raw, clean)) == 0
    assert sum(s.status == reg.INDEXED for s in statuses.values()) >= 6


@pytest.mark.parametrize("stage", ["deid", "index"])
def test_device_fault_propagates_out_of_wait_indexed(tagger, stage):
    """A kernel fault inside the tagger's forward (or a CUDA error in the
    encoder) is never retried, never dead-lettered and never written as
    ERROR_DEID / ERROR_INDEXING: the worker stops, and ``wait_indexed`` and
    ``stop`` raise the original error."""
    breakers = BreakerBoard(failure_threshold=1, reset_timeout_s=30.0)
    pipe = _port_pipeline(tagger, breakers=breakers)
    calls = []
    if stage == "deid":
        fault = KernelError("flash_attention prefill kernel launch failed: CUDA error 719")

        def broken(*_a, **_k):
            calls.append(1)
            raise fault

        pipe.deid.ner_logits = broken
    else:
        fault = RuntimeError("CUDA error: an illegal memory access was encountered")

        def broken(*_a, **_k):
            calls.append(1)
            raise fault

        pipe.encoder.encode_ids = broken
    [doc] = _ingest_all(pipe, corpus(1, seed=31))
    pipe.start()
    try:
        with pytest.raises(type(fault)) as err:
            pipe.wait_indexed(doc, timeout=WAIT_S)
        assert err.value is fault and pipe.fault is fault
    finally:
        with pytest.raises(type(fault)):
            pipe.stop()
    status = pipe.registry.get(doc).status
    assert status == (reg.PROCESSED if stage == "deid" else reg.DEIDENTIFIED)
    assert len(calls) == 1
    queue = pipe.cfg.broker.raw_queue if stage == "deid" else pipe.cfg.broker.clean_queue
    assert pipe.broker.dead_letters(queue) == []
    assert breakers.get(stage).state == "closed"
    assert pipe.store.count == 0
