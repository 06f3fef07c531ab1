"""Port parity, the Tier-B wire audit: ``docqa_tpu_torch/analysis/
wire_audit.py`` held against ``docqa_tpu/analysis/wire_audit.py`` and run
live.

* The fake-mode audit (canned answers, hash embeddings, the CPU): one
  runtime for the module drives all 29 routes over HTTP on 127.0.0.1 port
  0; coverage 29/29 both ways between the driven set, the app's route
  table and the contract, 0 violations (server-sent events included), the
  broker journal round trip, the report written.  A drifted contract turns
  a focused run red.
* The audit's pieces against the reference's on the same inputs:
  ``validate_value``, the SSE parser, ``render_api_md`` (equal to the
  reference's rendering and to its committed ``docs/API.md``), the journal
  round trip on each package's broker.
* The shed taxonomy's statuses are what the port's app serves: each
  ledgered class raised where it surfaces (admission for 503 / 504,
  the decode wait for the degraded 200s) through ``App.handle``.
* The live audit against a decoding runtime (a 2-layer float32 decoder
  behind a one-replica pool) with both runtime witnesses installed, in a
  child process, as ``chip_smoke.py`` phase 19 runs it on the card: the
  pool's control plane and the profiler answer 200, the witnesses still
  quiesce with no cycle, blind spot or leak, and every redundant retire the
  ledger witness counts is the trace-completion fallback
  (``FlightRecorder.complete``) after the completion path retired the
  record: a guard, not a second terminal path.

The module's runtimes count requests (503s and 504s among them) into the
port's metrics registry and traces into its flight recorder; both are put
back as they were when it ends, since a later runtime in the same worker
reads its SLOs' windows from those counters.
"""

import copy
import json
import os
import subprocess
import sys

import pytest

from docqa_tpu.analysis import wire_audit as j_audit
from docqa_tpu.analysis.wire_schema import default_ledger_path as j_contract_path
from docqa_tpu_torch.analysis import wire_audit
from docqa_tpu_torch.analysis.__main__ import main as lint_main
from docqa_tpu_torch.analysis.core import package_dir
from docqa_tpu_torch.analysis.wire_schema import default_ledger_path, load_contract

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = load_contract(default_ledger_path())
CHILD_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _restore_process_state():
    from docqa_tpu_torch import obs
    from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

    rec = obs.DEFAULT_RECORDER
    with rec._lock:
        saved_rec = (dict(rec._open), list(rec._ring), list(rec._anomalous),
                     list(rec._durations), rec.anomalous_total)
    with DEFAULT_REGISTRY._lock:
        saved = {name: c.value for name, c in DEFAULT_REGISTRY.counters.items()}
    probe = obs.DEFAULT_COST_LEDGER._pressure_probe
    yield
    obs.DEFAULT_COST_LEDGER._pressure_probe = probe
    with DEFAULT_REGISTRY._lock:
        counters = list(DEFAULT_REGISTRY.counters.items())
    for name, c in counters:
        with c._lock:
            c._value = saved.get(name, 0)
    open_, ring, anomalous, durations, total = saved_rec
    with rec._lock:
        rec._open.clear()
        rec._open.update(open_)
        for dq, items in ((rec._ring, ring), (rec._anomalous, anomalous),
                          (rec._durations, durations)):
            dq.clear()
            dq.extend(items)
        rec.anomalous_total = total


@pytest.fixture(scope="module")
def audit_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("wire") / "report.json"
    report = wire_audit.run_wire_audit(device="cpu", report_path=str(path))
    return report, path


def test_contract_is_the_shared_one():
    assert default_ledger_path() == j_contract_path() == os.path.join(REPO, "api_contract.json")
    assert len(CONTRACT["endpoints"]) == 29


def test_fake_mode_audit_green(audit_report):
    report, _ = audit_report
    bad = {k: r["violations"] for k, r in report["endpoints"].items() if r["violations"]}
    assert report["ok"] and report["violations_total"] == 0, bad


def test_fake_mode_audit_full_coverage(audit_report):
    cov = audit_report[0]["coverage"]
    assert cov["checked"]
    assert cov["registered"] == cov["driven"] == cov["declared"] == 29
    for key in ("not_driven", "not_registered", "undeclared_routes", "stale_entries"):
        assert cov[key] == [], key


def test_fake_mode_audit_validates_the_stream_and_the_statuses(audit_report):
    report, _ = audit_report
    ep = report["endpoints"]
    assert ep["POST /ask/stream"]["status"] == 200
    assert ep["POST /ask/"]["status"] == 200
    # no decoding pool and no witnesses in fake mode: the contract's 404s
    for key in ("GET /api/pool", "POST /api/pool/drain", "POST /api/pool/resume",
                "POST /api/pool/rolling_restart", "GET /api/witness", "GET /api/ledger"):
        assert ep[key]["status"] == 404, key
        assert 404 in CONTRACT["endpoints"][key].get("statuses", [200])
    assert ep["POST /api/profiler/start"]["status"] == 200
    assert ep["POST /api/profiler/stop"]["status"] == 200
    assert report["excepted_keys"]["GET /api/status"]["mesh"]


def test_report_artifact_written(audit_report):
    report, path = audit_report
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk["ok"] == report["ok"] and sorted(on_disk["endpoints"]) == sorted(
        CONTRACT["endpoints"])


def test_journal_roundtrip_green(audit_report):
    assert audit_report[0]["journal"] == {"ok": True, "violations": []}


def test_drifted_contract_turns_the_audit_red():
    drifted = copy.deepcopy(CONTRACT)
    drifted["endpoints"]["GET /health"]["response"]["uptime_s"] = "float"
    report = wire_audit.run_wire_audit(device="cpu", only=["GET /health"],
                                       contract=drifted, skip_journal=True)
    assert not report["ok"]
    assert report["endpoints"]["GET /health"]["violations"] == [
        "$: missing required key 'uptime_s'"]
    assert report["coverage"] == {"checked": False}


# ---------------------------------------------------------------------------
# the audit's pieces against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,spec,open_", [
    ("x", "str", False), (1, "int", False), (True, "int", False), (1.5, "number", False),
    (None, "str|null", False), ("x", "int|float", False),
    ({"a": 1, "b?": 2}, {"a": "int", "b?": "int"}, False),
    ({"a": 1}, {"a": "int", "b": "str"}, False),
    ({"a": 1, "z": 3}, {"a": "int"}, False), ({"a": 1, "z": 3}, {"a": "int"}, True),
    ({"a": 1, "_nonfinite_fields": ["a"]}, {"a": "int"}, False),
    ({"k": {"x": [1, "2"]}}, {"k": {"*": ["int"]}}, False),
    ([{"a": 1}, {"a": "s"}], [{"a": "int"}], False), ("x", ["int"], False),
    (3, {"a": "int"}, False), (3, 7, False),
])
def test_validate_value_equals_reference(value, spec, open_):
    assert wire_audit.validate_value(value, spec, open_) == j_audit.validate_value(
        value, spec, open_)


@pytest.mark.parametrize("key", sorted(CONTRACT["endpoints"]))
def test_validate_response_equals_reference(key):
    entry = CONTRACT["endpoints"][key]
    for status, body in ((200, {}), (404, {"detail": "x"}), (503, {"nope": 1}), (418, None)):
        assert wire_audit.validate_response(entry, status, body) == (
            j_audit.validate_response(entry, status, body))


def test_sse_parser_equals_reference():
    text = ('data: {"delta": "a"}\n\ndata: {"delta": "b"}\n\nevent: done\n'
            'data: {"sources": ["s"]}\n\nevent: error\ndata: not json\n\n')
    assert wire_audit._parse_sse(text) == j_audit._parse_sse(text)
    assert [n for n, _ in wire_audit._parse_sse(text)] == ["data", "data", "done", "error"]


def test_api_document_equals_reference_and_docs():
    text = wire_audit.render_api_md(CONTRACT)
    assert text == j_audit.render_api_md(CONTRACT)
    with open(j_audit.default_api_md_path(), encoding="utf-8") as f:
        assert text == f.read()


def test_cli_prints_the_api_document(capsys):
    assert lint_main(["--api-md"]) == 0
    assert capsys.readouterr().out == wire_audit.render_api_md(CONTRACT)


def test_cli_wire_audit_exit_codes(audit_report, monkeypatch, capsys):
    report, _ = audit_report
    calls = []

    def fake(device, report_path):
        calls.append((device, report_path))
        return copy.deepcopy(report)

    monkeypatch.setattr(wire_audit, "run_wire_audit", fake)
    assert lint_main(["--wire-audit", "--device", "cpu"]) == 0
    assert calls == [("cpu", None)]
    assert "29/29 routes driven, 29 declared, 0 violation(s), journal ok" in (
        capsys.readouterr().out)
    red = copy.deepcopy(report)
    red["ok"] = False
    red["violations_total"] = 1
    red["endpoints"]["GET /health"]["violations"] = ["$: missing required key 'x'"]
    monkeypatch.setattr(wire_audit, "run_wire_audit", lambda **kw: red)
    assert lint_main(["--wire-audit", "--device", "cpu"]) == 1
    assert "GET /health [200]: $: missing required key 'x'" in capsys.readouterr().out


@pytest.mark.parametrize("side", ["port", "reference"])
def test_journal_roundtrip_standalone(side, tmp_path):
    fn = wire_audit.journal_roundtrip if side == "port" else j_audit.journal_roundtrip
    assert fn(journal_dir=str(tmp_path), contract=CONTRACT) == {"ok": True, "violations": []}


@pytest.mark.parametrize("side", ["port", "reference"])
def test_journal_spec_violation_flagged(side, tmp_path):
    fn = wire_audit.journal_roundtrip if side == "port" else j_audit.journal_roundtrip
    contract = copy.deepcopy(CONTRACT)
    contract["journal_record"] = {"op": "int", "tag": "int"}
    got = fn(journal_dir=str(tmp_path), contract=contract)
    assert not got["ok"] and got["violations"][0].startswith("journal[0].op: expected int")


# ---------------------------------------------------------------------------
# the taxonomy's statuses are the app's
# ---------------------------------------------------------------------------


def _taxonomy():
    with open(os.path.join(package_dir(), "analysis", "shed_taxonomy.json")) as f:
        return json.load(f)["sheds"]


@pytest.fixture(scope="module")
def fake_app():
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import DocQARuntime, Request, make_app

    rt = DocQARuntime(load_config(env={}, overrides=dict(wire_audit.FAKE_OVERRIDES)),
                      device="cpu").start()
    app = make_app(rt)
    try:
        resp = app.handle(Request(
            "POST", "/ingest/", query={"wait": "1"},
            headers={"content-type": "application/json"},
            body=json.dumps({"filename": "n.txt", "text": wire_audit._DOC_TEXT}).encode()))
        assert resp.status == 200 and rt.store.count > 0, resp.payload
        yield rt, app, Request
    finally:
        app.close()
        rt.stop()


def _shed(name):
    import importlib

    entry = _taxonomy()[name]
    cls = getattr(importlib.import_module(entry["module"]), name)
    return cls("injected") if name != "DeadlineExceeded" else cls("injected", 0.1)


@pytest.mark.parametrize("name", sorted(_taxonomy()))
def test_taxonomy_status_is_what_the_app_serves(fake_app, name, monkeypatch):
    from docqa_tpu_torch.service.qa import PendingAnswer

    rt, app, Request = fake_app
    status = _taxonomy()[name]["http_status"]
    assert rt.store.count > 0
    if name == "EmptyStoreError":
        # the app's surface for an empty index is its admission check
        monkeypatch.setattr(type(rt.store), "count", property(lambda self: 0))
    elif status in (503, 504):
        def submit(*a, **kw):
            raise _shed(name)

        monkeypatch.setattr(rt.qa, "ask_submit", submit)
    else:
        class Handle:
            def text(self, tokenizer, timeout):
                raise _shed(name)

        monkeypatch.setattr(rt.qa, "ask_submit", lambda *a, **kw: PendingAnswer(
            sources=["s"], handle=Handle(), chunks=["the retrieved chunk"]))
    resp = app.handle(Request("POST", "/ask/", body=json.dumps(
        {"question": "aspirin dose?"}).encode()))
    assert resp.status == status, (name, resp.payload)
    if status == 200:
        assert resp.payload["degraded"] is True
    assert wire_audit.validate_response(
        CONTRACT["endpoints"]["POST /ask/"], resp.status, resp.payload) == []


# ---------------------------------------------------------------------------
# the live audit against a decoding runtime, under both witnesses
# ---------------------------------------------------------------------------

CHILD = r"""
import json, sys
root, out_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from docqa_tpu_torch.analysis import ledger_audit, race_witness
race_witness.install_witness()
ledger_audit.install_ledger_witness()
import torch
torch.set_num_threads(1)
from docqa_tpu_torch.analysis.wire_audit import run_wire_audit
from docqa_tpu_torch.config import load_config
from docqa_tpu_torch.service.app import DocQARuntime

cfg = load_config(env={}, overrides={
    "encoder.embed_dim": 64, "store.dim": 64, "store.shard_capacity": 256,
    "store.dtype": "float32", "flags.use_fake_encoder": True,
    "ner.hidden_dim": 32, "ner.num_layers": 1, "ner.num_heads": 2,
    "ner.mlp_dim": 64, "ner.train_steps": 0,
    "decoder.hidden_dim": 64, "decoder.num_layers": 2, "decoder.num_heads": 4,
    "decoder.num_kv_heads": 2, "decoder.head_dim": 16, "decoder.mlp_dim": 128,
    "decoder.vocab_size": 512, "decoder.max_seq_len": 512, "decoder.dtype": "float32",
    "generate.max_new_tokens": 8, "generate.max_concurrent": 2,
    "generate.prefill_buckets": (64, 128, 256, 512),
    "summarizer.max_summary_tokens": 8, "summarizer.max_input_tokens": 448,
    "pool.canary_interval_s": 3600.0, "resilience.request_deadline_s": 0.0,
    "qos.defer_batch_on_burn": False,
})
rt = DocQARuntime(cfg, device="cpu").start()
try:
    report = run_wire_audit(rt=rt, timeout=120)
finally:
    rt.stop()
with open(out_path, "w") as f:
    json.dump({"report": report,
               "witness": race_witness.witness_snapshot(),
               "ledger": ledger_audit.ledger_snapshot()}, f)
"""


@pytest.fixture(scope="module")
def witnessed_audit(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("witnessed_audit")
    out = tmp / "out.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("DOCQA_RACE_WITNESS", "DOCQA_LEDGER_WITNESS", "PYTHONPATH")}
    proc = subprocess.run([sys.executable, "-c", CHILD, REPO, str(out)],
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT,
                          env=env, cwd=str(tmp))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def test_live_audit_on_a_decoding_runtime_green(witnessed_audit):
    report = witnessed_audit["report"]
    bad = {k: r["violations"] for k, r in report["endpoints"].items() if r["violations"]}
    assert report["ok"], bad
    ep = report["endpoints"]
    for key in ("GET /api/pool", "POST /api/pool/drain", "POST /api/pool/resume",
                "POST /api/pool/rolling_restart", "GET /api/witness", "GET /api/ledger",
                "POST /api/profiler/start", "POST /api/profiler/stop",
                "POST /api/llm/summarize", "POST /api/synthese/patient",
                "POST /api/synthese/comparaison", "POST /ask/", "POST /ask/stream"):
        assert ep[key]["status"] == 200, (key, ep[key])


def test_live_audit_leaves_the_witnesses_clean(witnessed_audit):
    w, led = witnessed_audit["witness"], witnessed_audit["ledger"]
    assert w["cycles"] == [] and w["edges_missing_from_static"] == []
    assert led["leaked_tables"] == [] and led["unretired_records"] == []
    assert led["sites_missing_from_static"] == []
    assert led["counts"]["records_opened"] == led["counts"]["records_retired"] > 0


def test_every_redundant_retire_is_the_trace_fallback(witnessed_audit):
    """retire-once: the redundant retires the ledger witness counts (phase
    19 counted 8) all come from ``FlightRecorder.complete``, the declared
    fallback, after the completion path (``serve._finish``) retired the
    record first; none is a second terminal path."""
    led = witnessed_audit["ledger"]
    sites = led["redundant_retire_sites"]
    n = led["counts"]["records_retire_redundant"]
    assert n > 0 and sum(s["events"] for s in sites) == n
    recorder = os.path.join(REPO, "docqa_tpu_torch", "obs", "recorder.py")
    with open(recorder) as f:
        lines = f.read().splitlines()
    for s in sites:
        path, _, line = s["site"].rpartition(":")
        assert path == recorder, s
        assert "DEFAULT_COST_LEDGER.retire(" in lines[int(line) - 1], s
