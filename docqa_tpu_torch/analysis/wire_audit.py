"""Tier B wire audit: the contract enforced over real HTTP, counterpart of
``docqa_tpu/analysis/wire_audit.py``.

The static wire rules reason about dict literals; this module drives every
route of the port's app (``service/app.py``'s route table, served by its
stdlib front on 127.0.0.1 port 0) over a real socket and validates each
live response — status code, key tree and JSON leaf types — against
``api_contract.json``.  Three measured gates:

* **endpoint coverage** — the driven set, the app's route table and the
  contract's entries agree exactly (100 % both ways);
* **response validation** — 200 JSON bodies against the entry's
  ``response`` tree (``open`` entries tolerate extras), other statuses
  against the shared ``{"detail": str}`` error shape, ``kind`` routes
  (html, prometheus-text, sse) against their media type, server-sent
  events one by one.  A key the profile's ``wire_key_exceptions`` names
  for a route (``mesh`` on ``/api/status``, present only on a mesh of
  ranks) is set aside, with its reason, before validation;
* **journal round trip** — a broker journal is written by the port's
  ``MemoryBroker``, the broker is torn down, and a fresh one replays it:
  surviving depth, body equality and each record's ``journal_record``
  conformance are checked across the simulated restart.

:func:`run_wire_audit` boots a fake-mode runtime (canned LLM answers, hash
embeddings) on ``device`` — or drives a runtime the caller already runs
(``rt=``, the card smoke's real one) — and returns the report;
``python -m docqa_tpu_torch.analysis --wire-audit`` runs it from the
command line.  :func:`render_api_md` renders the reference's API document
from the same contract, byte for byte.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from docqa_tpu_torch.analysis.core import PORT_PROFILE, AnalysisProfile
from docqa_tpu_torch.analysis.wire_schema import (
    LEDGER_NAME,
    default_ledger_path,
    load_contract,
)

_SCALARS = {
    "str": (str,),
    "int": (int,),
    "float": (float,),
    "number": (int, float),
    "bool": (bool,),
}
NONFINITE_KEY = "_nonfinite_fields"


# ---------------------------------------------------------------------------
# value validation
# ---------------------------------------------------------------------------


def _leaf_ok(value: Any, leaf: str) -> bool:
    for alt in leaf.split("|"):
        alt = alt.strip()
        if alt == "any":
            return True
        if alt == "null":
            if value is None:
                return True
            continue
        types = _SCALARS.get(alt)
        if types is None:
            continue
        if isinstance(value, bool) and alt != "bool":
            continue  # bool is an int subclass; don't let it pass as int
        if isinstance(value, types):
            return True
    return False


def validate_value(
    value: Any,
    spec: Any,
    open_: bool = False,
    path: str = "$",
) -> List[str]:
    """Violations of ``value`` against a contract spec node."""
    out: List[str] = []
    if isinstance(spec, str):
        if not _leaf_ok(value, spec):
            out.append(
                f"{path}: expected {spec}, got "
                f"{type(value).__name__} ({value!r:.80})"
            )
        return out
    if isinstance(spec, list):
        if not isinstance(value, list):
            out.append(f"{path}: expected list, got {type(value).__name__}")
            return out
        elem = spec[0] if spec else "any"
        for i, v in enumerate(value):
            out.extend(validate_value(v, elem, open_, f"{path}[{i}]"))
        return out
    if isinstance(spec, dict):
        if not isinstance(value, dict):
            out.append(f"{path}: expected object, got {type(value).__name__}")
            return out
        star = spec.get("*")
        declared: Dict[str, Tuple[Any, bool]] = {}
        for k, sub in spec.items():
            if k == "*":
                continue
            if k.endswith("?"):
                declared[k[:-1]] = (sub, False)
            else:
                declared[k] = (sub, True)
        for k, (sub, required) in declared.items():
            if k in value:
                out.extend(validate_value(value[k], sub, open_, f"{path}.{k}"))
            elif required:
                out.append(f"{path}: missing required key '{k}'")
        for k, v in value.items():
            if k in declared or k == NONFINITE_KEY:
                continue
            if star is not None:
                out.extend(validate_value(v, star, open_, f"{path}.{k}"))
            elif not open_:
                out.append(f"{path}: undeclared key '{k}'")
        return out
    out.append(f"{path}: malformed spec node {spec!r}")
    return out


def validate_response(entry: Dict[str, Any], status: int, body: Any) -> List[str]:
    """Status + body of one live response against its contract entry."""
    allowed = entry.get("statuses", [200])
    if status not in allowed:
        return [f"$: status {status} not in declared {allowed}"]
    if status != 200:
        return validate_value(body, {"detail": "str"}, False)
    spec = entry.get("response")
    if spec is None:
        return []
    return validate_value(body, spec, bool(entry.get("open")))


# ---------------------------------------------------------------------------
# the API document
# ---------------------------------------------------------------------------


def _spec_lines(spec: Any, indent: int = 0) -> List[str]:
    pad = "  " * indent
    if isinstance(spec, str):
        return [f"{pad}- `{spec}`"]
    if isinstance(spec, list):
        elem = spec[0] if spec else "any"
        if isinstance(elem, str):
            return [f"{pad}- list of `{elem}`"]
        return [f"{pad}- list of:"] + _spec_lines(elem, indent + 1)
    if isinstance(spec, dict):
        lines = []
        for k, sub in spec.items():
            label = (
                "any other key"
                if k == "*"
                else f"`{k[:-1]}` *(optional)*"
                if k.endswith("?")
                else f"`{k}`"
            )
            if isinstance(sub, str):
                lines.append(f"{pad}- {label}: `{sub}`")
            else:
                lines.append(f"{pad}- {label}:")
                lines.extend(_spec_lines(sub, indent + 1))
        return lines
    return [f"{pad}- (malformed spec)"]


def render_api_md(contract: Dict[str, Any]) -> str:
    """The endpoint reference rendered from the contract: the same text the
    reference renders into ``docs/API.md`` from the same contract."""
    lines = [
        "# HTTP API reference",
        "",
        "Generated from `api_contract.json` by `scripts/wire_audit.py "
        "--write-api-docs` — do not edit by hand; a stale generation "
        "is a test failure.",
        "",
        "Every non-200 JSON response has the shape "
        "`{\"detail\": str}`.  `_nonfinite_fields` (a list of dotted "
        "paths whose non-finite floats were nulled by the boundary "
        "coercion) may appear in any object.  Contract grammar and the "
        "amendment workflow: docs/STATIC_ANALYSIS.md, \"Wire contract "
        "& live audit\".",
        "",
    ]
    for key, entry in contract.get("endpoints", {}).items():
        lines.append(f"## `{key}`")
        lines.append("")
        lines.append(
            f"Handler `{entry.get('handler', '?')}` · contract "
            f"version {entry.get('version', '?')}"
            + (
                f" · pydantic model `{entry['model']}`"
                if entry.get("model")
                else ""
            )
        )
        lines.append("")
        statuses = entry.get("statuses", [200])
        lines.append("Statuses: " + ", ".join(f"`{s}`" for s in statuses))
        lines.append("")
        kind = entry.get("kind")
        if kind is not None:
            lines.append(f"Body: non-JSON (`{kind}`).")
            events = entry.get("events")
            if events:
                lines.append("")
                lines.append("SSE events:")
                for ev, spec in events.items():
                    lines.append(f"- `{ev}`:")
                    lines.extend(_spec_lines(spec, 1))
            lines.append("")
            continue
        spec = entry.get("response")
        if spec is None:
            lines.append("Body: unspecified.")
        else:
            openness = (
                " (open: undeclared extra keys tolerated)"
                if entry.get("open")
                else ""
            )
            lines.append(f"200 body{openness}:")
            lines.append("")
            lines.extend(_spec_lines(spec))
        lines.append("")
    jr = contract.get("journal_record")
    if jr is not None:
        lines.append("## Broker journal record")
        lines.append("")
        lines.extend(_spec_lines(jr))
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


# ---------------------------------------------------------------------------
# journal round trip
# ---------------------------------------------------------------------------


def journal_roundtrip(
    journal_dir: Optional[str] = None,
    contract: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Publish → ack → close → replay in a fresh broker; validate the
    journal lines against ``journal_record`` and the surviving message
    against the original body."""
    from docqa_tpu_torch.service.broker import MemoryBroker

    if contract is None:
        contract = load_contract(default_ledger_path())
    spec = contract.get("journal_record", {"*": "any"})
    violations: List[str] = []
    owns_dir = journal_dir is None
    tmp = journal_dir or tempfile.mkdtemp(prefix="wire_journal_")
    queue = "wire_audit_q"
    body_kept = {"doc_id": "wire-1", "n": 2}
    body_acked = {"doc_id": "wire-0", "n": 1}
    try:
        broker = MemoryBroker(journal_dir=tmp)
        broker.publish(queue, body_acked)
        broker.publish(queue, body_kept, headers={"x-trace": "t-1"})
        d = broker.get(queue, timeout=1.0)
        if d is None:
            violations.append("journal: first delivery never arrived")
        else:
            broker.ack(d)
        broker.close()
        path = os.path.join(tmp, f"{queue}.jsonl")
        if not os.path.exists(path):
            violations.append(f"journal: {path} was never written")
        else:
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        violations.append(f"journal[{i}]: line is not JSON")
                        continue
                    violations.extend(
                        validate_value(rec, spec, False, f"journal[{i}]")
                    )
        # the simulated restart: a fresh broker replays the journal
        broker2 = MemoryBroker(journal_dir=tmp)
        depth = broker2.depth(queue)
        if depth != 1:
            violations.append(
                f"journal: replayed depth {depth}, expected 1 "
                "(one published message was acked)"
            )
        d2 = broker2.get(queue, timeout=1.0)
        if d2 is None:
            violations.append("journal: replayed message not deliverable")
        elif d2.body != body_kept:
            violations.append(
                f"journal: replayed body {d2.body!r} != published "
                f"{body_kept!r}"
            )
        else:
            broker2.ack(d2)
        broker2.close()
    finally:
        if owns_dir:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return {"ok": not violations, "violations": violations}


# ---------------------------------------------------------------------------
# live HTTP drive
# ---------------------------------------------------------------------------

# the fake-mode runtime: canned answers, hash embeddings, a seeded
# plumbing-mode tagger, the reference's audit widths
FAKE_OVERRIDES = {
    "flags.use_fake_llm": True,
    "flags.use_fake_encoder": True,
    "encoder.embed_dim": 64,
    "store.dim": 64,
    "store.shard_capacity": 256,
    "ner.hidden_dim": 32,
    "ner.num_layers": 1,
    "ner.num_heads": 2,
    "ner.mlp_dim": 64,
    "ner.train_steps": 0,
}

_DOC_TEXT = "Aspirin 100 mg daily. BP 130/85 mmHg. Follow-up in 3 months."


def _parse_sse(text: str) -> List[Tuple[str, Any]]:
    """-> [(event name, decoded data)]; default event name is 'data'."""
    events: List[Tuple[str, Any]] = []
    for block in text.split("\n\n"):
        name = "data"
        data_lines = []
        for line in block.split("\n"):
            if line.startswith("event:"):
                name = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                data_lines.append(line.split(":", 1)[1].strip())
        if data_lines:
            try:
                payload = json.loads("\n".join(data_lines))
            except ValueError:
                payload = None
            events.append((name, payload))
    return events


class _Driver:
    """One audit's requests against ``base``: each response validated
    against its contract entry and recorded under its route key."""

    def __init__(self, base: str, contract: Dict[str, Any],
                 only: Optional[List[str]], profile: AnalysisProfile,
                 timeout: float) -> None:
        self.base = base
        self.endpoints = contract.get("endpoints", {})
        self.only = only
        self.timeout = timeout
        self.excepted: Dict[str, Dict[str, str]] = {}
        for route, key, why in profile.wire_key_exceptions:
            self.excepted.setdefault(route, {})[key] = why
        self.results: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def record(self, key: str, status: int, violations: List[str],
               seconds: float) -> None:
        if self.only is not None and key not in self.only:
            return
        with self._lock:
            slot = self.results.setdefault(
                key, {"status": status, "violations": [], "seconds": 0.0}
            )
            slot["status"] = status
            slot["violations"].extend(violations)
            slot["seconds"] = round(slot["seconds"] + seconds, 4)

    def recorded(self) -> Dict[str, Any]:
        with self._lock:
            return {k: dict(v) for k, v in self.results.items()}

    def request(self, method: str, path: str, json_body: Any = None):
        """(status, headers, raw body bytes, seconds)."""
        data = None
        headers = {}
        if json_body is not None:
            data = json.dumps(json_body).encode("utf-8")
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(
            self.base + path, data=data, method=method, headers=headers
        )
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read()
                status, hdrs = r.status, dict(r.headers)
        except urllib.error.HTTPError as e:
            raw = e.read()
            status, hdrs = e.code, dict(e.headers)
        return status, hdrs, raw, time.perf_counter() - t0

    def json(self, key: str, path: str, json_body: Any = None):
        """Drive one JSON endpoint, validate, return (status, body, headers)."""
        method = key.split(" ", 1)[0]
        status, hdrs, raw, dt = self.request(method, path, json_body)
        try:
            body = json.loads(raw)
        except ValueError:
            body = None
        entry = self.endpoints.get(key)
        if entry is None:
            violations = [f"$: no {LEDGER_NAME} entry"]
        else:
            checked = body
            if status == 200 and isinstance(body, dict) and key in self.excepted:
                # keys the profile sets aside for this route, with reasons
                checked = {
                    k: v for k, v in body.items() if k not in self.excepted[key]
                }
            violations = validate_response(entry, status, checked)
        self.record(key, status, violations, dt)
        return status, body, hdrs

    def text(self, key: str, path: str, expect_ct: str):
        entry = self.endpoints.get(key, {})
        status, hdrs, raw, dt = self.request("GET", path)
        ct = hdrs.get("Content-Type", "")
        violations: List[str] = []
        allowed = entry.get("statuses", [200])
        if status not in allowed:
            violations.append(f"$: status {status} not in {allowed}")
        if expect_ct not in ct:
            violations.append(f"$: content-type {ct!r} lacks {expect_ct!r}")
        if not raw.strip():
            violations.append("$: empty body")
        self.record(key, status, violations, dt)

    def sse(self, key: str, path: str, json_body: Any) -> None:
        entry = self.endpoints.get(key, {})
        status, hdrs, raw, dt = self.request("POST", path, json_body)
        ct = hdrs.get("Content-Type", "")
        violations: List[str] = []
        if status != 200:
            violations.append(f"$: status {status} != 200")
        if "text/event-stream" not in ct:
            violations.append(f"$: content-type {ct!r} not SSE")
        events = _parse_sse(raw.decode("utf-8", "replace"))
        if not events:
            violations.append("$: no SSE events parsed")
        declared = entry.get("events", {})
        if not [n for n, _ in events if n in ("done", "error")]:
            violations.append("$: stream ended without done/error")
        for name, payload in events:
            spec = declared.get(name)
            if spec is None:
                violations.append(f"$: undeclared SSE event '{name}'")
            else:
                violations.extend(
                    validate_value(payload, spec, False, f"$.{name}")
                )
        self.record(key, status, violations, dt)


def _drive(d: _Driver, profiler_logdir: str) -> None:
    """Every route of the contract, in an order that gives each one
    content: documents first, the deleting DELETE and the page last."""
    doc_ids = []
    for i in range(2):
        _, body, _ = d.json(
            "POST /ingest/", "/ingest/?wait=1",
            {"filename": f"wire-{i}.txt", "text": _DOC_TEXT,
             "patient_id": "p-wire"},
        )
        if isinstance(body, dict) and "doc_id" in body:
            doc_ids.append(body["doc_id"])
    d.json("GET /documents/", "/documents/")
    if doc_ids:
        d.json("GET /documents/{doc_id}", f"/documents/{doc_ids[0]}")

    # QA and its trace
    _, _, hdrs = d.json("POST /ask/", "/ask/", {"question": "aspirin dose?"})
    trace_id = hdrs.get("X-Trace-Id")
    if trace_id:
        d.json("GET /api/trace/{trace_id}", f"/api/trace/{trace_id}")
        d.json("GET /api/trace/{trace_id}", f"/api/trace/{trace_id}?format=chrome")
    d.json("GET /api/traces", "/api/traces?limit=20")
    d.sse("POST /ask/stream", "/ask/stream", {"question": "blood pressure?"})

    # status, metrics, observability
    d.json("GET /health", "/health")
    d.json("GET /api/status", "/api/status")
    d.text("GET /metrics", "/metrics", "text/plain")
    d.json("GET /api/metrics", "/api/metrics")
    d.json("GET /api/telemetry", "/api/telemetry")
    d.json("GET /api/costs", "/api/costs")
    d.json("GET /api/costs/sheds", "/api/costs/sheds?limit=20")
    d.json("GET /api/retrieval", "/api/retrieval")
    # the witnesses answer 404 unless the process booted with them
    d.json("GET /api/witness", "/api/witness")
    d.json("GET /api/ledger", "/api/ledger")

    # the pool's control plane (404 without a decoding pool)
    d.json("GET /api/pool", "/api/pool")
    d.json("POST /api/pool/drain", "/api/pool/drain", {"replica": 0})
    d.json("POST /api/pool/resume", "/api/pool/resume", {"replica": 0})
    d.json("POST /api/pool/rolling_restart", "/api/pool/rolling_restart", {})

    d.json("POST /api/profiler/start", "/api/profiler/start",
           {"logdir": profiler_logdir})
    d.json("POST /api/profiler/stop", "/api/profiler/stop")

    # the clinical surfaces; the three that decode are asked at once (on a
    # decoding runtime each is a batcher request, so they share its slots)
    d.json("GET /api/search/patient-snippets",
           "/api/search/patient-snippets?patient_id=p-wire")
    jobs = [
        ("POST /api/llm/summarize", "/api/llm/summarize",
         {"prompt": "Summarize the treatment.", "max_tokens": 16}),
        ("POST /api/synthese/patient", "/api/synthese/patient",
         {"patient_id": "p-wire"}),
        ("POST /api/synthese/comparaison", "/api/synthese/comparaison",
         {"patient_ids": ["p-wire", "p-ghost"]}),
    ]
    threads = [threading.Thread(target=d.json, args=job, name="wire-audit-job")
               for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if len(doc_ids) > 1:
        d.json("DELETE /documents/{doc_id}", f"/documents/{doc_ids[1]}?erase=1")
    d.text("GET /", "/", "text/html")


def run_wire_audit(
    rt=None,
    device="cuda",
    contract_path: Optional[str] = None,
    report_path: Optional[str] = None,
    only: Optional[List[str]] = None,
    contract: Optional[Dict[str, Any]] = None,
    skip_journal: bool = False,
    profile: AnalysisProfile = PORT_PROFILE,
    timeout: float = 300.0,
) -> Dict[str, Any]:
    """Drive every route of the port's app over HTTP and return the report.

    ``rt``: a started runtime to audit (it keeps running); None boots the
    fake-mode runtime (:data:`FAKE_OVERRIDES`) on ``device`` and stops it
    after.  ``only`` restricts recording to the named route keys and turns
    the coverage gate off; ``contract`` overrides the loaded ledger (drift
    injection).  ``timeout`` bounds each request."""
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    if contract is None:
        contract = load_contract(contract_path or default_ledger_path())
    endpoints = contract.get("endpoints", {})
    owned = rt is None
    t0 = time.perf_counter()
    if owned:
        from docqa_tpu_torch.config import load_config

        cfg = load_config(env={}, overrides=dict(FAKE_OVERRIDES))
        rt = DocQARuntime(cfg, device=device).start()
    boot_s = time.perf_counter() - t0
    app = make_app(rt)
    registered = sorted({f"{m} {p}" for m, p, _rx, _fn in app.routes})
    server = AppServer(app).start()
    logdir = tempfile.mkdtemp(prefix="wire_profile_")
    t1 = time.perf_counter()
    try:
        d = _Driver(f"http://127.0.0.1:{server.port}", contract, only,
                    profile, timeout)
        _drive(d, logdir)
    finally:
        server.close()
        if owned:
            rt.stop()
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)
    drive_s = time.perf_counter() - t1
    results = d.recorded()

    coverage: Dict[str, Any] = {"checked": only is None}
    violations_total = sum(len(r["violations"]) for r in results.values())
    if only is None:
        driven = sorted(results)
        declared = sorted(endpoints)
        coverage.update({
            "registered": len(registered),
            "driven": len(driven),
            "declared": len(declared),
            "not_driven": sorted(set(registered) - set(driven)),
            "not_registered": sorted(set(driven) - set(registered)),
            "undeclared_routes": sorted(set(registered) - set(declared)),
            "stale_entries": sorted(set(declared) - set(registered)),
        })
        for k in ("not_driven", "not_registered", "undeclared_routes",
                  "stale_entries"):
            violations_total += len(coverage[k])

    journal = (
        {"ok": True, "violations": [], "skipped": True}
        if skip_journal
        else journal_roundtrip(contract=contract)
    )
    violations_total += len(journal["violations"])

    report = {
        "ok": violations_total == 0,
        "violations_total": violations_total,
        "coverage": coverage,
        "journal": journal,
        "excepted_keys": {
            route: dict(keys) for route, keys in sorted(d.excepted.items())
        },
        "seconds": {"boot": round(boot_s, 3), "drive": round(drive_s, 3)},
        "endpoints": {k: results[k] for k in sorted(results)},
    }
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return report
