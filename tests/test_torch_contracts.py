"""Port parity, the analyzer's serving-contract half:
``docqa_tpu_torch.analysis`` held against ``docqa_tpu.analysis`` for
host-sync, dispatch-streams, retire-once, shed-taxonomy, wire-schema,
wire-safety and wire-consumer.

* The shared fixtures: every positive, suppressed and clean fixture of the
  seven static rules in the reference's own tests
  (``tests/test_numcheck.py`` ``TestHostSync``, ``tests/test_racecheck.py``
  ``TestDispatchStreams``, ``tests/test_lifecheck.py`` ``TestRetireOnce``
  and ``TestShedTaxonomy``, ``tests/test_wirecheck.py`` ``TestWireSchema``,
  ``TestWireConsumer`` and ``TestWireSafety``), written to ``tmp_path`` and
  run through both analyzers.  The findings must be equal as (rule, path,
  line, symbol, message).  The port runs each under its own default
  profile, except the ten fixtures whose subject is a jax dispatch (four
  of host-sync, five of dispatch-streams, one of wire-safety: the port's
  dispatch heads are torch's), which it runs under the reference's profile.
  Their torch counterparts are held under the port's profile below.
* The reference tree: under the reference's profile the port's rules give
  the reference's findings on ``docqa_tpu/`` for dispatch-streams,
  retire-once, shed-taxonomy and the three static wire rules, with each
  rule's own ledger and with an empty one (every thread, site, raise and
  route then a finding), so no comparison is vacuous.  Host-sync's
  reference-tree parity would need jit discovery, which has no subject in
  the port: it is held by the fixtures only.
* The port's tree against its own ledgers
  (``docqa_tpu_torch/analysis/{dispatch_streams,retirement_sites,
  shed_taxonomy}.json``): in sync, every entry justified, and an undeclared
  or a stale entry failing either way.
* The true positives the rules found in the port, each pinned by a test
  that fails without its fix.
"""

import json
import os
import threading
import time

import pytest

from docqa_tpu.analysis import run as j_run
from docqa_tpu.analysis.core import Package as JPackage
from docqa_tpu.analysis.core import _run_package as j_run_package
from docqa_tpu.analysis.dispatch_streams import (
    DispatchStreamsChecker as JDispatchStreamsChecker,
)
from docqa_tpu.analysis.retire_once import RetireOnceChecker as JRetireOnceChecker
from docqa_tpu.analysis.shed_taxonomy import (
    ShedTaxonomyChecker as JShedTaxonomyChecker,
)
from docqa_tpu.analysis.wire_consumer import (
    WireConsumerChecker as JWireConsumerChecker,
)
from docqa_tpu.analysis.wire_schema import WireSchemaChecker as JWireSchemaChecker
from docqa_tpu.analysis.wire_schema import route_table as j_route_table
from docqa_tpu_torch.analysis import PORT_PROFILE, Package, all_checkers, run
from docqa_tpu_torch.analysis.core import _run_package, package_dir
from docqa_tpu_torch.analysis.dispatch_streams import (
    DispatchStreamsChecker,
    enumerate_spine_sites,
    spine_aware_owners,
)
from docqa_tpu_torch.analysis import retire_once as p_ro
from docqa_tpu_torch.analysis.retire_once import RetireOnceChecker
from docqa_tpu_torch.analysis.shed_taxonomy import (
    ShedTaxonomyChecker,
    request_path_functions,
)
from docqa_tpu_torch.analysis.wire_consumer import WireConsumerChecker
from docqa_tpu_torch.analysis.wire_schema import WireSchemaChecker, route_table
from test_torch_analysis import REF_PKG, REF_PROFILE, _key, _write

SERVING_RULES = ("dispatch-streams", "host-sync", "retire-once", "shed-taxonomy",
                 "wire-consumer", "wire-safety", "wire-schema")
PORT_ANALYSIS = os.path.join(package_dir(), "analysis")


def _contract(endpoints, **extra):
    data = {"endpoints": endpoints}
    data.update(extra)
    return json.dumps(data)


def _health_contract(**response):
    return _contract({"GET /health": {
        "handler": "health", "version": 1,
        "response": response or {"status": "str"},
    }})


# ---------------------------------------------------------------------------
# the shared fixtures (the reference tests' sources, verbatim after dedent)
# ---------------------------------------------------------------------------

_DISPATCHING_THREAD_SRC = """
import threading
import jax.numpy as jnp

class W:
    def _loop(self):
        return jnp.zeros((4,))

    def start(self):
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def stop(self):
        self._t.join()
"""

_STREAM_LEDGER = json.dumps({
    "streams": {"mod.py:W._loop": {"justification": "test stream",
                                   "concurrent_with_serving": True}},
    "budget": {"max_concurrent_device_streams": 1},
})
_STALE_STREAM_LEDGER = json.dumps({
    "streams": {"mod.py:W._loop": {"justification": "test"},
                "mod.py:W._gone": {"justification": "stale"}},
    "budget": {},
})
_BUDGET_SRC = _DISPATCHING_THREAD_SRC + """
class V:
    def _loop2(self):
        return jnp.ones((2,))

    def start(self):
        self._t = threading.Thread(target=self._loop2)
        self._t.start()

    def stop(self):
        self._t.join()
"""
_BUDGET_LEDGER = json.dumps({
    "streams": {
        "mod.py:W._loop": {"justification": "a", "concurrent_with_serving": True},
        "mod.py:V._loop2": {"justification": "b", "concurrent_with_serving": True},
    },
    "budget": {"max_concurrent_device_streams": 1},
})

_RETIRE_MOD = """
def _finish(req):
    req.done = True


def declared(req):
    _finish(req)
"""

_STAMPS_ONLY = """
def _finish(req):
    req.done = True


def stamps_only(req):
    req.error = RuntimeError("boom")
"""

_TAX_LEDGER = json.dumps({"sheds": {
    "QueueFull": {"module": "fixture.mod", "bases": ["RuntimeError"],
                  "http_status": 503, "cost_outcome": "shed_queue",
                  "trace_flag": "queue_full"},
    "Draining": {"module": "fixture.mod", "bases": ["QueueFull"],
                 "http_status": 200, "cost_outcome": "shed_queue",
                 "trace_flag": "draining"},
}})
_TAX_STALE_LEDGER = json.dumps({"sheds": {
    **json.loads(_TAX_LEDGER)["sheds"],
    "Vanished": {"module": "fixture.mod", "http_status": 503,
                 "cost_outcome": "x", "trace_flag": "x"},
}})

_TAX_CLASSES = """
# docqa-lint: request-path


class QueueFull(RuntimeError):
    pass


class Draining(QueueFull):
    pass
"""

_HEALTH_ROUTE = """
def health(_req):
    return web.json_response({"status": "ok"})

def make_app(app):
    app.router.add_routes([web.get("/health", health)])
"""

_BROKER_FIXTURE = """
class Pipeline:
    def start(self, broker):
        self.consumer = Consumer(broker, "clean", self._index)
        broker.publish("clean", {"doc_id": "d1", "text": "hello"})

    def _index(self, bodies, headers=None):
        for body in bodies:
            use(body["doc_id"], body[%r])
"""

_STATUS_CONTRACT = _contract({"GET /api/status": {
    "handler": "api_status", "version": 1, "response": {"service": "str"},
}})

_FETCH = """
import json
from urllib.request import urlopen

def fetch(url):
    with urlopen(url) as r:
        return json.loads(r.read())

def main(base):
%s
"""


def F(id, rule, sources, jax=False, ledger=None):
    """One fixture: ``sources`` (``.json`` names written raw); ``ledger``
    names a written file the checker is built on (the reference test
    called the checker directly); ``jax`` marks a jax-dispatch subject."""
    return pytest.param(rule, sources, jax, ledger, id=id)


FIXTURES = [
    # -- host-sync (tests/test_numcheck.py TestHostSync) --------------------
    F("TestHostSync.test_item_on_request_path_detected", "host-sync", {"mod.py": """
# docqa-lint: request-path

def score_of(vals):
    return vals.item()
"""}),
    F("TestHostSync.test_device_get_detected", "host-sync", {"mod.py": """
# docqa-lint: request-path
import jax

def fetch(x):
    return jax.device_get(x)
"""}, jax=True),
    F("TestHostSync.test_float_on_device_value_detected", "host-sync", {"mod.py": """
# docqa-lint: request-path
import jax.numpy as jnp

def best(scores):
    top = jnp.max(scores)
    return float(top)
"""}, jax=True),
    F("TestHostSync.test_asarray_over_device_computation_detected", "host-sync", {"mod.py": """
# docqa-lint: request-path
import numpy as np
import jax.numpy as jnp

def norms(x):
    return np.asarray(jnp.linalg.norm(x, axis=-1))
"""}, jax=True),
    F("TestHostSync.test_sanctioned_fetch_of_held_reference_clean", "host-sync", {"mod.py": """
# docqa-lint: request-path
import numpy as np

def process(packed_dev):
    packed_h = np.asarray(packed_dev)
    return int(packed_h[0, 0])
"""}),
    F("TestHostSync.test_off_request_path_clean", "host-sync", {"mod.py": """
def score_of(vals):
    return vals.item()
"""}),
    F("TestHostSync.test_inside_jit_left_to_jit_purity", "host-sync", {"mod.py": """
# docqa-lint: request-path
import jax
import numpy as np

@jax.jit
def kernel(x):
    return np.asarray(x)
"""}, jax=True),
    F("TestHostSync.test_laundered_fact_clean", "host-sync", {"mod.py": """
# docqa-lint: request-path
import numpy as np

def first(dev_ref):
    host = np.asarray(dev_ref)
    return float(host[0])
"""}),
    F("TestHostSync.test_suppression", "host-sync", {"mod.py": """
# docqa-lint: request-path

def score_of(vals):
    return vals.item()  # docqa-lint: disable=host-sync
"""}),
    # -- dispatch-streams (tests/test_racecheck.py TestDispatchStreams) -----
    F("TestDispatchStreams.test_unledgered_stream_detected", "dispatch-streams",
      {"mod.py": _DISPATCHING_THREAD_SRC}, jax=True),
    F("TestDispatchStreams.test_non_dispatching_thread_ignored", "dispatch-streams", {"mod.py": """
import threading

class W:
    def _loop(self):
        return 1

    def start(self):
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def stop(self):
        self._t.join()
"""}),
    F("TestDispatchStreams.test_ledgered_stream_clean", "dispatch-streams",
      {"mod.py": _DISPATCHING_THREAD_SRC, "ledger.json": _STREAM_LEDGER},
      jax=True, ledger="ledger.json"),
    F("TestDispatchStreams.test_stale_ledger_entry_detected", "dispatch-streams",
      {"mod.py": _DISPATCHING_THREAD_SRC, "ledger.json": _STALE_STREAM_LEDGER},
      jax=True, ledger="ledger.json"),
    F("TestDispatchStreams.test_budget_exceeded_detected", "dispatch-streams",
      {"mod.py": _BUDGET_SRC, "ledger.json": _BUDGET_LEDGER},
      jax=True, ledger="ledger.json"),
    F("TestDispatchStreams.test_suppression", "dispatch-streams", {
        "mod.py": _DISPATCHING_THREAD_SRC.replace(
            "self._t = threading.Thread(target=self._loop)",
            "self._t = threading.Thread(target=self._loop)  # docqa-lint: disable=dispatch-streams",
        )}, jax=True),
    # -- retire-once (tests/test_lifecheck.py TestRetireOnce) ---------------
    F("TestRetireOnce.test_undeclared_site_detected", "retire-once", {
        "mod.py": _RETIRE_MOD,
        "retirement_sites.json": json.dumps({"sites": {}})}),
    F("TestRetireOnce.test_declared_sites_clean", "retire-once", {
        "mod.py": _RETIRE_MOD,
        "retirement_sites.json": json.dumps({"sites": {"fixture.mod:declared": {}}})}),
    F("TestRetireOnce.test_stale_entry_detected", "retire-once", {
        "mod.py": _RETIRE_MOD,
        "retirement_sites.json": json.dumps({"sites": {
            "fixture.mod:declared": {}, "fixture.mod:gone": {}}})}),
    F("TestRetireOnce.test_error_set_without_finish_detected", "retire-once", {
        "mod.py": _STAMPS_ONLY,
        "retirement_sites.json": json.dumps({"sites": {}})}),
    F("TestRetireOnce.test_declared_error_setter_clean", "retire-once", {
        "mod.py": _STAMPS_ONLY,
        "retirement_sites.json": json.dumps({"sites": {
            "fixture.mod:stamps_only": {"kind": "error-setter"}}})}),
    F("TestRetireOnce.test_straight_line_double_retire_detected", "retire-once", {
        "mod.py": """
def _finish(req):
    req.done = True


def twice(req):
    _finish(req)
    _finish(req)
""",
        "retirement_sites.json": json.dumps({"sites": {"fixture.mod:twice": {}}})}),
    # -- shed-taxonomy (tests/test_lifecheck.py TestShedTaxonomy) -----------
    F("TestShedTaxonomy.test_unledgered_raise_detected", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

class Novel(Exception):
    pass


def submit(q):
    raise Novel("untyped")
""", "shed_taxonomy.json": _TAX_LEDGER}),
    F("TestShedTaxonomy.test_bare_generic_raise_detected", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

def submit(q):
    raise RuntimeError("generic")
""", "shed_taxonomy.json": _TAX_LEDGER}),
    F("TestShedTaxonomy.test_ledgered_and_validation_raises_clean", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

def submit(q, n):
    if n < 0:
        raise ValueError("n must be >= 0")
    raise QueueFull("full")
""", "shed_taxonomy.json": _TAX_LEDGER}),
    F("TestShedTaxonomy.test_off_request_path_silent", "shed-taxonomy", {
        "mod.py": """
def helper():
    raise RuntimeError("tooling, not serving")
""", "shed_taxonomy.json": json.dumps({"sheds": {}})}),
    F("TestShedTaxonomy.test_unledgered_subclass_detected", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

class Overloaded(QueueFull):
    pass
""", "shed_taxonomy.json": _TAX_LEDGER}),
    F("TestShedTaxonomy.test_stale_entry_detected", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES, "shed_taxonomy.json": _TAX_STALE_LEDGER}),
    F("TestShedTaxonomy.test_subtype_swallow_detected", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

def submit(q):
    try:
        q.push()
    except QueueFull:
        return None
""", "shed_taxonomy.json": _TAX_LEDGER}),
    F("TestShedTaxonomy.test_subtype_caught_first_clean", "shed-taxonomy", {
        "mod.py": _TAX_CLASSES + """

def submit(q):
    try:
        q.push()
    except Draining:
        return "drain"
    except QueueFull:
        return None
""", "shed_taxonomy.json": _TAX_LEDGER}),
    # -- wire-schema (tests/test_wirecheck.py TestWireSchema) ---------------
    F("TestWireSchema.test_new_key_detected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response(
        {"status": "ok", "uptime_s": 12.5}
    )

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _health_contract()}),
    F("TestWireSchema.test_new_key_suppressed", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response(  # docqa-lint: disable=wire-schema
        {"status": "ok", "uptime_s": 12.5}
    )

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _health_contract()}),
    F("TestWireSchema.test_declared_payload_clean", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _health_contract()}),
    F("TestWireSchema.test_removed_key_detected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _health_contract(status="str", uptime_s="float")}),
    F("TestWireSchema.test_undeclared_route_detected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _contract({})}),
    F("TestWireSchema.test_stale_entry_detected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _contract({
        "GET /health": {"handler": "health", "version": 1,
                        "response": {"status": "str"}},
        "GET /gone": {"handler": "gone", "version": 3, "response": {"x": "int"}},
    })}),
    F("TestWireSchema.test_todo_entry_rejected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _contract({"GET /health": {
        "handler": "health", "version": 1, "_note": "TODO tighten this",
        "response": {"status": "str"}}})}),
    F("TestWireSchema.test_handler_mismatch_detected", "wire-schema", {"mod.py": """
def health(_req):
    return web.json_response({"status": "ok"})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _contract({"GET /health": {
        "handler": "old_health", "version": 1, "response": {"status": "str"}}})}),
    F("TestWireSchema.test_model_drift_detected", "wire-schema", {
        "schemas.py": """
from pydantic import BaseModel

class Health(BaseModel):
    status: str
    extra_field: int = 0
""", "mod.py": _HEALTH_ROUTE,
        "api_contract.json": _contract({"GET /health": {
            "handler": "health", "version": 1, "model": "Health",
            "response": {"status": "str"}}})}),
    F("TestWireSchema.test_dead_model_detected", "wire-schema", {
        "schemas.py": """
from pydantic import BaseModel

class Orphan(BaseModel):
    x: int
""", "mod.py": _HEALTH_ROUTE, "api_contract.json": _health_contract()}),
    F("TestWireSchema.test_referenced_model_not_dead", "wire-schema", {
        "schemas.py": """
from pydantic import BaseModel

class Query(BaseModel):
    question: str
""", "mod.py": """
from schemas import Query

def health(req):
    q = Query(**req)
    return web.json_response({"status": q.question})

def wire(app):
    web.get("/health", health)
""", "api_contract.json": _health_contract()}),
    F("TestWireSchema.test_journal_record_gated", "wire-schema", {"mod.py": """
class Broker:
    def _journal_write(self, queue, record):
        pass

    def publish_like(self, queue):
        self._journal_write(
            queue, {"op": "pub", "surprise": 1}
        )
""", "api_contract.json": _contract({}, journal_record={"op": "str", "tag": "int"})}),
    # -- wire-consumer (tests/test_wirecheck.py TestWireConsumer) -----------
    F("TestWireConsumer.test_undeclared_broker_read_detected", "wire-consumer", {
        "mod.py": _BROKER_FIXTURE % "missing", "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_undeclared_broker_read_suppressed", "wire-consumer", {
        "mod.py": (_BROKER_FIXTURE % "missing").replace(
            "body['missing'])", "body['missing'])  # docqa-lint: disable=wire-consumer"),
        "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_declared_broker_read_clean", "wire-consumer", {
        "mod.py": _BROKER_FIXTURE % "text", "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_orphan_producer_key_detected", "wire-consumer", {"mod.py": """
class Pipeline:
    def start(self, broker):
        self.consumer = Consumer(broker, "clean", self._index)
        broker.publish(
            "clean", {"doc_id": "d1", "nobody_reads": 1}
        )

    def _index(self, bodies, headers=None):
        for body in bodies:
            use(body["doc_id"])
""", "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_undeclared_http_read_detected", "wire-consumer", {
        "mod.py": _FETCH % '    st = fetch(f"{base}/api/status")\n    print(st["nope"])',
        "api_contract.json": _STATUS_CONTRACT}),
    F("TestWireConsumer.test_declared_http_read_clean", "wire-consumer", {
        "mod.py": _FETCH % '    st = fetch(f"{base}/api/status")\n    print(st["service"])',
        "api_contract.json": _STATUS_CONTRACT}),
    F("TestWireConsumer.test_unmatched_url_detected", "wire-consumer", {
        "mod.py": _FETCH % '    st = fetch(f"{base}/api/unknown")\n    return st',
        "api_contract.json": _STATUS_CONTRACT}),
    F("TestWireConsumer.test_tuple_fetch_helper_tagged", "wire-consumer", {"mod.py": """
import json
from urllib.request import urlopen

def req(method, path):
    with urlopen(path) as r:
        return r.status, json.loads(r.read())

def main():
    code, js = req("GET", "/api/status")
    return js["oops"]
""", "api_contract.json": _STATUS_CONTRACT}),
    F("TestWireConsumer.test_bench_dotted_path_detected", "wire-consumer", {
        "bench.py": """
DETAILS = {}

def bench_qa():
    DETAILS["qa_e2e"] = {"p50_ms": 1.0, "p95_ms": 2.0}
""", "gate.py": """
CHECKS = ["qa_e2e.p50_ms", "qa_e2e.p999_ms"]
""", "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_open_bench_section_not_checked", "wire-consumer", {
        "bench.py": """
DETAILS = {}

def bench_qa():
    DETAILS["qa_e2e"] = build_details()
""", "gate.py": """
CHECKS = ["qa_e2e.anything_at_all"]
""", "api_contract.json": _contract({})}),
    F("TestWireConsumer.test_undeclared_journal_read_detected", "wire-consumer", {"mod.py": """
import json

def _replay(lines):
    for line in lines:
        rec = json.loads(line)
        use(rec["op"], rec["oops"])
""", "api_contract.json": _contract({}, journal_record={"op": "str", "tag": "int"})}),
    # -- wire-safety (tests/test_wirecheck.py TestWireSafety) ---------------
    F("TestWireSafety.test_numpy_scalar_detected", "wire-safety", {"mod.py": """
import numpy as np
from aiohttp import web

def handler(_req):
    p50 = np.percentile([1.0, 2.0], 50)
    return web.json_response({"p50": p50})
"""}),
    F("TestWireSafety.test_numpy_scalar_suppressed", "wire-safety", {"mod.py": """
import numpy as np
from aiohttp import web

def handler(_req):
    p50 = np.percentile([1.0, 2.0], 50)
    return web.json_response({"p50": p50})  # docqa-lint: disable=wire-safety
"""}),
    F("TestWireSafety.test_float_coercion_clean", "wire-safety", {"mod.py": """
import numpy as np
from aiohttp import web

def handler(_req):
    p50 = np.percentile([1.0, 2.0], 50)
    return web.json_response({"p50": float(p50)})
"""}),
    F("TestWireSafety.test_to_wire_wrapper_sanctions_sites", "wire-safety", {"mod.py": """
import numpy as np
from aiohttp import web

from wirelib import to_wire

def json_response(payload, **kw):
    return web.json_response(to_wire(payload), **kw)

def handler(_req):
    p50 = np.percentile([1.0, 2.0], 50)
    return json_response({"p50": p50})
""", "wirelib.py": """
def to_wire(payload):
    return payload
"""}),
    F("TestWireSafety.test_device_array_detected", "wire-safety", {"mod.py": """
import jax.numpy as jnp
from aiohttp import web

def handler(_req):
    emb = jnp.zeros((4,))
    return web.json_response({"embedding": emb})
"""}, jax=True),
    F("TestWireSafety.test_lock_in_broker_body_detected", "wire-safety", {"mod.py": """
import threading

def enqueue(broker):
    guard = threading.Lock()
    broker.publish("q", {"guard": guard})
"""}),
    F("TestWireSafety.test_nonfinite_float_detected", "wire-safety", {"mod.py": """
from aiohttp import web

def handler(_req):
    ratio = float("nan")
    return web.json_response({"ratio": ratio})
"""}),
    F("TestWireSafety.test_journal_write_boundary_checked", "wire-safety", {"mod.py": """
import numpy as np

def journal(broker, queue):
    n = np.sum([1, 2])
    broker._journal_write(queue, {"op": "pub", "n": n})
"""}),
]

_CHECKERS = {
    "dispatch-streams": (JDispatchStreamsChecker, DispatchStreamsChecker),
}


def _write_fixture(root, sources):
    root.mkdir(parents=True, exist_ok=True)
    py = {k: v for k, v in sources.items() if k.endswith(".py")}
    _write(root, py)
    for name, text in sources.items():
        if not name.endswith(".py"):
            (root / name).write_text(text)
    return str(root)


def test_fixture_inventory():
    """Every fixture of the reference's tests for these rules is here, and
    the ten jax-subject ones are the ones counted."""
    assert {p.values[0] for p in FIXTURES} == set(SERVING_RULES)
    jax_ids = sorted(p.id for p in FIXTURES if p.values[2])
    assert len(FIXTURES) == 60 and len(jax_ids) == 10
    assert sum(1 for p in FIXTURES if p.values[0] == "host-sync" and p.values[2]) == 4
    assert sum(1 for p in FIXTURES if p.values[0] == "dispatch-streams" and p.values[2]) == 5
    assert set(SERVING_RULES) <= set(all_checkers())


@pytest.mark.parametrize("rule,sources,jax_subject,ledger", FIXTURES)
def test_fixture_findings_equal_reference(rule, sources, jax_subject, ledger,
                                          tmp_path):
    root = _write_fixture(tmp_path / "fixture", sources)
    profile = REF_PROFILE if jax_subject else PORT_PROFILE
    if ledger is None:
        ref = j_run(root, rules=[rule], package_name="fixture")
        port = run(root, rules=[rule], package_name="fixture", profile=profile)
    else:
        jcls, pcls = _CHECKERS[rule]
        path = os.path.join(root, ledger)
        ref = jcls(ledger_path=path).check(JPackage.load(root, package_name="fixture"))
        port = pcls(ledger_path=path).check(
            Package.load(root, package_name="fixture", profile=profile))
    assert sorted(map(_key, port)) == sorted(map(_key, ref))


# ---------------------------------------------------------------------------
# the jax-subject fixtures' torch counterparts, under the port's profile
# ---------------------------------------------------------------------------

_TORCH_THREAD = """
import threading
import torch

class W:
    def _loop(self):
        return torch.zeros((4,), device="cuda")

    def start(self):
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def stop(self):
        self._t.join()
"""

_HOST_SYNC_PORT = [
    pytest.param("""
# docqa-lint: request-path
import torch

def wait_all():
    torch.cuda.synchronize()
""", ["torch.cuda.synchronize()"], id="torch_cuda_synchronize"),
    pytest.param("""
# docqa-lint: request-path

def wait_item(events):
    events[1].synchronize()
""", [".synchronize()"], id="event_synchronize"),
    pytest.param("""
# docqa-lint: request-path
import torch

def best(scores):
    top = torch.max(scores)
    return float(top)
""", ["float() on a device value"], id="float_of_torch_value"),
    pytest.param("""
# docqa-lint: request-path

def to_list(t):
    return t.cpu().numpy()
""", [".cpu()", ".numpy()"], id="cpu_and_numpy"),
    pytest.param("""
# docqa-lint: request-path
import torch

def decode(first, step):
    done = first == 2
    while not bool(done.all()):
        nxt = torch.argmax(step(), dim=-1)
        done |= nxt == 2
    return done
""", ["bool() on a device value"], id="loop_condition_turns_device"),
    pytest.param("""
# docqa-lint: request-path
import torch

def decode(first, step, fetch):
    done = torch.zeros(2, dtype=torch.bool)
    n, done = 0, fetch(done)
    while not bool(done.all()):
        n += 1
    return n
""", [], id="tuple_assignment_binds_each"),
    pytest.param("""
# docqa-lint: request-path
from docqa_tpu_torch.engines.spine import spine_run, to_host

def fetched(hits):
    rows = spine_run("retrieve", lambda: [to_host(h) for h in hits])
    ids = [r.numpy() for r in rows]
    return ids, rows[0].tolist()
""", [], id="sanctioned_spine_fetch_clean"),
]


@pytest.mark.parametrize("src,expect", _HOST_SYNC_PORT)
def test_host_sync_on_the_ports_subject(src, expect, tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": src})
    found = run(root, rules=["host-sync"], package_name="fx")
    assert len(found) == len(expect), [f.format() for f in found]
    for f, what in zip(sorted(found, key=lambda f: f.message), sorted(expect)):
        assert what in f.message


@pytest.mark.parametrize("ledgered", [False, True])
def test_dispatch_streams_on_the_ports_subject(ledgered, tmp_path):
    srcs = {"mod.py": _TORCH_THREAD}
    root = _write(tmp_path / "fx", srcs)
    ledger = tmp_path / "dispatch_streams.json"
    streams = {"mod.py:W._loop": {"justification": "t"}} if ledgered else {}
    ledger.write_text(json.dumps({"streams": streams, "budget": {}}))
    found = run(root, rules=["dispatch-streams"], package_name="fx")
    if ledgered:
        assert found == []
    else:
        assert len(found) == 1 and "mod.py:W._loop" in found[0].message
        assert "torch.zeros" in found[0].message


def test_spine_delegation_and_stage_gate_on_the_ports_subject(tmp_path):
    """A thread whose device work rides spine_issue / _on_lane owns none;
    every stage literal must be declared, and a declared stage no site
    uses is stale."""
    root = _write(tmp_path / "fx", {"mod.py": """
import threading
import torch
from docqa_tpu_torch.engines.spine import spine_issue

class B:
    def _on_lane(self, stage, fn):
        return spine_issue(stage, fn)

    def _loop(self):
        self._on_lane("serve_decode_chunk", lambda: torch.ones(2)).result()
        return spine_issue("undeclared_stage", lambda: torch.ones(2))

    def start(self):
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def stop(self):
        self._t.join()
"""})
    (tmp_path / "dispatch_streams.json").write_text(json.dumps({
        "streams": {}, "spine": {"stages": {
            "serve_decode_chunk": "chunk", "stale_stage": "gone"}}}))
    found = sorted(f.message for f in run(root, rules=["dispatch-streams"],
                                          package_name="fx"))
    assert len(found) == 2
    assert "'undeclared_stage' is not declared" in found[0]
    assert "stale spine stage 'stale_stage'" in found[1]


def test_wire_safety_flags_a_tensor_and_sanctions_the_ports_response(tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": """
import torch

from wirelib import to_wire


class Response:
    def __init__(self, status=200, payload=None):
        self.payload = payload

    def json_body(self):
        return to_wire(self.payload)


def handler(broker):
    emb = torch.zeros(4)
    broker.publish("q", {"embedding": emb})
    return Response(payload={"embedding": emb})
""", "wirelib.py": """
def to_wire(payload):
    return payload
"""})
    found = run(root, rules=["wire-safety"], package_name="fx")
    assert [f.message.split(" crosses")[0] for f in found] == ["device array"]
    assert "broker publish" in found[0].message


def test_wire_schema_reads_the_route_table_and_the_response_wrapper(tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": """
class App:
    def __init__(self):
        self.routes = [
            ("GET", "/health", self.health),
            ("GET", "/api/status", self.api_status),
        ]

    def health(self, req):
        if req:
            return Response(503, {"detail": "down"})
        return Response(payload={"status": "ok", "uptime_s": 1.0})

    def api_status(self, req):
        return Response(payload={"service": "s", "mesh": {}})
"""})
    (tmp_path / "api_contract.json").write_text(_contract({
        "GET /health": {"handler": "health", "version": 1,
                        "response": {"status": "str"}},
        "GET /api/status": {"handler": "api_status", "version": 1,
                            "response": {"service": "str"}},
        "GET /gone": {"handler": "gone", "version": 1, "response": {}},
    }))
    found = sorted(f.message for f in run(root, rules=["wire-schema"],
                                          package_name="fx"))
    # the 503 site carries the error shape; "mesh" is the profile's
    # documented exception on /api/status
    assert len(found) == 2
    assert "produces key 'uptime_s' not declared for GET /health" in found[0]
    assert "stale api_contract.json entry: no route registers GET /gone" in found[1]
    assert [why for route, key, why in PORT_PROFILE.wire_key_exceptions
            if (route, key) == ("GET /api/status", "mesh")]


def test_device_faults_must_pass_a_catch_all(tmp_path):
    ledger = json.loads(_TAX_LEDGER)
    ledger["faults"] = {"KernelError": {"module": "fixture.mod",
                                        "bases": ["RuntimeError"]}}
    root = _write(tmp_path / "fixture", {"mod.py": _TAX_CLASSES + """

class KernelError(RuntimeError):
    pass


def swallow(q):
    try:
        q.push()
    except Exception:
        return None


def narrow(q):
    try:
        q.push()
    except RuntimeError as e:
        log.warning("failed: %r", e)


def checked(q):
    try:
        q.push()
    except Exception as e:
        if is_device_fault(e):
            raise
        return None


def handed_on(q, item):
    try:
        q.push()
    except BaseException as e:
        item.error = e


def raises_fault(q):
    raise KernelError("launch failed")
"""})
    (tmp_path / "fixture" / "shed_taxonomy.json").write_text(json.dumps(ledger))
    found = run(root, rules=["shed-taxonomy"], package_name="fixture")
    assert sorted((f.symbol, f.message.split(" on the")[0]) for f in found) == [
        ("narrow", "except RuntimeError"), ("swallow", "except Exception")]
    # without a faults section (the reference's taxonomy) nothing of it fires
    ledger.pop("faults")
    (tmp_path / "fixture" / "shed_taxonomy.json").write_text(json.dumps(ledger))
    found = run(root, rules=["shed-taxonomy"], package_name="fixture")
    assert [f.message for f in found] == [
        "KernelError raised on the request path is not declared in shed_taxonomy.json"]


# ---------------------------------------------------------------------------
# the reference's own tree, under the reference's profile
# ---------------------------------------------------------------------------

REF_TREE_RULES = ("dispatch-streams", "retire-once", "shed-taxonomy",
                  "wire-schema", "wire-safety", "wire-consumer")


@pytest.fixture(scope="module")
def reference_tree():
    """docqa_tpu parsed once by each analyzer."""
    return JPackage.load(REF_PKG), Package.load(REF_PKG, profile=REF_PROFILE)


@pytest.mark.parametrize("rule", REF_TREE_RULES)
def test_reference_tree_findings_equal_reference(reference_tree, rule):
    jpkg, pkg = reference_tree
    ref = sorted(map(_key, j_run_package(jpkg, [rule])))
    port = sorted(map(_key, _run_package(pkg, [rule])))
    assert port == ref


_EMPTY_LEDGERS = {
    "dispatch-streams": (JDispatchStreamsChecker, DispatchStreamsChecker,
                         {"streams": {}, "budget": {}, "spine": {"stages": {}}}),
    "retire-once": (JRetireOnceChecker, RetireOnceChecker, {"sites": {}}),
    "shed-taxonomy": (JShedTaxonomyChecker, ShedTaxonomyChecker, {"sheds": {}}),
    "wire-schema": (JWireSchemaChecker, WireSchemaChecker, {"endpoints": {}}),
    "wire-consumer": (JWireConsumerChecker, WireConsumerChecker, {"endpoints": {}}),
}


@pytest.mark.parametrize("rule", sorted(_EMPTY_LEDGERS))
def test_reference_tree_with_an_empty_ledger_equals_reference(
        reference_tree, rule, tmp_path):
    """With nothing declared every thread, stage, site, raise and route of
    the reference's tree is a finding: the same ones in both."""
    jcls, pcls, empty = _EMPTY_LEDGERS[rule]
    path = str(tmp_path / "empty.json")
    with open(path, "w") as f:
        json.dump(empty, f)
    jpkg, pkg = reference_tree
    ref = sorted(map(_key, jcls(ledger_path=path).check(jpkg)))
    port = sorted(map(_key, pcls(ledger_path=path).check(pkg)))
    assert port == ref
    if rule != "wire-consumer":
        assert ref, f"the reference tree gives no {rule} finding: the check is vacuous"


def test_reference_tree_tables_equal_reference(reference_tree):
    """The rules' tables on the reference's tree: the dispatch owners and
    spine sites, the retiring functions, the request-path reach, the
    route table."""
    from docqa_tpu.analysis import dispatch_streams as j_ds
    from docqa_tpu.analysis import retire_once as j_ro
    from docqa_tpu.analysis import shed_taxonomy as j_st

    jpkg, pkg = reference_tree

    def names(p, ids):
        return sorted(f"{f.module.relpath}:{f.qualname}" for f in p.functions
                      if id(f.node) in ids or id(f) in ids)

    assert names(pkg, set(spine_aware_owners(pkg))) == names(
        jpkg, set(j_ds.spine_aware_owners(jpkg)))
    assert [(f.qualname, l, s) for f, l, s in enumerate_spine_sites(pkg)] == [
        (f.qualname, l, s) for f, l, s in j_ds.enumerate_spine_sites(jpkg)]
    def retiring(p, mod):
        return sorted(f"{fn.module.name}:{fn.qualname}" for fn in p.functions
                      if any(mod._is_retire_call(n)
                             for n in mod.RetireOnceChecker._own_calls(fn)))

    jret = retiring(jpkg, j_ro)
    assert retiring(pkg, p_ro) == jret and len(jret) == 20
    assert names(pkg, request_path_functions(pkg)) == names(
        jpkg, j_st.request_path_functions(jpkg))
    assert [(r.key, r.handler) for r in route_table(pkg)] == [
        (r.key, r.handler) for r in j_route_table(jpkg)]
    assert len(route_table(pkg)) == 29


# ---------------------------------------------------------------------------
# the port's tree against its own ledgers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_tree():
    return Package.load(package_dir())


def _ledger(name):
    with open(os.path.join(PORT_ANALYSIS, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("rule,checker", [
    ("dispatch-streams", DispatchStreamsChecker),
    ("retire-once", RetireOnceChecker),
    ("shed-taxonomy", ShedTaxonomyChecker),
])
def test_port_ledgers_are_the_ports_own_and_in_sync(port_tree, rule, checker):
    """Each rule finds its ledger in docqa_tpu_torch/analysis/ (not the
    reference's at the repository root), and its only findings on the
    port's tree are baselined ones (shed-taxonomy's caller-contract raises
    and host-side catches)."""
    from docqa_tpu_torch.analysis import Baseline, default_baseline_path
    from docqa_tpu_torch.analysis.core import package_ledger_path

    name = {"dispatch-streams": "dispatch_streams.json",
            "retire-once": "retirement_sites.json",
            "shed-taxonomy": "shed_taxonomy.json"}[rule]
    assert package_ledger_path(port_tree, name) == os.path.join(PORT_ANALYSIS, name)
    found = [f for f in checker().check(port_tree)
             if not port_tree.modules[0].is_suppressed(rule, f.line)]
    new, _matched, _stale = Baseline.load(default_baseline_path()).split(found)
    assert new == []
    if rule != "shed-taxonomy":
        assert found == []


def _mutated(tmp_path, name, mutate):
    data = _ledger(name)
    mutate(data)
    path = tmp_path / name
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("kind", ["undeclared", "stale"])
def test_port_dispatch_ledger_gated_both_ways(port_tree, kind, tmp_path):
    def mutate(d):
        if kind == "undeclared":
            del d["streams"]["engines/spine.py:DispatchSpine._lane_loop"]
            del d["spine"]["stages"]["store_search"]
        else:
            d["streams"]["engines/spine.py:DispatchSpine._gone"] = {"justification": "x"}
            d["spine"]["stages"]["gone_stage"] = "x"

    found = DispatchStreamsChecker(
        ledger_path=_mutated(tmp_path, "dispatch_streams.json", mutate)
    ).check(port_tree)
    msgs = sorted(f.message for f in found)
    assert len(msgs) == 2
    if kind == "undeclared":
        assert "unledgered device-dispatch stream 'engines/spine.py:DispatchSpine._lane_loop'" in msgs[1]
        assert "spine stage 'store_search' is not declared" in msgs[0]
    else:
        assert "stale dispatch_streams.json entry 'engines/spine.py:DispatchSpine._gone'" in msgs[0]
        assert "stale spine stage 'gone_stage'" in msgs[1]


@pytest.mark.parametrize("kind", ["undeclared", "stale"])
def test_port_retirement_ledger_gated_both_ways(port_tree, kind, tmp_path):
    def mutate(d):
        if kind == "undeclared":
            del d["sites"]["docqa_tpu_torch.engines.pool:EnginePool._fail"]
        else:
            d["sites"]["docqa_tpu_torch.engines.pool:EnginePool._gone"] = {}

    found = RetireOnceChecker(
        ledger_path=_mutated(tmp_path, "retirement_sites.json", mutate)
    ).check(port_tree)
    assert len(found) == 1
    want = ("undeclared retirement site docqa_tpu_torch.engines.pool:EnginePool._fail"
            if kind == "undeclared" else
            "stale retirement_sites entry: docqa_tpu_torch.engines.pool:EnginePool._gone")
    assert want in found[0].message


@pytest.mark.parametrize("kind", ["undeclared", "stale", "fault"])
def test_port_taxonomy_gated_both_ways(port_tree, kind, tmp_path):
    base = {(f.line, f.message) for f in ShedTaxonomyChecker().check(port_tree)}

    def mutate(d):
        if kind == "undeclared":
            del d["sheds"]["Draining"]
        elif kind == "stale":
            d["sheds"]["Vanished"] = dict(d["sheds"]["QueueFull"])
        else:
            d["faults"]["GoneFault"] = {"module": "docqa_tpu_torch.ops._kernels"}

    found = ShedTaxonomyChecker(
        ledger_path=_mutated(tmp_path, "shed_taxonomy.json", mutate)
    ).check(port_tree)
    extra = sorted(m for _l, m in {(f.line, f.message) for f in found} - base)
    assert extra, kind
    want = {"undeclared": "typed shed Draining (subclass of QueueFull) is not declared",
            "stale": "stale shed_taxonomy entry: class Vanished",
            "fault": "stale shed_taxonomy fault: class GoneFault"}[kind]
    assert any(want in m for m in extra), extra


def test_port_ledgers_justified():
    streams = _ledger("dispatch_streams.json")
    assert streams["streams"] and all(
        r.get("justification") and "TODO" not in r["justification"]
        for r in streams["streams"].values())
    assert all(streams["spine"]["stages"].values())
    assert streams["budget"]["max_concurrent_device_streams"] >= sum(
        1 for r in streams["streams"].values() if r.get("concurrent_with_serving"))
    sites = _ledger("retirement_sites.json")["sites"]
    assert len(sites) == 21 and all(r.get("kind") and r.get("note")
                                    for r in sites.values())
    tax = _ledger("shed_taxonomy.json")
    assert sorted(tax["faults"]) == ["AcceleratorError", "KernelError", "MeshFault"]


def test_port_taxonomy_keeps_the_references_contract():
    """The reference's fourteen classes, each with the reference's status,
    outcome and trace flag (the port drops none and adds none)."""
    root = os.path.dirname(package_dir())
    with open(os.path.join(root, "shed_taxonomy.json")) as f:
        ref = json.load(f)["sheds"]
    port = _ledger("shed_taxonomy.json")["sheds"]
    assert sorted(port) == sorted(ref) and len(port) == 14
    for name, entry in ref.items():
        keys = ("http_status", "cost_outcome", "trace_flag", "bases")
        assert {k: port[name].get(k) for k in keys} == {k: entry.get(k) for k in keys}
        assert port[name]["module"] == entry["module"].replace(
            "docqa_tpu.", "docqa_tpu_torch.", 1)


# ---------------------------------------------------------------------------
# the true positives the rules found in the port
# ---------------------------------------------------------------------------


def test_pool_monitor_fails_the_pool_on_a_device_fault():
    """shed-taxonomy: ``EnginePool._monitor_loop`` logged and ignored any
    exception of a tick, so a kernel or CUDA fault outside the rebuild and
    canary paths (a dead replica's teardown, a flush) was swallowed every
    tick while the pool kept routing onto a poisoned card.  The monitor now
    fails the pool on it, like those paths."""
    import torch

    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.pool import EnginePool
    from docqa_tpu_torch.ops._kernels import KernelError

    torch.set_num_threads(1)
    engine = GenerateEngine(
        DecoderConfig(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=256,
                      dtype="float32"),
        GenerateConfig(temperature=0.0, prefill_buckets=(16, 32), eos_id=2),
        seed=0, device="cpu",
    )
    pool = EnginePool(engine, replicas=1, n_slots=2, chunk=4, cache_len=128,
                      health_interval_s=0.02, canary_interval_s=3600.0,
                      device="cpu")
    err = KernelError("launch failed")
    fired = threading.Event()
    real = pool._reap_zombies

    def faulty():
        if not fired.is_set():
            fired.set()
            raise err
        real()

    pool._reap_zombies = faulty
    try:
        deadline = time.perf_counter() + 10
        while pool._failed is None and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert fired.is_set()
        assert pool._failed is err
        with pytest.raises(KernelError):
            pool.submit_ids([3, 5], max_new_tokens=2)
        assert all(r["state"] == "failed" for r in pool.status()["replicas"])
    finally:
        pool.stop()
