"""Port parity, the two runtime witnesses: ``docqa_tpu_torch.analysis``'s
``race_witness`` and ``ledger_audit`` against ``docqa_tpu.analysis``'s.

* The lock witness: the reference's witness scenarios
  (``tests/test_racecheck.py``'s ``_WITNESS_SRC`` and its variants), each
  run through the reference's witness and then the port's, each installed
  and uninstalled in turn.  Witnessed edges, cycles, the edges missing
  from the static graph and the blocking events must be equal, and
  ``uninstall`` must put ``threading``'s factories back.
* The ledger witness: one tiny seeded batcher workload (greedy, 2 slots,
  a shared prefix) through the reference's ``ContinuousBatcher`` under its
  witness and the port's under its own.  Both end with no leaked table,
  no unretired record and every witnessed site in the static map, and
  their counts are equal.
* The port's runtime: ``DocQARuntime`` at a tiny CPU config in a child
  process with ``DOCQA_RACE_WITNESS=1`` and ``DOCQA_LEDGER_WITNESS=1``
  answers ``/api/witness`` and ``/api/ledger`` with 200 and the contract's
  key trees while serving, and at quiesce shows no cycle, no blind spot,
  no leak and no unretired record.  Without the variables both routes
  answer 404.

Every child process runs under a timeout and every batcher is stopped.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

from docqa_tpu.analysis import ledger_audit as j_ledger
from docqa_tpu.analysis import race_witness as j_race
from docqa_tpu.analysis.wire_audit import validate_response
from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.engines.serve import ContinuousBatcher as JContinuousBatcher
from docqa_tpu_torch.analysis import ledger_audit, race_witness
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.serve import ContinuousBatcher

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120  # seconds any single result may take
CHILD_TIMEOUT = 240

# ---------------------------------------------------------------------------
# the lock witness: the reference's scenarios through both witnesses
# ---------------------------------------------------------------------------

PAIR = """
import threading


class Pair:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def ordered(self):
        with self._a_lock:
            with self._b_lock:
                return 1
"""

ALIAS = """
import threading


class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._other_lock = threading.Lock()

    def work(self):
        with self._cv:
            with self._other_lock:
                return 1
"""

CV_WAIT = """
import threading


class Q:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._cv = threading.Condition()

    def bad_wait(self):
        with self._a_lock:
            with self._cv:
                self._cv.wait(0.01)

    def bad_wait_for(self):
        with self._a_lock:
            with self._cv:
                self._cv.wait_for(lambda: True, 0.01)
                self._cv.notify_all()
"""

RLOCK = """
import threading


class Q:
    def __init__(self):
        self._lock = threading.RLock()

    def outer(self):
        with self._lock:
            return self.inner()

    def inner(self):
        with self._lock:
            return 1
"""


def _ordered(mod):
    mod.Pair().ordered()


def _blind_spot(mod):
    p = mod.Pair()
    with p._b_lock:
        with p._a_lock:
            pass


def _cycle(mod):
    p = mod.Pair()
    p.ordered()
    with p._b_lock:
        with p._a_lock:
            pass


def _unmapped(_mod):
    lock = threading.Lock()  # its creation site is in no id map
    assert type(lock).__name__ != "_WitnessLock"
    ev = threading.Event()  # its Condition is built inside threading.py
    ev.set()


SCENARIOS = {
    "edges_match_static": (PAIR, _ordered),
    "blind_spot": (PAIR, _blind_spot),
    "cycle": (PAIR, _cycle),
    "condition_alias": (ALIAS, lambda mod: mod.Q().work()),
    "cv_wait_under_held_lock": (CV_WAIT, lambda mod: mod.Q().bad_wait()),
    "cv_wait_for_under_held_lock": (CV_WAIT, lambda mod: mod.Q().bad_wait_for()),
    "unmapped_locks_stay_plain": (PAIR, _unmapped),
    "reentrant_rlock": (RLOCK, lambda mod: mod.Q().outer()),
}


def _witness_run(pkg, src, action, tmp_path, name):
    """One scenario through one package's witness: its id map from the
    fixture, installed, the module loaded and driven, uninstalled."""
    root = tmp_path / name
    root.mkdir()
    (root / "mod.py").write_text(textwrap.dedent(src))
    id_map, aliases, edges = pkg.build_lock_id_map([str(root)])
    witness = pkg.LockOrderWitness(id_map, aliases)
    witness.install()
    try:
        spec = importlib.util.spec_from_file_location(name, str(root / "mod.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        action(mod)
    finally:
        witness.uninstall()
    snap = witness.snapshot(static_edges=edges)
    return {
        "edges": snap["edges"],
        "cycles": snap["cycles"],
        "missing": snap["edges_missing_from_static"],
        "locks_seen": snap["locks_seen"],
        "static_edge_count": snap["static_edge_count"],
        "blocking": sorted(
            (b["op"], b["lock"], tuple(b["held"])) for b in snap["blocking"]
        ),
    }


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_lock_witness_equals_reference(scenario, tmp_path):
    src, action = SCENARIOS[scenario]
    real = (threading.Lock, threading.RLock, threading.Condition)
    ref = _witness_run(j_race, src, action, tmp_path, f"ref_{scenario}")
    assert (threading.Lock, threading.RLock, threading.Condition) == real
    port = _witness_run(race_witness, src, action, tmp_path, f"port_{scenario}")
    assert (threading.Lock, threading.RLock, threading.Condition) == real
    assert port == ref
    if scenario == "cycle":
        assert port["cycles"] == [["Pair._a_lock", "Pair._b_lock", "Pair._a_lock"]]
    if scenario == "blind_spot":
        assert ["Pair._b_lock", "Pair._a_lock"] in port["missing"]
    if scenario.startswith("cv_wait"):
        assert port["blocking"] == [("cv_wait", "Q._cv", ("Q._a_lock",))]


def test_condition_wrapper_passes_notify_and_wait_for_through(tmp_path):
    """What the port's code calls on a Condition (``wait_for``,
    ``notify_all``, ``notify``) works through the wrapper: a waiter
    released by another thread's notify_all sees its predicate."""
    root = tmp_path / "cvmod"
    root.mkdir()
    (root / "mod.py").write_text(textwrap.dedent("""
        import threading


        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.items = []

            def put(self, x):
                with self._cv:
                    self.items.append(x)
                    self._cv.notify_all()

            def take(self, timeout):
                with self._cv:
                    if not self._cv.wait_for(lambda: self.items, timeout):
                        return None
                    return self.items.pop()
    """))
    id_map, aliases, edges = race_witness.build_lock_id_map([str(root)])
    witness = race_witness.LockOrderWitness(id_map, aliases).install()
    try:
        spec = importlib.util.spec_from_file_location("cvmod", str(root / "mod.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        box = mod.Box()
        assert type(box._cv).__name__ == "_WitnessCondition"
        got = []
        t = threading.Thread(target=lambda: got.append(box.take(10.0)))
        t.start()
        box.put(7)
        t.join(timeout=10)
        assert not t.is_alive() and got == [7]
    finally:
        witness.uninstall()
    snap = witness.snapshot(static_edges=edges)
    assert snap["locks_seen"] == ["Box._lock"]
    assert snap["cycles"] == [] and snap["edges_missing_from_static"] == []


# ---------------------------------------------------------------------------
# the ledger witness: one batcher workload through both
# ---------------------------------------------------------------------------

DEC = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=256,
           dtype="float32")
CTX = [(3 + i * 7) % 120 + 1 for i in range(140)]  # past one 128-token prefix unit
PROMPTS = [[3, 5, 9, 4], CTX + [5, 9], CTX + [8, 4], [7], CTX + [6]]
KEYS = [None, "ctx", "ctx", None, "ctx"]


def _ledger_run(pkg, batcher_cls, engine):
    """Greedy, two slots, three prompts sharing a keyed prefix; stopped,
    then the witness's snapshot at quiesce."""
    witness = pkg.LedgerWitness(site_map=pkg.build_site_map()).install()
    try:
        b = batcher_cls(engine, n_slots=2, chunk=4, cache_len=256)
        try:
            handles = [
                b.submit_ids(p, max_new_tokens=6, prefix_key=k)
                for p, k in zip(PROMPTS, KEYS)
            ]
            streams = [h.result(timeout=WAIT) for h in handles]
        finally:
            b.stop()
    finally:
        witness.uninstall()
    return streams, witness.snapshot()


@pytest.fixture(scope="module")
def ledger_runs():
    ref_engine = JGenerateEngine(
        JDecoderConfig(**DEC),
        JGenerateConfig(temperature=0.0, prefill_buckets=(16, 64, 256), eos_id=2),
        seed=7,
    )
    port_engine = GenerateEngine(
        DecoderConfig(**DEC),
        GenerateConfig(temperature=0.0, prefill_buckets=(16, 64, 256), eos_id=2),
        seed=7, device="cpu",
    )
    return {
        "ref": _ledger_run(j_ledger, JContinuousBatcher, ref_engine),
        "port": _ledger_run(ledger_audit, ContinuousBatcher, port_engine),
    }


@pytest.mark.parametrize("side", ["ref", "port"])
def test_ledger_witness_quiesces_clean(ledger_runs, side):
    _streams, snap = ledger_runs[side]
    assert snap["leaked_tables"] == []
    assert snap["unretired_records"] == []
    assert snap["sites_missing_from_static"] == []
    assert snap["counts"]["tables_created"] > len(PROMPTS)  # the cache's pins too
    assert snap["counts"]["records_opened"] == len(PROMPTS)


def test_ledger_witness_counts_equal_reference(ledger_runs):
    ref_streams, ref = ledger_runs["ref"]
    port_streams, port = ledger_runs["port"]
    assert port_streams == ref_streams  # the same work, token for token
    assert port["counts"] == ref["counts"]


def test_ledger_witness_sites_are_the_ports():
    """The port's site map is built over docqa_tpu_torch: its kv-table and
    cost-record sites sit in the port's engines and obs, none in the
    reference's tree."""
    site_map = ledger_audit.build_site_map()
    pkg = os.path.join(REPO, "docqa_tpu_torch") + os.sep
    for proto in ("kv-table", "cost-record"):
        paths = {path for path, _line in site_map[proto]}
        assert paths and all(p.startswith(pkg) for p in paths), proto
    acquires = {
        (info["relpath"], info["symbol"])
        for info in site_map["kv-table"].values()
        if info["kind"] == "acquire"
    }
    assert ("engines/serve.py", "ContinuousBatcher._admit_round") in acquires or any(
        rel == "engines/serve.py" for rel, _sym in acquires
    )
    assert any(rel == "engines/paged.py" for rel, _sym in acquires)


# ---------------------------------------------------------------------------
# the port's runtime in a child process
# ---------------------------------------------------------------------------

CHILD = r"""
import json, os, sys, threading, urllib.error, urllib.request
root, out_path, mode = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
# first: both witnesses, before any other port import builds a lock
from docqa_tpu_torch.analysis import ledger_audit, race_witness
race_witness.maybe_install_from_env()
ledger_audit.maybe_install_from_env()
import torch
torch.set_num_threads(1)
from docqa_tpu_torch.config import load_config
from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

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
server = AppServer(make_app(rt)).start()
base = f"http://127.0.0.1:{server.port}"


def call(method, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


out = {}
try:
    if mode == "full":
        doc_ids = []
        for i in range(4):
            status, body = call("POST", "/ingest/?wait=1", {
                "filename": f"n{i}.txt", "patient_id": f"p{i % 2}",
                "text": f"Note {i}: patient seen for hypertension, lisinopril {10 + i} mg daily."})
            assert status == 200 and body["status"] == "INDEXED", body
            doc_ids.append(body["doc_id"])
        answers = [None] * 4

        def ask(i):
            answers[i] = call("POST", "/ask/", {"question": f"Quel traitement {i} ?"})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        out["witness_live"] = call("GET", "/api/witness")
        out["ledger_live"] = call("GET", "/api/ledger")
        for t in threads:
            t.join(timeout=120)
        out["asks"] = [a[0] if a else None for a in answers]
        out["delete"] = call("DELETE", f"/documents/{doc_ids[0]}")[0]
        out["witness_http"] = call("GET", "/api/witness")
        out["ledger_http"] = call("GET", "/api/ledger")
    else:
        out["witness_http"] = call("GET", "/api/witness")
        out["ledger_http"] = call("GET", "/api/ledger")
finally:
    out["server_closed"] = server.close(timeout=30)
    rt.stop()
out["witness_quiesced"] = race_witness.witness_snapshot()
out["ledger_quiesced"] = ledger_audit.ledger_snapshot()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def _run_child(tmp_path, mode, witnesses):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DOCQA_RACE_WITNESS", "DOCQA_LEDGER_WITNESS", "PYTHONPATH")}
    if witnesses:
        env.update(DOCQA_RACE_WITNESS="1", DOCQA_LEDGER_WITNESS="1")
    out_path = tmp_path / f"{mode}.json"
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, REPO, str(out_path), mode],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out_path) as f:
        return json.load(f)


def _contract():
    with open(os.path.join(REPO, "api_contract.json")) as f:
        return json.load(f)["endpoints"]


@pytest.fixture(scope="module")
def witnessed_runtime(tmp_path_factory):
    return _run_child(tmp_path_factory.mktemp("witness_rt"), "full", True)


def test_runtime_serves_both_witnesses_with_the_contracts_key_trees(witnessed_runtime):
    out = witnessed_runtime
    contract = _contract()
    for key, name in (("GET /api/witness", "witness"), ("GET /api/ledger", "ledger")):
        for when in ("live", "http"):
            status, body = out[f"{name}_{when}"]
            assert status == 200, (name, when, body)
            assert validate_response(contract[key], status, body) == [], (name, when, body)
    assert out["asks"] == [200, 200, 200, 200]
    assert out["delete"] == 200
    assert out["server_closed"]


def test_runtime_witnesses_quiesce_without_cycle_blind_spot_or_leak(witnessed_runtime):
    w = witnessed_runtime["witness_quiesced"]
    led = witnessed_runtime["ledger_quiesced"]
    assert w["cycles"] == []
    assert w["edges_missing_from_static"] == []
    assert w["edges"], "the runtime witnessed no lock-order edge"
    assert led["leaked_tables"] == []
    assert led["unretired_records"] == []
    assert led["sites_missing_from_static"] == []
    assert led["counts"]["tables_created"] > 0
    assert led["counts"]["records_opened"] >= 4


def test_runtime_without_the_variables_answers_404(tmp_path):
    out = _run_child(tmp_path, "routes", False)
    contract = _contract()
    for key, name in (("GET /api/witness", "witness"), ("GET /api/ledger", "ledger")):
        status, body = out[f"{name}_http"]
        assert status == 404
        assert validate_response(contract[key], status, body) == []
    assert out["witness_quiesced"] is None and out["ledger_quiesced"] is None


def test_the_burn_probe_is_read_outside_the_batchers_lock():
    """Phase 19's witness on the card saw ``ContinuousBatcher._cv ->
    BurnRateEvaluator._lock``, an order the static graph lacks: a batcher
    with a QoS policy read the SLO burn probe (the evaluator's ``firing``,
    under its lock) while holding its own condition.  The probe is now read
    before the batcher's lock, so the two never nest."""
    from docqa_tpu_torch.config import QoSConfig

    cfg = DecoderConfig(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
                        num_kv_heads=2, head_dim=16, mlp_dim=64, max_seq_len=128,
                        dtype="float32")
    engine = GenerateEngine(cfg, GenerateConfig(max_new_tokens=2), device="cpu")
    b = ContinuousBatcher(engine, n_slots=2, chunk=2, cache_len=64, qos=QoSConfig())
    held = []

    def probe():
        held.append(b._cv._is_owned())
        return []

    b.set_slo_probe(probe)
    try:
        b.submit_ids([3, 4, 5], max_new_tokens=2).result(timeout=60)
    finally:
        b.stop()
    assert held == [False]
