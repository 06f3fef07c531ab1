"""Port parity, the analyzer's determinism half: ``docqa_tpu_torch.analysis``
held against ``docqa_tpu.analysis`` for rng-discipline,
replay-key-integrity, order-stability and entropy-in-state, the entropy
classifier, the replay witness's pure functions and its two-process gate.

* The shared fixtures: every ``run_fixture`` call of the reference's
  ``tests/test_detcheck.py`` rule classes, harvested by running those tests
  against an in-memory copy of the reference analyzer (no file written),
  then written to ``tmp_path`` and run through both analyzers.  The
  findings must be equal as (rule, path, line, symbol, message).
  rng-discipline's subject is a JAX key, so its fixtures run under the
  reference's profile; the other three under the port's.  The torch
  counterparts of rng-discipline run under the port's profile below.
* The reference tree: under the reference's profile the four rules give
  the reference's findings on ``docqa_tpu/``, with the real scopes and
  with every module in scope (the real scopes find nothing there).
* The replay witness: the reference's transcript and manifest tests run
  against the port's functions; the port's manifest gated both ways; the
  smoke in two interpreters under different hash seeds; the port's
  transcript against the reference's smoke, section by section; a salted
  ``hash()`` planted in a copy of the port's prefix key fails both the
  static gate and the witness.
* The subjectless trip-wire: jit-purity, donation and retrace-hazard have
  no subject in the port; a construct that would give one fails.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import test_detcheck as ref_det
from docqa_tpu.analysis import run as j_run
from docqa_tpu.analysis.core import Module as JModule
from docqa_tpu.analysis.core import Package as JPackage
from docqa_tpu.analysis.core import _run_package as j_run_package
from docqa_tpu.analysis import entropy as j_entropy
from docqa_tpu.analysis import entropy_state as j_es
from docqa_tpu.analysis import order_stability as j_os
from docqa_tpu.analysis import replay_keys as j_rk
from docqa_tpu.analysis import rng_discipline as j_rng
from docqa_tpu_torch.analysis import PORT_PROFILE, Package, all_checkers, run
from docqa_tpu_torch.analysis import replay_audit as ra
from docqa_tpu_torch.analysis.core import _run_package, package_dir
from docqa_tpu_torch.analysis.entropy import enumerate_entropy_sites
from docqa_tpu_torch.analysis.subjectless import subject_sites
from test_torch_analysis import REF_PKG, REF_PROFILE, REPO, _key, _write

torch.set_num_threads(1)

DET_RULES = ("entropy-in-state", "order-stability", "replay-key-integrity",
             "rng-discipline")
# whose fixtures' subject is a JAX construct: run under the reference's
# profile (the port's has no JAX tables)
JAX_SUBJECT_RULES = frozenset({"rng-discipline", "dtype-flow", "mesh-axes", "spec-shape"})


# ---------------------------------------------------------------------------
# harvesting the reference's fixtures (shared with the num- and shardcheck
# files)
# ---------------------------------------------------------------------------


def _mem_findings(rule, sources, pkg="fixture"):
    """The reference analyzer's findings on ``sources`` parsed in memory."""
    mods = []
    for name, src in sources.items():
        dotted = name[: -len(".py")].replace("/", ".")
        if dotted.endswith(".__init__"):
            dotted = dotted[: -len(".__init__")]
        mods.append(JModule(f"/{pkg}/{name}", name, textwrap.dedent(src), f"{pkg}.{dotted}"))
    return j_run_package(JPackage(mods), [rule])


def harvest(module, class_names, subjectless=()):
    """``pytest.param(rule, sources, id=...)`` for every ``run_fixture``
    call the reference's test classes make (each test run against the
    in-memory reference analyzer, so its own assertions hold), and the ids
    of the classes in ``subjectless`` (listed, not compared)."""
    params, listed = [], []
    orig = module.run_fixture
    for cname in list(class_names) + list(subjectless):
        cls = getattr(module, cname)
        for mname in sorted(n for n in vars(cls) if n.startswith("test_")):
            calls = []

            def spy(_tmp_path, rule, sources, _calls=calls):
                srcs = {k: textwrap.dedent(v) for k, v in sources.items()}
                _calls.append((rule, srcs))
                return _mem_findings(rule, srcs)

            module.run_fixture = spy
            try:
                getattr(cls(), mname)(pathlib.Path("/nonexistent"))
            finally:
                module.run_fixture = orig
            for i, (rule, srcs) in enumerate(calls):
                tid = f"{cname}.{mname}" + (f"#{i}" if len(calls) > 1 else "")
                if cname in subjectless:
                    listed.append((rule, tid))
                else:
                    params.append(pytest.param(rule, srcs, id=tid))
    return params, listed


def assert_fixture_equal(rule, sources, tmp_path):
    root = _write(tmp_path / "fixture", sources)
    profile = REF_PROFILE if rule in JAX_SUBJECT_RULES else PORT_PROFILE
    ref = sorted(map(_key, j_run(root, rules=[rule], package_name="fixture")))
    port = sorted(map(_key, run(root, rules=[rule], package_name="fixture",
                                profile=profile)))
    assert port == ref


FIXTURES, _ = harvest(ref_det, ("TestRngDiscipline", "TestReplayKeyIntegrity",
                                "TestOrderStability", "TestEntropyInState"))


def test_fixture_inventory():
    """Every rule fixture of the reference's detcheck tests is here."""
    assert {p.values[0] for p in FIXTURES} == set(DET_RULES)
    assert len(FIXTURES) == 34
    assert set(DET_RULES) <= set(all_checkers())


@pytest.mark.parametrize("rule,sources", FIXTURES)
def test_fixture_findings_equal_reference(rule, sources, tmp_path):
    assert_fixture_equal(rule, sources, tmp_path)


# ---------------------------------------------------------------------------
# the reference's own tree, under the reference's profile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_tree():
    return JPackage.load(REF_PKG), Package.load(REF_PKG, profile=REF_PROFILE)


@pytest.mark.parametrize("rule", DET_RULES)
def test_reference_tree_findings_equal_reference(reference_tree, rule):
    jpkg, pkg = reference_tree
    assert sorted(map(_key, _run_package(pkg, [rule]))) == sorted(
        map(_key, j_run_package(jpkg, [rule])))


_SCOPES = {"replay-key-integrity": (j_rk, "PERSIST_KEY_MODULES", "replay_key_modules"),
           "entropy-in-state": (j_es, "STATE_MODULES", "state_modules"),
           "order-stability": (j_os, "ORDER_MODULES", "order_modules"),
           "rng-discipline": (j_rng, "RNG_SCOPE_MODULES", "rng_modules")}


@pytest.mark.parametrize("rule", DET_RULES)
def test_reference_tree_findings_equal_with_every_module_in_scope(
        reference_tree, rule, monkeypatch):
    """The real scopes find nothing on the reference's tree, so the same
    comparison with every module of it in scope: order-stability and
    rng-discipline then fire, and the two analyzers must agree."""
    jpkg, _ = reference_tree
    mod, attr, field = _SCOPES[rule]
    every = frozenset(m.name for m in jpkg.modules)
    monkeypatch.setattr(mod, attr, every)
    profile = dataclasses.replace(
        REF_PROFILE, **{field: frozenset(n.partition(".")[2] for n in every)})
    pkg = Package.load(REF_PKG, profile=profile)
    ref = sorted(map(_key, j_run_package(jpkg, [rule])))
    assert sorted(map(_key, _run_package(pkg, [rule]))) == ref
    if rule in ("order-stability", "rng-discipline"):
        assert ref


def test_entropy_sites_equal_reference(tmp_path):
    """The classifier and the manifest's enumeration under the reference's
    tables, on the reference's tree and on a fixture of every kind."""
    src = {"mod.py": """
        import os, secrets, time, uuid, random
        import numpy as np
        from datetime import datetime

        KEY = os.urandom(8)

        def mint(seed):
            rng = np.random.default_rng(seed)
            r = random.Random(seed)
            return uuid.uuid4(), secrets.token_hex(4), time.time(), datetime.now(), time.monotonic()
    """}
    root = _write(tmp_path / "fx", src)
    for path, name in ((root, "fx"), (REF_PKG, None)):
        ref = j_entropy.enumerate_entropy_sites(JPackage.load(path, package_name=name))
        port = enumerate_entropy_sites(Package.load(path, package_name=name,
                                                    profile=REF_PROFILE))
        assert port == ref and ref


def test_port_entropy_kinds(tmp_path):
    """The port's rng kind: torch's global seed and a Generator's seed."""
    root = _write(tmp_path / "fx", {"mod.py": """
        import torch

        def seeded(seed, device):
            torch.manual_seed(seed)
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            return g
    """})
    sites = enumerate_entropy_sites(Package.load(root, package_name="fx"))
    assert [(s["kind"], s["call"]) for s in sites] == [
        ("rng", "torch.Generator.manual_seed"), ("rng", "torch.manual_seed")]


# ---------------------------------------------------------------------------
# rng-discipline on the port's subject
# ---------------------------------------------------------------------------

_PRAGMA = "# docqa-lint: request-path\n"
_RNG_PORT = [
    pytest.param("""
import torch

def sample(probs):
    return torch.multinomial(probs, 1)
""", ["without generator="], id="global_generator_draw"),
    pytest.param("""
import torch

def sample(probs, g):
    return torch.multinomial(probs, 1, generator=g)
""", [], id="explicit_generator_clean"),
    pytest.param("""
def noise(x):
    return x.bernoulli_(0.5)
""", ["without generator="], id="in_place_sampler"),
    pytest.param("""
import torch

def reseed(seed):
    torch.manual_seed(seed)
""", ["reseeds the process-global"], id="global_reseed"),
    pytest.param("""
import torch

def per_request(device):
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g
""", ["literal seed"], id="literal_generator_seed"),
    pytest.param("""
import torch

def per_request(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
""", [], id="request_seed_clean"),
    pytest.param("""
import numpy as np

def jitter():
    return np.random.rand()
""", ["global numpy RNG"], id="module_numpy_rng"),
]


@pytest.mark.parametrize("src,expect", _RNG_PORT)
def test_rng_discipline_on_the_ports_subject(src, expect, tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": _PRAGMA + src})
    found = run(root, rules=["rng-discipline"], package_name="fx")
    assert len(found) == len(expect), [f.format() for f in found]
    for f, what in zip(found, expect):
        assert what in f.message
    # off the request path the rule is silent
    root = _write(tmp_path / "off", {"mod.py": src})
    assert run(root, rules=["rng-discipline"], package_name="off") == []


# ---------------------------------------------------------------------------
# the replay witness's pure functions: the reference's tests on the port's
# ---------------------------------------------------------------------------

_PURE = [(cls, name) for cls in ("TestCompareTranscripts", "TestManifestGate")
         for name in sorted(vars(getattr(ref_det, cls))) if name.startswith("test_")
         # the reference's own tree gate, not a fixture: the port's is below
         and name != "test_checked_in_manifest_in_sync"]


@pytest.mark.parametrize("cls,name", _PURE, ids=[f"{c}.{n}" for c, n in _PURE])
def test_replay_functions_pass_the_references_tests(cls, name, monkeypatch):
    for fn in ("compare_transcripts", "load_manifest", "manifest_split",
               "manifest_todos", "updated_manifest"):
        monkeypatch.setattr(ref_det, fn, getattr(ra, fn))
    getattr(getattr(ref_det, cls)(), name)()


def test_prefix_key_divergence_attributed():
    a = ref_det._transcript()
    b = json.loads(json.dumps(a))
    a["decode"]["prefix_keys"], b["decode"]["prefix_keys"] = ["k:1"], ["k:2"]
    report = ra.compare_transcripts(a, b)
    assert report["first_divergence"]["request"] == "prefix-keys"


def test_port_manifest_in_sync_and_justified():
    gate = ra.manifest_gate()
    assert gate["entries"] and not gate["new"] and not gate["stale"] and not gate["todo"]
    assert os.path.dirname(ra.default_manifest_path()) == os.path.join(
        REPO, "docqa_tpu_torch", "analysis")


def test_manifest_gate_fails_new_stale_and_todo(tmp_path):
    """A copy of the port's manifest: a site left out is NEW, an entry
    for a site that is gone is STALE, a regenerated entry reads TODO."""
    path = str(tmp_path / "m.json")
    entries = ra.load_manifest(ra.default_manifest_path())
    gone = dict(entries[0], path="nowhere.py")
    ra.save_manifest(path, entries[1:] + [gone])
    gate = ra.manifest_gate(manifest_path=path)
    assert [s["path"] for s in gate["new"]] == [entries[0]["path"]]
    assert [e["path"] for e in gate["stale"]] == ["nowhere.py"]
    gate = ra.manifest_gate(manifest_path=path, write=True)
    assert not gate["new"] and not gate["stale"]
    assert [e["path"] for e in gate["todo"]] == [entries[0]["path"]]


# ---------------------------------------------------------------------------
# the two-process witness
# ---------------------------------------------------------------------------


def test_replay_smoke_equal_across_hash_seeds(tmp_path):
    """The smoke at test width (float32, the CPU) in two interpreters at
    once under PYTHONHASHSEED 0 and 1: bitwise-equal transcripts."""
    runs = ra.spawn_runs(7, "cpu", "test", str(tmp_path), timeout_s=300)
    assert [r["python_hash_seed"] for r in runs] == ["0", "1"]
    report = ra.compare_transcripts(*runs)
    assert report["equal"], report["divergences"]
    assert len(runs[0]["decode"]["requests"]) == 11
    assert runs[0]["decode"]["spec_k"] == 4


@pytest.fixture(scope="module")
def reference_smoke():
    """The reference's smoke sections (``scripts/replay_audit.py``, loaded
    by path) and the port's, seed 7, in this process."""
    spec = importlib.util.spec_from_file_location(
        "ref_replay_audit", os.path.join(REPO, "scripts", "replay_audit.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ({"decode": ref._decode_section(7), "retrieval": ref._retrieval_section(7),
             "shadow": ref._shadow_section(7), "journal": ref._journal_section(7)},
            {"decode": ra.decode_section(7), "retrieval": ra.retrieval_section(7),
             "shadow": ra.shadow_section(7), "journal": ra.journal_section(7)})


@pytest.mark.parametrize("section", ["decode", "retrieval", "shadow", "journal"])
def test_port_transcript_equals_the_references(reference_smoke, section):
    """Section by section on seed 7: the decode streams identical (greedy,
    the tree drawn by the reference's host init), the retrieval ids equal
    (no score ties within the tie rule's 1e-4 here), the journal states and
    the shadow selection equal."""
    ref, port = (r[section] for r in reference_smoke)
    if section == "decode":
        assert port["spec_k"] == ref["spec_k"] == 4
        keys = ("id", "phase", "prompt_len", "tokens")
        assert [{k: r[k] for k in keys} for r in port["requests"]] == ref["requests"]
    else:
        assert port == ref


def test_planted_salted_hash_fails_the_gate_and_the_witness(tmp_path):
    """A salted ``hash()`` in a copy of the port's prefix key
    (``service/qa.py`` ``prefix_key_for``): replay-key-integrity flags it,
    and the two-process witness diverges on the key."""
    tree = tmp_path / "tree"
    shutil.copytree(package_dir(), tree / "docqa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    qa = tree / "docqa_tpu_torch" / "service" / "qa.py"
    src = qa.read_text()
    old = '    return f"{_TEMPLATE_HASH}:{h.hexdigest()[:16]}"'
    assert old in src
    qa.write_text(src.replace(
        old, '    return f"{_TEMPLATE_HASH}:{hash(tuple(chunks)) & 0xFFFFFFFF:08x}"'))
    found = run(str(tree / "docqa_tpu_torch"), rules=["replay-key-integrity"])
    assert [(f.path, f.symbol) for f in found] == [("service/qa.py", "prefix_key_for")]
    assert run(package_dir(), rules=["replay-key-integrity"]) == []
    runs = ra.spawn_runs(7, "cpu", "test", str(tmp_path), timeout_s=300, root=str(tree))
    report = ra.compare_transcripts(*runs)
    assert not report["equal"]
    assert report["first_divergence"]["request"] == "prefix-keys"


def _snippet(code, hash_seed):
    env = dict(os.environ, PYTHONHASHSEED=hash_seed)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_shadow_sampler_and_prefix_key_identical_across_processes():
    """The reference's two cross-process regressions on the port."""
    code = """
        from docqa_tpu_torch.obs.retrieval_observatory import RetrievalObservatory
        from docqa_tpu_torch.service.qa import prefix_key_for
        robs = RetrievalObservatory(sample_every=4, seed=11, frontier_every=0).start()
        try:
            print([i for i in range(96) if robs.sample()])
        finally:
            robs.stop()
        chunks = ["Patient presents with chest pain.", "History of hypertension."]
        print(prefix_key_for(chunks))
        print(prefix_key_for(list(reversed(chunks))))
    """
    a, b = _snippet(code, "0"), _snippet(code, "1")
    assert a == b
    selected, same, reordered = a.splitlines()
    assert selected != "[]" and same != reordered


# ---------------------------------------------------------------------------
# the subjectless trip-wire
# ---------------------------------------------------------------------------

SUBJECTLESS = ("jit-purity", "donation", "retrace-hazard")


@pytest.mark.parametrize("rule", SUBJECTLESS)
def test_subjectless_rules_have_no_subject_in_the_port(rule):
    """The port's tree holds no construct that would give ``rule`` a
    subject while the profile lists it as subjectless.  A change that adds
    one (``torch.compile``, ``torch.jit``, a CUDA graph capture, a
    ``donate`` argument) ports the rule's form for it with the change."""
    entry = {e[0]: e for e in PORT_PROFILE.subjectless}[rule]
    assert entry[1] and entry[2]
    assert rule not in all_checkers()
    sites = subject_sites(Package.load(package_dir()), rule)
    assert sites == [], f"{rule} has a subject in the port now: {sites}"


@pytest.mark.parametrize("construct,rule", [
    ("step = torch.compile(step)", "jit-purity"),
    ("g = torch.cuda.CUDAGraph()", "retrace-hazard"),
    ("fn = torch.jit.script(fn)", "jit-purity"),
    ("out = run(x, donate_argnums=(0,))", "donation"),
])
def test_trip_wire_sees_a_planted_construct(construct, rule, tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": f"""
        import torch

        def f(step, fn, run, x):
            {construct}
    """})
    sites = subject_sites(Package.load(root, package_name="fx"), rule)
    assert sites and sites[0]["path"] == "mod.py"


# ---------------------------------------------------------------------------
# the fault phase 21 found: the card's k-means summed with float atomics
# ---------------------------------------------------------------------------


def test_kmeans_cell_sums_keep_index_add_on_the_cpu():
    """On a card ``index_add_`` adds with float atomics in no fixed order,
    so two builds of one corpus gave different tiers there (phase 21 (a),
    queue 3); the card now sums with ``index_put_(accumulate=True)``, which
    sorts the cell ids and adds in a fixed order.  On the CPU the sums stay
    ``index_add_``'s bit for bit, and the card's form equals them to
    float32 rounding."""
    from docqa_tpu_torch.index import ivf

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2 * 16384 + 77, 24, generator=g)
    assign = torch.randint(0, 37, (x.shape[0],), generator=g)
    plain = torch.zeros(37, 24).index_add_(0, assign, x)
    assert ivf.cell_sums(x, assign, 37).equal(plain)
    sorted_form = torch.zeros(37, 24).index_put_((assign,), x, accumulate=True)
    assert torch.allclose(sorted_form, plain, rtol=1e-5, atol=1e-4)
