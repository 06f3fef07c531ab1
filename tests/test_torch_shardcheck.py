"""Port parity, the analyzer's sharding half: mesh-axes, spec-shape and the
shard audit of ``docqa_tpu_torch.analysis`` held against
``docqa_tpu.analysis``.

* The shared fixtures: every ``run_fixture`` call of the reference's
  ``tests/test_shardcheck.py`` ``TestMeshAxes`` and ``TestSpecShape``
  (JAX subjects: the port runs them under the reference's profile) through
  both analyzers; ``TestDonation``'s and ``tests/test_analysis.py``
  ``TestJitPurity``'s fixtures are listed as subjectless.
* mesh-axes on the port's subject: no ``torch.distributed`` collective
  outside ``runtime/mesh.py``, every counted wrapper over a MeshContext
  data or model group, every site a string literal; the ring's P2P round
  (``ring_exchange``) is the true positive it found.
* spec-shape on the port's tuple specs, statically (a mutated copy of
  ``parallel/sharding.py``) and at run time on abstract shapes for the
  tiny, Mistral-7B and Llama-3-8B configurations (nothing allocated).
* The shard audit: the budget file whole and justified, its numbers
  holding the semantic rules; the reference's mutation cases on the port's
  measurements (a budget edit cannot relax a rule); the 1x1 mesh measured
  here equal to the budget's.  The worlds' counts are read by
  ``tests/test_torch_mesh_tp.py`` and ``tests/test_torch_mesh_train.py``.
"""

import copy
import shutil

import pytest
import torch

import test_analysis as ref_analysis
import test_shardcheck as ref_shard
from docqa_tpu.analysis.core import Package as JPackage
from docqa_tpu.analysis.core import _run_package as j_run_package
from docqa_tpu_torch.analysis import Package, all_checkers, run
from docqa_tpu_torch.analysis import shard_audit as sa
from docqa_tpu_torch.analysis.core import _run_package, package_dir
from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.engines.paged import init_paged_pools
from docqa_tpu_torch.models.decoder import decoder_param_schema, init_kv_cache
from docqa_tpu_torch.parallel import sharding as S
from docqa_tpu_torch.runtime.mesh import MeshContext
from test_torch_analysis import REF_PKG, REF_PROFILE, _key
from test_torch_detcheck import assert_fixture_equal, harvest

torch.set_num_threads(1)

FIXTURES, SUBJECTLESS = harvest(ref_shard, ("TestMeshAxes", "TestSpecShape"),
                                subjectless=("TestDonation",))
_, JIT_SUBJECTLESS = harvest(ref_analysis, (), subjectless=("TestJitPurity",))


def test_fixture_inventory():
    assert {p.values[0] for p in FIXTURES} == {"mesh-axes", "spec-shape"}
    assert len(FIXTURES) == 15
    assert {r for r, _ in SUBJECTLESS} == {"donation"} and len(SUBJECTLESS) == 5
    assert {r for r, _ in JIT_SUBJECTLESS} == {"jit-purity"} and JIT_SUBJECTLESS
    assert {"mesh-axes", "spec-shape"} <= set(all_checkers())
    assert not {"donation", "jit-purity"} & set(all_checkers())


@pytest.mark.parametrize("rule,sources", FIXTURES)
def test_fixture_findings_equal_reference(rule, sources, tmp_path):
    assert_fixture_equal(rule, sources, tmp_path)


@pytest.mark.parametrize("rule", ["mesh-axes", "spec-shape"])
def test_reference_tree_findings_equal_reference(rule):
    ref = sorted(map(_key, j_run_package(JPackage.load(REF_PKG), [rule])))
    port = sorted(map(_key, _run_package(Package.load(REF_PKG, profile=REF_PROFILE),
                                         [rule])))
    assert port == ref


# ---------------------------------------------------------------------------
# mesh-axes on the port's subject
# ---------------------------------------------------------------------------

_MESH_HOME = """
import torch.distributed as dist

def count_collective(op, site):
    pass

def all_reduce(t, group, site):
    dist.all_reduce(t, group=group)
    count_collective("all_reduce", site)
    return t
"""

_MESH_PORT = [
    pytest.param("""
from fixture.runtime.mesh import all_reduce

def forward(x, mesh):
    return all_reduce(x, mesh.model_group, "decoder")
""", [], id="counted_wrapper_clean"),
    pytest.param("""
import torch.distributed as dist

def rotate(t, group):
    return dist.batch_isend_irecv([])
""", ["collective torch.distributed.batch_isend_irecv() outside runtime/mesh.py"],
        id="collective_outside_the_mesh_module"),
    pytest.param("""
import torch.distributed as dist
from fixture.runtime.mesh import all_reduce

def agree(x):
    g = dist.new_group(backend="gloo")
    return all_reduce(x, g, "agree")
""", ["over group 'g', which does not resolve"], id="group_off_the_mesh"),
    pytest.param("""
from fixture.runtime.mesh import all_reduce

def helper(mesh):
    return mesh.data_group, 4

def grads(x, mesh, name):
    group, n = helper(mesh)
    return all_reduce(x, group, name)
""", ["site 'name' is not a string literal"], id="site_not_literal"),
    pytest.param("""
from fixture.runtime.mesh import all_reduce

class Layer:
    def __init__(self, mesh):
        self.group = mesh.model_group

    def forward(self, x):
        def inner():
            return all_reduce(x, self.group, "layer")
        return inner()
""", [], id="class_attribute_and_closure_clean"),
]


@pytest.mark.parametrize("src,expect", _MESH_PORT)
def test_mesh_axes_on_the_ports_subject(src, expect, tmp_path):
    root = tmp_path / "fixture"
    (root / "runtime").mkdir(parents=True)
    (root / "__init__.py").write_text("")
    (root / "runtime" / "__init__.py").write_text("")
    (root / "runtime" / "mesh.py").write_text(_MESH_HOME)
    (root / "mod.py").write_text(src)
    found = run(str(root), rules=["mesh-axes"])
    assert len(found) == len(expect), [f.format() for f in found]
    for f, what in zip(found, expect):
        assert what in f.message and f.path == "mod.py"


def test_port_tree_mesh_axes_findings_are_the_side_groups():
    """The port's collectives all go through runtime/mesh.py's counted
    wrappers (the ring's P2P round moved there as ``ring_exchange``); the
    only findings are the two gloo side groups the baseline justifies."""
    found = run(package_dir(), rules=["mesh-axes"])
    assert sorted({(f.path, f.symbol) for f in found}) == [
        ("index/tiered.py", "TieredIndex._build_stage"),
        ("training/checkpoint.py", "TrainCheckpointer._write_sharded"),
    ]


# ---------------------------------------------------------------------------
# spec-shape on the port's subject
# ---------------------------------------------------------------------------


def _copy_tree(tmp_path):
    tree = tmp_path / "docqa_tpu_torch"
    shutil.copytree(package_dir(), tree, ignore=shutil.ignore_patterns("__pycache__"))
    return tree


def test_spec_shape_on_the_ports_tree(tmp_path):
    """The port's specs fit their leaves; a spec with an entry too many in
    a copy of ``parallel/sharding.py`` is a finding at its row."""
    assert run(package_dir(), rules=["spec-shape"]) == []
    tree = _copy_tree(tmp_path)
    path = tree / "parallel" / "sharding.py"
    src = path.read_text()
    old = '            f"l{i}_wo": (m, None),'
    assert old in src
    path.write_text(src.replace(old, '            f"l{i}_wo": (m, None, None),'))
    found = run(str(tree), rules=["spec-shape"])
    assert [(f.path, f.symbol) for f in found] == [("parallel/sharding.py",
                                                    "decoder_param_pspecs")]
    assert "'l{}_wo' has 3 entries but the array is rank 2" in found[0].message


def _mesh(n_model):
    return MeshContext(None, "data", "model", 1, n_model, 0, 0, torch.device("cpu"))


_CONFIGS = [
    pytest.param(DecoderConfig(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=8,
                               num_kv_heads=8, head_dim=16, mlp_dim=128, max_seq_len=128,
                               dtype="float32"), id="tiny"),
    pytest.param(DecoderConfig.mistral_7b(), id="mistral_7b"),
    pytest.param(DecoderConfig.llama3_8b(), id="llama3_8b"),
]


@pytest.mark.parametrize("cfg", _CONFIGS)
@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_every_spec_fits_its_leaf_on_abstract_shapes(cfg, n_model):
    """Every TreeLayout split dimension lies below its leaf's rank and every
    spec has its leaf's rank: parameters from the schema's shapes, the KV
    cache and the paged pool on the meta device (nothing allocated)."""
    layout = S.decoder_layout(cfg, _mesh(n_model))
    specs = S.decoder_param_pspecs(cfg, "model")
    for name, _kind, shape, _fan in decoder_param_schema(cfg):
        assert len(specs[name]) == len(shape), name
        dim = layout.dims[name]
        assert dim is None or dim < len(shape), name
        assert layout.shapes[name] == tuple(shape)
        if n_model > 1 and dim is not None:
            assert layout.local_shape(name)[dim] == -(-shape[dim] // n_model)
    mesh = _mesh(n_model)
    cache = init_kv_cache(cfg, 1, max_len=16, device="meta")
    pools = init_paged_pools(cfg, 4, 16, device="meta")
    for table, leaves in ((S.cache_pspecs(cfg, mesh), cache),
                          (S.paged_pool_pspecs(cfg, mesh), pools)):
        assert set(table) == set(leaves)
        for k, v in leaves.items():
            assert v.is_meta and len(table[k]) == v.dim(), k


# ---------------------------------------------------------------------------
# the shard audit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def budget():
    return sa.load_budget()


def test_budget_whole_justified_and_semantic(budget):
    progs = budget["programs"]
    assert sorted(progs) == sorted(sa.AUDIT_PROGRAMS)
    for name, prog in progs.items():
        assert sorted(prog["per_mesh"]) == sorted(sa.MESH_SHAPES), name
        assert prog["why"] and "TODO" not in prog["why"], name
    assert sa.budget_todos(budget) == []
    # the budget's own numbers, read as a measurement, hold every rule
    assert sa.semantic_violations(budget) == []
    assert sa.compare_budget(budget, budget) == []
    assert budget["jit_roots"] == {} and sa.enumerate_jit_roots() == []


def test_single_rank_mesh_measured_here_equals_the_budget(budget):
    """The 1x1 column of every program, measured in this process (no
    world): no collective anywhere."""
    measured = sa.audit_rank(["1x1"], sa.AUDIT_PROGRAMS)
    for name, prog in measured.items():
        assert prog["per_mesh"]["1x1"] == budget["programs"][name]["per_mesh"]["1x1"], name
    report = {"programs": measured}
    assert sa.semantic_violations(report) == []


def _report(budget):
    return {"programs": copy.deepcopy(budget["programs"]), "jit_roots": {"discovered": []}}


def test_replicated_row_parallel_weight_flips_red(budget):
    """The reference's 'simplify the specs' regression: ``wo`` replicated
    loses its all-reduces and gains gathers in the measurement."""
    report = _report(budget)
    counts = report["programs"]["decoder_tp_forward"]["per_mesh"]["1x4"]
    counts["all_reduce.decoder"] = 2
    counts["all_gather.decoder"] = 2
    violations = sa.semantic_violations(report)
    assert any("decoder_tp_forward/1x4" in v and "Megatron block" in v for v in violations)


def test_budget_edit_cannot_relax_semantics(budget, tmp_path):
    """A budget regenerated from a broken measurement still fails: the
    ring's n-th rotation, a third gather on the sharded probe, an
    all-reduce smuggled into it."""
    broken = _report(budget)
    ring = broken["programs"]["ring_attention"]["per_mesh"]["1x4"]
    ring["ring_round.ring_attention"] = ring["ring_size"]
    broken["programs"]["ivf_probe_sharded"]["per_mesh"]["2x2"]["all_gather.topk"] = 3
    broken["programs"]["sharded_topk"]["per_mesh"]["1x2"]["all_reduce.topk"] = 1
    path = str(tmp_path / "budget.json")
    sa.write_budget(broken, path)
    violations = sa.compare_budget(broken, sa.load_budget(path))
    assert any("n-1" in v for v in violations)
    assert any("ivf_probe_sharded/2x2" in v and "merge pair" in v for v in violations)
    assert any("sharded_topk/1x2" in v and "all_reduce.topk" in v for v in violations)
    # a budget written afresh carries a TODO why the gate refuses
    assert sorted(sa.budget_todos(sa.load_budget(path))) == sorted(sa.AUDIT_PROGRAMS)


def test_drift_missing_and_stale_flip_red(budget):
    report = _report(budget)
    report["programs"]["lm_train_step"]["per_mesh"]["2x2"]["all_reduce.lm_grads"] += 1
    del report["programs"]["ulysses_attention"]
    report["jit_roots"]["discovered"] = ["engines/x.py:12"]
    violations = sa.compare_budget(report, budget)
    assert any("lm_train_step/2x2: all_reduce.lm_grads" in v for v in violations)
    assert "budget program 'ulysses_attention' was not audited (stale?)" in violations
    assert any("new jit root 'engines/x.py:12'" in v for v in violations)
    # narrowed to one program, the others are not compared
    assert sa.compare_budget(_report(budget), budget, programs=["sharded_topk"]) == []


def test_ranks_that_disagree_flip_red(budget):
    ranks = [{"sharded_topk": {"meta": {}, "per_mesh": {"1x2": {"all_gather.topk": 2}}}},
             {"sharded_topk": {"meta": {}, "per_mesh": {"1x2": {"all_gather.topk": 3}}}}]
    merged, bad = sa.merge_ranks(ranks)
    assert merged == ranks[0] and bad and "rank 1 counted" in bad[0]
    report = _report(budget)
    report["rank_disagreements"] = bad
    assert any("ranks disagree" in v for v in sa.semantic_violations(report))
