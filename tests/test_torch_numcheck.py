"""Port parity, the analyzer's numerics half: dtype-flow and the compile
audit of ``docqa_tpu_torch.analysis`` held against ``docqa_tpu.analysis``.

* The shared fixtures: every ``run_fixture`` call of the reference's
  ``tests/test_numcheck.py`` ``TestDtypeFlow`` (its subject is jnp, so the
  port runs it under the reference's profile) through both analyzers;
  ``TestRetraceHazard``'s fixtures are listed as subjectless (the port
  traces nothing).  dtype-flow's torch idioms under the port's profile:
  bf16 reductions, softmax, float64 on the card, and the port's answer to
  ``preferred_element_type``: ``allow_bf16_reduced_precision_reduction``
  assigned False where the engines are built.
* The compile audit's mechanics: the reference's
  ``tests/test_compile_audit.py`` ``TestBudgetMechanics`` run against the
  port's module, and both modules' verdicts equal on its synthetic
  reports; the port's kernel half (the ptxas parser on a fixture log, a
  new spill, a register ceiling, regeneration that cannot launder) and its
  steady state; the port's budget file whole, justified and free of TODO.
"""

import copy
import json

import pytest
import torch

import test_compile_audit as ref_ca_tests
import test_numcheck as ref_num
from docqa_tpu.analysis import compile_audit as j_ca
from docqa_tpu.analysis.core import Package as JPackage
from docqa_tpu.analysis.core import _run_package as j_run_package
from docqa_tpu_torch.analysis import Package, all_checkers, run
from docqa_tpu_torch.analysis import compile_audit as ca
from docqa_tpu_torch.analysis.core import _run_package
from docqa_tpu_torch.ops import qmatmul as qm
from test_torch_analysis import REF_PKG, REF_PROFILE, _key, _write
from test_torch_detcheck import assert_fixture_equal, harvest

torch.set_num_threads(1)

FIXTURES, SUBJECTLESS = harvest(ref_num, ("TestDtypeFlow",), subjectless=("TestRetraceHazard",))


def test_fixture_inventory():
    assert {p.values[0] for p in FIXTURES} == {"dtype-flow"}
    assert len(FIXTURES) == 14
    assert {rule for rule, _id in SUBJECTLESS} == {"retrace-hazard"} and len(SUBJECTLESS) == 9
    assert "dtype-flow" in all_checkers() and "retrace-hazard" not in all_checkers()


@pytest.mark.parametrize("rule,sources", FIXTURES)
def test_fixture_findings_equal_reference(rule, sources, tmp_path):
    assert_fixture_equal(rule, sources, tmp_path)


def test_reference_tree_findings_equal_reference():
    ref = sorted(map(_key, j_run_package(JPackage.load(REF_PKG), ["dtype-flow"])))
    port = sorted(map(_key, _run_package(Package.load(REF_PKG, profile=REF_PROFILE),
                                         ["dtype-flow"])))
    assert port == ref


# ---------------------------------------------------------------------------
# dtype-flow on the port's subject
# ---------------------------------------------------------------------------

_DTYPE_PORT = [
    pytest.param("""
import torch

def pool(w):
    x = w.to(torch.bfloat16)
    return x.sum()
""", ["sum() reduces a bf16 value"], id="bf16_sum"),
    pytest.param("""
import torch

def pool(w):
    x = w.to(torch.bfloat16)
    return x.sum(dtype=torch.float32), x.float().mean()
""", [], id="upcast_sum_clean"),
    pytest.param("""
import torch

def probs(scores):
    s = scores.bfloat16()
    return torch.softmax(s, -1), s.log_softmax(-1)
""", ["log_softmax() over a bf16", "softmax() over a bf16"], id="bf16_softmax"),
    pytest.param("""
import torch

def probs(scores):
    s = scores.bfloat16()
    return torch.softmax(s, -1, dtype=torch.float32)
""", [], id="softmax_f32_clean"),
    pytest.param("""
import torch

def acc(x):
    return torch.zeros(4, dtype=torch.float64), x.double()
""", ["casts to float64", "float64 dtype passed to torch.zeros"], id="float64_on_card"),
    pytest.param("""
import numpy as np
import torch

def upload(n):
    a = np.zeros(n, dtype=np.float64)
    return torch.from_numpy(a)
""", ["float64 operand passed to torch.from_numpy"], id="float64_numpy_operand"),
    pytest.param("""
import numpy as np

def host(n):
    return np.zeros(n, dtype=np.float64).sum()
""", [], id="host_float64_alone_clean"),
    pytest.param("""
import torch

def proj(x, w):
    return x.to(torch.bfloat16) @ w
""", ["bf16 operand to '@' while torch.backends.cuda.matmul.allow_bf16_reduced"],
        id="bf16_product_unpinned"),
]


@pytest.mark.parametrize("src,expect", _DTYPE_PORT)
def test_dtype_flow_on_the_ports_subject(src, expect, tmp_path):
    root = _write(tmp_path / "fx", {"mod.py": src})
    found = sorted(run(root, rules=["dtype-flow"], package_name="fx"),
                   key=lambda f: f.message)
    assert len(found) == len(expect), [f.format() for f in found]
    for f, what in zip(found, sorted(expect)):
        assert what in f.message


def test_the_pin_sanctions_bf16_products(tmp_path):
    """A module of the package assigning the flag False is the port's
    ``preferred_element_type``: the same product is then clean."""
    src = "import torch\n\ndef proj(x, w):\n    return torch.matmul(x.to(torch.bfloat16), w)\n"
    pin = ("import torch\n\ndef pin():\n    torch.backends.cuda.matmul."
           "allow_bf16_reduced_precision_reduction = False\n")
    root = _write(tmp_path / "unpinned", {"mod.py": src})
    assert len(run(root, rules=["dtype-flow"], package_name="a")) == 1
    root = _write(tmp_path / "pinned", {"mod.py": src, "pin.py": pin})
    assert run(root, rules=["dtype-flow"], package_name="b") == []


def test_engines_pin_f32_accumulation(monkeypatch):
    """The flag is set once, where the package resolves a CUDA device (every
    engine, the mesh): a CPU resolution leaves it as it was."""
    from docqa_tpu_torch import utils
    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine

    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction", True)
    cfg = DecoderConfig(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
                        num_kv_heads=2, head_dim=16, mlp_dim=64, max_seq_len=64,
                        dtype="float32")
    GenerateEngine(cfg, GenerateConfig(max_new_tokens=2), device="cpu")
    assert flags.allow_bf16_reduced_precision_reduction is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert utils.resolve_device("cuda").type == "cuda"
    assert flags.allow_bf16_reduced_precision_reduction is False


def test_a_library_without_its_build_log_is_built_again(monkeypatch, tmp_path):
    """``build`` skips a source only when both its library and its ptxas log
    are there, so a library cached before the log was kept is rebuilt once
    and the compile audit can read its kernels."""
    from docqa_tpu_torch.ops import _kernels

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; '
                    'done\necho "ptxas info    : Used 40 registers"\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "build").mkdir()
    _kernels.library_path("qmatmul").write_bytes(b"")  # cached, no log
    assert set(_kernels.build(("qmatmul",))) == {"qmatmul"}
    assert "Used 40 registers" in _kernels.build_log("qmatmul")
    assert _kernels.build(("qmatmul",)) == {}  # library and log: skipped


# ---------------------------------------------------------------------------
# the compile audit's mechanics: the reference's tests on the port's module
# ---------------------------------------------------------------------------

_MECH = sorted(n for n in vars(ref_ca_tests.TestBudgetMechanics) if n.startswith("test_"))


@pytest.mark.parametrize("name", _MECH)
def test_budget_mechanics_pass_the_references_tests(name, monkeypatch, tmp_path):
    monkeypatch.setattr(ref_ca_tests, "ca", ca)
    method = getattr(ref_ca_tests.TestBudgetMechanics(), name)
    if "tmp_path" in method.__code__.co_varnames[:method.__code__.co_argcount]:
        method(tmp_path)
    else:
        method()


def _mutations():
    """The reference's synthetic report, and its mutations, as (report,
    budget) pairs."""
    base = ref_ca_tests.synthetic_report()
    out = [("clean", base, ref_ca_tests.budget_for(base))]

    def mutated(label, fn, budget_from_base=True):
        rep = copy.deepcopy(base)
        bud = ref_ca_tests.budget_for(base if budget_from_base else rep)
        fn(rep, bud)
        out.append((label, rep, bud))

    roots = lambda r: r["workloads"]["serve"]["roots"]  # noqa: E731
    mutated("retrace", lambda r, b: roots(r)["serve_decode"].update(steady_state_retraces=1))
    mutated("retrace_none", lambda r, b: roots(r)["serve_decode"].pop("steady_state_retraces"))
    mutated("drift", lambda r, b: roots(r)["serve_prefill"].update(compiles=6))
    mutated("peak", lambda r, b: roots(r)["serve_decode"].update(peak_bytes=10**7))
    mutated("no_peak", lambda r, b: roots(r)["serve_decode"].update(peak_bytes=0))
    mutated("todo_note", lambda r, b: b["workloads"]["serve"]["roots"]["serve_decode"].update(
        ceiling_note="TODO: justify"))
    mutated("new_root", lambda r, b: r["jit_roots"]["discovered"].append("x.py:f"))
    mutated("stale_root", lambda r, b: r["jit_roots"].update(discovered=[]))
    mutated("missing_root", lambda r, b: b["workloads"]["serve"]["roots"].pop("serve_decode"))
    mutated("paged", lambda r, b: r["workloads"]["serve"]["meta"].update(
        paged=True, token_buckets=[64], prefix_cache=True))
    return out


@pytest.mark.parametrize("label,report,budget", _mutations(), ids=lambda v: v if isinstance(v, str) else "")
def test_budget_verdicts_equal_reference(label, report, budget):
    assert ca.semantic_violations(report) == j_ca.semantic_violations(report)
    assert ca.compare_budget(report, budget) == j_ca.compare_budget(report, budget)


def test_write_budget_equal_reference(tmp_path):
    report = ref_ca_tests.synthetic_report()
    for mod, name in ((j_ca, "ref.json"), (ca, "port.json")):
        mod.write_budget(report, str(tmp_path / name))
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    ref.pop("_comment"), port.pop("_comment")
    assert port == ref


# ---------------------------------------------------------------------------
# the port's half: kernels and the steady state
# ---------------------------------------------------------------------------

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19flash_decode_kernelILi128ELi4EEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _Z19flash_decode_kernelILi128ELi4EEvPK13__nv_bfloat16
    536 bytes stack frame, 1096 bytes spill stores, 824 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 536 bytes cumulative stack size, 512 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19qmatmul_ring_kernelILi4ELi1EEvPKv' for 'sm_90a'
ptxas info    : Function properties for _Z19qmatmul_ring_kernelILi4ELi1EEvPKv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 141 registers, used 1 barriers, 128 bytes smem, 464 bytes cmem[0]
"""


def test_parse_ptxas_on_a_fixture_log():
    got = ca.parse_ptxas(_PTXAS, "k")
    assert sorted(got) == ["flash_decode_kernel<128,4>", "qmatmul_ring_kernel<4,1>"]
    dec = got["flash_decode_kernel<128,4>"]
    assert (dec["registers"], dec["spill_stores"], dec["spill_loads"], dec["stack_bytes"],
            dec["smem_bytes"], dec["source"]) == (255, 1096, 824, 536, 512, "k")
    ring = got["qmatmul_ring_kernel<4,1>"]
    assert (ring["registers"], ring["spill_stores"], ring["smem_bytes"]) == (141, 0, 128)


def _port_report(kernels=None, peaks=None, steady=None):
    kernels = kernels if kernels is not None else ca.parse_ptxas(_PTXAS)
    peaks = peaks or {name: 10**9 + i for i, name in enumerate(ca.ENTRY_POINTS)}
    steady = steady if steady is not None else {
        "int8_ask": {"plan_qmatmul": 0, "leaf_plans": 0, "tensor_maps": 0, "scratch": 0}}
    return ca.make_report(kernels, peaks, steady)


def _justified(budget):
    for wl in budget["workloads"].values():
        for root in wl["roots"].values():
            root["ceiling_note"] = "reviewed"
    for k in budget.get("kernels", {}).values():
        k["note"] = "reviewed"
    return budget


def test_port_report_clean_against_its_own_budget(tmp_path):
    report = _port_report()
    assert ca.semantic_violations(report) == []
    path = str(tmp_path / "b.json")
    budget = _justified(ca.write_budget(report, path))
    assert ca.compare_budget(report, budget) == []
    # the granted spill is the budget's; a kernel grows one more byte: red
    assert budget["kernels"]["flash_decode_kernel<128,4>"]["spill_stores"] == 1096
    grown = copy.deepcopy(report)
    grown["kernels"]["qmatmul_ring_kernel<4,1>"]["spill_stores"] = 8
    assert any("a new spill" in v for v in ca.compare_budget(grown, budget))
    grown["kernels"]["qmatmul_ring_kernel<4,1>"]["registers"] = 168
    assert any("over its ceiling" in v for v in ca.compare_budget(grown, budget))


def test_kernel_regeneration_cannot_launder(tmp_path):
    report = _port_report()
    path = str(tmp_path / "b.json")
    budget = _justified(ca.write_budget(report, path))
    with open(path, "w") as f:
        json.dump(budget, f)
    grown = copy.deepcopy(report)
    grown["kernels"]["qmatmul_ring_kernel<4,1>"]["registers"] = 200
    second = ca.write_budget(grown, path)
    assert "TODO" in second["kernels"]["qmatmul_ring_kernel<4,1>"]["note"]
    assert any("unjustified TODO" in v for v in ca.compare_budget(grown, second))
    # a fitting reading keeps the reviewed ceiling and note
    third = ca.write_budget(report, path)
    assert third["kernels"]["flash_decode_kernel<128,4>"] == budget["kernels"][
        "flash_decode_kernel<128,4>"]


def test_missing_readings_flip_red():
    assert any("no ptxas log was read" in v
               for v in ca.semantic_violations(_port_report(kernels={})))
    report = _port_report(peaks={"solo_ask": 5})
    assert any("batcher_round: no memory_analysis measurement" in v
               for v in ca.semantic_violations(report))
    bad = _port_report(steady={"int8_ask": {"plan_qmatmul": 0, "leaf_plans": 2,
                                            "tensor_maps": 0, "scratch": 1}})
    assert any("int8_ask: 3 steady-state retrace(s)" in v
               for v in ca.semantic_violations(bad))


def test_steady_state_reads_the_k4_host_state():
    """On the CPU K4 runs its plain version: a product builds nothing."""
    before = ca.steady_state()
    assert set(before) == {"plan_qmatmul", "leaf_plans", "tensor_maps", "scratch"}
    w = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    qm.qmatmul(torch.randn(4, 64), w, torch.rand(32) / 100)
    assert ca.steady_state_delta(before, ca.steady_state()) == dict.fromkeys(before, 0)


def test_port_budget_file_whole_and_justified():
    budget = ca.load_budget()
    roots = budget["workloads"]["main_path"]["roots"]
    assert sorted(roots) == sorted(ca.ENTRY_POINTS)
    for name, root in roots.items():
        assert root["peak_bytes_ceiling"] > 0, name
        assert root["ceiling_note"] and "TODO" not in root["ceiling_note"], name
    kernels = budget["kernels"]
    assert {k["source"] for k in kernels.values()} == set(ca.KERNEL_SOURCES)
    for sym, k in kernels.items():
        assert k["note"] and "TODO" not in k["note"], sym
        assert k["registers_ceiling"] <= 255, sym
    assert budget["jit_roots"] == {}
    # the budget's own numbers as a reading hold the gate
    as_report = {"kernels": {s: {"registers": k["registers_ceiling"],
                                 "spill_stores": k["spill_stores"],
                                 "spill_loads": k["spill_loads"],
                                 "stack_bytes": k["stack_bytes_ceiling"],
                                 "smem_bytes": k["smem_bytes_ceiling"]}
                             for s, k in kernels.items()}}
    assert ca.compare_budget(as_report, {"kernels": kernels}) == []
