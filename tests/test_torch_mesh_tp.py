"""Port parity, tensor-parallel decoding on a mesh: docqa_tpu_torch's
``GenerateEngine(mesh=)`` (Megatron layout, ``models/decoder.py``'s two
all-reduces a layer, the logits gathered once a forward) against
docqa_tpu's sharded engine on the same mesh shapes, on the CPU.

The process model is ``test_torch_mesh.py``'s: the reference in this
process on the conftest's 8 virtual CPU devices, the port SPMD in gloo
worlds of 2 and 4 processes (``tests/torch_mesh_worker.py``) on (1, 2),
(1, 4) and (2, 2).

Tolerances, float32:
* greedy ids (plain and K = 4 speculation, ``TP_CFG`` of
  tests/test_decoder.py) and quantised ids (tests/test_quant.py's TP
  cases): identical to the reference's sharded engine and to its
  single-device engine;
* first-step logits: 1e-5 relative RMS (a row-parallel product summed over
  the model axis adds its partial sums in another order than one product).

Collective budgets from ``runtime.mesh.COLLECTIVES``: a forward holds
2 x layers all-reduces and one logits gather and nothing else, one gather
of the streams over the data axis when it has more than one rank, none at
(1, 1).  The same worlds run the shard audit's programs
(``analysis/shard_audit.py``, the worker's ``shard_audit`` scenario), and
their report is held to the port's ``analysis/shard_budget.json``.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu.models import decoder as jdec
from docqa_tpu.models.quant import quantize_decoder_params as j_quantize
from docqa_tpu.parallel import sharding as jshard
from docqa_tpu.runtime import mesh as jmesh
from docqa_tpu_torch import weights
from docqa_tpu_torch.analysis import shard_audit
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.runtime import mesh as tmesh

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
_shape, _world_of, _counts = W.shape_of, W.world_of, W.counts_of
SHAPES = ["1x2", "1x4", "2x2"]
J_TP_CFG = JDecoderConfig(**W.TP_WIDTHS)
TP_CFG = DecoderConfig(**W.TP_WIDTHS)


def _int8_tree():
    """tests/test_quant.py's TP tree: the reference's device init quantised
    (only JAX can draw it), handed to the workers."""
    cfg = JDecoderConfig(**W.QUANT_WIDTHS)
    q = j_quantize(jdec.init_decoder_params(jax.random.PRNGKey(0), cfg))
    return {k: np.asarray(v) for k, v in q.items()}


@pytest.fixture(scope="module")
def int8_tree():
    return _int8_tree()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, int8_tree):
    """One gloo world of each size for the module, started at once; its
    ranks run every scenario of this file."""
    out = {}
    for n, scenarios in ((2, "tp_generate,quant_tp,shard_audit"),
                         (4, "tp_generate,quant_tp,shard_audit")):
        d = tmp_path_factory.mktemp(f"world{n}")
        np.savez(d / "inputs.npz", **{f"int8/{k}": v for k, v in int8_tree.items()})
        out[n] = W.World(n, scenarios, d)
    yield out
    for w in out.values():
        w.close()


def _world(worlds, tag):
    return worlds[_world_of(tag)]


def _jmesh(tag):
    d, m = _shape(tag)
    return jmesh.host_cpu_mesh(d * m, data=d)


# ---- tensor-parallel decoding ---------------------------------------------------

@pytest.fixture(scope="module")
def reference_ids():
    """The reference's greedy ids: its single-device engine and its sharded
    engine on each mesh shape, speculation off and on."""
    out = {}
    for k in (0, 4):
        gen = JGenerateConfig(max_new_tokens=6, speculative_k=k)
        out[("single", k)] = JGenerateEngine(J_TP_CFG, gen, seed=1).generate_ids(W.PROMPTS)
        for tag in SHAPES:
            out[(tag, k)] = JGenerateEngine(J_TP_CFG, gen, mesh=_jmesh(tag),
                                            seed=1).generate_ids(W.PROMPTS)
    return out


@pytest.mark.parametrize("spec", [0, 4], ids=["plain", "spec4"])
@pytest.mark.parametrize("tag", SHAPES)
def test_tp_greedy_ids_equal_the_reference(worlds, reference_ids, tag, spec):
    want = reference_ids[(tag, spec)]
    assert want == reference_ids[("single", spec)]  # test_tp8_matches_single_device
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result(f"tp_generate_{tag}", r)
        got = [[t for t in row if t >= 0] for row in res[f"spec{spec}/ids"].tolist()]
        assert got == want


@pytest.mark.parametrize("tag", SHAPES)
def test_tp_first_step_logits(worlds, tag):
    """Float32 prefill logits over the whole vocabulary within 1e-5
    relative RMS of the reference's forward over its sharded tree."""
    tree = {k: jnp.asarray(v) for k, v in weights.host_init_decoder_params(TP_CFG, 1).items()}
    mesh = _jmesh(tag)
    sharded = jshard.shard_decoder_params(tree, J_TP_CFG, mesh)
    ids = jnp.array([[3, 4, 5, 0], [9, 8, 7, 6]], jnp.int32)
    lengths = jnp.array([3, 4], jnp.int32)
    cache = jdec.init_kv_cache(J_TP_CFG, 2, max_len=128)
    fwd = jax.jit(lambda p, i, c, z, ln: jdec.decoder_forward(
        p, J_TP_CFG, i, c, z, attn_lengths=ln, last_token_only=True)[0])
    want = np.asarray(fwd(sharded, ids, cache, jnp.zeros_like(lengths), lengths))
    n_model = _shape(tag)[1]
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result(f"tp_generate_{tag}", r)
        got = res["logits"]
        assert got.shape == want.shape
        rel = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
        assert rel < 1e-5, rel
        assert int(res["cache_heads"]) == J_TP_CFG.num_kv_heads // n_model
        assert _counts(res, "prefill/") == {
            "all_reduce.decoder": 2 * J_TP_CFG.num_layers, "all_gather.logits": 1}


@pytest.mark.parametrize("tag", SHAPES)
def test_tp_collective_budget(worlds, tag):
    """2 x layers all-reduces and one logits gather a forward, and one
    gather of the streams over the data axis when it has more than one
    rank; nothing else.  The per-forward and per-call counts are the
    port's shard budget's (``analysis/shard_budget.json``
    ``decoder_tp_forward`` and ``generate_data_gather``), and this world's
    prefill forward holds the budget's semantic rules."""
    n_data = _shape(tag)[0]
    budget = shard_audit.load_budget()["programs"]
    assert budget["decoder_tp_forward"]["meta"]["num_layers"] == TP_CFG.num_layers
    per_forward = budget["decoder_tp_forward"]["per_mesh"][tag]
    per_call = budget["generate_data_gather"]["per_mesh"][tag]
    assert per_forward == {"all_reduce.decoder": 2 * TP_CFG.num_layers,
                           "all_gather.logits": 1}
    assert per_call == ({"all_gather.generate": 1} if n_data > 1 else {})
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result(f"tp_generate_{tag}", r)
        for run in ("spec0", "spec4", "sampled"):
            fw = int(res[f"{run}/forwards"])
            want = {k: v * fw for k, v in per_forward.items()}
            want.update(per_call)
            assert _counts(res, run + "/") == want, run
        measured = {"programs": {"decoder_tp_forward": {
            "meta": budget["decoder_tp_forward"]["meta"],
            "per_mesh": {tag: _counts(res, "prefill/")}}}}
        assert shard_audit.compare_budget(measured, {"programs": budget},
                                          programs=["decoder_tp_forward"]) == [
            f"decoder_tp_forward/{m}: present in budget only"
            for m in sorted(budget["decoder_tp_forward"]["per_mesh"]) if m != tag]


@pytest.mark.parametrize("tag", SHAPES)
def test_tp_sampling_agrees_across_the_model_group(worlds, tag):
    """At temperature 0.8 every rank of a model group draws the same tokens
    (one seeded generator a rank, the same gathered logits); the streams
    gathered over the data axis are then the same on every rank."""
    w = _world(worlds, tag)
    runs = [w.result(f"tp_generate_{tag}", r)["sampled/ids"] for r in range(_world_of(tag))]
    for ids in runs[1:]:
        np.testing.assert_array_equal(ids, runs[0])
    assert (runs[0][:, 0] >= 0).all()


@pytest.mark.parametrize("tag", SHAPES)
def test_tp_uneven_vocabulary_pads_the_gather(worlds, tag):
    """A vocabulary the model axis does not divide (the reference's
    device_put refuses one): the last rank's logits block is shorter, padded
    for the gather and cut after it; the ids equal the port's unsharded
    engine's and the reference's single-device engine's."""
    cfg = dataclasses.replace(J_TP_CFG, vocab_size=W.UNEVEN_VOCAB)
    want = JGenerateEngine(cfg, JGenerateConfig(max_new_tokens=6), seed=1
                           ).generate_ids(W.PROMPTS)
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result(f"tp_generate_{tag}", r)
        got = [[t for t in row if t >= 0] for row in res["uneven/ids"].tolist()]
        assert got == want
        np.testing.assert_array_equal(res["uneven/ids"], res["uneven/solo_ids"])


def test_tp_at_1x1_inserts_no_collective_and_no_copy():
    tree = {k: torch.from_numpy(v) for k, v in weights.host_init_decoder_params(TP_CFG, 1).items()}
    mesh = tmesh.make_mesh(device="cpu")
    eng = GenerateEngine(TP_CFG, GenerateConfig(max_new_tokens=6), params=tree,
                         device="cpu", mesh=mesh)
    assert all(eng.params[k].data_ptr() == tree[k].data_ptr() for k in tree)
    solo = GenerateEngine(TP_CFG, GenerateConfig(max_new_tokens=6), params=tree, device="cpu")
    tmesh.COLLECTIVES.clear()
    assert eng.generate_ids(W.PROMPTS) == solo.generate_ids(W.PROMPTS)
    assert not tmesh.COLLECTIVES


@pytest.fixture(scope="module")
def reference_quant_ids(int8_tree):
    gen = JGenerateConfig(max_new_tokens=6, prefill_buckets=(16,))
    cfg8 = JDecoderConfig(**W.QUANT_WIDTHS)
    cfgs = {"int8": (cfg8, {"params": {k: jnp.asarray(v) for k, v in int8_tree.items()}}),
            "int4": (dataclasses.replace(cfg8, quantize_weights=True, quant_bits=4), {}),
            "int4div": (JDecoderConfig(**W.INT4_DIV_WIDTHS, quantize_weights=True,
                                       quant_bits=4), {})}
    out = {}
    for kind, (cfg, kw) in cfgs.items():
        out[("single", kind)] = JGenerateEngine(cfg, gen, **kw).generate_ids([[5, 9, 11]])[0]
        for tag in SHAPES:
            out[(tag, kind)] = JGenerateEngine(cfg, gen, mesh=_jmesh(tag),
                                               **kw).generate_ids([[5, 9, 11]])[0]
    return out


@pytest.mark.parametrize("kind", ["int8", "int4", "int4div"])
@pytest.mark.parametrize("tag", SHAPES)
def test_quantised_tp_ids_equal_the_reference(worlds, reference_quant_ids, tag, kind):
    """tests/test_quant.py's TP cases (int8; int4 with one group a
    projection, replicated groups served through the covering groups) and
    an int4 config whose groups divide the axis, with an uneven vocabulary
    at n = 4."""
    want = reference_quant_ids[(tag, kind)]
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result(f"quant_tp_{tag}", r)
        assert [t for t in res[kind].tolist() if t >= 0] == want
        fw = _counts(res, kind + "/")
        assert fw.pop("all_gather.generate", 0) == (_shape(tag)[0] > 1)
        assert set(fw) == {"all_reduce.decoder", "all_gather.logits"}
        assert fw["all_reduce.decoder"] == 2 * (1 if kind == "int4div" else 2) * fw[
            "all_gather.logits"]


def test_shard_budget_over_the_worlds(worlds):
    """The shard audit's report, the ``1x1`` mesh counted here and the other
    shapes in this module's worlds (every rank of a world counting the
    same), equals ``analysis/shard_budget.json`` and holds its semantic
    rules.  ``DOCQA_SHARD_REPORT=<path>`` also writes the report there, for
    ``python -m docqa_tpu_torch.analysis --shard-audit <path> --write-budget``."""
    import json

    per_world = [[json.loads(str(worlds[n].result("shard_audit", r)["counts"]))
                  for r in range(n)] for n in (2, 4)]
    report = shard_audit.make_report(
        shard_audit.audit_rank(["1x1"], shard_audit.AUDIT_PROGRAMS), per_world)
    if os.environ.get("DOCQA_SHARD_REPORT"):
        with open(os.environ["DOCQA_SHARD_REPORT"], "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    budget = shard_audit.load_budget()
    assert shard_audit.compare_budget(report, budget) == []
    assert shard_audit.budget_todos(budget) == []
    assert report["rank_disagreements"] == []
