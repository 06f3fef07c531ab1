"""Port parity, the runtime on a mesh: docqa_tpu_torch's ``DocQARuntime``
over ``torch.distributed`` (rank 0 serving HTTP, the other ranks following
its command stream, ``runtime/mesh.py``), the sharded lexical tier and the
tagger's data-parallel step, against docqa_tpu's on the CPU.

The port runs in gloo worlds of ``tests/torch_mesh_worker.py`` processes
(a file store under ``tmp_path``, the leader's front on 127.0.0.1 port 0),
started at once by a module fixture: a world of 2 at mesh (1, 2), one of 4
at (2, 2) (and (1, 4) for the lexical tier), and a world of 2 whose
follower is killed mid-serve.  The reference runs in this process on the
conftest's 8 virtual devices, its runtime under the same config (the
default mesh section gives it (1, 8), ``mesh.data_parallel=2`` gives
(2, 4)), driven through aiohttp's test client with the same requests; the
port's single-rank runtime (no process group) is booted here too.

What must agree, float32 throughout:

* answers: greedy token streams identical (the answer's words), sources
  identical with each side's document ids mapped to their upload index,
  the same ``degraded`` flags; retrieved row ids identical under the tie
  rule (ids above the last score equal as sets) and scores within 1e-5;
* every rank: its command digest (``runtime.mesh.command_digest``), its
  batchers' fetched prefill and decode results (greedy and at temperature
  0.8), its retrievals, its store after a DELETE, and a snapshot written
  by the leader alone that every rank restores;
* budgets, from the port's counter: the batcher's forwards all-reduce
  twice a layer (4 for 2 layers, ``shard_budget.json``
  ``decoder_paged_decode`` / ``decoder_ragged_prefill``) and gather their
  logits once, with no collective over the data axis; a sharded lexical
  search two all-gathers (``retrieve_lexical_sharded``), none at (1, 1);
* the lexical tier against the reference's sharded program on the same
  mesh shapes: ids under the tie rule, scores within 1e-5;
* the tagger's data-parallel step against the reference's on (2, 1) and
  (2, 2) and against the port's one-device step: losses and params within
  2e-6 over 3 steps (test_torch_train_ner.py's bound; float32 sums in
  another order);
* a lost follower: the leader's ``/ask`` answers 5xx within the process
  group's timeout + 5 s and its ``stop()`` returns.
"""

import asyncio
import gc
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.config import NERConfig as JNERConfig
from docqa_tpu.config import load_config as j_load_config
from docqa_tpu.deid import datagen as jdatagen
from docqa_tpu.engines import retrieve as jretrieve
from docqa_tpu.index.lexical import LexicalIndex as JLexicalIndex
from docqa_tpu.models.ner import init_ner_params as j_init_ner_params
from docqa_tpu.runtime import mesh as jmesh
from docqa_tpu.runtime import metrics as jmetrics
from docqa_tpu.service.app import DocQARuntime as JDocQARuntime
from docqa_tpu.service.app import make_app as j_make_app
from docqa_tpu.training import ner as jner
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import NERConfig, load_config
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.engines import retrieve as tretrieve
from docqa_tpu_torch.index.lexical import LexicalIndex
from docqa_tpu_torch.runtime import mesh as tmesh
from docqa_tpu_torch.runtime import metrics
from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app
from docqa_tpu_torch.training import ner

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

SCORE_TOL = 1e-5
NER_TOL = 2e-6
LOST_TIMEOUT_S = 10  # the lost-rank world's process group timeout
LEX_SHAPES = ["1x2", "1x4", "2x2"]
BATCH_COLLECTIVES = {"all_reduce.decoder", "all_gather.logits"}


def _ner_init():
    jcfg = JNERConfig(**W.NER_WIDTHS)
    tree = jax.jit(j_init_ner_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of 2 and 4, started at once; the reference runs
    meanwhile.  The lost-rank world starts once both have ended
    (``_lost_world``), so the module never runs more than six ranks."""
    init = _ner_init()
    specs = {
        2: "lexical_sharded,ner_dp,runtime_greedy,runtime_restart,runtime_sampled",
        4: "lexical_sharded,ner_dp,runtime_wide",
    }
    out = {}
    for n, scenarios in specs.items():
        d = tmp_path_factory.mktemp(f"rt_world{n}")
        np.savez(d / "ner_init.npz", **init)
        out[n] = W.World(n, scenarios, d)
    out["lost_dir"] = tmp_path_factory.mktemp("rt_world_lost")
    yield out
    for key in (2, 4, "lost"):
        if key in out:
            out[key].close()


def _lost_world(worlds):
    if "lost" not in worlds:
        worlds[2].join()
        worlds[4].join()
        worlds["lost"] = W.World(2, "runtime_lost_rank", worlds["lost_dir"],
                                 timeout_s=LOST_TIMEOUT_S)
    return worlds["lost"]


class _RefClient:
    """The reference app in process, through aiohttp's test client."""

    def __init__(self, rt):
        from aiohttp.test_utils import TestClient, TestServer

        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(j_make_app(rt)), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def post(self, path, payload):
        async def go():
            r = await self.client.post(path, json=payload)
            return r.status, json.loads(await r.read() or b"null")

        return self.loop.run_until_complete(go())

    def delete(self, path):
        async def go():
            r = await self.client.delete(path)
            return r.status

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


def _drive(post, delete):
    """The leader's sequential requests (worker ``_serve_script`` without
    the concurrent burst)."""
    ids = W.rt_ingest(post)
    out = {"doc_ids": ids,
           "asks": [W.rt_answer(*post("/ask/", {"question": q})) for q in W.RT_QUESTIONS]}
    out["delete"] = delete(f"/documents/{ids[0]}")
    out["after_delete"] = [W.rt_answer(*post("/ask/", {"question": q}))
                           for q in W.RT_QUESTIONS]
    return out


def _recording(monkeypatch, cls, name):
    """Record ``cls.name``'s retrievals (rows and scores) in order."""
    rows = []
    orig = getattr(cls, name)

    def rec(self, *a, **k):
        res = orig(self, *a, **k)
        rows.append(W.retrieval_rows(res[0] if k.get("return_emb") else res))
        return res

    monkeypatch.setattr(cls, name, rec)
    return rows


@pytest.fixture(scope="module")
def reference(worlds):
    """The reference's runtime for the greedy (1, 8) and wide (2, 4) runs,
    and the port's single-rank runtime for the greedy run, each with its
    retrievals; the process's recorders, counters and the reference's
    cost-ledger probe are put back after."""
    from _pytest.monkeypatch import MonkeyPatch

    mp = MonkeyPatch()
    saved = [(reg, {n: c.value for n, c in list(reg.counters.items())})
             for reg in (jmetrics.DEFAULT_REGISTRY, metrics.DEFAULT_REGISTRY)]
    probe = jobs.DEFAULT_COST_LEDGER._pressure_probe
    out = {}
    try:
        for run in ("greedy", "wide"):
            rows = _recording(mp, jretrieve.FusedRetriever, "search_texts")
            cfg = j_load_config(env={}, overrides={**W.RT_CFG, **W.RT_RUNS[run]})
            rt = JDocQARuntime(cfg).start()
            client = _RefClient(rt)
            try:
                res = _drive(client.post, client.delete)
            finally:
                client.close()
                rt.stop()
            res["retrievals"] = rows
            out[run] = res
            mp.undo()
        rows = _recording(mp, tretrieve.FusedRetriever, "_search_texts")
        rt = DocQARuntime(load_config(env={}, overrides={**W.RT_CFG, **W.RT_RUNS["greedy"]}),
                          device="cpu").start()
        server = AppServer(make_app(rt)).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            res = _drive(lambda p, b: W.rt_post(base, p, b),
                         lambda p: W.rt_call(base, "DELETE", p)[0])
        finally:
            server.close()
            rt.stop()
        res["retrievals"] = rows
        out["single"] = res
    finally:
        mp.undo()
        jobs.DEFAULT_COST_LEDGER.set_pressure_probe(probe)
        for reg, counts in saved:
            for name, c in list(reg.counters.items()):
                with c._lock:
                    c._value = counts.get(name, 0)
        obs.DEFAULT_COST_LEDGER.set_pressure_probe(None)
    yield out
    jax.clear_caches()
    gc.collect()


def _ranks(world, name):
    return [world.result(name, r) for r in range(world.n)]


def _loads(res, key):
    return json.loads(str(res[key]))


def _normalized(answers, doc_ids):
    """Answers with each document id replaced by its upload index."""
    text = json.dumps(answers)
    for i, d in enumerate(doc_ids):
        text = text.replace(d, f"DOC{i}")
    return json.loads(text)


def _assert_same_rows(want, got):
    """Per query: scores within SCORE_TOL, ids equal above the last score."""
    assert len(want) == len(got)
    for wrow, grow in zip(want, got):
        assert len(wrow) == len(grow)
        ws = np.array([s for _r, s in wrow])
        np.testing.assert_allclose([s for _r, s in grow], ws, atol=SCORE_TOL, rtol=0)
        if wrow:
            tie = ws[-1] + SCORE_TOL
            assert ({r for r, s in wrow if s > tie} == {r for r, s in grow if s > tie})


def _port_retrievals(res):
    return [rows for (name, _kind, rows) in _loads(res, "batches") if name == "retriever"]


# ---- the runtime ----------------------------------------------------------------

@pytest.mark.parametrize("run, world", [("greedy", 2), ("wide", 4)])
def test_answers_equal_the_reference_and_the_single_rank_runtime(worlds, reference, run, world):
    res = _ranks(worlds[world], f"runtime_{run}")[0]
    port = _loads(res, "results")
    got = _normalized({k: port[k] for k in ("asks", "after_delete")}, port["doc_ids"])
    refs = [reference[run]] + ([reference["single"]] if run == "greedy" else [])
    for ref in refs:
        want = _normalized({k: ref[k] for k in ("asks", "after_delete")}, ref["doc_ids"])
        assert got == want
        assert port["delete"] == ref["delete"] == 200
    assert all(a["status"] == 200 and not a["degraded"] for a in got["asks"])
    # the retrievals of the sequential asks, before and after the DELETE
    mine = _port_retrievals(res)
    n = len(W.RT_QUESTIONS)
    for ref in refs:
        _assert_same_rows([r for rows in ref["retrievals"][:n] for r in rows],
                          [r for rows in mine[:n] for r in rows])
        _assert_same_rows([r for rows in ref["retrievals"][-n:] for r in rows],
                          [r for rows in mine[-n:] for r in rows])


@pytest.mark.parametrize("run, world", [("greedy", 2), ("restart", 2), ("sampled", 2),
                                        ("wide", 4)])
def test_every_rank_agrees(worlds, run, world):
    ranks = _ranks(worlds[world], f"runtime_{run}")
    lead = ranks[0]
    assert _loads(lead, "commands"), "the leader counted no command"
    for res in ranks[1:]:
        assert str(res["digest"]) == str(lead["digest"])
        assert _loads(res, "commands") == _loads(lead, "commands")
        assert _loads(res, "batches") == _loads(lead, "batches")
        assert int(res["count"]) == int(lead["count"])
        assert int(res["deleted"]) == int(lead["deleted"])
        assert _loads(res, "live_docs") == _loads(lead, "live_docs")
        assert int(res["snapshots"]) == 0
    kinds = {kind for _n, kind, _r in _loads(lead, "batches")}
    assert {"prefill", "decode"} <= kinds


def test_a_delete_removes_the_rows_on_every_rank(worlds):
    ranks = _ranks(worlds[2], "runtime_greedy")
    port = _loads(ranks[0], "results")
    assert port["delete"] == 200
    for res in ranks:
        live = _loads(res, "live_docs")
        assert port["doc_ids"][0] not in live and len(live) == len(W.RT_NOTES) - 1


def test_the_snapshot_is_written_once_and_restored_on_every_rank(worlds):
    before = _ranks(worlds[2], "runtime_greedy")
    after = _ranks(worlds[2], "runtime_restart")
    assert int(before[0]["snapshots"]) >= 1 and int(after[0]["snapshots"]) >= 1
    for b, a in zip(before, after):
        assert int(a["count"]) == int(b["count"]) and _loads(a, "live_docs") == _loads(b, "live_docs")
    restarted = _loads(after[0], "results")
    assert restarted["restored"] == int(before[0]["count"])
    assert restarted["asks"] == _loads(before[0], "results")["after_delete"]


def test_concurrent_asks_through_two_replicas_equal_the_solo_answers(worlds):
    port = _loads(worlds[2].result("runtime_greedy", 0), "results")
    solo = port["asks"]
    assert len(port["concurrent"]) == W.N_CONCURRENT
    for i, got in enumerate(port["concurrent"]):
        assert got == solo[i % len(solo)]
    batchers = {name for name, _k, _r in _loads(worlds[2].result("runtime_greedy", 0), "batches")
                if name.startswith("batcher")}
    assert batchers == {"batcher#0", "batcher#1"}


@pytest.mark.parametrize("run, world", [("greedy", 2), ("sampled", 2), ("wide", 4)])
def test_the_batchers_collectives_are_the_reference_budget(worlds, run, world):
    res = worlds[world].result(f"runtime_{run}", 0)
    c = _loads(res, "collectives")
    budget = json.load(open(os.path.join(W.REPO, "shard_budget.json")))["programs"]
    mesh_tag = "1x8" if world == 2 else "2x4"
    per_forward = budget["decoder_paged_decode"]["per_mesh"][mesh_tag]["all-reduce"]
    assert per_forward == budget["decoder_ragged_prefill"]["per_mesh"][mesh_tag]["all-reduce"]
    assert c["all_gather.logits"] > 0
    assert c["all_reduce.decoder"] == per_forward * c["all_gather.logits"]
    # the rest: the store's top-k (model axis) and the encoder's gather
    # (data axis, the (2, 2) mesh only); nothing else
    assert set(c) <= BATCH_COLLECTIVES | {"all_gather.topk", "all_gather.encode"}
    assert ("all_gather.encode" in c) == (world == 4)


def test_the_status_surface_has_a_mesh_section(worlds):
    for world, shape in ((2, [1, 2]), (4, [2, 2])):
        run = "greedy" if world == 2 else "wide"
        m = _loads(worlds[world].result(f"runtime_{run}", 0), "results")["status_mesh"]
        assert m["shape"] == shape and m["ranks"] == world and m["backend"] == "gloo"
        assert m["role"] == "leader" and m["broken"] is None
        assert m["commands_issued"] > 0 and "batcher#0.decode_chunk" in m["commands"]


def test_a_lost_follower_fails_the_ask_5xx_and_stop_returns(worlds):
    w = _lost_world(worlds)
    rcs = w.join()
    assert rcs[0] == 0, w.stderr()
    assert rcs[1] not in (0, None), w.stderr()
    with np.load(os.path.join(w.out, "runtime_lost_rank.r0.npz")) as d:
        assert int(d["first"]) == 200
        assert str(d["status"]).isdigit() and 500 <= int(str(d["status"])) < 600, str(d["status"])
        assert float(d["ask_s"]) < LOST_TIMEOUT_S + 5
        assert float(d["stop_s"]) < 30


# ---- the sharded lexical tier --------------------------------------------------

@pytest.mark.parametrize("tag", LEX_SHAPES)
def test_sharded_lexical_equals_the_reference(worlds, tag):
    d, m = W.shape_of(tag)
    jlx = JLexicalIndex(vocab_size=W.LEX_VOCAB, tile_width=W.LEX_WIDTH,
                        mesh=jmesh.host_cpu_mesh(d * m, data=d))
    jlx.add(list(range(len(W.LEX_TEXTS))), W.LEX_TEXTS)
    jlx.on_delete(W.LEX_DELETED)
    want = jlx.search(W.LEX_QUERIES, k=W.LEX_K)
    world = worlds[d * m]
    for r in range(world.n):
        res = world.result("lexical_sharded", r)
        got = [list(zip(res[f"{tag}/ids{qi}"].tolist(), res[f"{tag}/scores{qi}"].tolist()))
               for qi in range(len(W.LEX_QUERIES))]
        _assert_same_rows([[(rid, s) for s, rid in row] for row in want], got)
        assert W.counts_of(res, tag + "/") == {"all_gather.topk": 2}
        # equal row shards of whole 64-row buckets, as the reference pads
        assert int(res[tag + "/rows"]) * m == -(-len(W.LEX_TEXTS) // (64 * m)) * 64 * m
    assert any(want), "no query matched: the case tests nothing"


def test_lexical_at_1x1_issues_no_collective():
    lx = LexicalIndex(vocab_size=W.LEX_VOCAB, tile_width=W.LEX_WIDTH, device="cpu",
                      mesh=tmesh.make_mesh(device="cpu"))
    plain = LexicalIndex(vocab_size=W.LEX_VOCAB, tile_width=W.LEX_WIDTH, device="cpu")
    for ix in (lx, plain):
        ix.add(list(range(len(W.LEX_TEXTS))), W.LEX_TEXTS)
    tmesh.COLLECTIVES.clear()
    assert lx.search(W.LEX_QUERIES, k=W.LEX_K) == plain.search(W.LEX_QUERIES, k=W.LEX_K)
    assert not tmesh.COLLECTIVES


# ---- the tagger's data-parallel step ------------------------------------------

def _ner_reference(shape):
    jcfg = JNERConfig(**W.NER_WIDTHS)
    init = _ner_init()
    params = {k: jax.numpy.asarray(v) for k, v in init.items()}
    mesh = None if shape is None else jmesh.host_cpu_mesh(shape[0] * shape[1], data=shape[0])
    opt = jner.default_ner_optimizer(W.NER_LR, steps=W.NER_STEPS)
    state = opt.init(params)
    step = jner.make_ner_train_step(jcfg, opt, mesh=mesh)
    rng = np.random.default_rng(0)
    tok = jdatagen.ner_tokenizer(jcfg)
    losses = []
    for _ in range(W.NER_STEPS):
        batch = jdatagen.sample_batch(rng, tok, jcfg, W.NER_BATCH, W.NER_SEQ)
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return np.array(losses), {k: np.asarray(v) for k, v in params.items()}


def _ner_port_one_device():
    cfg = NERConfig(**W.NER_WIDTHS)
    params = ner.trainable(_ner_init(), cfg, "cpu")
    opt = ner.default_ner_optimizer(W.NER_LR, steps=W.NER_STEPS)
    state = opt.init(params)
    step = ner.make_ner_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    tok = datagen.ner_tokenizer(cfg)
    losses = []
    for _ in range(W.NER_STEPS):
        batch = datagen.sample_batch(rng, tok, cfg, W.NER_BATCH, W.NER_SEQ)
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return np.array(losses), {k: v.detach().numpy() for k, v in params.items()}


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_the_taggers_data_parallel_step_equals_the_reference(worlds, shape):
    want_losses, want = _ner_reference(shape)
    one_losses, one = _ner_port_one_device()
    world = worlds[shape[0] * shape[1]]
    for r in range(world.n):
        res = world.result(f"ner_dp_{shape[0]}x{shape[1]}", r)
        for ref_losses, ref in ((want_losses, want), (one_losses, one)):
            np.testing.assert_allclose(res["losses"], ref_losses, atol=NER_TOL, rtol=0)
            for k, v in ref.items():
                np.testing.assert_allclose(res["p/" + k], v, atol=NER_TOL, rtol=0, err_msg=k)
        # one all-reduce over the data axis a step
        assert W.counts_of(res) == {"all_reduce.ner_grads": W.NER_STEPS}


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_the_trained_tagger_on_a_mesh_is_one_tagger_cached_once(worlds, shape):
    world = worlds[shape[0] * shape[1]]
    ranks = [world.result(f"ner_dp_{shape[0]}x{shape[1]}", r) for r in range(world.n)]
    keys = [k for k in ranks[0] if k.startswith("trained/")]
    assert keys
    for res in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], ranks[0][k])
    cached = ner.load_ner_params(os.path.join(world.out, f"ner_{shape[0]}x{shape[1]}.npz"),
                                 NERConfig(**W.NER_WIDTHS), steps=2)
    assert cached is not None
    for k in keys:
        np.testing.assert_array_equal(np.asarray(cached[k[len("trained/"):]]), ranks[0][k])


# ---- the stream, the spine and the batcher in one process ---------------------

class _Target:
    def __init__(self):
        self.calls = []

    def op(self, x, inner=None):
        return tmesh.mirrored(self, "op", self._op, x, inner=inner)

    def _op(self, x, inner=None):
        self.calls.append(x)
        if inner is not None:
            inner.op(x + 1)  # a command inside a command runs where it is
        return x * 2


def test_a_stream_of_one_rank_counts_top_level_commands():
    plain = _Target()
    assert plain.op(3) == 6 and plain.calls == [3]  # no stream: a plain call
    stream = tmesh.CommandStream(tmesh.make_mesh(device="cpu"))
    a, b = stream.register("a", _Target()), stream.register("b", _Target())
    tmesh.reset_commands()
    empty = tmesh.command_digest()
    assert a.op(1) == 2  # the boot: local and counted
    stream.open()
    assert a.op(5, inner=b) == 10 and b.calls == [6]
    assert dict(tmesh.COMMANDS) == {"a.op": 2}
    assert tmesh.command_digest() != empty
    status = stream.status()
    assert status["shape"] == [1, 1] and status["role"] == "leader" and status["ranks"] == 1
    assert status["commands"]["a.op"]["count"] == 1
    stream.stop()
    with pytest.raises(tmesh.MeshFault):
        a.op(7)
    with pytest.raises(ValueError):
        stream.register("a", _Target())


def test_a_mesh_fault_is_a_device_fault():
    from docqa_tpu_torch.ops._kernels import is_device_fault

    assert is_device_fault(tmesh.MeshFault("a rank is gone"))


def test_spine_items_of_a_command_carry_its_scope_and_are_never_shed():
    from docqa_tpu_torch.engines.spine import DispatchSpine
    from docqa_tpu_torch.resilience.deadline import Deadline

    spine = DispatchSpine(n_lanes=1, max_depth=1)
    try:
        expired = Deadline(0.0)
        seen = []

        def item():
            seen.append(tmesh.in_command())
            return 1

        with tmesh.command_scope():
            # queued for a lane thread (submit): the scope rides along, and
            # the expired deadline sheds nothing
            assert spine.submit("x", item, deadline=expired).result(timeout=30) == 1
        assert seen == [True]
        assert spine.submit("x", item).result(timeout=30) == 1
        assert seen == [True, False]
    finally:
        spine.close()


def test_sharded_paged_pools_are_allocated_at_the_shard_width():
    from docqa_tpu_torch.config import DecoderConfig
    from docqa_tpu_torch.engines.paged import init_paged_pools
    from docqa_tpu_torch.parallel.sharding import shard_paged_pools

    cfg = DecoderConfig(**W.TP_WIDTHS)
    for n in (1, 2, 4, 8):
        mesh = tmesh.MeshContext(None, "data", "model", 1, n, 0, n - 1, torch.device("cpu"))
        want = shard_paged_pools(init_paged_pools(cfg, 4, 16), cfg, mesh)
        got = init_paged_pools(cfg, 4, 16, mesh=mesh)
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == want[k].shape and torch.equal(got[k], want[k])


def test_the_batcher_serves_a_sharded_engine_with_slots_rounded_to_the_data_axis():
    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.serve import ContinuousBatcher

    eng = GenerateEngine(DecoderConfig(**W.TP_WIDTHS), GenerateConfig(max_new_tokens=4),
                         device="cpu")
    eng.mesh = tmesh.MeshContext(None, "data", "model", 2, 1, 0, 0, torch.device("cpu"))
    b = ContinuousBatcher(eng, n_slots=3)
    try:
        assert b.n_slots == 4  # the reference's round_up(3, n_data)
        assert b.submit_ids([3, 4, 5], max_new_tokens=4).result(timeout=60)
    finally:
        b.stop()
