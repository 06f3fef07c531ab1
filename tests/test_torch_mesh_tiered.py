"""Port parity, tiered retrieval on a mesh: docqa_tpu_torch's row-sharded
int8 IVF tier (``index/ivf.py``), ``TieredIndex`` and
``FusedTieredRetriever`` over it, the runtime serving
``store.serving_index="tiered"`` on a mesh, and ``FusedRAG`` over a
row-sharded store with its token sidecar, against docqa_tpu's on the CPU.

The port runs in gloo worlds of ``tests/torch_mesh_worker.py`` processes (a
file store under ``tmp_path``), started at once by a module fixture: a
world of 2 at mesh (1, 2) and one of 4 at (1, 4) and (2, 2).  Tiers sharded
over ranks are driven as the runtime drives them: the leader calls, the
other ranks replay its command stream.  The
reference runs in this process on the conftest's 8 virtual devices
(``host_cpu_mesh`` at the same shapes; its runtime at (1, 8) and (2, 4)),
the port's one-device paths beside it.  Float32 throughout.

The tie rule (tests/test_ivf_sharded.py's): two ranked lists may swap ids
only where their scores tie, within ``TIE_EPS`` (int8 tiles scored in
float32, the same tile on a shard and on one device).  Scores agree within
``SCORE_TOL`` where both sides score the same rows.

What must agree:

* a reference tier carried onto each mesh (``ivf_from_arrays(mesh=)``,
  C = 30 dividing no shard count) probes at nprobe 2, 8 and 30 to the
  reference's sharded and one-device probes' ids, with two all-gathers a
  probe; the port's own mesh build is, shard by shard, the one-device
  build's cells sliced (bit for bit) and probes alike; a sharded tier is
  int8 and reports the reference's ``shards`` / ``per_shard_bytes``;
* a sharded ``TieredIndex``: the self-query first at 1.0 after the exact
  re-rank, fresh rows found through the replicated tail, the ids of the
  one-device tiered path and of the reference's sharded one, no shadow
  dispatch while sampling is off;
* ``FusedTieredRetriever`` dense and hybrid equal the two-step search and
  the reference's fused retrieval; ``all_gather.topk`` 2 a tiered
  retrieval and 4 a hybrid one (the data-parallel encode adds its
  ``all_gather.encode`` at (2, 2)); ``retrieve_offmesh_fallback`` stays 0;
  a leader's deadline spent after its command was published leaves every
  rank's rows, collectives and command digest as they were;
* the runtime with tiered serving at (1, 2) and (2, 2): answers dense,
  hybrid and during a background rebuild equal the reference's runtime's
  (and the port's single-rank runtime's), ``/api/retrieval`` reports the
  tier as the reference's does with ``shards`` the model axis; every rank
  ends on the same tier generation and command digest, and no follower
  started a rebuild;
* ``FusedRAG`` over a row-sharded store and a TP generator at (1, 2): its
  answers equal the classic text path's on the same mesh engine, its
  sources the one-device store's and the reference's; two all-gathers and
  the two all-reduces of the sidecar merge (the reference's two psums);
  the runtime builds no ``FusedRAG`` on a mesh.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.config import load_config as j_load_config
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.retrieve import FusedTieredRetriever as JFusedTieredRetriever
from docqa_tpu.index.ivf import IVFIndex as JIVFIndex
from docqa_tpu.index.lexical import LexicalIndex as JLexicalIndex
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.index.tiered import TieredIndex as JTieredIndex
from docqa_tpu.runtime import mesh as jmesh
from docqa_tpu.runtime import metrics as jmetrics
from docqa_tpu.service.app import DocQARuntime as JDocQARuntime
from docqa_tpu.service.app import make_app as j_make_app
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import load_config
from docqa_tpu_torch.index.ivf import IVFIndex
from docqa_tpu_torch.runtime import metrics
from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

SHAPES = ["1x2", "1x4", "2x2"]
TIE_EPS = 1e-4
SCORE_TOL = 1e-5
# the reference runtime's mesh for each port run (its default section gives
# (1, 8); data_parallel=2 gives (2, 4))
RUNTIME_RUNS = [("tiered", 2), ("tiered_wide", 4)]


def _jmesh(tag):
    d, m = W.shape_of(tag)
    return jmesh.host_cpu_mesh(d * m, data=d)


def _n_model(tag):
    return W.shape_of(tag)[1]


def _ref_arrays(jx):
    return {
        "centroids": np.asarray(jx._centroids, np.float32),
        "cells": np.asarray(jx._cells), "cell_scale": np.asarray(jx._cell_scale),
        "cell_ids": np.asarray(jx._cell_ids), "spill": np.asarray(jx._spill, np.float32),
        "spill_ids": np.asarray(jx._spill_ids), "n_assign": jx.n_assign,
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of 2 and 4, started at once, given the reference's
    one-device tier over tests/test_ivf_sharded.py's 4,000 rows."""
    x = W.clustered(4000)
    jx = JIVFIndex(x, [{"row": i} for i in range(len(x))], n_clusters=W.IVF_C, nprobe=8,
                   dtype="float32")
    specs = {
        2: "ivf_sharded,tiered_sharded,fused_tiered,runtime_tiered,fused_rag",
        4: "ivf_sharded,tiered_sharded,fused_tiered,runtime_tiered_wide",
    }
    out = {"ref_ivf": jx}
    for n, scenarios in specs.items():
        d = tmp_path_factory.mktemp(f"tier_world{n}")
        np.savez(d / "ivf_inputs.npz", **_ref_arrays(jx))
        out[n] = W.World(n, scenarios, d)
    yield out
    for n in specs:
        out[n].close()


def _world(worlds, tag):
    return worlds[W.world_of(tag)]


def _ranks(worlds, tag, name):
    w = _world(worlds, tag)
    return [w.result(name, r) for r in range(w.n)]


def _tie_equal(want_ids, want_scores, got_ids, got_scores, eps=TIE_EPS):
    """The tie rule over padded [q, k] rows (id -1: no row)."""
    np.testing.assert_array_equal(np.asarray(got_ids) < 0, np.asarray(want_ids) < 0)
    for wi, ws, gi, gs in zip(want_ids, want_scores, got_ids, got_scores):
        for a, sa, b, sb in zip(wi, ws, gi, gs):
            if a != b:
                assert abs(sa - sb) <= eps, (wi.tolist(), gi.tolist(), ws.tolist(), gs.tolist())


def _rows_of(res, k):
    """tests/torch_mesh_worker's padded (ids, scores) of the reference's rows."""
    if res and res[0] and hasattr(res[0][0], "row_id"):
        return W.result_rows(res, k)
    return W.ivf_rows(res, k)


# ---- the sharded IVF tier ---------------------------------------------------------

@pytest.fixture(scope="module")
def ref_sharded_ivf():
    """The reference's own sharded builds over the 4,000 rows at each mesh."""
    x = W.clustered(4000)
    meta = [{"row": i} for i in range(len(x))]
    return {tag: JIVFIndex(x, meta, n_clusters=W.IVF_C, nprobe=8, dtype="float32",
                           mesh=_jmesh(tag)) for tag in SHAPES}


@pytest.mark.parametrize("tag", SHAPES)
def test_carried_tier_probes_as_the_reference_sharded_and_one_device(worlds, ref_sharded_ivf,
                                                                     tag):
    jx = worlds["ref_ivf"]
    js = ref_sharded_ivf[tag]
    assert js._sharded and js.cells_per_shard * _n_model(tag) >= js.n_real_cells
    q = W.near(W.clustered(4000), 20, 1)
    for res in _ranks(worlds, tag, "ivf_sharded"):
        for p in W.IVF_NPROBES:
            got = res[f"{tag}/carried/ids{p}"], res[f"{tag}/carried/scores{p}"]
            for ref in (jx, js):
                _tie_equal(*_rows_of(ref.search(q, k=10, nprobe=p), 10), *got)
            assert W.counts_of(res, f"{tag}/carried/{p}/") == {"all_gather.topk": 2}


@pytest.mark.parametrize("tag", SHAPES)
def test_own_mesh_build_is_the_one_device_build_sliced(worlds, ref_sharded_ivf, tag):
    """The port's mesh build over the same rows and seed: each rank's cells,
    scales and ids are its block of the one-device build's (padded to the
    shard count), and it probes to the one-device build's ids and to the
    reference's sharded build's."""
    x = W.clustered(4000)
    q = W.near(x, 20, 1)
    n = _n_model(tag)
    solo = IVFIndex(x, [{"row": i} for i in range(len(x))], n_clusters=W.IVF_C, nprobe=8,
                    dtype="float32", device="cpu")
    arrays = solo.arrays()
    ranks = _ranks(worlds, tag, "ivf_sharded")
    cps = int(ranks[0][f"{tag}/cells_per_shard"])
    assert cps == -(-W.IVF_C // n)
    for r, res in enumerate(ranks):
        m = r % n
        for key, fill in (("cells", 0), ("cell_scale", 0), ("cell_ids", -1)):
            whole = arrays[key]
            pad = np.full((cps * n - len(whole),) + whole.shape[1:], fill, whole.dtype)
            np.testing.assert_array_equal(res[f"{tag}/own/{key}"],
                                          np.concatenate([whole, pad])[m * cps:(m + 1) * cps])
            np.testing.assert_array_equal(res[f"solo/{key}"], whole)
        for p in W.IVF_NPROBES:
            got = res[f"{tag}/own/ids{p}"], res[f"{tag}/own/scores{p}"]
            _tie_equal(*_rows_of(solo.search(q, k=10, nprobe=p), 10), *got)
            _tie_equal(*_rows_of(ref_sharded_ivf[tag].search(q, k=10, nprobe=p), 10), *got)


@pytest.mark.parametrize("tag", SHAPES)
def test_sharded_tier_forces_int8_and_splits_its_bytes(worlds, tag):
    x = W.clustered(4000)
    want = JIVFIndex(x, [{}] * len(x), n_clusters=32, dtype="float32",
                     mesh=_jmesh(tag)).index_bytes()
    assert want["shards"] == _n_model(tag)
    for res in _ranks(worlds, tag, "ivf_sharded"):
        assert str(res[f"{tag}/forced_storage"]) == "int8"
        got = {k: int(res[f"{tag}/bytes/{k}"]) for k in ("shards", "per_shard_bytes",
                                                         "total_bytes")}
        assert got == {k: want[k] for k in got}
        assert got["per_shard_bytes"] < 0.6 * got["total_bytes"]


# ---- the sharded TieredIndex ------------------------------------------------------

def _ref_tiered(x, mesh, **kw):
    store = JVectorStore(JStoreConfig(dim=W.IVF_DIM, shard_capacity=4096, dtype="float32"),
                         mesh=mesh)
    store.add(x, [{"doc_id": f"d{i}"} for i in range(len(x))])
    tiered = JTieredIndex(store, min_rows=100, rebuild_tail_rows=10**6, **kw)
    assert tiered.rebuild()
    return tiered


@pytest.mark.parametrize("tag", SHAPES)
def test_sharded_tiered_serves_self_queries_and_fresh_rows(worlds, tag):
    x = W.clustered(3000, seed=3)
    ref = _ref_tiered(x, _jmesh(tag), nprobe=8)
    want_self = W.result_rows(ref.search(x[77], k=5), 5)
    for res in _ranks(worlds, tag, "tiered_sharded"):
        assert int(res[f"{tag}/shards"]) == _n_model(tag)
        assert str(res[f"{tag}/storage"]) == "int8"
        ids, scores = res[f"{tag}/self_ids"], res[f"{tag}/self_scores"]
        assert ids[0, 0] == 77 and abs(scores[0, 0] - 1.0) <= 2e-3
        _tie_equal(*want_self, ids, scores)
        np.testing.assert_allclose(scores, want_self[1], atol=SCORE_TOL, rtol=0)
        assert res[f"{tag}/fresh"].tolist() == [f"new{i}" for i in range(8)]
        assert W.counts_of(res, f"{tag}/search/") == {"all_gather.topk": 2}
        assert int(res[f"{tag}/generation"]) == 1
        # a tier sharded over ranks is rebuilt by the leader of a command stream only
        assert bool(res[f"{tag}/unstreamed_refused"])


@pytest.mark.parametrize("tag", SHAPES)
def test_sharded_tiered_ids_equal_the_one_device_and_the_reference(worlds, tag):
    """tests/test_ivf_sharded.py's acceptance case: the tiered path on the
    mesh returns the one-device tiered path's ids (the port's, in the same
    rank, and the reference's) and the reference's sharded path's."""
    x = W.clustered(3000, seed=21)
    q = W.near(x, 24, 2)
    kw = dict(nprobe=6, n_clusters=30, seed=0)
    refs = [W.result_rows(_ref_tiered(x, mesh, **kw).search(q, k=10), 10)
            for mesh in (None, _jmesh(tag))]
    for res in _ranks(worlds, tag, "tiered_sharded"):
        got = res[f"{tag}/ids"], res[f"{tag}/scores"]
        for want in refs + [(res["solo/ids"], res["solo/scores"])]:
            _tie_equal(*want, *got)
            np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("tag", SHAPES)
def test_zero_shadow_dispatch_while_sampling_is_disabled(worlds, tag):
    for res in _ranks(worlds, tag, "tiered_sharded"):
        assert int(res[f"{tag}/shadow_dispatches"]) == 0


# ---- the fused tiered and hybrid programs ------------------------------------------

@pytest.mark.parametrize("tag", SHAPES)
def test_fused_tiered_and_hybrid_equal_the_two_step_and_the_reference(worlds, tag):
    mesh = _jmesh(tag)
    enc = JEncoderEngine(JEncoderConfig(**W.TIER_ENC), mesh=mesh)
    store = JVectorStore(JStoreConfig(dim=W.IVF_DIM, shard_capacity=512, dtype="float32"),
                         mesh=mesh)
    lex = JLexicalIndex(vocab_size=W.LEX_VOCAB, tile_width=W.LEX_WIDTH, mesh=mesh)
    store.register_index_sink(lex)
    store.add(enc.encode_texts(W.TIER_TEXTS),
              [{"doc_id": f"d{i}", "source": t, "text_content": t}
               for i, t in enumerate(W.TIER_TEXTS)])
    tiered = JTieredIndex(store, nprobe=4, min_rows=100, rebuild_tail_rows=10**6, lexical=lex)
    assert tiered.rebuild()
    retr = JFusedTieredRetriever(enc, tiered)
    encode = {"all_gather.encode": 1} if W.shape_of(tag)[0] > 1 else {}
    for res in _ranks(worlds, tag, "fused_tiered"):
        for mode, gathers in (("dense", 2), ("hybrid", 4)):
            got = res[f"{tag}/{mode}/ids"], res[f"{tag}/{mode}/scores"]
            _tie_equal(res[f"{tag}/{mode}/two_ids"], res[f"{tag}/{mode}/two_scores"], *got)
            want = W.result_rows(retr.search_texts(W.TIER_QUERIES, k=5, mode=mode), 5)
            _tie_equal(*want, *got)
            np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL, rtol=0)
            assert W.counts_of(res, f"{tag}/{mode}/") == {"all_gather.topk": gathers,
                                                           **encode}
        assert int(res[f"{tag}/fallbacks"]) == 0


@pytest.mark.parametrize("tag", SHAPES)
def test_a_deadline_spent_after_publish_keeps_the_mesh_in_step(worlds, tag):
    """The leader's deadline runs out once its retrieval command is
    published (in the slot wait, the marshal or the tail's upload): the
    leader still issues the command's collectives, dense, hybrid and on the
    filtered exact path, so every rank's rows and collectives equal the
    undeadlined run's and every rank ends on the same command digest."""
    ranks = _ranks(worlds, tag, "fused_tiered")
    for res in ranks:
        for case in ("dense", "hybrid", "filtered"):
            for key in ("ids", "scores"):
                np.testing.assert_array_equal(res[f"{tag}/{case}/lapsed_{key}"],
                                              res[f"{tag}/{case}/{key}"])
            assert (W.counts_of(res, f"{tag}/{case}/lapsed/")
                    == W.counts_of(res, f"{tag}/{case}/"))
        assert (res[f"{tag}/filtered/ids"] >= 0).all()
        assert W.counts_of(res, f"{tag}/filtered/")["all_gather.topk"] == 2
        assert str(res[f"{tag}/digest"]) == str(ranks[0][f"{tag}/digest"])


# ---- the runtime with tiered serving on a mesh --------------------------------------

class _RefClient:
    """The reference app in process, through aiohttp's test client."""

    def __init__(self, rt):
        import asyncio

        from aiohttp.test_utils import TestClient, TestServer

        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(j_make_app(rt)), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def call(self, method, path, payload=None):
        async def go():
            r = await self.client.request(method, path, json=payload)
            return r.status, json.loads(await r.read() or b"null")

        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture(scope="module")
def reference_runtimes(worlds):
    """The reference's tiered runtime for each run and the port's
    single-rank one for the (1, 2) run, each driven through
    ``tier_requests``; the process's counters and the reference's cost
    ledger probe are put back after."""
    saved = [(reg, {n: c.value for n, c in list(reg.counters.items())})
             for reg in (jmetrics.DEFAULT_REGISTRY, metrics.DEFAULT_REGISTRY)]
    probe = jobs.DEFAULT_COST_LEDGER._pressure_probe
    out = {}
    try:
        for run, _world in RUNTIME_RUNS:
            rt = JDocQARuntime(j_load_config(env={}, overrides={**W.RT_CFG,
                                                                **W.RT_RUNS[run]})).start()
            client = _RefClient(rt)
            try:
                out[run] = W.tier_requests(lambda p, b: client.call("POST", p, b),
                                           lambda p: client.call("GET", p)[1], rt)
            finally:
                client.close()
                rt.stop()
        rt = DocQARuntime(load_config(env={}, overrides={**W.RT_CFG, **W.RT_TIERED}),
                          device="cpu").start()
        server = AppServer(make_app(rt)).start()
        try:
            out["single"] = W.tier_script(f"http://127.0.0.1:{server.port}", rt)
        finally:
            server.close()
            rt.stop()
    finally:
        jobs.DEFAULT_COST_LEDGER.set_pressure_probe(probe)
        obs.DEFAULT_COST_LEDGER.set_pressure_probe(None)
        for reg, counts in saved:
            for name, c in list(reg.counters.items()):
                with c._lock:
                    c._value = counts.get(name, 0)
    yield out
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


def _answers(res, doc_ids):
    """The answers with each document id replaced by its upload index."""
    text = json.dumps({k: res[k] for k in ("dense", "hybrid", "during")})
    for i, d in enumerate(doc_ids):
        text = text.replace(d, f"DOC{i}")
    return json.loads(text)


SERVING_KEYS = ("serving_index", "rows", "nprobe", "covered", "tail_rows",
                "offmesh_fallbacks")
INDEX_KEYS = ("active", "covered", "n_clusters", "nprobe", "n_assign", "storage")


@pytest.mark.parametrize("run, world", RUNTIME_RUNS)
def test_tiered_runtime_on_a_mesh_equals_the_reference(worlds, reference_runtimes, run,
                                                       world):
    port = json.loads(str(worlds[world].result(f"runtime_{run}", 0)["results"]))
    got = _answers(port, port["doc_ids"])
    refs = [reference_runtimes[run]] + ([reference_runtimes["single"]]
                                        if run == "tiered" else [])
    for ref in refs:
        assert got == _answers(ref, ref["doc_ids"])
        assert port["rebuilt"] and ref["rebuilt"] and ref["covered_all"]
        for key in SERVING_KEYS:
            assert port["retrieval"]["serving"][key] == ref["retrieval"]["serving"][key], key
        for key in INDEX_KEYS:
            assert (port["retrieval"]["serving"]["index"][key]
                    == ref["retrieval"]["serving"]["index"][key]), key
    assert all(a["status"] == 200 and not a["degraded"]
               for mode in ("dense", "hybrid", "during") for a in got[mode])
    index = port["retrieval"]["serving"]["index"]
    n_model = 2
    assert index["shards"] == n_model and index["storage"] == "int8"
    assert index["per_shard_bytes"] < index["total_bytes"]
    assert port["retrieval"]["serving"]["offmesh_fallbacks"] == 0
    assert port["covered_all"]
    assert port["status_mesh"]["shape"] == [world // n_model, n_model]
    assert reference_runtimes[run]["retrieval"]["serving"]["index"]["shards"] == (
        8 if run == "tiered" else 4)


@pytest.mark.parametrize("run, world", RUNTIME_RUNS)
def test_a_background_rebuild_switches_every_rank_at_once(worlds, run, world):
    """Under load the leader alone rebuilt (k-means held so the questions
    land during it): every rank ends on the same tier generation and
    command digest, and no follower started a rebuild."""
    ranks = [worlds[world].result(f"runtime_{run}", r) for r in range(world)]
    lead = ranks[0]
    port = json.loads(str(lead["results"]))
    assert any(port["rebuilding"]), "no question landed during the rebuild"
    commands = json.loads(str(lead["commands"]))
    assert commands["tiered.stage"] == commands["tiered.switch"] == 2
    assert int(lead["rebuild_calls"]) >= 2
    for res in ranks:
        assert str(res["digest"]) == str(lead["digest"])
        assert int(res["generation"]) == int(lead["generation"]) == 2
        assert int(res["covered"]) == int(lead["covered"]) == int(lead["count"])
        assert int(res["shards"]) == 2
    for res in ranks[1:]:
        assert int(res["rebuild_calls"]) == 0


# ---- FusedRAG over a row-sharded store --------------------------------------------

def test_sharded_fused_rag_equals_the_classic_path_and_the_one_device_sources(worlds):
    from docqa_tpu.config import EncoderConfig as JEC

    enc = JEncoderEngine(JEC(**W.ENC_WIDTHS))
    store = JVectorStore(JStoreConfig(dim=64, shard_capacity=256, dtype="float32"))
    store.add(enc.encode_texts(W.RAG_CHUNKS),
              [{"doc_id": f"d{i}", "source": f"chunk {i}"} for i in range(len(W.RAG_CHUNKS))])
    for r in range(2):
        res = worlds[2].result("fused_rag", r)
        assert int(res["block"]) == 128  # the sidecar's rows are row-sharded
        for qi, question in enumerate(W.RAG_QUESTIONS):
            got = json.loads(str(res[f"q{qi}"]))
            want = [h.metadata["source"] for h in
                    store.search(enc.encode_texts([question]), k=3)[0]]
            assert got["answer"] == got["classic"] and got["answer"].strip()
            assert got["sources"] == got["classic_sources"] == got["solo"] == want
            counts = W.counts_of(res, f"q{qi}/")
            assert counts["all_gather.topk"] == 2 and counts["all_reduce.fused_rag"] == 2
            assert set(counts) == {"all_gather.topk", "all_reduce.fused_rag",
                                   "all_reduce.decoder", "all_gather.logits"}


def test_the_runtime_builds_no_fused_rag_on_a_mesh(worlds):
    # the reference's rule (docqa_tpu/service/app.py): a sidecar and exact
    # serving give the single-sync ask on one device only
    for r in range(2):
        assert not bool(worlds[2].result("fused_rag", r)["runtime_fused_rag"])


# ---- the commands in a world of one rank -------------------------------------------

def test_a_rebuild_is_stage_then_switch_commands_and_retires_the_old_tier():
    """The (1, 1) mesh's command stream with no process group (the chip's
    world of one rank runs the same path): a rebuild publishes
    ``tiered.stage`` then ``tiered.switch``, each tier is the command
    target ``tiered.ivf#<generation>``, and a superseded tier's frontier
    probe is refused before it is published; a search carries the leader's
    nprobe in its plan."""
    from docqa_tpu_torch.config import StoreConfig
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.index.tiered import TieredIndex
    from docqa_tpu_torch.runtime import mesh as tmesh

    mesh = tmesh.MeshContext(None, "data", "model", 1, 1, 0, 0, torch.device("cpu"))
    stream = tmesh.CommandStream(mesh)
    x = W.clustered(2000, seed=11)
    store = VectorStore(StoreConfig(dim=W.IVF_DIM, shard_capacity=2048, dtype="float32"),
                        device="cpu", mesh=mesh)
    store.add(x, [{"doc_id": f"d{i}"} for i in range(len(x))])
    tiered = TieredIndex(store, nprobe=4, min_rows=100, rebuild_tail_rows=10**6)
    stream.register("store", store)
    stream.register("tiered", tiered)
    stream.open()
    tmesh.reset_commands()
    try:
        assert tiered.rebuild()
        first = tiered._tier[0]
        assert dict(tmesh.COMMANDS) == {"tiered.stage": 1, "tiered.switch": 1}
        assert stream._targets["tiered.ivf#1"] is first
        tiered.set_nprobe(2)
        seen = []
        real = tiered._search_dense

        def record(*a, **kw):
            seen.append(kw["nprobe"])
            return real(*a, **kw)

        tiered._search_dense = record
        tiered.search(x[:2], k=5)
        assert seen == [2] and tmesh.COMMANDS["tiered.search"] == 1
        rows, _s, _f = first.timed_probe(x[:2], k=5, nprobe=4)
        assert len(rows) == 2 and tmesh.COMMANDS["tiered.ivf#1.timed_probe"] == 1
        assert tiered.rebuild() and tiered.tier_generation == 2
        assert "tiered.ivf#1" not in stream._targets
        with pytest.raises(RuntimeError, match="no longer registered"):
            first.timed_probe(x[:2], k=5, nprobe=4)
        tiered.reset()
        assert tiered._tier is None and "tiered.ivf#2" not in stream._targets
    finally:
        stream.stop()
        tmesh.reset_commands()
