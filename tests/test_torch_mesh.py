"""Port parity, the device plane on a mesh: docqa_tpu_torch's
``runtime/mesh.py``, ``parallel/`` and ``ops/topk.py`` and the engines'
``mesh=`` against docqa_tpu's on the same mesh shapes, on the CPU.

The reference runs in this process on the conftest's 8 virtual CPU devices
(``host_cpu_mesh(n, data)``); the port runs SPMD in gloo worlds of 2 and 4
processes (``tests/torch_mesh_worker.py``, a file store under ``tmp_path``,
so no port is bound), one world per size for the module, whose ranks run
every scenario and write their results as ``.npz``.  Reference device
``jax.devices("cpu")[r]`` and port rank ``r`` hold the same shard: both
meshes are row-major, ``rank = d * n_model + m``.  Mesh shapes: (1, 2) in
the 2-rank world, (1, 4) and (2, 2) in the 4-rank one.

Tolerances, float32:
* shards: bit for bit (both cut the same arrays; an int4 shard is compared
  packed);
* greedy ids (plain and K = 4 speculation), quantised ids, store and
  retrieval ids: identical (random unit vectors leave no tie at the k-th
  score; masked rows are dropped on both sides);
* ring and Ulysses outputs: 2e-5 absolute, the reference tests' own bound
  (online-softmax merges in another order);
* first-step logits: 1e-5 relative RMS (a row-parallel product summed over
  the model axis adds its partial sums in another order than one product);
* scores and embeddings: 1e-5 absolute (float32 dot products over 64 dims).

The collective budgets are pinned from the port's own counter
(``runtime.mesh.COLLECTIVES``): a sharded search two gathers, a
data-parallel batch one.  Tensor-parallel decoding is in
``test_torch_mesh_tp.py``, ring and Ulysses attention in
``test_torch_mesh_sp.py``.
"""


import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import MeshConfig as JMeshConfig
from docqa_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.retrieve import FusedRetriever as JFusedRetriever
from docqa_tpu.engines.seq2seq import Seq2SeqEngine as JSeq2SeqEngine
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.ops import topk as jtopk
from docqa_tpu.parallel import sharding as jshard
from docqa_tpu.runtime import mesh as jmesh
from docqa_tpu.utils.compat import shard_map
from docqa_tpu_torch import weights
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig, MeshConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.ops import topk as ttopk
from docqa_tpu_torch.ops.qmatmul import pack_int4, unpack_int4
from docqa_tpu_torch.parallel import sharding as tshard
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world of each size for the module, started at once; its
    ranks run every scenario of this file."""
    out = {}
    for n, scenarios in ((2, "mesh_basics,shard_trees,topk,store,runtime_refused"), (4, "mesh_basics,shard_trees,topk,store,retrieve,seq2seq")):
        d = tmp_path_factory.mktemp(f"world{n}")
        out[n] = W.World(n, scenarios, d)
    yield out
    for w in out.values():
        w.close()


def _world(worlds, tag):
    return worlds[_world_of(tag)]


def _jmesh(tag):
    d, m = _shape(tag)
    return jmesh.host_cpu_mesh(d * m, data=d)


# ---- mesh basics -------------------------------------------------------------

def test_mesh_config_equals_the_reference():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMeshConfig())
    from docqa_tpu_torch.config import load_config

    cfg = load_config(env={"DOCQA_MESH__MODEL_PARALLEL": "4"},
                      overrides={"mesh.platform": "cpu"})
    assert cfg.mesh.model_parallel == 4 and cfg.mesh.platform == "cpu"


@pytest.mark.parametrize("n, data, model", [
    (8, -1, -1), (8, 2, -1), (8, -1, 4), (8, 2, 4), (8, 3, -1), (8, -1, 3),
    (8, 3, 3), (4, 2, 2), (1, 1, -1), (1, 2, -1),
])
def test_factor_equals_the_reference(n, data, model):
    try:
        want = jmesh._factor(n, data, model)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            tmesh._factor(n, data, model)
        return
    assert tmesh._factor(n, data, model) == want


def test_make_mesh_without_a_world_is_1x1():
    m = tmesh.make_mesh(device="cpu")
    assert (m.n_data, m.n_model, m.n_devices, m.rank) == (1, 1, 1, 0)
    assert m.model_group is None and m.data_group is None
    assert tmesh.make_mesh(MeshConfig(platform="cpu")).device == torch.device("cpu")
    with pytest.raises(ValueError):  # the reference's test_bad_factorization
        tmesh.make_mesh(MeshConfig(data_parallel=3, model_parallel=2), device="cpu")


def test_multihost_init_alone_returns_false(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.multihost_init(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("tag", SHAPES)
def test_rank_coordinates_match_the_reference_grid(worlds, tag):
    n = _world_of(tag)
    grid = np.vectorize(lambda dev: dev.id)(_jmesh(tag).mesh.devices)
    cpus = [dev.id for dev in jax.devices("cpu")[:n]]
    for r in range(n):
        res = _world(worlds, tag).result("mesh_basics", r)
        nd, nm, di, mi, rank = res[tag + "_coords"].tolist()
        assert (nd, nm, rank) == (*_shape(tag), r)
        assert grid[di, mi] == cpus[r]
        assert res[tag + "_model_ranks"].tolist() == [cpus.index(i) for i in grid[di]]
        assert res[tag + "_data_ranks"].tolist() == [cpus.index(i) for i in grid[:, mi]]


# ---- sharding, bit for bit ------------------------------------------------------

def _reference_trees():
    q8, q4 = DecoderConfig(**W.QUANT_WIDTHS), DecoderConfig(**W.INT4_DIV_WIDTHS)
    return {
        "float": (J_TP_CFG, weights.host_init_decoder_params(TP_CFG, 1)),
        "int8": (JDecoderConfig(**W.QUANT_WIDTHS),
                 weights.host_init_quantized_decoder_params(q8, 0, 8)),
        "int4": (JDecoderConfig(**W.QUANT_WIDTHS),
                 weights.host_init_quantized_decoder_params(q8, 0, 4)),
        "int4div": (JDecoderConfig(**W.INT4_DIV_WIDTHS),
                    weights.host_init_quantized_decoder_params(q4, 0, 4)),
    }


@pytest.mark.parametrize("kind", ["float", "int8", "int4", "int4div", "cache", "pool"])
@pytest.mark.parametrize("tag", SHAPES)
def test_shards_equal_the_reference_bit_for_bit(worlds, tag, kind):
    n = _world_of(tag)
    mesh = _jmesh(tag)
    cpus = jax.devices("cpu")[:n]
    if kind in ("cache", "pool"):
        arr = jnp.asarray(W.cache_tensor() if kind == "cache" else W.pool_tensor())
        shard = jshard.shard_kv_cache if kind == "cache" else jshard.shard_paged_pools
        ref = {f"{kind}/k0": shard({"k0": arr}, J_TP_CFG, mesh)["k0"]}
    else:
        cfg, tree = _reference_trees()[kind]
        jtree = {}
        for name, v in tree.items():
            if name.endswith("__scale") or v.dtype != torch.uint8:
                jtree[name] = jnp.asarray(np.asarray(v))
            else:  # packed int4 -> the reference's int4 [groups, g, out]
                g = _in_dim(name, cfg) // v.shape[0]
                jtree[name] = jnp.asarray(unpack_int4(v, g).numpy(), jnp.int4)
        ref = {f"{kind}/{k}": v for k, v in
               jshard.shard_decoder_params(jtree, cfg, mesh).items()}
    for r in range(n):
        res = _world(worlds, tag).result(f"shard_trees_{tag}", r)
        for key, arr in ref.items():
            shard = next(s for s in arr.addressable_shards if s.device == cpus[r])
            want = np.asarray(shard.data)
            got = res[key]
            if got.dtype == np.uint8:  # packed int4: compare packed
                want = pack_int4(torch.from_numpy(want.astype(np.int8))).numpy()
            assert got.shape == want.shape, (key, r)
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (key, r)


def _in_dim(name, cfg):
    if name.endswith(("_wo",)):
        return cfg.num_heads * cfg.head_dim
    if name.endswith("_w_down"):
        return cfg.mlp_dim
    return cfg.hidden_dim


def test_indivisible_heads_raise_naming_the_width():
    mesh3 = tmesh.MeshContext(None, "data", "model", 1, 3, 0, 0, torch.device("cpu"))
    tree = {k: torch.from_numpy(v) for k, v in weights.host_init_decoder_params(TP_CFG, 1).items()}
    with pytest.raises(ValueError, match="num_heads=8"):
        tshard.shard_decoder_params(tree, TP_CFG, mesh3)
    mesh1 = tmesh.MeshContext(None, "data", "model", 1, 1, 0, 0, torch.device("cpu"))
    same = tshard.shard_decoder_params(tree, TP_CFG, mesh1)
    assert all(same[k] is tree[k] for k in tree)  # 1x1: the leaves themselves


# ---- top-k ---------------------------------------------------------------------

def test_merge_topk_equals_the_reference():
    rng = np.random.default_rng(7)
    scores = rng.normal(size=(4, 3, 5)).astype(np.float32)
    gids = np.arange(20).reshape(4, 1, 5).repeat(3, axis=1)
    jv, ji = jtopk.merge_topk(jnp.array(scores), jnp.array(gids), k=6)
    tv, ti = ttopk.merge_topk(torch.from_numpy(scores), torch.from_numpy(gids), k=6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("tag", ["1x2", "1x4"])
def test_sharded_topk_equals_the_reference(worlds, tag):
    n = _world_of(tag)
    mesh = _jmesh(tag)
    scores = W.topk_scores()
    n_local = scores.shape[1] // n

    def body(s):
        return jtopk.sharded_topk(s, jax.lax.axis_index("model") * n_local, 5, "model")

    jv, ji = shard_map(body, mesh=mesh.mesh, in_specs=P(None, "model"), out_specs=P(),
                       check_vma=False)(jnp.array(scores))
    for r in range(n):
        res = _world(worlds, tag).result("topk", r)
        np.testing.assert_array_equal(res["ids"], np.asarray(ji))
        np.testing.assert_array_equal(res["vals"], np.asarray(jv))
        assert _counts(res) == {"all_gather.topk": 2}


# ---- the store and retrieval ------------------------------------------------------

def _rows(res):
    return [[r.row_id for r in row] for row in res]


@pytest.mark.parametrize("tag", ["1x2", "1x4"])
def test_sharded_store_equals_the_reference(worlds, tag):
    """tests/test_store.py's sharded recipes: the same ids as the
    reference's row-sharded store, through growth across the shard
    boundary, a filter, deletes and a compaction."""
    mesh = _jmesh(tag)
    cfg = JStoreConfig(dim=64, shard_capacity=256, dtype="float32")
    st = JVectorStore(cfg, mesh=mesh)
    v = W.store_vectors(512, 64)
    st.add(v, [{"doc_id": f"d{i}"} for i in range(512)])
    match = st.search(W.store_vectors(3, 64, seed=3), k=7)
    cap_match = st._capacity
    st = JVectorStore(cfg, mesh=mesh)
    v = W.store_vectors(1500, 64)
    meta = [{"patient_id": f"P{i % 5}", "doc_id": f"doc{i // 10}"} for i in range(1500)]
    st.add(v[:800], meta[:800])
    cap800 = st._capacity
    st.add(v[800:], meta[800:])
    want = {"filtered": _rows(st.search(v[1203], k=4, filters={"patient_id": "P3"})),
            "all": _rows(st.search(v[[5, 700, 1203, 1499]], k=6))}
    cap1500 = st._capacity
    st.delete_docs([f"doc{i}" for i in range(70, 130)])
    want["deleted"] = _rows(st.search(v[[5, 700, 1203, 1499]], k=6))
    n_compacted = st.compact_deleted()
    want["compacted"] = _rows(st.search(v[[5, 700, 1203, 1499]], k=6))
    assert want["filtered"][0][0] == 1203
    for r in range(_world_of(tag)):
        res = _world(worlds, tag).result("store", r)
        assert res["match/ids"].tolist() == _rows(match)
        np.testing.assert_allclose(res["match/scores"],
                                   [[x.score for x in row] for row in match], atol=1e-5)
        assert _counts(res, "match/") == {"all_gather.topk": 2}
        assert int(res["match/block"]) * _shape(tag)[1] == cap_match
        assert (int(res["grow/cap800"]), int(res["grow/cap1500"])) == (cap800, cap1500)
        for key in ("filtered", "all", "deleted", "compacted"):
            assert res[f"grow/{key}"].tolist() == want[key], key
        assert int(res["grow/compacted_n"]) == n_compacted
        assert int(res["grow/cap_compacted"]) == st._capacity


@pytest.fixture(scope="module")
def reference_2x2_encoder():
    mesh = _jmesh("2x2")
    enc = JEncoderEngine(JEncoderConfig(**W.ENC_WIDTHS), mesh=mesh)
    return mesh, enc


def test_fused_retriever_over_a_sharded_store_with_a_dp_encoder(worlds, reference_2x2_encoder):
    """tests/test_retrieve.py's mesh recipe on (2, 2): the encoder splits
    the batch over data, the store its rows over model."""
    mesh, enc = reference_2x2_encoder
    emb = enc.encode_texts(W.RETRIEVE_TEXTS)
    st = JVectorStore(JStoreConfig(dim=64, shard_capacity=256), mesh=mesh)
    st.add(emb, [{"doc_id": f"d{i}", "patient_id": f"p{i % 4}"}
                 for i in range(len(W.RETRIEVE_TEXTS))])
    retr = JFusedRetriever(enc, st)
    want = retr.search_texts(W.RETRIEVE_QUERIES, k=5)
    filt = retr.search_texts(W.RETRIEVE_QUERIES[:1], k=6, filters={"patient_id": "p2"})[0]
    for r in range(4):
        res = worlds[4].result("retrieve", r)
        np.testing.assert_allclose(res["emb"], emb, atol=1e-5, rtol=0)
        assert res["ids"].tolist() == _rows(want)
        np.testing.assert_allclose(res["scores"], [[x.score for x in row] for row in want],
                                   atol=1e-5)
        assert res["filtered"].tolist() == [x.row_id for x in filt]
        assert _counts(res) == {"all_gather.encode": 1, "all_gather.topk": 2}


def test_encoder_engine_data_parallel_equals_the_reference(worlds, reference_2x2_encoder):
    """tests/test_encoder.py's mesh case on (2, 2): 40 texts padded to a
    multiple of the data axis, one gather a batch."""
    _mesh, enc = reference_2x2_encoder
    want = enc.encode_texts(W.RETRIEVE_TEXTS)
    for r in range(4):
        res = worlds[4].result("retrieve", r)
        assert res["emb"].shape == (len(W.RETRIEVE_TEXTS), 64)
        np.testing.assert_allclose(res["emb"], want, atol=1e-5, rtol=0)
        assert _counts(res, "enc/") == {"all_gather.encode": 1}


def test_seq2seq_engine_data_parallel_equals_the_reference(worlds):
    eng = JSeq2SeqEngine(JSeq2SeqConfig(**W.S2S_WIDTHS), seed=0, mesh=_jmesh("2x2"))
    want = eng.generate_ids(W.S2S_SRC, max_new_tokens=10)
    for r in range(4):
        res = worlds[4].result("seq2seq", r)
        assert [[t for t in row if t >= 0] for row in res["ids"].tolist()] == want
        assert _counts(res) == {"all_gather.seq2seq": 1}


# ---- failure paths ----------------------------------------------------------------

def test_runtime_refuses_a_world_of_more_than_one_rank(worlds):
    # the name is the one this test had while the world refused: tiered
    # serving on a mesh (item 9c) is ported, so a world of 2 boots it and
    # the leader answers (tests/test_torch_mesh_tiered.py holds its answers)
    ranks = [worlds[2].result("runtime_refused", r) for r in range(2)]
    out = json.loads(str(ranks[0]["results"]))
    assert out["index"] == "TieredIndex" and out["retriever"] == "FusedTieredRetriever"
    assert out["ask"]["status"] == 200 and not out["ask"]["degraded"]
    assert str(ranks[1]["digest"]) == str(ranks[0]["digest"])


def test_a_failing_rank_makes_the_others_raise_not_hang(tmp_path):
    w = W.World(2, "rank_fails", tmp_path, timeout_s=10)
    try:
        rcs = w.join()
        assert rcs[1] not in (0, None), w.stderr()
        assert rcs[0] == 0, w.stderr()  # rank 0 caught the collective's error
        with np.load(tmp_path / "rank_fails.r0.npz") as d:
            assert float(d["seconds"]) < 10 + 5
        assert w.seconds < 60
    finally:
        w.close()


def test_no_mesh_path_yet_refuses_a_sharded_engine():
    # the name is the one this test had while they refused: the tiered and
    # fused-RAG programs (item 9c) now take sharded parts
    from docqa_tpu_torch.config import EncoderConfig, StoreConfig
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.rag_fused import FusedRAG
    from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.index.tiered import TieredIndex

    mesh2 = tmesh.MeshContext(None, "data", "model", 1, 2, 0, 0, torch.device("cpu"))
    enc = EncoderEngine(EncoderConfig(**W.ENC_WIDTHS), device="cpu")
    store = VectorStore(StoreConfig(dim=64, shard_capacity=256), device="cpu")
    store.mesh = mesh2
    retr = FusedTieredRetriever(enc, TieredIndex(store), device="cpu")
    assert retr.tiered.store.mesh is mesh2
    eng = GenerateEngine(TP_CFG, GenerateConfig(), device="cpu")
    eng.mesh = mesh2
    sidecar = VectorStore(StoreConfig(dim=64, shard_capacity=256, token_width=8), device="cpu")
    sidecar.mesh = mesh2
    rag = FusedRAG(enc, sidecar, eng, "{context} {question}", device="cpu")
    assert rag.store.mesh is mesh2 and rag.generator.mesh is mesh2
