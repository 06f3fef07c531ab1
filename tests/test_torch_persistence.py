"""Port parity, the store's lifecycle: the DNS1 codec, the token sidecar
through growth, tombstones and compaction, snapshots and restore across
the two packages, and ``data.work_dir`` in the port's runtime (journal,
on-disk registry, reconciliation, kill and restart), on the CPU.

Codec: the port's bytes must equal the reference's ``_py_write_shard``
bytes for float32 and bf16 (finite inputs; both round to nearest even), and
the native and Python codecs must read each other's files.  Snapshots: a
snapshot written by either package must restore in the other with
bitwise-equal float32 vectors (both renormalize through ``add``), equal
metadata, sidecar and version, and top-k ids equal under the tie rule
(scores within 1e-5 of the k-th are interchangeable: float32 sums of the
same products, in another order).  The runtime cases follow
``tests/test_persistence.py`` and the erasure cases of
``tests/test_delete.py`` on the port's own runtime.
"""

import json
import os

import numpy as np
import pytest
import torch

from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.runtime import native as jnative
from docqa_tpu_torch.config import StoreConfig, load_config
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.runtime import native
from docqa_tpu_torch.service import registry as reg
from docqa_tpu_torch.service.app import DocQARuntime

torch.set_num_threads(1)

DIM = 16
W = 8
TIE = 1e-5

TINY = {
    "encoder.hidden_dim": 64, "encoder.num_layers": 1, "encoder.num_heads": 4,
    "encoder.mlp_dim": 128, "encoder.embed_dim": 64,
    "store.dim": 64, "store.shard_capacity": 256,
    "ner.train_steps": 0, "ner.hidden_dim": 32, "ner.num_layers": 1,
    "ner.num_heads": 2, "ner.mlp_dim": 64,
    "decoder.hidden_dim": 64, "decoder.num_layers": 1, "decoder.num_heads": 4,
    "decoder.num_kv_heads": 2, "decoder.head_dim": 16, "decoder.mlp_dim": 128,
    "decoder.vocab_size": 512, "generate.max_new_tokens": 8,
    "flags.use_fake_llm": True, "flags.use_fake_encoder": True,
}
NOTE = "Aspirin 100 mg daily was prescribed after the cardiac event."


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    meta = [{"doc_id": f"doc{i // 2}", "source": f"s{i}", "patient_id": "p1",
             "text_content": f"chunk {i}"} for i in range(n)]
    tokens = rng.integers(5, 500, size=(n, W + 3)).astype(np.int32)
    lens = rng.integers(0, W + 3, size=(n,)).astype(np.int32)
    return vecs, meta, tokens, lens


def _cfg(cls, **kw):
    return cls(**{"dim": DIM, "shard_capacity": 128, "dtype": "float32",
                  "token_width": W, **kw})


def _sidecar(store):
    tok, tok_len = store.token_sidecar()
    n = store.count
    return np.asarray(tok)[:n], np.asarray(tok_len)[:n]


def _ids_equal_under_ties(got, want):
    """Each query's hit ids equal, but a hit tied (within ``TIE``) with
    the k-th score is interchangeable."""
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if not w:
            continue
        kth = w[-1].score
        strict = lambda hits: [h.row_id for h in hits if h.score > kth + TIE]
        assert strict(g) == strict(w)
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w],
                                   atol=TIE)


# ---- the DNS1 codec ----------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_codec_bytes_equal_the_reference(tmp_path, bf16):
    arr = np.random.default_rng(1).standard_normal((37, 24)).astype(np.float32)
    jnative._py_write_shard(str(tmp_path / "ref.dns"), arr, bf16=bf16)
    native._py_write_shard(str(tmp_path / "py.dns"), arr, bf16=bf16)
    lib = native.load()
    assert lib is not None, "the native codec did not build"
    lib.write_shard(str(tmp_path / "native.dns"), arr, bf16=bf16)
    ref = (tmp_path / "ref.dns").read_bytes()
    assert (tmp_path / "py.dns").read_bytes() == ref
    assert (tmp_path / "native.dns").read_bytes() == ref
    assert ref[:4] == b"DNS1" and len(ref) == 64 + arr.size * (2 if bf16 else 4)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_native_and_python_codecs_read_each_other(tmp_path, bf16):
    arr = np.random.default_rng(2).standard_normal((9, 7)).astype(np.float32)
    lib = native.load()
    lib.write_shard(str(tmp_path / "n.dns"), arr, bf16=bf16)
    native._py_write_shard(str(tmp_path / "p.dns"), arr, bf16=bf16)
    a = native._py_read_shard(str(tmp_path / "n.dns"))
    b = lib.read_shard(str(tmp_path / "p.dns"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jnative._py_read_shard(str(tmp_path / "n.dns")))
    if not bf16:
        np.testing.assert_array_equal(a, arr)


@pytest.mark.parametrize("codec", ["native", "python"])
def test_crc_mismatch_raises(tmp_path, codec):
    arr = np.ones((4, 4), np.float32)
    path = str(tmp_path / "v.dns")
    native._py_write_shard(path, arr)
    raw = bytearray(open(path, "rb").read())
    raw[70] ^= 0xFF  # a payload byte
    open(path, "wb").write(bytes(raw))
    read = native.load().read_shard if codec == "native" else native._py_read_shard
    with pytest.raises(native.ShardError, match="crc mismatch"):
        read(path)


def test_front_door_counts_the_codec_and_builds_outside_native(tmp_path):
    before = dict(native.RUNS)
    path = native.write_vectors(str(tmp_path / "v"), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(native.read_vectors(path), np.eye(3, dtype=np.float32))
    assert native.RUNS[("write", "native")] == before.get(("write", "native"), 0) + 1
    assert native.RUNS[("read", "native")] == before.get(("read", "native"), 0) + 1
    built = native.library_path("g++")
    assert built.parent == native.BUILD_DIR and built.exists()


# ---- the token sidecar -------------------------------------------------------

def test_sidecar_follows_growth_tombstones_and_compaction():
    vecs, meta, tokens, lens = _rows(300)
    store = VectorStore(_cfg(StoreConfig), device="cpu")
    jstore = JVectorStore(_cfg(JStoreConfig))
    for s in (store, jstore):
        s.add(vecs[:200], meta[:200], token_rows=tokens[:200], token_lens=lens[:200])
        s.add(vecs[200:], meta[200:], token_rows=tokens[200:])  # lengths implied
    assert store.capacity >= 300
    got, want = _sidecar(store), (np.asarray(jstore.token_sidecar()[0])[:300],
                                  np.asarray(jstore.token_sidecar()[1])[:300])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], tokens[:, :W])
    for s in (store, jstore):
        s.delete_docs(["doc3", "doc40", "doc41"])
        s.compact_deleted()
    keep = [i for i in range(300) if meta[i]["doc_id"] not in ("doc3", "doc40", "doc41")]
    got = _sidecar(store)
    np.testing.assert_array_equal(got[0], tokens[keep, :W])
    np.testing.assert_array_equal(got[0], np.asarray(jstore.token_sidecar()[0])[: store.count])
    np.testing.assert_array_equal(got[1], np.asarray(jstore.token_sidecar()[1])[: store.count])
    host, md = store.vectors_snapshot(10)
    jhost, jmd = jstore.vectors_snapshot(10)
    np.testing.assert_array_equal(host, jhost)
    assert md == jmd
    np.testing.assert_array_equal(store.host_rows([0, 5, 7]), jstore.host_rows([0, 5, 7]))


def test_sidecar_off_ignores_token_rows():
    vecs, meta, tokens, lens = _rows(4)
    store = VectorStore(_cfg(StoreConfig, token_width=0), device="cpu")
    store.add(vecs, meta, token_rows=tokens, token_lens=lens)
    assert store.token_sidecar() is None and store.count == 4


# ---- snapshots across the packages ------------------------------------------

def _filled(cls_store, cls_cfg, **kw):
    vecs, meta, tokens, lens = _rows(150, seed=4)
    s = cls_store(_cfg(cls_cfg), **kw)
    s.add(vecs, meta, token_rows=tokens, token_lens=lens)
    s.delete_docs(["doc1", "doc30"])  # tombstones ride the metadata
    return s


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_snapshot_restores_across_packages(tmp_path, direction):
    queries = np.random.default_rng(9).standard_normal((6, DIM)).astype(np.float32)
    jsrc = _filled(JVectorStore, JStoreConfig)
    tsrc = _filled(VectorStore, StoreConfig, device="cpu")
    src = jsrc if direction == "reference_to_port" else tsrc
    src.snapshot(str(tmp_path))
    # the same snapshot restored by both packages
    port = VectorStore.restore(str(tmp_path), _cfg(StoreConfig), device="cpu")
    ref = JVectorStore.restore(str(tmp_path), _cfg(JStoreConfig))
    for restored in (port, ref):
        assert restored.count == src.count and restored.version == src.version
        assert restored.deleted_count == 4
    pv, pm = port.vectors_snapshot()
    rv, rm = ref.vectors_snapshot()
    assert pv.tobytes() == rv.tobytes()
    assert pm == rm == src.metadata_rows()
    np.testing.assert_array_equal(_sidecar(port)[0], np.asarray(ref.token_sidecar()[0])[: ref.count])
    np.testing.assert_array_equal(_sidecar(port)[1], np.asarray(ref.token_sidecar()[1])[: ref.count])
    np.testing.assert_array_equal(_sidecar(port)[0], _sidecar(tsrc)[0])
    _ids_equal_under_ties(port.search(queries, k=5), ref.search(queries, k=5))
    _ids_equal_under_ties(port.search(queries, k=5), src.search(queries, k=5))
    with open(os.path.join(str(tmp_path), f"index_v{src.version}", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["token_width"] == W and manifest["vectors"] == "vectors.dns"


def test_snapshot_replaces_a_stale_same_version_dir(tmp_path):
    d = str(tmp_path / "index")
    cfg = StoreConfig(dim=8, shard_capacity=128, dtype="float32")
    s1 = VectorStore(cfg, device="cpu")
    s1.add(np.eye(8, dtype=np.float32)[:2], [{"tag": "old", "i": i} for i in range(2)])
    s1.snapshot(d)
    s2 = VectorStore(cfg, device="cpu")
    s2.add(np.eye(8, dtype=np.float32)[:3], [{"tag": "new", "i": i} for i in range(3)])
    assert s2.version == s1.version
    s2.snapshot(d)
    s3 = VectorStore.restore(d, cfg, device="cpu")
    assert s3.count == 3 and all(m["tag"] == "new" for m in s3.metadata_rows())


def test_old_snapshots_pruned(tmp_path):
    d = str(tmp_path / "index")
    cfg = StoreConfig(dim=8, shard_capacity=128, dtype="float32")
    s = VectorStore(cfg, device="cpu")
    s.add(np.eye(8, dtype=np.float32)[:1], [{"i": -1}])
    for i in range(5):
        s.add(np.eye(8, dtype=np.float32)[i + 1 : i + 2], [{"i": i}])
        s.snapshot(d)
    dirs = sorted(p for p in os.listdir(d) if p.startswith("index_v"))
    assert dirs == ["index_v5", "index_v6"]  # published + one predecessor
    assert open(os.path.join(d, "LATEST")).read() == "index_v6"


def test_erase_prunes_the_predecessor_snapshot(tmp_path):
    vecs, meta, tokens, lens = _rows(8)
    store = VectorStore(_cfg(StoreConfig), device="cpu")
    store.add(vecs, meta, token_rows=tokens, token_lens=lens)
    store.snapshot(str(tmp_path))  # holds doc0
    store.delete_docs(["doc0"])
    store.compact_deleted()
    store.snapshot(str(tmp_path), keep_previous=False)
    dirs = [d for d in os.listdir(str(tmp_path)) if d.startswith("index_v")]
    assert len(dirs) == 1
    again = VectorStore.restore(str(tmp_path), _cfg(StoreConfig), device="cpu")
    assert all(md["doc_id"] != "doc0" for md in again.metadata_rows())
    np.testing.assert_array_equal(_sidecar(again)[0], tokens[2:, :W])


# ---- the runtime's data.work_dir ----------------------------------------------

def _rt_cfg(tmp_path, **extra):
    return load_config(env={}, overrides={
        **TINY, "data.work_dir": str(tmp_path / "work"), **extra,
    })


def _runtime(cfg):
    return DocQARuntime(cfg, device="cpu").start()


def _kill(rt):
    """Tear down without the final snapshot (a SIGKILL's effect on disk),
    joining the threads a kill would end."""
    if rt.sampler is not None:
        rt.sampler.stop()
    rt.pipeline.stop()
    rt.broker.close()
    rt.registry.close()


def test_restart_preserves_documents_and_registry(tmp_path):
    cfg = _rt_cfg(tmp_path, **{"store.token_width": 16})
    rt1 = _runtime(cfg)
    try:
        rec = rt1.pipeline.ingest_document("note.txt", NOTE.encode(), patient_id="p1")
        assert rt1.pipeline.wait_indexed(rec.doc_id, timeout=60)
        count, version = rt1.store.count, rt1.store.version
        answer = rt1.qa.ask("aspirin dose?")
        sidecar = _sidecar(rt1.store)
    finally:
        rt1.stop()  # the final snapshot
    rt2 = _runtime(cfg)
    try:
        assert (rt2.store.count, rt2.store.version) == (count, version)
        assert rt2.qa.ask("aspirin dose?") == answer
        rows = rt2.qa.patient_snippets("p1")
        assert rows and "Aspirin" in rows[0]["text"]
        docs = rt2.registry.list_documents()
        assert [(d.filename, d.status) for d in docs] == [("note.txt", reg.INDEXED)]
        np.testing.assert_array_equal(_sidecar(rt2.store)[0], sidecar[0])
        # the lexical tier holds the restored rows (the sink's back-fill)
        assert rt2.lexical.search(["aspirin"], k=1)[0][0][1] == 0
    finally:
        rt2.stop()


def test_replayed_index_message_does_not_duplicate_chunks(tmp_path):
    rt = _runtime(_rt_cfg(tmp_path))
    try:
        rec = rt.pipeline.ingest_document("note.txt", NOTE.encode(), patient_id="p1")
        assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
        count = rt.store.count
        rt.pipeline._index_handler([{
            "doc_id": rec.doc_id, "original_text_masked": NOTE,
            "metadata": {"patient_id": "p1", "filename": "note.txt"},
        }])
        assert rt.store.count == count
        assert rt.registry.get(rec.doc_id).status == reg.INDEXED
    finally:
        rt.stop()


def test_replay_after_restart_skips_restored_documents(tmp_path):
    cfg = _rt_cfg(tmp_path)
    rt1 = _runtime(cfg)
    try:
        rec = rt1.pipeline.ingest_document("note.txt", NOTE.encode(), patient_id="p1")
        assert rt1.pipeline.wait_indexed(rec.doc_id, timeout=60)
    finally:
        rt1.stop()
    rt2 = _runtime(cfg)
    try:
        count = rt2.store.count
        rt2.pipeline._index_handler([{
            "doc_id": rec.doc_id, "original_text_masked": NOTE,
            "metadata": {"patient_id": "p1", "filename": "note.txt"},
        }])
        assert rt2.store.count == count
    finally:
        rt2.stop()


def test_crash_between_snapshots_reconciles_registry(tmp_path):
    cfg = _rt_cfg(tmp_path, **{"data.snapshot_every": 10_000})
    rt1 = _runtime(cfg)
    rec = rt1.pipeline.ingest_document("lost.txt", NOTE.encode())
    assert rt1.pipeline.wait_indexed(rec.doc_id, timeout=60)
    _kill(rt1)
    rt2 = _runtime(cfg)
    try:
        assert rt2.registry.get(rec.doc_id).status == reg.ERROR_INDEXING
        assert rt2.store.count == 0
    finally:
        rt2.stop()


def test_no_work_dir_means_no_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rt = _runtime(load_config(env={}, overrides=dict(TINY)))
    try:
        rec = rt.pipeline.ingest_document("n.txt", NOTE.encode())
        assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
    finally:
        rt.stop()
    assert os.listdir(tmp_path) == []


def test_snapshot_every_document(tmp_path):
    rt = _runtime(_rt_cfg(tmp_path, **{"data.snapshot_every": 1}))
    try:
        rec = rt.pipeline.ingest_document("n.txt", NOTE.encode())
        assert rt.pipeline.wait_indexed(rec.doc_id, timeout=60)
        # written by the index worker before the INDEXED status
        assert os.path.exists(tmp_path / "work" / "index" / "LATEST")
    finally:
        rt.stop()


def test_bootstrap_once_then_restore(tmp_path):
    kb = tmp_path / "kb"
    kb.mkdir()
    (kb / "matrice_test.csv").write_text(
        "nom_syndrome,nom_latin,nom_chinois,score_role\n"
        "Vide de Qi,Astragalus membranaceus,Huang Qi,9\n"
        "Vide de Qi,Panax ginseng,Ren Shen,8\n"
    )
    cfg = _rt_cfg(tmp_path, **{"data.bootstrap_dir": str(kb), "store.token_width": 16})
    rt1 = _runtime(cfg)
    try:
        assert rt1.store.count == 2
        # the bootstrap snapshotted at once, sidecar rows included
        assert os.path.exists(tmp_path / "work" / "index" / "LATEST")
        assert (_sidecar(rt1.store)[1] > 0).all()
        version = rt1.store.version
    finally:
        rt1.stop()
    rt2 = _runtime(cfg)
    try:
        assert (rt2.store.count, rt2.store.version) == (2, version)
        kb_rows = [r for r in rt2.store.metadata_rows() if r.get("type") == "knowledge_base"]
        assert len(kb_rows) == 2
    finally:
        rt2.stop()


def test_erasure_leaves_no_predecessor_and_survives_restart(tmp_path):
    cfg = _rt_cfg(tmp_path, **{"data.snapshot_every": 1})
    rt = _runtime(cfg)
    try:
        recs = [rt.pipeline.ingest_document(f"{i}.txt", f"Note {i} stable vitals.".encode(),
                                            patient_id=f"q{i}") for i in range(2)]
        for r in recs:
            assert rt.pipeline.wait_indexed(r.doc_id, timeout=60)
        assert rt.delete_document(recs[0].doc_id, erase=True) >= 1
        index = tmp_path / "work" / "index"
        assert len([d for d in os.listdir(index) if d.startswith("index_v")]) == 1
        assert rt.qa.patient_snippets("q0") == []
    finally:
        rt.stop()
    rt2 = _runtime(cfg)
    try:
        assert rt2.qa.patient_snippets("q0") == [] and rt2.qa.patient_snippets("q1")
        assert rt2.registry.get(recs[0].doc_id).status == reg.DELETED
    finally:
        rt2.stop()


def test_corrupt_snapshot_serves_a_fresh_store(tmp_path):
    cfg = _rt_cfg(tmp_path)
    rt1 = _runtime(cfg)
    try:
        rec = rt1.pipeline.ingest_document("n.txt", NOTE.encode())
        assert rt1.pipeline.wait_indexed(rec.doc_id, timeout=60)
    finally:
        rt1.stop()
    index = tmp_path / "work" / "index"
    vec = index / open(index / "LATEST").read() / "vectors.dns"
    raw = bytearray(vec.read_bytes())
    raw[-1] ^= 0xFF
    vec.write_bytes(bytes(raw))
    rt2 = _runtime(cfg)
    try:
        assert rt2.store.count == 0  # logged, served fresh
    finally:
        rt2.stop()


def test_device_fault_during_restore_propagates(tmp_path, monkeypatch):
    cfg = _rt_cfg(tmp_path)
    rt1 = _runtime(cfg)
    rt1.stop()  # an empty snapshot: LATEST exists

    def broken(*_a, **_kw):
        raise KernelError("injected: the store's upload failed")

    monkeypatch.setattr(VectorStore, "restore", classmethod(lambda cls, *a, **kw: broken()))
    with pytest.raises(KernelError, match="injected"):
        DocQARuntime(cfg, device="cpu")
