"""Port parity, the tiered index: docqa_tpu_torch's ``TieredIndex`` and
``FusedTieredRetriever`` against docqa_tpu's, on the CPU.

Both stores hold the same rows.  Unless a test builds both tiers itself on
a well-separated corpus (where k-means agrees, ``tests/test_torch_ivf.py``),
the port's IVF tier is carried across from the reference's arrays
(``ivf_from_arrays``), so search, the exact re-rank, the tail, the merge
and its fallback are compared on identical tiers.

Tolerances: float32 stores.  The exact re-rank scores host float32 rows on
both sides (equal to 1e-6); tail and probe scores are float32 sums of the
same products in another order (1e-5).  The two float32 encoders' cosines
agree within 2.4e-7 (two ulps at 1.0); a hybrid score min-max normalizes
them over the query's dense candidates, so its tolerance is that error
scaled by ``alpha * 4 / spread``.  Ids are equal but among rows tied with
the k-th score.
"""

import threading
import time

import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.engines.encoder import EncoderEngine as JEncoderEngine
from docqa_tpu.engines.retrieve import FusedTieredRetriever as JFusedTieredRetriever
from docqa_tpu.index import ivf as jivf
from docqa_tpu.index.lexical import LexicalIndex as JLexicalIndex
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.index.tiered import TieredIndex as JTieredIndex
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import EncoderConfig, StoreConfig
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
from docqa_tpu_torch.index import ivf as tivf
from docqa_tpu_torch.index import tiered as ttiered
from docqa_tpu_torch.index.lexical import LexicalIndex
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.index.tiered import TieredIndex
from docqa_tpu_torch.ops._kernels import KernelError, MeshFault

torch.set_num_threads(1)

D = 32
TOL = 1e-5
DENSE_TOL = 2.4e-7
ALPHA = 0.6
ENC = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2,
           mlp_dim=64, max_seq_len=64, embed_dim=32, dtype="float32")
LEX = dict(vocab_size=4096, tile_width=8, k1=1.5, b=0.75, ref_len=16)


@pytest.fixture(autouse=True)
def _no_observatory():
    """Neither package's process observatory is installed here (a test
    that installs one restores both)."""
    prev = (obs.set_retrieval_observatory(None), jobs.set_retrieval_observatory(None))
    yield
    obs.set_retrieval_observatory(prev[0])
    jobs.set_retrieval_observatory(prev[1])


def clustered(n, seed=0, n_centers=120, noise=0.35):
    """The reference tests' mixture-of-directions recipe at d=32."""
    rng = np.random.default_rng(seed)
    c = np.random.default_rng(12345).normal(size=(n_centers, D))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, D))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def separated(n, n_centers=16, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n_centers, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, n_centers, n)] + noise * rng.standard_normal((n, D)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def ref_arrays(jx):
    return {
        "centroids": np.asarray(jx._centroids).astype(np.float32),
        "cells": np.asarray(jx._cells) if jx.storage == "int8"
        else np.asarray(jx._cells).astype(np.float32),
        "cell_scale": None if jx._cell_scale is None else np.asarray(jx._cell_scale),
        "cell_ids": np.asarray(jx._cell_ids),
        "spill": np.asarray(jx._spill).astype(np.float32),
        "spill_ids": np.asarray(jx._spill_ids),
        "n_assign": jx.n_assign,
    }


def carry(jt, tt):
    """Publish the reference tier's arrays as the port's tier."""
    jx, covered = jt._tier
    tx = tivf.ivf_from_arrays(ref_arrays(jx), jx._meta, nprobe=jx.nprobe,
                              dtype=str(tt.store.cfg.dtype), device="cpu")
    tx._store_compactions = tt.store.compactions
    tt._tier = (tx, covered)
    return tx


def pairs(rows):
    return [[(r.score, r.row_id) for r in row] for row in rows]


def same(jrows, trows, atol=TOL):
    """Scores within ``atol`` (a float or one per query), ids equal but among
    rows tied with the last score, metadata riding with each id."""
    j, t = pairs(jrows), pairs(trows)
    assert len(j) == len(t)
    for qi, (jrow, trow) in enumerate(zip(j, t)):
        tol = atol[qi] if isinstance(atol, list) else atol
        assert len(jrow) == len(trow), (qi, jrow, trow)
        js, ts = np.array([s for s, _ in jrow]), np.array([s for s, _ in trow])
        np.testing.assert_allclose(ts, js, atol=tol, rtol=0)
        if jrow:
            cut = js[-1] + 2 * tol
            assert {r for s, r in jrow if s > cut} == {r for s, r in trow if s > cut}
    for jrow, trow in zip(jrows, trows):
        md = {r.row_id: r.metadata for r in jrow}
        assert all(r.metadata == md[r.row_id] for r in trow if r.row_id in md)


def stores(x, meta, dtype="float32", lexical=False):
    jstore = JVectorStore(JStoreConfig(dim=D, dtype=dtype, shard_capacity=1024))
    tstore = VectorStore(StoreConfig(dim=D, dtype=dtype, shard_capacity=1024), device="cpu")
    jlex = tlex = None
    if lexical:
        jlex, tlex = JLexicalIndex(**LEX), LexicalIndex(**LEX, device="cpu")
        jstore.register_index_sink(jlex)
        tstore.register_index_sink(tlex)
    jstore.add(x, meta)
    tstore.add(x, meta)
    return jstore, tstore, jlex, tlex


@pytest.fixture(scope="module")
def ref_tier():
    """One reference IVF build over 5,000 clustered rows, reused by every
    pair (its arrays are read-only; nprobe is reset per pair)."""
    x = clustered(5000, seed=3)
    meta = [{"doc_id": f"d{i // 4}", "patient_id": f"P{i % 7}", "row": i}
            for i in range(len(x))]
    jx = jivf.IVFIndex(x, meta, nprobe=6, seed=0, dtype="float32")
    return x, meta, jx


def make_pair(ref_tier, dtype="float32", **kw):
    x, meta, jx = ref_tier
    jstore, tstore, _, _ = stores(x, meta, dtype=dtype)
    jt = JTieredIndex(jstore, nprobe=6, min_rows=1000, rebuild_tail_rows=10**6, **kw)
    tt = TieredIndex(tstore, nprobe=6, min_rows=1000, rebuild_tail_rows=10**6, **kw)
    if dtype == "float32":
        jx.nprobe = 6
        jx._store_compactions = 0
        jt._tier = (jx, len(x))
    else:
        assert jt.rebuild()
    carry(jt, tt)
    return jt, tt


def queries(n=10, seed=17):
    return clustered(n, seed=seed)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_search_equals_reference(ref_tier, k):
    jt, tt = make_pair(ref_tier)
    q = queries()
    same(jt.search(q, k=k), tt.search(q, k=k))
    # every bulk row finds itself first, at full precision (the re-rank)
    x = ref_tier[0]
    got = tt.search(x[100:104], k=3)
    assert [row[0].row_id for row in got] == [100, 101, 102, 103]
    assert all(row[0].score == pytest.approx(1.0, abs=1e-6) for row in got)


def test_bf16_store_casts_queries_like_the_reference(ref_tier):
    """A bf16 store: the query is cast to the store's dtype before the probe
    and the tail (the reference's ``q.astype(centroids.dtype)``)."""
    jt, tt = make_pair(ref_tier, dtype="bfloat16")
    q = queries(seed=5)
    same(jt.search(q, k=5), tt.search(q, k=5))
    fresh = clustered(40, seed=77)
    for t in (jt, tt):
        t.store.add(fresh, [{"doc_id": f"new{i}"} for i in range(40)])
    same(jt.search(fresh[:6], k=5), tt.search(fresh[:6], k=5))


def test_tail_merge_and_fresh_rows_equal_reference(ref_tier):
    jt, tt = make_pair(ref_tier)
    covered = tt.covered
    fresh = clustered(300, seed=99)
    for t in (jt, tt):
        t.store.add(fresh, [{"doc_id": f"new{i}"} for i in range(300)])
    assert tt.tail_rows == jt.tail_rows == 300
    res = tt.search(fresh[:20], k=3)
    same(jt.search(fresh[:20], k=3), res)
    for i, row in enumerate(res):  # a fresh row finds itself first
        assert row[0].row_id == covered + i
        assert row[0].metadata["doc_id"] == f"new{i}"
    # the cached device tail follows an append
    one = clustered(1, seed=123)
    for t in (jt, tt):
        t.store.add(one, [{"doc_id": "cache-test"}])
    assert tt.search(one, k=1)[0][0].metadata["doc_id"] == "cache-test"
    same(jt.search(queries(), k=10), tt.search(queries(), k=10))


def test_tombstones_and_the_underfill_fallback_equal_reference(ref_tier):
    """Deleting the documents around the queries' top rows exercises the
    2k / 4k over-fetch and the merge's exact fallback."""
    jt, tt = make_pair(ref_tier)
    q = queries(6, seed=31)
    top = {r.metadata["doc_id"] for row in tt.search(q, k=10) for r in row}
    for t in (jt, tt):
        t.store.delete_docs(sorted(top)[:20])
    assert tt._k_bulk(10, tt.covered) == jt._k_bulk(10, jt.covered) == 20
    same(jt.search(q, k=10), tt.search(q, k=10))
    more = [m["doc_id"] for m in tt.store.metadata_rows()[:1400:4]]
    for t in (jt, tt):
        t.store.delete_docs(more)
    assert tt._k_bulk(10, tt.covered) == jt._k_bulk(10, jt.covered) == 40
    res = tt.search(q, k=10)
    same(jt.search(q, k=10), res)
    assert all(not r.metadata.get("deleted") for row in res for r in row)


def test_compaction_skips_the_rerank_then_reset_serves_exact(ref_tier):
    jt, tt = make_pair(ref_tier)
    q = queries(5, seed=41)
    for t in (jt, tt):
        t.store.delete_docs(["d3", "d7", "d11"])
        t.store.compact_deleted()
    assert tt.store.compactions == jt.store.compactions == 1
    assert not tt._rerank_active(tt._tier[0]) and not jt._rerank_active(jt._tier[0])
    for t in (jt, tt):
        t.reset()
    assert tt._tier is None
    same(jt.search(q, k=5), tt.search(q, k=5))


def test_filters_delegate_to_the_exact_store(ref_tier):
    jt, tt = make_pair(ref_tier)
    q = queries(3, seed=8)
    f = {"patient_id": "P3"}
    got = tt.search(q, k=6, filters=f)
    same(jt.search(q, k=6, filters=f), got)
    assert all(r.metadata["patient_id"] == "P3" for row in got for r in row)


def test_below_min_rows_stays_exact():
    x = clustered(300, seed=1)
    meta = [{"doc_id": i} for i in range(300)]
    jstore, tstore, _, _ = stores(x, meta)
    jt, tt = JTieredIndex(jstore, min_rows=10_000), TieredIndex(tstore, min_rows=10_000)
    assert not tt.rebuild() and not jt.rebuild()
    res = tt.search(x[3], k=5)
    same(jt.search(x[3], k=5), res)
    assert res[0][0].row_id == 3 and tt.index_stats() == jt.index_stats() == {"active": False}


def test_background_rebuild_equals_reference():
    """On a separated corpus both packages' rebuilds give the same cells:
    a search past the tail threshold starts the rebuild in the background,
    serving exact meanwhile; after it the tiers and the results agree."""
    x = separated(3000, seed=4)
    meta = [{"doc_id": f"d{i}"} for i in range(len(x))]
    jstore, tstore, _, _ = stores(x, meta)
    jt = JTieredIndex(jstore, min_rows=1000, rebuild_tail_rows=500, n_clusters=16, nprobe=4)
    tt = TieredIndex(tstore, min_rows=1000, rebuild_tail_rows=500, n_clusters=16, nprobe=4)
    q = separated(8, seed=9)
    for t in (jt, tt):
        t.search(q, k=5)  # kicks the rebuild
    deadline = time.time() + 60
    while (tt.covered == 0 or jt.covered == 0) and time.time() < deadline:
        time.sleep(0.05)
    tt.close()
    jt.close()
    assert tt.covered == jt.covered == 3000
    np.testing.assert_array_equal(tt._tier[0]._cell_ids.numpy(), np.asarray(jt._tier[0]._cell_ids))
    same(jt.search(q, k=5), tt.search(q, k=5))


def test_reset_discards_a_rebuild_begun_before_it(monkeypatch):
    x = separated(1500, seed=6)
    _, tstore, _, _ = stores(x, [{"doc_id": i} for i in range(1500)])
    tt = TieredIndex(tstore, min_rows=1000, rebuild_tail_rows=100, n_clusters=8)
    started, release = threading.Event(), threading.Event()
    real = ttiered.IVFIndex

    def slow_build(*a, **kw):
        started.set()
        assert release.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ttiered, "IVFIndex", slow_build)
    tt.search(x[:1], k=3)
    assert started.wait(30)
    tt.reset()
    release.set()
    tt.close()
    assert tt._tier is None and not tt.rebuilding
    assert tt.search(x[:1], k=1)[0][0].row_id == 0


def test_rebuild_device_fault_reaches_search_and_close(monkeypatch):
    """The reference's rebuild thread logs and drops every exception; a
    kernel or CUDA fault is kept and raised by the next search (the fused
    retriever's too) and by close()."""
    x = separated(1500, seed=8)
    _, tstore, _, _ = stores(x, [{"doc_id": i} for i in range(1500)])
    tt = TieredIndex(tstore, min_rows=1000, rebuild_tail_rows=100)

    def broken(*a, **kw):
        raise KernelError("probe kernel failed to launch")

    monkeypatch.setattr(ttiered, "IVFIndex", broken)
    tt.search(x[:1], k=3)  # starts the rebuild, served exact
    tt._rebuild_thread.join(30)
    with pytest.raises(KernelError):
        tt.search(x[:1], k=3)
    enc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    with pytest.raises(KernelError):
        FusedTieredRetriever(enc, tt, device="cpu").search_texts(["a"], k=3)
    with pytest.raises(KernelError):
        tt.close()


def test_a_mesh_fault_in_the_rebuild_reaches_search_and_close(monkeypatch):
    """On a mesh the leader's k-means is followed by commands and the
    ranks' agreement: a lost rank there (``MeshFault``) is kept as a kernel
    fault is, and raised by the next search and by close()."""
    x = separated(1500, seed=8)
    _, tstore, _, _ = stores(x, [{"doc_id": i} for i in range(1500)])
    tt = TieredIndex(tstore, min_rows=1000, rebuild_tail_rows=100)

    def lost(*a, **kw):
        raise MeshFault("all_reduce.ivf_stage failed: peer gone")

    monkeypatch.setattr(ttiered, "fit_cells", lost)
    tt.search(x[:1], k=3)  # starts the rebuild, served exact
    tt._rebuild_thread.join(30)
    with pytest.raises(MeshFault):
        tt.search(x[:1], k=3)
    with pytest.raises(MeshFault):
        tt.close()


def test_an_ordinary_rebuild_error_is_logged_not_raised(monkeypatch):
    x = separated(1500, seed=8)
    _, tstore, _, _ = stores(x, [{"doc_id": i} for i in range(1500)])
    tt = TieredIndex(tstore, min_rows=1000, rebuild_tail_rows=100)

    def broken(*a, **kw):
        raise ValueError("bad build")

    monkeypatch.setattr(ttiered, "IVFIndex", broken)
    tt.search(x[:1], k=3)
    tt.close()
    assert tt.search(x[:1], k=1)[0][0].row_id == 0


def test_set_nprobe_and_index_stats_equal_reference(ref_tier):
    jt, tt = make_pair(ref_tier)
    assert tt.set_nprobe(3) == jt.set_nprobe(3) == 3
    assert tt._tier[0].nprobe == jt._tier[0].nprobe == 3
    q = queries(seed=23)
    same(jt.search(q, k=5), tt.search(q, k=5))
    ts, js = tt.index_stats(), jt.index_stats()
    js["per_shard_bytes"] = ts["total_bytes"]  # one device: everything
    assert ts == js
    for t in (jt, tt):
        t.set_nprobe(1000)
    assert tt._tier[0].nprobe == jt._tier[0].nprobe == jt._tier[0].n_clusters


# ---- FusedTieredRetriever over a tiny encoder ------------------------------

# each query term is in one note only: an exact lexical tie between two
# rows would let the packages' top-k keep different representatives
NOTES = [
    f"note {i}: " + w
    for i, w in enumerate(
        ["aspirin for cardiac prevention", "metformin manages diabetes",
         "ginseng root in formulas", "persistent headache reported",
         "chest pain on exertion", "influenza vaccination given",
         "lisinopril for hypertension", "atorvastatin at bedtime",
         "warfarin with INR checks", "insulin sliding scale",
         "albuterol as needed", "prednisone taper planned"]
    )
] + [f"follow-up visit {i} booked at clinic {i % 5}" for i in range(36)]
QUERIES = ["diabetes medication metformin", "heart symptoms chest pain",
           "INR warfarin", "atorvastatin at bedtime"]


@pytest.fixture(scope="module")
def fused_pair():
    """Both packages' stores over the notes (the reference encoder's
    vectors), a lexical tier each, tiered indexes over 3 cells, the port's
    carried across, and the two fused retrievers."""
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    emb = jenc.encode_texts(NOTES)
    meta = [{"doc_id": f"d{i}", "source": t, "text_content": t, "patient_id": f"P{i % 3}"}
            for i, t in enumerate(NOTES)]
    jstore, tstore, jlex, tlex = stores(emb, meta, lexical=True)
    kw = dict(min_rows=4, n_clusters=3, nprobe=2, rebuild_tail_rows=10**6,
              hybrid_alpha=ALPHA)
    jt = JTieredIndex(jstore, lexical=jlex, **kw)
    tt = TieredIndex(tstore, lexical=tlex, **kw)
    assert jt.rebuild()
    carry(jt, tt)
    return jenc, jt, tt, JFusedTieredRetriever(jenc, jt), FusedTieredRetriever(
        tenc, tt, device="cpu")


def hybrid_tols(jt, jenc, k):
    dense = jt.search(np.asarray(jenc.encode_texts(QUERIES)), k=k, mode="dense",
                      query_texts=QUERIES)
    spreads = [max(row[0].score - row[-1].score, 1e-6) if row else 1.0 for row in dense]
    return [ALPHA * 4 * DENSE_TOL / sp + 1e-6 for sp in spreads]


@pytest.mark.parametrize("mode", ["dense", "hybrid", "lexical"])
def test_fused_tiered_equals_reference(fused_pair, mode):
    jenc, jt, tt, jr, tr = fused_pair
    for k in (3, 5):
        atol = hybrid_tols(jt, jenc, k) if mode == "hybrid" else TOL
        same(jr.search_texts(QUERIES, k=k, mode=mode), tr.search_texts(QUERIES, k=k, mode=mode),
             atol)
    # the two-step path over the port's own tier ranks alike
    if mode == "dense":
        emb = np.asarray(jenc.encode_texts(QUERIES), np.float32)
        same(tt.search(emb, k=5), tr.search_texts(QUERIES, k=5))


def test_fused_tiered_tail_and_filters_equal_reference(fused_pair):
    jenc, jt, tt, jr, tr = fused_pair
    extra = ["ibuprofen after surgery", "metformin dose raised"]
    emb = jenc.encode_texts(extra)
    md = [{"doc_id": f"x{i}", "source": t, "text_content": t, "patient_id": "P1"}
          for i, t in enumerate(extra)]
    jt.store.add(emb, md)
    tt.store.add(emb, md)
    assert tt.tail_rows == jt.tail_rows == 2
    for mode in ("dense", "hybrid"):
        atol = hybrid_tols(jt, jenc, 4) if mode == "hybrid" else TOL
        same(jr.search_texts(QUERIES, k=4, mode=mode), tr.search_texts(QUERIES, k=4, mode=mode),
             atol)
    f = {"patient_id": "P1"}
    got = tr.search_texts(QUERIES, k=4, filters=f, mode="hybrid")
    same(jr.search_texts(QUERIES, k=4, filters=f, mode="hybrid"), got)
    assert all(r.metadata["patient_id"] == "P1" for row in got for r in row)


def test_fused_tiered_before_the_tier_equals_reference():
    """Below ``min_rows`` both serve through the exact fused path, the
    hybrid fusion included."""
    jenc = JEncoderEngine(JEncoderConfig(**ENC), seed=1)
    tenc = EncoderEngine(EncoderConfig(**ENC), seed=1, device="cpu")
    emb = jenc.encode_texts(NOTES[:12])
    meta = [{"doc_id": f"d{i}", "text_content": t} for i, t in enumerate(NOTES[:12])]
    jstore, tstore, jlex, tlex = stores(emb, meta, lexical=True)
    jt = JTieredIndex(jstore, lexical=jlex, min_rows=10**6)
    tt = TieredIndex(tstore, lexical=tlex, min_rows=10**6)
    jr, tr = JFusedTieredRetriever(jenc, jt), FusedTieredRetriever(tenc, tt, device="cpu")
    for mode in ("dense", "hybrid"):
        atol = hybrid_tols(jt, jenc, 4) if mode == "hybrid" else TOL
        same(jr.search_texts(QUERIES, k=4, mode=mode), tr.search_texts(QUERIES, k=4, mode=mode),
             atol)
