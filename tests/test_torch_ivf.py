"""Port parity, the IVF tier: docqa_tpu_torch's ``index/ivf.py`` against
docqa_tpu's on the same numpy inputs, on the CPU.

* ``quantize_rows_int8`` is integer-equal (the same numpy).
* ``kmeans`` end to end on a seeded, well-separated corpus (16 directions
  in d=32, noise 0.05 a dimension): the seeds are unambiguous there, so
  assignments are identical and centroids agree within 1e-5 (float32 sums
  over the same rows in another order, then a normalize).  A corpus where
  two rows tie for the farthest point to within a float32 ulp could seed
  differently; that is what the carried-across tier below is for.
* ``IVFIndex`` builds on that corpus give identical cells, ids and spill.
* A tier carried across from the reference's arrays (``ivf_from_arrays``)
  probes to the same ids under the tie rule (a row tied with the k-th
  score is not a miss) at nprobe 1, 4 and every cell, scores within 1e-5
  (int8 or bf16 products are exact in float32; only the order of the
  float32 sums differs).  A full probe equals exact search.
"""

import numpy as np
import pytest
import torch

from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.index import ivf as jivf
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu_torch.config import StoreConfig
from docqa_tpu_torch.index import ivf as tivf
from docqa_tpu_torch.index.store import VectorStore

torch.set_num_threads(1)

D = 32
CENT_TOL = 1e-5
SCORE_TOL = 1e-5


def separated(n=4000, n_centers=16, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n_centers, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, n_centers, n)] + noise * rng.standard_normal((n, D)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def clustered(n, seed=0, n_centers=120, noise=0.35):
    """The reference tests' mixture-of-directions recipe at d=32."""
    rng = np.random.default_rng(seed)
    c = np.random.default_rng(12345).normal(size=(n_centers, D))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, D))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def ref_arrays(jx):
    """The reference IVFIndex's device arrays as numpy."""
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


def same_topk(jrows, trows, tol=SCORE_TOL):
    """Per query: the same length, scores within ``tol``, and the same ids
    among rows scoring clear of the last row's score (a tie at the k-th
    score is not a miss)."""
    assert len(jrows) == len(trows)
    for jrow, trow in zip(jrows, trows):
        assert len(jrow) == len(trow)
        js = np.array([r[0] for r in jrow])
        ts = np.array([r[0] for r in trow])
        np.testing.assert_allclose(ts, js, atol=tol, rtol=0)
        if jrow:
            cut = js[-1] + 2 * tol
            assert {r[1] for r in jrow if r[0] > cut} == {r[1] for r in trow if r[0] > cut}


@pytest.mark.parametrize("shape", [(5, 32), (3, 7, 16), (4, 8)])
def test_quantize_rows_int8_integer_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # a zero row: scale 0, exact
    q, s = tivf.quantize_rows_int8(x)
    jq, js = jivf.quantize_rows_int8(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("n_assign, sample", [(1, None), (2, None), (4, 1500)])
def test_kmeans_equals_reference_on_a_separated_corpus(n_assign, sample):
    """``sample`` below the row count draws the fit subsample from the same
    RNG stream first, as the reference does."""
    x = separated()
    jc, ja = jivf.kmeans(x, 16, n_iters=5, seed=3, sample=sample, n_assign=n_assign)
    timings = {}
    tc, ta = tivf.kmeans(x, 16, n_iters=5, seed=3, sample=sample, n_assign=n_assign,
                         device="cpu", timings=timings)
    assert tc.dtype == np.float32 and ta.dtype == np.int32
    np.testing.assert_allclose(tc, jc, atol=CENT_TOL, rtol=0)
    np.testing.assert_array_equal(ta[:, 0], ja[:, 0])
    # the lower-ranked choices may swap only between cells tied for a row
    assert (ta == ja).mean() > 0.999
    assert set(timings) == {"seeding", "lloyd", "assignment"}


def test_kcenter_seeds_like_the_reference():
    x = separated(n=3000, seed=5)
    want = np.asarray(jivf._kcenter_init(x, 16))
    got = tivf._kcenter_init(torch.from_numpy(x), 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("storage", ["int8", "float"])
def test_build_equals_reference(storage):
    x = separated(seed=1)
    meta = [{"row": i} for i in range(len(x))]
    jx = jivf.IVFIndex(x, meta, n_clusters=16, nprobe=4, seed=2, dtype="bfloat16",
                       storage=storage, cap_factor=0.3)
    tx = tivf.IVFIndex(x, meta, n_clusters=16, nprobe=4, seed=2, dtype="bfloat16",
                       storage=storage, cap_factor=0.3, device="cpu")
    ref = ref_arrays(jx)
    assert (tx.cap, tx.n_spilled, tx.n_assign) == (jx.cap, jx.n_spilled, jx.n_assign)
    assert tx.n_spilled > 0  # the cap is small enough to spill
    np.testing.assert_array_equal(tx._cell_ids.numpy(), ref["cell_ids"])
    np.testing.assert_array_equal(tx._spill_ids.numpy(), ref["spill_ids"])
    np.testing.assert_array_equal(tx._cells.float().numpy(), ref["cells"].astype(np.float32))
    if storage == "int8":
        np.testing.assert_array_equal(tx._cell_scale.numpy(), ref["cell_scale"])
    np.testing.assert_array_equal(tx._spill.float().numpy(), ref["spill"])
    np.testing.assert_allclose(tx._centroids.float().numpy(), ref["centroids"],
                               atol=2 ** -8, rtol=0)  # one bf16 rounding apart
    assert tx.index_bytes() == jx.index_bytes() | {"per_shard_bytes": tx.index_bytes()["total_bytes"]}
    assert set(tx.build_seconds) == {"seeding", "lloyd", "assignment", "placement",
                                     "quantize", "upload", "total"}


@pytest.fixture(scope="module")
def carried():
    """A reference tier over a clustered corpus with spilled rows, and the
    port's tier carried across from its arrays, for each storage."""
    x = clustered(6000, seed=2)
    meta = [{"row": i} for i in range(len(x))]
    out = {}
    for storage in ("int8", "float"):
        jx = jivf.IVFIndex(x, meta, n_clusters=24, nprobe=4, seed=0, storage=storage,
                           cap_factor=0.4)
        tx = tivf.ivf_from_arrays(ref_arrays(jx), meta, nprobe=4, device="cpu")
        out[storage] = (jx, tx)
    return x, meta, out


@pytest.mark.parametrize("storage", ["int8", "float"])
@pytest.mark.parametrize("nprobe", [1, 4, 24])
def test_carried_tier_probes_like_the_reference(carried, storage, nprobe):
    x, _meta, tiers = carried
    jx, tx = tiers[storage]
    assert tx.storage == storage and jx.n_spilled > 0
    q = clustered(12, seed=9)
    for k, dedup_full in ((5, False), (10, True)):
        same_topk(jx.search(q, k=k, nprobe=nprobe, dedup_full=dedup_full),
                  tx.search(q, k=k, nprobe=nprobe, dedup_full=dedup_full))


def test_full_probe_equals_exact_search(carried):
    """Every cell probed (float cells in the store's dtype) is exact search
    over the same rows, so it matches the port's exact store."""
    x, meta, tiers = carried
    _jx, tx = tiers["float"]
    store = VectorStore(StoreConfig(dim=D, dtype="bfloat16"), device="cpu")
    store.add(x, meta)
    q = clustered(8, seed=4)
    exact = [[(r.score, r.row_id) for r in row] for row in store.search(q, k=10)]
    probed = [[(s, rid) for s, rid, _m in row] for row in tx.search(q, k=10, nprobe=24)]
    same_topk(exact, probed)


def test_overfetch_clamped_to_the_probed_pool(carried):
    """k beyond the probed pool returns the whole pool, deduped, on both
    sides (a top-k past it would fail)."""
    _x, _meta, tiers = carried
    jx, tx = tiers["int8"]
    q = clustered(2, seed=11)
    k = 5 * jx.cap
    j = jx.search(q, k=k, nprobe=1)
    t = tx.search(q, k=k, nprobe=1)
    assert [len(r) for r in t] == [len(r) for r in j]
    for jrow, trow in zip(j, t):
        assert {r[1] for r in jrow} == {r[1] for r in trow}


def test_timed_probe_fresh_rule_equals_reference(carried):
    """``fresh`` is True exactly at the first call of a (batch, fetch,
    nprobe) shape, search() included, as the reference's compile rule."""
    _x, _meta, tiers = carried
    jx, tx = tiers["int8"]
    q1, q3 = clustered(1, seed=21), clustered(3, seed=22)
    calls = [("probe", q1, 3), ("probe", q1, 3), ("search", q3, 2), ("probe", q3, 2),
             ("probe", q3, 5), ("probe", q1, 5)]
    for kind, q, nprobe in calls:
        if kind == "search":
            same_topk(jx.search(q, k=4, nprobe=nprobe), tx.search(q, k=4, nprobe=nprobe))
            continue
        jrows, _js, jfresh = jx.timed_probe(q, k=4, nprobe=nprobe, dedup_full=True)
        trows, seconds, tfresh = tx.timed_probe(q, k=4, nprobe=nprobe, dedup_full=True)
        assert tfresh == jfresh and seconds >= 0.0
        same_topk([[(s, r) for r, s in row] for row in jrows],
                  [[(s, r) for r, s in row] for row in trows])


def test_from_store_reads_the_port_store():
    x = separated(n=2000, seed=7)
    meta = [{"doc_id": f"d{i}"} for i in range(len(x))]
    store = VectorStore(StoreConfig(dim=D, dtype="float32"), device="cpu")
    store.add(x, meta)
    jstore = JVectorStore(JStoreConfig(dim=D, dtype="float32"))
    jstore.add(x, meta)
    tx = tivf.IVFIndex.from_store(store, n_clusters=16, nprobe=16, seed=0)
    jx = jivf.IVFIndex.from_store(jstore, n_clusters=16, nprobe=16, seed=0)
    assert tx.device == store.device and tx.n == jx.n == len(x)
    q = x[:6]
    got = tx.search(q, k=3)
    same_topk(jx.search(q, k=3), got)
    assert [row[0][1] for row in got] == list(range(6))
    assert got[2][0][2] == {"doc_id": "d2"}


def test_arrays_round_trip(carried):
    """``IVFIndex.arrays()`` carries a port tier to another device (the card
    tests and the chip smoke carry the CPU's tier to the card this way)."""
    _x, meta, tiers = carried
    for storage in ("int8", "float"):
        _jx, tx = tiers[storage]
        again = tivf.ivf_from_arrays(tx.arrays(), meta, nprobe=4, device="cpu")
        for name in ("_cells", "_cell_ids", "_centroids", "_spill", "_spill_ids"):
            assert torch.equal(getattr(again, name), getattr(tx, name)), name
        q = clustered(5, seed=13)
        assert [[r[1] for r in row] for row in again.search(q, k=6)] == [
            [r[1] for r in row] for row in tx.search(q, k=6)]
