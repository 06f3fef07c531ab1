"""Port parity, the retrieval observatory: docqa_tpu_torch's
``obs/retrieval_observatory.py`` against docqa_tpu's, and the port's tiered
shadow hooks against the reference's on identical tiers, on the CPU.

The estimator is stdlib arithmetic on the same inputs, so Wilson bounds,
comparisons, samples, estimates, the frontier, recommendations and the
``status()`` payload must be equal outright (the drift section's digests
read each package's own registry, so only its key tree is compared).
The shadow hooks feed estimates from each package's served rows and its
exact shadow; on a carried-across tier both give the same hits.

Both packages keep a process-wide observatory; every test that installs
one restores both (``_hooks``).
"""

import numpy as np
import pytest
import torch

from docqa_tpu import obs as jobs
from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu.index.tiered import TieredIndex as JTieredIndex
from docqa_tpu.obs import retrieval_observatory as jro
from docqa_tpu.runtime.metrics import DEFAULT_REGISTRY as J_REGISTRY
from docqa_tpu_torch import obs
from docqa_tpu_torch.config import EncoderConfig, StoreConfig
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
from docqa_tpu_torch.engines.spine import get_spine
from docqa_tpu_torch.index import ivf as tivf
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.index.tiered import TieredIndex
from docqa_tpu_torch.obs import retrieval_observatory as tro
from docqa_tpu_torch.ops._kernels import KernelError, MeshFault
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

torch.set_num_threads(1)

D = 32


@pytest.fixture(autouse=True)
def _hooks():
    prev = (obs.set_retrieval_observatory(None), jobs.set_retrieval_observatory(None))
    yield
    obs.set_retrieval_observatory(prev[0])
    jobs.set_retrieval_observatory(prev[1])


def _counter(name):
    return DEFAULT_REGISTRY.counter(name).value


@pytest.mark.parametrize("hits, total", [
    (0, 0), (0, 5), (5, 5), (1, 2), (95, 100), (380, 400), (1, 1000), (999, 1000),
])
def test_wilson_interval_equals_reference(hits, total):
    assert tro.wilson_interval(hits, total) == jro.wilson_interval(hits, total)
    assert tro.wilson_interval(hits, total, z=2.58) == jro.wilson_interval(hits, total, z=2.58)


@pytest.mark.parametrize("served, shadow, k", [
    ([(1, 0.9), (2, 0.8)], [(1, 0.9), (2, 0.8)], 2),
    ([(1, 0.9), (9, 0.1)], [(1, 0.9), (2, 0.8)], 2),
    ([(1, 0.9), (7, 0.8)], [(1, 0.9), (2, 0.8)], 2),  # a tie at the k-th score
    ([(1, 0.9), (3, 0.5)], [(1, 0.9)], 5),
    ([(1, 0.9)], [], 3),
    ([(4, 0.7), (5, 0.69999995)], [(1, 0.9), (4, 0.7)], 2),
])
def test_compare_topk_equals_reference(served, shadow, k):
    assert tro.compare_topk(served, shadow, k) == jro.compare_topk(served, shadow, k)


@pytest.mark.parametrize("sample_every, seed", [(1, 0), (3, 0), (7, 5), (32, 0), (32, 11)])
def test_sampler_equals_reference(sample_every, seed):
    """The same deterministic slots, exactly one in each window, and
    nothing sampled while the worker is not running."""
    t = tro.RetrievalObservatory(sample_every=sample_every, seed=seed)
    j = jro.RetrievalObservatory(sample_every=sample_every, seed=seed)
    got = [t._sampled(i) for i in range(8 * sample_every)]
    assert got == [j._sampled(i) for i in range(8 * sample_every)]
    assert sum(got) == 8
    assert not any(t.sample() for _ in range(sample_every))


def _job(mod, **kw):
    return mod.ShadowJob(**kw)


def _synthetic_jobs(mod):
    """The reference tests' synthetic jobs: window math, per-query
    comparisons, a frontier whose neighbour meets the target, a rebuilt
    tier, and compile samples kept off the latency axis."""
    truth = [[(1, 0.9), (2, 0.8)]]
    lats = iter([5000.0, 0.001, 7000.0, 0.002])
    fresh = iter([True, False, True, False])
    return [
        _job(mod, tier="t", nprobe=4, k=2, served=[[(1, 0.9), (9, 0.1)]],
             shadow_fn=lambda: ([[(1, 0.9), (2, 0.8)]], None)),
        _job(mod, tier="t", nprobe=4, k=2, served=[[(1, 0.9)], [(2, 0.8)], [(9, 0.1)]],
             shadow_fn=lambda: ([[(1, 0.9)], [(2, 0.8)], [(3, 0.7)]], None)),
        _job(mod, tier="tiered", nprobe=2, k=2, served=[[(1, 0.9), (7, 0.1)]],
             shadow_fn=lambda: (truth, "qn"),
             frontier_fn=lambda _qn, p: (truth if p >= 4 else [[(1, 0.9), (7, 0.1)]], 0.001),
             covered=100, n_clusters=64),
        _job(mod, tier="tiered", nprobe=2, k=2, served=[truth[0]],
             shadow_fn=lambda: (truth, "qn"),
             frontier_fn=lambda _qn, p: (truth, next(lats), next(fresh)),
             covered=100, n_clusters=64),
        _job(mod, tier="tiered", nprobe=2, k=2, served=[truth[0]],
             shadow_fn=lambda: (truth, "qn"),
             frontier_fn=lambda _qn, p: ([[(7, 0.1), (8, 0.1)]], 0.001),
             covered=500, n_clusters=256),
    ]


@pytest.mark.parametrize("auto_apply", [False, True])
@pytest.mark.parametrize("upto", [1, 2, 3, 4, 5])
def test_estimates_frontier_and_status_equal_reference(auto_apply, upto):
    applied = {"t": [], "j": []}
    kw = dict(sample_every=1, frontier_every=1, min_frontier_n=1, recall_target=0.9,
              frontier_factors=(0.5, 1.0, 2.0), auto_apply=auto_apply)
    t = tro.RetrievalObservatory(apply_nprobe=applied["t"].append, **kw)
    j = jro.RetrievalObservatory(apply_nprobe=applied["j"].append, **kw)
    for tj, jj in list(zip(_synthetic_jobs(tro), _synthetic_jobs(jro)))[:upto]:
        t._process(tj)
        j._process(jj)
    assert t.status() == j.status()
    assert t.telemetry_gauges() == j.telemetry_gauges()
    assert t.recommended_nprobe() == j.recommended_nprobe()
    assert applied["t"] == applied["j"]
    assert {p: list(e["lat_ms"]) for p, e in t._frontier.items()} == {
        p: list(e["lat_ms"]) for p, e in j._frontier.items()}


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if tree is not None else None


def test_status_key_tree_equals_reference_with_the_drift_section():
    """The drift section names the retrieval histograms with samples in
    each package's registry: record one sample in each, in both, and the
    whole payload's key tree (drift included) is the reference's."""
    names = ("retrieve_score_margin", "retrieve_query_norm", "retrieve_tier_ms_bulk_ivf",
             "retrieve_tier_ms_tail_exact", "retrieve_tier_ms_merge",
             "retrieve_tier_ms_fused_probe")
    for reg in (DEFAULT_REGISTRY, J_REGISTRY):
        for name in names:
            reg.histogram(name).observe(1.0)
    t = tro.RetrievalObservatory(registry=DEFAULT_REGISTRY)
    j = jro.RetrievalObservatory(registry=J_REGISTRY)
    for mod, robs in ((tro, t), (jro, j)):
        robs._process(_synthetic_jobs(mod)[0])
    ts, js = t.status(), j.status()
    assert set(ts["drift"]) == set(js["drift"]) == set(names)
    assert _keys(ts) == _keys(js)


class TestShadowJobsOnACarriedTier:
    """The port's tiered hooks against the reference's on one tier (its
    arrays carried across): the same served rows, the same shadows, so
    the same estimates and the same measured frontier recall."""

    @pytest.fixture(scope="class")
    def pair(self):
        rng = np.random.default_rng(0)
        v = rng.standard_normal((600, D)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        meta = [{"doc_id": f"d{i}"} for i in range(len(v))]
        jstore = JVectorStore(JStoreConfig(dim=D, dtype="float32", shard_capacity=1024))
        tstore = VectorStore(StoreConfig(dim=D, dtype="float32", shard_capacity=1024),
                             device="cpu")
        jstore.add(v, meta)
        tstore.add(v, meta)
        jt = JTieredIndex(jstore, nprobe=1, min_rows=100, rebuild_tail_rows=100_000)
        tt = TieredIndex(tstore, nprobe=1, min_rows=100, rebuild_tail_rows=100_000)
        assert jt.rebuild()
        jx = jt._tier[0]
        tx = tivf.ivf_from_arrays({
            "centroids": np.asarray(jx._centroids).astype(np.float32),
            "cells": np.asarray(jx._cells), "cell_scale": np.asarray(jx._cell_scale),
            "cell_ids": np.asarray(jx._cell_ids),
            "spill": np.asarray(jx._spill).astype(np.float32),
            "spill_ids": np.asarray(jx._spill_ids), "n_assign": jx.n_assign,
        }, jx._meta, nprobe=1, dtype="float32", device="cpu")
        tx._store_compactions = tstore.compactions
        tt._tier = (tx, jt._tier[1])
        q = v[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32)
        return jt, tt, q

    def _observe(self, tiered, mod, q, **kw):
        robs = mod.RetrievalObservatory(sample_every=1, seed=0, frontier_every=1,
                                        min_frontier_n=1, **kw).start()
        hook = obs if mod is tro else jobs
        hook.set_retrieval_observatory(robs)
        try:
            for _ in range(6):
                tiered.search(q, k=5)
            assert robs.drain(30)
        finally:
            hook.set_retrieval_observatory(None)
            robs.stop()
        return robs.status()

    def test_degraded_nprobe_measured_like_the_reference(self, pair):
        jt, tt, q = pair
        expected0 = _counter("retrieve_shadow_expected")
        ts = self._observe(tt, tro, q, registry=DEFAULT_REGISTRY)
        js = self._observe(jt, jro, q)
        assert ts["estimates"] == js["estimates"]
        assert ts["current"] == js["current"] == {"tier": "tiered", "nprobe": 1}
        assert ts["estimate"]["recall"] < 0.95 and ts["estimate"]["ci_hi"] < 0.95
        strip = [{k: v for k, v in row.items() if k != "probe_ms_p50"} for row in ts["frontier"]]
        assert strip == [{k: v for k, v in row.items() if k != "probe_ms_p50"}
                         for row in js["frontier"]]
        assert len(strip) >= 2
        assert _counter("retrieve_shadow_expected") > expected0
        # first calls at a shape stay off the latency axis, the rest land
        assert all(row["probe_ms_p50"] is not None for row in ts["frontier"])

    def test_auto_apply_sets_the_tier_nprobe(self, pair):
        _jt, tt, q = pair
        try:
            # recall at nprobe 1 is 0.65 here, at 2 0.75 (the test above)
            st = self._observe(tt, tro, q, recall_target=0.7, auto_apply=True,
                               apply_nprobe=tt.set_nprobe)
            assert st["applied_nprobe"] == tt.nprobe == tt._tier[0].nprobe == 2
        finally:
            tt.set_nprobe(1)

    def test_zero_shadow_work_while_disabled(self, pair):
        _jt, tt, q = pair

        def shadow_items():
            row = get_spine().stats()["stages"].get("retrieve_shadow")
            return row["count"] if row else 0

        items0, total0 = shadow_items(), _counter("retrieve_shadow_total")
        served0 = _counter("retrieve_served_total")
        tt.search(q, k=5)  # no observatory installed
        robs = tro.RetrievalObservatory(sample_every=1, registry=DEFAULT_REGISTRY)
        obs.set_retrieval_observatory(robs)  # installed, never started
        tt.search(q, k=5)
        assert shadow_items() == items0
        assert _counter("retrieve_shadow_total") == total0
        assert _counter("retrieve_served_total") == served0 + 1


def _kernel_fault(*_a):
    raise KernelError("shadow kernel failed to launch")


@pytest.mark.parametrize("where", ["shadow", "frontier"])
def test_device_fault_in_a_shadow_job_stops_the_worker(where):
    """The reference counts every failing shadow as an error and carries on;
    a kernel or CUDA fault stops the port's worker and is raised by drain()
    and stop()."""
    robs = tro.RetrievalObservatory(sample_every=1, frontier_every=1,
                                    registry=DEFAULT_REGISTRY).start()
    truth = [[(1, 0.9)]]
    job = tro.ShadowJob(
        tier="tiered", nprobe=2, k=1, served=truth,
        shadow_fn=_kernel_fault if where == "shadow" else (lambda: (truth, "qn")),
        frontier_fn=_kernel_fault if where == "frontier" else None,
        covered=10, n_clusters=4,
    )
    errors0 = _counter("retrieve_shadow_errors")
    assert robs.submit(job)
    with pytest.raises(KernelError):
        robs.drain(30)
    assert not robs.running and not robs.sample()
    with pytest.raises(KernelError):
        robs.stop()
    assert _counter("retrieve_shadow_errors") == errors0


def test_a_mesh_fault_in_a_shadow_job_stops_the_worker():
    """On a mesh the shadow's exact scan is a command: a lost rank there
    (``MeshFault``) stops the worker as a kernel fault does."""
    robs = tro.RetrievalObservatory(sample_every=1, registry=DEFAULT_REGISTRY).start()

    def lost():
        raise MeshFault("publish store.shadow_search failed: peer gone")

    assert robs.submit(tro.ShadowJob(tier="tiered_fused", nprobe=2, k=1,
                                     served=[[(1, 0.9)]], shadow_fn=lost))
    with pytest.raises(MeshFault):
        robs.drain(30)
    assert not robs.running
    with pytest.raises(MeshFault):
        robs.stop()


def test_an_ordinary_shadow_error_is_counted_and_the_worker_goes_on():
    robs = tro.RetrievalObservatory(sample_every=1, registry=DEFAULT_REGISTRY).start()
    errors0 = _counter("retrieve_shadow_errors")

    def broken():
        raise ValueError("bad shadow")

    try:
        robs.submit(tro.ShadowJob(tier="t", nprobe=1, k=1, served=[[]], shadow_fn=broken))
        robs.submit(tro.ShadowJob(tier="t", nprobe=1, k=1, served=[[(1, 1.0)]],
                                  shadow_fn=lambda: ([[(1, 1.0)]], None)))
        assert robs.drain(30)
        assert robs.running and robs.status()["counts"]["errors"] == 1
        assert robs.status()["counts"]["shadows"] == 1
        assert _counter("retrieve_shadow_errors") == errors0 + 1
    finally:
        robs.stop()


def _strings_reachable(job, depth_max=8):
    """Every string reachable from a job: fields, containers, closure cells,
    defaults, ``__dict__`` and ``__slots__``; a slot that cannot be read is
    skipped, and tensors and arrays hold no text."""
    strings, seen = [], set()

    def walk(o, depth=0):
        if depth > depth_max or id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, str):
            strings.append(o)
            return
        if isinstance(o, (bytes, np.ndarray, torch.Tensor, int, float, bool, type)):
            return
        if isinstance(o, dict):
            for k, v in o.items():
                walk(k, depth + 1)
                walk(v, depth + 1)
            return
        if isinstance(o, (list, tuple, set, frozenset)):
            for v in o:
                walk(v, depth + 1)
            return
        if callable(o):
            for cell in getattr(o, "__closure__", None) or ():
                walk(cell.cell_contents, depth + 1)
            walk(getattr(o, "__defaults__", None), depth + 1)
            walk(getattr(o, "__self__", None), depth + 1)
            return
        for name in getattr(type(o), "__slots__", ()) or ():
            try:
                value = getattr(o, name)
            except (AttributeError, TypeError):
                continue  # an unreadable slot holds nothing to walk
            walk(value, depth + 1)
        d = getattr(o, "__dict__", None)
        if d:
            walk(d, depth + 1)

    walk(job)
    return strings


def test_queued_shadow_job_holds_no_raw_text():
    """The fused path's queued job holds the served query embeddings and a
    salted hash of them, never the query's text."""
    enc = EncoderEngine(EncoderConfig(vocab_size=512, hidden_dim=32, num_layers=1,
                                      num_heads=2, mlp_dim=64, max_seq_len=64,
                                      embed_dim=32, dtype="float32"), device="cpu")
    texts = [f"note {i}: drug-{i % 13} for condition-{i % 7}" for i in range(300)]
    store = VectorStore(StoreConfig(dim=32, shard_capacity=512), device="cpu")
    store.add(enc.encode_texts(texts),
              [{"doc_id": f"d{i}", "source": t, "text_content": t} for i, t in enumerate(texts)])
    tiered = TieredIndex(store, nprobe=1, min_rows=100, rebuild_tail_rows=100_000)
    assert tiered.rebuild()
    retr = FusedTieredRetriever(enc, tiered, device="cpu")

    class Capture(tro.RetrievalObservatory):
        def __init__(self):
            super().__init__(sample_every=1)
            self.jobs = []

        @property
        def running(self):  # sample() samples only while a worker runs
            return True

        def submit(self, job):
            self.jobs.append(job)
            return True

    cap = Capture()
    obs.set_retrieval_observatory(cap)
    query = "drug-3 for condition-3 PHI-SENTINEL-TEXT"
    retr.search_texts([query], k=5)
    obs.set_retrieval_observatory(None)
    assert cap.jobs and cap.jobs[0].tier == "tiered_fused"
    job = cap.jobs[0]
    leaked = [s for s in _strings_reachable(job) if "PHI-SENTINEL" in s or query in s]
    assert not leaked, leaked
    assert job.attrs.get("query_hashes")
    assert all("PHI-SENTINEL" not in h for h in job.attrs["query_hashes"])
    # and the estimate it feeds is a real comparison
    shadow, q = job.shadow_fn()
    assert q.shape == (1, 32) and tro.compare_topk(job.served[0], shadow[0], 5)[1] == 5
