"""Port parity, store rows: docqa_tpu_torch's VectorStore metadata filters,
``metadata_select``, tombstones (``delete_docs``), ``compact_deleted`` and
index sinks against docqa_tpu's VectorStore on the same seeded rows.

Both stores hold float32 rows.  Top-k ids must be equal, except that a tie
at the k-th score is not a miss; scores agree within 1e-5 (float32 sums of
the same products, in another order).  Listings, counts, versions and the
sink's calls must be equal outright.
"""

import numpy as np
import pytest
import torch

from docqa_tpu.config import StoreConfig as JStoreConfig
from docqa_tpu.index.store import VectorStore as JVectorStore
from docqa_tpu_torch.config import StoreConfig
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import KernelError
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

torch.set_num_threads(1)

DIM = 32
TOL = 1e-5
PATIENTS = ("p1", "p2", "p3", None)
TYPES = ("consult", "labs", None)
DATES = ("2024-01-05", "2024-03-17", "2023-11-30", None, "sometime")


def _rows(n=64, seed=3):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    meta = [
        {
            "doc_id": f"doc-{i // 4:02d}",
            "text_content": f"chunk {i}",
            "source": f"src-{i}",
            "patient_id": PATIENTS[int(rng.integers(len(PATIENTS)))],
            "doc_type": TYPES[int(rng.integers(len(TYPES)))],
            "doc_date": DATES[int(rng.integers(len(DATES)))],
        }
        for i in range(n)
    ]
    return vecs, meta


class _Sink:
    """Records every index-sink call in a comparable form."""

    def __init__(self):
        self.calls = []

    def on_add(self, row_ids, metadata):
        self.calls.append(("add", list(row_ids), [m["doc_id"] for m in metadata]))

    def on_delete(self, row_ids):
        self.calls.append(("delete", sorted(row_ids)))

    def on_compact(self, keep):
        self.calls.append(("compact", np.asarray(keep, bool).tolist()))


def _pair(sinks=False):
    """Both stores with the same rows, added in three batches so the port's
    device buffer grows past its first capacity."""
    jstore = JVectorStore(JStoreConfig(dim=DIM, shard_capacity=16, dtype="float32"))
    tstore = VectorStore(StoreConfig(dim=DIM, shard_capacity=16, dtype="float32"),
                         device="cpu")
    jsink = tsink = None
    if sinks:
        jsink, tsink = _Sink(), _Sink()
        jstore.register_index_sink(jsink)
        tstore.register_index_sink(tsink)
    vecs, meta = _rows()
    for lo, hi in ((0, 10), (10, 40), (40, len(vecs))):
        jstore.add(vecs[lo:hi], meta[lo:hi])
        tstore.add(vecs[lo:hi], meta[lo:hi])
    return jstore, tstore, jsink, tsink


def _queries(n=5, seed=11):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _assert_same_hits(jres, tres):
    """Per query: same length, scores within TOL, and the same ids except
    among rows tied (within TOL) at the last score."""
    assert len(jres) == len(tres)
    for jrow, trow in zip(jres, tres):
        assert len(jrow) == len(trow)
        js = np.array([h.score for h in jrow])
        ts = np.array([h.score for h in trow])
        np.testing.assert_allclose(ts, js, atol=TOL)
        if not len(jrow):
            continue
        kth = js[-1]
        jsure = {h.row_id for h in jrow if h.score > kth + TOL}
        tsure = {h.row_id for h in trow if h.score > kth + TOL}
        assert jsure == tsure
        assert [h.metadata for h in trow if h.score > kth + TOL] == [
            h.metadata for h in jrow if h.score > kth + TOL
        ]


FILTERS = [
    {},
    {"patient_id": "p1"},
    {"patient_id": "p2", "doc_type": "labs"},
    {"doc_type": "consult"},
    {"patient_id": "nobody"},
    {"date_from": "2024-01-01"},
    {"date_to": "2024-02-01", "patient_id": "p3"},
    {"date_from": "2023-12-01", "date_to": "2024-12-31"},
    {"date_from": "", "date_to": None, "patient_id": "p1"},
]


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: ",".join(f) or "none")
def test_filtered_search_equals_reference(filters):
    jstore, tstore, _, _ = _pair()
    q = _queries()
    for k in (1, 4, 64):
        _assert_same_hits(
            jstore.search(q, k=k, filters=filters or None),
            tstore.search(q, k=k, filters=filters or None),
        )


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: ",".join(f) or "none")
def test_metadata_select_equals_reference(filters):
    jstore, tstore, _, _ = _pair()
    for limit in (None, 3):
        assert tstore.metadata_select(limit=limit, **filters) == \
            jstore.metadata_select(limit=limit, **filters)


@pytest.mark.parametrize("filters", [
    {"date_from": "sometime"},
    {"date_to": "2024/13"},
    {"patient": "p1"},
])
def test_bad_filters_raise_as_the_reference(filters):
    jstore, tstore, _, _ = _pair()
    with pytest.raises(ValueError):
        jstore.metadata_select(**filters)
    with pytest.raises(ValueError):
        tstore.metadata_select(**filters)
    with pytest.raises(ValueError):
        tstore.search(_queries(1), k=3, filters=filters)


def test_delete_tombstones_like_reference():
    jstore, tstore, jsink, tsink = _pair(sinks=True)
    for ids in (["doc-03", "doc-07"], ["doc-03"], ["no-such-doc"], ["doc-15", "doc-00"]):
        assert tstore.delete_docs(ids) == jstore.delete_docs(ids)
    assert tstore.deleted_count == jstore.deleted_count == 16
    assert tstore.version == jstore.version
    assert tstore.count == jstore.count
    q = _queries()
    for filters in (None, {"patient_id": "p1"}, {"date_from": "2024-01-01"}):
        _assert_same_hits(
            jstore.search(q, k=64, filters=filters),
            tstore.search(q, k=64, filters=filters),
        )
    assert tstore.metadata_select() == jstore.metadata_select()
    assert tstore.metadata_rows() == jstore.metadata_rows()
    assert tsink.calls == jsink.calls


def test_compaction_renumbers_like_reference():
    jstore, tstore, jsink, tsink = _pair(sinks=True)
    for store in (jstore, tstore):
        store.delete_docs(["doc-01", "doc-02", "doc-09"])
    assert tstore.compact_deleted() == jstore.compact_deleted() == 12
    assert tstore.compact_deleted() == jstore.compact_deleted() == 0
    assert (tstore.count, tstore.deleted_count, tstore.version) == (
        jstore.count, jstore.deleted_count, jstore.version
    )
    assert tstore.metadata_rows() == jstore.metadata_rows()
    q = _queries()
    for filters in (None, {"patient_id": "p2"}, {"doc_type": "labs"}):
        _assert_same_hits(
            jstore.search(q, k=8, filters=filters),
            tstore.search(q, k=8, filters=filters),
        )
    # rows added after a compaction land after the survivors on both sides
    vecs, meta = _rows(6, seed=5)
    meta = [dict(m, doc_id="doc-new") for m in meta]
    assert tstore.add(vecs, meta) == jstore.add(vecs, meta)
    _assert_same_hits(jstore.search(q, k=8), tstore.search(q, k=8))
    assert tsink.calls == jsink.calls


def test_sink_registered_late_is_backfilled_with_tombstones():
    jstore, tstore, _, _ = _pair()
    for store in (jstore, tstore):
        store.delete_docs(["doc-04"])
    jsink, tsink = _Sink(), _Sink()
    jstore.register_index_sink(jsink)
    tstore.register_index_sink(tsink)
    assert tsink.calls == jsink.calls
    assert [m.get("deleted", False) for m in tstore.metadata_rows()] == [
        m.get("deleted", False) for m in jstore.metadata_rows()
    ]


def test_broken_sink_is_counted_and_a_device_fault_propagates():
    """An ordinary sink error is counted and logged and the dense add
    commits, as the reference's; a kernel or CUDA fault reaches the
    caller."""

    class Broken:
        def __init__(self, exc):
            self.exc = exc

        def on_add(self, row_ids, metadata):
            raise self.exc

    vecs, meta = _rows(4)
    store = VectorStore(StoreConfig(dim=DIM, dtype="float32"), device="cpu")
    store.register_index_sink(Broken(KeyError("bad row")))
    before = DEFAULT_REGISTRY.counter("index_sink_errors").value
    assert store.add(vecs, meta) == [0, 1, 2, 3]
    assert DEFAULT_REGISTRY.counter("index_sink_errors").value == before + 1

    store = VectorStore(StoreConfig(dim=DIM, dtype="float32"), device="cpu")
    store.register_index_sink(Broken(KernelError("launch failed")))
    with pytest.raises(KernelError):
        store.add(vecs, meta)
