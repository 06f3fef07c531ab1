"""Device-resident exact vector store, counterpart of
``docqa_tpu/index/store.py``'s ``VectorStore`` on one device.

A float32 host master copy plus one [capacity, dim] device buffer in
``StoreConfig.dtype`` (bf16 by default) that doubles when it fills.
Vectors are L2-normalized on add, so a dot product is the cosine.

Metadata filters are columnar, as in the reference: ``patient_id``,
``doc_type`` and ``doc_id`` are interned to int codes and ``doc_date`` to a
sortable int, so a filtered search builds its row mask with vectorized
compares.  Deleted rows are tombstoned (masked out of every search and
listing) until :meth:`VectorStore.compact_deleted` erases them and
renumbers the rows.  Secondary indexes (the lexical tier) register as index
sinks and are told of every add, delete and compaction inside the same
locked mutation.

The token sidecar (``StoreConfig.token_width`` > 0) keeps each row's chunk
as generator token ids (``[capacity, W]`` int32) and their true lengths
(``[capacity]``), a host master copy and a device copy that stay row-aligned
with the vectors through growth, tombstones and compaction: the device-side
prompt source of the fused RAG path (``engines/rag_fused.py``).

:meth:`VectorStore.snapshot` publishes the host copies atomically under a
directory (the vectors as a DNS1 shard through ``runtime/native.py``, the
metadata as JSON, the sidecar as ``.npy``, a manifest, then ``LATEST``);
:meth:`VectorStore.restore` reads them back through :meth:`add`, so the
index sinks see restored rows as any others.  Both directions read the
reference's snapshot layout.

On a mesh (``mesh=``, ``runtime/mesh.py``) the rows are sharded over the
model axis, as the reference's ``row_sharded`` buffer: the capacity is a
multiple of ``128 * n_model`` and model rank ``m`` holds the contiguous
block of rows ``[m * capacity / n, (m + 1) * capacity / n)`` of the vectors
and of the token sidecar (one placement rule for both).  Every rank keeps
the host master copy, and a growth or a compaction re-places the blocks
from it.  A search scores the local block, masks dead, tombstoned and
filtered rows (the mask sliced at the block's offset) and merges the
shards' top-k exactly (``ops/topk.py``: two gathers a search); every rank
gets the whole result.  :meth:`VectorStore.search_view` then returns the
local block.

Device writes are dispatch-spine work items (``store_add``), the host-query
search (:meth:`VectorStore.search`) a ``store_search`` item; the text-query
search is the fused retriever's ``retrieve`` item.

Registered with a mesh's command stream (``runtime/mesh.py``), every
mutation (:meth:`~VectorStore.add`, :meth:`~VectorStore.delete_docs`,
:meth:`~VectorStore.compact_deleted`) and search is a command: the leader
publishes its rows, metadata, row ids or queries, and every follower's
store applies it to its own host copy and block, so the row ids, the
tombstones and the index sinks agree on every rank.  Snapshots are the
caller's to write once (the runtime's leader); :meth:`VectorStore.restore`
runs on every rank from the same ``LATEST``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch.config import StoreConfig
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.ops.topk import sharded_topk
from docqa_tpu_torch.runtime import native
from docqa_tpu_torch.runtime.mesh import MeshContext, mirrored
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import resolve_device, round_up, torch_dtype

log = get_logger("docqa.store")

NEG_INF = -1e30

# rows scored per float32 product in search_single: bounds the float32
# copy of the buffer to 512 MB at d=384
SCORE_CHUNK = 1 << 18

_FILTER_KEYS = ("patient_id", "doc_type", "date_from", "date_to")
_CODED = ("patient_id", "doc_type", "doc_id")


@dataclass
class SearchResult:
    score: float
    row_id: int
    metadata: Dict[str, Any]


def search_single(vectors: torch.Tensor, queries: torch.Tensor, count: int,
                  k: int, mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries`` [q, d] over rows [0, count) of
    ``vectors``.  Scores are float32 dot products of the stored-dtype
    values, as the reference's ``preferred_element_type=float32`` product
    gives; rows where ``mask`` [count] (bool) is False score ``NEG_INF``.
    Returns (vals [q, k] f32, row ids [q, k])."""
    qf = queries.float()
    scores = torch.cat(
        [
            qf @ vectors[start : min(start + SCORE_CHUNK, count)].float().T
            for start in range(0, count, SCORE_CHUNK)
        ],
        dim=1,
    )
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :], NEG_INF)
    vals, ids = torch.topk(scores, k, dim=-1)
    return vals, ids


def search_sharded(block: torch.Tensor, queries: torch.Tensor, count: int, k: int,
                   mask: Optional[torch.Tensor], offset: int, group
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded buffer: this rank's ``block`` holds
    global rows ``[offset, offset + len(block))``; rows at or past
    ``count``, and rows where ``mask`` [count] is False, score ``NEG_INF``;
    the shards' candidates merge through :func:`sharded_topk` over
    ``group``.  Returns (vals [q, k] f32, global row ids [q, k]) on every
    rank, the reference's ``_search_kernel``."""
    n_local = block.shape[0]
    qf = queries.float()
    scores = torch.cat(
        [qf @ block[start : start + SCORE_CHUNK].float().T
         for start in range(0, n_local, SCORE_CHUNK)],
        dim=1,
    )
    live = torch.zeros((n_local,), dtype=torch.bool, device=block.device)
    n_live = max(0, min(count - offset, n_local))
    if n_live:
        live[:n_live] = True if mask is None else mask[offset : offset + n_live]
    scores = scores.masked_fill(~live[None, :], NEG_INF)
    return sharded_topk(scores, offset, k, group)


def sidecar_rows(tokenizer, texts: Sequence[str], width: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Each text's generator tokens (no specials) cut to ``width``: the
    token sidecar's ``[n, width]`` int32 rows and their lengths, as ingest
    and the bootstrap write them."""
    rows = np.zeros((len(texts), width), np.int32)
    lens = np.zeros((len(texts),), np.int32)
    for i, text in enumerate(texts):
        ids = tokenizer.encode(text, add_specials=False)[:width]
        rows[i, : len(ids)] = ids
        lens[i] = len(ids)
    return rows, lens


def _date_code(value: Optional[str]) -> int:
    """ISO ``YYYY-MM-DD`` (or any prefix-ISO string) -> sortable int code;
    anything unparseable -> -1 ('no date').  The reference's."""
    if not value:
        return -1
    digits = "".join(c for c in str(value)[:10] if c.isdigit())
    if len(digits) < 8:
        return -1
    return int(digits[:8])


def _normalized(queries: np.ndarray) -> np.ndarray:
    queries = np.asarray(queries, np.float32)
    if queries.ndim == 1:
        queries = queries[None]
    return queries / np.maximum(
        np.linalg.norm(queries, axis=1, keepdims=True), 1e-9
    )


class VectorStore:
    """Append, exact search, filters and tombstones over device vectors
    with host metadata."""

    def __init__(self, cfg: StoreConfig, device="cuda",
                 mesh: Optional[MeshContext] = None):
        """``mesh``: shard the rows over its model axis on the mesh's
        device (module docstring)."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self._n_shards = mesh.n_model if mesh is not None else 1
        self._shard = mesh.model_index if mesh is not None else 0
        self.cfg = cfg
        self._lock = threading.RLock()
        self._meta: List[Dict[str, Any]] = []
        self._host = np.zeros((0, cfg.dim), np.float32)  # durable master copy
        self._count = 0
        self._version = 0
        self._n_compactions = 0
        self._dtype = torch_dtype(cfg.dtype)
        self._capacity = self._round_capacity(cfg.shard_capacity)
        self._dev = torch.zeros(
            (self._capacity // self._n_shards, cfg.dim), dtype=self._dtype,
            device=self.device,
        )
        self._reset_columns()
        # secondary indexes kept row-aligned with this store (on_add /
        # on_delete / on_compact), told inside the mutation's lock
        self._index_sinks: List[Any] = []
        W = cfg.token_width
        if W:
            self._tok_host = np.zeros((0, W), np.int32)
            self._tok_len_host = np.zeros((0,), np.int32)
            self._tok_dev = torch.zeros(
                (self._capacity // self._n_shards, W), dtype=torch.int32,
                device=self.device,
            )
            self._tok_len_dev = torch.zeros(
                (self._capacity // self._n_shards,), dtype=torch.int32,
                device=self.device,
            )

    def _round_capacity(self, n: int) -> int:
        """Round up to a multiple of ``128 * n_shards`` (equal shards)."""
        quantum = 128 * self._n_shards
        return max(quantum, round_up(n, quantum))

    def _block_rows(self) -> Tuple[int, int]:
        """The global rows [lo, hi) of this rank's block at the current
        capacity (every row without a mesh)."""
        per = self._capacity // self._n_shards
        return self._shard * per, (self._shard + 1) * per

    def _place_rows(self, count: int) -> None:
        """Rebuild this rank's device blocks of the vectors and the token
        sidecar at the current capacity from the host master copy's rows
        [0, count): the one placement rule for both."""
        lo, hi = self._block_rows()
        top = min(hi, count)
        buf = torch.zeros((hi - lo, self.cfg.dim), dtype=self._dtype, device=self.device)
        if top > lo:
            buf[: top - lo] = torch.from_numpy(self._host[lo:top]).to(
                device=self.device, dtype=self._dtype
            )
        self._dev = buf
        if self.cfg.token_width:
            tok = torch.zeros((hi - lo, self.cfg.token_width), dtype=torch.int32,
                              device=self.device)
            tok_len = torch.zeros((hi - lo,), dtype=torch.int32, device=self.device)
            if top > lo:
                tok[: top - lo] = torch.from_numpy(self._tok_host[lo:top]).to(self.device)
                tok_len[: top - lo] = torch.from_numpy(self._tok_len_host[lo:top]).to(
                    self.device
                )
            self._tok_dev, self._tok_len_dev = tok, tok_len

    def search_rows(self, buf: torch.Tensor, q: torch.Tensor, count: int, k: int,
                    mask: Optional[torch.Tensor]):
        """Exact top-k over ``buf`` (this rank's block on a mesh):
        :func:`search_single`, or :func:`search_sharded` over the model
        group."""
        if self._n_shards == 1:
            return search_single(buf, q, count, k, mask)
        lo = self._shard * buf.shape[0]
        return search_sharded(buf, q, count, k, mask, lo, self.mesh.model_group)

    def _reset_columns(self) -> None:
        # columnar metadata: code -1 == absent, one code space per column
        self._codes: Dict[str, Dict[str, int]] = {c: {} for c in _CODED}
        self._cols: Dict[str, np.ndarray] = {
            c: np.zeros((0,), np.int32) for c in _CODED + ("doc_date",)
        }
        self._deleted = np.zeros((0,), bool)
        self._n_deleted = 0

    def _intern(self, column: str, value: Optional[str]) -> int:
        if value is None:
            return -1
        table = self._codes[column]
        return table.setdefault(value, len(table))

    def _append_columns(self, start: int, metadata: Sequence[Dict[str, Any]]) -> None:
        n = len(metadata)
        for name, col in self._cols.items():
            if col.shape[0] < start + n:
                grown = np.full(
                    (max(start + n, 2 * max(1, col.shape[0])),), -1, np.int32
                )
                grown[: col.shape[0]] = col
                self._cols[name] = grown
        if self._deleted.shape[0] < start + n:
            grown_d = np.zeros(
                (max(start + n, 2 * max(1, self._deleted.shape[0])),), bool
            )
            grown_d[: self._deleted.shape[0]] = self._deleted
            self._deleted = grown_d
        for i, md in enumerate(metadata):
            for column in _CODED:
                self._cols[column][start + i] = self._intern(
                    column, md.get(column)
                )
            self._cols["doc_date"][start + i] = _date_code(md.get("doc_date"))
            if md.get("deleted"):  # a tombstone carried in the metadata
                self._deleted[start + i] = True
                self._n_deleted += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def version(self) -> int:
        return self._version

    @property
    def deleted_count(self) -> int:
        """Tombstoned rows still in the buffer (0 after a compaction)."""
        return self._n_deleted

    @property
    def compactions(self) -> int:
        """How many times :meth:`compact_deleted` renumbered the rows.  A
        tier built over this store records it, and its exact re-rank reads
        host rows only while it is unchanged."""
        with self._lock:
            return self._n_compactions

    def register_index_sink(self, sink: Any) -> None:
        """Register a secondary index (``on_add(row_ids, metadata)``,
        ``on_delete(row_ids)``, ``on_compact(keep_mask)``).  Rows already
        committed are back-filled through ``on_add`` at once, tombstones
        included (their metadata carries ``deleted``)."""
        with self._lock:
            self._index_sinks.append(sink)
            if self._count:
                self._call_sink(
                    sink, "on_add", list(range(self._count)),
                    self._meta[: self._count],
                )

    @staticmethod
    def _call_sink(sink: Any, method: str, *args) -> None:
        """A broken sink must not take dense ingest down with it, but it
        fails loudly (``index_sink_errors``); a kernel or CUDA fault
        reaches the caller."""
        try:
            getattr(sink, method)(*args)
        except Exception as e:
            if is_device_fault(e):
                raise
            DEFAULT_REGISTRY.counter("index_sink_errors").inc()
            log.exception("index sink %s.%s failed", sink, method)

    def _notify_sinks(self, method: str, *args) -> None:
        for sink in self._index_sinks:
            self._call_sink(sink, method, *args)

    def device_view(self) -> Tuple[torch.Tensor, int]:
        """(device buffer, row count) read under one lock acquisition (on a
        mesh, this rank's block).
        Rows below the count never change until a compaction, which swaps
        in a new buffer, so a search may use the pair after the lock is
        released."""
        with self._lock:
            return self._dev, self._count

    def search_view(
        self, filters: Optional[Dict[str, Any]] = None
    ) -> Tuple[torch.Tensor, int, Optional[np.ndarray]]:
        """(device buffer, row count, live mask [count] or None) under one
        lock acquisition (on a mesh the buffer is this rank's block, which
        :meth:`search_rows` searches): the mask folds ``filters`` (patient_id /
        doc_type / date_from / date_to) and the tombstones; None when
        neither applies."""
        with self._lock:
            count = self._count
            if filters:
                mask = self._filter_mask_locked(filters)
            elif self._n_deleted:
                mask = ~self._deleted[:count]
            else:
                mask = None
            return self._dev, count, mask

    def _grow_to(self, needed: int) -> None:
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        if self._n_shards > 1:
            # the blocks' rows change with the capacity: re-place them
            self._capacity = new_cap
            self._place_rows(self._count)
            return
        buf = torch.zeros((new_cap, self.cfg.dim), dtype=self._dtype,
                          device=self.device)
        buf[: self._count] = self._dev[: self._count]
        self._dev = buf
        if self.cfg.token_width:
            tok = torch.zeros((new_cap, self.cfg.token_width),
                              dtype=torch.int32, device=self.device)
            tok[: self._count] = self._tok_dev[: self._count]
            tok_len = torch.zeros((new_cap,), dtype=torch.int32, device=self.device)
            tok_len[: self._count] = self._tok_len_dev[: self._count]
            self._tok_dev, self._tok_len_dev = tok, tok_len
        self._capacity = new_cap

    def _sidecar_block(self, n: int, token_rows, token_lens):
        """``[n, W]`` token ids and ``[n]`` lengths for an add: rows longer
        than the width are truncated, absent rows stay empty (the fused
        path then packs that chunk as zero tokens)."""
        W = self.cfg.token_width
        block = np.zeros((n, W), np.int32)
        lens = np.zeros((n,), np.int32)
        if token_rows is not None:
            token_rows = np.asarray(token_rows, np.int32)
            w = min(W, token_rows.shape[1])
            block[:, :w] = token_rows[:, :w]
            if token_lens is None:
                token_lens = (token_rows != 0).sum(axis=1)
            lens[:] = np.minimum(np.asarray(token_lens, np.int32), W)
        return block, lens

    def _append_sidecar_host(self, start: int, block, lens) -> None:
        n = len(lens)
        if self._tok_host.shape[0] < start + n:
            grow = max(start + n, 2 * max(1, self._tok_host.shape[0]))
            th = np.zeros((grow, self.cfg.token_width), np.int32)
            th[: self._tok_host.shape[0]] = self._tok_host
            tl = np.zeros((grow,), np.int32)
            tl[: self._tok_len_host.shape[0]] = self._tok_len_host
            self._tok_host, self._tok_len_host = th, tl
        self._tok_host[start : start + n] = block
        self._tok_len_host[start : start + n] = lens

    def token_sidecar(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(tokens [capacity, W] int32, lengths [capacity] int32) device
        tensors read under one lock acquisition, or None when the sidecar
        is off.  Rows below the count never change until a compaction,
        which swaps in new tensors."""
        if not self.cfg.token_width:
            return None
        with self._lock:
            return self._tok_dev, self._tok_len_dev

    def add(
        self,
        vectors: np.ndarray,
        metadata: Sequence[Dict[str, Any]],
        token_rows: Optional[np.ndarray] = None,
        token_lens: Optional[np.ndarray] = None,
    ) -> List[int]:
        """Append vectors (L2-normalized here) + metadata rows; returns the
        global row ids.  Visible to searches immediately, from any stream:
        on a card the call returns once the rows are on the device.

        ``token_rows`` / ``token_lens``: each row's generator token ids for
        the sidecar (``cfg.token_width``); ignored when the sidecar is off.
        Without ``token_lens`` a row's length is its count of nonzero
        ids.  A command on a mesh."""
        return mirrored(self, "add", self._add, np.asarray(vectors, np.float32),
                        [dict(m) for m in metadata], token_rows, token_lens)

    def _add(self, vectors, metadata, token_rows=None, token_lens=None) -> List[int]:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.cfg.dim:
            raise ValueError(
                f"expected [n, {self.cfg.dim}] vectors, got {vectors.shape}"
            )
        if len(vectors) != len(metadata):
            raise ValueError("vectors/metadata length mismatch")
        vectors = _normalized(vectors)

        with self._lock, span("store_add", DEFAULT_REGISTRY):
            start = self._count
            n = len(vectors)
            if self._host.shape[0] < start + n:
                grow = max(start + n, 2 * max(1, self._host.shape[0]))
                host = np.zeros((grow, self.cfg.dim), np.float32)
                host[:start] = self._host[:start]
                self._host = host
            self._host[start : start + n] = vectors
            if self.cfg.token_width:
                block, lens = self._sidecar_block(n, token_rows, token_lens)
                self._append_sidecar_host(start, block, lens)

            def _append_on_device():
                self._grow_to(start + n)
                # in-place write of the new rows that fall in this rank's
                # block (every row without a mesh)
                lo, hi = self._block_rows()
                a, z = max(start, lo), min(start + n, hi)
                if z <= a:
                    return
                self._dev[a - lo : z - lo] = torch.from_numpy(
                    vectors[a - start : z - start]
                ).to(device=self.device, dtype=self._dtype)
                if self.cfg.token_width:
                    self._tok_dev[a - lo : z - lo] = torch.from_numpy(
                        block[a - start : z - start]
                    ).to(self.device)
                    self._tok_len_dev[a - lo : z - lo] = torch.from_numpy(
                        lens[a - start : z - start]
                    ).to(self.device)

            # the submitter holds the lock while blocked; the item takes
            # none.  spine_run returns once the item's device work has
            # finished, so the count below publishes rows that have landed.
            spine_run("store_add", _append_on_device, device=self.device)
            self._meta.extend(dict(m) for m in metadata)
            self._append_columns(start, metadata)
            self._count = start + n
            self._version += 1
            row_ids = list(range(start, start + n))
            self._notify_sinks("on_add", row_ids, metadata)
            return row_ids

    def _filter_mask_locked(self, filters: Dict[str, Any]) -> np.ndarray:
        """[count] bool mask of the live rows matching ``filters``.  Rows
        without a date are excluded when a date bound is given; a bound
        that is not an ISO date raises ``ValueError``."""
        unknown = set(filters) - set(_FILTER_KEYS)
        if unknown:
            raise ValueError(f"unknown filter keys: {sorted(unknown)}")
        count = self._count
        live = np.ones((count,), bool)
        for column in ("patient_id", "doc_type"):
            value = filters.get(column)
            if value is not None:
                # an unseen value interns to no row: code -2 matches nothing
                code = self._codes[column].get(value, -2)
                live &= self._cols[column][:count] == code
        dates = self._cols["doc_date"][:count]
        for bound in ("date_from", "date_to"):
            value = filters.get(bound)
            if not value:  # None or '': an unfilled form field is no bound
                continue
            code = _date_code(value)
            if code < 0:
                raise ValueError(
                    f"{bound}={value!r} is not an ISO date (YYYY-MM-DD)"
                )
            live &= (dates >= code) if bound == "date_from" else (dates <= code)
        if filters.get("date_from") or filters.get("date_to"):
            live &= dates >= 0  # undated rows excluded when bounds given
        if self._n_deleted:
            live &= ~self._deleted[:count]
        return live

    def delete_docs(self, doc_ids: Sequence[str]) -> int:
        """Tombstone every chunk of the given documents: the rows vanish
        from every search and listing at once; their bytes stay until
        :meth:`compact_deleted`.  Returns the rows tombstoned.  A command
        on a mesh."""
        return mirrored(self, "delete_docs", self._delete_docs, list(doc_ids))

    def _delete_docs(self, doc_ids: Sequence[str]) -> int:
        with self._lock:
            count = self._count
            codes = [
                self._codes["doc_id"][d]
                for d in doc_ids
                if d in self._codes["doc_id"]
            ]
            if count == 0 or not codes:
                return 0
            hit = np.isin(self._cols["doc_id"][:count], codes)
            hit &= ~self._deleted[:count]
            rows = [int(i) for i in np.nonzero(hit)[0]]
            if not rows:
                return 0
            self._deleted[:count] |= hit
            self._n_deleted += len(rows)
            for i in rows:
                self._meta[i]["deleted"] = True
            self._version += 1
            self._notify_sinks("on_delete", rows)
            log.info("tombstoned %d rows across %d docs", len(rows), len(codes))
            return len(rows)

    def compact_deleted(self) -> int:
        """Remove the tombstoned rows for real: the host copy, the columns
        and a fresh device buffer.  Row ids change (the sinks get the keep
        mask).  Returns the rows removed.  A command on a mesh."""
        return mirrored(self, "compact_deleted", self._compact_deleted)

    def _compact_deleted(self) -> int:
        with self._lock:
            count = self._count
            if not self._n_deleted:
                return 0
            keep = ~self._deleted[:count]
            kept = int(keep.sum())
            self._host = self._host[:count][keep].copy()
            if self.cfg.token_width:
                self._tok_host = self._tok_host[:count][keep].copy()
                self._tok_len_host = self._tok_len_host[:count][keep].copy()
            self._meta = [md for md, k in zip(self._meta, keep) if k]
            self._reset_columns()
            self._append_columns(0, self._meta)
            self._count = kept
            self._capacity = self._round_capacity(kept)
            spine_run("store_add", lambda: self._place_rows(kept), device=self.device)
            self._version += 1
            self._n_compactions += 1
            self._notify_sinks("on_compact", keep.copy())
            log.info("compacted %d deleted rows; %d remain", count - kept, kept)
            return count - kept

    def metadata_select(
        self, limit: Optional[int] = None, **filters: Any
    ) -> List[Dict[str, Any]]:
        """The metadata rows matching ``filters`` in row order, at most
        ``limit`` of them (the non-semantic patient-snippet listing)."""
        with self._lock:
            if self._count == 0:
                return []
            idx = np.nonzero(self._filter_mask_locked(filters))[0]
            if limit is not None:
                idx = idx[:limit]
            return [self._meta[int(i)] for i in idx]

    def search(
        self,
        queries: np.ndarray,
        k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> List[List[SearchResult]]:
        """Exact top-k of host query vectors (L2-normalized here) over the
        live rows matching ``filters``: the search of the runtime's
        fake-encoder mode and of the reference's ``store.search``.  A
        command on a mesh."""
        return mirrored(self, "search", self._search,
                        np.asarray(queries, np.float32), k, filters)

    def _search(self, queries, k=None, filters=None) -> List[List[SearchResult]]:
        k = k or self.cfg.default_k
        qn = _normalized(queries)
        buf, count, mask = self.search_view(filters)
        if count == 0:
            return [[] for _ in qn]

        def _search_on_device():
            q = torch.from_numpy(qn).to(device=self.device, dtype=buf.dtype)
            m = None if mask is None else torch.from_numpy(mask).to(self.device)
            vals, ids = self.search_rows(buf, q, count, min(k, count), m)
            return to_host(vals), to_host(ids)

        with span("store_search", DEFAULT_REGISTRY):
            vals, ids = spine_run(
                "store_search", _search_on_device, device=self.device
            )
        return self.assemble_results(vals.numpy(), ids.numpy())

    def shadow_search(
        self, queries: np.ndarray, k: int, count_cap: Optional[int] = None
    ) -> List[List[SearchResult]]:
        """Exact tombstone-masked top-k of host queries, the retrieval
        observatory's ground truth: :meth:`search`'s ranking (no filters)
        as a ``retrieve_shadow`` item on the spine's background ``probe``
        stream.  ``count_cap`` limits the scan to the rows the served query
        could see.  A command on a mesh."""
        return mirrored(self, "shadow_search", self._shadow_search,
                        np.asarray(queries, np.float32), int(k), count_cap)

    def _shadow_search(self, queries, k, count_cap=None) -> List[List[SearchResult]]:
        qn = _normalized(queries)
        buf, count, mask = self.search_view(None)
        if count_cap is not None and count_cap < count:
            count = int(count_cap)
            mask = None if mask is None else mask[:count]
        if count == 0:
            return [[] for _ in qn]

        def _shadow_on_device():
            q = torch.from_numpy(qn).to(device=self.device, dtype=buf.dtype)
            m = None if mask is None else torch.from_numpy(mask).to(self.device)
            vals, ids = self.search_rows(buf, q, count, min(k, count), m)
            return to_host(vals), to_host(ids)

        vals, ids = spine_run(
            "retrieve_shadow", _shadow_on_device, stream="probe", device=self.device
        )
        return self.assemble_results(vals.numpy(), ids.numpy())

    def assemble_results(
        self, vals: np.ndarray, ids: np.ndarray
    ) -> List[List[SearchResult]]:
        """Host-side (score, row-id) -> SearchResult rows with metadata;
        masked rows (``NEG_INF``) are dropped."""
        out: List[List[SearchResult]] = []
        for qi in range(len(vals)):
            row: List[SearchResult] = []
            for score, rid in zip(vals[qi], ids[qi]):
                if score <= NEG_INF / 2:
                    continue  # filtered or tombstoned row
                row.append(
                    SearchResult(float(score), int(rid), self._meta[int(rid)])
                )
            out.append(row)
        return out

    def row_metadata(self, rid: int) -> Optional[Dict[str, Any]]:
        """Metadata of one row id, or None past the count."""
        with self._lock:
            if 0 <= rid < self._count:
                return self._meta[rid]
        return None

    def metadata_rows(self) -> List[Dict[str, Any]]:
        """Copy of the metadata list (row order == insertion order, tombstoned
        rows included with ``deleted`` set) — listings without a device
        round trip."""
        with self._lock:
            return list(self._meta[: self._count])

    def host_rows(self, ids: np.ndarray) -> np.ndarray:
        """L2-normalized float32 vectors of the given row ids from the host
        master copy.  Rows the caller holds ids for are immutable until a
        compaction, and a reallocation publishes a whole new array."""
        return self._host[np.asarray(ids, np.int64)]

    def vectors_snapshot(
        self, start: int = 0
    ) -> Tuple[np.ndarray, List[Dict[str, Any]]]:
        """Consistent (vectors, metadata) of rows [start, count) under one
        lock acquisition."""
        with self._lock:
            return self._host[start : self._count].copy(), list(
                self._meta[start : self._count]
            )

    def snapshot(self, directory: str, keep_previous: bool = True) -> str:
        """Publish the store under ``directory`` atomically and return the
        published path: vectors (float32 DNS1 shard), ``metadata.json``,
        the sidecar's ``tokens.npy`` / ``token_lens.npy`` and
        ``manifest.json`` are written into a temporary directory, renamed
        to ``index_v<version>`` (replacing a stale directory of the same
        version: after a failed restore a fresh store counts from 0 again),
        then ``LATEST`` is replaced.  Superseded versions are pruned,
        keeping one predecessor unless ``keep_previous`` is False (after an
        erasure the predecessor still holds the erased rows)."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            count, version = self._count, self._version
            vectors = self._host[:count].copy()
            meta = list(self._meta)
            tokens = token_lens = None
            if self.cfg.token_width:
                tokens = self._tok_host[:count].copy()
                token_lens = self._tok_len_host[:count].copy()
        base = os.path.join(directory, f"index_v{version}")
        tmp = tempfile.mkdtemp(dir=directory)
        vec_path = native.write_vectors(os.path.join(tmp, "vectors"), vectors)
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f)
        manifest = {
            "version": version,
            "count": count,
            "dim": self.cfg.dim,
            "vectors": os.path.basename(vec_path),
        }
        if tokens is not None:
            np.save(os.path.join(tmp, "tokens.npy"), tokens)
            np.save(os.path.join(tmp, "token_lens.npy"), token_lens)
            manifest["tokens"] = "tokens.npy"
            manifest["token_width"] = self.cfg.token_width
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(base):
            shutil.rmtree(base)
        os.replace(tmp, base)
        latest = os.path.join(directory, "LATEST")
        with open(latest + ".tmp", "w") as f:
            f.write(f"index_v{version}")
        os.replace(latest + ".tmp", latest)
        versions = sorted(
            (
                int(d.split("index_v", 1)[1])
                for d in os.listdir(directory)
                if d.startswith("index_v") and d.split("index_v", 1)[1].isdigit()
            ),
            reverse=True,
        )
        for old in versions[2 if keep_previous else 1:]:
            shutil.rmtree(os.path.join(directory, f"index_v{old}"), ignore_errors=True)
        return base

    @classmethod
    def restore(cls, directory: str, cfg: StoreConfig, device="cuda",
                mesh: Optional[MeshContext] = None) -> "VectorStore":
        """A new store holding the snapshot ``LATEST`` names under
        ``directory``, its version included.  The sidecar is restored when
        both the config and the snapshot have one."""
        with open(os.path.join(directory, "LATEST")) as f:
            base = os.path.join(directory, f.read().strip())
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        vectors = native.read_vectors(
            os.path.join(base, manifest.get("vectors", "vectors.npy"))
        )
        with open(os.path.join(base, "metadata.json")) as f:
            meta = json.load(f)
        store = cls(cfg, device=device, mesh=mesh)
        tokens = token_lens = None
        if cfg.token_width and manifest.get("tokens"):
            tokens = np.load(os.path.join(base, manifest["tokens"]))
            token_lens = np.load(os.path.join(base, "token_lens.npy"))
        if len(vectors):
            store.add(vectors, meta, token_rows=tokens, token_lens=token_lens)
        store._version = manifest["version"]
        return store
