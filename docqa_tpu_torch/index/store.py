"""Device-resident exact vector store (a subset of
``docqa_tpu/index/store.py``'s ``VectorStore``).

A float32 host master copy plus one [capacity, dim] device buffer in
``StoreConfig.dtype`` (bf16 by default) that doubles when it fills.
Vectors are L2-normalized on add, so a dot product is the cosine.
Metadata filters, tombstones, snapshots and the fused RAG path's token
sidecar (``StoreConfig.token_width``) are later slices.  The device write
of :meth:`VectorStore.add` is a dispatch-spine work item (``store_add``);
the port's only search is the fused retriever's ``retrieve`` item.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch.config import StoreConfig
from docqa_tpu_torch.engines.spine import spine_run
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.utils import resolve_device, round_up, torch_dtype

NEG_INF = -1e30

# rows scored per float32 product in search_single: bounds the float32
# copy of the buffer to 512 MB at d=384
SCORE_CHUNK = 1 << 18


@dataclass
class SearchResult:
    score: float
    row_id: int
    metadata: Dict[str, Any]


def search_single(vectors: torch.Tensor, queries: torch.Tensor, count: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries`` [q, d] over rows [0, count) of
    ``vectors``.  Scores are float32 dot products of the stored-dtype
    values, as the reference's ``preferred_element_type=float32`` product
    gives.  Returns (vals [q, k] f32, row ids [q, k])."""
    qf = queries.float()
    scores = torch.cat(
        [
            qf @ vectors[start : min(start + SCORE_CHUNK, count)].float().T
            for start in range(0, count, SCORE_CHUNK)
        ],
        dim=1,
    )
    vals, ids = torch.topk(scores, k, dim=-1)
    return vals, ids


class VectorStore:
    """Append + exact search over device vectors with host metadata."""

    def __init__(self, cfg: StoreConfig, device="cuda"):
        self.device = resolve_device(device)
        if cfg.token_width:
            raise ValueError(
                "the token sidecar (StoreConfig.token_width) comes with the "
                "fused RAG slice; only token_width=0 is supported"
            )
        self.cfg = cfg
        self._lock = threading.RLock()
        self._meta: List[Dict[str, Any]] = []
        self._host = np.zeros((0, cfg.dim), np.float32)  # durable master copy
        self._count = 0
        self._dtype = torch_dtype(cfg.dtype)
        self._capacity = max(128, round_up(cfg.shard_capacity, 128))
        self._dev = torch.zeros(
            (self._capacity, cfg.dim), dtype=self._dtype, device=self.device
        )

    @property
    def count(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._capacity

    def device_view(self) -> Tuple[torch.Tensor, int]:
        """(device buffer, row count) read under one lock acquisition.
        Rows below the count never change, so a search may use the pair
        after the lock is released."""
        with self._lock:
            return self._dev, self._count

    def _grow_to(self, needed: int) -> None:
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        buf = torch.zeros((new_cap, self.cfg.dim), dtype=self._dtype,
                          device=self.device)
        buf[: self._count] = self._dev[: self._count]
        self._dev = buf
        self._capacity = new_cap

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

        ``token_rows`` / ``token_lens`` take the reference's signature for
        the token sidecar, which this port does not have yet: passing
        either raises."""
        if token_rows is not None or token_lens is not None:
            raise ValueError(
                "token_rows/token_lens need the token sidecar "
                f"(StoreConfig.token_width, here {self.cfg.token_width}), "
                "which comes with the fused RAG slice"
            )
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.cfg.dim:
            raise ValueError(
                f"expected [n, {self.cfg.dim}] vectors, got {vectors.shape}"
            )
        if len(vectors) != len(metadata):
            raise ValueError("vectors/metadata length mismatch")
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = vectors / np.maximum(norms, 1e-9)

        with self._lock, span("store_add", DEFAULT_REGISTRY):
            start = self._count
            n = len(vectors)
            if self._host.shape[0] < start + n:
                grow = max(start + n, 2 * max(1, self._host.shape[0]))
                host = np.zeros((grow, self.cfg.dim), np.float32)
                host[:start] = self._host[:start]
                self._host = host
            self._host[start : start + n] = vectors

            def _append_on_device():
                self._grow_to(start + n)
                # in-place write of the new rows into the device buffer
                self._dev[start : start + n] = torch.from_numpy(vectors).to(
                    device=self.device, dtype=self._dtype
                )

            # the submitter holds the lock while blocked; the item takes
            # none.  spine_run returns once the item's device work has
            # finished, so the count below publishes rows that have landed.
            spine_run("store_add", _append_on_device, device=self.device)
            self._meta.extend(dict(m) for m in metadata)
            self._count = start + n
            return list(range(start, start + n))

    def assemble_results(
        self, vals: np.ndarray, ids: np.ndarray
    ) -> List[List[SearchResult]]:
        """Host-side (score, row-id) -> SearchResult rows with metadata."""
        out: List[List[SearchResult]] = []
        for qi in range(len(vals)):
            row: List[SearchResult] = []
            for score, rid in zip(vals[qi], ids[qi]):
                if score <= NEG_INF / 2:
                    continue  # dead row
                row.append(
                    SearchResult(float(score), int(rid), self._meta[int(rid)])
                )
            out.append(row)
        return out

    def metadata_rows(self) -> List[Dict[str, Any]]:
        """Copy of the metadata list (row order == insertion order) —
        non-semantic listings without a device round trip."""
        with self._lock:
            return list(self._meta[: self._count])
