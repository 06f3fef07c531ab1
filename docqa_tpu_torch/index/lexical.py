"""Lexical (inverted-impact) tier beside the dense store, counterpart of
``docqa_tpu/index/lexical.py`` on one device.

Exact-token recall (MRNs, dotted phone numbers, hyphenated drug names,
French jargon) that the dense encoder's neighbourhood misses:

* :func:`clinical_tokens`: case fold, NFKD diacritic fold, digit runs
  joined across ``.``/``-``/space, ``[a-z0-9]+`` tokens plus one joined
  token per hyphenated compound.  The reference's, character for character.
* hashed vocabulary: :func:`term_slot` is ``crc32(token) % vocab_size``
  (never the builtin ``hash``, which ``PYTHONHASHSEED`` would change).
* impact tiles: each row keeps its top ``tile_width`` terms as ``(slot
  int32, impact int8)``, BM25-style ``tf*(k1+1) / (tf + k1*(1-b+b*len/
  ref_len))`` quantized at a fixed ``(k1+1)/127`` scale.  ``ref_len`` is a
  constant, so an add never re-scores existing rows.  IDF is applied on the
  query side from host document frequencies, folded into the float32 query
  weights with the int8 descale.

Rows are addressed by the dense store's row ids: the tier ingests through
``VectorStore.register_index_sink``, so adds, tombstones and compactions
stay aligned with the store.

The device copy is a version-checked snapshot uploaded on the
``lexical_search`` spine stage; scoring (:func:`score_lexical`) is plain
PyTorch on the device, as the reference leaves it to XLA (ROADMAP queue 2
lists its kernel, K8).  The reference's sharded program (tiles row-sharded
over a mesh) is multi-GPU work, not here.
"""

from __future__ import annotations

import re
import threading
import unicodedata
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.utils import resolve_device

NEG_INF = -1e30

# tile pad (-1) and query pad (-2) differ: a padded query slot must never
# match a padded tile slot
_TILE_PAD = -1
_QUERY_PAD = -2

# query-term and query-batch padding ladders (the reference's operand
# shapes, kept so encode_queries gives the same operands)
_QUERY_TERM_BUCKETS = (8, 16, 32, 64)
_QUERY_BATCH_BUCKETS = (1, 4, 16)

# rows scored per pass in score_lexical: bounds the [terms, rows, width]
# compare to a few hundred MB at the largest query
_ROW_CHUNK = 1 << 14

_DIGIT_JOIN = re.compile(r"(?<=\d)[.\-\s](?=\d)")
_TOKEN = re.compile(r"[a-z0-9]+")
_HYPHEN_WORD = re.compile(r"[a-z0-9]+(?:-[a-z0-9]+)+")


def clinical_tokens(text: str) -> List[str]:
    """Normalize and tokenize one document or query (EN/FR clinical text):
    case fold, NFKD with combining marks stripped, digit runs joined,
    ``[a-z0-9]+`` split, plus one joined token per hyphenated compound."""
    if not text:
        return []
    t = unicodedata.normalize("NFKD", text.casefold())
    t = "".join(ch for ch in t if not unicodedata.combining(ch))
    t = _DIGIT_JOIN.sub("", t)
    toks = _TOKEN.findall(t)
    for m in _HYPHEN_WORD.finditer(t):
        toks.append(m.group(0).replace("-", ""))
    return toks


def term_slot(token: str, vocab_size: int) -> int:
    """Deterministic hashed vocabulary slot of a token."""
    return zlib.crc32(token.encode("utf-8")) % vocab_size


def _bucket(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def score_lexical(term_ids: torch.Tensor, impacts: torch.Tensor,
                  row_live: torch.Tensor, q_terms: torch.Tensor,
                  q_weights: torch.Tensor) -> torch.Tensor:
    """Impact-tile scores of term-encoded queries, the reference's
    ``_score_lexical``: for each query term, the matching tile slot's int8
    impact of every row summed in float32 (``[T, R]``), then the float32
    query weights contracted over the terms.  term_ids [R, W] int32 (pad
    -1), impacts [R, W] int8, row_live [R] bool, q_terms [Q, T] int32 (pad
    -2), q_weights [Q, T] f32.  Returns [Q, R] f32, dead rows ``NEG_INF``."""
    rows = term_ids.shape[0]
    out = torch.empty((q_terms.shape[0], rows), dtype=torch.float32,
                      device=term_ids.device)
    for start in range(0, rows, _ROW_CHUNK):
        end = min(start + _ROW_CHUNK, rows)
        tids = term_ids[start:end]
        imps = impacts[start:end].float()
        for qi in range(q_terms.shape[0]):
            eq = q_terms[qi][:, None, None] == tids[None]  # [T, r, W]
            per_term = torch.where(eq, imps[None], 0.0).sum(dim=2)  # [T, r]
            out[qi, start:end] = q_weights[qi] @ per_term
    return out.masked_fill(~row_live[None, :], NEG_INF)


class LexicalIndex:
    """Incremental lexical tier over hashed impact tiles.

    A host master copy (int32 slots, int8 impacts, liveness)
    grows under a lock like the store's; the device copy is re-uploaded on
    the first search after it moved."""

    def __init__(
        self,
        *,
        vocab_size: int = 1 << 17,
        tile_width: int = 32,
        k1: float = 1.5,
        b: float = 0.75,
        ref_len: int = 64,
        device="cuda",
    ) -> None:
        if vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        if tile_width < 1:
            raise ValueError("tile_width must be >= 1")
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.tile_width = int(tile_width)
        self.k1 = float(k1)
        self.b = float(b)
        self.ref_len = max(1, int(ref_len))
        self._lock = threading.RLock()
        self._term_ids = np.full((0, tile_width), _TILE_PAD, np.int32)
        self._impacts = np.zeros((0, tile_width), np.int8)
        # the unquantized impacts: the exact host scoring (host_topk) of
        # the retrieval observatory's lexical shadow
        self._impacts_f = np.zeros((0, tile_width), np.float32)
        self._live = np.zeros((0,), bool)
        self._count = 0
        self._df = np.zeros((self.vocab_size,), np.int64)
        self._n_docs = 0  # docs that contributed df (deleted ones included)
        self._slot_owner: Dict[int, str] = {}
        self._collided_slots: set = set()
        self._n_truncated_terms = 0
        self._n_empty_docs = 0
        self._version = 0
        # device snapshot: (version, term_ids, impacts, row_live, count)
        self._dev: Optional[Tuple[Any, ...]] = None

    # -- ingest (the store's index-sink protocol) ---------------------------

    def on_add(self, row_ids: Sequence[int], metadata: Sequence[Dict[str, Any]]):
        """Rows appended to the dense store, with their row ids and
        metadata (text under ``text_content``); rows whose metadata carries
        ``deleted`` are tombstoned here too."""
        texts = [
            str((md or {}).get("text_content", "") or "") for md in metadata
        ]
        self.add(row_ids, texts)
        dead = [
            rid for rid, md in zip(row_ids, metadata) if (md or {}).get("deleted")
        ]
        if dead:
            self.on_delete(dead)

    def on_delete(self, row_ids: Sequence[int]) -> None:
        """Tombstones, mirroring the store's."""
        with self._lock:
            for rid in row_ids:
                if 0 <= rid < self._count:
                    self._live[rid] = False
            self._version += 1

    def on_compact(self, keep: np.ndarray) -> None:
        """The store's keep mask over its rows before a compaction; the
        surviving rows renumber in order, as the store's do."""
        keep = np.asarray(keep, bool)
        with self._lock:
            k = keep[: self._count]
            self._term_ids = self._term_ids[: self._count][k].copy()
            self._impacts = self._impacts[: self._count][k].copy()
            self._impacts_f = self._impacts_f[: self._count][k].copy()
            self._live = self._live[: self._count][k].copy()
            self._count = int(k.sum())
            self._version += 1

    def add(self, row_ids: Sequence[int], texts: Sequence[str]) -> None:
        """Tokenize, count per-slot term frequencies, keep each row's top
        ``tile_width`` impacts."""
        if len(row_ids) != len(texts):
            raise ValueError("row_ids and texts must align")
        if not row_ids:
            return
        with self._lock, span("lexical_add", DEFAULT_REGISTRY):
            top = max(max(row_ids) + 1, self._count)
            self._ensure_capacity(top)
            for rid, text in zip(row_ids, texts):
                self._add_one_locked(int(rid), text)
            self._count = max(self._count, top)
            self._version += 1

    def _ensure_capacity(self, n: int) -> None:
        cap = len(self._live)
        if n <= cap:
            return
        new_cap = max(64, cap * 2, n)

        def grow(arr, fill):
            out = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            out[: len(arr)] = arr
            return out

        self._term_ids = grow(self._term_ids, _TILE_PAD)
        self._impacts = grow(self._impacts, 0)
        self._impacts_f = grow(self._impacts_f, 0.0)
        self._live = grow(self._live, False)

    def _add_one_locked(self, rid: int, text: str) -> None:
        toks = clinical_tokens(text)
        self._live[rid] = True
        self._term_ids[rid, :] = _TILE_PAD
        self._impacts[rid, :] = 0
        self._impacts_f[rid, :] = 0.0
        if not toks:
            self._n_empty_docs += 1
            return
        tf: Dict[int, int] = {}
        for tok in toks:
            s = term_slot(tok, self.vocab_size)
            tf[s] = tf.get(s, 0) + 1
            owner = self._slot_owner.setdefault(s, tok)
            if owner != tok:
                self._collided_slots.add(s)
        k1, b = self.k1, self.b
        norm = k1 * (1.0 - b + b * len(toks) / self.ref_len)
        pairs = sorted(
            ((f * (k1 + 1.0) / (f + norm), s) for s, f in tf.items()),
            key=lambda p: (-p[0], p[1]),
        )
        self._n_truncated_terms += max(0, len(pairs) - self.tile_width)
        for j, (imp, s) in enumerate(pairs[: self.tile_width]):
            self._term_ids[rid, j] = s
            self._impacts_f[rid, j] = imp
            q = int(round(127.0 * imp / (k1 + 1.0)))
            self._impacts[rid, j] = max(1, min(127, q))
            self._df[s] += 1
        self._n_docs += 1

    # -- query encoding -----------------------------------------------------

    def _encode_query_locked(self, text: str) -> List[Tuple[int, float]]:
        """(slot, weight) pairs of one query: query tf x idf x the int8
        descale; slots no document emitted are dropped."""
        tf: Dict[int, int] = {}
        for tok in clinical_tokens(text):
            s = term_slot(tok, self.vocab_size)
            tf[s] = tf.get(s, 0) + 1
        n = max(self._n_docs, 1)
        descale = (self.k1 + 1.0) / 127.0
        out = []
        for s, f in tf.items():
            df = int(self._df[s])
            if df == 0:
                continue
            idf = float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))
            out.append((s, f * idf * descale))
        # widest weights first, so the rare truncation drops the least
        # informative terms
        out.sort(key=lambda p: (-p[1], p[0]))
        return out[: _QUERY_TERM_BUCKETS[-1]]

    def encode_queries(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """A query batch as padded operands ``(q_terms [Q, T] int32,
        q_weights [Q, T] f32)``, the reference's shapes."""
        with self._lock:
            enc = [self._encode_query_locked(t) for t in texts]
        t_pad = _bucket(max((len(e) for e in enc), default=1) or 1,
                        _QUERY_TERM_BUCKETS)
        n_q = max(len(texts), 1)
        q_pad = (
            _bucket(n_q, _QUERY_BATCH_BUCKETS)
            if n_q <= _QUERY_BATCH_BUCKETS[-1] else n_q
        )
        q_terms = np.full((q_pad, t_pad), _QUERY_PAD, np.int32)
        q_weights = np.zeros((q_pad, t_pad), np.float32)
        for i, pairs in enumerate(enc):
            for j, (s, w) in enumerate(pairs):
                q_terms[i, j] = s
                q_weights[i, j] = w
        return q_terms, q_weights

    # -- device snapshot ----------------------------------------------------

    def device_tiles(self) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]]:
        """``(term_ids, impacts, row_live, count)`` on the device, uploaded
        only when the host copy moved since the last upload; None while the
        tier is empty."""
        with self._lock:
            count, version = self._count, self._version
            if count == 0:
                return None
            if self._dev is not None and self._dev[0] == version:
                return self._dev[1:]
            host = (
                self._term_ids[:count].copy(),
                self._impacts[:count].copy(),
                self._live[:count].copy(),
            )

        def _upload_on_device():
            return tuple(torch.from_numpy(a).to(self.device) for a in host)

        tiles = spine_run(
            "lexical_search", _upload_on_device, stream="rebuild",
            device=self.device,
        )
        snapshot = (version, *tiles, count)
        with self._lock:
            # publish only if nothing moved during the upload; this search
            # serves the consistent snapshot it built either way
            if self._version == version:
                self._dev = snapshot
        return snapshot[1:]

    # -- search -------------------------------------------------------------

    def search(self, texts: Sequence[str], k: int = 10) -> List[List[Tuple[float, int]]]:
        """Per query, ``(score, row_id)`` pairs by impact score; rows with
        no term overlap (score <= 0) are dropped.  One ``lexical_search``
        item on the device."""
        if not len(texts):
            return []
        tiles = self.device_tiles()
        if tiles is None:
            return [[] for _ in texts]
        term_ids, impacts, row_live, count = tiles
        q_terms, q_weights = self.encode_queries(texts)
        if not (q_terms != _QUERY_PAD).any():
            return [[] for _ in texts]  # no query term is in the corpus
        k_eff = min(k, count)

        def _lexical_on_device():
            scores = score_lexical(
                term_ids, impacts, row_live,
                torch.from_numpy(q_terms).to(self.device),
                torch.from_numpy(q_weights).to(self.device),
            )
            vals, ids = torch.topk(scores, k_eff, dim=-1)
            return to_host(vals), to_host(ids)

        with span("lexical_search", DEFAULT_REGISTRY):
            vals, ids = spine_run(
                "lexical_search", _lexical_on_device, device=self.device
            )
        vals, ids = vals.numpy(), ids.numpy()
        return [
            [
                (float(score), int(rid))
                for score, rid in zip(vals[qi], ids[qi])
                if score > 0.0 and 0 <= rid < count
            ]
            for qi in range(len(texts))
        ]

    def host_topk(
        self, texts: Sequence[str], k: int, count_cap: Optional[int] = None
    ) -> List[List[Tuple[int, float]]]:
        """Exact host scoring over the unquantized impacts: per query,
        ``(row_id, score)`` pairs of its top ``k`` rows scoring above 0, the
        lexical shadow's ground truth.  ``count_cap`` limits the rows to
        those the served query could see."""
        with self._lock:
            count = self._count if count_cap is None else min(count_cap, self._count)
            term_ids = self._term_ids[:count].copy()
            impacts_f = self._impacts_f[:count].copy()
            live = self._live[:count].copy()
            enc = [self._encode_query_locked(t) for t in texts]
        descale = (self.k1 + 1.0) / 127.0
        out: List[List[Tuple[int, float]]] = []
        for pairs in enc:
            if count == 0 or not pairs:
                out.append([])
                continue
            scores = np.zeros((count,), np.float32)
            for s, w in pairs:
                # w folds in the int8 descale, which full precision undoes
                scores += (w / descale) * (impacts_f * (term_ids == s)).sum(axis=1)
            scores[~live] = NEG_INF
            order = np.argsort(-scores, kind="stable")[:k]
            out.append([(int(r), float(scores[r])) for r in order if scores[r] > 0.0])
        return out

    def index_bytes(self) -> Dict[str, Any]:
        """Device bytes of the tiles (int32 slots, int8 impacts, a live
        flag a row); the port's tiles are not padded."""
        count = self._count
        total = count * (self.tile_width * (4 + 1) + 1)
        return {
            "total_bytes": total,
            "bytes_per_chunk": round(total / max(count, 1), 2),
            "per_shard_bytes": total,
            "shards": 1,
            "storage": "lexical_int8",
        }

    def stats(self) -> Dict[str, Any]:
        """The ``/api/retrieval`` view of the tier."""
        with self._lock:
            return {
                "rows": self._count,
                "live_rows": int(self._live[: self._count].sum()),
                "vocab_size": self.vocab_size,
                "tile_width": self.tile_width,
                "hash_collisions": len(self._collided_slots),
                "truncated_terms": self._n_truncated_terms,
                "empty_docs": self._n_empty_docs,
                "version": self._version,
                **self.index_bytes(),
            }
