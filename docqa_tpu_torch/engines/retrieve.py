"""Fused query path: tokenize on the host, then encoder forward -> L2
re-normalize -> cast to the store's dtype -> exact scores -> top-k, all on
the device, with one fetch at the end.  Counterpart of
``docqa_tpu/engines/retrieve.py``'s ``FusedRetriever`` (single device).

The device phase is one dispatch-spine work item (stage ``retrieve``)
inside a ``fused_query`` span, as the reference's single program is.  A
metadata filter or a tombstone rides as a row mask, built from the store
under the same lock as the buffer it masks.

Retrieve modes (``mode=``): ``dense`` (the path above), ``lexical`` (the
lexical tier alone, mapped onto the store's rows) and ``hybrid`` (both,
fused by ``engines.router.fuse_scores``), with the reference's rules: a
request without a mode takes ``default_mode``; a non-dense mode falls back
to dense when no lexical tier is wired or a filter is set (only the dense
store implements filters), counting ``retrieve_mode_fallback``.  The
reference serves these modes on its tiered index only: under exact serving
its app builds the retriever with no lexical tier, and so does the port's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from docqa_tpu_torch.engines.encoder import EncoderEngine, marshal_texts
from docqa_tpu_torch.engines.router import fuse_scores
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.store import SearchResult, VectorStore, search_single
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY, encoder_cost
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.retrieve")

QUERY_BATCH_BUCKETS = (1, 4, 16)
MODES = ("dense", "lexical", "hybrid")


class FusedRetriever:
    """Text-in, ranked-rows-out retrieval over an :class:`EncoderEngine`
    (params, config, tokenizer) and a :class:`VectorStore` (device buffer,
    host metadata), all on one device; ``lexical`` (an
    ``index.lexical.LexicalIndex`` fed by the store) enables the lexical
    and hybrid modes."""

    def __init__(self, encoder: EncoderEngine, store: VectorStore, device="cuda",
                 lexical=None, hybrid_alpha: float = 0.6,
                 default_mode: str = "dense"):
        self.device = resolve_device(device)
        if encoder.device != self.device or store.device != self.device:
            raise ValueError(
                f"encoder on {encoder.device} and store on {store.device}; "
                f"the retriever runs on {self.device}"
            )
        self.encoder = encoder
        self.store = store
        self.lexical = lexical
        self.hybrid_alpha = float(hybrid_alpha)
        self.default_mode = default_mode

    @property
    def supports_modes(self) -> bool:
        """Whether the QA service should forward a requested mode."""
        return self.lexical is not None

    def annotate_costs(self) -> None:
        """Register the ``retrieve`` stage's analytic cost model: the
        encoder forward plus the exact scores (``2·queries·rows·dim``
        FLOPs, the store rows read once).  Key: ``("retrieve", batch,
        seq, pairs, rows)``."""
        cfg = self.encoder.cfg
        dim = self.store.cfg.dim
        row_bytes = dim * self.store._dev.element_size()

        def model(key):
            _tag, batch, seq, pairs, rows = key
            c = encoder_cost(cfg, batch, seq, pairs)
            return {
                "flops": c["flops"] + 2.0 * batch * rows * dim,
                "bytes": c["bytes"] + float(rows * row_bytes),
            }

        DEFAULT_OBSERVATORY.annotate_model("retrieve", model)

    def _resolve_mode(self, mode: Optional[str], filters) -> str:
        mode = mode or self.default_mode
        if mode not in MODES:
            log.warning("unknown retrieve mode %r; serving dense", mode)
            mode = "dense"
        if mode != "dense" and (self.lexical is None or filters):
            DEFAULT_REGISTRY.counter("retrieve_mode_fallback").inc()
            return "dense"
        return mode

    def search_texts(
        self,
        texts: Sequence[str],
        k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        deadline=None,  # resilience.Deadline: shed before the dispatch
        mode: Optional[str] = None,
    ) -> List[List[SearchResult]]:
        """One ranked list of :class:`SearchResult` per query text, over
        the live rows matching ``filters`` (patient_id / doc_type /
        date_from / date_to)."""
        k = k or self.store.cfg.default_k
        if not len(texts):
            return []
        if deadline is not None:
            deadline.check("retrieve")
        mode = self._resolve_mode(mode, filters)
        DEFAULT_REGISTRY.counter(f"retrieve_mode_{mode}").inc()
        if mode == "lexical":
            return self._lexical_rows(self.lexical.search(list(texts), k=k))
        dense = self._search_dense(texts, k, filters, deadline)
        if mode == "dense":
            return dense
        lex = self.lexical.search(list(texts), k=k)
        return self._fuse_rows(dense, lex, k)

    def _search_dense(self, texts, k, filters, deadline) -> List[List[SearchResult]]:
        store = self.store
        n = len(texts)
        ids_p, len_p = marshal_texts(
            self.encoder.tokenizer,
            self.encoder.cfg,
            texts,
            batch_buckets=QUERY_BATCH_BUCKETS,
        )
        _tag, batch, seq, pairs = self.encoder.cost_key(ids_p, len_p)

        # one consistent snapshot: the reference re-snapshots when an add
        # donated its buffer mid-compile (engines/dispatch.py); nothing is
        # donated here, a grow or a compaction swaps in a new tensor
        buf, count, mask = store.search_view(filters)
        if count == 0:
            return [[] for _ in texts]

        def _retrieve_on_device():
            if buf.is_cuda:
                # an add or a compaction on another stream may swap in a
                # new buffer meanwhile: the allocator must not reuse this
                # one before this stream's reads of it are done
                buf.record_stream(torch.cuda.current_stream(buf.device))
            emb = self.encoder.encode_ids(ids_p, len_p)
            with torch.inference_mode():
                # the store scores cosine: re-normalize even when the
                # encoder config skips its own normalize
                emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
                live = None if mask is None else torch.from_numpy(mask).to(self.device)
                vals, row_ids = search_single(
                    buf, emb.to(buf.dtype), count, min(k, count), live
                )
            return to_host(vals[:n]), to_host(row_ids[:n])

        with span("fused_query", DEFAULT_REGISTRY):
            vals, row_ids = spine_run(
                "retrieve", _retrieve_on_device, device=self.device,
                deadline=deadline, cost_key=("retrieve", batch, seq, pairs, count),
            )
        return store.assemble_results(vals.numpy(), row_ids.numpy())

    def _lexical_rows(
        self, lex: List[List[Tuple[float, int]]]
    ) -> List[List[SearchResult]]:
        """Lexical candidates on the store's metadata, tombstones dropped."""
        out = []
        for row in lex:
            res = []
            for score, rid in row:
                md = self.store.row_metadata(rid)
                if md is not None and not md.get("deleted"):
                    res.append(SearchResult(float(score), rid, md))
            out.append(res)
        return out

    def _fuse_rows(
        self,
        dense: List[List[SearchResult]],
        lex: List[List[Tuple[float, int]]],
        k: int,
    ) -> List[List[SearchResult]]:
        """Hybrid rows: :func:`fuse_scores` over each query's dense and
        lexical candidates, cut to ``k`` after dropping tombstones."""
        out: List[List[SearchResult]] = []
        for qi, drow in enumerate(dense):
            lrow = lex[qi] if qi < len(lex) else []
            md_by = {r.row_id: r.metadata for r in drow}
            fused = fuse_scores(
                [(r.score, r.row_id) for r in drow], lrow, self.hybrid_alpha
            )
            res: List[SearchResult] = []
            for score, rid in fused:
                md = md_by.get(rid)
                if md is None:
                    md = self.store.row_metadata(rid)
                if md is None or md.get("deleted"):
                    continue
                res.append(SearchResult(float(score), rid, md))
                if len(res) >= k:
                    break
            out.append(res)
        return out
