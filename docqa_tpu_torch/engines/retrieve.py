"""Fused query path: tokenize on the host, then encoder forward -> L2
re-normalize -> cast to the store's dtype -> exact scores -> top-k, all on
the device, with one fetch at the end.  Counterpart of
``docqa_tpu/engines/retrieve.py``'s ``FusedRetriever`` (single device).

The device phase is one dispatch-spine work item (stage ``retrieve``)
inside a ``fused_query`` span, as the reference's single program is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from docqa_tpu_torch.engines.encoder import EncoderEngine, marshal_texts
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.store import SearchResult, VectorStore, search_single
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY, encoder_cost
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.utils import resolve_device

QUERY_BATCH_BUCKETS = (1, 4, 16)


class FusedRetriever:
    """Text-in, ranked-rows-out retrieval over an :class:`EncoderEngine`
    (params, config, tokenizer) and a :class:`VectorStore` (device buffer,
    host metadata), all on one device."""

    def __init__(self, encoder: EncoderEngine, store: VectorStore, device="cuda"):
        self.device = resolve_device(device)
        if encoder.device != self.device or store.device != self.device:
            raise ValueError(
                f"encoder on {encoder.device} and store on {store.device}; "
                f"the retriever runs on {self.device}"
            )
        self.encoder = encoder
        self.store = store

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

    def search_texts(
        self, texts: Sequence[str], k: Optional[int] = None
    ) -> List[List[SearchResult]]:
        """Same contract as the reference's ``search_texts``: one ranked
        list of :class:`SearchResult` per query text."""
        store = self.store
        k = k or store.cfg.default_k
        if not len(texts):
            return []
        n = len(texts)
        ids_p, len_p = marshal_texts(
            self.encoder.tokenizer,
            self.encoder.cfg,
            texts,
            batch_buckets=QUERY_BATCH_BUCKETS,
        )
        buf, count = store.device_view()
        if count == 0:
            return [[] for _ in texts]

        def _retrieve_on_device():
            if buf.is_cuda:
                # an add on another stream (the ingest pipeline's index
                # worker) may swap in a grown buffer meanwhile: the
                # allocator must not reuse this one before this stream's
                # reads of it are done
                buf.record_stream(torch.cuda.current_stream(buf.device))
            emb = self.encoder.encode_ids(ids_p, len_p)
            with torch.inference_mode():
                # the store scores cosine: re-normalize even when the
                # encoder config skips its own normalize
                emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
                vals, row_ids = search_single(
                    buf, emb.to(buf.dtype), count, min(k, count)
                )
            return to_host(vals[:n]), to_host(row_ids[:n])

        _tag, batch, seq, pairs = self.encoder.cost_key(ids_p, len_p)
        with span("fused_query", DEFAULT_REGISTRY):
            vals, row_ids = spine_run(
                "retrieve", _retrieve_on_device, device=self.device,
                cost_key=("retrieve", batch, seq, pairs, count),
            )
        return store.assemble_results(vals.numpy(), row_ids.numpy())
