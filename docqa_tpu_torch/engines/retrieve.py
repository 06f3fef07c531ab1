"""Fused query paths, counterpart of ``docqa_tpu/engines/retrieve.py``:
tokenize on the host, then the whole device phase as one dispatch-spine
work item with one host fetch at its end.

* :class:`FusedRetriever` (exact serving, dense only): encoder forward ->
  L2 re-normalize -> cast to the store's dtype -> exact scores -> top-k.
  Over a row-sharded store (``VectorStore(mesh=)``) the top-k is the
  store's sharded search (local block, then the exact merge), and a
  data-parallel encoder splits the query batch over the data axis.
  A metadata filter or a tombstone rides as a row mask, built from the
  store under the same lock as the buffer it masks.
* :class:`FusedTieredRetriever` (``store.serving_index="tiered"``): the
  same forward, then :func:`tiered_search_program` (coarse probe over the
  IVF cells, cell scores, the exact tail's top-k) or, in hybrid mode,
  :func:`hybrid_search_program` (that plus the lexical tier's top-k).  The
  host then dedups, re-ranks, merges and fuses with ``TieredIndex``'s own
  code.  Modes are the tiered index's (``mode=``); lexical mode skips the
  encoder.  With no IVF tier yet, or a filter, it serves through
  :class:`FusedRetriever`, as ``TieredIndex`` serves through the store.
  Over a sharded tier (``TieredIndex`` on a mesh) the probe is the
  sharded one and the lexical scoring the sharded lexical program, in the
  same item: two all-gathers a tiered retrieval, four a hybrid one
  (``shard_budget.json`` ``retrieve_ivf_sharded`` /
  ``retrieve_hybrid_sharded``), and, as the reference's, no off-mesh
  fallback.  A data-parallel encoder splits the query batch over the data
  axis as :class:`FusedRetriever`'s does (one more all-gather there).

The device work is plain PyTorch, as the reference leaves it to XLA.
Sampled tiered retrievals hand the process retrieval observatory a shadow
job holding the served query embeddings (never the text) and a salted
hash of them.
"""

from __future__ import annotations

import hashlib
import secrets
from time import perf_counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch.engines.encoder import EncoderEngine, marshal_texts
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.ivf import _probe_kernel
from docqa_tpu_torch.index.lexical import lexical_search_program
from docqa_tpu_torch.index.store import SearchResult, VectorStore
from docqa_tpu_torch.index.tiered import TAIL_BUCKET, _tail_kernel, tier_generation_of
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY, encoder_cost
from docqa_tpu_torch.runtime.mesh import in_command, mirrored
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import resolve_device, round_up

log = get_logger("docqa.retrieve")

QUERY_BATCH_BUCKETS = (1, 4, 16)

# per-process salt of the shadow jobs' query hashes: the same query gets
# the same label within a process, unlinkable across processes
_SHADOW_HASH_SALT = secrets.token_bytes(16)


def salted_query_hashes(emb) -> List[str]:
    """Salted, process-local labels of sampled query embeddings."""
    rows = np.asarray(emb, np.float32)
    return [
        hashlib.sha1(_SHADOW_HASH_SALT + row.tobytes()).hexdigest()[:12]
        for row in rows
    ]


def _encode_normalized(encoder: EncoderEngine, ids, lengths) -> torch.Tensor:
    """Encoder forward re-normalized (the store scores cosine, even when
    the encoder config skips its own normalize): [B, d] float32."""
    emb = encoder.encode_ids(ids, lengths)
    with torch.inference_mode():
        return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)


class FusedRetriever:
    """Text-in, ranked-rows-out exact retrieval over an
    :class:`EncoderEngine` (params, config, tokenizer) and a
    :class:`VectorStore` (device buffer, host metadata), on one device.
    Dense only, as the reference's: the retrieve modes belong to the
    tiered index."""

    def __init__(self, encoder: EncoderEngine, store: VectorStore, device="cuda"):
        """On a mesh the retriever runs on the store's device (the mesh's)."""
        self.device = (store.device if getattr(store, "mesh", None) is not None
                       else resolve_device(device))
        if encoder.device != self.device or store.device != self.device:
            raise ValueError(
                f"encoder on {encoder.device} and store on {store.device}; "
                f"the retriever runs on {self.device}"
            )
        self.encoder = encoder
        self.store = store

    def annotate_costs(self) -> None:
        """Register the ``retrieve`` stage's analytic cost model: the
        encoder forward plus the scores (``2·queries·rows·dim`` FLOPs, the
        scored rows read once).  Key: ``("retrieve", batch, seq, pairs,
        rows)``."""
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
        self,
        texts: Sequence[str],
        k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        deadline=None,  # resilience.Deadline: shed before the dispatch
        stage: str = "retrieve",
        stream: str = "serve",
        return_emb: bool = False,
    ) -> Any:
        """One ranked list of :class:`SearchResult` per query text over the
        live rows matching ``filters`` (patient_id / doc_type / date_from /
        date_to).  ``stage`` / ``stream`` relabel the spine item (a
        background caller passes ``("retrieve_shadow", "probe")``);
        ``return_emb=True`` returns ``(results, embeddings [n, d] float32)``,
        the normalized query embeddings of the same item.  A command on a
        mesh: the deadline is checked before it is published, and only
        the leader's item carries it."""
        if not len(texts):
            return ([], np.zeros((0, 0), np.float32)) if return_emb else []
        if deadline is not None:
            deadline.check("retrieve")
        return mirrored(self, "search_texts", self._search_texts,
                        [str(t) for t in texts], k, filters, stage=stage,
                        stream=stream, return_emb=return_emb,
                        local={"deadline": deadline})

    def _search_texts(self, texts, k=None, filters=None, stage="retrieve",
                      stream="serve", return_emb=False, deadline=None):
        store = self.store
        k = k or store.cfg.default_k
        n = len(texts)
        ids_p, len_p = marshal_texts(
            self.encoder.tokenizer, self.encoder.cfg, texts,
            batch_buckets=QUERY_BATCH_BUCKETS, n_data=self.encoder.n_data,
        )
        _tag, batch, seq, pairs = self.encoder.cost_key(ids_p, len_p)

        # one consistent snapshot: a grow or a compaction swaps in a new
        # tensor, nothing is donated
        buf, count, mask = store.search_view(filters)
        if count == 0:
            empty: List[List[SearchResult]] = [[] for _ in texts]
            if return_emb:
                return empty, np.zeros((n, self.encoder.cfg.embed_dim), np.float32)
            return empty

        def _retrieve_on_device():
            if buf.is_cuda:
                # an add or a compaction on another stream may swap in a
                # new buffer meanwhile: the allocator must not reuse this
                # one before this stream's reads of it are done
                buf.record_stream(torch.cuda.current_stream(buf.device))
            emb = _encode_normalized(self.encoder, ids_p, len_p)
            with torch.inference_mode():
                live = None if mask is None else torch.from_numpy(mask).to(self.device)
                vals, row_ids = store.search_rows(
                    buf, emb.to(buf.dtype), count, min(k, count), live
                )
            return to_host(vals[:n]), to_host(row_ids[:n]), to_host(emb[:n].float())

        span_name = "fused_query" if stage == "retrieve" else stage
        with span(span_name, DEFAULT_REGISTRY):
            vals, row_ids, emb = spine_run(
                stage, _retrieve_on_device, stream=stream, device=self.device,
                deadline=deadline, cost_key=("retrieve", batch, seq, pairs, count),
            )
        results = store.assemble_results(vals.numpy(), row_ids.numpy())
        if return_emb:
            return results, emb.numpy()
        return results


def tiered_search_program(
    encoder: EncoderEngine, ids, lengths, ivf, *, nprobe: int, fetch: int,
    tail: torch.Tensor, n_live: int, k_tail: int,
) -> Tuple[torch.Tensor, ...]:
    """The tiered retrieve program (inside a caller's spine item): encoder
    forward -> L2 normalize -> cast to the tier's dtype -> coarse probe
    over the IVF cells (this rank's block and the shards' merge on a
    mesh) -> cell and spill scores -> top-``fetch``, and the exact tail's
    top-``k_tail`` (none for ``k_tail`` 0).  Returns device tensors (bulk
    vals, bulk ids, tail vals, tail ids, embeddings)."""
    emb = _encode_normalized(encoder, ids, lengths)
    with torch.inference_mode():
        q = emb.to(ivf._centroids.dtype)
        bulk_vals, bulk_ids = _probe_kernel(
            ivf._cells, ivf._cell_scale, ivf._cell_ids, ivf._centroids,
            ivf._spill, ivf._spill_ids, q, nprobe=nprobe, k=fetch,
            n_real_cells=ivf.n_real_cells, mesh=ivf.shard_mesh,
        )
        if k_tail:
            tail_vals, tail_ids = _tail_kernel(tail, q, n_live, k_tail)
        else:  # empty tail: nothing to scan
            tail_vals = torch.zeros((q.shape[0], 0), device=q.device)
            tail_ids = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    return bulk_vals, bulk_ids, tail_vals, tail_ids, emb


def hybrid_search_program(
    encoder: EncoderEngine, ids, lengths, ivf, *, nprobe: int, fetch: int,
    tail: torch.Tensor, n_live: int, k_tail: int, lex_tiles, q_terms: torch.Tensor,
    q_weights: torch.Tensor, k_lex: int, lex_mesh=None,
) -> Tuple[torch.Tensor, ...]:
    """:func:`tiered_search_program` plus the lexical tier's top-``k_lex``
    over its device tiles ``(term_ids, impacts, row_live)`` (this rank's
    block over ``lex_mesh``, the lexical tier's mesh).  Returns (bulk vals,
    bulk ids, tail vals, tail ids, lexical vals, lexical ids, embeddings);
    fusion is host work on these candidates."""
    bulk_vals, bulk_ids, tail_vals, tail_ids, emb = tiered_search_program(
        encoder, ids, lengths, ivf, nprobe=nprobe, fetch=fetch, tail=tail,
        n_live=n_live, k_tail=k_tail,
    )
    term_ids, impacts, row_live = lex_tiles
    with torch.inference_mode():
        lex_vals, lex_ids = lexical_search_program(
            term_ids, impacts, row_live, q_terms, q_weights, k_lex, lex_mesh)
    return bulk_vals, bulk_ids, tail_vals, tail_ids, lex_vals, lex_ids, emb


class FusedTieredRetriever:
    """Text-in, ranked-rows-out over a ``TieredIndex`` in one spine item
    and one fetch: the encode, the IVF probe, the tail scan and, in hybrid
    mode, the lexical scoring.  Host work (dedup, re-rank, tombstones, the
    tier merge, its exact fallback, fusion) is ``TieredIndex``'s."""

    # search_texts takes mode= (the QA service forwards modes)
    supports_modes = True

    def __init__(self, encoder: EncoderEngine, tiered, device="cuda"):
        """On a mesh the retriever runs on the store's device (the mesh's)."""
        store = tiered.store
        self.device = (store.device if getattr(store, "mesh", None) is not None
                       else resolve_device(device))
        if encoder.device != self.device or tiered.device != self.device:
            raise ValueError(
                f"encoder on {encoder.device} and tier on {tiered.device}; "
                f"the retriever runs on {self.device}"
            )
        self.encoder = encoder
        self.tiered = tiered
        self._exact = FusedRetriever(encoder, store, device=self.device)

    def search_texts(
        self,
        texts: Sequence[str],
        k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        deadline=None,  # resilience.Deadline: shed before the dispatch
        mode: Optional[str] = None,
        plan: Optional[Dict[str, Any]] = None,
    ) -> List[List[SearchResult]]:
        """``TieredIndex.search``'s contract from raw texts; ``mode`` is
        dense (default), lexical or hybrid.  A command on a mesh: ``plan``
        carries the leader's decisions (:meth:`plan`), and the deadline is
        checked before it is published, never after (once published, the
        leader issues every collective its followers do)."""
        tiered = self.tiered
        tiered.raise_rebuild_fault()
        if not len(texts):
            return []
        if deadline is not None:
            deadline.check("retrieve")
        texts = [str(t) for t in texts]
        return mirrored(self, "search_texts", self._search_texts, texts, k, filters,
                        mode=mode, plan=plan, local={"deadline": deadline},
                        decide=lambda: self.plan(texts, k, filters, mode))

    def plan(self, texts, k, filters, mode) -> Dict[str, Any]:
        """The leader's host decisions for one retrieval, at the state its
        command will find: the resolved mode, the generation of the tier
        it reads, and for a tiered read its ``covered``, ``nprobe``,
        ``fetch`` and ``k_tail``."""
        # one read: (ivf, covered) stay consistent
        return self._plan_for(self.tiered._tier, texts, k, filters, mode)

    def _plan_for(self, tier, texts, k, filters, mode) -> Dict[str, Any]:
        tiered = self.tiered
        store = tiered.store
        out: Dict[str, Any] = {"mode": tiered._resolve_mode(mode, texts, filters),
                               "gen": tier_generation_of(tier)}
        if tier is not None and not filters and out["mode"] != "lexical":
            ivf, covered = tier
            k = k or store.cfg.default_k
            k_bulk = tiered._k_bulk(k, covered)
            # one nprobe read: pool and fetch must come from the same value
            nprobe = min(ivf.nprobe, ivf.n_clusters)
            pool = nprobe * ivf.cap + int(ivf._spill_ids.shape[0])
            bucket = round_up(max(store.count - covered, 1), TAIL_BUCKET)
            out.update(covered=covered, nprobe=nprobe,
                       fetch=min(min(k_bulk, ivf.n) * (ivf.n_assign + 1), pool),
                       # the reference's quantized k, bounded by the padded bucket
                       k_tail=min(max(k_bulk, k), bucket))
        return out

    def _search_texts(self, texts, k=None, filters=None, mode=None, plan=None,
                      deadline=None) -> List[List[SearchResult]]:
        if in_command():
            # published: the leader issues the command's collectives as its
            # followers do, whatever is left of its budget
            deadline = None
        tiered = self.tiered
        store = tiered.store
        k = k or store.cfg.default_k
        tier = tiered._tier  # one read: (ivf, covered) stay consistent
        if plan["gen"] != tier_generation_of(tier):
            tiered.check_plan(plan)  # raises on a command stream
            plan = self._plan_for(tier, texts, k, filters, mode)  # a local switch landed
        mode = plan["mode"]
        DEFAULT_REGISTRY.counter(f"retrieve_mode_{mode}").inc()
        if mode == "lexical":
            return tiered._search_lexical(texts, k)
        lex_tiles = None
        if mode == "hybrid":
            lex_tiles = tiered.lexical.device_tiles()
            if lex_tiles is None:  # empty lexical tier: nothing to fuse
                mode = "dense"
        tiered._maybe_background_rebuild()
        if tier is None or filters:
            if mode == "hybrid":
                seen_count = store.count
                dense, emb = self._exact.search_texts(
                    texts, k=k, deadline=deadline, return_emb=True
                )
                out = tiered._fuse_rows(dense, tiered.lexical.search(texts, k=k), k)
                tiered._observe_hybrid(emb, texts, out, k, seen_count)
                return out
            return self._exact.search_texts(texts, k=k, filters=filters, deadline=deadline)
        ivf, covered = tier
        nprobe, fetch, k_tail = plan["nprobe"], plan["fetch"], plan["k_tail"]

        n = len(texts)
        ids_p, len_p = marshal_texts(
            self.encoder.tokenizer, self.encoder.cfg, texts,
            batch_buckets=QUERY_BATCH_BUCKETS, n_data=self.encoder.n_data,
        )
        _tag, batch, seq, pairs = self.encoder.cost_key(ids_p, len_p)
        k_bulk = tiered._k_bulk(k, covered)
        _, _, tail_dev, n_live, tail_meta = tiered._tail_device(covered)
        lex_count = 0
        if mode == "hybrid":
            term_ids, impacts, row_live, lex_count = lex_tiles
            q_terms, q_weights = tiered.lexical.encode_queries(texts)
            k_lex = min(k, lex_count)
        if deadline is not None:  # marshal and the tail may have eaten it
            deadline.check("retrieve_dispatch")

        def _tiered_on_device():
            if mode == "hybrid":
                out = hybrid_search_program(
                    self.encoder, ids_p, len_p, ivf, nprobe=nprobe, fetch=fetch,
                    tail=tail_dev, n_live=n_live, k_tail=k_tail,
                    lex_tiles=(term_ids, impacts, row_live),
                    q_terms=torch.from_numpy(q_terms).to(self.device),
                    q_weights=torch.from_numpy(q_weights).to(self.device),
                    k_lex=k_lex, lex_mesh=tiered.lexical.mesh,
                )
            else:
                out = tiered_search_program(
                    self.encoder, ids_p, len_p, ivf, nprobe=nprobe, fetch=fetch,
                    tail=tail_dev, n_live=n_live, k_tail=k_tail,
                )
            return tuple(to_host(t[:n].float() if t.is_floating_point() else t[:n])
                         for t in out)

        rows_scored = nprobe * ivf.cap + int(ivf._spill_ids.shape[0]) + int(
            tail_dev.shape[0] if k_tail else 0
        )
        seen_count = store.count  # the hybrid shadow's horizon
        t_probe = perf_counter()
        with span("fused_tiered_query", DEFAULT_REGISTRY):
            fetched = spine_run(
                "retrieve", _tiered_on_device, device=self.device, deadline=deadline,
                cost_key=("retrieve", batch, seq, pairs, rows_scored),
            )
        fetched = [t.numpy() for t in fetched]
        bulk_vals, bulk_ids, tail_vals, tail_ids = fetched[:4]
        emb = fetched[-1]
        # one item holds encode, probe and tail: only their sum is observable
        DEFAULT_REGISTRY.histogram("retrieve_tier_ms_fused_probe").observe(
            (perf_counter() - t_probe) * 1e3
        )

        t_merge = perf_counter()
        # the full candidate pool: the re-rank recovers rows the int8
        # ranking pushed past k_bulk
        bulk_rows = ivf.dedup_rows(bulk_vals, bulk_ids, fetch)
        bulk_rows = tiered._rerank_bulk(emb, bulk_rows, ivf, k_bulk)
        out = tiered._merge(
            _FallbackQueries(self.encoder, texts), bulk_rows, tail_vals, tail_ids,
            tail_meta, covered, k,
        )
        DEFAULT_REGISTRY.histogram("retrieve_tier_ms_merge").observe(
            (perf_counter() - t_merge) * 1e3
        )
        if mode == "hybrid":
            lex_vals, lex_ids = fetched[4], fetched[5]
            lex_rows = [
                [(float(s), int(rid)) for s, rid in zip(lex_vals[qi], lex_ids[qi])
                 if s > 0.0 and 0 <= rid < lex_count]
                for qi in range(n)
            ]
            out = tiered._fuse_rows(out, lex_rows, k)
            tiered._observe_hybrid(emb, texts, out, k, seen_count)
            return out
        tiered._observe_quality(
            emb, out, ivf, covered, covered + n_live, k, nprobe,
            tier="tiered_fused", attrs={"query_hashes": salted_query_hashes(emb)},
        )
        return out


class _FallbackQueries:
    """Lazy query embeddings for ``TieredIndex._merge``'s under-fill
    fallback, which reads ``len()`` and, rarely, ``[short]``: only those
    queries are encoded, and only then."""

    def __init__(self, encoder, texts: Sequence[str]):
        self._encoder = encoder
        self._texts = list(texts)

    def __len__(self) -> int:
        return len(self._texts)

    def __getitem__(self, idx) -> np.ndarray:
        texts = [self._texts[i] for i in idx]
        return np.asarray(self._encoder.encode_texts(texts), np.float32)
