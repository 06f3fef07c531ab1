"""Tiered serving index: IVF over the bulk of the store plus an exact scan
of the tail, counterpart of ``docqa_tpu/index/tiered.py``.

The live ``VectorStore`` stays the source of truth (appends, metadata,
filters, tombstones).  An ``IVFIndex`` is rebuilt from a consistent
snapshot and serves the rows it covers; rows appended since (the tail) are
scored exactly, so a row is findable the moment it lands.

* unfiltered: the IVF probe over the bulk, its candidates re-ranked at full
  precision against the store's host copy (int8 tiers), plus the exact
  top-k of the tail, merged on the host;
* filtered, or before the store reaches ``min_rows``: the exact store;
* modes (``mode=``): ``dense`` (the tiers above), ``lexical`` (the lexical
  tier alone) and ``hybrid`` (both, fused by ``engines.router.
  fuse_scores``), with the reference's fallback to dense when no lexical
  tier is wired, no query texts are given or a filter is set;
* rebuild: once the tail outgrows ``rebuild_tail_rows`` a background
  thread rebuilds from ``store.vectors_snapshot()`` and publishes ``(ivf,
  covered)`` as one reference; serving never waits for it.

Each tiered search offers the process retrieval observatory a shadow job
(``obs/retrieval_observatory.py``).

On a mesh (the store's ``mesh``) the tier shards where the store shards:
its cells ride the model axis (``index/ivf.py``), the tail stays
replicated (each rank uploads it from its own host copy and scans it with
no collective).  A rebuild is split so that no rank builds a tier of its
own and nothing holds the mesh slot for a build's host work: the leader
snapshots and runs k-means (:func:`~docqa_tpu_torch.index.ivf.fit_cells`)
outside any command, the short command :meth:`TieredIndex.stage` hands
every rank its centroids and each row's ranked cells, every rank then
places the rows and quantizes and uploads its own cells on its own thread
(a follower's ``ivf-stage``), the ranks agree over a gloo group of their
own that every shard is ready, and the short command
:meth:`TieredIndex.switch` swaps the tier on every rank at the same point
of the order, bumping :attr:`TieredIndex.tier_generation`.  Registered with
a mesh's command stream, :meth:`~TieredIndex.search`, :meth:`~TieredIndex.
reset` and those two are commands, and each tier is a command target
(``<name>.ivf#<generation>``) for the frontier probe; the leader's host
decisions (the resolved mode, ``nprobe``, the tier generation) ride in a
search command's ``plan``, so a follower never reads its own knobs.  In a
world of ranks only the leader of a live command stream rebuilds: a
follower never does, nor does any rank during the boot or without a
stream.

One difference from the reference: its rebuild thread logs and drops every
exception.  Here a kernel or CUDA fault (``ops/_kernels.is_device_fault``)
in the rebuild is kept and raised by the next :meth:`TieredIndex.search`
(and ``FusedTieredRetriever.search_texts``) and by :meth:`TieredIndex.close`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from datetime import timedelta
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from docqa_tpu_torch.engines.router import fuse_scores
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.ivf import IVFIndex, fit_cells, l2_rows
from docqa_tpu_torch.index.store import NEG_INF, SearchResult, VectorStore, _normalized
from docqa_tpu_torch.obs.retrieval_observatory import (
    ShadowJob,
    get_retrieval_observatory,
)
from docqa_tpu_torch.ops._kernels import MeshFault, is_device_fault
from docqa_tpu_torch.runtime.mesh import all_reduce, mirrored
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import round_up

log = get_logger("docqa.tiered")

MODES = ("dense", "lexical", "hybrid")
# rows of the tail's device bucket grow in these steps
TAIL_BUCKET = 4096
# the ranks' agreement on a staged build waits this long for the slowest
# rank's host work (a 1M-row build's placement and quantize take ~20 s)
STAGE_TIMEOUT = timedelta(hours=1)


def _tail_kernel(tail: torch.Tensor, queries: torch.Tensor, n_live: int,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k over the padded tail bucket [T, d]: float32
    scores, rows at or past ``n_live`` masked to ``NEG_INF``."""
    scores = queries.float() @ tail.float().T  # [q, T]
    scores[:, n_live:] = NEG_INF
    return torch.topk(scores, k, dim=1)


def tier_generation_of(tier: Optional[tuple]) -> Optional[int]:
    """The generation of a served ``(ivf, covered)`` pair (None: no tier)."""
    return None if tier is None else tier[0].generation


@dataclass
class _Stage:
    """A rebuild's decisions as :meth:`TieredIndex.stage` hands them to
    every rank, and this rank's build of its shard."""

    id: int
    gen: int
    comp_gen: int
    covered: int
    centroids: np.ndarray
    assign: np.ndarray
    nprobe: int
    ivf: Optional[IVFIndex] = None
    thread: Optional[threading.Thread] = None


class TieredIndex:
    """Serving facade over (VectorStore, IVFIndex) with the store's search
    signature, for ``QAService``.  The tier lives on the store's device,
    sharded over the store's mesh (module docstring)."""

    # search() takes mode= and query_texts= (the QA service forwards modes)
    supports_modes = True

    def __init__(
        self,
        store: VectorStore,
        nprobe: int = 8,
        min_rows: int = 50_000,
        rebuild_tail_rows: int = 100_000,
        n_clusters: Optional[int] = None,
        seed: int = 0,
        storage: str = "int8",
        lexical=None,  # index.lexical.LexicalIndex fed by the store
        hybrid_alpha: float = 0.6,
        default_mode: str = "dense",
    ) -> None:
        """On a mesh of more than one rank every rank builds it at the same
        point (it makes a gloo group)."""
        self.store = store
        self.device = store.device
        self.nprobe = nprobe
        self.min_rows = min_rows
        self.rebuild_tail_rows = rebuild_tail_rows
        self.n_clusters = n_clusters
        self.seed = seed
        self.lexical = lexical
        self.hybrid_alpha = float(hybrid_alpha)
        self.default_mode = default_mode
        self.storage = storage
        # (IVFIndex, covered rows), published as one reference so a reader
        # never pairs an old IVF with a new watermark
        self._tier: Optional[tuple] = None
        # bumped by every switch, at the same command on every rank
        self._tier_gen = 0
        self._rebuild_lock = threading.Lock()
        # one rebuild at a time on the rank that decides them
        self._build_lock = threading.Lock()
        self._rebuilding = False
        self._rebuild_thread: Optional[threading.Thread] = None
        # the kernel or CUDA fault a background rebuild stopped on
        self._rebuild_fault: Optional[BaseException] = None
        # bumped by reset(): a rebuild begun before it must not publish
        self._gen = 0
        self._stage_seq = 0
        self._staged: Optional[_Stage] = None
        # (covered, count, tail_dev, n_live, meta), rebuilt when the store grows
        self._tail_cache: Optional[tuple] = None
        # the ranks of a world agree on each staged build over their own group
        self._agree_group = None
        if store.mesh is not None and dist.is_initialized() and dist.get_world_size() > 1:
            self._agree_group = dist.new_group(backend="gloo", timeout=STAGE_TIMEOUT)

    # ---- rebuild -------------------------------------------------------------

    @property
    def covered(self) -> int:
        tier = self._tier
        return tier[1] if tier else 0

    @property
    def tail_rows(self) -> int:
        return self.store.count - self.covered

    @property
    def tier_generation(self) -> int:
        """How many tiers this index switched to (equal on every rank)."""
        return self._tier_gen

    def _stream(self):
        return getattr(self, "_command_stream", None)

    def _follows(self) -> bool:
        """A follower of a command stream: its tier changes only by the
        leader's commands."""
        stream = self._stream()
        return stream is not None and stream.follower

    def _decides(self) -> bool:
        """Whether this rank decides rebuilds: never a follower; in a world
        of ranks only the leader of a live command stream."""
        stream = self._stream()
        if stream is not None and stream.follower:
            return False
        return self._agree_group is None or (stream is not None and stream.live)

    def rebuild(self) -> bool:
        """Synchronous rebuild from a consistent snapshot; whether a tier is
        now active (False below ``min_rows``: exact search is optimal
        there).  On a mesh every rank builds its shard from the k-means
        decisions of the leader (module docstring), which alone calls it
        in a world of ranks."""
        if not self._decides():
            raise RuntimeError("in a world of ranks only the leader of a live command "
                               "stream rebuilds the tier")
        with self._build_lock:
            return self._rebuild()

    def _rebuild(self) -> bool:
        gen = self._gen
        # read before the snapshot: a compaction between the two makes the
        # re-rank guard skip the re-rank instead of reading renumbered rows
        comp_gen = self.store.compactions
        vectors, meta = self.store.vectors_snapshot()
        if len(vectors) < self.min_rows:
            return self._tier is not None
        with span("tiered_rebuild", DEFAULT_REGISTRY):
            t0 = perf_counter()
            c = self.n_clusters or max(1, int(np.sqrt(len(vectors))))
            timings: Dict[str, float] = {}
            fit = fit_cells(l2_rows(vectors), c, seed=self.seed, device=self.device,
                            timings=timings)
            self._stage_seq += 1
            stage_id = self._stage_seq
            self.stage(stage_id, gen, comp_gen, len(vectors), fit[0], fit[1], int(self.nprobe))
            if not self._build_stage(vectors, meta):
                raise RuntimeError("a rank's shard of the staged tier failed to build")
            ivf = self._staged.ivf
            ivf.build_seconds = {**timings, **ivf.build_seconds,
                                 "total": perf_counter() - t0}
        if not self.switch(stage_id):
            return self._tier is not None
        log.info("tiered: ivf tier now covers %d rows", len(vectors))
        return True

    def stage(self, stage_id: int, gen: int, comp_gen: int, covered: int,
              centroids: np.ndarray, assign: np.ndarray, nprobe: int) -> None:
        """Hand every rank a rebuild's decisions: the snapshot's reset and
        compaction generations, its row count, the centroids and each row's
        ranked cells.  A follower builds its shard on its own thread; the
        caller of :meth:`rebuild` builds on its own.  A command on a
        mesh."""
        mirrored(self, "stage", self._stage, int(stage_id), int(gen), int(comp_gen),
                 int(covered), np.asarray(centroids, np.float32),
                 np.asarray(assign, np.int32), int(nprobe))

    def _stage(self, stage_id, gen, comp_gen, covered, centroids, assign, nprobe) -> None:
        st = _Stage(stage_id, gen, comp_gen, covered, centroids, assign, nprobe)
        self._staged = st
        if self._follows():
            st.thread = threading.Thread(target=self._follow_stage, args=(st,),
                                         daemon=True, name="ivf-stage")
            st.thread.start()

    def _follow_stage(self, st: _Stage) -> None:
        try:
            self._build_stage(None, None, st)
        except Exception as e:
            if is_device_fault(e):
                self._rebuild_fault = e
                log.error("tier stage stopped on a device fault: %r", e)
            else:
                log.exception("tier stage failed")

    def _build_stage(self, vectors, meta, st: Optional[_Stage] = None) -> bool:
        """Build this rank's shard of the staged tier (a follower snapshots
        the rows the leader did), then, in a world of ranks, agree with
        every rank that each one's shard is ready.  Returns whether all
        are; this rank's own failure raises."""
        st = st or self._staged
        ok, error = False, None
        try:
            if vectors is None:
                with self.store._lock:
                    if self.store.compactions != st.comp_gen:
                        raise RuntimeError("the rows were renumbered since the stage")
                    vectors, meta = self.store.vectors_snapshot(stop=st.covered)
            ivf = IVFIndex(
                vectors, meta, n_clusters=len(st.centroids), nprobe=st.nprobe,
                seed=self.seed, dtype=str(self.store.cfg.dtype), storage=self.storage,
                device=self.device, mesh=self.store.mesh, fit=(st.centroids, st.assign),
            )
            ivf._store_compactions = st.comp_gen
            st.ivf = ivf
            ok = True
        except Exception as e:
            error = e
        if self._agree_group is not None:
            flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
            ok = bool(all_reduce(flag, self._agree_group, "ivf_stage",
                                 op=dist.ReduceOp.MIN).item())
        if error is not None:
            raise error
        return ok

    def switch(self, stage_id: int) -> bool:
        """Make the staged tier the served one on every rank, unless a
        :meth:`reset` came after its snapshot; whether it switched.  A
        command on a mesh."""
        return mirrored(self, "switch", self._switch, int(stage_id))

    def _switch(self, stage_id: int) -> bool:
        st = self._staged
        if st is None or st.id != stage_id:
            raise MeshFault(f"switch to stage {stage_id}: this rank staged "
                            f"{None if st is None else st.id}")
        if st.thread is not None:
            st.thread.join()  # past the agreement: ending
        with self._rebuild_lock:
            self._staged = None
            if st.gen != self._gen or st.ivf is None:
                log.info("discarding rebuild begun before reset()")
                return False
            old = self._tier
            self._tier_gen += 1
            st.ivf.generation = self._tier_gen
            self._tier = (st.ivf, st.covered)
        stream = self._stream()
        if stream is not None:
            if old is not None:
                stream.unregister(old[0])
            stream.register(f"{self._command_name}.ivf#{self._tier_gen}", st.ivf)
        return True

    def _maybe_background_rebuild(self) -> None:
        if not self._decides():
            return
        if self.tail_rows < self.rebuild_tail_rows and self._tier is not None:
            return
        if self.store.count < self.min_rows:
            return
        with self._rebuild_lock:
            if self._rebuilding:
                return
            self._rebuilding = True

        def run():
            try:
                self.rebuild()
            except Exception as e:
                if is_device_fault(e):
                    self._rebuild_fault = e
                    log.error("tiered rebuild stopped on a device fault: %r", e)
                else:
                    log.exception("tiered rebuild failed")
            finally:
                with self._rebuild_lock:
                    self._rebuilding = False

        t = threading.Thread(target=run, daemon=True, name="ivf-rebuild")
        self._rebuild_thread = t
        t.start()

    def raise_rebuild_fault(self) -> None:
        """Raise the device fault a background rebuild stopped on, if any."""
        fault = self._rebuild_fault
        if fault is not None:
            raise fault

    @property
    def rebuilding(self) -> bool:
        return self._rebuilding

    def close(self, timeout: float = 60.0) -> None:
        """Join an in-flight background rebuild or stage (bounded: a
        legitimate rebuild at millions of rows takes minutes), then raise
        the device fault one stopped on."""
        staged = self._staged
        for t in (self._rebuild_thread, staged and staged.thread):
            if t is not None and t.is_alive():
                t.join(timeout=timeout)
                if t.is_alive():
                    log.warning("%s still alive after close() join", t.name)
        self.raise_rebuild_fault()

    # ---- search --------------------------------------------------------------

    def _k_bulk(self, k: int, covered: int) -> int:
        """The IVF tier's candidate count: tombstones are dropped on the
        host after top-k, so with deletions the fetch grows to 2k (up to a
        quarter deleted) or 4k, the reference's quantized ladder; the
        merge's exact fallback covers tombstones clustered at the top."""
        deleted_frac = self.store.deleted_count / max(self.store.count, 1)
        if deleted_frac == 0:
            return k
        if deleted_frac <= 0.25:
            return min(covered, 2 * k)
        return min(covered, 4 * k)

    def _rerank_active(self, ivf: IVFIndex) -> bool:
        """The exact host re-rank applies to int8 tiers whose row ids still
        address the store's host copy (no compaction since the build)."""
        return (
            ivf.storage == "int8"
            and getattr(ivf, "_store_compactions", None) == self.store.compactions
        )

    def _rerank_order(self, qn_row: np.ndarray, ids: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Float32 cosines of ``ids`` against one normalized query from the
        store's host copy, and their descending order cut to ``k``: the one
        re-rank core of serving and of the frontier probe."""
        scores = self.store.host_rows(ids) @ qn_row
        return np.argsort(-scores)[:k], scores

    def _rerank_bulk(self, queries_n: np.ndarray, bulk: List[List[tuple]],
                     ivf: IVFIndex, k_bulk: int) -> List[List[tuple]]:
        """Exact float32 re-rank of the int8 tier's candidates, cut back to
        ``k_bulk``: the quantization decides which candidates surface, the
        served scores and order are full precision."""
        if not self._rerank_active(ivf):
            return [row[:k_bulk] for row in bulk]
        out: List[List[tuple]] = []
        for qi, row in enumerate(bulk):
            if not row:
                out.append(row)
                continue
            ids = np.fromiter((rid for _s, rid, _m in row), np.int64, len(row))
            order, scores = self._rerank_order(queries_n[qi], ids, k_bulk)
            out.append([(float(scores[j]), row[j][1], row[j][2]) for j in order])
        return out

    def _merge(self, queries, bulk: List[List[tuple]], tail_vals: np.ndarray,
               tail_ids: np.ndarray, tail_meta: List[Dict[str, Any]],
               covered: int, k: int) -> List[List[SearchResult]]:
        """Host tier merge: tombstones dropped, score sort, and the exact
        store for a query left with fewer than ``k`` rows (tombstones at
        the top of its ranking)."""
        out: List[List[SearchResult]] = []
        short: List[int] = []
        for qi in range(len(queries)):
            cands: List[SearchResult] = [
                SearchResult(s, rid, md) for s, rid, md in bulk[qi]
                if not md.get("deleted")
            ]
            for s, tid in zip(tail_vals[qi], tail_ids[qi]):
                if s <= NEG_INF / 2:
                    continue
                md = tail_meta[int(tid)]
                if md.get("deleted"):
                    continue
                cands.append(SearchResult(float(s), covered + int(tid), md))
            cands.sort(key=lambda r: -r.score)
            out.append(cands[:k])
            if len(cands) < k:
                short.append(qi)
        if short and (self.store.count - self.store.deleted_count) > 0:
            exact = self.store.search(queries[short], k=k)
            for j, qi in enumerate(short):
                if len(exact[j]) > len(out[qi]):
                    out[qi] = exact[j]
        return out

    def search(
        self,
        queries: np.ndarray,
        k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        mode: Optional[str] = None,
        query_texts: Optional[List[str]] = None,
        plan: Optional[Dict[str, Any]] = None,
    ) -> List[List[SearchResult]]:
        """Mode-aware retrieval of host query vectors (module docstring);
        lexical evidence needs ``query_texts``.  A command on a mesh:
        ``plan`` carries the leader's decisions (:meth:`plan`)."""
        self.raise_rebuild_fault()
        return mirrored(self, "search", self._search, np.asarray(queries, np.float32), k,
                        filters, mode, None if query_texts is None else list(query_texts),
                        plan=plan, decide=lambda: self.plan(mode, query_texts, filters))

    def plan(self, mode: Optional[str], query_texts, filters) -> Dict[str, Any]:
        """The leader's host decisions for one search: the resolved mode,
        the serving ``nprobe`` and the tier generation it reads."""
        return {"mode": self._resolve_mode(mode, query_texts, filters),
                "nprobe": int(self.nprobe), "gen": tier_generation_of(self._tier)}

    def check_plan(self, plan: Dict[str, Any]) -> None:
        """On a command stream every rank reads the tier the plan names (a
        switch is a command); anything else is a mesh out of step.  With
        no stream a background switch may land in between, and the search
        serves the tier it reads."""
        here = tier_generation_of(self._tier)
        if plan["gen"] != here and self._stream() is not None:
            raise MeshFault(f"tier generation {here} here, the leader planned on "
                            f"{plan['gen']}")

    def _search(self, queries, k=None, filters=None, mode=None, query_texts=None,
                plan=None) -> List[List[SearchResult]]:
        self.check_plan(plan)
        k_final = k or self.store.cfg.default_k
        mode = plan["mode"]
        DEFAULT_REGISTRY.counter(f"retrieve_mode_{mode}").inc()
        if mode == "lexical":
            return self._search_lexical(query_texts, k_final)
        dense = self._search_dense(queries, k, filters, observe=mode == "dense",
                                   nprobe=plan["nprobe"])
        if mode == "dense":
            return dense
        return self._fuse_hybrid(queries, query_texts, dense, k_final)

    def _resolve_mode(self, mode, query_texts, filters) -> str:
        mode = mode or self.default_mode
        if mode not in MODES:
            log.warning("unknown retrieve mode %r; serving dense", mode)
            mode = "dense"
        if mode != "dense" and (self.lexical is None or query_texts is None or filters):
            DEFAULT_REGISTRY.counter("retrieve_mode_fallback").inc()
            return "dense"
        return mode

    def _search_dense(self, queries: np.ndarray, k: Optional[int],
                      filters: Optional[Dict[str, Any]], observe: bool, nprobe: int
                      ) -> List[List[SearchResult]]:
        self._maybe_background_rebuild()
        tier = self._tier  # one read: (ivf, covered) stay consistent
        if tier is None or filters:
            return self.store.search(queries, k=k, filters=filters)
        ivf, covered = tier
        k = k or self.store.cfg.default_k
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        k_bulk = self._k_bulk(k, covered)
        with span("tiered_search", DEFAULT_REGISTRY):
            t_stage = perf_counter()
            qn = _normalized(queries)
            bulk = ivf.search(queries, k=k_bulk, nprobe=nprobe, dedup_full=True)
            bulk = self._rerank_bulk(qn, bulk, ivf, k_bulk)
            DEFAULT_REGISTRY.histogram("retrieve_tier_ms_bulk_ivf").observe(
                (perf_counter() - t_stage) * 1e3
            )
            _, _, tail_dev, n_live, tail_meta = self._tail_device(covered)
            t_stage = perf_counter()
            if n_live == 0:
                vals = np.empty((len(queries), 0), np.float32)
                ids = np.empty((len(queries), 0), np.int64)
            else:
                # the reference's quantized k (not clamped to n_live: rows
                # past it are masked and dropped in the merge)
                k_tail = min(max(k_bulk, k), int(tail_dev.shape[0]))

                def _tail_on_device():
                    q = torch.from_numpy(qn).to(self.device, tail_dev.dtype)
                    v, i = _tail_kernel(tail_dev, q, n_live, k_tail)
                    return to_host(v), to_host(i)

                v, i = spine_run("tiered_tail", _tail_on_device, device=self.device)
                vals, ids = v.numpy(), i.numpy()
            DEFAULT_REGISTRY.histogram("retrieve_tier_ms_tail_exact").observe(
                (perf_counter() - t_stage) * 1e3
            )
        t_stage = perf_counter()
        out = self._merge(queries, bulk, vals, ids, tail_meta, covered, k)
        DEFAULT_REGISTRY.histogram("retrieve_tier_ms_merge").observe(
            (perf_counter() - t_stage) * 1e3
        )
        if observe:
            # lexical and hybrid modes submit their own shadow jobs
            self._observe_quality(
                queries, out, ivf, covered, covered + n_live, k, nprobe
            )
        return out

    # ---- lexical / hybrid ----------------------------------------------------

    def _search_lexical(self, texts: List[str], k: int) -> List[List[SearchResult]]:
        """The lexical tier's top-k on the store's metadata (one row-id
        space through the index sink), tombstones dropped."""
        out: List[List[SearchResult]] = []
        for row in self.lexical.search(texts, k=k):
            res = []
            for score, rid in row:
                md = self.store.row_metadata(rid)
                if md is None or md.get("deleted"):
                    continue
                res.append(SearchResult(float(score), rid, md))
            out.append(res)
        self._observe_lexical(texts, out, k)
        return out

    def _fuse_hybrid(self, queries: np.ndarray, texts: List[str],
                     dense: List[List[SearchResult]], k: int) -> List[List[SearchResult]]:
        """Hybrid: the dense rows above fused with the lexical tier's."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        seen_count = self.store.count  # the shadow's horizon
        t_stage = perf_counter()
        lex = self.lexical.search(texts, k=k)
        DEFAULT_REGISTRY.histogram("retrieve_tier_ms_lexical").observe(
            (perf_counter() - t_stage) * 1e3
        )
        out = self._fuse_rows(dense, lex, k)
        self._observe_hybrid(queries, texts, out, k, seen_count)
        return out

    def _fuse_rows(self, dense: List[List[SearchResult]],
                   lex: List[List[Tuple[float, int]]], k: int) -> List[List[SearchResult]]:
        """:func:`fuse_scores` over each query's dense and lexical
        candidates, cut to ``k`` after dropping tombstones: the fusion of
        this class's path and of ``FusedTieredRetriever``'s."""
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

    # ---- the retrieval observatory's hooks -----------------------------------

    def _observe_lexical(self, texts: List[str], out: List[List[SearchResult]],
                         k: int) -> None:
        """Lexical shadow: ground truth is the exact host scoring
        (``LexicalIndex.host_topk``), computed now, so the queued job holds
        row/score pairs and no text."""
        robs = get_retrieval_observatory()
        if robs is None or not robs.sample():
            return
        served = [[(r.row_id, r.score) for r in row] for row in out]
        reference = self.lexical.host_topk(texts, k)

        def shadow_fn():
            return [list(row) for row in reference], None

        robs.submit(ShadowJob(tier="lexical", nprobe=0, k=k, served=served,
                              shadow_fn=shadow_fn))

    def _observe_hybrid(self, queries: np.ndarray, texts: List[str],
                        out: List[List[SearchResult]], k: int,
                        seen_count: int) -> None:
        """Hybrid shadow: the store's exact scan fused with the lexical
        tier's exact host scoring under the serving alpha.  The lexical
        half is computed now (no text in the job); the dense half runs on
        the background probe stream."""
        robs = get_retrieval_observatory()
        if robs is None or not robs.sample():
            return
        served = [[(r.row_id, r.score) for r in row] for row in out]
        alpha = self.hybrid_alpha
        lex_ref = self.lexical.host_topk(texts, k, count_cap=seen_count)
        q_copy = np.array(queries, np.float32, copy=True)
        store = self.store

        def shadow_fn():
            rows = store.shadow_search(q_copy, k, count_cap=seen_count)
            fused = []
            for qi, row in enumerate(rows):
                dense_pairs = [(r.score, r.row_id) for r in row]
                lrow = [(s, rid) for rid, s in (lex_ref[qi] if qi < len(lex_ref) else [])]
                fused.append(
                    [(rid, s) for s, rid in fuse_scores(dense_pairs, lrow, alpha, k=k)]
                )
            return fused, q_copy

        robs.submit(ShadowJob(
            tier="hybrid", nprobe=0, k=k, served=served, shadow_fn=shadow_fn,
            query_norms=[float(x) for x in np.linalg.norm(q_copy, axis=1)],
            attrs={"alpha": alpha},
        ))

    def _observe_quality(self, queries: np.ndarray, out: List[List[SearchResult]],
                         ivf: IVFIndex, covered: int, seen_count: int, k: int,
                         nprobe: int, tier: str = "tiered",
                         attrs: Optional[Dict[str, Any]] = None) -> None:
        """Dense shadow: the served top-k with closures for the exact ground
        truth (the store's scan, capped at the rows this query could see)
        and the neighbour-nprobe frontier probes.  ``queries`` are
        embeddings, never text."""
        robs = get_retrieval_observatory()
        if robs is None or not robs.sample():
            return
        served = [[(r.row_id, r.score) for r in row] for row in out]
        margins = [row[0].score - row[-1].score for row in out if len(row) >= 2]
        q_copy = np.array(queries[: len(out)], np.float32, copy=True)
        store = self.store

        def shadow_fn():
            rows = store.shadow_search(q_copy, k, count_cap=seen_count)
            return [[(r.row_id, r.score) for r in row] for row in rows], q_copy

        robs.submit(ShadowJob(
            tier=tier,
            # the nprobe the served probe used, not a racing set_nprobe's
            nprobe=int(min(nprobe, ivf.n_clusters)),
            k=k,
            served=served,
            shadow_fn=shadow_fn,
            frontier_fn=lambda qn, p: self._frontier_probe(ivf, qn, k, p),
            covered=covered,
            n_clusters=ivf.n_clusters,
            query_norms=[float(x) for x in np.linalg.norm(q_copy, axis=1)],
            served_margins=margins,
            attrs=dict(attrs or {}),
        ))

    def _frontier_probe(self, ivf: IVFIndex, queries, k: int, nprobe: int):
        """One frontier probe with serving semantics: the widened pool and
        the int8 tier's exact re-rank, so the frontier reads what
        ``search`` would serve at that nprobe.  ``seconds`` is the probe's
        device time."""
        rows, seconds, fresh = ivf.timed_probe(queries, k=k, nprobe=nprobe,
                                               dedup_full=True)
        if not self._rerank_active(ivf):
            return [r[:k] for r in rows], seconds, fresh
        qn = _normalized(queries)
        out = []
        for qi, row in enumerate(rows):
            if not row:
                out.append(row)
                continue
            ids = np.fromiter((rid for rid, _s in row), np.int64, len(row))
            order, scores = self._rerank_order(qn[qi], ids, k)
            out.append([(int(ids[j]), float(scores[j])) for j in order])
        return out, seconds, fresh

    # ---- knobs and state -----------------------------------------------------

    def set_nprobe(self, nprobe: int) -> int:
        """Apply a serving nprobe live (the observatory's auto-apply hook
        and the operator's knob); later rebuilds inherit it.  On a mesh it
        is the leader's: each search command carries it."""
        n = max(1, int(nprobe))
        tier = self._tier
        self.nprobe = n
        if tier is not None:
            tier[0].nprobe = min(n, tier[0].n_clusters)
        log.info("tiered: serving nprobe set to %d", n)
        return n

    def reset(self) -> None:
        """Drop the tier and the tail cache (exact search until the next
        rebuild); required after ``store.compact_deleted``.  A rebuild in
        flight discards itself.  A command on a mesh, so the reset
        generation moves on every rank at once."""
        mirrored(self, "reset", self._reset)

    def _reset(self) -> None:
        with self._rebuild_lock:
            self._gen += 1
            old = self._tier
            self._tier = None
            self._tail_cache = None
        stream = self._stream()
        if stream is not None and old is not None:
            stream.unregister(old[0])

    def _tail_device(self, covered: int):
        """The tail rows [covered, count) on the device, padded to a
        ``TAIL_BUCKET`` multiple and cached until the store grows.  Returns
        (covered, count, tail_dev, n_live, meta)."""
        cache = self._tail_cache
        if cache is not None and cache[0] == covered and cache[1] == self.store.count:
            return cache
        gen = self._gen
        vecs, meta = self.store.vectors_snapshot(start=covered)
        n_live = len(vecs)
        bucket = round_up(max(n_live, 1), TAIL_BUCKET)
        padded = np.zeros((bucket, self.store.cfg.dim), np.float32)
        padded[:n_live] = vecs
        dtype = self.store._dtype
        tail_dev = spine_run(
            "tiered_tail", lambda: torch.from_numpy(padded).to(self.device, dtype),
            device=self.device,
        )
        cache = (covered, covered + n_live, tail_dev, n_live, meta)
        # a search that snapshotted before a reset() must not publish
        with self._rebuild_lock:
            if gen == self._gen:
                self._tail_cache = cache
        return cache

    def index_stats(self) -> dict:
        """Tier layout and bytes for ``/api/retrieval``."""
        with self._rebuild_lock:
            tier = self._tier
        if tier is None:
            out: Dict[str, Any] = {"active": False}
        else:
            ivf, covered = tier
            out = {
                "active": True,
                "covered": covered,
                "n_clusters": ivf.n_clusters,
                "nprobe": self.nprobe,
                "n_assign": ivf.n_assign,
                "cap": ivf.cap,
                "spilled": ivf.n_spilled,
            }
            out.update(ivf.index_bytes())
        if self.lexical is not None:
            out["lexical"] = self.lexical.stats()
            out["retrieve_mode_default"] = self.default_mode
            out["hybrid_alpha"] = self.hybrid_alpha
        return out

    # ---- store passthroughs (QAService) --------------------------------------

    @property
    def count(self) -> int:
        return self.store.count

    def metadata_select(self, limit=None, **filters):
        return self.store.metadata_select(limit=limit, **filters)

    def metadata_rows(self):
        return self.store.metadata_rows()
