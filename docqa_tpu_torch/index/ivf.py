"""IVF (inverted-file) coarse-quantized search, counterpart of
``docqa_tpu/index/ivf.py``.

* k-means on the device, as bounded work items on the dispatch spine's
  background ``rebuild`` stream (seeding, one item per Lloyd iteration, one
  per 262,144-row assignment block), so serving interleaves with a build.
  Seeding is greedy k-center (farthest point) on a subsample of at most
  65,536 rows; the host RNG (``np.random.default_rng(seed)``) is drawn in
  the reference's order: the fit subsample, then the seed pool.
* cells are one dense ``[C, cap, d]`` tensor (uniform capacity, padding
  rows carry id -1 and score ``NEG_INF``); a probe gathers ``nprobe`` cells
  a query.  Rows are placed by the reference's cap-aware cascade: the
  primary copy goes to the best of four ranked cells with room, redundant
  copies (``n_assign``) best effort; rows no cell takes spill to a small
  exact buffer.
* the bulk tier is int8 tiles with per-row scales by default
  (``storage="int8"``, :func:`quantize_rows_int8`), scored as ``(q ·
  query) * s`` with float32 accumulation: the int8 values are exact in the
  query's dtype, the products exact in float32.
* on a mesh (``mesh=`` with a model axis of n > 1) the cell tensors (tiles,
  scales, ids) are row-sharded over the model axis, as the reference's
  ``ivf_cell_specs`` lays them out: the cell count rounds up to a multiple
  of n (``cells_per_shard``; padded cells have zero centroids and id -1,
  and the coarse score masks them with ``n_real_cells``) and model rank
  ``m`` holds the contiguous block of cells ``[m * C / n, (m + 1) * C /
  n)``.  Centroids, spill and queries are replicated.  A probe ranks the
  same global probe list on every rank, scores only the probed cells it
  owns (other slots clamp to local cell 0 and score ``NEG_INF``), scores
  the spill on model rank 0 only, and merges the shards' top-k through
  ``ops/topk.py``'s two gathers.  A sharded tier is int8 (HBM capacity is
  why it shards).  Each rank places every row's cell and slot (the whole
  cascade: it is cheap integer work) but stages, quantizes and uploads only
  its own cells, so a shard is bit-equal to that block of a one-device
  build of the same snapshot and seed.

The probe is plain PyTorch (:func:`_probe_kernel`), as the reference leaves
it to XLA; ROADMAP queue 2 lists its kernel (K9).  The host build (the
placement and the quantization over the float32 staging buffer) is the
reference's; :attr:`IVFIndex.build_seconds` splits its wall time.  A build
can take its k-means decisions from elsewhere (``fit=``, :func:`fit_cells`):
on a mesh one rank fits and every rank places its own cells.

:func:`ivf_from_arrays` builds an index from another build's arrays
(centroids, cells, scales, ids, spill), so two implementations can be
compared on identical tiers.  Registered with a mesh's command stream
(``index/tiered.py`` registers each tier it switches to), :meth:`IVFIndex.
search` and :meth:`~IVFIndex.timed_probe` are commands whose host arguments
are the raw queries, ``k`` and ``nprobe``; :meth:`~IVFIndex.probe`, their
device body, runs inside a caller's command.
"""

from __future__ import annotations

from time import perf_counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.store import _normalized
from docqa_tpu_torch.ops.topk import merge_sharded
from docqa_tpu_torch.runtime.mesh import MeshContext, mirrored
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import resolve_device, torch_dtype

log = get_logger("docqa.ivf")

NEG_INF = -1e30

# assignment block: bounds device memory and one background item's length
_ASSIGN_BLOCK = 1 << 18
# seed pool of the k-center seeding
_SEED_POOL = 65536
# cells each row is copied into (the redundant assignment)
N_ASSIGN = 2


def quantize_rows_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: ``q = round(x / s)`` with ``s =
    max|row| / 127``.  Returns ``(q int8, scales float32)``, the scales of
    ``x``'s shape minus the last axis; a zero row gets scale 0."""
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=-1)
    scale = (amax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / safe[..., None]), -127, 127).astype(np.int8)
    return q, scale


# ---------------------------------------------------------------------------
# k-means on the device
# ---------------------------------------------------------------------------


def _kcenter_init(vectors: torch.Tensor, c: int) -> torch.Tensor:
    """Greedy k-center (farthest point) seeding: row 0, then ``c - 1`` times
    the row least similar to every chosen seed (the first such row on a
    tie, as ``argmin`` gives).  Random seeding leaves natural clusters
    unseeded on clustered corpora.  No host sync inside the loop."""
    n, d = vectors.shape
    best = torch.full((n,), -2.0, dtype=vectors.dtype, device=vectors.device)
    best[0] = 2.0
    chosen = torch.zeros((c, d), dtype=vectors.dtype, device=vectors.device)
    chosen[0] = vectors[0]
    best = torch.maximum(best, vectors @ vectors[0])
    for i in range(1, c):
        cvec = torch.index_select(vectors, 0, torch.argmin(best).view(1))[0]
        chosen[i] = cvec
        best = torch.maximum(best, vectors @ cvec)
    return chosen


def cell_sums(vectors: torch.Tensor, assign: torch.Tensor, c: int) -> torch.Tensor:
    """The sum of the rows assigned to each of ``c`` cells.  On a card
    ``index_put_`` with ``accumulate`` sorts the cell ids and adds each
    cell's rows in one fixed order, so two builds of one corpus give the
    same centroids bit for bit; ``index_add_`` there adds with float
    atomics in no fixed order, and a centroid a bit off moves rows at the
    next step (``chip_smoke.py`` phase 21 (a)).  On the CPU ``index_add_``
    adds in row order."""
    sums = torch.zeros((c, vectors.shape[1]), dtype=vectors.dtype, device=vectors.device)
    if vectors.is_cuda:
        return sums.index_put_((assign,), vectors, accumulate=True)
    return sums.index_add_(0, assign, vectors)


def _kmeans_step(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration over L2-normalized rows: assign each row to its
    most similar centroid, average, re-normalize; an empty cell keeps its
    centroid."""
    c = centroids.shape[0]
    assign = torch.argmax(vectors @ centroids.T, dim=1)
    sums = cell_sums(vectors, assign, c).to(centroids.dtype)
    counts = torch.bincount(assign, minlength=c).to(vectors.dtype)[:, None]
    new = sums / counts.clamp_min(1.0)
    new = torch.where(counts > 0, new, centroids)
    return new / new.norm(dim=1, keepdim=True).clamp_min(1e-9)


def _assign_block(vectors: torch.Tensor, centroids: torch.Tensor,
                  n_assign: int) -> torch.Tensor:
    """The ``n_assign`` most similar cells of each row of one block."""
    return torch.topk(vectors @ centroids.T, n_assign, dim=1).indices


def kmeans(
    vectors: np.ndarray,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    sample: Optional[int] = 262_144,
    n_assign: int = 1,
    device="cuda",
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit centroids (on a subsample of ``sample`` rows for larger
    corpora) and assign every row to its ``n_assign`` nearest cells.
    Returns (centroids [C, d] float32, assignments [n, n_assign] int32).

    Each device phase is a bounded ``ivf_build`` item on the ``rebuild``
    stream.  ``timings``, when given, gets the wall seconds of ``seeding``,
    ``lloyd`` and ``assignment``."""
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    rng = np.random.default_rng(seed)
    fit_on = vectors
    if sample is not None and n > sample:
        fit_on = vectors[rng.choice(n, sample, replace=False)]
    n_assign = min(n_assign, n_clusters)
    t0 = perf_counter()

    def _seed_item():
        if len(fit_on) > n_clusters:
            seed_pool = fit_on
            if len(seed_pool) > _SEED_POOL:
                seed_pool = seed_pool[
                    rng.choice(len(seed_pool), _SEED_POOL, replace=False)
                ]
            return _kcenter_init(torch.from_numpy(seed_pool).to(dev), n_clusters)
        rows = fit_on[
            rng.choice(len(fit_on), n_clusters, replace=n_clusters > len(fit_on))
        ]
        return torch.from_numpy(rows).to(dev)

    cent = spine_run("ivf_build", _seed_item, stream="rebuild", device=dev)
    t1 = perf_counter()
    fit_dev = spine_run(
        "ivf_build", lambda: torch.from_numpy(fit_on).to(dev),
        stream="rebuild", device=dev,
    )
    for _ in range(n_iters):
        cent = spine_run(
            "ivf_build", _kmeans_step, fit_dev, cent, stream="rebuild", device=dev
        )
    del fit_dev
    t2 = perf_counter()
    assigns = []
    for start in range(0, n, _ASSIGN_BLOCK):
        blk = vectors[start : start + _ASSIGN_BLOCK]

        def _assign_item(blk=blk):
            idx = _assign_block(torch.from_numpy(blk).to(dev), cent, n_assign)
            return to_host(idx.to(torch.int32))

        assigns.append(
            spine_run("ivf_build", _assign_item, stream="rebuild", device=dev).numpy()
        )
    centroids_h = spine_run(
        "ivf_build", lambda: to_host(cent), stream="rebuild", device=dev
    ).numpy()
    if timings is not None:
        timings["seeding"] = t1 - t0
        timings["lloyd"] = t2 - t1
        timings["assignment"] = perf_counter() - t2
    return centroids_h.astype(np.float32), np.concatenate(assigns).astype(np.int32)


# ---------------------------------------------------------------------------
# the probe (plain PyTorch)
# ---------------------------------------------------------------------------


def _coarse_probe(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                  n_real_cells: Optional[int] = None) -> torch.Tensor:
    """Top-``nprobe`` cell ids a query by float32 centroid score; cells at
    or past ``n_real_cells`` are never probed."""
    c_scores = queries.float() @ centroids.float().T  # [q, C]
    if n_real_cells is not None and n_real_cells < centroids.shape[0]:
        c_scores[:, n_real_cells:] = NEG_INF
    return torch.topk(c_scores, nprobe, dim=1).indices


def _score_probed(queries: torch.Tensor, cells: torch.Tensor,
                  cell_scale: Optional[torch.Tensor], cell_ids: torch.Tensor,
                  probe: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores of each query's probed cells.  cells [C, cap, d] (int8 tiles
    or float), cell_scale [C, cap] f32 (None for float storage), cell_ids
    [C, cap] (-1 pad), probe [q, nprobe] (local cell ids), valid [q,
    nprobe] bool (None when every probed cell is live: one device).  The
    tile is converted to float32 (int8 and the query's dtype are exact
    there) and the per-row scale multiplies the float32 sum.  Returns flat
    per-query (scores [q, nprobe*cap] f32, ids)."""
    scores, ids = [], []
    for qi in range(queries.shape[0]):
        p = probe[qi]
        s = cells[p].float() @ queries[qi].float()  # [nprobe, cap]
        if cell_scale is not None:
            s = s * cell_scale[p]
        iq = cell_ids[p]
        dead = iq < 0
        if valid is not None:
            dead = dead | ~valid[qi][:, None]
        scores.append(s.masked_fill(dead, NEG_INF).reshape(-1))
        ids.append(iq.reshape(-1))
    return torch.stack(scores), torch.stack(ids)


def _probe_kernel(
    cells: torch.Tensor,  # [C, cap, d] int8 tiles or float (a shard: C / n)
    cell_scale: Optional[torch.Tensor],  # [C, cap] f32 (None: float storage)
    cell_ids: torch.Tensor,  # [C, cap] int32 global row ids (-1 pad)
    centroids: torch.Tensor,  # [C, d] (replicated)
    spill: torch.Tensor,  # [S, d]
    spill_ids: torch.Tensor,  # [S]
    queries: torch.Tensor,  # [q, d]
    *,
    nprobe: int,
    k: int,
    n_real_cells: Optional[int] = None,
    mesh: Optional[MeshContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse rank, score the probed cells and the spill buffer, top-``k``
    of both.  With ``mesh`` (a model axis of n > 1) the cell tensors are
    this rank's block (module docstring): the reference's
    ``_probe_kernel_sharded``, two all-gathers over the model group.
    Returns (vals [q, k] f32, row ids [q, k]) on every rank."""
    probe = _coarse_probe(queries, centroids, nprobe, n_real_cells)
    valid = None
    spill_live = spill_ids >= 0
    if mesh is not None:
        c_local = cells.shape[0]
        local = probe - mesh.model_index * c_local
        valid = (local >= 0) & (local < c_local)
        probe = torch.where(valid, local, 0)
        if mesh.model_index != 0:  # the merge sees each spill row once
            spill_live = torch.zeros_like(spill_live)
    cell_s, cell_i = _score_probed(queries, cells, cell_scale, cell_ids, probe, valid)
    spill_s = queries.float() @ spill.float().T  # [q, S]
    spill_s = spill_s.masked_fill(~spill_live[None, :], NEG_INF)
    q_n = queries.shape[0]
    all_s = torch.cat([cell_s, spill_s], dim=1)
    all_i = torch.cat(
        [cell_i, spill_ids[None, :].to(cell_i.dtype).expand(q_n, -1)], dim=1
    )
    vals, pos = torch.topk(all_s, k, dim=1)
    ids = torch.gather(all_i, 1, pos)
    if mesh is None:
        return vals, ids
    return merge_sharded(vals, ids, k, mesh.model_group)


# ---------------------------------------------------------------------------
# IVF index
# ---------------------------------------------------------------------------


def fit_cells(vectors: np.ndarray, n_clusters: int, n_assign: int = N_ASSIGN,
              n_iters: int = 10, seed: int = 0, device="cuda",
              timings: Optional[Dict[str, float]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A build's k-means decisions over rows L2-normalized as the build
    normalizes them (:func:`l2_rows`): (centroids [C, d] float32, each
    row's ranked cells [n, min(max(4, n_assign), C)] int32).  It ranks more
    cells than copies: the placement cascade needs fallback cells when a
    row's best cells are full."""
    n_assign = max(1, min(n_assign, n_clusters))
    n_choices = max(4, n_assign)
    return kmeans(vectors, n_clusters, n_iters=n_iters, seed=seed,
                  n_assign=min(n_choices, n_clusters), device=device, timings=timings)


def l2_rows(vectors: np.ndarray) -> np.ndarray:
    vectors = np.asarray(vectors, np.float32)
    return vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-9)


class IVFIndex:
    """Coarse-quantized cosine search over a fixed corpus snapshot, on one
    device or row-sharded over a mesh's model axis (module docstring).
    ``index/tiered.py``'s ``TieredIndex`` serves it beside an exact tail
    and rebuilds it as the store grows.

    ``storage="int8"`` (default) keeps int8 tiles with per-row scales;
    ``"float"`` keeps ``dtype`` cells (exact scores, twice the bytes; one
    device only: a sharded tier forces int8, as the reference's does).
    ``fit``: (centroids, ranked cells) from :func:`fit_cells` over the same
    rows, in place of this build's own k-means.
    """

    def __init__(
        self,
        vectors: np.ndarray,
        metadata: Sequence[Dict[str, Any]],
        n_clusters: Optional[int] = None,
        nprobe: int = 8,
        cap_factor: float = 1.5,
        n_iters: int = 10,
        seed: int = 0,
        dtype: str = "bfloat16",
        n_assign: int = N_ASSIGN,
        storage: str = "int8",
        device="cuda",
        mesh: Optional[MeshContext] = None,
        fit: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        self._set_mesh(mesh, device)
        t_start = perf_counter()
        vectors = l2_rows(vectors)
        n, d = vectors.shape
        self._meta = list(metadata)
        self.n = n
        self.dim = d
        c = n_clusters or max(1, int(np.sqrt(max(n, 1))))
        self.n_clusters = c
        self.nprobe = min(nprobe, c)
        self.n_assign = max(1, min(n_assign, c))
        self._dtype = torch_dtype(dtype)
        if self._sharded and storage != "int8":
            log.warning("sharded IVF tier forces int8 storage (requested %r)", storage)
            storage = "int8"
        self.storage = storage
        self.n_real_cells = c
        c_pad = -(-c // self.n_shards) * self.n_shards
        self.cells_per_shard = c_pad // self.n_shards
        timings: Dict[str, float] = {}

        with span("ivf_build", DEFAULT_REGISTRY):
            if fit is None:
                centroids, assign = fit_cells(vectors, c, self.n_assign, n_iters, seed,
                                              self.device, timings)
            else:
                centroids, assign = (np.asarray(a) for a in fit)
                if centroids.shape != (c, d) or len(assign) != n:
                    raise ValueError(f"fit of {centroids.shape} centroids and {len(assign)} "
                                     f"rows for {n} rows in {c} cells of {d}")
            t_place = perf_counter()
            if c_pad != c:
                centroids = np.vstack([centroids, np.zeros((c_pad - c, d), np.float32)])
            cap = max(8, int(np.ceil(cap_factor * self.n_assign * n / c)))
            cell_ids = np.full((c_pad, cap), -1, np.int32)
            fill = np.zeros((c_pad,), np.int64)
            slots: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

            def place(rows: np.ndarray, target_cells: np.ndarray) -> np.ndarray:
                """Vectorized cap-aware placement of rows[i] into
                target_cells[i] where the cell has room; returns the
                placed mask."""
                if len(rows) == 0:
                    return np.zeros((0,), bool)
                order = np.argsort(target_cells, kind="stable")
                tc = target_cells[order]
                group_change = np.r_[True, tc[1:] != tc[:-1]]
                group_start = np.nonzero(group_change)[0]
                within = np.arange(len(tc)) - np.repeat(
                    group_start, np.diff(np.r_[group_start, len(tc)])
                )
                slot = fill[tc] + within
                ok = slot < cap
                r_ok, c_ok, s_ok = rows[order][ok], tc[ok], slot[ok]
                slots.append((c_ok, s_ok, r_ok))
                cell_ids[c_ok, s_ok] = r_ok
                fill[:] = fill + np.bincount(c_ok, minlength=c_pad)
                placed = np.zeros((len(rows),), bool)
                placed[order[ok]] = True
                return placed

            # primary copy: cascade to the best ranked cell with room
            primary_cell = np.full((n,), -1, np.int64)
            pending = np.arange(n)
            for r in range(assign.shape[1]):
                if len(pending) == 0:
                    break
                targets = assign[pending, r]
                placed = place(pending, targets)
                primary_cell[pending[placed]] = targets[placed]
                pending = pending[~placed]
            spill_rows = list(pending)
            # redundant copies, best effort, never twice into one cell
            for r in range(1, self.n_assign):
                everyone = np.arange(n)
                rows = everyone[assign[everyone, r] != primary_cell[everyone]]
                place(rows, assign[rows, r])
            spill_n = max(1, len(spill_rows))
            spill = np.zeros((spill_n, d), np.float32)
            spill_ids = np.full((spill_n,), -1, np.int32)
            for j, i in enumerate(spill_rows):
                spill[j] = vectors[i]
                spill_ids[j] = i
            self.cap = cap
            self.n_spilled = len(spill_rows)
            # the float32 staging buffer of this rank's cells only
            lo = self.shard_index * self.cells_per_shard
            cells = np.zeros((self.cells_per_shard, cap, d), np.float32)
            for c_ok, s_ok, r_ok in slots:
                own = (c_ok >= lo) & (c_ok < lo + self.cells_per_shard)
                cells[c_ok[own] - lo, s_ok[own]] = vectors[r_ok[own]]
            del slots
            t_quant = perf_counter()
            timings["placement"] = t_quant - t_place
            if storage == "int8":
                cells_up, cell_scale = quantize_rows_int8(cells)
            else:
                cells_up, cell_scale = cells, None
            del cells  # the float32 staging buffer is the build's peak
            t_up = perf_counter()
            timings["quantize"] = t_up - t_quant
            self._upload(cells_up, cell_scale, cell_ids[lo : lo + self.cells_per_shard],
                         centroids, spill, spill_ids)
            timings["upload"] = perf_counter() - t_up
        timings["total"] = perf_counter() - t_start
        self.build_seconds = timings
        self._seen_shapes: set = set()
        log.info(
            "ivf built: n=%d C=%d cap=%d spill=%d nprobe=%d storage=%s "
            "shards=%d bytes/chunk=%.0f in %.1f s",
            n, c, cap, self.n_spilled, self.nprobe, self.storage, self.n_shards,
            self.index_bytes()["bytes_per_chunk"], timings["total"],
        )

    def _set_mesh(self, mesh: Optional[MeshContext], device) -> None:
        """The device, the mesh and this rank's shard of the cells."""
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.n_model > 1
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.n_shards = mesh.n_model if self._sharded else 1
        self.shard_index = mesh.model_index if self._sharded else 0
        # bumped by the tiered index that publishes this tier
        self.generation = 0

    @property
    def shard_mesh(self) -> Optional[MeshContext]:
        """The mesh the probe merges over; None on one device."""
        return self.mesh if self._sharded else None

    def _upload(self, cells, cell_scale, cell_ids, centroids, spill, spill_ids) -> None:
        dev, dt = self.device, self._dtype

        def up(a, np_dtype, dtype=None):
            a = np.ascontiguousarray(a, np_dtype)
            if not a.flags.writeable:  # torch refuses read-only numpy
                a = a.copy()
            return torch.from_numpy(a).to(dev, dtype)

        def _upload_on_device():
            return (
                up(cells, cells.dtype, torch.int8 if self.storage == "int8" else dt),
                None if cell_scale is None else up(cell_scale, np.float32),
                up(cell_ids, np.int32),
                up(centroids, np.float32, dt),
                up(spill, np.float32, dt),
                up(spill_ids, np.int32),
            )

        (self._cells, self._cell_scale, self._cell_ids, self._centroids,
         self._spill, self._spill_ids) = spine_run(
            "ivf_build", _upload_on_device, stream="rebuild", device=dev
        )

    @classmethod
    def from_store(cls, store, **kw) -> "IVFIndex":
        """An index over a consistent snapshot of a ``VectorStore``, on the
        store's device and, as the reference's, sharded where it shards."""
        vectors, meta = store.vectors_snapshot()
        kw.setdefault("device", store.device)
        kw.setdefault("mesh", store.mesh)
        return cls(vectors, meta, **kw)

    def arrays(self) -> Dict[str, Any]:
        """The tier as host numpy arrays, :func:`ivf_from_arrays`'s input
        (float tensors as float32); a shard gives its own block of cells."""
        def host(t):
            if t is None:
                return None
            return (t if t.dtype in (torch.int8, torch.int32) else t.float()).cpu().numpy()

        return {
            "centroids": host(self._centroids), "cells": host(self._cells),
            "cell_scale": host(self._cell_scale), "cell_ids": host(self._cell_ids),
            "spill": host(self._spill), "spill_ids": host(self._spill_ids),
            "n_assign": self.n_assign, "n_real_cells": self.n_real_cells,
        }

    def index_bytes(self) -> Dict[str, Any]:
        """Device bytes of the tier (tiles, scales, ids, centroids, spill):
        ``per_shard_bytes`` is what one rank holds (its block of the cell
        tensors and the replicated rest), as the reference reports it."""
        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors if t is not None)

        local = nbytes((self._cells, self._cell_scale, self._cell_ids))
        repl = nbytes((self._centroids, self._spill, self._spill_ids))
        total = local * self.n_shards + repl
        return {
            "total_bytes": total,
            "bytes_per_chunk": round(total / max(self.n, 1), 2),
            "per_shard_bytes": local + repl,
            "shards": self.n_shards,
            "storage": self.storage,
        }

    def _fetch(self, k: int, nprobe: Optional[int]) -> Tuple[int, int, int]:
        """(nprobe, fetch, k_eff): rows in several cells can appear once per
        probed copy in the raw top list, so the probe over-fetches
        ``k * (n_assign + 1)`` (at most the probed pool) and the host
        dedups back to ``k``."""
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        k_eff = min(k, self.n)
        pool = nprobe * self.cap + int(self._spill_ids.shape[0])
        return nprobe, min(k_eff * (self.n_assign + 1), pool), k_eff

    def probe(self, qn: np.ndarray, nprobe: int, fetch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The raw probe of normalized host queries, inside a caller's
        spine item (and, on a mesh, inside its command): (vals [q, fetch]
        f32, ids [q, fetch]) on the device."""
        q = torch.from_numpy(qn).to(self.device, self._dtype)
        return _probe_kernel(
            self._cells, self._cell_scale, self._cell_ids, self._centroids,
            self._spill, self._spill_ids, q, nprobe=nprobe, k=fetch,
            n_real_cells=self.n_real_cells, mesh=self.shard_mesh,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        nprobe: Optional[int] = None,
        dedup_full: bool = False,
    ) -> List[List[Tuple[float, int, Dict[str, Any]]]]:
        """Per query a list of (score, row_id, metadata).  ``dedup_full``
        returns every unique candidate the probe fetched (up to ``k *
        (n_assign + 1)``) instead of cutting at ``k``: the tiered exact
        re-rank widens its pool this way.  A command on a mesh, its nprobe
        resolved by the caller."""
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        return mirrored(self, "search", self._search, np.asarray(queries, np.float32),
                        int(k), nprobe, bool(dedup_full))

    def _search(self, queries, k, nprobe, dedup_full):
        qn = _normalized(queries)
        nprobe, fetch, k_eff = self._fetch(k, nprobe)
        self._seen_shapes.add((len(qn), fetch, nprobe))

        def _probe_on_device():
            v, i = self.probe(qn, nprobe, fetch)
            return to_host(v), to_host(i)

        with span("ivf_search", DEFAULT_REGISTRY):
            vals, ids = spine_run("ivf_search", _probe_on_device, device=self.device)
        return self.dedup_rows(vals.numpy(), ids.numpy(), fetch if dedup_full else k_eff)

    def dedup_rows(
        self, vals: np.ndarray, ids: np.ndarray, k_eff: int
    ) -> List[List[Tuple[float, int, Dict[str, Any]]]]:
        """Host dedup of a raw top list (a row appears once per probed copy)
        down to ``k_eff`` a query, padding and masked rows dropped."""
        out = []
        for qi in range(len(vals)):
            row = []
            seen = set()
            for score, rid in zip(vals[qi], ids[qi]):
                if rid < 0 or score <= NEG_INF / 2 or int(rid) in seen:
                    continue
                seen.add(int(rid))
                row.append((float(score), int(rid), self._meta[int(rid)]))
                if len(row) >= k_eff:
                    break
            out.append(row)
        return out

    def timed_probe(
        self,
        queries: np.ndarray,
        k: int = 10,
        nprobe: Optional[int] = None,
        dedup_full: bool = False,
    ) -> Tuple[List[List[Tuple[int, float]]], float, bool]:
        """One probe at an explicit ``nprobe`` as a ``retrieve_shadow`` item
        on the background ``probe`` stream: the retrieval observatory's
        frontier instrument.  Returns ``(rows, seconds, fresh)``: rows per
        query ``(row_id, score)``, ``seconds`` the probe's device time
        (CUDA events on a card, the closure's wall time on the CPU; queue
        wait excluded; on a mesh its gathers included), ``fresh`` True on
        the first call at a (batch, fetch, nprobe) shape, which the
        observatory keeps off its latency axis as the reference does its
        compiles.  A command on a mesh."""
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        return mirrored(self, "timed_probe", self._timed_probe,
                        np.asarray(queries, np.float32), int(k), nprobe, bool(dedup_full))

    def _timed_probe(self, queries, k, nprobe, dedup_full):
        qn = _normalized(queries)
        nprobe, fetch, k_eff = self._fetch(k, nprobe)
        key = (len(qn), fetch, nprobe)
        fresh = key not in self._seen_shapes
        self._seen_shapes.add(key)
        on_card = self.device.type == "cuda"

        def _shadow_probe_on_device():
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = perf_counter()
            v, i = self.probe(qn, nprobe, fetch)
            if on_card:
                ev[1].record()
                return to_host(v), to_host(i), ev
            return v, i, perf_counter() - t0

        vals, ids, timing = spine_run(
            "retrieve_shadow", _shadow_probe_on_device, stream="probe",
            device=self.device,
        )
        if on_card:
            timing[1].synchronize()
            seconds = timing[0].elapsed_time(timing[1]) / 1e3
        else:
            seconds = timing
        rows = [
            [(rid, score) for score, rid, _md in row]
            for row in self.dedup_rows(
                vals.numpy(), ids.numpy(), fetch if dedup_full else k_eff
            )
        ]
        return rows, seconds, fresh


def ivf_from_arrays(
    arrays: Dict[str, Any],
    metadata: Sequence[Dict[str, Any]],
    nprobe: int = 8,
    dtype: str = "bfloat16",
    device="cuda",
    mesh: Optional[MeshContext] = None,
) -> IVFIndex:
    """An :class:`IVFIndex` over another build's whole tier, as numpy
    arrays: ``centroids`` [C, d], ``cells`` [C, cap, d] (int8 tiles, or
    float), ``cell_scale`` [C, cap] (None for float storage), ``cell_ids``
    [C, cap], ``spill`` [S, d], ``spill_ids`` [S], ``n_assign`` and,
    optionally, ``n_real_cells`` (C less a padding).  Float arrays are cast
    to ``dtype`` as the build's upload casts them, so values already in
    ``dtype`` carry over exactly.  ``mesh``: shard it as a mesh build does
    (a float tier is quantized to int8 there, with a warning)."""
    ivf = IVFIndex.__new__(IVFIndex)
    ivf._set_mesh(mesh, device)
    centroids = np.asarray(arrays["centroids"], np.float32)
    cells = np.asarray(arrays["cells"])
    scale = arrays.get("cell_scale")
    cell_ids = np.asarray(arrays["cell_ids"], np.int32)
    ivf._meta = list(metadata)
    ivf.n = len(ivf._meta)
    ivf.n_clusters = ivf.n_real_cells = int(arrays.get("n_real_cells") or centroids.shape[0])
    ivf.dim = centroids.shape[1]
    ivf.cap = cells.shape[1]
    ivf.nprobe = min(nprobe, ivf.n_clusters)
    ivf.n_assign = int(arrays["n_assign"])
    ivf._dtype = torch_dtype(dtype)
    ivf.storage = "int8" if cells.dtype == np.int8 else "float"
    if ivf.storage == "float":
        cells = cells.astype(np.float32)
    scale = None if scale is None else np.asarray(scale, np.float32)
    if ivf._sharded and ivf.storage != "int8":
        log.warning("sharded IVF tier forces int8 storage (carried a float tier)")
        cells, scale = quantize_rows_int8(cells)
        ivf.storage = "int8"
    c_pad = -(-centroids.shape[0] // ivf.n_shards) * ivf.n_shards
    pad = c_pad - centroids.shape[0]
    if pad:
        centroids = np.vstack([centroids, np.zeros((pad, ivf.dim), np.float32)])
        cells = np.concatenate([cells, np.zeros((pad,) + cells.shape[1:], cells.dtype)])
        cell_ids = np.concatenate([cell_ids, np.full((pad, ivf.cap), -1, np.int32)])
        if scale is not None:
            scale = np.concatenate([scale, np.zeros((pad, ivf.cap), np.float32)])
    ivf.cells_per_shard = c_pad // ivf.n_shards
    block = slice(ivf.shard_index * ivf.cells_per_shard,
                  (ivf.shard_index + 1) * ivf.cells_per_shard)
    spill_ids = np.asarray(arrays["spill_ids"], np.int32)
    ivf.n_spilled = int((spill_ids >= 0).sum())
    ivf._upload(
        cells[block], None if scale is None else scale[block], cell_ids[block],
        centroids, np.asarray(arrays["spill"], np.float32), spill_ids,
    )
    ivf.build_seconds = {}
    ivf._seen_shapes = set()
    return ivf
