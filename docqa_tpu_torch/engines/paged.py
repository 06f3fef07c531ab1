"""Block-table paged KV cache for the continuous batcher, counterpart of
``docqa_tpu/engines/paged.py``.

KV lives in ONE flat pool of fixed-size blocks shared by every decode slot:

* **host side** — :class:`BlockAllocator`: a lock-disciplined, refcounted
  free list of KV blocks with per-request :class:`BlockTable`\\ s, and
  :class:`PrefixCache`: an LRU of immutable, full-block prompt prefixes
  mapped copy-on-write into new requests' tables.  Near verbatim from the
  reference: all-or-nothing allocation, idempotent release whose double
  free RAISES (the accounting is the leak detector), exact block-seconds.
* **device side** — :func:`init_paged_pools` allocates per-layer pools
  ``[n_blocks * block_size + 1, kv_heads, head_dim]``;
  :func:`ragged_prefill_forward` prefills a packed batch of mixed-length
  prompts and scatters their K/V into their blocks;
  :func:`paged_decode_forward` advances lanes 1 (plain) or K (verify)
  tokens through the tables.  Both compose the shared decoder trunk
  (``models/decoder.decoder_layer_stack``) with the ragged/paged attention
  ops, so the layer math is the solo engine's.

Two departures from the reference, both forced by PyTorch:

* the pools are written IN PLACE (the reference returns updated copies
  from donated buffers), so the forwards return logits only;
* JAX drops an out-of-range scatter (``mode="drop"``); an out-of-range
  ``index_put_`` on a card is a device-side assert.  Each pool therefore
  carries one spare row past the reference's ``P = n_blocks *
  block_size`` rows: every write the reference would drop lands there
  instead (never clamped onto a live row), and attention reads the pool
  through the ``[:P]`` view, which is exactly the reference's pool.
"""

from __future__ import annotations

import collections
import math
import threading
from time import monotonic as _mono
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.decoder import (
    Params,
    decoder_head,
    decoder_layer_stack,
)
from docqa_tpu_torch.ops.attention import (
    RAGGED_ALIGN,
    paged_decode_attention,
    ragged_prefill_attention,
)
from docqa_tpu_torch.utils import torch_dtype

PagedPools = Dict[str, torch.Tensor]  # "k0".."k{L-1}", "v0".."v{L-1}"


class OutOfBlocks(RuntimeError):
    """The allocator could not satisfy a block request.  Internal to the
    paging layer: the batcher maps it to its typed shed
    (``serve.BlockPoolExhausted``)."""


class BlockTable:
    """Per-request block list; all mutation goes through the owning
    :class:`BlockAllocator` (one lock for table + free list).

    The first ``n_shared`` blocks may be SHARED with other tables (a cached
    prompt prefix mapped in at refcount+1).  Shared blocks are immutable:
    every write a request issues lands at positions >= its own prompt
    length, past the shared region (copy-on-write realized as
    never-write-shared).  ``grow`` only appends fresh private blocks;
    ``release`` decrements instead of freeing blocks others reference."""

    __slots__ = (
        "blocks", "n_shared", "released", "_alloc", "acc_base",
        "billed_block_seconds",
    )

    def __init__(self, alloc: "BlockAllocator") -> None:
        self.blocks: List[int] = []
        self.n_shared = 0
        self.released = False
        self._alloc = alloc
        # acc_base[i]: blocks[i]'s unit-accrual reading at acquisition; the
        # bill at release is the sum of deltas (∫ dt / refcount per block)
        self.acc_base: List[float] = []
        self.billed_block_seconds = 0.0

    @property
    def capacity(self) -> int:
        """Tokens this table can currently hold."""
        return self._alloc.capacity_of(self)

    def ensure(self, n_tokens: int) -> None:
        """Grow to cover ``n_tokens``; raises :class:`OutOfBlocks`
        atomically (every needed block is taken or none are)."""
        self._alloc.grow(self, n_tokens)

    def release(self) -> None:
        """Return every block to the pool.  Idempotent and thread-safe:
        exactly one of the paths that reach a table frees it."""
        self._alloc.release(self)


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks, refcounted for
    copy-on-write prefix sharing.

    LIFO reuse; all-or-nothing allocation; a block's refcount is 1 when
    privately owned and +1 per table the prefix cache mapped it into;
    ``release`` decrements and only a 0-refcount block returns to the free
    list.  Double frees raise.  ``blocks_in_use`` counts UNIQUE live
    blocks, so a shared release that is not a free is observable."""

    def __init__(
        self,
        n_blocks: int,
        block_size: int,
        now_fn: Optional[Callable[[], float]] = None,
    ) -> None:
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO stack: low block ids hand out first
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs = [0] * self.n_blocks
        self._in_use = 0
        # block-second ledger on an injectable clock: per block, _unit_acc
        # accrues ∫ dt / refcount while live (settled at every refcount
        # change); _pool_acc is ∫ blocks_in_use dt; _billed sums released
        # tables' bills, so total - billed is what live tables still hold
        self._now = now_fn or _mono
        self._unit_acc = [0.0] * self.n_blocks
        self._last_evt = [0.0] * self.n_blocks
        self._pool_acc = 0.0
        self._pool_last = self._now()
        self._billed = 0.0

    # ---- block-second ledger internals (caller holds self._lock) ---------

    def _touch_pool_locked(self, now: float) -> None:
        self._pool_acc += (now - self._pool_last) * self._in_use
        self._pool_last = now

    def _settle_locked(self, b: int, now: float) -> None:
        if self._refs[b] > 0:
            self._unit_acc[b] += (now - self._last_evt[b]) / self._refs[b]
        self._last_evt[b] = now

    # ---- table lifecycle -------------------------------------------------

    def new_table(self) -> BlockTable:
        return BlockTable(self)

    def capacity_of(self, table: BlockTable) -> int:
        with self._lock:
            return len(table.blocks) * self.block_size

    def grow(self, table: BlockTable, n_tokens: int) -> None:
        with self._lock:
            need = -(-int(n_tokens) // self.block_size) - len(table.blocks)
            if need <= 0:
                return
            if table.released:
                raise OutOfBlocks("table already released")
            if need > len(self._free):
                raise OutOfBlocks(
                    f"need {need} block(s), {len(self._free)} free "
                    f"(pool {self.n_blocks} x {self.block_size} tokens)"
                )
            now = self._now()
            self._touch_pool_locked(now)
            for _ in range(need):
                b = self._free.pop()
                self._refs[b] = 1
                self._last_evt[b] = now  # accrual restarts at refcount 0->1
                table.blocks.append(b)
                table.acc_base.append(self._unit_acc[b])
            self._in_use += need

    def share(self, table: BlockTable, blocks: Sequence[int]) -> None:
        """Map an already-live block run into ``table`` at refcount+1 (the
        warm-admission path and the cache's own pin).  The run must be the
        table's LEADING blocks, so the table must still be empty."""
        blocks = [int(b) for b in blocks]
        with self._lock:
            if table.released:
                raise OutOfBlocks("table already released")
            if table.blocks:
                raise ValueError(
                    "shared prefix blocks must be mapped before any "
                    "private growth (they are the table's leading run)"
                )
            for b in blocks:
                if self._refs[b] <= 0:
                    raise RuntimeError(
                        f"share of a free block (id {b}): the prefix "
                        "cache pinned a block the allocator no longer "
                        "considers live"
                    )
            now = self._now()
            for b in blocks:
                # settle at the OLD refcount: the interval up to now belongs
                # to the existing holders alone
                self._settle_locked(b, now)
                self._refs[b] += 1
            table.blocks = list(blocks)
            table.n_shared = len(blocks)
            table.acc_base = [self._unit_acc[b] for b in blocks]

    def release(self, table: BlockTable) -> None:
        with self._lock:
            if table.released:
                return
            table.released = True
            if not table.blocks:
                return
            if len(set(table.blocks)) != len(table.blocks):
                raise RuntimeError(
                    "double free detected: table lists a block twice"
                )
            for b in table.blocks:
                if self._refs[b] <= 0:
                    raise RuntimeError(
                        f"double free detected: block {b} already at "
                        "refcount 0"
                    )
            now = self._now()
            self._touch_pool_locked(now)
            earned = 0.0
            bases = table.acc_base
            for i, b in enumerate(table.blocks):
                self._settle_locked(b, now)
                if i < len(bases):
                    earned += self._unit_acc[b] - bases[i]
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    # a SHARED release is not a free
                    self._free.append(b)
                    self._in_use -= 1
            table.billed_block_seconds = earned
            self._billed += earned
            table.blocks = []
            table.n_shared = 0
            table.acc_base = []

    # ---- sizing / stats --------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def can_alloc(self, n_blocks: int) -> bool:
        with self._lock:
            return int(n_blocks) <= len(self._free)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        with self._lock:
            return self._in_use

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs[int(block)]

    def reclaimable(self, table: BlockTable) -> int:
        """Blocks releasing ``table`` would return to the free list right
        now (refcount 1: not also pinned by the prefix cache or another
        sharer).  KV preemption ranks victims by this."""
        with self._lock:
            if table.released:
                return 0
            return sum(1 for b in table.blocks if self._refs[b] == 1)

    def block_seconds(self) -> Dict[str, float]:
        """``total`` = ∫ blocks_in_use dt since construction, ``billed`` =
        the sum of released tables' bills, ``residual`` = what live tables
        still hold — exactly zero after everything released."""
        with self._lock:
            self._touch_pool_locked(self._now())
            total = self._pool_acc
            billed = self._billed
        return {
            "total": total,
            "billed": billed,
            "residual": total - billed,
        }


# ---------------------------------------------------------------------------
# prefix cache: refcounted KV block sharing
# ---------------------------------------------------------------------------


class _PrefixEntry:
    __slots__ = ("tokens", "pin", "n_tokens")

    def __init__(self, tokens: Tuple[int, ...], pin: BlockTable) -> None:
        self.tokens = tokens
        self.pin = pin  # a BlockTable of shared refs: the cache's pin
        self.n_tokens = len(tokens)


class PrefixCache:
    """LRU cache of immutable, full-block KV prompt prefixes, keyed by the
    submitter's prefix key (for /ask: template hash + retrieved-chunk-set
    hash, ``service/qa.prefix_key_for``).

    An entry pins its blocks through its own :class:`BlockTable` of shared
    refs, so eviction and teardown reuse the allocator's exactly-once
    release.  Entries keep the prefix TOKEN IDS and admission verifies them
    token by token: a key collision degrades to a shorter run or a miss,
    never to wrong attention.  A shared run is a multiple of ``align`` =
    lcm(RAGGED_ALIGN, block_size) tokens (full blocks only), capped one
    unit below the prompt so the prefill keeps >= 1 real token.

    One lock, ordered BEFORE the allocator's."""

    def __init__(
        self, alloc: BlockAllocator, align: int, max_entries: int = 32
    ) -> None:
        if align % alloc.block_size:
            raise ValueError(
                f"share alignment {align} must be a multiple of the "
                f"block size {alloc.block_size} (full blocks only)"
            )
        self._alloc = alloc
        self.align = int(align)
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _PrefixEntry]" = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.tokens_avoided = 0

    # ---- admission-side API (batcher worker) ----------------------------

    def _shared_len_locked(
        self, entry: _PrefixEntry, ids: Sequence[int]
    ) -> int:
        """Longest verified, aligned, suffix-preserving shared run."""
        n = min(entry.n_tokens, len(ids))
        n_match = 0
        toks = entry.tokens
        for i in range(n):
            if toks[i] != ids[i]:
                break
            n_match += 1
        return max(
            0,
            min(
                (n_match // self.align) * self.align,
                ((len(ids) - 1) // self.align) * self.align,
            ),
        )

    def peek(self, key: Optional[str], ids: Sequence[int]) -> int:
        """Shared-token estimate for capacity planning — no counters, no
        recency bump, no share."""
        if key is None:
            return 0
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return 0
            return self._shared_len_locked(entry, ids)

    def acquire(
        self, key: Optional[str], ids: Sequence[int], table: BlockTable
    ) -> int:
        """Map the longest cached, verified, aligned prefix of ``ids`` into
        ``table`` at refcount+1; returns the shared token count (0 = miss).
        Stats are credited later by :meth:`credit`, once the admission
        holds its blocks."""
        if key is None:
            return 0
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return 0
            shared = self._shared_len_locked(entry, ids)
            if shared <= 0:
                return 0
            self._alloc.share(
                table, entry.pin.blocks[: shared // self._alloc.block_size]
            )
            self._entries.move_to_end(key)
            return shared

    def credit(self, shared: int) -> None:
        """Record one keyed admission's outcome in the hit stats."""
        with self._lock:
            if shared > 0:
                self.hits += 1
                self.tokens_avoided += shared
            else:
                self.misses += 1

    def insert(self, key: Optional[str], ids: Sequence[int],
               table: BlockTable) -> bool:
        """Cache the aligned prefix of a just-admitted prompt (its K/V is
        written by the admission dispatch, which the batcher's one stream
        orders before every later reader).  Keeps the LONGEST prefix per
        key; shorter re-inserts only refresh recency."""
        if key is None:
            return False
        n = (len(ids) // self.align) * self.align
        if n <= 0:
            return False
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._entries.move_to_end(key)
                if old.n_tokens >= n:
                    return False
            pin = self._alloc.new_table()
            try:
                self._alloc.share(
                    pin, table.blocks[: n // self._alloc.block_size]
                )
            except BaseException:
                pin.release()  # never strand refs a partial share took
                raise
            self._entries[key] = _PrefixEntry(tuple(ids[:n]), pin)
            self._entries.move_to_end(key)
            self.insertions += 1
            evict_old = old
            while len(self._entries) > self.max_entries:
                _, lru = self._entries.popitem(last=False)
                lru.pin.release()
                self.evictions += 1
        if evict_old is not None:
            evict_old.pin.release()
        return True

    # ---- pressure / lifecycle -------------------------------------------

    def evict_for(self, n_blocks: int) -> int:
        """Evict IDLE entries (some pinned block at refcount 1, the cache
        its sole holder), LRU first, until the allocator could grant
        ``n_blocks`` or nothing idle remains.  An entry whose blocks live
        lanes still share frees nothing now and is skipped.  Returns the
        number evicted."""
        n_evicted = 0
        with self._lock:
            while self._entries and not self._alloc.can_alloc(n_blocks):
                victim = None
                for key, entry in self._entries.items():  # LRU order
                    if any(
                        self._alloc.refcount(b) == 1
                        for b in entry.pin.blocks
                    ):
                        victim = key
                        break
                if victim is None:
                    break
                self._entries.pop(victim).pin.release()
                self.evictions += 1
                n_evicted += 1
        return n_evicted

    def clear(self) -> int:
        """Release every pin (teardown / device-state reset)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.pin.release()
        return len(entries)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            pinned = sum(len(e.pin.blocks) for e in self._entries.values())
            n = len(self._entries)
            hits, misses = self.hits, self.misses
            return {
                "entries": float(n),
                "pinned_blocks": float(pinned),
                "hits": float(hits),
                "misses": float(misses),
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
                "tokens_avoided": float(self.tokens_avoided),
                "evictions": float(self.evictions),
            }


def share_alignment(block_size: int) -> int:
    """Tokens per shareable prefix unit: full blocks AND RAGGED_ALIGN
    aligned."""
    return math.lcm(int(block_size), RAGGED_ALIGN)


# ---------------------------------------------------------------------------
# device side: block pool init + ragged/paged forwards
# ---------------------------------------------------------------------------


def init_paged_pools(
    cfg: DecoderConfig, n_blocks: int, block_size: int,
    dtype: Optional[torch.dtype] = None, device=None,
) -> PagedPools:
    """Flat per-layer K/V block pools ``[n_blocks * block_size + 1,
    kv_heads, head_dim]``, zero-filled.  Row ``b * block_size + o`` is
    offset ``o`` of block ``b``; the last row is the drop row that takes
    every write the reference's ``mode="drop"`` scatter would discard."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (n_blocks * block_size + 1, cfg.num_kv_heads, cfg.head_dim)
    pools: PagedPools = {}
    for i in range(cfg.num_layers):
        pools[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        pools[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return pools


def pool_rows(pools: PagedPools) -> int:
    """``P``, the pool rows attention may read (the drop row excluded)."""
    return pools["k0"].shape[0] - 1


def kv_bytes_per_token(cfg: DecoderConfig) -> int:
    """Bytes one token of KV occupies across every layer."""
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * itemsize


def ragged_prefill_forward(
    params: Params,
    cfg: DecoderConfig,
    pools: PagedPools,
    ids: torch.Tensor,  # [T] packed prompt tokens (pad elsewhere)
    seg_ids: torch.Tensor,  # [T] lane index per token; -1 = padding
    positions: torch.Tensor,  # [T] position within its own sequence
    dest_rows: torch.Tensor,  # [T] flat pool row per token; >= P = dropped
    last_rows: torch.Tensor,  # [B] packed row of each lane's last token
    *,
    rope_len: int,
    block_tables: Optional[torch.Tensor] = None,  # [B, NB] (warm mode)
    prefix_lens: Optional[torch.Tensor] = None,  # [B] (warm mode)
    n_prefix_rows: int = 0,  # static prefix window (warm mode)
    block_size: Optional[int] = None,
) -> torch.Tensor:
    """Prefill a whole admission round of MIXED-length prompts in one pass:
    every token computes through the shared trunk, its K/V is written into
    its block-table row in place, and each lane's last-token hidden state
    feeds the head.  Returns last_logits [B, vocab] f32 (padding lanes give
    logits the caller ignores; their writes land on the drop row).

    WARM mode (``n_prefix_rows > 0``): the packed stream holds only each
    lane's novel suffix (positions start at its cached prefix length), and
    attention also reads the cached prefix K/V from the pool through
    ``block_tables`` / ``prefix_lens``.  The prefix rows are not written
    here: suffix positions map past them."""
    P = pool_rows(pools)
    dest = dest_rows.long().clamp(max=P)  # every row >= P is the drop row
    warm = n_prefix_rows > 0

    def attend(i, q, k, v):
        kp, vp = pools[f"k{i}"], pools[f"v{i}"]
        kp[dest] = k[0].to(kp.dtype)
        vp[dest] = v[0].to(vp.dtype)
        kwargs = {}
        if warm:
            kwargs = dict(
                k_pool=kp[:P], v_pool=vp[:P],
                block_tables=block_tables, prefix_lens=prefix_lens,
                n_prefix_rows=n_prefix_rows, block_size=block_size,
            )
        return ragged_prefill_attention(
            q[0], k[0], v[0], seg_ids, positions,
            sliding_window=cfg.sliding_window, **kwargs,
        )[None]

    x = decoder_layer_stack(
        params, cfg, ids[None, :], positions[None, :], rope_len, attend
    )
    x_last = x[0][last_rows.long()]  # [B, hidden]
    return decoder_head(params, cfg, x_last[:, None, :])[:, 0]


def paged_decode_forward(
    params: Params,
    cfg: DecoderConfig,
    pools: PagedPools,
    block_tables: torch.Tensor,  # [S, NB] int32; entries >= n_blocks are holes
    tok: torch.Tensor,  # [S, s] next token(s) per lane (s=1 plain, K verify)
    lengths: torch.Tensor,  # [S] tokens already in each lane's KV
    *,
    block_size: int,
    rope_len: int,
) -> torch.Tensor:
    """Advance every lane ``s`` tokens against the block pool: write each
    new token's K/V at its table-mapped row (in place), attend through the
    table.  A write past a lane's allocated blocks (holes, retired lanes
    whose row went sentinel) lands on the drop row; the batcher's capacity
    guard stops live lanes before that.  Returns logits [S, s, vocab] f32."""
    S, s = tok.shape
    nb = block_tables.shape[1]
    P = pool_rows(pools)
    n_blocks = P // block_size

    pos = lengths.long()[:, None] + torch.arange(s, device=tok.device)[None, :]
    blk_idx = pos // block_size
    blk = torch.gather(block_tables.long(), 1, blk_idx.clamp(max=nb - 1))
    dest = torch.where(
        (blk_idx < nb) & (blk < n_blocks),
        blk * block_size + pos % block_size,
        P,
    ).reshape(-1)
    rope_pos = pos.clamp(max=rope_len - 1)
    attn_lengths = lengths + s

    def attend(i, q, k, v):
        kp, vp = pools[f"k{i}"], pools[f"v{i}"]
        kp[dest] = k.reshape(S * s, *k.shape[2:]).to(kp.dtype)
        vp[dest] = v.reshape(S * s, *v.shape[2:]).to(vp.dtype)
        return paged_decode_attention(
            q, kp[:P], vp[:P], block_tables, attn_lengths,
            block_size=block_size, q_offset=lengths,
            sliding_window=cfg.sliding_window,
        )

    x = decoder_layer_stack(params, cfg, tok, rope_pos, rope_len, attend)
    return decoder_head(params, cfg, x)
