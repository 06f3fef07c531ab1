"""Port parity, paged KV layer: docqa_tpu_torch.engines.paged and the
ragged/paged attention ops against docqa_tpu's (CPU, float32, 2 layers).

* Host half: the allocator and prefix-cache cases of tests/test_paged.py
  and tests/test_prefix.py run against the port's classes, plus a seeded
  operation trace replayed on both packages' allocators (free lists,
  refcounts and the block-second ledger must agree exactly).
* Device half: ``ragged_prefill_forward`` (cold and warm) and
  ``paged_decode_forward`` (q_len 1 and 4) against the reference on the
  same numpy-seeded weights, ids, pools and tables.  Tolerance 1e-5 abs on
  logits and written pool rows: float32 throughout, the frameworks differ
  only in summation order.  The attention ops alone: 2e-5 (the ops tests'
  tolerance).  The port's pools carry one drop row past the reference's
  P rows; rows [0, P) are compared.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.engines import paged as jpaged
from docqa_tpu_torch import weights
from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.engines import paged
from docqa_tpu_torch.engines.paged import (
    BlockAllocator,
    OutOfBlocks,
    PrefixCache,
    share_alignment,
)
from docqa_tpu_torch.ops import attention as attn

# the reference's ops package re-exports a function named `attention`
jattn = importlib.import_module("docqa_tpu.ops.attention")

torch.set_num_threads(1)

DEC = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32")
SEED = 7
ALIGN = share_alignment(16)  # 128 for 16-token blocks
ATOL = 1e-5


def _ctx(n=200, seed=3):
    return [(seed + i * 7) % 120 + 1 for i in range(n)]


# ---- host half --------------------------------------------------------------


class TestBlockAllocator:
    def test_all_or_nothing_and_stats(self):
        a = BlockAllocator(n_blocks=8, block_size=4)
        t = a.new_table()
        t.ensure(9)  # 3 blocks
        assert len(t.blocks) == 3 and t.capacity == 12
        assert a.blocks_in_use == 3 and a.n_free == 5
        t.ensure(10)  # already covered
        assert len(t.blocks) == 3
        with pytest.raises(OutOfBlocks):
            t.ensure(8 * 4 + 1)
        assert a.blocks_in_use == 3 and a.n_free == 5  # took nothing

    def test_fragmentation_reuse_after_mixed_retirement(self):
        a = BlockAllocator(n_blocks=6, block_size=2)
        t1, t2, t3 = a.new_table(), a.new_table(), a.new_table()
        for t in (t1, t2, t3):
            t.ensure(4)
        assert a.n_free == 0
        t2.release()
        t1.release()
        big = a.new_table()
        big.ensure(8)  # spans both freed tables' blocks
        assert a.blocks_in_use == 6
        big.release()
        t3.release()
        assert a.blocks_in_use == 0 and a.n_free == 6

    def test_release_idempotent_double_free_raises(self):
        a = BlockAllocator(n_blocks=4, block_size=2)
        t = a.new_table()
        t.ensure(6)
        t.release()
        t.release()  # idempotent
        assert a.blocks_in_use == 0
        t2 = a.new_table()
        t2.ensure(2)
        stolen = list(t2.blocks)
        t2.release()
        forged = a.new_table()
        forged.blocks = stolen
        with pytest.raises(RuntimeError, match="double free"):
            forged.release()

    def test_grow_after_release_refused(self):
        a = BlockAllocator(n_blocks=4, block_size=2)
        t = a.new_table()
        t.ensure(2)
        t.release()
        with pytest.raises(OutOfBlocks):
            t.ensure(4)

    def test_shared_release_is_not_a_free(self):
        a = BlockAllocator(n_blocks=8, block_size=4)
        owner = a.new_table()
        owner.ensure(8)
        shared_ids = list(owner.blocks)
        t2 = a.new_table()
        a.share(t2, shared_ids)
        assert a.refcount(shared_ids[0]) == 2
        assert a.blocks_in_use == 2  # unique blocks, not references
        t2.release()
        assert a.refcount(shared_ids[0]) == 1 and a.blocks_in_use == 2
        owner.release()
        assert a.blocks_in_use == 0 and a.n_free == 8

    def test_double_free_still_raises_under_sharing(self):
        a = BlockAllocator(n_blocks=4, block_size=4)
        owner = a.new_table()
        owner.ensure(8)
        stolen = list(owner.blocks)
        t2 = a.new_table()
        a.share(t2, stolen)
        t2.release()
        owner.release()
        forged = a.new_table()
        forged.blocks = stolen
        with pytest.raises(RuntimeError, match="double free"):
            forged.release()

    def test_share_of_free_block_raises(self):
        a = BlockAllocator(n_blocks=4, block_size=4)
        t = a.new_table()
        t.ensure(4)
        freed = list(t.blocks)
        t.release()
        with pytest.raises(RuntimeError, match="share of a free block"):
            a.share(a.new_table(), freed)

    def test_cow_grow_never_hands_out_shared_blocks(self):
        a = BlockAllocator(n_blocks=8, block_size=4)
        owner = a.new_table()
        owner.ensure(8)
        shared_ids = set(owner.blocks)
        warm = a.new_table()
        a.share(warm, list(owner.blocks))
        owner.release()  # warm keeps them alive
        grower = a.new_table()
        grower.ensure(16)
        assert shared_ids.isdisjoint(grower.blocks)
        warm.ensure(16)  # private blocks past the shared prefix
        assert set(warm.blocks[warm.n_shared:]).isdisjoint(shared_ids)
        with pytest.raises(OutOfBlocks):
            a.new_table().ensure(4)
        grower.release()
        warm.release()
        assert a.blocks_in_use == 0 and a.n_free == 8

    def test_block_seconds_exact_under_sharing(self):
        """Shared blocks bill each holder 1/refcount; the bills sum to the
        pool's in-use integral and the residual is exactly 0 once every
        table released."""
        clock = [0.0]
        a = BlockAllocator(n_blocks=4, block_size=4, now_fn=lambda: clock[0])
        owner = a.new_table()
        owner.ensure(8)  # 2 blocks at t=0
        clock[0] = 2.0
        sharer = a.new_table()
        a.share(sharer, owner.blocks)
        clock[0] = 6.0
        sharer.release()  # 2 blocks x 4 s / 2 holders
        assert sharer.billed_block_seconds == pytest.approx(4.0)
        clock[0] = 7.0
        owner.release()  # 2 x 2 s alone + 2 x 4 s / 2 + 2 x 1 s alone
        assert owner.billed_block_seconds == pytest.approx(10.0)
        ledger = a.block_seconds()
        assert ledger["total"] == pytest.approx(14.0)
        assert ledger["residual"] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("trace_seed", [0, 1, 2])
def test_allocator_trace_matches_reference(trace_seed):
    """A seeded trace of grow / share / release on both packages'
    allocators (same fake clock): every outcome, free list, refcount and
    the block-second ledger agree exactly."""
    rng = np.random.default_rng(trace_seed)
    clock = [0.0]
    allocs = [BlockAllocator(12, 4, now_fn=lambda: clock[0]),
              jpaged.BlockAllocator(12, 4, now_fn=lambda: clock[0])]
    tables = [[], []]
    for _ in range(60):
        clock[0] += float(rng.integers(1, 5))
        op = int(rng.integers(3))
        pick = int(rng.integers(1 << 30))
        n = int(rng.integers(1, 20))
        outcome = []
        for a, ts in zip(allocs, tables):
            live = [t for t in ts if not t.released]
            try:
                if op == 0 or not live:
                    t = a.new_table()
                    ts.append(t)
                    t.ensure(n)
                elif op == 1:
                    t = a.new_table()
                    ts.append(t)
                    src = live[pick % len(live)]
                    a.share(t, src.blocks[: max(1, len(src.blocks) // 2)])
                else:
                    live[pick % len(live)].release()
                outcome.append("ok")
            except (OutOfBlocks, jpaged.OutOfBlocks, ValueError) as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1]
        assert allocs[0]._free == allocs[1]._free
        assert allocs[0]._refs == allocs[1]._refs
        assert [t.blocks for t in tables[0]] == [t.blocks for t in tables[1]]
    assert allocs[0].block_seconds() == pytest.approx(allocs[1].block_seconds())


class TestPrefixCache:
    def test_alignment_matches_reference(self):
        assert attn.RAGGED_ALIGN == jattn.RAGGED_ALIGN == 128
        for bs in (8, 16, 48):
            assert share_alignment(bs) == jpaged.share_alignment(bs)

    def test_verified_aligned_acquire_and_suffix_floor(self):
        a = BlockAllocator(n_blocks=64, block_size=16)
        cache = PrefixCache(a, ALIGN, max_entries=4)
        ids = _ctx(2 * ALIGN + 7)
        t = a.new_table()
        t.ensure(len(ids))
        assert cache.insert("k", ids, t)
        warm = a.new_table()
        assert cache.acquire("k", ids[: 2 * ALIGN] + [9, 9, 9], warm) == 2 * ALIGN
        assert warm.n_shared == 2 * ALIGN // 16
        warm.release()
        # the suffix keeps >= 1 real token: one align unit held back
        warm2 = a.new_table()
        assert cache.acquire("k", ids[: 2 * ALIGN], warm2) == ALIGN
        warm2.release()
        # a mismatch in the first unit is a miss, never wrong attention
        warm3 = a.new_table()
        assert cache.acquire("k", [5] + ids[1:], warm3) == 0
        warm3.release()
        t.release()
        cache.clear()
        assert a.blocks_in_use == 0

    def test_lru_eviction_frees_only_cache_pinned_blocks(self):
        a = BlockAllocator(n_blocks=16, block_size=16)
        cache = PrefixCache(a, ALIGN, max_entries=4)
        t1 = a.new_table()
        t1.ensure(ALIGN)
        cache.insert("hot", _ctx(ALIGN, 1), t1)
        t2 = a.new_table()
        t2.ensure(ALIGN)
        cache.insert("cold", _ctx(ALIGN, 2), t2)
        t2.release()  # "cold" pinned by the cache alone
        assert a.n_free == 0
        assert cache.evict_for(8) >= 1
        assert a.n_free >= 8
        assert not t1.released and a.refcount(t1.blocks[0]) >= 1
        t1.release()
        cache.clear()
        assert a.blocks_in_use == 0

    def test_stats_match_reference_on_the_same_sequence(self):
        caches = []
        for mod in (paged, jpaged):
            a = mod.BlockAllocator(n_blocks=128, block_size=16)
            c = mod.PrefixCache(a, ALIGN, max_entries=2)
            for key, n in (("a", 300), ("b", 140), ("a", 260), ("c", 200)):
                ids = _ctx(n, seed=len(key))
                t = a.new_table()
                shared = c.acquire(key, ids, t)
                t.ensure(n)
                c.credit(shared)
                c.insert(key, ids, t)
                t.release()
            caches.append((c.stats(), a.blocks_in_use))
            c.clear()
            assert a.blocks_in_use == 0
        assert caches[0] == caches[1]


# ---- device half ------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = DecoderConfig(**DEC), JDecoderConfig(**DEC)
    host = weights.host_init_decoder_params(cfg, SEED)
    return (
        cfg, weights.to_torch(host, "cpu"),
        jcfg, {k: jnp.asarray(v) for k, v in host.items()},
    )


def _pools(cfg, n_blocks, bs, seed):
    """Equal initial pools for both packages: seeded numpy rows (so warm
    prefixes and unwritten rows hold real values); the port's extra drop
    row is zero."""
    rng = np.random.default_rng(seed)
    P = n_blocks * bs
    host = {
        name: rng.standard_normal((P, cfg.num_kv_heads, cfg.head_dim), np.float32)
        for i in range(cfg.num_layers) for name in (f"k{i}", f"v{i}")
    }
    port = paged.init_paged_pools(cfg, n_blocks, bs)
    for name, arr in host.items():
        port[name][:P] = torch.from_numpy(arr)
    return port, {k: jnp.asarray(v) for k, v in host.items()}


def _assert_pools_equal(port, ref, P):
    for name, arr in ref.items():
        np.testing.assert_allclose(port[name][:P].numpy(), np.asarray(arr), atol=ATOL)


def _pack(lanes, bs, n_blocks, blocks_of, T, B, shared=None):
    """numpy packed stream for lanes of token ids; ``blocks_of[l]`` the
    lane's table, ``shared[l]`` its cached prefix length (warm)."""
    shared = shared or [0] * len(lanes)
    P = n_blocks * bs
    ids = np.zeros((T,), np.int32)
    seg = np.full((T,), -1, np.int32)
    pos = np.zeros((T,), np.int32)
    dest = np.full((T,), P, np.int32)
    last = np.zeros((B,), np.int32)
    off = 0
    for lane, (toks, sh) in enumerate(zip(lanes, shared)):
        p = np.arange(sh, len(toks))
        n = len(p)
        ids[off:off + n] = toks[sh:]
        seg[off:off + n] = lane
        pos[off:off + n] = p
        blk = np.asarray(blocks_of[lane])
        dest[off:off + n] = blk[p // bs] * bs + p % bs
        last[lane] = off + n - 1
        off += -(-n // 128) * 128
    return ids, seg, pos, dest, last


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in arrays]


class TestRaggedPrefillForward:
    BS, NB = 16, 64

    def test_cold_matches_reference(self, models):
        cfg, params, jcfg, jparams = models
        rng = np.random.default_rng(11)
        lanes = [list(rng.integers(3, 120, n)) for n in (37, 128, 5)]
        perm = rng.permutation(self.NB)
        blocks_of = [perm[0:3], perm[3:11], perm[11:12]]
        args = _pack(lanes, self.BS, self.NB, blocks_of, T=384, B=4)
        port_pools, ref_pools = _pools(cfg, self.NB, self.BS, seed=1)
        got = paged.ragged_prefill_forward(
            params, cfg, port_pools, *_t(*args), rope_len=512
        )
        want, ref_pools = jpaged.ragged_prefill_forward(
            jparams, jcfg, ref_pools, *map(jnp.asarray, args), rope_len=512
        )
        np.testing.assert_allclose(got[:3].numpy(), np.asarray(want)[:3], atol=ATOL)
        _assert_pools_equal(port_pools, ref_pools, self.NB * self.BS)
        # the padding tokens' writes went to the drop row, not a live row
        assert port_pools["k0"][-1].abs().sum() > 0

    def test_warm_matches_reference(self, models):
        """Two lanes whose first 128 tokens are cached in the pool (random
        rows), each packing only its suffix; a third lane cold."""
        cfg, params, jcfg, jparams = models
        rng = np.random.default_rng(12)
        nb_seq = 16  # blocks per sequence: 256-token capacity
        lanes = [list(rng.integers(3, 120, n)) for n in (148, 188, 9)]
        perm = rng.permutation(self.NB)
        blocks_of = [perm[0:10], perm[10:22], perm[22:23]]
        shared = [128, 128, 0]
        args = _pack(lanes, self.BS, self.NB, blocks_of, T=384, B=3, shared=shared)
        tables = np.full((3, nb_seq), self.NB, np.int32)
        for lane, blk in enumerate(blocks_of):
            tables[lane, : len(blk)] = blk
        plens = np.asarray(shared, np.int32)
        port_pools, ref_pools = _pools(cfg, self.NB, self.BS, seed=2)
        warm = dict(n_prefix_rows=nb_seq * self.BS, block_size=self.BS)
        got = paged.ragged_prefill_forward(
            params, cfg, port_pools, *_t(*args), rope_len=512,
            block_tables=torch.from_numpy(tables),
            prefix_lens=torch.from_numpy(plens).long(), **warm,
        )
        want, ref_pools = jpaged.ragged_prefill_forward(
            jparams, jcfg, ref_pools, *map(jnp.asarray, args), rope_len=512,
            block_tables=jnp.asarray(tables), prefix_lens=jnp.asarray(plens),
            **warm,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        _assert_pools_equal(port_pools, ref_pools, self.NB * self.BS)


class TestPagedDecodeForward:
    @pytest.mark.parametrize("s", [1, 4])
    def test_matches_reference(self, models, s):
        """Three lanes: mid-block, at a block edge, and a retired lane whose
        table row is all holes (its writes are dropped)."""
        cfg, params, jcfg, jparams = models
        bs, n_blocks, nb = 16, 40, 8
        rng = np.random.default_rng(20 + s)
        perm = rng.permutation(n_blocks)
        tables = np.full((3, nb), n_blocks, np.int32)
        tables[0, :4] = perm[:4]  # 64 rows allocated
        tables[1, :8] = perm[4:12]
        lengths = np.asarray([37, 64 + 48 - s, 5], np.int32)
        tok = rng.integers(3, 120, (3, s)).astype(np.int32)
        port_pools, ref_pools = _pools(cfg, n_blocks, bs, seed=3)
        got = paged.paged_decode_forward(
            params, cfg, port_pools, torch.from_numpy(tables),
            torch.from_numpy(tok).long(), torch.from_numpy(lengths),
            block_size=bs, rope_len=512,
        )
        want, ref_pools = jpaged.paged_decode_forward(
            jparams, jcfg, ref_pools, jnp.asarray(tables), jnp.asarray(tok),
            jnp.asarray(lengths), block_size=bs, rope_len=512,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        _assert_pools_equal(port_pools, ref_pools, n_blocks * bs)


class TestAttentionOps:
    def _qkv(self, rng, t, hq, hkv, d):
        return [rng.standard_normal(shape, np.float32)
                for shape in ((t, hq, d), (t, hkv, d), (t, hkv, d))]

    @pytest.mark.parametrize("window", [None, 24])
    def test_ragged_cold_matches_reference(self, window):
        rng = np.random.default_rng(5)
        q, k, v = self._qkv(rng, 256, 4, 2, 16)
        seg = np.full((256,), -1, np.int32)
        pos = np.zeros((256,), np.int32)
        seg[:70], pos[:70] = 0, np.arange(70)
        seg[128:228], pos[128:228] = 1, np.arange(100)
        got = attn.ragged_prefill_attention(
            *map(torch.from_numpy, (q, k, v)), *_t(seg, pos), sliding_window=window,
        )
        want = jattn.ragged_prefill_attention(
            *map(jnp.asarray, (q, k, v, seg, pos)), sliding_window=window,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert not got[70:128].any()  # padding rows output zeros

    def test_ragged_warm_matches_reference(self):
        rng = np.random.default_rng(6)
        bs, n_blocks = 16, 20
        q, k, v = self._qkv(rng, 256, 4, 2, 16)
        kp = rng.standard_normal((n_blocks * bs, 2, 16), np.float32)
        vp = rng.standard_normal((n_blocks * bs, 2, 16), np.float32)
        seg = np.full((256,), -1, np.int32)
        pos = np.zeros((256,), np.int32)
        seg[:40], pos[:40] = 0, 128 + np.arange(40)
        seg[128:150], pos[128:150] = 1, np.arange(22)
        tables = np.full((2, 12), n_blocks, np.int32)
        tables[0, :11] = rng.permutation(n_blocks)[:11]
        plens = np.asarray([128, 0], np.int32)
        kw = dict(n_prefix_rows=192, block_size=bs)
        got = attn.ragged_prefill_attention(
            *map(torch.from_numpy, (q, k, v)), *_t(seg, pos),
            k_pool=torch.from_numpy(kp), v_pool=torch.from_numpy(vp),
            block_tables=torch.from_numpy(tables),
            prefix_lens=torch.from_numpy(plens), **kw,
        )
        want = jattn.ragged_prefill_attention(
            *map(jnp.asarray, (q, k, v, seg, pos)),
            k_pool=jnp.asarray(kp), v_pool=jnp.asarray(vp),
            block_tables=jnp.asarray(tables), prefix_lens=jnp.asarray(plens),
            **kw,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    @pytest.mark.parametrize("s,window", [(1, None), (4, None), (4, 20)])
    def test_paged_decode_matches_reference(self, s, window):
        rng = np.random.default_rng(7 + s)
        bs, n_blocks = 16, 24
        q = rng.standard_normal((3, s, 4, 16), np.float32)
        kp = rng.standard_normal((n_blocks * bs, 2, 16), np.float32)
        vp = rng.standard_normal((n_blocks * bs, 2, 16), np.float32)
        tables = np.full((3, 6), n_blocks, np.int32)  # holes past the rows
        tables[0, :3] = [5, 17, 2]
        tables[1, :6] = rng.permutation(n_blocks)[:6]
        lengths = np.asarray([40, 90, 0], np.int32)
        got = attn.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(tables), torch.from_numpy(lengths),
            block_size=bs, q_offset=torch.from_numpy(lengths - s),
            sliding_window=window,
        )
        want = jattn.paged_decode_attention(
            *map(jnp.asarray, (q, kp, vp, tables, lengths)), block_size=bs,
            q_offset=jnp.asarray(lengths - s), sliding_window=window,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    def test_gather_matches_reference(self):
        rng = np.random.default_rng(8)
        pool = rng.standard_normal((64, 2, 8), np.float32)
        tables = np.asarray([[3, 0, 9], [1, 8, 8]], np.int32)  # 8 = hole
        got = attn.gather_paged_kv(torch.from_numpy(pool), torch.from_numpy(tables), 8)
        want = jattn.gather_paged_kv(jnp.asarray(pool), jnp.asarray(tables), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_paged_wrapper_rejects_other_devices(self):
        x = torch.zeros((1, 1, 2, 32), device="meta")
        pool = torch.zeros((16, 2, 32), device="meta")
        tables = torch.zeros((1, 1), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            attn.paged_decode_attention(
                x, pool, pool, tables, torch.ones(1, dtype=torch.int32),
                block_size=16,
            )
