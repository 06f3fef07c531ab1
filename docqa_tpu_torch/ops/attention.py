"""Attention: the plain PyTorch version and the Hopper flash kernel's wrapper.

Counterpart of ``docqa_tpu/ops/attention.py`` (``attention_reference``,
``flash_attention``, ``attention``).  Layouts, as in the reference:

  q        [batch, q_len, num_q_heads, head_dim]
  k, v     [batch, kv_len, num_kv_heads, head_dim]   (q_heads % kv_heads == 0)
  lengths  [batch] int — valid KV prefix per example
  q_offset [batch] int — absolute position of q[:, 0]

``flash_attention`` on a CUDA tensor launches the hand-written kernels in
``csrc/flash_attention.cu``, which replace the Pallas TPU kernel
``docqa_tpu/ops/attention.py::_flash_kernel``; on a CPU tensor it runs
``attention_reference``, the plain version the kernels are held against.
:func:`plan_flash` picks one of three paths from dtype and static shapes:

* ``decode`` (bf16, sq <= 16): split-kv with GQA packing on ``mma.sync``
  tensor cores; memory-bound (the live K/V bytes / 3.35 TB/s on an H100).
  The splits tile ``[0, skv)`` by shape alone, never by ``lengths``, so
  the step needs no host sync.  :func:`split_kv_reference` is its plain
  version of the split-and-merge arithmetic, for the tests.
* ``prefill`` (bf16, sq > 16): ``wgmma`` fed by TMA; operation-bound at
  long prompts (4 * d * hq * live pairs / 989 TFLOP/s in bf16).
* ``simt`` (float32): the first port's float32-FMA kernel, kept because
  TF32 tensor cores cannot meet the float32 tolerance.

The continuous batcher's attention lives here too: ``paged_decode_attention``
runs the ``decode`` path in paged mode (K/V rows of a flat block pool
read through a block table inside the kernel; ``gather_paged_kv`` +
``attention_reference`` is its plain version), and
``ragged_prefill_attention`` is plain PyTorch, as the reference leaves it
to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from docqa_tpu_torch.ops import _kernels

NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
DECODE_MAX_Q = 16     # q rows per call on the split-kv path (decode, verify)
DECODE_MAX_ROWS = 64  # packed groups * sq rows: four 16-row mma tiles
SPLIT_TILE = 64       # kv rows per tile of the split-kv kernel
PREFILL_TILE = 64     # q rows per consumer warpgroup of the prefill kernel
H100_SMS = 132
PATHS = ("simt", "decode", "prefill")  # the C entry point's path numbers


class FlashPlan(NamedTuple):
    path: str            # "decode", "prefill" or "simt"
    num_splits: int      # kv splits (decode path; 1 elsewhere)
    split_tiles: int     # SPLIT_TILE-row tiles per split (decode; 0 elsewhere)
    prefill_groups: int  # consumer warpgroups per block (prefill; 0 elsewhere)


def plan_flash(dtype, b: int, sq: int, skv: int, hq: int, hkv: int,
               num_sms: int = H100_SMS) -> FlashPlan:
    """The kernel path and its launch shape, from static shapes alone — no
    ``lengths``, so a decode step's launch never waits on the device.

    Decode splits the kv axis so that about two blocks per SM are in flight
    (``b * hkv`` blocks per split); prefill takes two 64-row warpgroups per
    block (half the K/V re-reads) when the grid still holds two blocks per
    SM at that size."""
    if dtype != torch.bfloat16:
        return FlashPlan("simt", 1, 0, 0)
    if sq <= DECODE_MAX_Q and (hq // hkv) * sq <= DECODE_MAX_ROWS:
        tiles = max(1, math.ceil(skv / SPLIT_TILE))
        want = math.ceil(2 * num_sms / (b * hkv))
        per = math.ceil(tiles / max(1, min(tiles, want)))
        return FlashPlan("decode", math.ceil(tiles / per), per, 0)
    pairs = (math.ceil(sq / PREFILL_TILE) // 2) * hq * b
    return FlashPlan("prefill", 1, 0, 2 if pairs >= 2 * num_sms else 1)


def split_bounds(skv: int, num_splits: int) -> List[Tuple[int, int]]:
    """The kv row range [lo, hi) of each split, as the decode kernel cuts
    them: whole SPLIT_TILE tiles, the same number per split, the last one
    clipped at ``skv``.  ``num_splits`` is an upper bound (the plan's
    count is exact)."""
    tiles = max(1, math.ceil(skv / SPLIT_TILE))
    per = math.ceil(tiles / max(1, min(tiles, num_splits)))
    return [
        (i * per * SPLIT_TILE, min(skv, (i + 1) * per * SPLIT_TILE))
        for i in range(math.ceil(tiles / per))
    ]


def live_mask(b, sq, skv, lengths, q_offset, causal, sliding_window, dev):
    """[b, sq, skv] bool: the (q row, kv row) pairs attended.  Defaults as
    in :func:`attention_reference`: no ``lengths`` = all of skv; causal
    with no ``q_offset`` aligns the ends of q and kv."""
    kv_pos = torch.arange(skv, device=dev)[None, None, :]
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if lengths is not None:
        mask = mask & (kv_pos < lengths.to(dev)[:, None, None])
    if causal:
        if q_offset is None:
            end = lengths.to(dev) if lengths is not None else torch.full((b,), skv, device=dev)
            q_offset = end - sq
        q_abs = torch.arange(sq, device=dev)[None, :, None] + q_offset.to(dev)[:, None, None]
        mask = mask & (kv_pos <= q_abs)
        if sliding_window is not None:
            mask = mask & (kv_pos > q_abs - sliding_window)
    return mask


def attention_reference(
    q,
    k,
    v,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
):
    """Plain attention: f32 softmax over f32 scores; a row with no valid
    kv position outputs zeros.  ``q_offset`` defaults to aligning the ends
    of q and kv when causal (prefill/decode convention)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if sliding_window is not None and not causal:
        raise ValueError("sliding_window requires causal=True (bidirectional local attention is not implemented)")

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=2)
        vf = vf.repeat_interleave(groups, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)  # [b, h, sq, skv]
    mask = live_mask(b, sq, skv, lengths, q_offset, causal, sliding_window, q.device)[:, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # a row with no valid kv position (padding rows) outputs zeros,
    # matching the kernel
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def split_kv_reference(
    q,
    k,
    v,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    num_splits: int = 1,
):
    """The decode path's arithmetic in plain PyTorch, float32: each split of
    :func:`split_bounds` keeps its own (running max m, sum l, unnormalised
    output o); a split with nothing live holds the empty state (m = -inf,
    l = 0).  The merge weighs split i by exp(m_i - M), M the largest m_i,
    skips empty splits, and divides by the weighted l; a row with no live
    kv anywhere outputs 0.  Used by the tests only."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float() * scale
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    live = live_mask(b, sq, skv, lengths, q_offset, causal, sliding_window, dev)[:, None]
    ms, ls, os_ = [], [], []
    for lo, hi in split_bounds(skv, num_splits):
        sl = slice(lo, hi)
        s_i = scores[..., sl].masked_fill(~live[..., sl], -math.inf)
        m_i = s_i.amax(dim=-1)  # -inf where the split holds nothing live
        p_i = torch.exp(s_i - torch.where(torch.isinf(m_i), 0.0, m_i)[..., None])
        ms.append(m_i)
        ls.append(p_i.sum(dim=-1))
        os_.append(torch.einsum("bhqk,bkhd->bhqd", p_i, vf[:, sl]))
    m = torch.stack(ms)  # [splits, b, h, sq]
    big = m.amax(dim=0)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(big), 0.0, big)))
    den = (w * torch.stack(ls)).sum(dim=0)
    num = (w[..., None] * torch.stack(os_)).sum(dim=0)
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # [b, sq, h, d]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _flash_fn():
    fn = _kernels.load("flash_attention").docqa_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7  # q, k, v, o, lengths, q_offset, strides
        + [ctypes.c_int] * 8  # batch, sq, skv, hq, hkv, head_dim, causal, window
        + [ctypes.c_float]  # scale
        + [ctypes.c_int] * 5  # is_bf16, path, num_splits, split_tiles, prefill_groups
        + [ctypes.c_void_p] * 3  # part_o, part_ml, stream
    )
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v, lengths, q_offset, sliding_window, causal):
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [b, s, h, d], got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on head_dim")
        # the kernel reads 16-byte vectors along head_dim
        if t.data_ptr() % 16 or any(
            st * t.element_size() % 16 for st in t.stride()[:3]
        ):
            raise ValueError(f"{name} is not 16-byte aligned per row")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash kernel takes {DTYPES}, got {q.dtype}")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q "
            f"{tuple(q.shape)}"
        )
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    for name, t in (("lengths", lengths), ("q_offset", q_offset)):
        if t.shape != (b,) or t.device != q.device:
            raise ValueError(f"{name} must be [{b}] on {q.device}")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal=True (bidirectional local attention is not implemented)")
        if int(sliding_window) <= 0:
            raise ValueError(f"sliding_window must be positive, got {sliding_window}")


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
):
    """Forward-only flash attention.  CPU tensors take
    :func:`attention_reference`; CUDA tensors launch the Hopper kernel of
    :func:`plan_flash`'s path or raise — there is no fallback on the card.
    Counts one launch under ``flash_attention`` and one under
    ``flash_attention.<path>``.

    The kernel has no backward (the reference's has none either), so an
    input that requires grad while grad mode is on raises on both devices:
    on the card its output would carry no ``grad_fn`` and every gradient
    through attention would be dropped silently.  Training passes
    ``use_flash=False`` to the trunks, which calls
    :func:`attention_reference` directly."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError(
            "flash_attention is forward-only and cannot be differentiated: "
            "train with use_flash=False (attention_reference under autograd)"
        )
    if q.device.type == "cpu":
        return attention_reference(
            q, k, v, causal=causal, lengths=lengths, q_offset=q_offset,
            sliding_window=sliding_window, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if lengths is None:
        lengths = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if q_offset is None:
        q_offset = lengths - sq if causal else torch.zeros_like(lengths)
    q_offset = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    _check_cuda_inputs(q, k, v, lengths, q_offset, sliding_window, causal)

    plan = plan_flash(q.dtype, b, sq, skv, hq, hkv, _num_sms(q.device.index or 0))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    part_o = part_ml = None
    if plan.path == "decode" and plan.num_splits > 1:
        rows = (hq // hkv) * sq
        part_o = torch.empty((b, hkv, plan.num_splits, rows, d),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hkv, plan.num_splits, rows, 2),
                              dtype=torch.float32, device=q.device)
    rc = _flash_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), q_offset.data_ptr(), ctypes.addressof(strides),
        b, sq, skv, hq, hkv, d, int(causal), int(sliding_window or 0),
        float(scale), int(q.dtype == torch.bfloat16), PATHS.index(plan.path),
        plan.num_splits, plan.split_tiles, plan.prefill_groups,
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise _kernels.KernelError(
            f"flash_attention {plan.path} kernel launch failed: CUDA error {rc}"
        )
    _kernels.count("flash_attention", f"flash_attention.{plan.path}")
    return out


def attention(q, k, v, **kwargs):
    """Dispatcher: the flash wrapper decides by the tensors' device (the
    kernel on a card, the plain version on the CPU)."""
    return flash_attention(q, k, v, **kwargs)


# --------------------------------------------------------------------------
# Ragged / paged attention (block-table KV), counterparts of the reference's
# ragged_prefill_attention, gather_paged_kv and paged_decode_attention
# --------------------------------------------------------------------------

# Sequence starts inside a packed ragged-prefill batch are aligned to this
# many rows, and a shared prefix-cache run is a multiple of it.  The
# reference aligns for XLA's bitwise serve == solo parity; the port keeps
# the value so the prefix cache's sharing unit is the reference's.
RAGGED_ALIGN = 128


def ragged_prefill_attention(q, k, v, seg_ids, positions, *,
                             sliding_window=None, scale=None,
                             k_pool=None, v_pool=None, block_tables=None,
                             prefix_lens=None, n_prefix_rows=0,
                             block_size=None):
    """Self-attention over a PACKED batch of variable-length prompts, in
    plain PyTorch (the reference leaves it to XLA; its hand kernel is a
    later slice).

    q, k, v   [T, heads, d] — one flat token axis, each prompt a contiguous
              run of rows (starts RAGGED_ALIGN-aligned)
    seg_ids   [T] — sequence id per token; negative = padding row
    positions [T] — position of each token within its own sequence

    A token attends within its own segment, causally by position (plus the
    optional sliding window); f32 softmax; padding rows output zeros.
    Computed in RAGGED_ALIGN-row query blocks, so the score transient is
    heads x 128 x T, never heads x T x T.

    WARM mode (``n_prefix_rows > 0``): each segment also attends a cached
    prompt prefix read from the pool ``k_pool``/``v_pool`` [P, hkv, d]
    through its block table: per query block, the owning lane's first
    ``prefix_lens[lane]`` pool rows (in position order, ``n_prefix_rows``
    columns, the rest masked) come ahead of the packed keys in one
    softmax.  Aligned segment starts make every query block belong to one
    lane (or be padding)."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=1)
        vf = vf.repeat_interleave(groups, dim=1)
    valid = seg_ids >= 0
    warm = n_prefix_rows > 0
    if warm:
        if t % RAGGED_ALIGN:
            raise ValueError(
                "warm ragged prefill needs a RAGGED_ALIGN-multiple packed "
                f"axis (got T={t})"
            )
        pool_rows = k_pool.shape[0]
        n_blocks = pool_rows // block_size
        pfx_cols = torch.arange(n_prefix_rows, device=dev)

    def attend_rows(lo: int, hi: int):
        qb = qf[lo:hi]
        seg_q = seg_ids[lo:hi]
        pos_q = positions[lo:hi]
        scores = torch.einsum("qhd,khd->hqk", qb, kf)  # [hq, bq, T]
        mask = (
            (seg_q[:, None] == seg_ids[None, :])
            & (valid[lo:hi][:, None] & valid[None, :])
            & (positions[None, :] <= pos_q[:, None])
        )
        if sliding_window is not None:
            mask &= positions[None, :] > pos_q[:, None] - sliding_window
        mask = mask[None]
        if not warm:
            scores = scores.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
            return torch.einsum("hqk,khd->qhd", probs, vf)
        # the block's lane (-1 when all padding), read on the device: no
        # host sync
        lane = seg_q.max()
        lane_c = lane.clamp(min=0)
        blk = block_tables[lane_c].long()[pfx_cols // block_size]
        rows = (blk * block_size + pfx_cols % block_size).clamp(max=pool_rows - 1)
        kp = k_pool[rows].float()  # [PFX, hkv, d]
        vp = v_pool[rows].float()
        if groups > 1:
            kp = kp.repeat_interleave(groups, dim=1)
            vp = vp.repeat_interleave(groups, dim=1)
        plen = prefix_lens[lane_c]
        scores_p = torch.einsum("qhd,khd->hqk", qb, kp)  # [hq, bq, PFX]
        mask_p = (
            (lane >= 0)
            & valid[lo:hi][:, None]
            & (pfx_cols[None, :] < plen)
            & (blk[None, :] < n_blocks)
            & (pfx_cols[None, :] <= pos_q[:, None])
        )
        if sliding_window is not None:
            mask_p &= pfx_cols[None, :] > pos_q[:, None] - sliding_window
        full_mask = torch.cat([mask_p[None], mask], dim=-1)
        full_scores = torch.cat([scores_p, scores], dim=-1).masked_fill(
            ~full_mask, NEG_INF
        )
        probs = torch.softmax(full_scores, dim=-1)
        probs = torch.where(full_mask.any(dim=-1, keepdim=True), probs, 0.0)
        return torch.einsum("hqk,khd->qhd", probs, torch.cat([vp, vf], dim=0))

    if t % RAGGED_ALIGN or t <= RAGGED_ALIGN:
        out = attend_rows(0, t)
    else:
        out = torch.cat(
            [attend_rows(lo, lo + RAGGED_ALIGN) for lo in range(0, t, RAGGED_ALIGN)]
        )
    return out.to(q.dtype)


def gather_paged_kv(pool, block_tables, block_size):
    """A per-sequence contiguous KV view gathered out of a flat block pool:
    pool [P, kv_heads, d], block_tables [S, NB] (ids >= P / block_size are
    holes, clamped here and masked later by ``lengths``) -> [S, NB *
    block_size, kv_heads, d], row p of sequence s its token position p."""
    S, nb = block_tables.shape
    cols = torch.arange(nb * block_size, device=pool.device)
    blk = block_tables.long()[:, cols // block_size]  # [S, L]
    rows = (blk * block_size + cols[None, :] % block_size).clamp(max=pool.shape[0] - 1)
    return pool[rows]


@functools.lru_cache(maxsize=None)
def _paged_fn():
    fn = _kernels.load("flash_attention").docqa_flash_decode_paged
    fn.argtypes = (
        [ctypes.c_void_p] * 8  # q, k_pool, v_pool, o, lengths, q_offset, tables, strides
        + [ctypes.c_int] * 9  # batch, sq, nb, block_size, pool_rows, hq, hkv, head_dim, window
        + [ctypes.c_float]  # scale
        + [ctypes.c_int] * 2  # num_splits, split_tiles
        + [ctypes.c_void_p] * 3  # part_o, part_ml, stream
    )
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           block_size, q_offset=None, sliding_window=None,
                           scale=None):
    """Decode / verify attention through a block table (the batcher's
    steps), causal.

    q            [S, s, q_heads, d] (s = 1 plain step, K spec verify)
    k/v_pool     [P, kv_heads, d] flat block pool
    block_tables [S, NB] int; ids >= P / block_size are holes
    lengths      [S] valid kv length per sequence AFTER this step
    q_offset     [S] position of q row 0 (default ``lengths - s``)

    A CPU tensor takes the plain version, :func:`gather_paged_kv` +
    :func:`attention_reference`.  A CUDA tensor launches K1's split-kv
    decode kernel in paged mode or raises (bf16 and the decode path only):
    row p of lane s is read at pool row ``min(table[s, p // block_size] *
    block_size + p % block_size, P - 1)`` inside the kernel's cp.async
    producer, so the gather is never materialised, holes clamp like
    :func:`gather_paged_kv` and ``lengths`` masks them.  The plan comes
    from ``skv = NB * block_size`` and the shapes alone, never from
    ``lengths`` or table contents.  Counts one launch under
    ``flash_attention`` and one under ``flash_attention.decode_paged``."""
    if q.device.type == "cpu":
        k = gather_paged_kv(k_pool, block_tables, block_size)
        v = gather_paged_kv(v_pool, block_tables, block_size)
        return attention_reference(
            q, k, v, causal=True, lengths=lengths, q_offset=q_offset,
            sliding_window=sliding_window, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    S, sq, hq, d = q.shape
    if k_pool.dim() != 3 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools must be [P, kv_heads, d], got {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}"
        )
    P, hkv = k_pool.shape[0], k_pool.shape[1]
    block_size = int(block_size)
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != S
            or block_tables.device != q.device):
        raise ValueError(f"block_tables must be [{S}, NB] on {q.device}")
    nb = block_tables.shape[1]
    skv = nb * block_size
    tables = block_tables.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if q_offset is None:
        q_offset = lengths - sq
    q_offset = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    # the pools seen as [S, P, hkv, d] with a zero batch stride: the same
    # checks as the contiguous path (device, dtype, 16-byte rows, heads)
    k4 = k_pool.unsqueeze(0).expand(S, -1, -1, -1)
    v4 = v_pool.unsqueeze(0).expand(S, -1, -1, -1)
    _check_cuda_inputs(q, k4, v4, lengths, q_offset, sliding_window, True)
    plan = plan_flash(q.dtype, S, sq, skv, hq, hkv, _num_sms(q.device.index or 0))
    if plan.path != "decode":
        raise ValueError(
            "paged attention runs on K1's split-kv decode path only (bf16, "
            f"q_len <= {DECODE_MAX_Q}, groups * q_len <= {DECODE_MAX_ROWS}); "
            f"got {q.dtype}, q_len {sq}, groups {hq // hkv}"
        )
    out = torch.empty((S, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], 0, *k_pool.stride()[:2], 0, *v_pool.stride()[:2],
        *out.stride()[:3],
    )
    part_o = part_ml = None
    if plan.num_splits > 1:
        rows = (hq // hkv) * sq
        part_o = torch.empty((S, hkv, plan.num_splits, rows, d),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((S, hkv, plan.num_splits, rows, 2),
                              dtype=torch.float32, device=q.device)
    rc = _paged_fn()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), q_offset.data_ptr(), tables.data_ptr(),
        ctypes.addressof(strides),
        S, sq, nb, block_size, P, hq, hkv, d, int(sliding_window or 0),
        float(scale), plan.num_splits, plan.split_tiles,
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise _kernels.KernelError(
            f"flash_attention decode_paged kernel launch failed: CUDA error {rc}"
        )
    _kernels.count("flash_attention", "flash_attention.decode_paged")
    return out
