"""Attention: the plain PyTorch version and the Hopper flash kernel's wrapper.

Counterpart of ``docqa_tpu/ops/attention.py`` (``attention_reference``,
``flash_attention``, ``attention``).  Layouts, as in the reference:

  q        [batch, q_len, num_q_heads, head_dim]
  k, v     [batch, kv_len, num_kv_heads, head_dim]   (q_heads % kv_heads == 0)
  lengths  [batch] int — valid KV prefix per example
  q_offset [batch] int — absolute position of q[:, 0]

``flash_attention`` on a CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``docqa_tpu/ops/attention.py::_flash_kernel``; on a CPU tensor it runs
``attention_reference``, the plain version the kernel is held against.
On an H100 the kernel is memory-bound at decode (K and V bytes of the live
rows / 3.35 TB/s) and compute-bound at long prefill
(4 * sq * skv_live * hq * d / 989 TFLOP/s in bf16).  Its design skips dead
kv tiles and reads each live tile once per (head, q tile), and uses a
16-row q tile for decode and speculative verify; its float32 FMA inner
loops are far from the tensor-core rate, which is later work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from docqa_tpu_torch.ops import _kernels

NEG_INF = -1e30

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
SMALL_Q_TILE = 16  # decode (sq=1) and spec verify (sq=K)
LARGE_Q_TILE = 64


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

    dev = q.device
    kv_pos = torch.arange(skv, device=dev)[None, None, None, :]
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=dev)
    if lengths is not None:
        mask = mask & (kv_pos < lengths.to(dev)[:, None, None, None])
    if causal:
        rows = torch.arange(sq, device=dev)[None, :]
        if q_offset is None:
            end = (
                lengths.to(dev)[:, None]
                if lengths is not None
                else torch.full((b, 1), skv, device=dev)
            )
            q_abs = rows + (end - sq)
        else:
            q_abs = rows + q_offset.to(dev)[:, None]
        q_abs = q_abs[:, None, :, None]  # [b, 1, sq, 1]
        mask = mask & (kv_pos <= q_abs)
        if sliding_window is not None:
            mask = mask & (kv_pos > q_abs - sliding_window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # a row with no valid kv position (padding rows) outputs zeros,
    # matching the kernel
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _flash_fn():
    fn = _kernels.load("flash_attention").docqa_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7  # q, k, v, o, lengths, q_offset, strides
        + [ctypes.c_int] * 8  # batch, sq, skv, hq, hkv, head_dim, causal, window
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    :func:`attention_reference`; CUDA tensors launch the Hopper kernel or
    raise — there is no fallback on the card."""
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

    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    block_q = SMALL_Q_TILE if sq <= SMALL_Q_TILE else LARGE_Q_TILE
    rc = _flash_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), q_offset.data_ptr(), ctypes.addressof(strides),
        b, sq, skv, hq, hkv, d, int(causal), int(sliding_window or 0),
        float(scale), int(q.dtype == torch.bfloat16), block_q,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    _kernels.LAUNCHES["flash_attention"] += 1
    return out


def attention(q, k, v, **kwargs):
    """Dispatcher: the flash wrapper decides by the tensors' device (the
    kernel on a card, the plain version on the CPU)."""
    return flash_attention(q, k, v, **kwargs)
