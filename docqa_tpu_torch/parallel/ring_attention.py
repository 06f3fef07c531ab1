"""Sequence parallelism: ring attention and Ulysses all-to-all, counterpart
of ``docqa_tpu/parallel/ring_attention.py``.

* :func:`ring_attention_local` — each rank keeps its Q shard while the K/V
  shards rotate around the ring (``batch_isend_irecv`` to the next rank,
  from the previous one) in ``n - 1`` rounds, the reference's budget;
  partial results merge with the online-softmax (m, l) accumulation.  Plain
  PyTorch, as the reference's body is jnp.
* :func:`ulysses_attention` — two reshuffles (sequence-sharded ->
  head-sharded and back: three ``all_to_all``s in, one out), and one
  full-context attention over the local heads through
  :func:`docqa_tpu_torch.ops.attention.attention`: K1 on a card, its plain
  version on the CPU.  Needs the q heads to divide the group.

The global-view entry points take the full ``[b, s, h, d]`` tensors on
every rank of the sequence axis's group (the model axis by default) and
return the full result on every rank (one ``all_gather`` of the output
shards), as the reference's return a global array.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from docqa_tpu_torch.ops.attention import attention
from docqa_tpu_torch.runtime.mesh import (
    MeshContext,
    all_gather,
    all_to_all,
    group_size,
    ring_exchange,
)

NEG_INF = -1e30


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over sequence shards: ``q, k, v`` are this rank's
    ``[b, s_local, heads, d]`` shards (group rank ``i`` holds global
    positions ``[i * s_local, (i + 1) * s_local)``); ``lengths`` [b] are
    global valid-prefix lengths; ``causal`` masks in global positions.
    Returns this rank's output shard; rows with no live position are 0."""
    b, s_loc, hq, d = q.shape
    skv_loc, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    groups = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    n = group_size(group)
    idx = 0 if n == 1 else dist.get_rank(group)
    dev = q.device

    qf = q.float() * scale
    q_abs = idx * s_loc + torch.arange(s_loc, device=dev)

    def merge(t, kc, vc, acc, m, l):
        # kv shards travel at their own head count; expanded inside the step
        ke = kc.repeat_interleave(groups, dim=2) if groups > 1 else kc
        ve = vc.repeat_interleave(groups, dim=2) if groups > 1 else vc
        src = (idx - t) % n
        kv_abs = src * skv_loc + torch.arange(skv_loc, device=dev)
        mask = torch.ones((b, 1, s_loc, skv_loc), dtype=torch.bool, device=dev)
        if lengths is not None:
            mask = mask & (kv_abs[None, None, None, :]
                           < lengths.to(dev)[:, None, None, None])
        if causal:
            mask = mask & (kv_abs[None, None, None, :] <= q_abs[None, None, :, None])
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ke.float())
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, ve.float())
        acc = acc * alpha.permute(0, 2, 1, 3) + pv
        return acc, m_new, l

    acc = torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, s_loc, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, s_loc, 1), dtype=torch.float32, device=dev)
    kc, vc = k, v
    # n - 1 rounds: after round n - 2 every rank holds the last block it
    # needs, and an n-th round would only send the shards home
    for t in range(n - 1):
        acc, m, l = merge(t, kc, vc, acc, m, l)
        kc, vc = ring_exchange((kc, vc), group, "ring_attention")
    acc, _, l = merge(n - 1, kc, vc, acc, m, l)

    lt = l.permute(0, 2, 1, 3)  # [b, sq, h, 1]
    out = acc / lt.clamp_min(1e-30)
    out = torch.where(lt > 0.0, out, torch.zeros_like(out))
    return out.to(q.dtype)


def _seq_group(mesh: MeshContext, seq_axis: Optional[str]):
    """(group, size, this rank's index) of the sequence axis."""
    ax = seq_axis or mesh.model_axis
    return mesh.group(ax), mesh.axis_size(ax), mesh.axis_index(ax)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: MeshContext,
    *,
    seq_axis: Optional[str] = None,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Global view: the full ``[b, s, h, d]`` tensors on every rank of
    ``seq_axis``'s group (default: the model axis); each rank attends its
    sequence shard over the ring, and the output shards are gathered."""
    group, n, i = _seq_group(mesh, seq_axis)
    if q.shape[1] % n:
        raise ValueError(f"seq len {q.shape[1]} not divisible by ring size {n}")
    s_loc = q.shape[1] // n
    sl = slice(i * s_loc, (i + 1) * s_loc)
    out = ring_attention_local(q[:, sl], k[:, sl], v[:, sl], group, causal=causal,
                               lengths=lengths, scale=scale)
    return all_gather(out, group, "ring_attention", dim=1)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: MeshContext,
    *,
    seq_axis: Optional[str] = None,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism over ``seq_axis``'s group (global
    view, as :func:`ring_attention`): sequence shards reshuffled to head
    shards, one full-context attention over the local heads (K1 on a card),
    reshuffled back.  Needs ``q heads % group size == 0``; kv heads that do
    not divide are expanded to the q heads first."""
    group, n, i = _seq_group(mesh, seq_axis)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s % n:
        raise ValueError(f"seq len {s} not divisible by group size {n}")
    if hq % n:
        raise ValueError(f"{hq} heads not divisible by group size {n}")
    if hkv != hq and hkv % n:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s_loc = s // n
    sl = slice(i * s_loc, (i + 1) * s_loc)

    def to_heads(t):
        # [b, s/n, h, d] -> chunks by head block [n, b, s/n, h/n, d] -> the
        # blocks received by sequence shard -> [b, s, h/n, d]
        h = t.shape[2]
        t = t[:, sl].reshape(b, s_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
        t = all_to_all(t, group, "ulysses")
        return t.permute(1, 0, 2, 3, 4).reshape(b, s, h // n, d)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    q_offset = torch.zeros((b,), dtype=torch.int32, device=q.device) if causal else None
    out = attention(qh, kh, vh, causal=causal, lengths=lengths, q_offset=q_offset,
                    scale=scale)
    # [b, s, h/n, d] -> chunks by sequence block -> the head blocks received
    # -> [b, s/n, h, d]
    out = out.reshape(b, n, s_loc, hq // n, d).permute(1, 0, 2, 3, 4)
    out = all_to_all(out, group, "ulysses")
    out = out.permute(1, 2, 0, 3, 4).reshape(b, s_loc, hq, d)
    return all_gather(out, group, "ulysses", dim=1)
