"""Rotary position embeddings, split-halves convention (Llama/Mistral).
Counterpart of ``docqa_tpu/ops/rope.py``; angles and rotation in float32.
"""

from __future__ import annotations

import torch


def rope_angles(head_dim: int, max_len: int, theta: float = 10000.0,
                device=None):
    """Return (cos, sin), each [max_len, head_dim/2], float32."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    # a Python-float base: a tensor of theta made on the card would be a
    # host-to-device copy, which waits for the device on every forward
    inv_freq = 1.0 / torch.pow(float(theta), exponent)
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)  # [max_len, head_dim/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin, positions):
    """Rotate q or k.

    x: [batch, seq, heads, head_dim]; cos, sin: [max_len, head_dim/2];
    positions: [batch, seq] absolute positions, each < max_len (the decode
    engine clamps them to the cache length).
    """
    dtype = x.dtype
    c = cos[positions][:, :, None, :]  # [b, s, 1, hd/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
