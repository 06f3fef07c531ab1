"""Normalization ops (counterpart of ``docqa_tpu/ops/norms.py``).

Computed in float32 whatever the input dtype, cast back on exit.
"""

from __future__ import annotations

import torch


def layer_norm(x, gamma, beta, eps: float = 1e-12):
    """BERT-style LayerNorm over the last axis (encoder stack)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dtype)


def rms_norm(x, gamma, eps: float = 1e-5):
    """RMSNorm over the last axis (decoder stack, Llama/Mistral-style)."""
    dtype = x.dtype
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * gamma.float()).to(dtype)
