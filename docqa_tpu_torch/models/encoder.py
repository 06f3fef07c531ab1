"""MiniLM-class sentence encoder (BERT stack), counterpart of
``docqa_tpu/models/encoder.py``: post-LN, GELU, learned positions,
token-type embeddings; masked mean pooling + L2 normalization.

Parameters are a flat dict of float32 tensors with the reference's names
(weights [in, out]); each matmul casts its weight to ``cfg.dtype`` as the
reference does.  Attention (non-causal, ``lengths``-masked) goes through
:func:`attention` when ``use_flash`` (the default, serving): the flash
kernel on a card, with head_dim 32 at the MiniLM width.  ``use_flash=False``
calls :func:`attention_reference` on either device: the path training
takes, since the kernel has no backward (the reference trains on its plain
attention too).  Padded batch lanes have length 0 and come out as zeros.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from docqa_tpu_torch.config import EncoderConfig
from docqa_tpu_torch.ops.attention import attention, attention_reference
from docqa_tpu_torch.ops.norms import layer_norm
from docqa_tpu_torch.utils import torch_dtype

Params = Dict[str, torch.Tensor]


def encoder_forward(
    params: Params,
    cfg: EncoderConfig,
    ids: torch.Tensor,  # [b, s] right-padded
    lengths: torch.Tensor,  # [b]
    *,
    use_flash: bool = True,
) -> torch.Tensor:
    """Token-level hidden states [b, s, hidden]."""
    b, s = ids.shape
    h, nh = cfg.hidden_dim, cfg.num_heads
    hd = h // nh
    dtype = torch_dtype(cfg.dtype)
    attend = attention if use_flash else attention_reference

    def dense(x, name):
        return x @ params[f"{name}_w"].to(dtype) + params[f"{name}_b"].to(dtype)

    x = (
        params["tok_emb"][ids]
        + params["pos_emb"][None, :s]
        + params["type_emb"][0][None, None]
    )
    x = layer_norm(x, params["emb_ln_g"], params["emb_ln_b"]).to(dtype)

    for i in range(cfg.num_layers):
        q = dense(x, f"l{i}_q").reshape(b, s, nh, hd)
        k = dense(x, f"l{i}_k").reshape(b, s, nh, hd)
        v = dense(x, f"l{i}_v").reshape(b, s, nh, hd)
        attn = attend(q, k, v, lengths=lengths).reshape(b, s, h)
        attn = dense(attn, f"l{i}_o")
        x = layer_norm(
            x + attn, params[f"l{i}_attn_ln_g"], params[f"l{i}_attn_ln_b"]
        ).to(dtype)

        up = dense(x, f"l{i}_up")
        up = F.gelu(up.float(), approximate="none").to(dtype)
        down = dense(up, f"l{i}_down")
        x = layer_norm(
            x + down, params[f"l{i}_mlp_ln_g"], params[f"l{i}_mlp_ln_b"]
        ).to(dtype)
    return x


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def mean_pool_normalize(hidden, lengths, normalize: bool = True):
    """Masked mean over valid tokens, then L2 normalize (f32)."""
    b, s, _ = hidden.shape
    steps = torch.arange(s, device=hidden.device)[None, :]
    mask = (steps < lengths[:, None]).float()
    summed = torch.einsum("bsh,bs->bh", hidden.float(), mask)
    pooled = summed / mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return _l2_normalize(pooled) if normalize else pooled


def encode_batch(
    params: Params, cfg: EncoderConfig, ids: torch.Tensor, lengths: torch.Tensor,
    *, use_flash: bool = True,
) -> torch.Tensor:
    """[b, s] ids -> [b, embed_dim] f32 embeddings (normalized when
    ``cfg.normalize``)."""
    hidden = encoder_forward(params, cfg, ids, lengths, use_flash=use_flash)
    pooled = mean_pool_normalize(hidden, lengths, normalize=False)
    if cfg.embed_dim != cfg.hidden_dim:
        pooled = pooled @ params["proj_w"].float() + params["proj_b"].float()
    if cfg.normalize:
        pooled = _l2_normalize(pooled)
    return pooled
