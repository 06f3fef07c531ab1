"""MiniLM-class sentence encoder (BERT stack), counterpart of
``docqa_tpu/models/encoder.py``: post-LN, GELU, learned positions,
token-type embeddings; masked mean pooling + L2 normalization.

Parameters are a flat dict of tensors (float32 unless a checkpoint ships
another dtype) with the reference's names
(weights [in, out]); each matmul casts its weight to ``cfg.dtype`` as the
reference does.  Attention (non-causal, ``lengths``-masked) goes through
:func:`attention` when ``use_flash`` (the default, serving): the flash
kernel on a card, with head_dim 32 at the MiniLM width.  ``use_flash=False``
calls :func:`attention_reference` on either device: the path training
takes, since the kernel has no backward (the reference trains on its plain
attention too).  Padded batch lanes have length 0 and come out as zeros.

:func:`load_hf_bert_weights` maps a HF BERT/MiniLM ``model.safetensors``
onto the tree (the port's own safetensors reader, no ``safetensors``
package).
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


# --------------------------------------------------------------------------
# HF weight import (BERT / MiniLM ``model.safetensors``)
# --------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "attention.self.query": ("q_w", "q_b"),
    "attention.self.key": ("k_w", "k_b"),
    "attention.self.value": ("v_w", "v_b"),
    "attention.output.dense": ("o_w", "o_b"),
    "intermediate.dense": ("up_w", "up_b"),
    "output.dense": ("down_w", "down_b"),
}


def load_hf_bert_weights(path: str, cfg: EncoderConfig) -> Params:
    """A HF BERT/MiniLM ``model.safetensors`` (``BertModel`` names, with or
    without the ``bert.`` prefix) as the reference's tree of CPU tensors
    in the file's dtype.  Torch ``nn.Linear`` stores [out, in]; the tree
    is [in, out], so 2-d weights are transposed (and made contiguous)."""
    from docqa_tpu_torch.models.safetensors_io import load_file

    raw = {k.replace("bert.", ""): v for k, v in load_file(path).items()}

    def t(name):
        w = raw[name]
        return w.T.contiguous() if w.dim() == 2 else w

    p: Params = {
        "tok_emb": raw["embeddings.word_embeddings.weight"],
        "pos_emb": raw["embeddings.position_embeddings.weight"],
        "type_emb": raw["embeddings.token_type_embeddings.weight"],
        "emb_ln_g": raw["embeddings.LayerNorm.weight"],
        "emb_ln_b": raw["embeddings.LayerNorm.bias"],
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        for hf_name, (w_key, b_key) in _HF_LAYER_MAP.items():
            p[f"l{i}_{w_key}"] = t(pre + hf_name + ".weight")
            p[f"l{i}_{b_key}"] = raw[pre + hf_name + ".bias"]
        p[f"l{i}_attn_ln_g"] = raw[pre + "attention.output.LayerNorm.weight"]
        p[f"l{i}_attn_ln_b"] = raw[pre + "attention.output.LayerNorm.bias"]
        p[f"l{i}_mlp_ln_g"] = raw[pre + "output.LayerNorm.weight"]
        p[f"l{i}_mlp_ln_b"] = raw[pre + "output.LayerNorm.bias"]
    return p
