"""Decoder-only generator trunk (Mistral/Llama-class), counterpart of
``docqa_tpu/models/decoder.py``.

Parameters are a flat dict of tensors with the reference's names and
layouts (weights stored [in, out]).  Architecture: RMSNorm pre-norm, GQA
attention with split-halves RoPE, SwiGLU MLP, optional sliding window.

KV cache: preallocated [b, max_len, kv_heads, head_dim] per layer, written
IN PLACE at a per-lane row offset (the reference returns an updated copy
from ``vmap`` + ``dynamic_update_slice``) — each lane carries its own
write offset, so lanes at different positions share one step.

:func:`load_hf_llama_weights` maps HF Llama/Mistral ``model*.safetensors``
shards onto the tree (the port's own safetensors reader).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.ops.attention import attention, attention_reference
from docqa_tpu_torch.ops.norms import rms_norm
from docqa_tpu_torch.ops.rope import apply_rope, rope_angles
from docqa_tpu_torch.utils import torch_dtype

Params = Dict[str, torch.Tensor]
KVCache = Dict[str, torch.Tensor]  # "k0".."k{L-1}", "v0".."v{L-1}"


def decoder_param_schema(cfg: DecoderConfig):
    """The parameter tree as ``(name, kind, shape, fan_in)`` with kind in
    {"normal", "ones"} — the reference's order exactly, which is the order
    the seeded inits draw their random streams in."""
    h = cfg.hidden_dim
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    yield ("tok_emb", "normal", (cfg.vocab_size, h), h)
    yield ("final_norm_g", "ones", (h,), None)
    yield ("lm_head", "normal", (h, cfg.vocab_size), h)
    for i in range(cfg.num_layers):
        yield (f"l{i}_attn_norm_g", "ones", (h,), None)
        yield (f"l{i}_wq", "normal", (h, qd), h)
        yield (f"l{i}_wk", "normal", (h, kvd), h)
        yield (f"l{i}_wv", "normal", (h, kvd), h)
        yield (f"l{i}_wo", "normal", (qd, h), qd)
        yield (f"l{i}_mlp_norm_g", "ones", (h,), None)
        yield (f"l{i}_w_gate", "normal", (h, cfg.mlp_dim), h)
        yield (f"l{i}_w_up", "normal", (h, cfg.mlp_dim), h)
        yield (f"l{i}_w_down", "normal", (cfg.mlp_dim, h), cfg.mlp_dim)


def init_decoder_params(
    cfg: DecoderConfig, seed: int, device, dtype: Optional[torch.dtype] = None
) -> Params:
    """Random init drawn ON ``device`` from a seeded ``torch.Generator``:
    ``normal * fan_in**-0.5`` in schema order, cast per tensor to ``dtype``
    (default ``cfg.dtype``).  The route for full-width random weights on a
    card; its numbers differ from the reference's numpy route
    (:func:`docqa_tpu_torch.weights.host_init_decoder_params`)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    p: Params = {}
    for name, kind, shape, fan_in in decoder_param_schema(cfg):
        if kind == "ones":
            p[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(
                shape, generator=gen, dtype=torch.float32, device=device
            )
            p[name] = (w * fan_in ** -0.5).to(dtype)
    return p


def init_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None, device=None,
) -> KVCache:
    max_len = max_len or cfg.max_seq_len
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache: KVCache = {}
    for i in range(cfg.num_layers):
        cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def write_cache(cache_layer: torch.Tensor, new: torch.Tensor,
                offsets: torch.Tensor) -> None:
    """Per-lane KV write, in place.  cache [b, S, kh, d], new [b, s, kh, d],
    offsets [b]: lane i writes new[i] at rows offsets[i].. — clamped like
    ``dynamic_update_slice`` so the rows stay inside the cache."""
    b, s = new.shape[:2]
    start = offsets.long().clamp(0, cache_layer.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=new.device)[None, :]
    lanes = torch.arange(b, device=new.device)[:, None]
    cache_layer[lanes, rows] = new.to(cache_layer.dtype)


def _matmul(x: torch.Tensor, params: Params, name: str, dtype) -> torch.Tensor:
    """``x [..., in] @ W`` — the unquantised branch of the reference's
    ``_qmatmul`` (weight-only int8/int4 is a later slice)."""
    return x @ params[name].to(dtype)


def decoder_layer_stack(
    params: Params,
    cfg: DecoderConfig,
    ids: torch.Tensor,  # [b, s]
    positions: torch.Tensor,  # [b, s] absolute position per token (RoPE)
    rope_len: int,  # RoPE table length (>= max position + 1)
    attend,  # attend(layer, q, k, v) -> [b, s, num_heads, head_dim]
    *,
    remat: bool = False,
) -> torch.Tensor:
    """The shared trunk: embed, then per layer project q/k/v, apply RoPE at
    ``positions``, delegate the KV-cache write AND attention to ``attend``
    (which owns the cache layout), then wo and the SwiGLU MLP.  Returns the
    final hidden states [b, s, hidden] before the final norm.

    ``remat``: each layer runs under ``torch.utils.checkpoint`` (non-
    reentrant), so its activations are recomputed in the backward pass
    instead of stored — the training step's per-layer counterpart of the
    reference's ``jax.checkpoint``."""
    b, s = ids.shape
    dtype = torch_dtype(cfg.dtype)
    cos, sin = rope_angles(cfg.head_dim, rope_len, cfg.rope_theta, ids.device)

    def layer(i: int, x: torch.Tensor) -> torch.Tensor:
        y = rms_norm(x, params[f"l{i}_attn_norm_g"], cfg.norm_eps)
        q = _matmul(y, params, f"l{i}_wq", dtype).reshape(
            b, s, cfg.num_heads, cfg.head_dim
        )
        k = _matmul(y, params, f"l{i}_wk", dtype).reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim
        )
        v = _matmul(y, params, f"l{i}_wv", dtype).reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim
        )
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        attn = attend(i, q, k, v)
        attn = attn.reshape(b, s, cfg.num_heads * cfg.head_dim)
        x = x + _matmul(attn, params, f"l{i}_wo", dtype)

        y = rms_norm(x, params[f"l{i}_mlp_norm_g"], cfg.norm_eps)
        gate = _matmul(y, params, f"l{i}_w_gate", dtype)
        up = _matmul(y, params, f"l{i}_w_up", dtype)
        act = F.silu(gate.float()).to(dtype) * up
        return x + _matmul(act, params, f"l{i}_w_down", dtype)

    x = params["tok_emb"][ids].to(dtype)
    for i in range(cfg.num_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, i, x, use_reentrant=False)
        else:
            x = layer(i, x)
    return x


def decoder_head(
    params: Params,
    cfg: DecoderConfig,
    x: torch.Tensor,  # [b, s, hidden]
    new_lengths: Optional[torch.Tensor] = None,
    last_token_only: bool = False,
) -> torch.Tensor:
    """Final norm + lm_head over the trunk's hidden states (f32 logits)."""
    dtype = torch_dtype(cfg.dtype)
    if last_token_only and x.shape[1] > 1:
        # prefill: only the last valid row per lane feeds sampling
        idx = (new_lengths.long() - 1)[:, None, None].expand(-1, 1, x.shape[2])
        x = torch.gather(x, 1, idx)
    x = rms_norm(x, params["final_norm_g"], cfg.norm_eps)
    return _matmul(x, params, "lm_head", dtype).float()


def decoder_forward(
    params: Params,
    cfg: DecoderConfig,
    ids: torch.Tensor,  # [b, s]
    cache: KVCache,
    cache_lengths: torch.Tensor,  # [b] tokens already in cache
    attn_lengths: Optional[torch.Tensor] = None,  # [b] valid kv after this step
    *,
    last_token_only: bool = False,
    use_flash: bool = True,
    remat: bool = False,
) -> torch.Tensor:
    """Run s new tokens through the stack, writing their K/V into ``cache``
    in place.  Prefill: cache_lengths = 0 and ``attn_lengths`` = the true
    prompt lengths, so right-padded tail rows are never attended.  Decode:
    s = 1, ``attn_lengths`` defaults to cache_lengths + s.

    Returns logits [b, s, vocab] f32 ([b, 1, vocab] with last_token_only).
    Attention goes through :func:`attention` (the flash kernel on a card)
    when ``use_flash``, else through :func:`attention_reference` on either
    device: the training path, which also takes ``remat``
    (:func:`decoder_layer_stack`).  Under autograd the cache write is an
    in-place ``index_put_`` into a tensor that needs no grad; gradients
    flow through it to k and v.
    """
    b, s = ids.shape
    max_len = cache["k0"].shape[1]
    steps = torch.arange(s, device=ids.device)[None, :]
    positions = (cache_lengths.long()[:, None] + steps).clamp(max=max_len - 1)
    new_lengths = cache_lengths + s if attn_lengths is None else attn_lengths

    attn_fn = attention if use_flash else attention_reference

    def attend(i, q, k, v):
        write_cache(cache[f"k{i}"], k, cache_lengths)
        write_cache(cache[f"v{i}"], v, cache_lengths)
        return attn_fn(
            q,
            cache[f"k{i}"],
            cache[f"v{i}"],
            causal=True,
            lengths=new_lengths,
            q_offset=cache_lengths,
            sliding_window=cfg.sliding_window,
        )

    x = decoder_layer_stack(params, cfg, ids, positions, max_len, attend,
                            remat=remat)
    return decoder_head(params, cfg, x, new_lengths, last_token_only)


# --------------------------------------------------------------------------
# HF weight import (Mistral / Llama ``model*.safetensors`` shards)
# --------------------------------------------------------------------------

def load_hf_llama_weights(paths, cfg: DecoderConfig) -> Params:
    """HF ``model*.safetensors`` shards (one path or a list) as the
    reference's tree of CPU tensors in the files' dtype.  Torch Linear
    stores [out, in]; the tree is [in, out] (GQA's k/v projections are
    [hidden, kv_heads * head_dim]).  A file with no ``lm_head.weight``
    ties the head to the embedding (``lm_head`` = ``embed_tokens``ᵀ).
    Rotary rows are taken in the Llama/Mistral split-halves order."""
    from docqa_tpu_torch.models.safetensors_io import load_file

    raw: Dict[str, torch.Tensor] = {}
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        raw.update(load_file(path))

    def t(name):
        return raw[name].T.contiguous()

    p: Params = {
        "tok_emb": raw["model.embed_tokens.weight"],
        "final_norm_g": raw["model.norm.weight"],
        "lm_head": (
            t("lm_head.weight") if "lm_head.weight" in raw
            else t("model.embed_tokens.weight")
        ),
    }
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        p[f"l{i}_attn_norm_g"] = raw[pre + "input_layernorm.weight"]
        p[f"l{i}_wq"] = t(pre + "self_attn.q_proj.weight")
        p[f"l{i}_wk"] = t(pre + "self_attn.k_proj.weight")
        p[f"l{i}_wv"] = t(pre + "self_attn.v_proj.weight")
        p[f"l{i}_wo"] = t(pre + "self_attn.o_proj.weight")
        p[f"l{i}_mlp_norm_g"] = raw[pre + "post_attention_layernorm.weight"]
        p[f"l{i}_w_gate"] = t(pre + "mlp.gate_proj.weight")
        p[f"l{i}_w_up"] = t(pre + "mlp.up_proj.weight")
        p[f"l{i}_w_down"] = t(pre + "mlp.down_proj.weight")
    return p
