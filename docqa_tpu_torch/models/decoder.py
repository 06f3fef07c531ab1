"""Decoder-only generator trunk (Mistral/Llama-class), counterpart of
``docqa_tpu/models/decoder.py``.

Parameters are a flat dict of tensors with the reference's names and
layouts (weights stored [in, out]); a weight-only quantised tree
(``models/quant.py``) carries int8 or packed int4 projections with their
``__scale`` leaves, and every projection goes through :func:`_qmatmul`.
Architecture: RMSNorm pre-norm, GQA attention with split-halves RoPE,
SwiGLU MLP, optional sliding window.

Tensor parallelism (``mesh=`` with a model axis of ``n`` > 1): the tree
holds this rank's shards (``parallel/sharding.py``), the trunk reads its
head counts off the shards' own widths, and the row-parallel ``wo`` and
``w_down`` products are summed over the model group: exactly two
all-reduces a layer, in the activation's dtype, and no other collective
in the forward.  :func:`decoder_head` returns vocabulary-local logits (the
engine gathers them).  At ``n`` = 1 nothing is inserted.

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
from docqa_tpu_torch.models.quant import SCALE_SUFFIX
from docqa_tpu_torch.ops import qmatmul as _qm
from docqa_tpu_torch.ops.attention import attention, attention_reference
from docqa_tpu_torch.ops.norms import rms_norm
from docqa_tpu_torch.ops.rope import apply_rope, rope_angles
from docqa_tpu_torch.runtime.mesh import MeshContext, all_reduce
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
    num_kv_heads: Optional[int] = None,
) -> KVCache:
    """``num_kv_heads``: the heads this rank holds (default
    ``cfg.num_kv_heads``; a tensor-parallel shard holds its own share)."""
    max_len = max_len or cfg.max_seq_len
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (batch, max_len, num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
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


def _qmatmul(x: torch.Tensor, params: Params, name: str, dtype) -> torch.Tensor:
    """``x [..., in] @ W``, the reference's ``_qmatmul``: a float weight is
    cast to ``dtype``; a quantised one (``<name>__scale`` beside it: int8
    ``[in, out]`` or packed int4 ``[groups, g/2, out]``) goes through
    :func:`~docqa_tpu_torch.ops.qmatmul.qmatmul`, which dequantises inside
    K4 on a card (``dtype(q) * dtype(scale)``, never materialised) and
    through the plain version on the CPU."""
    w = params[name]
    scale = params.get(name + SCALE_SUFFIX)
    if scale is None:
        return x @ w.to(dtype)
    return _qm.qmatmul(x.to(dtype), w, scale)


def _int4_replicated(w: torch.Tensor, full_in: int, n: int) -> bool:
    """Whether a row-parallel int4 store is the whole store: its groups do
    not divide the model axis, so the sharding replicated them."""
    groups = w.shape[0]
    return (groups % n != 0 and full_in % groups == 0
            and w.shape[1] == -(-(full_in // groups) // 2))


def _row_parallel(x: torch.Tensor, params: Params, name: str, dtype, full_in: int,
                  mesh: Optional[MeshContext]) -> torch.Tensor:
    """A row-parallel product (``wo``, ``w_down``) summed over the model
    group.  An int4 store replicated on whole groups serves its rank's rows
    ``x`` through the groups that cover them, ``x`` zero-padded to their
    edges: the added products are exact zeros and K4 still runs."""
    if mesh is None or mesh.n_model == 1:
        return _qmatmul(x, params, name, dtype)
    w, scale = params[name], params.get(name + SCALE_SUFFIX)
    if scale is not None and w.dim() == 3 and _int4_replicated(w, full_in, mesh.n_model):
        g = full_in // w.shape[0]
        start = mesh.model_index * x.shape[-1]
        end = start + x.shape[-1]
        g0, g1 = start // g, -(-end // g)
        x = F.pad(x.to(dtype), (start - g0 * g, g1 * g - end))
        out = _qm.qmatmul(x, w[g0:g1], scale[g0:g1])
    else:
        out = _qmatmul(x, params, name, dtype)
    return all_reduce(out, mesh.model_group, "decoder")


def decoder_layer_stack(
    params: Params,
    cfg: DecoderConfig,
    ids: torch.Tensor,  # [b, s]
    positions: torch.Tensor,  # [b, s] absolute position per token (RoPE)
    rope_len: int,  # RoPE table length (>= max position + 1)
    attend,  # attend(layer, q, k, v) -> [b, s, num_heads, head_dim]
    *,
    remat: bool = False,
    mesh: Optional[MeshContext] = None,
) -> torch.Tensor:
    """The shared trunk: embed, then per layer project q/k/v, apply RoPE at
    ``positions``, delegate the KV-cache write AND attention to ``attend``
    (which owns the cache layout), then wo and the SwiGLU MLP.  Returns the
    final hidden states [b, s, hidden] before the final norm.

    ``remat``: each layer runs under ``torch.utils.checkpoint`` (non-
    reentrant), so its activations are recomputed in the backward pass
    instead of stored — the training step's per-layer counterpart of the
    reference's ``jax.checkpoint``.

    ``mesh``: the tree holds this rank's tensor-parallel shards; heads are
    read off their widths and the row-parallel products all-reduced over
    the model axis (module docstring)."""
    b, s = ids.shape
    dtype = torch_dtype(cfg.dtype)
    cos, sin = rope_angles(cfg.head_dim, rope_len, cfg.rope_theta, ids.device)

    def layer(i: int, x: torch.Tensor) -> torch.Tensor:
        y = rms_norm(x, params[f"l{i}_attn_norm_g"], cfg.norm_eps)
        # heads from the widths: a tensor-parallel shard holds its share
        q = _qmatmul(y, params, f"l{i}_wq", dtype).reshape(b, s, -1, cfg.head_dim)
        k = _qmatmul(y, params, f"l{i}_wk", dtype).reshape(b, s, -1, cfg.head_dim)
        v = _qmatmul(y, params, f"l{i}_wv", dtype).reshape(b, s, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        attn = attend(i, q, k, v)
        attn = attn.reshape(b, s, -1)
        x = x + _row_parallel(attn, params, f"l{i}_wo", dtype,
                              cfg.num_heads * cfg.head_dim, mesh)

        y = rms_norm(x, params[f"l{i}_mlp_norm_g"], cfg.norm_eps)
        gate = _qmatmul(y, params, f"l{i}_w_gate", dtype)
        up = _qmatmul(y, params, f"l{i}_w_up", dtype)
        act = F.silu(gate.float()).to(dtype) * up
        return x + _row_parallel(act, params, f"l{i}_w_down", dtype, cfg.mlp_dim, mesh)

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
    """Final norm + lm_head over the trunk's hidden states (f32 logits;
    a tensor-parallel ``lm_head`` shard gives this rank's vocabulary
    block)."""
    dtype = torch_dtype(cfg.dtype)
    if last_token_only and x.shape[1] > 1:
        # prefill: only the last valid row per lane feeds sampling
        idx = (new_lengths.long() - 1)[:, None, None].expand(-1, 1, x.shape[2])
        x = torch.gather(x, 1, idx)
    x = rms_norm(x, params["final_norm_g"], cfg.norm_eps)
    return _qmatmul(x, params, "lm_head", dtype).float()


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
    mesh: Optional[MeshContext] = None,
) -> torch.Tensor:
    """Run s new tokens through the stack, writing their K/V into ``cache``
    in place.  Prefill: cache_lengths = 0 and ``attn_lengths`` = the true
    prompt lengths, so right-padded tail rows are never attended.  Decode:
    s = 1, ``attn_lengths`` defaults to cache_lengths + s.

    Returns logits [b, s, vocab] f32 ([b, 1, vocab] with last_token_only).
    Attention goes through :func:`attention` (the flash kernel on a card)
    when ``use_flash``, else through :func:`attention_reference` on either
    device: the training path, which also takes ``remat``
    (:func:`decoder_layer_stack`).  ``mesh``: a tensor-parallel tree and
    cache (local heads); the logits are then vocabulary-local.  Under autograd the cache write is an
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
                            remat=remat, mesh=mesh)
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
