"""Sharding layouts for the decoder, counterpart of
``docqa_tpu/parallel/sharding.py``: the same Megatron layout, held as each
rank's local slice of every leaf.

Per layer (two Megatron blocks, attention and MLP):

* ``wq`` / ``wk`` / ``wv``: output (head) axis split -> column parallel
* ``wo``: input (head) axis split -> row parallel, all-reduce after
* ``w_gate`` / ``w_up``: output axis split -> column parallel
* ``w_down``: input axis split -> row parallel, all-reduce after
* ``lm_head``: vocabulary axis split -> vocabulary-local logits
* everything else (embedding, norm gains) replicated
* KV cache ``[b, S, kv_heads, d]``: lanes over data, kv heads over model

Quantisation scales mirror their weight as the reference's ``spec_for``
does: an int8 scale ``[out]`` follows ``out``; an int4 store ``[groups,
g/2, out]`` and its scale ``[groups, out]`` split the input axis on whole
groups, and where the groups do not divide the model axis the groups axis
is replicated (the trunk then takes the groups that cover its rows).

A spec is a tuple of axis names (or None) per dimension.  An axis of size
``n`` gives rank ``i`` the ``i``-th block of ``ceil(size / n)`` (the last
block shorter where ``n`` does not divide, as JAX cuts an uneven axis): a
view where the block is contiguous, a contiguous copy where it is not
(the kernels read contiguous stores), and the leaf itself at 1x1.  Head
counts and ``mlp_dim`` must divide the model axis (``ValueError``; GSPMD
pads them silently); an uneven vocabulary pads the gathered logits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.quant import SCALE_SUFFIX
from docqa_tpu_torch.runtime.mesh import MeshContext

Spec = Tuple[Optional[str], ...]


def decoder_param_pspecs(cfg: DecoderConfig, model_axis: str) -> Dict[str, Spec]:
    m = model_axis
    specs: Dict[str, Spec] = {
        "tok_emb": (None, None),
        "final_norm_g": (None,),
        "lm_head": (None, m),
    }
    for i in range(cfg.num_layers):
        specs.update({
            f"l{i}_attn_norm_g": (None,),
            f"l{i}_wq": (None, m),
            f"l{i}_wk": (None, m),
            f"l{i}_wv": (None, m),
            f"l{i}_wo": (m, None),
            f"l{i}_mlp_norm_g": (None,),
            f"l{i}_w_gate": (None, m),
            f"l{i}_w_up": (None, m),
            f"l{i}_w_down": (m, None),
        })
    return specs


def cache_pspecs(cfg: DecoderConfig, mesh: MeshContext) -> Dict[str, Spec]:
    """KV cache [b, S, kv_heads, d]: lanes over data, kv heads over model."""
    spec = (mesh.data_axis, None, mesh.model_axis, None)
    return {f"{kv}{i}": spec for i in range(cfg.num_layers) for kv in "kv"}


def paged_pool_pspecs(cfg: DecoderConfig, mesh: MeshContext) -> Dict[str, Spec]:
    """Paged KV block pool [n_blocks * block_size, kv_heads, d]: kv heads
    over model, the block rows replicated over data (every slot allocates
    from the one pool, so there is no lane axis to split)."""
    spec = (None, mesh.model_axis, None)
    return {f"{kv}{i}": spec for i in range(cfg.num_layers) for kv in "kv"}


def shard_leaf(t: torch.Tensor, spec: Spec, mesh: MeshContext) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (module docstring)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not fit a {t.dim()}-d leaf {tuple(t.shape)}")
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.axis_size(axis)
        if n == 1:
            continue
        size = t.shape[dim]
        chunk = -(-size // n)
        start = min(mesh.axis_index(axis) * chunk, size)
        out = out.narrow(dim, start, min(chunk, size - start))
    if out is not t and not out.is_contiguous():
        out = out.contiguous()
    return out


def check_divisible(cfg: DecoderConfig, n_model: int) -> None:
    """Raise ``ValueError`` naming the first width the model axis does not
    divide (heads, kv heads, MLP width)."""
    if n_model == 1:
        return
    for name in ("num_heads", "num_kv_heads", "mlp_dim"):
        if getattr(cfg, name) % n_model:
            raise ValueError(
                f"decoder {name}={getattr(cfg, name)} is not divisible by the "
                f"mesh's model axis ({n_model}); tensor parallelism needs whole "
                f"heads and equal MLP shards on every rank"
            )


def spec_for(name: str, v: torch.Tensor, specs: Mapping[str, Spec],
             n_model: int) -> Spec:
    """The reference's ``spec_for``: scales mirror their weight; an int4
    store's input-axis split moves to its groups axis, replicated where the
    groups do not divide the model axis."""
    if name.endswith(SCALE_SUFFIX):
        base = specs[name[: -len(SCALE_SUFFIX)]]
        if v.dim() == 1:
            return (base[1],)
        d0 = base[0]
        if d0 is not None and v.shape[0] % n_model:
            d0 = None
        return (d0, base[1])
    spec = specs[name]
    if v.dim() == 3 and len(spec) == 2:
        d0 = spec[0]
        if d0 is not None and v.shape[0] % n_model:
            d0 = None
        return (d0, None, spec[1])
    return spec


def shard_decoder_params(params: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                         mesh: MeshContext) -> Dict[str, torch.Tensor]:
    """Each leaf's local slice on this rank (float, int8 or packed int4
    trees).  At 1x1 every leaf is returned as it is, storage and all."""
    check_divisible(cfg, mesh.n_model)
    specs = decoder_param_pspecs(cfg, mesh.model_axis)
    return {
        k: shard_leaf(v, spec_for(k, v, specs, mesh.n_model), mesh)
        for k, v in params.items()
    }


def shard_kv_cache(cache: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                   mesh: MeshContext) -> Dict[str, torch.Tensor]:
    specs = cache_pspecs(cfg, mesh)
    return {k: shard_leaf(v, specs[k], mesh) for k, v in cache.items()}


def shard_paged_pools(pools: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                      mesh: MeshContext) -> Dict[str, torch.Tensor]:
    specs = paged_pool_pspecs(cfg, mesh)
    return {k: shard_leaf(v, specs[k], mesh) for k, v in pools.items()}
