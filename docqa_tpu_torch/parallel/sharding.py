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

The trainers hold float32 master trees in the same layout:
:class:`TreeLayout` (:func:`decoder_layout`) says which leaves are split
and on which dimension, and the global shape of each, for the optimizer's
clip and the checkpointer (:func:`replicated_layout` for a tree whole on
every rank); :func:`unshard` gathers a tree's leaves whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.decoder import decoder_param_schema
from docqa_tpu_torch.models.quant import SCALE_SUFFIX
from docqa_tpu_torch.runtime.mesh import MeshContext, all_gather

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


def block_of(size: int, n: int, index: int) -> Tuple[int, int]:
    """(start, length) of block ``index`` of an axis of ``size`` split ``n``
    ways: blocks of ``ceil(size / n)``, the last shorter (or empty) where
    ``n`` does not divide."""
    chunk = -(-size // n)
    start = min(index * chunk, size)
    return start, min(chunk, size - start)


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
        start, length = block_of(t.shape[dim], n, mesh.axis_index(axis))
        out = out.narrow(dim, start, length)
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


# ---- the trainers' float32 master trees ------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Where each leaf of a float32 master tree lies on a mesh: its global
    shape and the dimension split over the model axis (None: replicated).
    The trainers' optimizer and checkpointer read it."""

    mesh: MeshContext
    shapes: Dict[str, Tuple[int, ...]]
    dims: Dict[str, Optional[int]]

    @property
    def sharded(self) -> Tuple[str, ...]:
        """The leaves split over the model axis (none at n_model = 1)."""
        if self.mesh.n_model == 1:
            return ()
        return tuple(k for k, d in self.dims.items() if d is not None)

    def block(self, name: str) -> Tuple[Optional[int], int, int]:
        """(dim, start, length) of this rank's block of ``name`` along its
        split dimension; (None, 0, 0) where the rank holds the whole leaf
        (replicated, or a model axis of one rank)."""
        dim = self.dims[name]
        if dim is None or self.mesh.n_model == 1:
            return None, 0, 0
        start, length = block_of(self.shapes[name][dim], self.mesh.n_model,
                                 self.mesh.model_index)
        return dim, start, length

    def local_shape(self, name: str) -> Tuple[int, ...]:
        dim, _start, length = self.block(name)
        shape = list(self.shapes[name])
        if dim is not None:
            shape[dim] = length
        return tuple(shape)

    def check(self, params: Mapping[str, torch.Tensor]) -> None:
        """Raise ``ValueError`` naming the first leaf that is not this
        rank's block (a whole tree on a tensor-parallel mesh, or a shard
        where a whole leaf belongs)."""
        if set(params) != set(self.shapes):
            odd = sorted(set(params) ^ set(self.shapes))
            raise ValueError(f"the tree's leaves differ from the layout's: {odd[:4]}")
        for k, v in params.items():
            want = self.local_shape(k)
            if tuple(v.shape) != want:
                raise ValueError(
                    f"leaf {k!r} has shape {tuple(v.shape)}, this rank's block on the "
                    f"{self.mesh.n_data}x{self.mesh.n_model} mesh is {want}")


def decoder_layout(cfg: DecoderConfig, mesh: MeshContext) -> TreeLayout:
    """The layout of a float32 master decoder tree on ``mesh``: the serving
    PartitionSpecs (:func:`decoder_param_pspecs`), a vocabulary that does
    not divide cut as :func:`shard_leaf` cuts it."""
    check_divisible(cfg, mesh.n_model)
    specs = decoder_param_pspecs(cfg, mesh.model_axis)
    shapes, dims = {}, {}
    for name, _kind, shape, _fan in decoder_param_schema(cfg):
        shapes[name] = tuple(shape)
        split = [d for d, axis in enumerate(specs[name]) if axis is not None]
        dims[name] = split[0] if split else None
    return TreeLayout(mesh, shapes, dims)


def replicated_layout(params: Mapping[str, torch.Tensor], mesh: MeshContext) -> TreeLayout:
    """The layout of a tree whole on every rank of ``mesh`` (the
    data-parallel encoder's): no leaf split."""
    return TreeLayout(mesh, {k: tuple(v.shape) for k, v in params.items()},
                      dict.fromkeys(params))


def unshard(tree: Mapping[str, torch.Tensor], layout: TreeLayout) -> Dict[str, torch.Tensor]:
    """Whole leaves from this rank's blocks: one all-gather over the model
    axis a sharded leaf (site ``unshard``, a short last block padded for
    it), replicated leaves as they are.  Every rank of a model group gets
    the same tree."""
    mesh = layout.mesh
    out = {}
    for k, v in tree.items():
        dim, _start, _len = layout.block(k)
        if dim is None:
            out[k] = v
            continue
        size = layout.shapes[k][dim]
        chunk = -(-size // mesh.n_model)
        v = v.detach()
        if v.shape[dim] < chunk:
            pad = [0, 0] * (v.dim() - 1 - dim) + [0, chunk - v.shape[dim]]
            v = F.pad(v, pad)
        out[k] = all_gather(v, mesh.model_group, "unshard", dim=dim).narrow(dim, 0, size)
    return out
