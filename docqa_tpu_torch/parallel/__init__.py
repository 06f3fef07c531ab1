"""Tensor and sequence parallelism over the mesh (``runtime/mesh.py``),
counterpart of ``docqa_tpu/parallel``."""

from docqa_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_local,
    ulysses_attention,
)
from docqa_tpu_torch.parallel.sharding import (
    cache_pspecs,
    decoder_param_pspecs,
    paged_pool_pspecs,
    shard_decoder_params,
    shard_kv_cache,
    shard_paged_pools,
)

__all__ = [
    "decoder_param_pspecs",
    "cache_pspecs",
    "paged_pool_pspecs",
    "shard_decoder_params",
    "shard_kv_cache",
    "shard_paged_pools",
    "ring_attention",
    "ring_attention_local",
    "ulysses_attention",
]
