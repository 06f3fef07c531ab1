"""Configuration for the port: its own copies of the docqa_tpu dataclasses
(``docqa_tpu/config.py``), holding only the fields this package reads.

Field names and defaults match the reference exactly, so one dict of
overrides builds the same configuration in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderConfig:
    """MiniLM-class sentence encoder (all-MiniLM-L6-v2 widths)."""

    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_seq_len: int = 512
    embed_dim: int = 384  # pooled output dim
    dtype: str = "bfloat16"
    normalize: bool = True  # cosine == dot product on normalized vectors


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder-only generator (Llama/Mistral trunk).  Defaults are a small
    smoke-size model; ``mistral_7b()`` gives the target-scale config."""

    vocab_size: int = 32000
    hidden_dim: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 2  # GQA
    head_dim: int = 64
    mlp_dim: int = 1408
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    sliding_window: Optional[int] = None
    # instruction wrapper for text prompts: a named alias ("mistral-inst")
    # or a format string containing "{prompt}"; None = raw prompts
    chat_template: Optional[str] = None

    @staticmethod
    def mistral_7b() -> "DecoderConfig":
        return DecoderConfig(
            vocab_size=32000,
            hidden_dim=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            mlp_dim=14336,
            max_seq_len=4096,
            rope_theta=1000000.0,
            sliding_window=4096,
        )


@dataclass(frozen=True)
class GenerateConfig:
    """Decode-loop policy (the fields of the reference's GenerateConfig
    that the solo engine and the continuous batcher read)."""

    max_new_tokens: int = 256
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = 2
    pad_id: int = 0
    # SOLO engine: prompt lengths pad to these buckets
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    # batcher: ragged-prefill packed token budgets (the batcher always adds
    # the full packed capacity of one maximal prompt)
    prefill_token_buckets: Tuple[int, ...] = (512,)
    max_concurrent: int = 16  # batcher decode slots
    decode_chunk: int = 16  # tokens per batcher decode dispatch
    kv_block_size: int = 16  # tokens per paged KV block
    # tokens the shared KV block pool holds; None = n_slots x capacity
    kv_pool_tokens: Optional[int] = None
    prefix_cache: bool = True  # copy-on-write KV prefix cache
    prefix_cache_entries: int = 32
    # prompt-lookup speculation verify width (greedy only); 0/1 disables
    speculative_k: int = 4


@dataclass(frozen=True)
class QoSConfig:
    """Batcher admission policy (the fields of the reference's QoSConfig
    that the admission queue reads).  KV preemption is off, the
    reference's default; its ``preemption`` field comes with it."""

    enabled: bool = True
    weight_interactive: float = 8.0
    weight_batch: float = 2.0
    weight_background: float = 1.0
    # a queue head older than this wins the next slot regardless of weight
    aging_floor_s: float = 5.0


@dataclass(frozen=True)
class StoreConfig:
    """Device-resident exact vector store."""

    dim: int = 384
    # initial row capacity; the device buffer doubles when it fills
    shard_capacity: int = 16384
    dtype: str = "bfloat16"
    default_k: int = 3
