"""Configuration for the port: its own copies of the docqa_tpu dataclasses
(``docqa_tpu/config.py``), holding only the fields this package reads.

Field names and defaults match the reference exactly, so one dict of
overrides builds the same configuration in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
class NERConfig:
    """Token-classification PHI tagger: the encoder trunk plus a per-token
    head, BIO labels over the reference's 6-entity contract."""

    vocab_size: int = 30522
    hidden_dim: int = 256
    num_layers: int = 4
    num_heads: int = 8
    mlp_dim: int = 1024
    max_seq_len: int = 512
    entities: Tuple[str, ...] = (
        "PERSON",
        "PHONE_NUMBER",
        "EMAIL_ADDRESS",
        "DATE_TIME",
        "NRP",
        "LOCATION",
    )
    dtype: str = "bfloat16"
    # the trained tagger's cache (training/ner.py) and the steps it must
    # have been trained with; a missing or mismatched cache raises
    params_path: Optional[str] = None
    train_steps: int = 1500
    # document-register language of the pattern recognizers: "fr" keeps
    # the French + English forms, "en" drops the French-only ones
    language: str = "fr"
    # part of the cache fingerprint (the training recipe's entity weight)
    entity_loss_weight: float = 4.0

    @property
    def num_labels(self) -> int:
        return 1 + 2 * len(self.entities)  # O + B-/I- per entity


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
    # how many of the SMALLEST packed token budgets EnginePool construction
    # warms per replica (plus the decode step); 0 = none
    startup_warm_buckets: int = 1
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
    """Multi-tenant QoS: weighted-fair admission by request class, KV
    preemption under block-pool pressure, and SLO-burn deferral of batch
    traffic (the rule is ported; nothing wires a burn probe until the obs
    slice)."""

    # False: plain FIFO admission, no preemption, no deferral
    enabled: bool = True
    weight_interactive: float = 8.0
    weight_batch: float = 2.0
    weight_background: float = 1.0
    # a queue head older than this wins the next slot regardless of weight
    aging_floor_s: float = 5.0
    # "off" never evicts; "advisory" counts would-be victims without
    # evicting; "on" evicts lower-ranked lanes' KV blocks and requeues them
    # with their generated tokens kept for the re-prefill
    preemption: str = "off"
    # a victim with less deadline than this left cannot survive a second
    # prefill: it sheds typed instead of requeueing
    preempt_min_resume_s: float = 0.5


@dataclass(frozen=True)
class ResilienceConfig:
    """Failure-path policy of ``/ask`` (the fields of the reference's
    ResilienceConfig that this package reads)."""

    # end-to-end /ask budget stamped at admission; 0 disables deadlines
    request_deadline_s: float = 8.0
    # below this remaining budget the QA path skips generation and serves
    # the degraded extractive answer
    min_generate_budget_s: float = 0.5
    # decoder circuit breaker: trip after this many consecutive failures,
    # probe again after the reset timeout
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0
    # cap on the degraded extractive answer built from retrieved chunks
    degraded_max_chars: int = 600
    # in-place retry policy (resilience/policy.py) of the ingest pipeline's
    # broker publishes, extraction and queue handlers
    retry_attempts: int = 3
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0


@dataclass(frozen=True)
class PoolConfig:
    """Replicated decode-engine pool (``engines/pool.py``): N continuous
    batchers behind one submit surface, each with a liveness contract
    (heartbeat, canary, breaker), failover for queued requests, fail-fast
    for admitted ones, graceful drain and optional hedged dispatch."""

    replicas: int = 1
    # per-replica batcher slots; None = gen.max_concurrent
    n_slots: Optional[int] = None
    max_queue: int = 256
    # a worker iteration may legitimately hold a long first-shape call;
    # pre-warmed deployments can drop this for faster wedge detection
    heartbeat_max_age_s: float = 60.0
    # synthetic 2-token canary generate per idle replica
    canary_interval_s: float = 20.0
    canary_timeout_s: float = 30.0
    health_interval_s: float = 0.5
    # replica hops a queued request may make before failing typed
    requeue_max_hops: int = 1
    # hedged dispatch: duplicate a request with no first token after a
    # p95-based delay onto a second replica; the first token wins
    hedge: bool = False
    hedge_min_delay_s: float = 0.75
    hedge_warmup: int = 20
    # session-affine routing on the prefix key, unless the preferred
    # replica is more than affinity_max_queue_delta requests deeper
    session_affinity: bool = True
    affinity_max_queue_delta: int = 4


@dataclass(frozen=True)
class StoreConfig:
    """Device-resident exact vector store."""

    dim: int = 384
    # initial row capacity; the device buffer doubles when it fills
    shard_capacity: int = 16384
    dtype: str = "bfloat16"
    default_k: int = 3
    # per-row generator-token sidecar of the fused RAG path; not in this
    # port yet, so only 0 is accepted (index/store.py)
    token_width: int = 0


@dataclass(frozen=True)
class ChunkConfig:
    """Chunking policy: the reference's fixed 500 characters, optional
    overlap."""

    chunk_chars: int = 500
    overlap_chars: int = 0


@dataclass(frozen=True)
class BrokerConfig:
    """The ingest pipeline's message bus (two queues, batched consumers,
    redelivery with backoff, then a dead-letter queue)."""

    backend: str = "memory"  # "memory"; "amqp" is not in this port yet
    raw_queue: str = "raw_documents_queue"
    clean_queue: str = "clean_documents_queue"
    prefetch: int = 8  # messages a consumer pulls per batch
    max_redelivery: int = 3
    retry_backoff_s: float = 0.5  # base redelivery delay (doubles per attempt)


@dataclass(frozen=True)
class RegistryConfig:
    """Document-metadata registry: SQLite by default, a Postgres URL for
    several processes."""

    url: str = "sqlite://"  # in memory; "sqlite:///path.db" on disk


@dataclass(frozen=True)
class Config:
    """The sections ``DocumentPipeline`` reads (``cfg.broker``,
    ``cfg.chunk``, ``cfg.resilience``, ``cfg.ner``, ``cfg.store``), plus
    the registry section that wires it.  The reference's ``DataConfig``
    (work and bootstrap directories) comes with the app's runtime, its
    only reader."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    ner: NERConfig = field(default_factory=NERConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    chunk: ChunkConfig = field(default_factory=ChunkConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    registry: RegistryConfig = field(default_factory=RegistryConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
