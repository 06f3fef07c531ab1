"""Configuration for the port: its own copies of the docqa_tpu dataclasses
(``docqa_tpu/config.py``), holding only the fields this package reads.

Every field of the reference is here, with its name and default, so one
dict of overrides (or one set of ``DOCQA_<SECTION>__<FIELD>`` variables)
builds the same configuration in both packages; the one default that
differs is ``DispatchConfig.n_lanes`` (see there).  A field with no
subject in the port says so in its section's docstring; the runtime logs
it once at boot when it is set away from its default
(:func:`unused_fields`).  :func:`load_config`
is the reference's: defaults, then the ``DOCQA_<SECTION>__<FIELD>``
environment overlay, then explicit ``section.field`` overrides.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh (``runtime/mesh.py``): axes ``data`` (batch-axis data
    parallelism) and ``model`` (tensor parallelism, and the store's row
    shards), the reference's names and defaults.  ``-1`` takes every rank
    of the world left on that axis; ``platform="cpu"`` builds the mesh on
    the CPU over gloo (the tests' worlds), else on the card over NCCL."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = -1
    platform: Optional[str] = None


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
    # real-vocabulary file for imported checkpoints: vocab.txt (WordPiece),
    # tokenizer.json or tokenizer.model; None -> the hash fallback
    tokenizer_path: Optional[str] = None
    # a Hugging Face checkpoint directory (config.json + model.safetensors
    # + vocabulary): the runtime loads architecture, weights and
    # vocabulary from it (models/hf_checkpoint.py) and ignores this
    # config's architecture fields
    checkpoint_dir: Optional[str] = None


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
    # have been trained with; a missing or mismatched cache retrains (at
    # boot too); train_steps=0 with no params_path is plumbing mode, a
    # seeded random tagger
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
    # real-vocabulary file for imported checkpoints: tokenizer.json
    # (byte-level or metaspace BPE) or tokenizer.model (SentencePiece);
    # None -> the hash fallback
    tokenizer_path: Optional[str] = None
    # a Hugging Face Llama/Mistral checkpoint directory: the runtime loads
    # architecture, weights and vocabulary from it, with max_seq_len capped
    # at this config's
    checkpoint_dir: Optional[str] = None
    # weight-only quantisation, as the reference's (models/quant.py):
    # int8 per column (quant_bits=8) or int4 in groups of 128 along the
    # input axis (4); the projections then run on K4 (ops/qmatmul.py)
    quantize_weights: bool = False
    quant_bits: int = 8

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

    @staticmethod
    def llama3_8b() -> "DecoderConfig":
        """Llama-3-8B: the 128,256-token vocabulary, no sliding window,
        ``rope_theta`` 500,000 and an 8,192-token context."""
        return DecoderConfig(
            vocab_size=128256,
            hidden_dim=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            mlp_dim=14336,
            max_seq_len=8192,
            rope_theta=500000.0,
        )


@dataclass(frozen=True)
class Seq2SeqConfig:
    """BART-class encoder-decoder (the summarizer BASELINE config 4 names,
    bart-large-cnn), laid out as HF ``BartForConditionalGeneration``:
    post-LN residuals, learned positions with the +2 padding offset, GELU,
    tied lm_head + ``final_logits_bias`` (``models/seq2seq.py``).  Defaults
    are a smoke size; ``bart_large_cnn()`` is the target checkpoint's
    shape."""

    vocab_size: int = 1024
    d_model: int = 128
    enc_layers: int = 2
    dec_layers: int = 2
    num_heads: int = 4
    mlp_dim: int = 256
    max_src_len: int = 256
    max_tgt_len: int = 128
    pos_offset: int = 2  # BART's learned-position padding offset
    pad_id: int = 1  # BART convention: pad=1, bos=0, eos=2
    bos_id: int = 0
    eos_id: int = 2
    decoder_start_id: int = 2  # HF BART: decoding starts from eos
    # HF BART generation forces BOS as the first decoded token
    forced_bos_id: Optional[int] = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # generation policy; None = unset (greedy, unconstrained, and a
    # checkpoint directory's shipped policy applies); a set value always
    # wins, the engine default included (num_beams=1 forces greedy over a
    # checkpoint that ships 4)
    num_beams: Optional[int] = None  # effective default 1 (greedy)
    length_penalty: Optional[float] = None  # effective default 1.0
    min_length: Optional[int] = None  # EOS masked below this; default 0
    no_repeat_ngram: Optional[int] = None  # n bans repeated n-grams; default 0
    # real-vocabulary file (bart-large-cnn ships a byte-level BPE
    # tokenizer.json); None -> the hash fallback
    tokenizer_path: Optional[str] = None
    # a bart-large-cnn-layout checkpoint directory for the runtime's
    # seq2seq summarizer
    checkpoint_dir: Optional[str] = None

    @staticmethod
    def bart_large_cnn() -> "Seq2SeqConfig":
        return Seq2SeqConfig(
            vocab_size=50264,
            d_model=1024,
            enc_layers=12,
            dec_layers=12,
            num_heads=16,
            mlp_dim=4096,
            max_src_len=1024,
            max_tgt_len=1024,
            forced_bos_id=0,
            num_beams=4,
            length_penalty=2.0,
            min_length=56,
            no_repeat_ngram=3,
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
    traffic (``set_slo_probe`` on the batcher or pool wires the burn
    probe)."""

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
    # while an interactive SLO burns (the probe reports it firing), defer
    # batch-class admission (typed serve.DeferredByPolicy); background is
    # never deferred: it carries the pool's canaries
    defer_batch_on_burn: bool = True
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
    """Device-resident exact vector store.  ``score`` names what the store
    ranks by: ``"cosine"`` (a product of normalised rows, the one score it
    computes); the runtime refuses any other value with ``ValueError``."""

    dim: int = 384
    # initial row capacity; the device buffer doubles when it fills
    shard_capacity: int = 16384
    dtype: str = "bfloat16"
    score: str = "cosine"
    default_k: int = 3
    # "exact" (one product over the whole store) or "tiered" (IVF over the
    # bulk plus an exact tail, index/tiered.py)
    serving_index: str = "exact"
    # the tiered index: serving nprobe, the rows below which the IVF tier
    # stays off, the tail that triggers a background rebuild, and the bulk
    # tier's cells ("int8" tiles with per-row scales, or "float")
    ivf_nprobe: int = 8
    ivf_min_rows: int = 50_000
    ivf_rebuild_tail: int = 100_000
    ivf_storage: str = "int8"
    # a DELETE compacts the store once tombstones reach this share of its
    # rows; 0 disables the automatic compaction
    compact_threshold: float = 0.25
    # per-row generator-token sidecar (index/store.py): > 0 keeps each
    # row's chunk as this many generator token ids on the device and
    # enables the single-sync fused /ask (engines/rag_fused.py)
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

    backend: str = "memory"  # "memory" | "amqp" (RabbitMQ through pika)
    raw_queue: str = "raw_documents_queue"
    clean_queue: str = "clean_documents_queue"
    prefetch: int = 8  # messages a consumer pulls per batch
    max_redelivery: int = 3
    retry_backoff_s: float = 0.5  # base redelivery delay (doubles per attempt)
    amqp_host: str = "localhost"
    amqp_port: int = 5672


@dataclass(frozen=True)
class RegistryConfig:
    """Document-metadata registry: SQLite by default, a Postgres URL for
    several processes; ``table`` is the name of its table."""

    url: str = "sqlite://"  # in memory; "sqlite:///path.db" on disk
    table: str = "documents"


@dataclass(frozen=True)
class SummarizerConfig:
    """Clinical summarizer within a prompt and summary token budget:
    instruction-prompted decoding on the generator, or the seq2seq
    summarizer on the raw packed documents."""

    max_input_tokens: int = 3072
    max_summary_tokens: int = 512
    max_chunks: int = 5
    # "decoder": instruction prompts on the causal LM, through its batcher;
    # "seq2seq": the BART-class encoder-decoder of the seq2seq section
    backend: str = "decoder"


@dataclass(frozen=True)
class DataConfig:
    """Startup data lifecycle.

    * ``work_dir``: the persistence root.  The store snapshots under
      ``<work_dir>/index`` and restores from it on boot, the broker
      journals under ``<work_dir>/journal``, the default registry lives in
      ``<work_dir>/registry.db`` and the trained tagger's cache in
      ``<work_dir>/ner.npz``.  None keeps everything in memory.
    * ``bootstrap_dir``: a CSV knowledge base indexed on first boot (only
      into an empty store).
    * ``snapshot_every``: snapshot after this many indexed documents; 0
      turns the periodic snapshot off (a DELETE and a stop still
      snapshot when ``work_dir`` is set).
    """

    work_dir: Optional[str] = None
    bootstrap_dir: Optional[str] = None
    snapshot_every: int = 64


@dataclass(frozen=True)
class ServiceConfig:
    """HTTP surface: the port the one server binds (the reference
    deployment's ingest port), the bind address, the socket timeout of
    each connection (``request_timeout_s``: a client that sends or reads
    nothing for that long is dropped), and an optional Tika-protocol
    extractor server.

    ``qa_port`` and ``synthesis_port`` name the reference deployment's
    other two services; the port serves every route from the one server
    on ``ingest_port``, so they have no subject here and are ignored."""

    ingest_port: int = 8000
    qa_port: int = 8001
    synthesis_port: int = 8005
    host: str = "0.0.0.0"
    request_timeout_s: float = 60.0
    extractor_url: Optional[str] = None


@dataclass(frozen=True)
class FlagsConfig:
    """Fake-mode flags: canned LLM answers, canned patient retrieval, and
    hash embeddings in place of the encoder."""

    use_fake_llm: bool = False
    use_fake_retrieval: bool = False
    use_fake_encoder: bool = False


@dataclass(frozen=True)
class DispatchConfig:
    """The dispatch spine (``engines/spine.py``): every device work item
    of the process runs through its ``n_lanes`` slots.  ``strict_sync``
    serialises the spine: one item executes at a time and its device work
    has finished (its end event waited for) before its slot frees; None is
    auto, which is off (the port's single-process card runtime keeps
    ``n_lanes`` items in flight)."""

    # the reference's default is 2; on the card a retrieval waited up to
    # 94.8 ms in the queue at 2 slots and under 0.1 ms at 8 (PERF.md), so
    # this port's default is its spine's DEFAULT_LANES
    n_lanes: int = 8
    max_depth: int = 256
    inline: bool = False
    strict_sync: Optional[bool] = None
    # register the analytic cost models with the observatory after warm-up
    annotate_costs: bool = True


@dataclass(frozen=True)
class TelemetryConfig:
    """Time-series telemetry and the /ask SLO burn-rate policy
    (``obs/telemetry.py``, ``obs/slo.py``).

    ``hbm_refresh_s`` paces the reference's compiled-program memory probe;
    the port compiles no program and reads device memory from
    ``torch.cuda.memory_stats`` every tick instead, so the field has no
    subject here and is ignored."""

    enabled: bool = True
    interval_s: float = 10.0
    points: int = 360
    sample_every_s: float = 2.0
    hbm_refresh_s: float = 600.0
    slo_ask_p95_ms: float = 2500.0
    slo_ask_availability: float = 0.99
    slo_ask_degraded_budget: float = 0.05
    slo_short_windows: int = 2
    slo_long_windows: int = 30
    slo_burn_threshold: float = 4.0


@dataclass(frozen=True)
class RetrievalQualityConfig:
    """The retrieval-quality observatory (``obs/retrieval_observatory.py``):
    a seeded 1-in-``sample_every`` share of tiered retrievals gets an exact
    shadow scan on the spine's background stream; the comparisons give
    windowed recall@k estimates with Wilson intervals, the recall SLO and a
    measured nprobe frontier with the nprobe that meets ``recall_target``.
    Under exact serving the observatory idles."""

    enabled: bool = True
    sample_every: int = 32
    seed: int = 0
    # per-query comparisons kept per (tier, nprobe) estimate
    window: int = 512
    # bounded shadow queue; a backlogged worker drops (counted)
    max_pending: int = 8
    # every Nth sampled shadow also probes these multiples of the nprobe
    frontier_every: int = 4
    frontier_factors: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0, 4.0)
    # comparisons a frontier row needs before it backs a recommendation
    min_frontier_n: int = 5
    recall_target: float = 0.95
    auto_apply_nprobe: bool = False
    slo_short_windows: int = 2
    slo_long_windows: int = 30
    slo_burn_threshold: float = 4.0
    slo_min_events: int = 6


@dataclass(frozen=True)
class LexicalConfig:
    """The lexical (BM25-impact) tier beside the dense store
    (``index/lexical.py``) and the hybrid fusion weight."""

    enabled: bool = True
    vocab_size: int = 131072
    tile_width: int = 32
    k1: float = 1.5
    b: float = 0.75
    ref_len: int = 64
    # hybrid fusion mix: alpha * norm(dense) + (1 - alpha) * norm(lexical)
    hybrid_alpha: float = 0.6
    # the retrieve mode when a request names none: dense | lexical | hybrid
    serving_mode: str = "dense"


@dataclass(frozen=True)
class RouterConfig:
    """Confidence-gated answer routing (``engines/router.py``): lookup
    questions are answered from retrieval, with no decode."""

    enabled: bool = True
    min_confidence: float = 0.7
    evidence_min: float = 0.5


@dataclass(frozen=True)
class Config:
    """Every section the app's runtime (``service/app.py``) and the
    components it builds read.  On a mesh of ranks (``runtime/mesh.py``)
    the runtime serves every configuration, tiered serving included."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    ner: NERConfig = field(default_factory=NERConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    summarizer: SummarizerConfig = field(default_factory=SummarizerConfig)
    seq2seq: Seq2SeqConfig = field(default_factory=Seq2SeqConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    chunk: ChunkConfig = field(default_factory=ChunkConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)
    registry: RegistryConfig = field(default_factory=RegistryConfig)
    data: DataConfig = field(default_factory=DataConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    flags: FlagsConfig = field(default_factory=FlagsConfig)
    generate: GenerateConfig = field(default_factory=GenerateConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    pool: PoolConfig = field(default_factory=PoolConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    dispatch: DispatchConfig = field(default_factory=DispatchConfig)
    retrieval_quality: RetrievalQualityConfig = field(
        default_factory=RetrievalQualityConfig
    )
    qos: QoSConfig = field(default_factory=QoSConfig)
    lexical: LexicalConfig = field(default_factory=LexicalConfig)
    router: RouterConfig = field(default_factory=RouterConfig)


_SECTIONS = {f.name for f in fields(Config)}

# fields kept for the reference's configuration surface that no code of
# the port reads (their sections' docstrings say why)
UNUSED_FIELDS = (
    "service.qa_port",
    "service.synthesis_port",
    "telemetry.hbm_refresh_s",
)


def unused_fields(cfg: Config) -> Dict[str, Any]:
    """``{"section.field": value}`` of every field in
    :data:`UNUSED_FIELDS` set away from its default."""
    default = Config()
    out: Dict[str, Any] = {}
    for path in UNUSED_FIELDS:
        section, _, name = path.partition(".")
        value = getattr(getattr(cfg, section), name)
        if value != getattr(getattr(default, section), name):
            out[path] = value
    return out


def _env_bool(value: str) -> bool:
    return value.strip().lower() in ("1", "true", "yes", "on")


def coerce_value(raw: str, target_type: Any) -> Any:
    """A string from the environment or the command line as the field's
    type; an Optional (None-default) field tries int, float, none/bool,
    then keeps the string.  The reference's ``_coerce``."""
    if target_type is bool:
        return _env_bool(raw)
    if target_type is int:
        return int(raw)
    if target_type is float:
        return float(raw)
    if target_type is str:
        return raw
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    if raw.lower() in ("none", "null", ""):
        return None
    if raw.lower() in ("true", "false"):
        return _env_bool(raw)
    return raw


def load_config(
    env: Optional[Mapping[str, str]] = None,
    overrides: Optional[Mapping[str, Any]] = None,
) -> Config:
    """Defaults, then every ``DOCQA_<SECTION>__<FIELD>`` variable of
    ``env`` (``os.environ`` when None; unknown sections and fields are
    skipped), then ``overrides`` (``{"section.field": value}``; an unknown
    name raises)."""
    env = os.environ if env is None else env
    cfg = Config()
    sections = {name: getattr(cfg, name) for name in _SECTIONS}
    prefix = "DOCQA_"
    for key, raw in env.items():
        if not key.startswith(prefix) or "__" not in key:
            continue
        section_name, _, field_name = key[len(prefix):].partition("__")
        section = sections.get(section_name.lower())
        if section is None:
            continue
        field_name = field_name.lower()
        if field_name not in {f.name for f in fields(section)}:
            continue
        current = getattr(section, field_name)
        target = type(current) if current is not None else object
        sections[section_name.lower()] = dataclasses.replace(
            section, **{field_name: coerce_value(raw, target)}
        )
    for path, value in (overrides or {}).items():
        section_name, _, field_name = path.partition(".")
        sections[section_name] = dataclasses.replace(
            sections[section_name], **{field_name: value}
        )
    return Config(**sections)
