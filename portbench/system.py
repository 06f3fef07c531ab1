"""The system under test: the port's ``/ask`` path, built from a cell's
configuration and mix the way ``DocQARuntime`` wires it under the default
``Config``, with the benchmark's inputs in place of a corpus and a
checkpoint.

What is left out of the runtime's boot, and why: the de-identification
tagger, ingest, the broker and the registry (``/ask`` does not use them);
the HTTP front (3-4 ms of a multi-second ask); telemetry and its SLO probe
(the probe only defers batch-class asks, and every ask here is
interactive).  Kept: the dispatch spine as the runtime configures it, the
exact store, the fused retriever, the answer router, the breakers, one
``EnginePool`` replica over ``ContinuousBatcher`` with ``QoSConfig()``, and
each ask's trace and cost record as ``App.ask`` opens them.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.flops import ModelShape
from portbench.reference.text import encode, prompt_text


def model_shape(config: Dict[str, Any]) -> ModelShape:
    """The decoder's widths from a configuration file's published keys."""
    c = config
    heads = int(c["num_attention_heads"])
    return ModelShape(
        vocab=int(c["vocab_size"]), hidden=int(c["hidden_size"]),
        layers=int(c["num_hidden_layers"]), heads=heads,
        kv_heads=int(c["num_key_value_heads"]),
        head_dim=int(c.get("head_dim") or c["hidden_size"] // heads),
        mlp=int(c["intermediate_size"]), window=c.get("sliding_window"),
        weight_bits=int(c["served"].get("weight_bits", 16)),
    )


def prompt_tokens(config: Dict[str, Any], mix: Dict[str, Any]) -> int:
    """Pieces of every prompt the mix sends: the template around the
    deployment's ``default_k`` chunks and a question."""
    text = prompt_text("q " * (int(mix["question_tokens"]) - 1) + "?",
                       ["w " * int(mix["chunk_tokens"])] * int(config["store"]["default_k"]))
    return len(encode(text, int(config["vocab_size"])))


@dataclass
class System:
    qa: Any
    pool: Any
    engine: Any
    shape: ModelShape
    texts: List[str]

    def stop(self) -> None:
        """Stop the pool's workers and drop every device tensor of the
        program, so that the reference finds the card's memory free."""
        self.pool.stop()
        self.qa = self.pool = self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def build(config: Dict[str, Any], mix: Dict[str, Any], seed: int, device,
          log=print) -> System:
    from docqa_tpu_torch.config import (
        Config, DecoderConfig, EncoderConfig, GenerateConfig, PoolConfig,
        QoSConfig, ResilienceConfig, StoreConfig,
    )
    from docqa_tpu_torch.engines import spine as _spine
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.pool import EnginePool
    from docqa_tpu_torch.engines.retrieve import FusedRetriever
    from docqa_tpu_torch.engines.router import AnswerRouter
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.resilience.breaker import BreakerBoard
    from docqa_tpu_torch.service.qa import QAService

    dev = torch.device(device)
    base = Config()
    res = ResilienceConfig(request_deadline_s=float(mix["request_deadline_s"]))
    _spine.configure(n_lanes=base.dispatch.n_lanes, max_depth=base.dispatch.max_depth,
                     inline=base.dispatch.inline, strict_sync=base.dispatch.strict_sync)
    breakers = BreakerBoard(failure_threshold=res.breaker_failure_threshold,
                            reset_timeout_s=res.breaker_reset_s)

    t = time.perf_counter()
    enc = config["encoder"]
    enc_cfg = EncoderConfig(
        vocab_size=enc["vocab_size"], hidden_dim=enc["hidden_size"],
        num_layers=enc["num_hidden_layers"], num_heads=enc["num_attention_heads"],
        mlp_dim=enc["intermediate_size"], max_seq_len=enc["max_position_embeddings"],
        embed_dim=enc["hidden_size"], dtype=enc["dtype"],
    )
    encoder = EncoderEngine(enc_cfg, params=inputs.encoder_weights(enc, seed, dev), device=dev)

    st = config["store"]
    texts = inputs.text_pool(seed, int(mix["text_pool"]), int(mix["chunk_tokens"]))
    store = VectorStore(StoreConfig(dim=int(st["dim"]), dtype=st["dtype"]), device=dev)
    vectors = inputs.store_vectors(int(st["rows"]), int(st["dim"]), seed, dev).cpu().numpy()
    n_text = len(texts)
    store.add(vectors, [{"source": f"r{i}", "text_content": texts[i % n_text]}
                        for i in range(len(vectors))])
    del vectors
    log(f"  encoder and store: {store.count} rows x {st['dim']} in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    shape = model_shape(config)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["torch_dtype"]]
    served = config["served"]
    dec_cfg = DecoderConfig(
        vocab_size=shape.vocab, hidden_dim=shape.hidden, num_layers=shape.layers,
        num_heads=shape.heads, num_kv_heads=shape.kv_heads, head_dim=shape.head_dim,
        mlp_dim=shape.mlp, max_seq_len=int(config["max_position_embeddings"]),
        rope_theta=float(config["rope_theta"]), norm_eps=float(config["rms_norm_eps"]),
        dtype=config["torch_dtype"], sliding_window=config.get("sliding_window"),
        quantize_weights=shape.weight_bits != 16,
        quant_bits=shape.weight_bits if shape.weight_bits != 16 else 8,
    )
    pool_cfg = config["pool"]
    gen = GenerateConfig(
        max_new_tokens=int(mix["max_new_tokens"]), decode_chunk=int(pool_cfg["decode_chunk"]),
        speculative_k=int(pool_cfg["speculative_k"]), prefix_cache=bool(pool_cfg["prefix_cache"]),
        startup_warm_buckets=0,
    )
    # an int8 configuration is quantised on the card by the engine, from
    # the float tree as drawn, as the runtime quantises a loaded one
    engine = GenerateEngine(dec_cfg, gen=gen,
                            params=inputs.decoder_weights(shape, seed, dev, dtype), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    log(f"  decoder: {served['weights']} weights ready in {time.perf_counter() - t:.1f} s")

    pool = EnginePool(engine, cfg=PoolConfig(replicas=int(pool_cfg["replicas"]),
                                             n_slots=int(pool_cfg["n_slots"])),
                      qos=QoSConfig(), device=dev)
    rt = base.router
    qa = QAService(
        encoder, store, engine, k=int(st["default_k"]), device=dev, batcher=pool,
        breakers=breakers, resilience=res,
        retriever=FusedRetriever(encoder, store, device=dev),
        router=AnswerRouter(min_confidence=rt.min_confidence, evidence_min=rt.evidence_min),
    )
    if base.dispatch.annotate_costs:
        pool.annotate_costs()
    return System(qa, pool, engine, shape, texts)


def warm(system: System, config: Dict[str, Any], mix: Dict[str, Any], log=print) -> None:
    """Warm the shapes this cell's traffic uses: the packed prefill budgets
    of one prompt and of several (cold and warm-prefix) and the verify
    step, one retrieval, then one real request through the pool
    (admission, a speculative chunk, retirement)."""
    t = time.perf_counter()
    n = prompt_tokens(config, mix)
    system.pool.warmup(buckets=[n, 2 * n])
    system.qa.retriever.search_texts(["question de préchauffage"],
                                     k=int(config["store"]["default_k"]))
    ids = [2] + [5 + (i % 1000) for i in range(n - 2)] + [3]
    system.pool.submit_ids(ids, max_new_tokens=2 * int(config["pool"]["decode_chunk"]),
                           req_class="background").result(timeout=600)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    log(f"  warm-up: prompts of {n} tokens, one or several a pass, in "
        f"{time.perf_counter() - t:.1f} s")


def prompt_lengths_ok(config: Dict[str, Any], mix: Dict[str, Any]) -> bool:
    """A prompt and its answer fit a slot's capacity."""
    return (prompt_tokens(config, mix) + int(mix["max_new_tokens"])
            + 2 * int(config["pool"]["speculative_k"]) < int(config["max_position_embeddings"]))


def sources_to_rows(sources: List[str]) -> np.ndarray:
    return np.array([int(s[1:]) for s in sources], np.int64)
