"""Checkpoint-directory loader, counterpart of
``docqa_tpu/models/hf_checkpoint.py``: an HF-layout directory in, a config,
a parameter tree and a vocabulary path out.

    config.json            -> architecture hyper-parameters
    model*.safetensors     -> weights (models/{decoder,encoder,seq2seq}.py,
                              read by models/safetensors_io.py)
    tokenizer.json / tokenizer.model / vocab.txt -> vocabulary (text/)

:func:`load_checkpoint_dir` maps ``config.json`` onto the matching config
dataclass by ``model_type`` (Llama/Mistral, BART, BERT).  Trees come back
as CPU tensors in the files' dtypes; the engines move them to their device.
:func:`generate_engine_from_dir` goes straight to a decoder engine.

Weight reads are retried (``_LOAD_RETRY``: ``OSError`` and injected faults,
three attempts) behind the ``checkpoint`` breaker (``_LOAD_BREAKER``, which
the runtime adopts onto its board so ``/api/status`` shows it).  A kernel
or CUDA fault passes both unchanged and is never retried.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

from docqa_tpu_torch.config import DecoderConfig, EncoderConfig, Seq2SeqConfig
from docqa_tpu_torch.resilience import faults
from docqa_tpu_torch.resilience.breaker import CircuitBreaker
from docqa_tpu_torch.resilience.policy import RetryPolicy

# shard reads ride network filesystems in real deployments: transient IO
# errors are retried with backoff; deterministic failures (a corrupt
# file) are not retried but still feed the breaker, so repeated in-process
# loads fail fast after two exhausted loads
_LOAD_RETRY = RetryPolicy(
    max_attempts=3,
    base_delay_s=0.2,
    max_delay_s=2.0,
    retry_on=(OSError, faults.InjectedFault),
)
# two fully exhausted loads (2 x max_attempts): one bad directory must not
# block a later load of a healthy one
_LOAD_BREAKER = CircuitBreaker(
    "checkpoint", failure_threshold=6, reset_timeout_s=60.0
)

def _load_weights(loader, *args):
    """One retried, breaker-guarded weight read (fault site
    ``checkpoint.load``)."""

    def attempt():
        faults.perturb("checkpoint.load")
        return loader(*args)

    return _LOAD_RETRY.call(
        attempt, name="checkpoint_load", breaker=_LOAD_BREAKER
    )


def _find_tokenizer(path: str) -> Optional[str]:
    for name in ("tokenizer.json", "tokenizer.model", "vocab.txt"):
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            return cand
    return None


def _find_weights(path: str) -> list:
    shards = sorted(glob.glob(os.path.join(path, "model*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no model*.safetensors under {path}")
    return shards


def _decoder_config(hf: Dict[str, Any], tokenizer_path) -> DecoderConfig:
    heads = hf["num_attention_heads"]
    return DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_dim=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        mlp_dim=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        sliding_window=hf.get("sliding_window"),
        tokenizer_path=tokenizer_path,
    )


def _seq2seq_config(hf: Dict[str, Any], tokenizer_path) -> Seq2SeqConfig:
    activation = hf.get("activation_function", "gelu")
    if activation != "gelu":
        raise ValueError(
            f"activation_function {activation!r}: the port's BART MLP is the "
            "exact GELU (\"gelu\") only"
        )
    return Seq2SeqConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        enc_layers=hf["encoder_layers"],
        dec_layers=hf["decoder_layers"],
        num_heads=hf["encoder_attention_heads"],
        mlp_dim=hf["encoder_ffn_dim"],
        max_src_len=hf.get("max_position_embeddings", 1024),
        max_tgt_len=hf.get("max_position_embeddings", 1024),
        pad_id=hf.get("pad_token_id", 1),
        bos_id=hf.get("bos_token_id", 0),
        eos_id=hf.get("eos_token_id", 2),
        decoder_start_id=hf.get("decoder_start_token_id", 2),
        forced_bos_id=hf.get("forced_bos_token_id"),
        # the checkpoint's shipped generation policy (bart-large-cnn's
        # config.json holds num_beams 4, length_penalty 2.0, min_length 56,
        # no_repeat_ngram_size 3): serving it greedy and unconstrained
        # would silently degrade it
        num_beams=int(hf.get("num_beams", 1)),
        length_penalty=float(hf.get("length_penalty", 1.0)),
        min_length=int(hf.get("min_length", 0)),
        no_repeat_ngram=int(hf.get("no_repeat_ngram_size", 0)),
        tokenizer_path=tokenizer_path,
    )


def _encoder_config(hf: Dict[str, Any], tokenizer_path) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_dim=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 512),
        embed_dim=hf["hidden_size"],
        tokenizer_path=tokenizer_path,
    )


# llama/mistral only: qwen2 ships attention biases and gemma changes the
# norm, the embedding scale and the MLP; the Llama mapper would load either
# without error and serve wrong text
_DECODER_TYPES = ("llama", "mistral")
_SEQ2SEQ_TYPES = ("bart", "mbart")
# bert only: distilbert renames every config key and roberta prefixes its
# weights "roberta.", either a KeyError deep in the mapper
_ENCODER_TYPES = ("bert",)

_FAMILY_TYPES = {
    DecoderConfig: _DECODER_TYPES,
    Seq2SeqConfig: _SEQ2SEQ_TYPES,
    EncoderConfig: _ENCODER_TYPES,
}
_FAMILY_NAMES = {
    DecoderConfig: "a Llama/Mistral-family decoder",
    Seq2SeqConfig: "a BART-family seq2seq",
    EncoderConfig: "a BERT-family encoder",
}


def load_checkpoint_dir(
    path: str,
    *,
    expect: Optional[type] = None,
    keep: Optional[Dict[str, Any]] = None,
    tokenizer_fallback: Optional[str] = None,
) -> Tuple[Any, Any, Optional[str]]:
    """(config, params, tokenizer_path) from an HF directory.

    ``expect`` (a config class) rejects a wrong-family directory from
    ``config.json`` alone, before any shard is read.  ``keep`` fields
    override the loaded config (the serving knobs the operator keeps).
    ``tokenizer_fallback`` is used when the directory ships no vocabulary
    file; real weights with no vocabulary at all are an error (hash ids
    into real embeddings would serve gibberish).  Sharded BART and BERT
    directories are refused (their mappers take one file)."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "")
    if model_type not in _DECODER_TYPES + _SEQ2SEQ_TYPES + _ENCODER_TYPES:
        raise ValueError(
            f"unsupported model_type {model_type!r} in {path}/config.json "
            f"(decoder: {_DECODER_TYPES}, seq2seq: {_SEQ2SEQ_TYPES}, "
            f"encoder: {_ENCODER_TYPES})"
        )
    if expect is not None and model_type not in _FAMILY_TYPES[expect]:
        raise ValueError(
            f"{path} has model_type {model_type!r} — not "
            f"{_FAMILY_NAMES[expect]} checkpoint"
        )
    tok = _find_tokenizer(path) or tokenizer_fallback
    if tok is None:
        raise ValueError(
            f"no tokenizer.json / tokenizer.model / vocab.txt in {path} "
            "and no tokenizer_path configured — real weights with a "
            "hash-fallback vocabulary would serve gibberish; ship the "
            "tokenizer file or set <section>.tokenizer_path"
        )
    shards = _find_weights(path)
    if model_type in _DECODER_TYPES:
        from docqa_tpu_torch.models.decoder import load_hf_llama_weights

        cfg = _decoder_config(hf, tok)
        if keep:
            cfg = dataclasses.replace(cfg, **keep)
        return cfg, _load_weights(load_hf_llama_weights, shards, cfg), tok
    if len(shards) > 1:
        raise ValueError(
            f"sharded {model_type} checkpoints are not supported "
            f"({len(shards)} shards in {path}); merge to one "
            "model.safetensors first"
        )
    if model_type in _SEQ2SEQ_TYPES:
        from docqa_tpu_torch.models.seq2seq import load_hf_bart_weights

        cfg = _seq2seq_config(hf, tok)
        if keep:
            cfg = dataclasses.replace(cfg, **keep)
        return cfg, _load_weights(load_hf_bart_weights, shards[0], cfg), tok
    from docqa_tpu_torch.models.encoder import load_hf_bert_weights

    cfg = _encoder_config(hf, tok)
    if keep:
        cfg = dataclasses.replace(cfg, **keep)
    return cfg, _load_weights(load_hf_bert_weights, shards[0], cfg), tok


def generate_engine_from_dir(
    path: str,
    *,
    quant_bits: Optional[int] = None,
    gen=None,
    tokenizer_path: Optional[str] = None,
    device="cuda",
):
    """A ready :class:`~docqa_tpu_torch.engines.generate.GenerateEngine`
    from an HF Llama/Mistral checkpoint directory, on ``device``.
    ``quant_bits`` 8 / 4 quantises the float tree on load, tensor by tensor
    as each is uploaded (the engine's ``quantize_weights`` path: the
    quantised tree plus one float tensor on the device at the peak).
    ``tokenizer_path`` supplies the vocabulary of a weights-only
    directory."""
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    keep = (
        {"quantize_weights": True, "quant_bits": quant_bits} if quant_bits else None
    )
    cfg, params, _tok = load_checkpoint_dir(
        path, expect=DecoderConfig, keep=keep, tokenizer_fallback=tokenizer_path
    )
    return GenerateEngine(cfg, gen=gen, params=params, device=device)
