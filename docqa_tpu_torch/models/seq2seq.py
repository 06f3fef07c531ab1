"""BART-class encoder-decoder for summarization, counterpart of
``docqa_tpu/models/seq2seq.py``, laid out as HF
``BartForConditionalGeneration``:

* post-LN residuals (``x = LN(x + sublayer(x))``), GELU MLP;
* learned positions with BART's ``+2`` padding offset, and
  ``layernorm_embedding`` after the (token + position) sum;
* tied lm_head (the shared embedding transposed) + ``final_logits_bias``,

so a ``bart-large-cnn`` ``model.safetensors`` imports 1:1
(:func:`load_hf_bart_weights`).  Parameters are a flat dict of tensors with
the reference's names ([in, out] weights); every projection casts its
weight and bias to ``cfg.dtype`` where the reference does, the embedding
sum runs in the tree's dtype before its cast, layer norms in float32.

The MLP's GELU is the exact (erf) one, HF BART's ``"gelu"``; the
reference's ``jax.nn.gelu`` computes the tanh form (ROADMAP queue 3).

All three attentions go through :func:`docqa_tpu_torch.ops.attention.
attention` (K1 on a card, the plain version on the CPU) unless
``use_flash=False``: the encoder's self-attention (``prefill``, not
causal, ``lengths`` = source lengths), the decoder's causal
self-attention over its cache (``decode`` at one new token, ``q_offset`` =
cache lengths) and its cross-attention over the precomputed source K/V
(``decode``, not causal, ``lengths`` = source lengths).

Decoding (:func:`greedy_summarize`, :func:`beam_summarize`) encodes the
source once, computes every decoder layer's cross K/V once, then runs one
decoder step per token with no host sync except the termination test,
read once every ``check_every`` steps.  Steps run after every lane is done
emit ``pad_id`` and change nothing else that reaches the output, so the
tokens do not depend on ``check_every``.  Beam selection takes the top
``n_beams`` by (score, lower index), as the reference's ``lax.top_k``
orders ties.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from docqa_tpu_torch.config import Seq2SeqConfig
from docqa_tpu_torch.models.decoder import write_cache
from docqa_tpu_torch.ops.attention import attention, attention_reference
from docqa_tpu_torch.ops.norms import layer_norm
from docqa_tpu_torch.utils import torch_dtype

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30
GELU_APPROXIMATE = "none"  # F.gelu's exact form, HF BART's "gelu"
# the projections whose weight and bias the forward casts to cfg.dtype
_LINEAR = re.compile(r"^[ed]\d+_(x?[qkvo][wb]|fc[12]_[wb])$")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def seq2seq_param_schema(cfg: Seq2SeqConfig):
    """(name, kind, shape) with kind in {normal, zeros, ones}, in the
    reference's order: the order the seeded host init draws in, and the
    names the HF import maps to."""
    d, m = cfg.d_model, cfg.mlp_dim
    yield ("shared_emb", "normal", (cfg.vocab_size, d))
    yield ("enc_pos", "normal", (cfg.max_src_len + cfg.pos_offset, d))
    yield ("dec_pos", "normal", (cfg.max_tgt_len + cfg.pos_offset, d))
    yield ("enc_ln_emb_g", "ones", (d,))
    yield ("enc_ln_emb_b", "zeros", (d,))
    yield ("dec_ln_emb_g", "ones", (d,))
    yield ("dec_ln_emb_b", "zeros", (d,))
    yield ("final_logits_bias", "zeros", (cfg.vocab_size,))
    for side, n_layers in (("e", cfg.enc_layers), ("d", cfg.dec_layers)):
        for i in range(n_layers):
            p = f"{side}{i}_"
            attns = ("self", "cross") if side == "d" else ("self",)
            for a in attns:
                ap = p + ("x" if a == "cross" else "")
                for w in ("q", "k", "v", "o"):
                    yield (ap + w + "w", "normal", (d, d))
                    yield (ap + w + "b", "zeros", (d,))
                yield (ap + "ln_g", "ones", (d,))
                yield (ap + "ln_b", "zeros", (d,))
            yield (p + "fc1_w", "normal", (d, m))
            yield (p + "fc1_b", "zeros", (m,))
            yield (p + "fc2_w", "normal", (m, d))
            yield (p + "fc2_b", "zeros", (d,))
            yield (p + "lnf_g", "ones", (d,))
            yield (p + "lnf_b", "zeros", (d,))


def serving_params(params: Params, cfg: Seq2SeqConfig) -> Params:
    """The tree a serving engine holds: each projection's weight and bias
    cast to ``cfg.dtype`` once (the forward's per-use cast is then a no-op,
    with the same numbers), everything else as given, plus ``lm_head``, the
    shared embedding in ``cfg.dtype`` for the tied logits product."""
    dtype = torch_dtype(cfg.dtype)
    out = {
        name: t.to(dtype) if _LINEAR.match(name) else t
        for name, t in params.items()
    }
    out["lm_head"] = params["shared_emb"].to(dtype)
    return out


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _proj(x, params, prefix, dtype):
    return x @ params[prefix + "w"].to(dtype) + params[prefix + "b"].to(dtype)


def _heads(x, n_heads):
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads)


def _ln(x, params, prefix, cfg):
    return layer_norm(x, params[prefix + "_g"], params[prefix + "_b"],
                      cfg.norm_eps)


def _attend(use_flash):
    return attention if use_flash else attention_reference


def _attn_block(params, prefix, x, kv, cfg, lengths, dtype, use_flash):
    """One post-LN bidirectional attention sublayer (the encoder's)."""
    q = _heads(_proj(x, params, prefix + "q", dtype), cfg.num_heads)
    k = _heads(_proj(kv, params, prefix + "k", dtype), cfg.num_heads)
    v = _heads(_proj(kv, params, prefix + "v", dtype), cfg.num_heads)
    out = _attend(use_flash)(q, k, v, causal=False, lengths=lengths)
    out = _proj(out.reshape(x.shape), params, prefix + "o", dtype)
    return _ln(x + out, params, prefix + "ln", cfg)


def _ffn_block(params, prefix, x, cfg, dtype):
    h = F.gelu(_proj(x, params, prefix + "fc1_", dtype).float(),
               approximate=GELU_APPROXIMATE).to(dtype)
    h = _proj(h, params, prefix + "fc2_", dtype)
    return _ln(x + h, params, prefix + "lnf", cfg)


def encode_source(params: Params, cfg: Seq2SeqConfig, ids: torch.Tensor,
                  lengths: torch.Tensor, *, use_flash: bool = True) -> torch.Tensor:
    """[b, s] source ids -> [b, s, d] encoder states (padding positions are
    masked out of every attention by ``lengths``)."""
    s = ids.shape[1]
    dtype = torch_dtype(cfg.dtype)
    pos = torch.arange(s, device=ids.device) + cfg.pos_offset
    x = (params["shared_emb"][ids] + params["enc_pos"][pos][None]).to(dtype)
    x = _ln(x, params, "enc_ln_emb", cfg)
    for i in range(cfg.enc_layers):
        x = _attn_block(params, f"e{i}_", x, x, cfg, lengths, dtype, use_flash)
        x = _ffn_block(params, f"e{i}_", x, cfg, dtype)
    return x


def precompute_cross_kv(params: Params, cfg: Seq2SeqConfig,
                        enc_h: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V over the encoded source,
    computed once a request."""
    dtype = torch_dtype(cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.dec_layers):
        p = f"d{i}_x"
        out[f"xk{i}"] = _heads(_proj(enc_h, params, p + "k", dtype), cfg.num_heads)
        out[f"xv{i}"] = _heads(_proj(enc_h, params, p + "v", dtype), cfg.num_heads)
    return out


def init_self_cache(cfg: Seq2SeqConfig, batch: int, max_len: int,
                    device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.num_heads, cfg.d_model // cfg.num_heads)
    dtype = torch_dtype(cfg.dtype)
    return {
        key: torch.zeros(shape, dtype=dtype, device=device)
        for i in range(cfg.dec_layers)
        for key in (f"sk{i}", f"sv{i}")
    }


def decoder_forward(
    params: Params,
    cfg: Seq2SeqConfig,
    ids: torch.Tensor,  # [b, s] new target ids
    cache: Dict[str, torch.Tensor],  # self-attention K/V, written in place
    cache_lengths: torch.Tensor,  # [b] tokens already in the cache
    cross_kv: Dict[str, torch.Tensor],
    src_lengths: torch.Tensor,  # [b]
    *,
    use_flash: bool = True,
) -> torch.Tensor:
    """Run s new target tokens; returns logits [b, s, vocab] float32 and
    writes their K/V into ``cache`` at rows ``cache_lengths``.."""
    b, s = ids.shape
    dtype = torch_dtype(cfg.dtype)
    attend = _attend(use_flash)
    max_len = cache["sk0"].shape[1]
    steps = torch.arange(s, device=ids.device)[None, :]
    pos = (cache_lengths.long()[:, None] + steps).clamp(max=max_len - 1) + cfg.pos_offset
    x = (params["shared_emb"][ids] + params["dec_pos"][pos]).to(dtype)
    x = _ln(x, params, "dec_ln_emb", cfg)
    new_lengths = cache_lengths + s
    for i in range(cfg.dec_layers):
        p = f"d{i}_"
        # causal self-attention over the cache
        q = _heads(_proj(x, params, p + "q", dtype), cfg.num_heads)
        k = _heads(_proj(x, params, p + "k", dtype), cfg.num_heads)
        v = _heads(_proj(x, params, p + "v", dtype), cfg.num_heads)
        write_cache(cache[f"sk{i}"], k, cache_lengths)
        write_cache(cache[f"sv{i}"], v, cache_lengths)
        attn = attend(q, cache[f"sk{i}"], cache[f"sv{i}"], causal=True,
                      lengths=new_lengths, q_offset=cache_lengths)
        attn = _proj(attn.reshape(b, s, cfg.d_model), params, p + "o", dtype)
        x = _ln(x + attn, params, p + "ln", cfg)
        # cross-attention over the precomputed source K/V
        xq = _heads(_proj(x, params, p + "xq", dtype), cfg.num_heads)
        xattn = attend(xq, cross_kv[f"xk{i}"], cross_kv[f"xv{i}"], causal=False,
                       lengths=src_lengths)
        xattn = _proj(xattn.reshape(b, s, cfg.d_model), params, p + "xo", dtype)
        x = _ln(x + xattn, params, p + "xln", cfg)
        x = _ffn_block(params, p, x, cfg, dtype)
    head = params.get("lm_head")
    if head is None:
        head = params["shared_emb"].to(dtype)
    return (x @ head.T).float() + params["final_logits_bias"].float()


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def _done_check(done: torch.Tensor, step: int, check_every: int,
                stats: Optional[dict]) -> bool:
    """The loop's one host sync: every ``check_every`` steps, read whether
    every lane is done."""
    if step % check_every:
        return False
    if stats is not None:
        stats["flag_reads"] = stats.get("flag_reads", 0) + 1
    return bool(done.all())


def _count_step(stats: Optional[dict]) -> None:
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + 1


def greedy_summarize(
    params: Params,
    cfg: Seq2SeqConfig,
    src_ids: torch.Tensor,  # [b, s]
    src_lengths: torch.Tensor,  # [b]
    *,
    max_new: int,
    check_every: int = 16,
    use_flash: bool = True,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode, cross K/V, then greedy decode until every lane has emitted
    EOS or ``max_new`` tokens are out.  Returns (tokens [b, max_new],
    tokens emitted before EOS [b]) on the device.  ``stats`` (a dict)
    counts decode ``steps`` and host ``flag_reads``."""
    b = src_ids.shape[0]
    dev = src_ids.device
    enc_h = encode_source(params, cfg, src_ids, src_lengths, use_flash=use_flash)
    cross_kv = precompute_cross_kv(params, cfg, enc_h)
    cache = init_self_cache(cfg, b, max_new + 1, device=dev)

    start = torch.full((b, 1), cfg.decoder_start_id, dtype=torch.long, device=dev)
    logits = decoder_forward(
        params, cfg, start, cache, torch.zeros((b,), dtype=torch.int32, device=dev),
        cross_kv, src_lengths, use_flash=use_flash,
    )
    first = torch.argmax(logits[:, -1], dim=-1)
    if cfg.forced_bos_id is not None:  # HF BART: the first decoded token is BOS
        first = torch.full_like(first, cfg.forced_bos_id)
    out = torch.full((b, max_new), cfg.pad_id, dtype=torch.long, device=dev)
    out[:, 0] = first
    done = first == cfg.eos_id
    n_emitted = (~done).long()
    for step in range(1, max_new):
        if _done_check(done, step, check_every, stats):
            break
        logits = decoder_forward(
            params, cfg, out[:, step - 1 : step], cache,
            torch.full((b,), step, dtype=torch.int32, device=dev),
            cross_kv, src_lengths, use_flash=use_flash,
        )
        _count_step(stats)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(done, cfg.pad_id, nxt)
        out[:, step] = nxt
        is_eos = nxt == cfg.eos_id
        n_emitted += (~(done | is_eos)).long()
        done = done | is_eos
    return out, n_emitted


def top_k_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``x`` [rows, n], in
    descending order with ties taken lowest index first (the order of the
    reference's ``lax.top_k``; ``torch.topk`` leaves it unspecified).  k
    rounds of ``argmax``, which returns the first maximal index."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=1, keepdim=True)
        vals.append(torch.gather(x, 1, i))
        idxs.append(i)
        x.scatter_(1, i, float("-inf"))
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def _no_repeat_bans(out: torch.Tensor, t: int, m: int, V: int) -> torch.Tensor:
    """[b, B, W] token ids a beam may not emit at step ``t`` without
    repeating an ``m``-gram of its history (``V`` = nothing banned)."""
    max_new = out.shape[2]
    dev = out.device
    if m == 1:  # each token at most once
        complete = torch.arange(max_new, device=dev)[None, None, :] < t
        return torch.where(complete, out, V)
    W = max_new - m + 1
    follower = out[:, :, m - 1 : m - 1 + W]
    if t < m - 1:  # no complete (m-1)-token history yet
        return torch.full_like(follower, V)
    last = out[:, :, t - (m - 1) : t]  # the m-1 tokens ending at t-1
    # every historical m-gram window: its prefix and its follower token
    win = torch.stack([out[:, :, j : j + W] for j in range(m - 1)], dim=-1)
    match = (win == last[:, :, None, :]).all(dim=-1)
    complete = (torch.arange(W, device=dev) + m - 1)[None, None, :] < t
    return torch.where(match & complete, follower, V)


def beam_summarize(
    params: Params,
    cfg: Seq2SeqConfig,
    src_ids: torch.Tensor,  # [b, s]
    src_lengths: torch.Tensor,  # [b]
    *,
    max_new: int,
    n_beams: int,
    length_penalty: float = 1.0,
    min_length: int = 0,
    no_repeat_ngram: int = 0,
    check_every: int = 16,
    use_flash: bool = True,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search, the reference's ``beam_summarize_fn`` step for step.
    Beams ride the batch axis ([b * B] lanes): each step reorders the
    self-attention cache rows by winning parent beam (``index_select`` on
    the device) while the tiled cross K/V needs no reorder.  A finished
    beam exposes one continuation (pad at log-prob 0), so its score
    freezes; a beam that emits EOS is banked at once in a finished pool,
    so later eviction cannot lose it.  Final ranking divides by emitted
    length ** ``length_penalty``.  ``min_length`` bans EOS until emitted +
    1 reaches it (HF counts the start token); ``no_repeat_ngram`` bans
    repeated n-grams.  ``n_beams=1`` is exactly greedy.  Returns (tokens
    [b, max_new], tokens emitted [b])."""
    b = src_ids.shape[0]
    B, V = n_beams, cfg.vocab_size
    eos, pad = cfg.eos_id, cfg.pad_id
    dev = src_ids.device
    lane = torch.arange(b, device=dev)

    def penalize(score, n):
        return score / n.clamp(min=1).float() ** float(length_penalty)

    enc_h = encode_source(params, cfg, src_ids, src_lengths, use_flash=use_flash)
    cross_kv = {
        k: v.repeat_interleave(B, dim=0)
        for k, v in precompute_cross_kv(params, cfg, enc_h).items()
    }
    srcl = src_lengths.repeat_interleave(B, dim=0)
    cache = init_self_cache(cfg, b * B, max_new + 1, device=dev)

    start = torch.full((b * B, 1), cfg.decoder_start_id, dtype=torch.long, device=dev)
    logits = decoder_forward(
        params, cfg, start, cache,
        torch.zeros((b * B,), dtype=torch.int32, device=dev), cross_kv, srcl,
        use_flash=use_flash,
    )
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    if min_length > 1:  # no emission yet + the start token < min_length
        logp[:, eos] = NEG_INF
    if cfg.forced_bos_id is not None:
        # every beam shares the forced BOS prefix: only beam 0 carries
        # weight until the first branching step
        tok0 = torch.full((b, B), cfg.forced_bos_id, dtype=torch.long, device=dev)
        first = logp.reshape(b, B, V)[:, 0, cfg.forced_bos_id][:, None]
        scores = torch.where(torch.arange(B, device=dev)[None, :] == 0, first, NEG_INF)
    else:
        # all beams of a row are identical at step 0: branch from beam 0
        scores, tok0 = top_k_lowest_index(logp.reshape(b, B, V)[:, 0], B)
    out = torch.full((b, B, max_new), pad, dtype=torch.long, device=dev)
    out[:, :, 0] = tok0
    done = tok0 == eos
    emit_len = (~done).long()
    pad_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
    pad_only[pad] = 0.0
    fin_score = torch.where(done, penalize(scores, emit_len), NEG_INF)
    best0 = torch.argmax(fin_score, dim=1)
    fin_best = fin_score.amax(dim=1)
    fin_tokens = out[lane, best0]
    fin_len = emit_len[lane, best0]
    ngram = no_repeat_ngram >= 1 and max_new >= no_repeat_ngram

    for t in range(1, max_new):
        if _done_check(done, t, check_every, stats):
            break
        prev = out[:, :, t - 1].reshape(b * B)
        logits = decoder_forward(
            params, cfg, prev[:, None], cache,
            torch.full((b * B,), t, dtype=torch.int32, device=dev), cross_kv, srcl,
            use_flash=use_flash,
        )
        _count_step(stats)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(b, B, V)
        if min_length > 0:
            logp[:, :, eos] = torch.where(emit_len + 1 < min_length, NEG_INF,
                                          logp[:, :, eos])
        if ngram:
            ban = _no_repeat_bans(out, t, no_repeat_ngram, V)
            padded = torch.cat([logp, logp.new_zeros((b, B, 1))], dim=2)
            logp = padded.scatter_(2, ban, NEG_INF)[:, :, :V]
        cont = torch.where(done[:, :, None], pad_only[None, None, :], logp)
        total = scores[:, :, None] + cont  # [b, B, V]
        scores_new, idx = top_k_lowest_index(total.reshape(b, B * V), B)
        beam_idx = idx // V
        tok = idx % V
        # reorder the beam-carried state by the winning parent beam
        rows = (lane[:, None] * B + beam_idx).reshape(-1)
        for key in cache:
            cache[key] = cache[key].index_select(0, rows)
        out = torch.gather(out, 1, beam_idx[:, :, None].expand(-1, -1, max_new))
        done_g = torch.gather(done, 1, beam_idx)
        emit_g = torch.gather(emit_len, 1, beam_idx)
        out[:, :, t] = torch.where(done_g, pad, tok)
        is_eos = (~done_g) & (tok == eos)
        emit_len = emit_g + (~(done_g | is_eos)).long()
        done = done_g | is_eos
        scores = scores_new
        # bank newly finished hypotheses into the pool
        cand = torch.where(is_eos, penalize(scores, emit_len), NEG_INF)
        cand_best = torch.argmax(cand, dim=1)
        cand_score = cand.amax(dim=1)
        better = cand_score > fin_best
        fin_best = torch.where(better, cand_score, fin_best)
        fin_tokens = torch.where(better[:, None], out[lane, cand_best], fin_tokens)
        fin_len = torch.where(better, emit_len[lane, cand_best], fin_len)
    # the best banked hypothesis against the best still-live beam
    live_pen = torch.where(done, NEG_INF, penalize(scores, emit_len))
    live_best = torch.argmax(live_pen, dim=1)
    use_fin = fin_best >= live_pen.amax(dim=1)
    tokens = torch.where(use_fin[:, None], fin_tokens, out[lane, live_best])
    n_emitted = torch.where(use_fin, fin_len, emit_len[lane, live_best])
    return tokens, n_emitted


# ---------------------------------------------------------------------------
# HF weight import (facebook/bart-large-cnn layout)
# ---------------------------------------------------------------------------

_HF_ATTN = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}


def load_hf_bart_weights(path: str, cfg: Seq2SeqConfig) -> Params:
    """HF ``model.safetensors`` (``BartForConditionalGeneration``) as the
    reference's flat tree of CPU tensors in the file's dtype.  Torch Linear
    stores [out, in]: weights are transposed (and made contiguous).  A file
    with no ``final_logits_bias`` gets a float32 zero bias."""
    from docqa_tpu_torch.models.safetensors_io import load_file

    raw = {k.replace("model.", "", 1): v for k, v in load_file(path).items()}

    def t(name):
        return raw[name].T.contiguous()

    p: Params = {
        "shared_emb": raw["shared.weight"],
        "enc_pos": raw["encoder.embed_positions.weight"],
        "dec_pos": raw["decoder.embed_positions.weight"],
        "enc_ln_emb_g": raw["encoder.layernorm_embedding.weight"],
        "enc_ln_emb_b": raw["encoder.layernorm_embedding.bias"],
        "dec_ln_emb_g": raw["decoder.layernorm_embedding.weight"],
        "dec_ln_emb_b": raw["decoder.layernorm_embedding.bias"],
        "final_logits_bias": (
            raw["final_logits_bias"].reshape(-1)
            if "final_logits_bias" in raw
            else torch.zeros((cfg.vocab_size,), dtype=torch.float32)
        ),
    }
    for side, hf_side, n_layers in (
        ("e", "encoder", cfg.enc_layers),
        ("d", "decoder", cfg.dec_layers),
    ):
        for i in range(n_layers):
            pre = f"{hf_side}.layers.{i}."
            attns = [("", "self_attn", "ln")]
            if side == "d":
                attns.append(("x", "encoder_attn", "xln"))
            for mark, hf_attn, ln_mark in attns:
                for ours, theirs in _HF_ATTN.items():
                    p[f"{side}{i}_{mark}{ours}w"] = t(pre + f"{hf_attn}.{theirs}.weight")
                    p[f"{side}{i}_{mark}{ours}b"] = raw[pre + f"{hf_attn}.{theirs}.bias"]
                p[f"{side}{i}_{ln_mark}_g"] = raw[pre + f"{hf_attn}_layer_norm.weight"]
                p[f"{side}{i}_{ln_mark}_b"] = raw[pre + f"{hf_attn}_layer_norm.bias"]
            p[f"{side}{i}_fc1_w"] = t(pre + "fc1.weight")
            p[f"{side}{i}_fc1_b"] = raw[pre + "fc1.bias"]
            p[f"{side}{i}_fc2_w"] = t(pre + "fc2.weight")
            p[f"{side}{i}_fc2_b"] = raw[pre + "fc2.bias"]
            p[f"{side}{i}_lnf_g"] = raw[pre + "final_layer_norm.weight"]
            p[f"{side}{i}_lnf_b"] = raw[pre + "final_layer_norm.bias"]
    return p
