"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the answered asks, drawn from the seed with the longest among them, is held
to the plain reference (``portbench/reference``), which works everything
out again from the benchmark's inputs:

* ``retrieval_gap``: the widest amount by which a row the program retrieved
  scores, by the reference's float32 encoder and cosine top-k, below the
  reference's k-th best row, or below the row the program ranked after it;
* ``prompt_mismatch``: asks whose prompt ids differ from the reference's
  tokenization of the template over the program's retrieved chunks (exact);
* ``logit_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at its position (with the end token
  after an answer that stopped early), over the prefill and every decode
  step of the sampled answers.

The control puts the reference in the program's place one precision lower,
on the same sampled asks: its rows are the float8 top-k, its tokens at each
position of the same prompts and answers the ones that the lower precision
puts first.  They are judged by the same numbers and the same limits as the
program's, through :func:`verdict`, and have to come out not correct.  One
precision below the configuration's: float8 e4m3 for what it states in bf16
(the encoder's products, the store's rows, a bf16 decoder's projections:
the step Hopper's fp8 tensor cores tempt), int4 in groups for an int8
decoder (``control_bits``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.reference import models, text
from portbench.system import model_shape, sources_to_rows

EOS_ID = 2


def control_bits(config: Dict[str, Any]):
    """The decoder's precision in the control: float8 below bf16, int4 below
    int8."""
    return {16: "fp8", 8: 4}[int(config["served"].get("weight_bits", 16))]


def sample(records, n: int, seed: int):
    """``n`` answered asks drawn from the seed, the longest among them."""
    done = [r for r in records if r.answered and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.prompt_ids) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([inputs.sub_seed(seed, "sample"), 0])
    pick = sorted(rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False))
    return [longest] + [rest[i] for i in pick]


def judge(asks, config: Dict[str, Any], mix: Dict[str, Any], seed: int, device,
          control=None):
    """The numbers compared, for the sampled ``asks`` (records with
    ``sources``, ``prompt_ids`` and ``tokens``): the program's, and with
    ``control`` (the decoder's bits in the control) the control's under the
    same names, else None."""
    dev = torch.device(device)
    shape = model_shape(config)
    enc, st = config["encoder"], config["store"]
    k = int(st["default_k"])
    texts = inputs.text_pool(seed, int(mix["text_pool"]), int(mix["chunk_tokens"]))
    bits = int(config["served"].get("weight_bits", 16))
    out: Dict[str, float] = {}
    ctl_out: Dict[str, float] = {"prompt_mismatch": 0.0}  # the reference's own prompts
    with torch.no_grad(), models.exact_float32():
        rows = inputs.store_vectors(int(st["rows"]), int(st["dim"]), seed, dev)
        rows = rows / rows.norm(dim=1, keepdim=True).clamp_min(1e-9)
        enc_w = inputs.encoder_weights(enc, seed, dev)
        layers, heads = int(enc["num_hidden_layers"]), int(enc["num_attention_heads"])
        gaps, ctl_gaps, mismatch, prompts = [], [], 0, []
        rows_c = models.fp8(rows, 1) if control else None
        for r in asks:
            q_ids = text.encode(r.ask.question, int(enc["vocab_size"]),
                                int(enc["max_position_embeddings"]))
            score = rows @ models.bert_embed(enc_w, layers, heads, q_ids, dev)
            kth = torch.topk(score, k).values[-1]
            got = torch.as_tensor(sources_to_rows(r.sources), device=dev)
            gaps.append(_retrieval_gap(score, kth, got, k))
            if control:
                q_c = models.bert_embed(enc_w, layers, heads, q_ids, dev, bits="fp8")
                ctl = torch.topk(rows_c @ q_c, k).indices
                ctl_gaps.append(_retrieval_gap(score, kth, ctl, k))
            chunks = [texts[int(i) % len(texts)] for i in got.tolist()]
            ids = text.encode(text.prompt_text(r.ask.question, chunks), shape.vocab)
            mismatch += int(ids != list(r.prompt_ids))
            prompts.append(ids)
        del rows, rows_c, enc_w
        out["retrieval_gap"] = max(gaps, default=0.0)
        out["prompt_mismatch"] = float(mismatch)
        ctl_out["retrieval_gap"] = max(ctl_gaps, default=0.0)

        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["torch_dtype"]]
        weights = inputs.decoder_weights(shape, seed, dev, dtype)
        seqs = [p + list(r.tokens) for p, r in zip(prompts, asks)]
        starts = [len(p) - 1 for p in prompts]
        kw = dict(rope_theta=float(config["rope_theta"]), norm_eps=float(config["rms_norm_eps"]))
        ref = models.decoder_logits(weights, shape, seqs, starts, dev, bits=bits, **kw)
        served = []
        for logits, r in zip(ref, asks):
            want = list(r.tokens)
            if len(want) < int(mix["max_new_tokens"]):
                want.append(EOS_ID)  # it stopped early: the end token was chosen
            served.append(_token_gap(logits, want))
        out["logit_gap"] = max(served, default=0.0)
        if not control:
            return out, None
        ctl = models.decoder_logits(weights, shape, seqs, starts, dev, bits=control, **kw)
        ctl_out["logit_gap"] = max(
            (_token_gap(logits, c_logits[: len(r.tokens)].argmax(dim=1).tolist())
             for logits, c_logits, r in zip(ref, ctl, asks)), default=0.0)
    return out, ctl_out


def _token_gap(logits: torch.Tensor, tokens: List[int]) -> float:
    """The widest gap by which ``tokens`` (one a position) lie below the
    reference's best logit at their positions."""
    idx = torch.arange(len(tokens), device=logits.device)
    best = logits[: len(tokens)].max(dim=1).values
    chosen = logits[idx, torch.as_tensor(tokens, device=logits.device)]
    return float((best - chosen).max())


def _retrieval_gap(score: torch.Tensor, kth: torch.Tensor, got: torch.Tensor, k: int) -> float:
    """How far the rows ``got`` (in their served order) fall below the k-th
    best reference score, or below the row before them; 1 for a list that
    is short or repeats a row."""
    if got.numel() != k or got.unique().numel() != k:
        return 1.0
    s = score[got]
    below = (kth - s).clamp_min(0).max()
    order = (s[1:] - s[:-1]).clamp_min(0).max() if k > 1 else torch.zeros((), device=s.device)
    return float(torch.maximum(below, order))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict[str, Any]]:
    """Each number compared beside its limit, in the limits' order."""
    return [{"name": name, "value": numbers.get(name, float("nan")), "limit": limit,
             "ok": bool(numbers.get(name, float("inf")) <= limit)}
            for name, limit in limits.items()]
