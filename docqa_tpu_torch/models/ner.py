"""Token-classification NER for PHI detection, counterpart of
``docqa_tpu/models/ner.py``: the encoder trunk (``models/encoder.py``,
attention through K1 on a card unless ``use_flash=False``, as training
asks) with a per-token classification head in float32, BIO labels over
the reference's 6-entity contract.  Span extraction is host-side
(``deid/engine.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from docqa_tpu_torch.config import EncoderConfig, NERConfig
from docqa_tpu_torch.models.encoder import Params, encoder_forward


def _trunk_cfg(cfg: NERConfig) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=cfg.vocab_size,
        hidden_dim=cfg.hidden_dim,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        mlp_dim=cfg.mlp_dim,
        max_seq_len=cfg.max_seq_len,
        embed_dim=cfg.hidden_dim,
        dtype=cfg.dtype,
    )


def init_ner_params(cfg: NERConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """A random float32 numpy tagger tree with the reference's names and
    layouts: the encoder trunk's seeded host init, then ``head_w`` ~
    N(0, 0.02²) [hidden, num_labels] and ``head_b`` = 0.

    The reference draws its tagger with ``jax.random`` (``init_ner_params``
    there), which this package cannot reproduce without JAX: the same seed
    gives OTHER weights here.  Parity with the reference therefore comes
    from carrying its weights across (``weights.ner_params_to_torch``, or an
    npz it wrote, ``training/ner.py``), never from matching inits."""
    from docqa_tpu_torch.weights import host_init_encoder_params

    p = host_init_encoder_params(_trunk_cfg(cfg), seed)
    head = np.random.default_rng([int(seed) & 0x7FFFFFFF, 1])
    p["head_w"] = (
        head.standard_normal((cfg.hidden_dim, cfg.num_labels)) * 0.02
    ).astype(np.float32)
    p["head_b"] = np.zeros((cfg.num_labels,), np.float32)
    return p


def ner_forward(
    params: Params, cfg: NERConfig, ids: torch.Tensor, lengths: torch.Tensor,
    *, use_flash: bool = True,
) -> torch.Tensor:
    """[b, s] ids -> [b, s, num_labels] f32 logits."""
    hidden = encoder_forward(params, _trunk_cfg(cfg), ids, lengths,
                             use_flash=use_flash)
    return hidden.float() @ params["head_w"].float() + params["head_b"].float()


# ---- BIO label scheme ------------------------------------------------------

def label_ids(cfg: NERConfig) -> Dict[str, int]:
    """{"O": 0, "B-PERSON": 1, "I-PERSON": 2, ...} in entity order."""
    out = {"O": 0}
    for i, ent in enumerate(cfg.entities):
        out[f"B-{ent}"] = 1 + 2 * i
        out[f"I-{ent}"] = 2 + 2 * i
    return out


def bio_to_spans(
    labels: List[int],
    word_spans: List[Tuple[int, int]],
    cfg: NERConfig,
    scores: List[float] | None = None,
) -> List[Tuple[str, int, int, float]]:
    """Merge per-word BIO labels into (entity, char_start, char_end, score).

    ``labels[i]`` is the label id for the word covering chars
    ``word_spans[i]``.  An I- tag without a preceding B-/I- of the same
    entity opens a new span (standard lenient decoding).
    """
    spans: List[Tuple[str, int, int, float]] = []
    cur_ent, cur_start, cur_end, cur_scores = None, 0, 0, []
    for i, lab in enumerate(labels):
        if lab <= 0 or lab > 2 * len(cfg.entities):
            ent, is_b = None, False
        else:
            ent = cfg.entities[(lab - 1) // 2]
            is_b = lab % 2 == 1
        score = scores[i] if scores is not None else 1.0
        if ent is None:
            if cur_ent:
                spans.append(
                    (cur_ent, cur_start, cur_end, float(min(cur_scores)))
                )
            cur_ent = None
        elif is_b or ent != cur_ent:
            if cur_ent:
                spans.append(
                    (cur_ent, cur_start, cur_end, float(min(cur_scores)))
                )
            cur_ent = ent
            cur_start, cur_end = word_spans[i]
            cur_scores = [score]
        else:  # I- continuing
            cur_end = word_spans[i][1]
            cur_scores.append(score)
    if cur_ent:
        spans.append((cur_ent, cur_start, cur_end, float(min(cur_scores))))
    return spans
