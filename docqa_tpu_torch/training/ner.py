"""The trained NER tagger's cache, counterpart of the persistence half of
``docqa_tpu/training/ner.py`` (``save_ner_params``, ``load_ner_params``,
``load_ner_train_seq``, ``_fingerprint``, ``load_or_train``).

The cache is a flat ``.npz`` of the tagger's leaves under the reference's
names, plus ``__fingerprint__`` (architecture, training steps, entity loss
weight, ``deid/datagen.DATA_VERSION``) and ``__train_seq__`` (the window
the tagger was trained at).  It is the carrier of a trained tagger across
frameworks: an npz the reference wrote loads here unchanged.

Training is not in this port yet, so :func:`load_or_train` loads or
raises.  It never trains and never falls back to random weights: a
random-init tagger must never mask production documents.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from docqa_tpu_torch.config import NERConfig
from docqa_tpu_torch.runtime.metrics import get_logger

log = get_logger("docqa.train.ner")

HostTree = Dict[str, np.ndarray]


class NERCacheError(RuntimeError):
    """No cached tagger matches the configuration (missing file, or one
    trained under another architecture, recipe or data version)."""


def save_ner_params(
    path: str,
    params,
    cfg: NERConfig,
    train_seq: int = 128,
    train_steps: Optional[int] = None,
) -> None:
    """``train_steps`` must be the steps ACTUALLY trained: a tagger saved
    under a larger count would later be served as if fully trained."""
    arrays = {k: np.asarray(v) for k, v in params.items()}
    arrays["__fingerprint__"] = np.asarray(
        _fingerprint(cfg, train_steps if train_steps is not None else cfg.train_steps)
    )
    # serving must window at the trained length: longer positions have
    # untrained position embeddings
    arrays["__train_seq__"] = np.asarray(train_seq)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_ner_params(
    path: str, cfg: NERConfig, steps: Optional[int] = None
) -> Optional[HostTree]:
    """The cached numpy tree, or None if missing or trained under a
    different architecture/recipe.  ``steps``: the steps the caller
    requires (default ``cfg.train_steps``) — a cache trained with other
    steps is not a match."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    fp = arrays.pop("__fingerprint__", None)
    arrays.pop("__train_seq__", None)
    want = _fingerprint(cfg, steps if steps is not None else cfg.train_steps)
    if fp is None or fp.tolist() != want:
        log.warning("ner params at %s do not match config", path)
        return None
    return arrays


def load_ner_train_seq(path: str) -> Optional[int]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "__train_seq__" not in z.files:
            return None
        return int(z["__train_seq__"])


def _fingerprint(cfg: NERConfig, steps: int) -> list:
    from docqa_tpu_torch.deid.datagen import DATA_VERSION

    return [
        cfg.vocab_size, cfg.hidden_dim, cfg.num_layers, cfg.num_heads,
        cfg.mlp_dim, cfg.max_seq_len, cfg.num_labels,
        # training-recipe fields: a cache trained with fewer steps, another
        # loss weighting or an older synthetic-data distribution must not
        # serve
        steps, int(cfg.entity_loss_weight * 100), DATA_VERSION,
    ]


def load_or_train(
    cfg: NERConfig,
    path: Optional[str] = None,
    steps: Optional[int] = None,
) -> Tuple[HostTree, int]:
    """(params, train_seq) of the cached tagger at ``path``; ``train_seq``
    is the serving window bound.  Raises :class:`NERCacheError` when no
    matching cache exists: training is not in this port yet (the reference
    trains here), and random weights are never served in its place."""
    steps = cfg.train_steps if steps is None else steps
    if not path:
        raise NERCacheError(
            "no NER params path given; the PyTorch port does not train the "
            "tagger (ROADMAP.md queue 1, item 10)"
        )
    params = load_ner_params(path, cfg, steps=steps)
    if params is None:
        raise NERCacheError(
            f"no NER cache at {path} matches this config and {steps} training "
            "steps; the PyTorch port does not train the tagger (ROADMAP.md "
            "queue 1, item 10)"
        )
    log.info("loaded ner params from %s", path)
    return params, load_ner_train_seq(path) or 128
