"""NER fine-tuning and the trained tagger's cache, counterpart of
``docqa_tpu/training/ner.py``.

The tagger trains on the synthetic PHI generator (``deid/datagen.py``):
an entity-weighted masked token-classification cross-entropy
(:func:`ner_loss`) under the reference's optimizer chain
(``training/optim.py``: global-norm clip 1.0, AdamW b1 0.9 b2 0.95 wd 0.01,
linear warmup + cosine decay from 0).  Training runs the trunk's plain
attention under autograd (``use_flash=False``): the flash kernel is
forward-only, as the reference's is, and the reference trains on its plain
attention too.  The single-device step is ported; the reference's
data-parallel ``mesh`` branch waits for the multi-GPU slice.

The trained tagger is cached as a flat ``.npz`` of its leaves under the
reference's names, plus ``__fingerprint__`` (architecture, training steps,
entity loss weight, ``deid/datagen.DATA_VERSION``) and ``__train_seq__``
(the window it was trained at), so serving restarts load instead of
retrain (:func:`load_or_train`).  The npz carries a tagger across
frameworks: one the reference wrote loads here, and one written here loads
there.  ``DeidEngine.trained`` is the one-call consumer.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from docqa_tpu_torch.config import NERConfig
from docqa_tpu_torch.models.ner import init_ner_params, ner_forward
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.runtime.metrics import get_logger
from docqa_tpu_torch.training.optim import AdamWChain, ChainState
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.train.ner")

Params = Dict[str, torch.Tensor]
HostTree = Dict[str, np.ndarray]


def ner_loss(
    params: Params,
    cfg: NERConfig,
    ids: torch.Tensor,  # [b, s]
    lengths: torch.Tensor,  # [b]
    labels: torch.Tensor,  # [b, s] BIO label ids
    mask: torch.Tensor,  # [b, s] 1.0 on supervised positions (first word token)
) -> torch.Tensor:
    """Masked NLL over the supervised positions, entity positions weighted
    by ``cfg.entity_loss_weight`` (they are ~18 % of the supervision; the
    weight keeps the optimizer out of the all-O collapse)."""
    logits = ner_forward(params, cfg, ids, lengths, use_flash=False)  # [b, s, L] f32
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = torch.where(labels > 0, cfg.entity_loss_weight, 1.0) * mask
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def default_ner_optimizer(
    lr: float = 1e-3, steps: Optional[int] = None, warmup: int = 100
) -> AdamWChain:
    """AdamW with global-norm clipping; when ``steps`` is given the lr
    follows linear-warmup + cosine-decay (the reference measured a constant
    lr unstable)."""
    return AdamWChain(lr, weight_decay=0.01, steps=steps, warmup=warmup)


def make_ner_train_step(cfg: NERConfig, optimizer: AdamWChain):
    """``step(params, opt_state, ids, lengths, labels, mask) -> (params,
    opt_state, loss)``: loss, backward, one update of ``opt_state`` (built
    by ``optimizer.init(params)``).  The parameters are updated in place
    and returned; the loss stays on the device (no host sync).  Batches may
    be numpy arrays or tensors."""

    def step(params, opt_state: ChainState, ids, lengths, labels, mask):
        if opt_state.chain != optimizer:
            raise ValueError("opt_state was not built by this step's optimizer")
        dev = next(iter(params.values())).device
        ids, lengths, labels, mask = (
            torch.as_tensor(a, device=dev) for a in (ids, lengths, labels, mask)
        )
        loss = ner_loss(params, cfg, ids.long(), lengths, labels, mask)
        loss.backward()
        opt_state.update()
        return params, opt_state, loss.detach()

    return step


def trainable(tree, cfg: NERConfig, device) -> Params:
    """A tagger tree (numpy or tensors) as float32 leaf tensors on
    ``device`` that require grad, copied: training never writes into the
    caller's tree."""
    from docqa_tpu_torch.weights import ner_params_to_torch

    return {
        k: v.detach().clone().requires_grad_(True)
        for k, v in ner_params_to_torch(tree, cfg, device).items()
    }


def train_ner(
    cfg: NERConfig,
    *,
    steps: Optional[int] = None,
    batch_size: int = 32,
    seq: int = 128,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 100,
    params=None,
    device="cuda",
) -> Params:
    """Fit the tagger on the synthetic PHI generator; returns its float32
    params (detached tensors on ``device``).

    ``params``: the tree to start from (default: ``init_ner_params(cfg,
    seed)``, a numpy draw that differs from the reference's ``jax.random``
    one — the tests carry the reference's tree across here).  Batches come
    from ``np.random.default_rng(seed)``, as the reference's do.  Serving
    must window documents at the ``seq`` used here — position embeddings
    beyond it never receive gradient (``DeidEngine.trained`` wires this
    through ``max_window``).
    """
    from docqa_tpu_torch.deid.datagen import ner_tokenizer, sample_batch

    dev = resolve_device(device)
    if steps is None:
        steps = cfg.train_steps
    if steps < 1:
        raise ValueError(
            f"train_ner needs steps >= 1, got {steps}; a 0-step 'trained' "
            "tagger would serve random weights (contextual-PHI leak)"
        )
    tokenizer = ner_tokenizer(cfg)
    seq = min(seq, cfg.max_seq_len)
    params = trainable(init_ner_params(cfg, seed) if params is None else params, cfg, dev)
    optimizer = default_ner_optimizer(lr, steps=steps)
    opt_state = optimizer.init(params)
    step_fn = make_ner_train_step(cfg, optimizer)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        batch = sample_batch(rng, tokenizer, cfg, batch_size, seq)
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        if log_every and (i + 1) % log_every == 0:
            log.info("ner step %d/%d loss %.4f", i + 1, steps, float(loss))
    return {k: v.detach() for k, v in params.items()}


# ---------------------------------------------------------------------------
# Span-level evaluation on the HELD-OUT lexicons (generalization, not recall
# of memorized surface forms).
# ---------------------------------------------------------------------------

def evaluate_ner(
    params,
    cfg: NERConfig,
    *,
    n_examples: int = 64,
    seed: int = 1234,
    threshold: Optional[float] = None,
    device="cuda",
) -> Dict[str, float]:
    """Exact-span precision / recall / F1 against gold spans of synthetic
    notes filled from EVAL_LEXICONS (disjoint from training).

    Scores the TAGGER ALONE (``engine._ner_results`` with the deny-list
    veto off, not the merged analyze output): the cue regexes match several
    datagen templates, and the deny-list was built from past tagger false
    positives — including either would credit a collapsed or regressed
    model.  The threshold defaults to the served operating point
    (``engine.DEFAULT_NER_THRESHOLD``).  The tagger runs its serving
    forward: the flash kernel on a card."""
    from docqa_tpu_torch.deid.datagen import (
        EVAL_LEXICONS,
        generate_example,
        ner_tokenizer,
    )
    from docqa_tpu_torch.deid.engine import DEFAULT_NER_THRESHOLD, DeidEngine

    engine = DeidEngine(
        cfg,
        tokenizer=ner_tokenizer(cfg),
        params=params,
        use_ner_model=True,
        ner_threshold=(
            DEFAULT_NER_THRESHOLD if threshold is None else threshold
        ),
        ner_deny_list=False,
        device=device,
    )
    rng = np.random.default_rng(seed)
    texts, golds = [], []
    for _ in range(n_examples):
        text, spans = generate_example(rng, EVAL_LEXICONS, gibberish_frac=0.0)
        texts.append(text)
        golds.append({(a, b, e) for a, b, e in spans})
    results = engine._ner_results(texts)
    tp = fp = fn = 0
    for rs, gold in zip(results, golds):
        pred = {
            (r.start, r.end, r.entity_type)
            for r in rs
            if r.entity_type in ("PERSON", "LOCATION", "NRP")
        }
        gold = {g for g in gold if g[2] in ("PERSON", "LOCATION", "NRP")}
        tp += len(pred & gold)
        fp += len(pred - gold)
        fn += len(gold - pred)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"precision": precision, "recall": recall, "f1": f1}


# ---------------------------------------------------------------------------
# Persistence: flat .npz cache so serving restarts load instead of retrain.
# ---------------------------------------------------------------------------

def save_ner_params(
    path: str,
    params,
    cfg: NERConfig,
    train_seq: int = 128,
    train_steps: Optional[int] = None,
) -> None:
    """``params``: numpy arrays or tensors.  ``train_steps`` must be the
    steps ACTUALLY trained: a tagger saved under a larger count would later
    be served as if fully trained."""
    arrays = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in params.items()
    }
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


def _train_in_subprocess(
    cfg: NERConfig, path: str, steps: int, seq: int, **train_kw
) -> bool:
    """Run train+save in a child process; True when the child saved the npz.

    A substantial train is minutes of step loops and allocator churn that
    a serving process should not carry: the child takes all of it, exits
    (releasing its device memory), and the parent loads host-side arrays
    from the npz, the path a restart takes.  The child imports this
    package only and gets the device in its JSON spec; its log lines (the
    loss every ``log_every`` steps) are relayed to this logger."""
    import dataclasses
    import json
    import subprocess
    import sys

    child = (
        "import json, sys\n"
        "spec = json.loads(sys.argv[1])\n"
        "from docqa_tpu_torch.config import NERConfig\n"
        "from docqa_tpu_torch.training.ner import save_ner_params, train_ner\n"
        "cfg = NERConfig(**{k: tuple(v) if isinstance(v, list) else v\n"
        "                   for k, v in spec['cfg'].items()})\n"
        "p = train_ner(cfg, steps=spec['steps'], seq=spec['seq'],\n"
        "              **spec['train_kw'])\n"
        "save_ner_params(spec['path'], p, cfg, train_seq=spec['seq'],\n"
        "                train_steps=spec['steps'])\n"
    )
    try:
        # payload construction inside the try: a non-JSON-serializable
        # value in train_kw must trigger the in-process fallback, not
        # raise out of load_or_train
        payload = json.dumps(
            {"cfg": dataclasses.asdict(cfg), "path": path, "steps": steps,
             "seq": seq, "train_kw": train_kw}
        )
        r = subprocess.run(
            [sys.executable, "-c", child, payload],
            capture_output=True,
            text=True,
            timeout=5400,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
    except Exception as e:  # timeout, spawn failure — parent falls back
        if is_device_fault(e):
            raise
        log.warning("subprocess NER training failed to run: %r", e)
        return False
    if r.returncode != 0:
        log.warning(
            "subprocess NER training exited %d: %s",
            r.returncode,
            (r.stderr or r.stdout)[-400:],
        )
        return False
    for line in r.stderr.splitlines():
        if "ner step" in line:
            log.info("child: %s", line.split("] ", 1)[-1])
    return True


def load_or_train(
    cfg: NERConfig,
    path: Optional[str] = None,
    train_in_subprocess: Optional[bool] = None,
    **train_kw,
) -> Tuple[Dict[str, object], int]:
    """(params, train_seq) — the cached tagger at ``path`` when its
    fingerprint matches, else a freshly trained one (cached at ``path``
    when given).  ``train_seq`` is the serving window bound.  ``train_kw``
    goes to :func:`train_ner` (``device`` included, default "cuda").

    ``train_in_subprocess``: None (default) auto-selects — a substantial
    train (steps >= 500) with a cache path on a card runs in a child
    process (:func:`_train_in_subprocess`); tiny trains and CPU trains stay
    in-process, where a child would only re-pay interpreter and torch
    start-up.  A child that fails falls back to training in-process."""
    steps = train_kw.get("steps")
    if steps is None:
        steps = cfg.train_steps
    if path:
        params = load_ner_params(path, cfg, steps=steps)
        if params is not None:
            log.info("loaded ner params from %s", path)
            return params, load_ner_train_seq(path) or 128
    seq = min(train_kw.get("seq", 128), cfg.max_seq_len)
    dev = resolve_device(train_kw.get("device", "cuda"))
    if train_in_subprocess is None:
        train_in_subprocess = bool(path) and steps >= 500 and dev.type == "cuda"
    if path and train_in_subprocess:
        # every remaining train_kw (seed, batch_size, lr, log_every) is a
        # JSON-able scalar and is forwarded verbatim, so the child trains
        # the caller's exact recipe under the same fingerprint
        sub_kw = {
            k: v for k, v in train_kw.items() if k not in ("steps", "seq", "device")
        }
        if _train_in_subprocess(cfg, path, steps, seq, device=str(dev), **sub_kw):
            params = load_ner_params(path, cfg, steps=steps)
            if params is not None:
                log.info("loaded ner params from child train at %s", path)
                return params, load_ner_train_seq(path) or seq
        log.warning("falling back to in-process NER training")
    params = train_ner(cfg, **train_kw)
    if path:
        save_ner_params(path, params, cfg, train_seq=seq, train_steps=steps)
        log.info("saved ner params to %s", path)
    return params, seq
