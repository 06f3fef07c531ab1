"""Contrastive fine-tuning for the sentence encoder, counterpart of
``docqa_tpu/training/encoder.py``: symmetric InfoNCE over in-batch
negatives (the sentence-transformers MultipleNegativesRanking recipe).

Embeddings come from the serving forward (``models/encoder.encode_batch``)
with its attention swapped for the plain version (``use_flash=False``: the
flash kernel is forward-only), so train and serve share one numerical
path.

On a mesh (``mesh=``) the step is data parallel, as the reference's: the
parameters are replicated, each data rank encodes its rows of the batch (a
multiple of the data axis), and ``zq`` and ``zp`` are all-gathered over
``data`` through autograd (``runtime/mesh.gather_from_group``, site
``encoder_negatives``: two gathers forward, and backward each rank's slice
of the summed gradient, two all-reduces), so every row scores against
every in-batch negative and a remote embedding's gradient goes back to its
owner.  Each rank sums its rows of both cross-entropy directions over the
global batch; the gradients are summed over ``data`` one leaf at a time
(``all_reduce.encoder_grads``) and the loss with them
(``all_reduce.encoder_loss``).  The model axis holds replicas that
compute alike; a data axis of one rank runs the single-device step.

A synthetic pair generator rides along for the zero-egress environment:
(query, positive) pairs are built by sampling keyword subsets of a
passage — the query shares content words with its passage, other rows are
the negatives.  The same ``numpy`` seed gives the reference's pairs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from docqa_tpu_torch.config import EncoderConfig
from docqa_tpu_torch.models.encoder import Params, encode_batch
from docqa_tpu_torch.parallel.sharding import replicated_layout
from docqa_tpu_torch.runtime.mesh import MeshContext, all_reduce, gather_from_group
from docqa_tpu_torch.runtime.metrics import get_logger
from docqa_tpu_torch.training.optim import AdamWChain
from docqa_tpu_torch.training.train import TrainState
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.train.encoder")


def info_nce_loss(
    params: Params,
    cfg: EncoderConfig,
    q_ids: torch.Tensor,  # [b, s]
    q_len: torch.Tensor,  # [b]
    p_ids: torch.Tensor,  # [b, s]
    p_len: torch.Tensor,  # [b]
    *,
    temperature: float = 0.05,
) -> torch.Tensor:
    """Symmetric in-batch-negatives cross-entropy: row i's positive is
    column i; every other row is a negative."""
    zq = encode_batch(params, cfg, q_ids, q_len, use_flash=False)  # [b, d]
    zp = encode_batch(params, cfg, p_ids, p_len, use_flash=False)
    logits = (zq @ zp.T) / temperature  # [b, b] cosine / T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def _info_nce_rows(params, cfg, q_ids, q_len, p_ids, p_len, rows: slice,
                   mesh: MeshContext, temperature: float) -> torch.Tensor:
    """This data rank's share of :func:`info_nce_loss` over the whole
    batch: its rows of both directions' cross-entropy, summed and divided
    by twice the global batch (the module docstring)."""
    group, b = mesh.data_group, q_ids.shape[0]
    zq = encode_batch(params, cfg, q_ids[rows], q_len[rows], use_flash=False)
    zp = encode_batch(params, cfg, p_ids[rows], p_len[rows], use_flash=False)
    zq_all = gather_from_group(zq, group, "encoder_negatives")  # [b, d]
    zp_all = gather_from_group(zp, group, "encoder_negatives")
    labels = torch.arange(rows.start, rows.stop, device=zq.device)
    l_qp = F.cross_entropy((zq @ zp_all.T) / temperature, labels, reduction="sum")
    l_pq = F.cross_entropy((zp @ zq_all.T) / temperature, labels, reduction="sum")
    return (l_qp + l_pq) / (2 * b)


def init_encoder_train_state(
    cfg: EncoderConfig,
    seed: int = 0,
    optimizer: Optional[AdamWChain] = None,
    params=None,
    device="cuda",
    mesh: Optional[MeshContext] = None,
) -> Tuple[TrainState, AdamWChain]:
    """(state, optimizer) over float32 params on ``device`` that require
    grad: ``params`` (numpy or tensors, copied) or, by default, the seeded
    host init ``weights.host_init_encoder_params(cfg, seed)``.  ``mesh``:
    the params are replicated on ``mesh.device``, and the optimizer state
    carries that layout (``parallel/sharding.replicated_layout``), so a
    checkpoint of it is written once, by rank 0, beside every rank's
    manifest (``training/checkpoint.py``)."""
    from docqa_tpu_torch.weights import host_init_encoder_params, to_torch

    dev = mesh.device if mesh is not None else resolve_device(device)
    optimizer = optimizer or AdamWChain(2e-4, weight_decay=0.01)
    if params is None:
        params = host_init_encoder_params(cfg, seed)
    params = {
        k: v.detach().clone().requires_grad_(True)
        for k, v in to_torch(params, dev, torch.float32).items()
    }
    layout = replicated_layout(params, mesh) if mesh is not None else None
    return (
        {"params": params, "opt_state": optimizer.init(params, layout), "step": 0},
        optimizer,
    )


def make_encoder_train_step(
    cfg: EncoderConfig, optimizer: AdamWChain, mesh: Optional[MeshContext] = None, *,
    temperature: float = 0.05,
):
    """``step(state, q_ids, q_len, p_ids, p_len) -> (state, loss)``: InfoNCE
    loss, backward, one update in place; the loss stays on the device.
    ``mesh``: data parallel (module docstring); every rank passes the whole
    batch, whose rows must divide the data axis (``ValueError``), and
    returns the whole batch's loss."""

    def step(state: TrainState, q_ids, q_len, p_ids, p_len):
        params = state["params"]
        if state["opt_state"].chain != optimizer:
            raise ValueError("the state's optimizer is not this step's")
        dev = next(iter(params.values())).device
        q_ids, q_len, p_ids, p_len = (
            torch.as_tensor(a, device=dev) for a in (q_ids, q_len, p_ids, p_len)
        )
        if mesh is None or mesh.n_data == 1:
            loss = info_nce_loss(
                params, cfg, q_ids.long(), q_len, p_ids.long(), p_len,
                temperature=temperature,
            )
            loss.backward()
        else:
            rows = mesh.data_lanes(q_ids.shape[0])
            share = _info_nce_rows(params, cfg, q_ids.long(), q_len, p_ids.long(), p_len,
                                   rows, mesh, temperature)
            share.backward()
            for p in params.values():
                all_reduce(p.grad, mesh.data_group, "encoder_grads")
            loss = all_reduce(share.detach(), mesh.data_group, "encoder_loss")
        state["opt_state"].update()
        state["step"] = int(state["step"]) + 1
        return state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Synthetic (query, passage) pair generator — zero-egress stand-in for
# mined clinical query logs.
# ---------------------------------------------------------------------------

_REAL_TOPICS: Tuple[Tuple[str, ...], ...] = (
    ("aspirin", "cardiac", "prevention", "dose", "antiplatelet", "daily"),
    ("metformin", "diabetes", "glucose", "insulin", "glycemic", "oral"),
    ("hypertension", "lisinopril", "blood", "pressure", "systolic", "ace"),
    ("asthma", "albuterol", "inhaler", "wheezing", "bronchial", "rescue"),
    ("warfarin", "anticoagulation", "inr", "clot", "bleeding", "monitor"),
    ("ginseng", "formula", "tonic", "qi", "root", "decoction"),
    ("influenza", "vaccine", "seasonal", "immunization", "antiviral", "flu"),
    ("migraine", "headache", "aura", "triptan", "photophobia", "episodic"),
)


def _make_topics(n_extra: int = 56, seed: int = 1234):
    """Pad the real topics with generated ones (unique pseudo-terms) so a
    batch larger than the topic pool doesn't recycle topics — recycled
    topics make rows i and i+8 near-duplicates, and InfoNCE then labels a
    passage containing the query's own keywords as a negative."""
    syl = (
        "bra cre dro fli gno plu sta tri vor wex zan kel mor dun pev "
        "qua rin sol tam urb"
    ).split()
    rng = np.random.default_rng(seed)
    topics = list(_REAL_TOPICS)
    seen = {w for t in topics for w in t}
    while len(topics) < len(_REAL_TOPICS) + n_extra:
        words = []
        while len(words) < 6:
            w = "".join(rng.choice(syl, 3))
            if w not in seen:
                seen.add(w)
                words.append(w)
        topics.append(tuple(words))
    return tuple(topics)


_TOPIC_WORDS: Tuple[Tuple[str, ...], ...] = _make_topics()
_FILLER = (
    "patient reports review plan continue stable daily follow up noted "
    "history exam today without with the for and of on"
).split()


def synthetic_pairs(
    rng: np.random.Generator, n: int
) -> List[Tuple[str, str]]:
    """(query, passage) pairs: each passage mixes one topic's content words
    with filler; its query is a keyword subset of the SAME topic.  Distinct
    rows draw distinct topics where possible, so in-batch negatives are
    real negatives."""
    pairs: List[Tuple[str, str]] = []
    topics = rng.permutation(len(_TOPIC_WORDS))
    for i in range(n):
        topic = list(_TOPIC_WORDS[topics[i % len(_TOPIC_WORDS)]])
        rng.shuffle(topic)
        body = topic[:4] + list(rng.choice(_FILLER, 6))
        rng.shuffle(body)
        passage = " ".join(body)
        query = " ".join(topic[:2])
        pairs.append((query, passage))
    return pairs


def encode_pair_batch(
    tokenizer, pairs: Sequence[Tuple[str, str]], seq: int
):
    """Host-side marshalling of a pair batch: ``tokenizer.batch`` already
    returns right-padded [b, seq] ids with clamped lengths."""
    q_ids, q_len = tokenizer.batch([q for q, _ in pairs], max_len=seq)
    p_ids, p_len = tokenizer.batch([p for _, p in pairs], max_len=seq)
    return q_ids, q_len, p_ids, p_len


def train_encoder(
    cfg: EncoderConfig,
    steps: int = 200,
    batch_size: int = 32,
    seq: int = 32,
    seed: int = 0,
    params=None,
    tokenizer=None,
    device="cuda",
    mesh: Optional[MeshContext] = None,
) -> Params:
    """Short fit on the synthetic pair stream; returns the trained float32
    params (detached tensors on ``device``).  The caller's ``params`` are
    copied, never written.  ``mesh``: data parallel, the batch rounded up
    to a multiple of the data axis as the reference rounds it."""
    from docqa_tpu_torch.text.tokenizer import default_tokenizer
    from docqa_tpu_torch.utils import round_up

    if steps < 1:
        raise ValueError(f"train_encoder needs steps >= 1, got {steps}")
    tokenizer = tokenizer or default_tokenizer(cfg.vocab_size)
    if mesh is not None and batch_size % mesh.n_data:
        batch_size = round_up(batch_size, mesh.n_data)
    state, optimizer = init_encoder_train_state(
        cfg, seed, params=params, device=device, mesh=mesh
    )
    step_fn = make_encoder_train_step(cfg, optimizer, mesh=mesh)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        pairs = synthetic_pairs(rng, batch_size)
        state, loss = step_fn(state, *encode_pair_batch(tokenizer, pairs, seq))
        if (i + 1) % 50 == 0 or i == steps - 1:
            log.info("encoder step %d/%d loss %.4f", i + 1, steps, float(loss))
    return {k: v.detach() for k, v in state["params"].items()}
