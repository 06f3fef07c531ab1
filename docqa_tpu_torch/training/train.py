"""Training plane: causal-LM loss and train step, counterpart of
``docqa_tpu/training/train.py``.

The loss reuses the serving forward (``models/decoder.decoder_forward``)
with a throwaway cache and ``cache_lengths = 0`` — pure prefill — so train
and serve share one numerical path, with the attention swapped for its
plain version (``use_flash=False``): the flash kernel is forward-only.
Master parameters are float32 (the reference's ``param_dtype``); each
matmul casts its weight to ``cfg.dtype`` as serving does.  With ``remat``
each decoder layer runs under ``torch.utils.checkpoint``, so activations
are recomputed in the backward pass and device memory goes to weights,
gradients, optimizer moments and the batch.

On a mesh (``mesh=``, ``runtime/mesh.py``) the step is the reference's
GSPMD program written out: data parallel over ``data``, Megatron tensor
parallel over ``model`` with the serving PartitionSpecs
(``parallel/sharding.py``).  Every rank runs the same step in the same
order (a training script runs under ``torchrun``).  Per step, with L
layers and n_model > 1:

* the trunk: 2L all-reduces forward (``all_reduce.decoder``, Megatron's
  *g*), L more when remat recomputes the layers (the recompute stops once
  it has rebuilt what the backward saved, so ``w_down``'s all-reduce is
  not issued again), and 2L + 1 in the backward
  (``all_reduce.decoder_grad``, *f* before ``wq``/``wk``/``wv``,
  ``w_gate``/``w_up`` and ``lm_head``);
* the loss is vocabulary parallel over the ``lm_head`` shards: the row
  max (a MAX all-reduce) and then Σexp with the target's logit (one SUM
  all-reduce through *g*) over ``model`` (``all_reduce.vocab_ce``, two);
  no logits are gathered, and each rank's gradient reaches its own
  ``lm_head`` block;
* the loss is the reference's global mean: every rank counts the valid
  tokens of the whole batch (it holds the whole ``lengths``), takes its
  data rows (``mesh.data_lanes``), and backpropagates its rows' Σ nll
  over that count; the gradients are then summed over ``data`` one leaf at
  a time (``all_reduce.lm_grads``, one a leaf, no flat copy of the tree)
  and the loss with them (``all_reduce.lm_loss``), so every rank returns
  the whole batch's loss;
* the clip takes the global norm (one scalar over ``model``,
  ``all_reduce.clip``; ``training/optim.py``).

A data axis of one rank issues no data collective and a model axis of one
no model collective; the (1, 1) mesh runs the single-device step itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.decoder import (
    Params,
    decoder_forward,
    decoder_param_schema,
    init_kv_cache,
    iter_decoder_params,
)
from docqa_tpu_torch.parallel.sharding import (
    block_of, decoder_layout, decoder_param_pspecs, shard_leaf,
)
from docqa_tpu_torch.runtime.mesh import MeshContext, all_reduce, reduce_from_group
from docqa_tpu_torch.training.optim import AdamWChain
from docqa_tpu_torch.utils import resolve_device

TrainState = Dict[str, object]  # {"params", "opt_state", "step"}


def _loss_terms(params, cfg, ids, lengths, *, remat, mesh=None):
    """(Σ nll·mask, mask) over these rows: position t is supervised iff
    t + 1 < length.  ``mesh``: a tensor-parallel tree, whose vocabulary
    block's logits give the nll through :func:`_vocab_parallel_nll`."""
    b, s = ids.shape
    kv_heads = params["l0_wk"].shape[1] // cfg.head_dim
    cache = init_kv_cache(cfg, b, max_len=s, device=ids.device, num_kv_heads=kv_heads)
    logits = decoder_forward(
        params, cfg, ids, cache,
        torch.zeros((b,), dtype=torch.int32, device=ids.device),
        attn_lengths=lengths, use_flash=False, remat=remat, mesh=mesh,
    )  # [b, s, vocab (this rank's block on a model axis)] f32
    targets = ids[:, 1:].long()  # predict token t+1 from position t
    if mesh is not None and mesh.n_model > 1:
        nll = _vocab_parallel_nll(logits[:, :-1], targets, cfg.vocab_size, mesh)
    else:
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (torch.arange(s - 1, device=ids.device)[None, :] + 1) < lengths[:, None]
    return (nll * mask).sum(), mask


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
                        mesh: MeshContext) -> torch.Tensor:
    """-log softmax(logits)[target] from this rank's vocabulary block of
    the logits (``parallel/sharding.block_of``'s cut): the row max over
    ``model`` (a constant shift, no gradient), then Σexp and the target's
    logit summed over ``model`` in one all-reduce through Megatron's *g*.
    Every model rank gets the same nll; the gradient of its own block is
    softmax − one-hot on the block."""
    group = mesh.model_group
    start, _length = block_of(vocab, mesh.n_model, mesh.model_index)
    top = all_reduce(logits.detach().amax(dim=-1), group, "vocab_ce", op=dist.ReduceOp.MAX)
    sum_exp = torch.exp(logits - top[..., None]).sum(dim=-1)
    local = targets - start
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    both = reduce_from_group(torch.stack([sum_exp, torch.where(inside, picked, 0.0)]),
                             group, "vocab_ce")
    return torch.log(both[0]) + top - both[1]


def lm_loss(
    params: Params,
    cfg: DecoderConfig,
    ids: torch.Tensor,  # [b, s] right-padded token ids
    lengths: torch.Tensor,  # [b] valid lengths
    *,
    remat: bool = False,
) -> torch.Tensor:
    """Mean next-token cross-entropy over valid positions (position t is
    supervised iff t + 1 < length, so padding never counts)."""
    num, mask = _loss_terms(params, cfg, ids, lengths, remat=remat)
    return num / mask.sum().clamp_min(1)


def default_optimizer(lr: float = 3e-4) -> AdamWChain:
    return AdamWChain(lr, weight_decay=0.1)


def init_train_state(
    cfg: DecoderConfig,
    seed: int = 0,
    optimizer: Optional[AdamWChain] = None,
    params=None,
    device="cuda",
    mesh: Optional[MeshContext] = None,
) -> Tuple[TrainState, AdamWChain]:
    """(state, optimizer): float32 master params on ``device`` that require
    grad — ``params`` (numpy or tensors, copied) or, by default, the
    seeded device init of ``models/decoder.init_decoder_params`` (another
    draw than the reference's ``jax.random`` one) — their optimizer state,
    and step 0.

    ``mesh``: the params are this rank's tensor-parallel blocks (cut as
    ``parallel/sharding.shard_decoder_params`` cuts them) on
    ``mesh.device``, a leaf drawn and cut at a time, so a rank never holds
    the whole tree; the AdamW moments live beside them on the shards, and
    the optimizer state carries the tree's layout (``opt_state.layout``)."""
    from docqa_tpu_torch.weights import to_torch

    dev = mesh.device if mesh is not None else resolve_device(device)
    optimizer = optimizer or default_optimizer()
    copy = params is not None
    if params is None:  # drawn a leaf at a time
        leaves = iter_decoder_params(cfg, seed, dev, dtype=torch.float32)
    else:
        leaves = to_torch(params, dev, torch.float32).items()
    layout = specs = None
    if mesh is not None:
        layout = decoder_layout(cfg, mesh)
        specs = decoder_param_pspecs(cfg, mesh.model_axis)
        copy = copy or mesh.n_model > 1  # a block may be a view of the whole leaf
    params = {}
    for k, v in leaves:  # a leaf is dropped once its block is kept
        if specs is not None:
            v = shard_leaf(v, specs[k], mesh)
        params[k] = (v.clone() if copy else v).detach().requires_grad_(True)
        del v
    state: TrainState = {
        "params": params,
        "opt_state": optimizer.init(params, layout),
        "step": 0,
    }
    return state, optimizer


def _check_whole(params: Params, cfg: DecoderConfig) -> None:
    for name, _kind, shape, _fan in decoder_param_schema(cfg):
        got = tuple(params[name].shape) if name in params else None
        if got != tuple(shape):
            raise ValueError(
                f"leaf {name!r} has shape {got}, the whole leaf is {tuple(shape)}: a "
                f"tensor-parallel shard trains through make_train_step(mesh=)")


def make_train_step(
    cfg: DecoderConfig,
    optimizer: AdamWChain,
    mesh: Optional[MeshContext] = None,
    *,
    remat: bool = True,
):
    """``step(state, ids, lengths) -> (state, loss)``: loss, backward, one
    update; the state's parameters and moments are updated in place.  The
    loss stays on the device (no host sync).

    ``mesh``: data and tensor parallel (module docstring); the state must
    hold this rank's blocks (``init_train_state(mesh=)``) and the batch's
    rows divide the data axis (``ValueError`` otherwise).  Every rank
    passes the whole batch and returns the whole batch's loss.  A tree
    that is not what the step expects (a shard without ``mesh``, a whole
    tree on a tensor-parallel mesh) raises ``ValueError`` naming the leaf."""
    whole = mesh is None or mesh.n_devices == 1
    layout = None if whole else decoder_layout(cfg, mesh)

    def step(state: TrainState, ids, lengths):
        params = state["params"]
        if state["opt_state"].chain != optimizer:
            raise ValueError("the state's optimizer is not this step's")
        dev = next(iter(params.values())).device
        ids = torch.as_tensor(ids, device=dev)
        lengths = torch.as_tensor(lengths, device=dev)
        if whole:
            _check_whole(params, cfg)
            loss = lm_loss(params, cfg, ids, lengths, remat=remat)
            loss.backward()
            state["opt_state"].update()
            state["step"] = int(state["step"]) + 1
            return state, loss.detach()
        layout.check(params)
        if mesh.n_model > 1 and state["opt_state"].layout is None:
            raise ValueError("the optimizer state holds no layout: build the state with "
                             "init_train_state(mesh=)")
        rows = mesh.data_lanes(ids.shape[0])
        s = ids.shape[1]
        count = ((torch.arange(s - 1, device=dev)[None, :] + 1)
                 < lengths[:, None]).sum().clamp_min(1)
        num, _mask = _loss_terms(params, cfg, ids[rows], lengths[rows], remat=remat,
                                 mesh=mesh)
        (num / count).backward()
        for p in params.values():
            all_reduce(p.grad, mesh.data_group, "lm_grads")
        loss = all_reduce(num.detach() / count, mesh.data_group, "lm_loss")
        state["opt_state"].update()
        state["step"] = int(state["step"]) + 1
        return state, loss

    return step
