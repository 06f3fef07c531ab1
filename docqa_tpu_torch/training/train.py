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

The single-device step is ported; the reference's mesh branch (data
parallel over the batch, tensor parallel over the serving
PartitionSpecs) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.models.decoder import (
    Params,
    decoder_forward,
    init_decoder_params,
    init_kv_cache,
)
from docqa_tpu_torch.training.optim import AdamWChain
from docqa_tpu_torch.utils import resolve_device

TrainState = Dict[str, object]  # {"params", "opt_state", "step"}


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
    b, s = ids.shape
    cache = init_kv_cache(cfg, b, max_len=s, device=ids.device)
    logits = decoder_forward(
        params, cfg, ids, cache,
        torch.zeros((b,), dtype=torch.int32, device=ids.device),
        attn_lengths=lengths, use_flash=False, remat=remat,
    )  # [b, s, vocab] f32
    targets = ids[:, 1:].long()  # predict token t+1 from position t
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (torch.arange(s - 1, device=ids.device)[None, :] + 1) < lengths[:, None]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def default_optimizer(lr: float = 3e-4) -> AdamWChain:
    return AdamWChain(lr, weight_decay=0.1)


def init_train_state(
    cfg: DecoderConfig,
    seed: int = 0,
    optimizer: Optional[AdamWChain] = None,
    params=None,
    device="cuda",
) -> Tuple[TrainState, AdamWChain]:
    """(state, optimizer): float32 master params on ``device`` that require
    grad — ``params`` (numpy or tensors, copied) or, by default, the
    seeded device init of ``models/decoder.init_decoder_params`` (another
    draw than the reference's ``jax.random`` one) — their optimizer state,
    and step 0."""
    from docqa_tpu_torch.weights import to_torch

    dev = resolve_device(device)
    optimizer = optimizer or default_optimizer()
    if params is None:
        params = init_decoder_params(cfg, seed, dev, dtype=torch.float32)
    else:
        params = {k: v.clone() for k, v in to_torch(params, dev, torch.float32).items()}
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    state: TrainState = {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": 0,
    }
    return state, optimizer


def make_train_step(
    cfg: DecoderConfig,
    optimizer: AdamWChain,
    *,
    remat: bool = True,
):
    """``step(state, ids, lengths) -> (state, loss)``: loss, backward, one
    update; the state's parameters and moments are updated in place.  The
    loss stays on the device (no host sync)."""

    def step(state: TrainState, ids, lengths):
        params = state["params"]
        if state["opt_state"].chain != optimizer:
            raise ValueError("the state's optimizer is not this step's")
        dev = next(iter(params.values())).device
        ids = torch.as_tensor(ids, device=dev)
        lengths = torch.as_tensor(lengths, device=dev)
        loss = lm_loss(params, cfg, ids, lengths, remat=remat)
        loss.backward()
        state["opt_state"].update()
        state["step"] = int(state["step"]) + 1
        return state, loss.detach()

    return step
