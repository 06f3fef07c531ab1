"""Token sampling for the decode loop (counterpart of
``docqa_tpu/ops/sampling.py``).

Greedy is the default (temperature 0).  Stochastic sampling draws from an
explicit ``torch.Generator``: its numbers differ from JAX's threefry for
the same seed, so cross-framework parity is greedy only.
"""

from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[b, v] -> [b] int64 (first index of the maximum, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """[b, v] logits -> [b] int64 tokens; temperature 0 is pure argmax."""
    if temperature == 0.0:
        return greedy(logits)
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[
            ..., -1:
        ]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative prob (exclusive) is < top_p
        cutoff_mask = cum - probs < top_p
        kth = torch.where(
            cutoff_mask, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
