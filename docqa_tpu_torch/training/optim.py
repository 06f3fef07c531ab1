"""The trainers' optimizer: the reference's optax chain in PyTorch.

Every trainer of the reference builds the same chain
(``docqa_tpu/training/{ner,train,encoder}.py``)::

    optax.chain(optax.clip_by_global_norm(1.0),
                optax.adamw(lr_or_schedule, b1=0.9, b2=0.95, weight_decay=wd))

and this module reproduces it step for step:

* **Clip** as optax computes it: with ``n`` the global L2 norm of all
  gradients, each gradient becomes ``g / n * max_norm`` when
  ``n >= max_norm`` and stays as it is otherwise — no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_`` (which divides by ``n + 1e-6``).  The
  choice is made on the device (``torch.where``), so a step never waits
  for the norm on the host.  On a tensor-parallel mesh the norm is the
  global gradient's: the squared norms of the split leaves summed over the
  model axis, the replicated leaves' added once (the state's ``layout``).
* **AdamW** is ``torch.optim.AdamW`` with the reference's b1, b2, eps 1e-8
  and weight decay.  PyTorch decays before its Adam step
  (``p *= 1 - lr * wd``) and optax adds ``wd * p`` to the Adam update; both
  use the parameter as it was before the step, so
  ``p - lr * (adam + wd * p)`` is the same update either way.
* **Schedule**: optax evaluates a schedule at its update count BEFORE the
  count increments, so the first update runs at ``schedule(0)``.  For the
  tagger's ``warmup_cosine_decay_schedule(0, lr, warmup, steps, lr * 0.05)``
  that is 0: the first step moves the moments and leaves the weights as
  they were.  :meth:`ChainState.update` sets the group's lr from
  :meth:`AdamWChain.lr_at` of its own count before each step, which keeps
  that order (a ``LambdaLR`` built to start at factor 1 would not).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from docqa_tpu_torch.runtime.mesh import all_reduce, group_size


@dataclasses.dataclass(frozen=True)
class AdamWChain:
    """The description of the chain, as an optax ``GradientTransformation``
    is one: ``init(params)`` gives the live state that steps them.

    ``steps``: when given, the lr follows optax's
    ``warmup_cosine_decay_schedule(0, lr, min(warmup, max(steps // 10, 1)),
    steps, lr * 0.05)``; otherwise it is constant."""

    lr: float
    weight_decay: float
    steps: Optional[int] = None
    warmup: int = 100
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    max_norm: float = 1.0

    def __post_init__(self):
        if self.steps and self.steps - self.warmup_steps <= 0:
            # optax's cosine leg refuses a non-positive length too
            raise ValueError(
                f"the cosine schedule needs steps > warmup, got steps={self.steps}"
            )

    @property
    def warmup_steps(self) -> int:
        return min(self.warmup, max(self.steps // 10, 1)) if self.steps else 0

    def lr_at(self, count: int) -> float:
        """The lr of the update made at ``count`` (0 for the first)."""
        if not self.steps:
            return self.lr
        w = self.warmup_steps
        if count < w:  # linear from 0 to lr
            return self.lr * (count / w)
        t = min(count - w, self.steps - w)
        alpha = 0.05  # end value / peak value
        cosine = 0.5 * (1 + math.cos(math.pi * t / (self.steps - w)))
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: Dict[str, torch.Tensor], layout=None) -> "ChainState":
        """``layout``: a ``parallel/sharding.TreeLayout`` when ``params``
        are this rank's blocks of a tree on a mesh (the clip then takes the
        global norm)."""
        return ChainState(self, params, layout)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         group=None) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm`` does; returns
    the global norm before clipping (a 0-dim float32 tensor).

    ``sharded`` (a flag a gradient) and ``group``: the gradients are this
    rank's blocks of a tensor-parallel tree, the flagged ones split over
    ``group`` and the others whole on every rank.  The squared norms of
    the split blocks are summed over ``group`` (one all-reduce of one
    scalar, site ``clip``) and the whole leaves' added once, so every rank
    clips by the norm of the global gradient.  On a group of one rank, or
    with nothing flagged, it is the single-device function."""
    if sharded is None or group_size(group) == 1 or not any(sharded):
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
    else:
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        sq = all_reduce(torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum(),
                        group, "clip")
        whole = [n for n, s in zip(norms, sharded) if not s]
        if whole:
            sq = sq + torch.stack(whole).square().sum()
        norm = sq.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ChainState:
    """The chain's live state over one parameter tree: the AdamW moments
    and the update count.  The parameters are stepped in place.
    ``layout``: where the tree's leaves lie on a mesh (None: whole)."""

    def __init__(self, chain: AdamWChain, params: Dict[str, torch.Tensor], layout=None):
        self.chain = chain
        self.params = params
        self.layout = layout
        split = set(layout.sharded) if layout is not None else set()
        self._sharded = [k in split for k in params] if split else None
        self.count = 0
        self.adamw = torch.optim.AdamW(
            list(params.values()), lr=chain.lr_at(0), betas=(chain.b1, chain.b2),
            eps=chain.eps, weight_decay=chain.weight_decay,
        )

    def update(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``: clip, set the
        lr of this count, AdamW; clears the grads.  Returns the global
        gradient norm before clipping."""
        grads = [p.grad for p in self.params.values()]
        if any(g is None for g in grads):
            missing = [k for k, p in self.params.items() if p.grad is None]
            raise RuntimeError(f"no gradient reached {missing}")
        norm = clip_by_global_norm_(
            grads, self.chain.max_norm, self._sharded,
            self.layout.mesh.model_group if self._sharded else None)
        for group in self.adamw.param_groups:
            group["lr"] = self.chain.lr_at(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}
