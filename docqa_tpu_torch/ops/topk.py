"""Exact top-k over row-sharded scores, counterpart of
``docqa_tpu/ops/topk.py``.

Each rank of the store's model group holds a block of the corpus rows,
scores it, and keeps a local top-k; the k candidates of every shard are
gathered (two ``all_gather``s: values and global ids) and merged, so the
gather moves ``k * n_shards`` pairs a query instead of a row of scores.
Exact: a row of the global top-k is in its own shard's top-k.
"""

from __future__ import annotations

import torch

from docqa_tpu_torch.runtime.mesh import all_gather, group_size


def local_topk(scores: torch.Tensor, k: int):
    """Per-shard top-k.  scores [q, n_local] -> (vals [q, k], idx [q, k])."""
    return torch.topk(scores, min(k, scores.shape[-1]), dim=-1)


def merge_topk(shard_vals: torch.Tensor, shard_ids: torch.Tensor, k: int):
    """Merge per-shard candidates: ``[n_shards, q, k_local]`` scores and
    global ids -> (vals [q, k], ids [q, k]), globally exact."""
    n_shards, q, k_local = shard_vals.shape
    flat_vals = shard_vals.permute(1, 0, 2).reshape(q, n_shards * k_local)
    flat_ids = shard_ids.permute(1, 0, 2).reshape(q, n_shards * k_local)
    vals, pos = torch.topk(flat_vals, min(k, flat_vals.shape[-1]), dim=-1)
    return vals, torch.gather(flat_ids, 1, pos)


def merge_sharded(vals: torch.Tensor, gids: torch.Tensor, k: int, group):
    """This rank's top candidates (vals [q, k_local], global ids) -> the
    global exact (vals [q, k], ids [q, k]) on every rank of ``group``: two
    ``all_gather``s and the merge.  A group of one rank gathers nothing."""
    if group_size(group) == 1:
        return vals, gids
    all_vals = all_gather(vals[None], group, "topk")
    all_ids = all_gather(gids[None], group, "topk")
    return merge_topk(all_vals, all_ids, k)


def sharded_topk(scores_local: torch.Tensor, shard_offset: int, k: int, group):
    """This rank's scores [q, n_local] (its rows start at global id
    ``shard_offset``) -> the global exact (vals [q, k], ids [q, k]) on every
    rank of ``group``: a local top-k, then :func:`merge_sharded`."""
    vals, idx = local_topk(scores_local, k)
    return merge_sharded(vals, idx + shard_offset, k, group)
