"""Collectives over a mesh's shards, as explicit tensor operations.

In the JAX package GSPMD inserts these into the sharded serving step; the
port's single controller calls them.  Each takes one tensor a shard (in
shard order, shard r on its own device) and returns one a shard: the
combined value, computed once on shard 0's device in shard order — so
results do not depend on timing and are the same on every shard — then
moved to each shard's device (``.to`` returns the same tensor where a
shard lives on shard 0's device, so shards that share a card share the
result).  With distinct cards the moves are peer copies.

``merge_partials`` is the split-K softmax merge: each shard attended over
its own slice of every page's rows and returned its output normalised over
those keys and their log-sum-exp; the merge weighs each shard by
``exp(lse_r - max lse)`` in float32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def _to_each(t: torch.Tensor, like: Sequence[torch.Tensor]):
    return [t.to(p.device) for p in like]


def all_reduce_sum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum of the shards' tensors, added in shard order."""
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return _to_each(acc, parts)


def all_reduce_max(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise maximum of the shards' tensors."""
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(dev))
    return _to_each(acc, parts)


def all_gather(parts: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The shards' tensors concatenated along ``dim`` in shard order."""
    dev = parts[0].device
    full = torch.cat([p.to(dev) for p in parts], dim=dim)
    return _to_each(full, parts)


def merge_partials(outs: List[torch.Tensor], lses: List[torch.Tensor]
                   ) -> torch.Tensor:
    """Split-K merge on shard 0's device.  outs: per shard (B, Sq, H, D),
    normalised over that shard's keys (zeros where it saw none); lses: per
    shard (B, Sq, H) float32, ``-inf`` where it saw none.  Returns the
    attention over all shards' keys, (B, Sq, H, D) in outs' dtype; a row
    no shard saw a key for is zeros.  The shards are stacked and weighed
    in one pass (a few launches whatever the shard count)."""
    dev = outs[0].device
    lse = torch.stack([x.to(dev) for x in lses]).float()     # (n, B, Sq, H)
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=dev))
    w = torch.exp(lse - m)                                   # 0 where -inf
    o = torch.stack([x.to(dev) for x in outs]).float()
    num = (w[..., None] * o).sum(dim=0)
    den = w.sum(dim=0)
    den = torch.where(den > 0, den, torch.ones((), device=dev))
    return (num / den[..., None]).to(outs[0].dtype)
