"""Collectives over a mesh's shards, as explicit tensor operations.

In the JAX package GSPMD inserts these into the sharded serving step; the
port's single controller calls them.  Each takes one tensor a shard (in
shard order, shard r on its own device) and returns one a shard: the
combined value, computed once on shard 0's device in shard order — so
results do not depend on timing and are the same on every shard — then
moved to each shard's device (``.to`` returns the same tensor where a
shard lives on shard 0's device, so shards that share a card share the
result).  With distinct cards the moves are peer copies.

``gather_partials`` serves the split-K softmax merge of shards on distinct
devices: each shard attended over its own slice of every page's rows, in
splits of its keys, and returned float32 partials (each split's output
normalised over its keys, and their log-sum-exp); they are copied to shard
0's device, where ``kernels.ops.merge_partials`` weighs every shard's and
split's partial by ``exp(lse_i - max lse)``.  Shards that share one device
write their partials into one workspace (``ops.partial_workspace``)
instead, which the merge reads in place.

A running ``roofline.cost.Counter`` charges each call its ring link bytes
per device, by type (all-reduce 2·B·(g−1)/g, all-gather out·(g−1)/g); the
additions and copies that compute it are counted as operations.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.roofline.cost import charge_collective


def _to_each(t: torch.Tensor, like: Sequence[torch.Tensor]):
    return [t.to(p.device) for p in like]


def all_reduce_sum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum of the shards' tensors, added in shard order."""
    charge_collective("all-reduce", parts)
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return _to_each(acc, parts)


def all_reduce_max(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise maximum of the shards' tensors."""
    charge_collective("all-reduce", parts)
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(dev))
    return _to_each(acc, parts)


def all_gather(parts: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The shards' tensors concatenated along ``dim`` in shard order."""
    dev = parts[0].device
    full = torch.cat([p.to(dev) for p in parts], dim=dim)
    charge_collective("all-gather", parts, full)
    return _to_each(full, parts)


def gather_partials(outs: List[torch.Tensor], lses: List[torch.Tensor]):
    """The split-K partials of shards on distinct devices, concatenated on
    shard 0's device in shard order for ``ops.merge_partials``: outs per
    shard (S, B, Sq, H, D) and lses per shard (S, B, Sq, H), float32 ->
    (o (tp·S, B, Sq, H, D), lse (tp·S, B, Sq, H))."""
    dev = outs[0].device
    o = torch.cat([x.to(dev) for x in outs])
    lse = torch.cat([x.to(dev) for x in lses])
    charge_collective("all-gather", outs, o)
    charge_collective("all-gather", lses, lse)
    return o, lse
