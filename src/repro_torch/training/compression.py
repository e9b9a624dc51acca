"""int8 gradient compression for the data-parallel all-reduce, after the
JAX package's ``training/compression.py``.

Single-controller, like ``distributed/collectives.py``: one gradient tree a
replica of the mesh's ``data`` axis (replica r's tensors on its own
device), one reduced tree a replica back.  Per tensor, the replicas first
agree on one scale, the all-reduce maximum of their per-tensor scales;
each then quantizes its gradient to int8 at that scale, the int32 sum of
the codes is all-reduced, and the mean is the sum times the scale over n:
4x fewer bytes over the data axis than float32, at the int8 error.

The JAX package's formula differs where replicas' scales differ: each
replica quantizes at its own scale and the summed codes are multiplied by
the largest (``compressed_psum``, repro/training/compression.py:21-39), so
gradients 1.0 and 0.1 average to 1.0 there.  Its ``shard_map`` hands every
replica the same gradient, where the two formulas agree bit for bit; this
one stays inside the int8 error on unequal replicas too (0.5512 for 1.0
and 0.1).  Nothing in either package's train step calls it yet.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.distributed import collectives as C
from repro_torch.kernels.quant import int8_codes, int8_scale
from repro_torch.training.tree import leaves, unflatten


def compressed_psum(grads_per_replica: List, mesh, axis: str = "data"
                    ) -> List:
    """The mean over ``axis`` of one gradient tree a replica, through an
    int8 payload; returns one float32 tree a replica, on its device."""
    n = mesh.shape[axis]
    if len(grads_per_replica) != n:
        raise ValueError(f"compressed_psum: {len(grads_per_replica)} "
                         f"gradient trees for {n} replicas on {axis!r}")
    cols = list(zip(*(leaves(g) for g in grads_per_replica)))
    out = [[] for _ in range(n)]
    for parts in cols:
        parts = [p.float() for p in parts]
        scales = [int8_scale(a) for a in
                  C.all_reduce_max([p.abs().amax() for p in parts])]
        acc = C.all_reduce_sum([int8_codes(p, s).to(torch.int32)
                                for p, s in zip(parts, scales)])
        for r in range(n):
            out[r].append(acc[r].float() * scales[r] / n)
    return [unflatten(g, o) for g, o in zip(grads_per_replica, out)]
