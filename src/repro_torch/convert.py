"""Carry parameters across from the JAX package.

A test turns the JAX parameters into numpy (``jax.tree.map(np.asarray,
params)``) and hands the nested dictionary here; this module never imports
JAX.  The layout is already the port's — weights (in, out), the layer stack
on a leading (L, ...) axis — so conversion is a dtype-preserving copy onto
the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.transformer import _dtype, resolve_device


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg, tree: Dict, device="cuda") -> Dict:
    """The port's parameter dictionary from a numpy copy of the JAX
    ``DenseLM`` parameters: the same keys, shapes and layout, in
    ``cfg.dtype`` on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"params_from_numpy: family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    dt = _dtype(cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x, dt, dev)
    out = conv(tree)
    expect = {"emb", "ln_f", "blocks"} | (set() if cfg.tie_embeddings
                                          else {"lm_head"})
    missing = expect - set(out)
    if missing:
        raise KeyError(f"params_from_numpy: missing {sorted(missing)}")
    return out
