"""Carry parameters across from the JAX package.

A test turns the JAX parameters into numpy (``jax.tree.map(np.asarray,
params)``) and hands the nested dictionary here; this module never imports
JAX.  The layout is already the port's — weights (in, out), the layer stack
on a leading (L, ...) axis — so conversion is a copy onto the device in
``cfg.dtype``, except for the leaves the JAX package keeps in float32
whatever the model dtype, which stay float32: Mamba's ``a_log``,
``dt_bias`` and ``d_skip``, xLSTM's gate biases ``b_if`` and ``b_ifzo``,
the MoE ``router``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.transformer import _dtype, resolve_device

# the top-level keys each family's parameter tree must have (and
# "lm_head" where the transformer families do not tie the embeddings)
_EXPECT = {"dense": {"emb", "ln_f", "blocks"},
           "vlm": {"emb", "ln_f", "blocks", "patch_proj"},
           "moe": {"emb", "ln_f", "blocks"},
           "encdec": {"frame_proj", "emb", "enc", "dec", "ln_enc", "ln_f",
                      "lm_head"},
           "mamba2": {"emb", "ln_f", "lm_head", "mamba"},
           "hybrid": {"emb", "ln_f", "lm_head", "mamba", "shared"},
           "xlstm": {"emb", "ln_f", "lm_head", "mlstm", "slstm"}}
# the leaves each family keeps in float32 whatever the model dtype
FLOAT32_LEAVES = {"mamba2": mamba2.FLOAT32_LEAVES,
                  "hybrid": mamba2.FLOAT32_LEAVES,
                  "xlstm": xlstm.FLOAT32_LEAVES,
                  "moe": moe.FLOAT32_LEAVES}


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
    model's parameters (any registered family): the same keys, shapes and
    layout, in ``cfg.dtype`` on ``device`` (the family's float32 leaves in
    float32)."""
    if cfg.family not in _EXPECT:
        raise KeyError(f"params_from_numpy: unknown family {cfg.family!r}")
    dev = resolve_device(device)
    dt = _dtype(cfg.dtype)
    keep = FLOAT32_LEAVES.get(cfg.family, ())

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        keep32 = name in keep
        return _tensor(x, torch.float32 if keep32 else dt, dev)
    out = conv(tree)
    expect = set(_EXPECT[cfg.family])
    if cfg.family in ("dense", "vlm", "moe") and not cfg.tie_embeddings:
        expect.add("lm_head")
    missing = expect - set(out)
    if missing:
        raise KeyError(f"params_from_numpy: missing {sorted(missing)}")
    return out
