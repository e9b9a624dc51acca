"""Symmetric int8 quantization, with the JAX package's conventions.

One scale per tensor, or per leading group when ``axis`` reduces a subset
of dims: ``scale = max(max|x|, 1e-12) / 127`` in float32, and the codes are
``round(x / scale)`` clipped to [-127, 127].  The division is a true
division (never a multiply by the reciprocal) and ``torch.round`` rounds
half to even as ``jnp.round`` does, so the codes equal the JAX package's
exactly.  Used by the int8 KV tier (``DenseLM.compress_paged``); these are
plain tensor operations there as well, not a kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

Axis = Union[int, Sequence[int], None]


def quantize_int8(x: torch.Tensor, axis: Axis = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: q int8 of x's shape and scale float32 of x's shape
    with the ``axis`` dims removed (a 0-d scale for ``axis=None``), such
    that ``q * scale`` approximates x."""
    if axis is None:
        dims = tuple(range(x.dim()))
    elif isinstance(axis, int):
        dims = (axis,)
    else:
        dims = tuple(axis)
    xf = x.float()
    s = torch.clamp(torch.amax(xf.abs(), dim=dims, keepdim=True),
                    min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s.squeeze(dims) if dims else s


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: Optional[torch.dtype] = torch.float32
                    ) -> torch.Tensor:
    """Inverse of `quantize_int8`; ``scale`` must broadcast against ``q``
    (expand trailing dims at the call site when it was axis-reduced)."""
    return (q.float() * scale.float()).to(dtype)
