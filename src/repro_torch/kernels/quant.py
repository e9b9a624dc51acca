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
    s = int8_scale(torch.amax(xf.abs(), dim=dims, keepdim=True))
    return int8_codes(xf, s), s.squeeze(dims) if dims else s


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """The float32 scale of a group whose max |x| is ``amax``.  A group cut
    over several shards takes the maximum of their maxima first, which is
    exact, so its scale is the unsharded one bit for bit."""
    return torch.clamp(amax.float(), min=1e-12) / 127.0


def int8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(x / scale)`` clipped to [-127, 127], as int8; ``scale``
    broadcasts against ``x``."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127) \
        .to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: Optional[torch.dtype] = torch.float32
                    ) -> torch.Tensor:
    """Inverse of `quantize_int8`; ``scale`` must broadcast against ``q``
    (expand trailing dims at the call site when it was axis-reduced)."""
    return (q.float() * scale.float()).to(dtype)
