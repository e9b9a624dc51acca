"""Shared model layers: norms, RoPE, dense attention, MLPs, init.

Plain PyTorch, with the JAX package's conventions: norms and RoPE compute
in float32 and cast back, attention softmax runs in float32, and RoPE
rotates halves (the two halves of the head dimension, not interleaved
pairs).  The dense attention here serves the reference ``prefill`` /
``decode_step`` and the attention the JAX package computes outside any
Pallas kernel (the encoder's and the cross attention of ``EncDecLM``);
the serving path's paged attention is a kernel (``repro_torch.kernels``)
held against these semantics.  The training loss (``softmax_xent``) and
the per-block rematerialisation (``remat``, the JAX package's
``jax.checkpoint``) live here too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def einsum32(spec, *ops):
    """einsum with float32 accumulation and a float32 result: the JAX
    package's ``einsum32`` in the mode it runs on the CPU (operands cast
    to float32)."""
    return torch.einsum(spec, *[o.float() for o in ops])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense attention (the reference prefill / decode path)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: Optional[int] = None):
    """Softmax attention of new tokens over K/V, float32 inside.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0.
    ``causal``: query i sees the keys at positions <= q_offset + i (False:
    every key).  ``q_offset``: absolute position of q[0] relative to k[0]
    (a cached prefix of q_offset tokens).  ``window``: sliding-window size.
    The JAX reference chunks this computation to bound memory; the result
    is the same softmax, so the port computes it in one piece.  Causal at
    window=None it is ``kernels.ref.flash_prefill_ref``, the CUDA kernel's
    plain version."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window is not None:
        mask &= qp[:, None] - kp[None, :] < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, layout: str = "bshd"):
    """Single-position attention over a (possibly padded) cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, Hkv, D) for layout="bshd"
    (sequence-major) or (B, Hkv, S, D) for layout="bhsd" (head-major);
    cache_len: (B,) valid entries *including* the current token's KV."""
    if layout == "bshd":
        k_cache, v_cache = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif layout != "bhsd":
        raise ValueError(f"decode_attention: layout {layout!r}")
    B, _, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < cache_len[:, None]
    if window is not None:
        mask &= pos[None, :] >= cache_len[:, None] - window
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# Losses and training helpers
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """logits (..., V), labels int (tensors or arrays, moved to the logits'
    device, as is ``mask``); the mean negative log-likelihood over the
    masked tokens (every token without a mask), in float32."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=logits.device).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) whenever autograd records; a plain call under
    ``no_grad``."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def unbind_layers(stack):
    """A stacked (L, ...) parameter dictionary as L per-layer dictionaries.
    Under autograd each ``v[l]`` would backpropagate a zero-filled gradient
    of the whole stack, L times over; one ``unbind`` a leaf stacks the
    layers' gradients once."""
    per_leaf = {k: v.unbind(0) for k, v in stack.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[l] for k, v in per_leaf.items()} for l in range(n)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale=None, device=None):
    """Normal(0, scale) weights drawn in float32 from ``gen`` and cast;
    the default scale is 1/sqrt(fan_in) with fan_in = shape[-2] (weights are
    stored (in, out), as in the JAX package)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w.mul_(scale)).to(dtype)
