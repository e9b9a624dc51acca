"""The plain reference: a dense decoder's forward pass in float32 over a
session's whole token history, with no cache, no paging and no kernel.

It follows the block the configuration files describe (pre-norm RMSNorm,
RoPE on the two halves of each head, grouped-query causal softmax
attention, SwiGLU, a final RMSNorm and an untied unembedding), reads the
weights the benchmark made from the seed (the same tensors the program
serves with, upcast here one layer at a time), and imports nothing of the
program.  Matrix products run with TF32 off.

``precision="fp8"`` is the control: every matrix product's operands (the
weights per output channel, the activations per row, and K and V per
row) are rounded to float8 e4m3 first, the step below the bf16 the
configurations state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (per row for dim=-1), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """a (rows, in) @ w (in, out), float32; fp8 rounds a per row and w per
    output column."""
    if fp8:
        return _fp8(a, -1) @ _fp8(w, 0)
    return a @ w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (S, heads, D); the two halves of each head rotated together."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@contextlib.contextmanager
def _exact_float32():
    cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(prec)


@torch.no_grad()
def logits_at(weights: Dict, cfg: Dict, tokens: Sequence[int],
              positions: Sequence[int], precision: str = "fp32",
              block: int = 1024) -> torch.Tensor:
    """Float32 logits (len(positions), vocab): row i is what the model
    predicts at ``tokens[positions[i]]`` for the token after it.  Attention
    runs over blocks of ``block`` query rows, so a long history fits."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    fp8 = precision == "fp8"
    dev = weights["emb"].device
    L, H, Hkv, D = (cfg["n_layers"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["d_head"])
    G, eps = H // Hkv, cfg["norm_eps"]
    ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    S = ids.numel()
    pos = torch.arange(S, device=dev)
    x = weights["emb"][ids].float()
    blocks = weights["blocks"]
    with _exact_float32():
        for l in range(L):
            w = {k: v[l].float() for k, v in blocks.items()}
            h = _rms(x, w["ln1"], eps)
            q = _rope(_mm(h, w["wq"], fp8).view(S, H, D), pos,
                      cfg["rope_theta"])
            k = _rope(_mm(h, w["wk"], fp8).view(S, Hkv, D), pos,
                      cfg["rope_theta"])
            v = _mm(h, w["wv"], fp8).view(S, Hkv, D)
            if fp8:
                q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
            o = torch.empty((S, H, D), dtype=torch.float32, device=dev)
            for a in range(0, S, block):
                b = min(S, a + block)
                qb = q[a:b].view(b - a, Hkv, G, D)
                s = torch.einsum("qhgd,khd->hgqk", qb, k[:b]) / math.sqrt(D)
                mask = pos[a:b, None] >= pos[None, :b]
                s = s.masked_fill(~mask, float("-inf"))
                p = torch.softmax(s, dim=-1)
                o[a:b] = torch.einsum("hgqk,khd->qhgd", p, v[:b]).reshape(
                    b - a, H, D)
            x = x + _mm(o.view(S, H * D), w["wo"], fp8)
            h = _rms(x, w["ln2"], eps)
            x = x + _mm(torch.nn.functional.silu(_mm(h, w["w1"], fp8))
                        * _mm(h, w["w3"], fp8), w["w2"], fp8)
            del w, h, q, k, v, o
        rows = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        xf = _rms(x[rows], weights["ln_f"].float(), eps)
        head = weights["lm_head"][:cfg["vocab"]].float()
        return _mm(xf, head.T, fp8)


def gaps(logits: torch.Tensor, served: List[int]) -> torch.Tensor:
    """Per row: by how much the served token's logit lies below the row's
    best (0 where it is the best)."""
    idx = torch.as_tensor(served, dtype=torch.long, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, idx[:, None])[:, 0]
