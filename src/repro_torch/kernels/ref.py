"""Plain PyTorch versions of the kernels (the correctness ground truth).

Each function computes what its kernel computes, on any device, with
ordinary tensor operations.  The CPU tests use them, and the card run
(chip_smoke.py) holds every kernel against them on the same inputs."""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables, q_offsets,
                              ctx_lens, quant=None):
    """Mixed-batch paged attention: each lane is a chunk of queries.

    q:            (B, Sq, H, D) — lane b's token i at position q_offsets[b]+i
    k/v_pages:    (P, page_size, Hkv, D)
    block_tables: (B, max_pages) int
    q_offsets:    (B,) int — cached context before the chunk
    ctx_lens:     (B,) int — total valid KV incl. the chunk (0 = padded
                  lane, output zeroed as the kernel's page skip does)
    quant:        optional (kq_pages, vq_pages, k_scales, v_scales,
                  page_quant) — int8 shadow pools (P, page, Hkv, D),
                  per-page float32 scales (P,) and the per-page precision
                  bit (P,) int32.  Flagged pages read ``int8 * scale`` in
                  float32, never rounded to the model dtype; the rest read
                  the fp pool
    returns:      (B, Sq, H, D) in q's dtype, computed in float32

    A KV position contributes iff it is causally visible (qpos >= kpos)
    and < ctx_lens[b]; table columns past ceil(ctx / page) may therefore
    repeat the lane's last valid page id (their rows sit at kpos >= ctx
    and never survive the mask)."""
    B, Sq, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = block_tables.shape[1] * page
    tables = block_tables.long()
    k = k_pages[tables].float()
    v = v_pages[tables].float()
    if quant is not None:
        kq_pages, vq_pages, k_scales, v_scales, page_quant = quant
        isq = (page_quant[tables] > 0)[..., None, None, None]
        kd = kq_pages[tables].float() \
            * k_scales[tables].float()[..., None, None, None]
        vd = vq_pages[tables].float() \
            * v_scales[tables].float()[..., None, None, None]
        k = torch.where(isq, kd, k)
        v = torch.where(isq, vd, v)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    dev = q.device
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(S, device=dev)
    mask = (qpos[:, :, None] >= kpos[None, None, :]) \
        & (kpos[None, None, :] < ctx_lens.long()[:, None, None])
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(MASK_VALUE, dtype=s.dtype, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    o = torch.where((ctx_lens > 0)[:, None, None, None, None], o,
                    torch.zeros((), dtype=o.dtype, device=dev))
    return o.reshape(B, Sq, H, D).to(q.dtype)
