"""Plain PyTorch versions of the kernels (the correctness ground truth).

Each function computes what its kernel computes, on any device, with
ordinary tensor operations.  The CPU tests use them, and the card run
(chip_smoke.py) holds every kernel against them on the same inputs."""
from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens):
    """Single-token decode attention over paged KV: the CUDA
    ``paged_attention`` kernel's plain version.

    q:            (B, H, D)
    k/v_pages:    (P, page_size, Hkv, D)
    block_tables: (B, max_pages) int
    ctx_lens:     (B,) int — valid tokens per lane
    returns:      (B, H, D) in q's dtype, computed in float32

    Only positions < ctx_lens[b] reach the softmax, so table columns past
    a lane's first ceil(ctx / page) may hold anything (callers repeat the
    last valid page id).  A lane with ctx = 0 comes back as zeros, as the
    TPU kernel's skipped page walk leaves it; the JAX package's oracle
    returns the mean of the gathered V rows there instead."""
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = block_tables.shape[1] * page
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, S, Hkv, D).float()
    v = v_pages[tables].reshape(B, S, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] \
        < ctx_lens.long()[:, None]
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(MASK_VALUE, dtype=s.dtype, device=q.device))
    o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, dim=-1), v)
    o = torch.where((ctx_lens > 0)[:, None, None, None], o,
                    torch.zeros((), dtype=o.dtype, device=q.device))
    return o.reshape(B, H, D).to(q.dtype)


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


def flash_prefill_ref(q, k, v, q_offset=0):
    """Causal attention of new tokens over dense K/V with a cached prefix:
    the CUDA ``flash_prefill`` kernel's plain version.

    q:        (B, Sq, H, D) — query i sits at absolute position q_offset + i
    k/v:      (B, Skv, Hkv, D), H % Hkv == 0, Skv >= q_offset + Sq
    returns:  (B, Sq, H, D) in q's dtype, computed in float32

    Query i attends to key j iff q_offset + i >= j, so keys past
    q_offset + Sq (padding) are never seen."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
    s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def ssd_scan_ref(x, dA, Bm, Cm):
    """Sequential SSD/Mamba2 recurrence (token by token, float32): the
    oracle the chunked scan is held to.

    x:  (B, S, H, P)  inputs, already dt-scaled
    dA: (B, S, H)     per-step log decay (<= 0)
    Bm: (B, S, H, N)  input projections (per head; the caller broadcasts
                      groups)
    Cm: (B, S, H, N)  output projections
    returns (y (B, S, H, P), state (B, H, N, P)), both float32"""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = (h * torch.exp(dA[:, t].float())[..., None, None]
             + torch.einsum("bhn,bhp->bhnp", Bm[:, t].float(),
                            x[:, t].float()))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1), h


def ssd_scan_chunked_ref(x, dA, Bm, Cm, chunk: int, init_state=None,
                         compute_dtype=torch.float32):
    """The chunked SSD scan (Mamba-2's algorithm, arXiv:2405.21060) in
    float32: the CUDA ``ssd_scan`` kernel's plain version.

    x:  (B, S, H, P)  inputs, already dt-scaled (any float dtype)
    dA: (B, S, H)     per-step log decay (<= 0), float32
    Bm, Cm: (B, S, G, N) with H % G == 0 — head h reads group h // (H / G)
    chunk: steps per chunk (Q = min(chunk, S)); S need not be a multiple:
      the tail is padded with dA = 0 and zero inputs, which leaves the
      state exactly as it was
    init_state: optional (B, H, N, P) state before step 0 (zeros if None)
    compute_dtype: float32 (the kernel's arithmetic), or float64 for a
      rounding reference
    returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P) in
    compute_dtype)

    Per chunk, with cs the cumulative sum of dA inside it:
      Y = ((C B^T) o exp(cs_i - cs_j) o [j <= i]) x + (C h) o exp(cs)
      h <- exp(cs_Q) h + B^T (exp(cs_Q - cs) o x)
    The mask is applied before the exponent (exp of a positive segment
    overflows)."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    dev = x.device
    xf, dAf, Bf, Cf = (t.to(compute_dtype) for t in (x, dA, Bm, Cm))
    Q = max(1, min(chunk, S))
    pad = (-S) % Q
    if pad:
        def zpad(t):
            shape = (t.shape[0], pad) + tuple(t.shape[2:])
            return torch.cat([t, t.new_zeros(shape)], dim=1)
        xf, dAf, Bf, Cf = zpad(xf), zpad(dAf), zpad(Bf), zpad(Cf)
    h = (torch.zeros((Bb, H, N, P), dtype=compute_dtype, device=dev)
         if init_state is None else init_state.to(compute_dtype).clone())
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    neg = torch.tensor(MASK_VALUE, dtype=compute_dtype, device=dev)
    ys = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        dAq, xq, Bq, Cq = dAf[:, sl], xf[:, sl], Bf[:, sl], Cf[:, sl]
        cs = torch.cumsum(dAq, dim=1)                        # (B, Q, H)
        seg = cs[:, :, None, :] - cs[:, None, :, :]          # (B, Q, Q, H)
        ldec = torch.exp(torch.where(causal[None, :, :, None], seg, neg))
        cb = torch.einsum("bign,bjgn->bijg", Cq, Bq)
        cb = cb.repeat_interleave(hpg, dim=3)                # (B, Q, Q, H)
        yd = torch.einsum("bijh,bjhp->bihp", cb * ldec, xq)
        ch = Cq.repeat_interleave(hpg, dim=2)                # (B, Q, H, N)
        yo = torch.einsum("bihn,bhnp->bihp", ch, h) \
            * torch.exp(cs)[..., None]
        wj = torch.exp(cs[:, -1:, :] - cs)                   # (B, Q, H)
        bh = Bq.repeat_interleave(hpg, dim=2)
        snew = torch.einsum("bjhn,bjhp->bhnp", bh * wj[..., None], xq)
        h = h * torch.exp(cs[:, -1, :])[..., None, None] + snew
        ys.append(yd + yo)
    y = torch.cat(ys, dim=1)[:, :S] if ys else xf.new_zeros((Bb, 0, H, P))
    return y.to(x.dtype), h
