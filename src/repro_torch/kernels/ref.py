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


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                              split: int):
    """B.3's split-KV decode written out plainly: the arithmetic of the CUDA
    ``paged_attention`` kernel (csrc/paged_attention.cu, merge in
    csrc/split_kv.cuh), the same function as `paged_attention_ref`.

    Lane b's relevant keys [0, min(ctx_b, T x page)) are cut into splits of
    ``split`` keys.  Each split gives float32 partials per query head: m its
    score maximum, l = sum exp(s - m), acc = sum exp(s - m) v.  The merge
    takes M = max m over the lane's splits and returns sum exp(m - M) acc /
    max(sum exp(m - M) l, 1e-30) in q's dtype; a lane with no relevant key
    (ctx = 0) is zeros.  Splits past a lane's end hold no key and weigh
    nothing (m = MASK_VALUE, l = acc = 0)."""
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = block_tables.shape[1] * page
    n_split = max(1, -(-S // split))
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, S, Hkv, D).float()
    v = v_pages[tables].reshape(B, S, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    kv_end = torch.clamp(ctx_lens.long(), min=0, max=S)
    neg = torch.tensor(MASK_VALUE, dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for s0 in range(0, n_split * split, split):
        ks, vs = k[:, s0:s0 + split], v[:, s0:s0 + split]
        pos = s0 + torch.arange(ks.shape[1], device=q.device)
        valid = pos[None, :] < kv_end[:, None]               # (B, n)
        sc = torch.einsum("bhgd,bshd->bhgs", qg, ks) / math.sqrt(D)
        sc = torch.where(valid[:, None, None], sc, neg)
        m = sc.max(dim=-1).values if sc.shape[-1] else \
            neg.expand(B, Hkv, G).clone()
        p = torch.where(valid[:, None, None], torch.exp(sc - m[..., None]),
                        torch.zeros((), device=q.device))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p, vs))
    m = torch.stack(ms)                                      # (n, B, Hkv, G)
    M = m.max(dim=0).values
    e = torch.exp(m - M)
    l_sum = (torch.stack(ls) * e).sum(dim=0)
    acc = (torch.stack(accs) * e[..., None]).sum(dim=0)
    o = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    o = torch.where((kv_end > 0)[:, None, None, None], o,
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


def paged_chunk_attention_partial_ref(q, k_pages, v_pages, block_tables,
                                      q_offsets, ctx_lens, shard: int,
                                      n_shards: int, quant=None):
    """One shard's part of `paged_chunk_attention_ref` on the split-K rung:
    kernel 1's (with ``quant``, B.2's) partial mode.

    k/v_pages (and the int8 shadows in ``quant``): (P, pl, Hkv, D), the
    shard's slice of every page — rows [shard·pl, (shard+1)·pl) of pages
    of ``pl · n_shards`` rows, so local row j of table entry t holds the
    key at position t·pl·n_shards + shard·pl + j.  The causal mask and
    ``ctx_lens`` use those global positions.  Returns the shard's float32
    partials in the kernel's form with one split: o (1, B, Sq, H, D), the
    attention normalised over this shard's visible keys; lse (1, B, Sq,
    H), the log-sum-exp of their scaled scores.  A row with no visible key
    in this shard (every row of a ctx = 0 lane, bucket padding) has o = 0
    and lse = -inf.  Merging every shard's partials (``merge_partials_ref``)
    gives the unsharded attention."""
    B, Sq, H, D = q.shape
    _, pl, Hkv, _ = k_pages.shape
    G = H // Hkv
    T = block_tables.shape[1]
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
    k = k.reshape(B, T * pl, Hkv, D)
    v = v.reshape(B, T * pl, Hkv, D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    dev = q.device
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    j = torch.arange(T * pl, device=dev)
    kpos = (j // pl) * (pl * n_shards) + shard * pl + j % pl
    ctx = ctx_lens.long()
    # a row past its lane's context is bucket padding: it sees nothing
    mask = (qpos[:, :, None] >= kpos[None, None, :]) \
        & (kpos[None, None, :] < ctx[:, None, None]) \
        & (qpos[:, :, None] < ctx[:, None, None])
    neg = torch.tensor(-torch.inf, dtype=s.dtype, device=dev)
    s = torch.where(mask[:, None, None], s, neg)
    lse = torch.logsumexp(s, dim=-1)                       # (B, Hkv, G, Sq)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    lse = lse.permute(0, 3, 1, 2).reshape(1, B, Sq, H)
    return o.reshape(1, B, Sq, H, D), lse


def _feature_pages(pages, quant_pages, scales, page_quant, tables):
    """Rows of a feature shard's pool gathered through the tables, float32
    (B, T, page, Hkv, dr): ``int8 * scale`` where the page is flagged."""
    x = pages[tables].float()
    if page_quant is None:
        return x
    isq = (page_quant[tables] > 0)[..., None, None, None]
    xd = quant_pages[tables].float() \
        * scales[tables].float()[..., None, None, None]
    return torch.where(isq, xd, x)


def _visible(q_offsets, ctx_lens, Sq, T, dev):
    """(B, Sq, T) bool: key kpos is visible to lane b's query row i iff
    kpos <= q_offsets[b] + i and kpos < ctx_lens[b] (a position mask,
    whatever page the table names there)."""
    qpos = q_offsets.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(T, device=dev)
    return (qpos[:, :, None] >= kpos[None, None, :]) \
        & (kpos[None, None, :] < ctx_lens.long()[:, None, None])


def paged_chunk_scores_partial_ref(q, k_pages, block_tables, q_offsets,
                                   ctx_lens, quant=None):
    """One shard's scores on the head-feature rung: F1's plain version.

    q:            (B, Sq, H, dr) — the shard's features of every query head
    k_pages:      (P, page, Hkv, dr) — the shard's features of every row
    block_tables, q_offsets, ctx_lens: as `paged_chunk_attention_ref`
    quant:        optional (kq_pages, vq_pages, k_scales, v_scales,
                  page_quant), the shard's int8 shadows (P, page, Hkv, dr)
                  and the per-page scales and flags; K reads kq, k_scales
    returns:      (B, H, Sq, T) float32, T = table width x page: the
                  unscaled partial products q_r . k_r of every (query row,
                  key).  Summed over the shards they are the full heads'
                  q . k; `paged_chunk_softmax_pv_ref` scales, masks and
                  normalises them.  The kernel writes only the entries a
                  row can see (kpos <= qpos, kpos < ctx, qpos < ctx); the
                  rest are left as they were, and are never read."""
    B, Sq, H, dr = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = H // Hkv
    T = block_tables.shape[1] * page
    tables = block_tables.long()
    k = (_feature_pages(k_pages, None, None, None, tables) if quant is None
         else _feature_pages(k_pages, quant[0], quant[2], quant[4], tables))
    k = k.reshape(B, T, Hkv, dr)
    qg = q.reshape(B, Sq, Hkv, G, dr).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    return s.reshape(B, H, Sq, T)


def paged_chunk_softmax_pv_ref(scores, v_pages, block_tables, q_offsets,
                               ctx_lens, head_dim: int, dtype, quant=None):
    """One shard's output on the head-feature rung: F2's plain version.

    scores:       (B, H, Sq, T) float32, every shard's partial products
                  summed (the full heads' q . k)
    v_pages:      (P, page, Hkv, dr) — the shard's features of every row
    head_dim:     the full head's D: the softmax scale is 1 / sqrt(D),
                  whatever the shard's dr
    dtype:        the output's dtype (q's)
    quant:        as `paged_chunk_scores_partial_ref`; V reads vq, v_scales
    returns:      (B, Sq, H, dr) in ``dtype``: softmax over the visible
                  keys (the causal and ctx mask of
                  `paged_chunk_attention_ref`, by position) of scores /
                  sqrt(D), times the shard's V features, in float32; a
                  ctx = 0 lane is zeros.  Concatenated over the shards
                  along the last dim it is `paged_chunk_attention_ref` on
                  the full pool."""
    B, H, Sq, T = scores.shape
    _, page, Hkv, dr = v_pages.shape
    G = H // Hkv
    dev = scores.device
    tables = block_tables.long()
    v = (_feature_pages(v_pages, None, None, None, tables) if quant is None
         else _feature_pages(v_pages, quant[1], quant[3], quant[4], tables))
    v = v.reshape(B, T, Hkv, dr)
    s = scores.float().reshape(B, Hkv, G, Sq, T) / math.sqrt(head_dim)
    mask = _visible(q_offsets, ctx_lens, Sq, T, dev)
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(MASK_VALUE, dtype=s.dtype, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    o = torch.where((ctx_lens > 0)[:, None, None, None, None], o,
                    torch.zeros((), dtype=o.dtype, device=dev))
    return o.reshape(B, Sq, H, dr).to(dtype)


def paged_chunk_attention_features_ref(q, k_pools, v_pools, block_tables,
                                       q_offsets, ctx_lens, quant=None):
    """The head-feature rung's attention with every shard's pools at hand:
    the one-card route's plain version.

    q:            (B, Sq, H, D) full heads
    k/v_pools:    one (P, page, Hkv, dr) pool a shard, shard r holding
                  features [r·dr, (r+1)·dr) of every row
    quant:        optional (kq_pools, vq_pools, k_scales, v_scales,
                  page_quant): the shards' int8 shadows (lists shaped as
                  the pools) and the pages' scales and flags (P,), the same
                  for every shard
    returns:      `paged_chunk_attention_ref` on the pools concatenated
                  along D (the shards' features in order)"""
    kp = torch.cat(list(k_pools), dim=-1)
    vp = torch.cat(list(v_pools), dim=-1)
    if quant is not None:
        quant = (torch.cat(list(quant[0]), dim=-1),
                 torch.cat(list(quant[1]), dim=-1), *quant[2:])
    return paged_chunk_attention_ref(q, kp, vp, block_tables, q_offsets,
                                     ctx_lens, quant=quant)


def combine_partials(o, lse):
    """N float32 partials of the same rows, o (N, ..., D) each normalised
    over its own keys and lse (N, ...) their log-sum-exp (-inf where a
    partial saw no key, whose o is zeros), combined: (o over all their keys
    (..., D) float32, zeros where none saw a key; its lse (...), -inf
    there).  Each partial is weighed by exp(lse_i - max lse) in float32."""
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    w = torch.exp(lse - m)                                   # 0 where -inf
    num = (w[..., None] * o).sum(dim=0)
    den = w.sum(dim=0)
    seen = den > 0
    out = num / torch.where(seen, den, torch.ones((), device=m.device))[
        ..., None]
    return out, torch.where(seen, m + torch.log(den),
                            torch.full((), -torch.inf, device=m.device))


def merge_partials_ref(o, lse, dtype):
    """The plain version of the split-K merge (``paged_attention.
    merge_partials``): o (N, B, Sq, H, D) and lse (N, B, Sq, H) float32,
    every shard's and split's partials of one call; returns the attention
    over all their keys, (B, Sq, H, D) in ``dtype``, a row no partial saw
    a key for as zeros."""
    return combine_partials(o.float(), lse.float())[0].to(dtype)


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


def ssd_scan_ref(x, dA, Bm, Cm, init_state=None):
    """Sequential SSD/Mamba2 recurrence (token by token, float32): the
    oracle the chunked scan is held to, and the arithmetic of the CUDA
    scan's decode path (h <- exp(dA) h + B x^T, y = C h).

    x:  (B, S, H, P)  inputs, already dt-scaled
    dA: (B, S, H)     per-step log decay (<= 0)
    Bm: (B, S, H, N)  input projections (per head; the caller broadcasts
                      groups)
    Cm: (B, S, H, N)  output projections
    init_state: optional (B, H, N, P) state before step 0 (zeros if None)
    returns (y (B, S, H, P), state (B, H, N, P)), both float32"""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float().clone())
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


def ssd_scan_state_passing_ref(x, dA, Bm, Cm, chunk: int, init_state=None):
    """The chunk-parallel state-passing form of the chunked scan, pass by
    pass: the arithmetic of the CUDA scan's chunk path (csrc/ssd_scan.cu),
    the same function as `ssd_scan_chunked_ref`, in float32.

    Shapes as `ssd_scan_chunked_ref`.  With nc = ceil(S / chunk) chunks
    (the tail padded with dA = 0 and zero inputs) and cs the running sum of
    dA inside each chunk:
      (a) every chunk at once: C B^T per group, and per head the
          chunk-local state  S_c = B^T (exp(cs_last - cs) o x)  and the
          intra-chunk output  y_diag = ((C B^T) o exp(cs_i - cs_j) o
          [j <= i]) x, each decay cs_i - cs_j summed over its own steps
          (dA_{j+1} + ... + dA_i) rather than taken as a difference;
      (b) in chunk order:  h_prev_0 = init,  h_prev_{c+1} = exp(cs_last_c)
          h_prev_c + S_c; the final state is h_prev_nc;
      (c) every chunk at once:  y = y_diag + (C h_prev_c) o exp(cs).
    returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P)
    float32)."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    dev = x.device
    Q = max(1, chunk)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dAf, Bf, Cf = (t.float() for t in (x, dA, Bm, Cm))
    if pad:
        def zpad(t):
            shape = (t.shape[0], pad) + tuple(t.shape[2:])
            return torch.cat([t, t.new_zeros(shape)], dim=1)
        xf, dAf, Bf, Cf = zpad(xf), zpad(dAf), zpad(Bf), zpad(Cf)
    xc = xf.reshape(Bb, nc, Q, H, P)
    Bc = Bf.reshape(Bb, nc, Q, G, N)
    Cc = Cf.reshape(Bb, nc, Q, G, N)
    # (a); decays over a segment are sums of its own steps, never
    # differences of running sums (as the kernel forms them)
    cs = torch.cumsum(dAf.reshape(Bb, nc, Q, H), dim=2)      # (B, nc, Q, H)
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)          # per group
    cb = cb.repeat_interleave(hpg, dim=2)                    # (B,nc,H,Q,Q)
    a = dAf.reshape(Bb, nc, Q, H).permute(0, 1, 3, 2)        # (B,nc,H,Q)
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev), -1)
    steps = torch.where(below, a[..., :, None], torch.zeros((), device=dev))
    seg = torch.cumsum(steps, dim=-2)      # [i, j] = dA_{j+1} + ... + dA_i
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    ldec = torch.exp(torch.where(causal, seg,
                                 torch.tensor(MASK_VALUE, device=dev)))
    y_diag = torch.einsum("bchij,bcjhp->bcihp", cb * ldec, xc)
    w = torch.exp(seg[..., -1, :])                           # (B,nc,H,Q)
    bh = Bc.repeat_interleave(hpg, dim=3)                    # (B,nc,Q,H,N)
    s_loc = torch.einsum("bcjhn,bchj,bcjhp->bchnp", bh, w, xc)
    # (b)
    h = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=dev)
         if init_state is None else init_state.float().clone())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(cs[:, c, -1])[..., None, None] * h + s_loc[:, c]
    # (c)
    if nc:
        hp = torch.stack(h_prev, dim=1)                      # (B,nc,H,N,P)
        ch = Cc.repeat_interleave(hpg, dim=3)                # (B,nc,Q,H,N)
        y_off = torch.einsum("bcihn,bchnp->bcihp", ch, hp) \
            * torch.exp(cs)[..., None]
        y = (y_diag + y_off).reshape(Bb, nc * Q, H, P)[:, :S]
    else:
        y = xf.new_zeros((Bb, 0, H, P))
    return y.to(x.dtype), h
