"""The yardstick's arithmetic: the card's peaks, a paged attention call's
work and a serving step's model FLOPs.

``attention_work`` is frozen from ``repro_torch.roofline.cost`` (the tests
hold it equal there): it charges the bytes and operations that THESE
inputs need, whatever implements the call, so a share of its bound cannot
pass 100 % and removing padding moves the share the right way.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def attention_work(q_shape, tables, q_offsets, ctx_lens, page, hkv, d,
                   itemsize, q_lens, flags=None):
    """(bytes, operations) of one paged attention call over q of shape
    (B, Sq, H, D): each real query row read and its output written once
    (nothing for bucket padding or ctx = 0 lanes), each lane's relevant K/V
    rows once per kv head, the tables' relevant columns; QK and PV over
    the keys each real query row sees (4 D operations per head and key).
    With ``flags`` (the int8 kernel, a page's precision bit by page id): a
    flagged page's rows at one byte an element plus its two float32
    scales, and each relevant page's flag.  Array arguments are numpy."""
    B, Sq, H, D = q_shape
    qo = np.asarray(q_offsets, np.int64)
    cx = np.asarray(ctx_lens, np.int64)
    nbytes = 2 * B * 4
    flops = 0
    for b in range(B):
        if cx[b] == 0:
            continue
        n = int(q_lens[b])
        c = int(cx[b])
        npg = -(-c // page)
        nbytes += 2 * n * H * D * itemsize
        nbytes += 4 * npg
        if flags is None:
            nbytes += 2 * c * hkv * d * itemsize
        else:
            nbytes += 4 * npg
            for i in range(npg):
                rows = min(page, c - i * page)
                if flags[tables[b, i]]:
                    nbytes += 2 * rows * hkv * d + 2 * 4
                else:
                    nbytes += 2 * rows * hkv * d * itemsize
        seen = np.minimum(cx[b], qo[b] + np.arange(n) + 1)
        flops += 4 * D * H * int(seen.sum())
    return nbytes, flops


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in a dense block: q, k, v, o and the
    three SwiGLU matrices."""
    d, q, kv, ff = (cfg["d_model"], cfg["n_heads"] * cfg["d_head"],
                    cfg["n_kv_heads"] * cfg["d_head"], cfg["d_ff"])
    return d * (q + 2 * kv) + q * d + 3 * d * ff


def step_flops(cfg: dict, q_offsets, ctx_lens) -> float:
    """Model FLOPs one serving step needs for its real tokens: 2 x the
    block weights per token on every layer, causal attention over each
    token's real context (4 D operations per head and key seen), and the
    unembedding of each real lane's one read-out row.  Padded rows and
    lanes (ctx = 0) are not charged."""
    qo = np.asarray(q_offsets, np.int64)
    cx = np.asarray(ctx_lens, np.int64)
    real = cx > 0
    n = (cx - qo)[real]
    tokens = int(n.sum())
    # keys seen summed over a lane's rows: positions qo+1 .. cx
    seen = int(((qo[real] + 1 + cx[real]) * n // 2).sum())
    L, H, D = cfg["n_layers"], cfg["n_heads"], cfg["d_head"]
    return (2.0 * L * layer_matmul_params(cfg) * tokens
            + 4.0 * L * H * D * seen
            + 2.0 * cfg["d_model"] * cfg["vocab"] * int(real.sum()))


ATTENTION_KERNEL = "paged_chunk_attention"


def attention_roofline(r):
    """Share (%) of the bound that kernel 1 reached over the traced paged
    steps that read no int8 page.  Every call launches one attention
    kernel a layer, in order on the compute stream, so the k-th group of
    ``n_layers`` attention kernels in the trace is the k-th traced call's.
    None where the trace holds no such call, or its kernels do not line up
    with the calls."""
    if not r.on_card:
        return None
    calls = [c for c in r.calls if c.traced]
    kern = sorted((e for e in r.events if ATTENTION_KERNEL in e[0]),
                  key=lambda e: e[1])
    L = r.cfg["n_layers"]
    if not calls or len(kern) != L * len(calls):
        return None
    bound = busy = 0.0
    hkv, d = r.cfg["n_kv_heads"], r.cfg["d_head"]
    itemsize = 4 if r.cfg["dtype"] == "float32" else 2
    for i, c in enumerate(calls):
        if c.quant:
            continue
        q_lens = (c.ctx_lens.astype(np.int64)
                  - c.q_offsets.astype(np.int64)).clip(min=0)
        nb, fl = attention_work(c.q_shape, None, c.q_offsets, c.ctx_lens,
                                r.page, hkv, d, itemsize, q_lens)
        for l in range(L):
            bound += bound_s(nb, fl)
            _, s, e = kern[i * L + l]
            busy += e - s
    if busy <= 0:
        return None
    return 100.0 * bound / busy
