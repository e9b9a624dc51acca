"""Kernel entry points with dispatch on the tensors' device.

``mode="auto"`` (the serving default) launches the hand-written kernel for
CUDA tensors and takes the plain PyTorch version for CPU tensors — the
device of the tensor decides, never a failed launch.  ``mode="ref"`` asks
for the plain version by name, which the tests and chip_smoke.py use to
hold the kernel against it on the same inputs.

``ssd_scan`` takes the model's chunk length for the plain version only: the
CUDA kernel walks its own inner chunk, and any chunk length gives the same
function up to rounding.

The TPU package's ``_auto_tile`` (largest divisor of the bucketed length
<= 128) has no counterpart: the CUDA kernel's query tile is set by the
GQA group (64 / G query positions in bf16, 16 / G in float32) and it masks
the ragged edge of any Sq, so there is no tile for a caller to choose; nor has ``flash_prefill``
(``bq``/``bk`` in the TPU package): its query block is 64 / G positions and
it too masks any Sq and Skv."""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd

MODES = ("auto", "ref")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                    mode: str = "auto"):
    """Single-token decode attention over paged KV: q (B, H, D), pools
    (P, page, Hkv, D), tables (B, T) int32, ctx_lens (B,) int32 -> (B, H,
    D).  Fed by a `PagedAllocator`'s ``batch_block_tables`` and the lanes'
    context lengths, as the JAX package's entry point is.  mode: auto |
    ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if mode == "ref" or q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       ctx_lens)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, ctx_lens)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, q_offsets,
                          ctx_lens, mode: str = "auto", quant=None):
    """Unified mixed-batch serving attention (decode = 1-token chunk).
    mode: auto | ref.  ``quant``: optional (kq_pages, vq_pages, k_scales,
    v_scales, page_quant) int8 shadow state — flagged pages are read from
    the int8 pools and dequantized inside the kernel (or the plain
    version); None keeps the all-fp kernel."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    args = (q, k_pages, v_pages, block_tables, q_offsets, ctx_lens)
    if mode == "ref" or q.device.type == "cpu":
        if quant is None:
            return ref.paged_chunk_attention_ref(*args)
        return ref.paged_chunk_attention_ref(*args, quant=quant)
    if quant is None:
        return _pa.paged_chunk_attention(*args)
    return _pa.paged_chunk_attention_quant(q, k_pages, v_pages, *quant,
                                           block_tables, q_offsets, ctx_lens)


def paged_chunk_attention_partial(q, k_pages, v_pages, block_tables,
                                  q_offsets, ctx_lens, shard: int,
                                  n_shards: int, mode: str = "auto",
                                  quant=None):
    """One shard's part of `paged_chunk_attention` on the split-K rung of
    tensor-parallel serving: the pools (and int8 shadows) are shard
    ``shard``'s slice of every page's rows.  Returns (o, lse) for
    ``distributed.collectives.merge_partials``.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    args = (q, k_pages, v_pages, block_tables, q_offsets, ctx_lens)
    if mode == "ref" or q.device.type == "cpu":
        return ref.paged_chunk_attention_partial_ref(
            *args, shard, n_shards, quant=quant)
    if quant is None:
        return _pa.paged_chunk_attention_partial(*args, shard, n_shards)
    return _pa.paged_chunk_attention_quant_partial(
        q, k_pages, v_pages, *quant, block_tables, q_offsets, ctx_lens,
        shard, n_shards)


def flash_prefill(q, k, v, q_offset: int = 0, mode: str = "auto"):
    """Causal prefill attention over dense K/V with a cached prefix: query
    i of q (B, Sq, H, D) sits at position q_offset + i of k/v (B, Skv, Hkv,
    D).  Returns (B, Sq, H, D) in q's dtype.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if mode == "ref" or q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, q_offset)
    return _fp.flash_prefill(q, k, v, q_offset)


def ssd_scan(x, dA, Bm, Cm, chunk: int, init_state=None, mode: str = "auto"):
    """Chunked SSD scan with an initial and a final state (see
    ``ref.ssd_scan_chunked_ref`` for the shapes).  Returns (y in x's
    dtype, final state float32).  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if mode == "ref" or x.device.type == "cpu":
        return ref.ssd_scan_chunked_ref(x, dA, Bm, Cm, chunk,
                                        init_state=init_state)
    return _ssd.ssd_scan(x, dA, Bm, Cm, init_state=init_state)
