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
it too masks any Sq and Skv.

No CUDA kernel here has a backward pass (nor has any Pallas kernel in the
JAX package), and a kernel writes its output through raw pointers that
autograd never sees.  So every kernel entry raises (`needs_grad`) when it
would launch its kernel on tensors that autograd records, rather than cut
the graph quietly; the plain versions are differentiable and run as they
are.  Training reaches a kernel through one door: `ssd_scan_grad`, the
scan under autograd (the kernel forward, the plain version's gradient).
Serving is unaffected: its parameters never require grad and its entry
points run under ``no_grad``.

The meta route: on ``meta`` tensors (shapes only, the dry run's) every
entry returns empty outputs of the right shapes and dtypes, whatever the
mode; neither the CUDA wrapper nor the plain version runs.  Under
autograd the outputs are recorded, and their backward gives empty
gradients of the inputs' shapes.

Each entry is charged its analytic work once by a running
`roofline.cost.Counter`, whichever route implements the call
(``roofline/cost.py``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.roofline import cost

MODES = ("auto", "ref")


def _charged(work):
    """The entry, charged ``work`` (its ``roofline.cost`` function, same
    arguments) by a running counter."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            return cost.kernel_entry(fn.__name__, work, fn, args, kwargs)
        return entry
    return wrap


class _MetaEntry(torch.autograd.Function):
    """An entry's meta route under autograd: ``make()``'s empty outputs,
    whose backward gives empty gradients of the inputs' shapes and charges
    the entry's backward to a running counter."""

    @staticmethod
    def forward(ctx, name, work, make, *inputs):
        ctx.name, ctx.work = name, work
        ctx.specs = [None if t is None else (t.shape, t.dtype)
                     for t in inputs]
        return make()

    @staticmethod
    def backward(ctx, *grads):
        cost.charge_backward(ctx.name, *ctx.work())
        return (None, None, None) + tuple(
            None if s is None else torch.empty(s[0], dtype=s[1],
                                               device="meta")
            for s in ctx.specs)


def _meta(name, work, make, *inputs):
    """The meta route of entry ``name``: ``make()``, recorded by autograd
    when it records ``inputs``; ``work()`` is the entry's charge."""
    if needs_grad(*inputs):
        return _MetaEntry.apply(name, work, make, *inputs)
    return make()


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors``: grad
    mode is on and one of them requires grad (None entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_grad_kernel(name, *tensors):
    if needs_grad(*tensors):
        raise RuntimeError(
            f"ops.{name}: the CUDA kernel has no backward pass, and autograd "
            f"records these inputs; run it under torch.no_grad(), take "
            f"mode='ref' (the plain version, differentiable), or, for the "
            f"scan, ops.ssd_scan_grad")


@_charged(cost.paged_attention_work)
def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                    mode: str = "auto"):
    """Single-token decode attention over paged KV: q (B, H, D), pools
    (P, page, Hkv, D), tables (B, T) int32, ctx_lens (B,) int32 -> (B, H,
    D).  Fed by a `PagedAllocator`'s ``batch_block_tables`` and the lanes'
    context lengths, as the JAX package's entry point is.  mode: auto |
    ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if q.device.type == "meta":
        return torch.empty_like(q)
    if mode == "ref" or q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       ctx_lens)
    _no_grad_kernel("paged_attention", q, k_pages, v_pages)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, ctx_lens)


@_charged(cost.paged_chunk_attention_work)
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
    if q.device.type == "meta":
        return torch.empty_like(q)
    if mode == "ref" or q.device.type == "cpu":
        if quant is None:
            return ref.paged_chunk_attention_ref(*args)
        return ref.paged_chunk_attention_ref(*args, quant=quant)
    _no_grad_kernel("paged_chunk_attention", q, k_pages, v_pages,
                    *(quant or ()))
    if quant is None:
        return _pa.paged_chunk_attention(*args)
    return _pa.paged_chunk_attention_quant(q, k_pages, v_pages, *quant,
                                           block_tables, q_offsets, ctx_lens)


def one_device(devices) -> bool:
    """Whether every shard of a mesh (shard r on ``devices[r]``) lives on
    one device, so that one buffer or one kernel can serve them all."""
    dev = torch.device(devices[0])
    return all(torch.device(d) == dev for d in devices)


def partial_workspace(q, k_pages, block_tables, devices,
                      mode: str = "auto"):
    """The float32 partials of one split-K call of ``len(devices)`` shards
    (shard r's pools on ``devices[r]``), side by side on shard 0's device:
    (ws, slots), ws = (o (tp·S, B, Sq, H, D), lse (tp·S, B, Sq, H)) for
    `merge_partials`, slots[r] shard r's (o, lse) views of it for
    `paged_chunk_attention_partial`'s ``out``.  S splits a shard: 1 for
    the plain version, the kernel's plan
    (``paged_attention.partial_split_plan``) on the card.  (None, [None]
    * tp) when the shards do not all live on one device: each then
    returns its own partials.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    tp = len(devices)
    if not one_device(devices):
        return None, [None] * tp
    dev = torch.device(devices[0])
    B, Sq, H, D = q.shape
    n_split = 1
    if mode != "ref" and q.device.type not in ("cpu", "meta"):
        _, pl, Hkv, _ = k_pages.shape
        n_split = _pa.partial_split_plan(
            B, Sq, H, Hkv, block_tables.shape[1], pl, q.dtype,
            _pa._sm_count(_pa._device(q)))[0]
    ws = (torch.empty((tp * n_split, B, Sq, H, D), dtype=torch.float32,
                      device=dev),
          torch.empty((tp * n_split, B, Sq, H), dtype=torch.float32,
                      device=dev))
    return ws, [tuple(t[r * n_split:(r + 1) * n_split] for t in ws)
                for r in range(tp)]


@_charged(cost.paged_chunk_attention_partial_work)
def paged_chunk_attention_partial(q, k_pages, v_pages, block_tables,
                                  q_offsets, ctx_lens, shard: int,
                                  n_shards: int, mode: str = "auto",
                                  quant=None, out=None):
    """One shard's part of `paged_chunk_attention` on the split-K rung of
    tensor-parallel serving: the pools (and int8 shadows) are shard
    ``shard``'s slice of every page's rows.  Returns its float32 partials
    (o (S, B, Sq, H, D), lse (S, B, Sq, H)), S splits as
    `partial_workspace` plans them, for `merge_partials`; into ``out`` =
    (o, lse) when given (the shard's slots of a workspace).  mode: auto |
    ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    args = (q, k_pages, v_pages, block_tables, q_offsets, ctx_lens)
    if q.device.type == "meta":
        if out is not None:
            return out
        B, Sq, H, D = q.shape
        return (q.new_empty((1, B, Sq, H, D), dtype=torch.float32),
                q.new_empty((1, B, Sq, H), dtype=torch.float32))
    if mode == "ref" or q.device.type == "cpu":
        o, lse = ref.paged_chunk_attention_partial_ref(
            *args, shard, n_shards, quant=quant)
        if out is None:
            return o, lse
        out[0].copy_(o)
        out[1].copy_(lse)
        return out
    _no_grad_kernel("paged_chunk_attention_partial", q, k_pages, v_pages,
                    *(quant or ()))
    if quant is None:
        return _pa.paged_chunk_attention_partial(*args, shard, n_shards,
                                                 out=out)
    return _pa.paged_chunk_attention_quant_partial(
        q, k_pages, v_pages, *quant, block_tables, q_offsets, ctx_lens,
        shard, n_shards, out=out)


@_charged(cost.merge_partials_work)
def merge_partials(o, lse, dtype, mode: str = "auto"):
    """The split-K merge of one call: o (N, B, Sq, H, D) and lse (N, B,
    Sq, H) float32, every shard's and split's partials on one device ->
    (B, Sq, H, D) in ``dtype``.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if o.device.type == "meta":
        return o.new_empty(o.shape[1:], dtype=dtype)
    if mode == "ref" or o.device.type == "cpu":
        return ref.merge_partials_ref(o, lse, dtype)
    _no_grad_kernel("merge_partials", o, lse)
    return _pa.merge_partials(o, lse, dtype)


# bytes of one scores buffer of the head-feature rung (a call's F1 sums
# into it, its F2 reads it): a call whose buffer would pass this is cut
# into tiles of lanes, one buffer a tile (`scores_workspace`)
SCORES_CAP = 4 << 30


def scores_workspace(q, k_pages, block_tables, devices):
    """The float32 scores buffer of one head-feature call of
    ``len(devices)`` shards (shard r's pools on ``devices[r]``) and the
    lanes it takes at once: (ws, lanes).  ``lanes`` is the most lanes of
    q (B, Sq, H, ·) whose scores (lanes, H, Sq, T), T = table width x page,
    stay within SCORES_CAP bytes (at least one); the caller cuts the call
    into tiles of that many lanes.  ``ws`` is one (lanes, H, Sq, T) buffer
    on shard 0's device, which every shard's `paged_chunk_scores_partial`
    writes (shard 0) or adds into (the others) in stream order, when every
    shard lives there; None otherwise: each shard then returns its own
    scores and ``collectives.all_reduce_sum`` sums them."""
    B, Sq, H, _ = q.shape
    T = block_tables.shape[1] * k_pages.shape[1]
    lanes = max(1, min(B, SCORES_CAP // max(4 * H * Sq * T, 1)))
    if not one_device(devices):
        return None, lanes
    return torch.empty((lanes, H, Sq, T), dtype=torch.float32,
                       device=torch.device(devices[0])), lanes


@_charged(cost.paged_chunk_scores_partial_work)
def paged_chunk_scores_partial(q, k_pages, block_tables, q_offsets, ctx_lens,
                               mode: str = "auto", quant=None, out=None,
                               accumulate: bool = False):
    """F1 of the head-feature rung: one shard's unscaled partial scores
    q_r · k_r (B, H, Sq, T) float32 over its features (q (B, Sq, H, dr),
    the pools (P, page, Hkv, dr); ``quant`` its int8 shadows), written
    into ``out`` when given, or added to it with ``accumulate``.  Entries
    of keys a row cannot see are whatever the route leaves there (the
    kernel does not write them, the plain version computes them): only
    `paged_chunk_softmax_pv` reads them, by position.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if q.device.type == "meta":
        if out is not None:
            return out
        B, Sq, H, _ = q.shape
        return q.new_empty((B, H, Sq, block_tables.shape[1]
                            * k_pages.shape[1]), dtype=torch.float32)
    if mode == "ref" or q.device.type == "cpu":
        s = ref.paged_chunk_scores_partial_ref(q, k_pages, block_tables,
                                               q_offsets, ctx_lens,
                                               quant=quant)
        if out is None:
            return s
        return out.add_(s) if accumulate else out.copy_(s)
    _no_grad_kernel("paged_chunk_scores_partial", q, k_pages, *(quant or ()))
    return _pa.paged_chunk_scores(q, k_pages, block_tables, q_offsets,
                                  ctx_lens, quant=quant, out=out,
                                  accumulate=accumulate)


@_charged(cost.paged_chunk_softmax_pv_work)
def paged_chunk_softmax_pv(scores, v_pages, block_tables, q_offsets, ctx_lens,
                           head_dim: int, dtype, mode: str = "auto",
                           quant=None):
    """F2 of the head-feature rung: the softmax of every shard's summed
    scores (B, H, Sq, T) at 1 / sqrt(``head_dim``) of the full head, over
    the keys each row sees, times one shard's V features (pools (P, page,
    Hkv, dr)): (B, Sq, H, dr) in ``dtype``.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if scores.device.type == "meta":
        B, H, Sq, _ = scores.shape
        return scores.new_empty((B, Sq, H, v_pages.shape[-1]), dtype=dtype)
    if mode == "ref" or scores.device.type == "cpu":
        return ref.paged_chunk_softmax_pv_ref(scores, v_pages, block_tables,
                                              q_offsets, ctx_lens, head_dim,
                                              dtype, quant=quant)
    _no_grad_kernel("paged_chunk_softmax_pv", scores, v_pages, *(quant or ()))
    return _pa.paged_chunk_softmax_pv(scores, v_pages, block_tables,
                                      q_offsets, ctx_lens, head_dim, dtype,
                                      quant=quant)


@_charged(cost.paged_chunk_attention_features_work)
def paged_chunk_attention_features(q, k_pools, v_pools, block_tables,
                                   q_offsets, ctx_lens, mode: str = "auto",
                                   quant=None):
    """The head-feature rung's attention when every shard's pools live on
    one device (`one_device`): one kernel launch for the whole call, the
    shards' features gathered into the tile of kernel 1 (B.2 with
    ``quant``), so no scores buffer exists.  q (B, Sq, H, D) full heads;
    k_pools, v_pools one (P, page, Hkv, dr) pool a shard; ``quant`` =
    (kq_pools, vq_pools, k_scales, v_scales, page_quant), the shards' int8
    shadows and the pages' scales and flags.  Returns (B, Sq, H, D): the
    attention over the pools concatenated along D.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if q.device.type == "meta":
        return torch.empty_like(q)
    if mode == "ref" or q.device.type == "cpu":
        return ref.paged_chunk_attention_features_ref(
            q, k_pools, v_pools, block_tables, q_offsets, ctx_lens,
            quant=quant)
    _no_grad_kernel("paged_chunk_attention_features", q, *k_pools,
                    *v_pools, *(() if quant is None
                                else (*quant[0], *quant[1])))
    return _pa.paged_chunk_attention_features(q, k_pools, v_pools,
                                              block_tables, q_offsets,
                                              ctx_lens, quant=quant)


@_charged(cost.flash_prefill_work)
def flash_prefill(q, k, v, q_offset: int = 0, mode: str = "auto"):
    """Causal prefill attention over dense K/V with a cached prefix: query
    i of q (B, Sq, H, D) sits at position q_offset + i of k/v (B, Skv, Hkv,
    D).  Returns (B, Sq, H, D) in q's dtype.  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if q.device.type == "meta":
        return _meta("flash_prefill",
                     lambda: cost.flash_prefill_work(q, k, v, q_offset),
                     lambda: torch.empty_like(q), q, k, v)
    if mode == "ref" or q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, q_offset)
    _no_grad_kernel("flash_prefill", q, k, v)
    return _fp.flash_prefill(q, k, v, q_offset)


@_charged(cost.ssd_scan_work)
def ssd_scan(x, dA, Bm, Cm, chunk: int, init_state=None, mode: str = "auto"):
    """Chunked SSD scan with an initial and a final state (see
    ``ref.ssd_scan_chunked_ref`` for the shapes).  Returns (y in x's
    dtype, final state float32).  mode: auto | ref."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    if x.device.type == "meta":
        B, _, H, P = x.shape
        return _meta("ssd_scan",
                     lambda: cost.ssd_scan_work(x, dA, Bm, Cm, chunk,
                                                init_state),
                     lambda: (torch.empty_like(x), x.new_empty(
                         (B, H, Bm.shape[3], P), dtype=torch.float32)),
                     x, dA, Bm, Cm, init_state)
    if mode == "ref" or x.device.type == "cpu":
        return ref.ssd_scan_chunked_ref(x, dA, Bm, Cm, chunk,
                                        init_state=init_state)
    _no_grad_kernel("ssd_scan", x, dA, Bm, Cm, init_state)
    return _ssd.ssd_scan(x, dA, Bm, Cm, init_state=init_state)


class _SSDScan(torch.autograd.Function):
    """The scan with a gradient: the forward is `ssd_scan` (the kernel on
    the card), the backward recomputes the plain chunked scan from the
    saved inputs and differentiates it.  The JAX package has no backward
    kernel for the scan either: its loss differentiates the jnp scan."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, init_state, chunk, mode):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dA, Bm, Cm, init_state)
        return ssd_scan(x, dA, Bm, Cm, chunk, init_state=init_state,
                        mode=mode)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, h = ref.ssd_scan_chunked_ref(*ins[:4], ctx.chunk,
                                            init_state=ins[4])
        outs = [(o, g) for o, g in ((y, gy), (h, gh)) if g is not None]
        wrt = [t for t in ins if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in outs], wrt, [g for _, g in outs],
            allow_unused=True) if outs and wrt else ())
        return (*(next(grads) if t is not None and t.requires_grad
                  else None for t in ins), None, None)


def ssd_scan_grad(x, dA, Bm, Cm, chunk: int, init_state=None,
                  mode: str = "auto"):
    """`ssd_scan` for tensors that autograd records (the hybrid and mamba2
    loss): the same forward, the hand-written kernel on the card, and the
    plain chunked scan's gradient."""
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    return _SSDScan.apply(x, dA, Bm, Cm, init_state, chunk, mode)
